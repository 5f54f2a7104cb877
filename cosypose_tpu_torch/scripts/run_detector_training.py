"""Detector training CLI (port of cosypose_tpu/scripts/run_detector_training.py).

  python -m cosypose_tpu_torch.scripts.run_detector_training --config NAME \\
      [--debug] [--n-epochs N] [--mask-pos-weight W] [--pretrain-run-id RUN] \\
      [--resume] [--ds-root DIR] [--exp-dir DIR] [--device cpu]

Configs: detector-procedural (the recorded procedural-4k piles, 240x320),
detector-procedural-all (every recorded procedural tier, a longer schedule),
detector-procedural-all2 (also the textured tier, the softmax class head, 32
mask prototypes, mask_pos_weight 2) and detector-bop-<ds>-{pbr|synt+real}
at the dataset's input size. --debug trains 2 epochs of 32 samples in
batches of 4 with no loader workers, into the run <config>-debug.
--pretrain-run-id copies the tensors of that run whose name and shape match.
Under torchrun (python -m torch.distributed.run --nproc_per_node N -m
cosypose_tpu_torch.scripts.run_detector_training ...) the run is data
parallel over global batches of batch_size × N, with --dist-backend and
--param-mode as in run_pose_training.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import pathlib

from .. import config
from ..bop_config import BOP_CONFIG
from ..data.datasets_cfg import make_object_dataset, make_scene_dataset
from ..data.detection_dataset import DetectionDataset
from ..data.wrappers import ConcatSceneDataset
from ..models.detector import DetectorConfig
from ..training.detector_training import DetectorTrainConfig, train_detector
from ..utils.distributed import distributed_mode

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class DetectorRunConfig:
    run_id: str
    train: DetectorTrainConfig
    train_ds_names: tuple
    object_ds_name: str
    input_size: tuple            # (h, w) of the frames the detector trains on
    n_dataloader_workers: int = 8


def make_cfg(config_name: str, debug: bool = False) -> DetectorRunConfig:
    """The named config; its detector's n_classes is set from the object set
    by `main`."""
    batch = 4 if debug else 16
    if config_name.startswith("detector-procedural"):
        use_all = config_name.startswith("detector-procedural-all")
        v2 = config_name == "detector-procedural-all2"
        train = DetectorTrainConfig(
            detector=DetectorConfig(cls_mode="softmax" if v2 else "percls",
                                    n_mask_protos=32 if v2 else 16),
            batch_size=batch, epoch_size=32 if debug else 3200,
            n_epochs=2 if debug else (90 if use_all else 30), n_epochs_warmup=1,
            lr_epoch_decay=40 if use_all else 100, mask_pos_weight=2.0 if v2 else 1.0)
        names = (["synthetic.procedural-4k.train", "synthetic.procedural-canon.train",
                  "synthetic.procedural-solo.train"] if use_all
                 else ["synthetic.procedural-4k.train"])
        if v2:
            names.append("synthetic.procedural-texsolo.train")
        cfg = DetectorRunConfig(config_name, train, tuple(names), "procedural", (240, 320))
    elif config_name.startswith("detector-bop-"):
        ds, data = config_name.split("-")[2:4]
        if ds not in BOP_CONFIG or data not in ("pbr", "synt+real"):
            raise ValueError(f"Unknown config {config_name}")
        bop = BOP_CONFIG[ds]
        train = DetectorTrainConfig(batch_size=batch, epoch_size=32 if debug else 115200,
                                    n_epochs=2 if debug else 200)
        split = (bop["train_pbr_ds_name"][0] if data == "pbr"
                 else bop["train_synt_real_ds_names"][0][0])
        cfg = DetectorRunConfig(config_name, train, (split,), bop["obj_ds_name"],
                                (bop["input_resize"][1], bop["input_resize"][0]))
    else:
        raise ValueError(f"Unknown config {config_name}")
    if debug:
        cfg.run_id = f"{config_name}-debug"
        cfg.n_dataloader_workers = 0
    return cfg


def label_to_category_id(obj_ds) -> dict:
    """Labels → class ids in the object set's order."""
    labels = [o["label"] for o in obj_ds.objects] if hasattr(obj_ds, "objects") else obj_ds.labels
    return {label: i for i, label in enumerate(labels)}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True,
                        help="e.g. detector-procedural, detector-bop-ycbv-pbr")
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--n-epochs", type=int, default=None)
    parser.add_argument("--mask-pos-weight", type=float, default=None,
                        help="foreground BCE weight of the instance-mask loss")
    parser.add_argument("--pretrain-run-id", default=None,
                        help="initialise from this run's checkpoint (tensors whose name and "
                             "shape match)")
    parser.add_argument("--resume", action="store_true",
                        help="resume from the run's latest checkpoint (optimizer included)")
    parser.add_argument("--ds-root", default=None, help="data root (default config.LOCAL_DATA_DIR)")
    parser.add_argument("--exp-dir", default=None, help="runs directory (default config.EXP_DIR)")
    parser.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    parser.add_argument("--dist-backend", default=None,
                        help="process-group backend under torchrun (default: nccl on cuda, "
                             "gloo on cpu)")
    parser.add_argument("--param-mode", default="replicated", choices=("replicated", "fsdp"),
                        help="data-parallel parameters: replicated (DDP) or sharded (FSDP2)")
    args = parser.parse_args(argv)
    with distributed_mode(args.dist_backend, args.device) as device:
        return run(args, device)


def run(args, device):
    cfg = make_cfg(args.config, args.debug)
    labels = label_to_category_id(make_object_dataset(cfg.object_ds_name, ds_root=args.ds_root))
    train = dataclasses.replace(
        cfg.train, detector=dataclasses.replace(cfg.train.detector, n_classes=len(labels)))
    if args.n_epochs is not None and not args.debug:
        train = dataclasses.replace(train, n_epochs=args.n_epochs)
    if args.mask_pos_weight is not None:
        train = dataclasses.replace(train, mask_pos_weight=args.mask_pos_weight)
    sets = [make_scene_dataset(name, ds_root=args.ds_root) for name in cfg.train_ds_names]
    scene_ds = sets[0] if len(sets) == 1 else ConcatSceneDataset(sets)
    det_ds = DetectionDataset(scene_ds, labels, resize=tuple(cfg.input_size))
    exp_dir = pathlib.Path(args.exp_dir or config.EXP_DIR)
    run_dir = exp_dir / cfg.run_id
    state = train_detector(train, det_ds, run_dir, n_workers=cfg.n_dataloader_workers,
                           resume=args.resume,
                           pretrain_dir=exp_dir / args.pretrain_run_id
                           if args.pretrain_run_id else None, device=device,
                           param_mode=args.param_mode)
    return state, run_dir


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
