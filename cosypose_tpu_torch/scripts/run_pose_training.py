"""Pose training CLI (port of cosypose_tpu/scripts/run_pose_training.py).

  python -m cosypose_tpu_torch.scripts.run_pose_training --config procedural-refiner \\
      [--debug] [--resume] [--pretrain-run-id RUN] [--ds-root DIR] [--n-epochs N] \\
      [--no-eval-bundle] [--device cpu]

Data parallel over N processes, each loading its rows of global batches of
batch_size × N (training/train_pose.py):

  python -m torch.distributed.run --nproc_per_node N \
      -m cosypose_tpu_torch.scripts.run_pose_training --config ... \
      [--dist-backend gloo] [--param-mode fsdp]

NCCL on the cards (cuda:LOCAL_RANK), gloo with --device cpu; --dist-backend
gloo with --device cuda:0 puts every rank on one card.

A named config (training/configs.py) gives the hyperparameters, its datasets
come from the registry (data/datasets_cfg.py) and the mesh database from its
object dataset, on the card unless --device says otherwise. A config with a
validation set gets the in-training evaluation bundle over its first one
(evaluation/eval_bundle.py: test/... metrics in log.txt every
test_epoch_interval epochs) unless --no-eval-bundle is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging

from ..data.datasets_cfg import make_object_dataset, make_scene_dataset
from ..data.pose_dataset import PoseDataset
from ..evaluation.eval_bundle import make_eval_bundle
from ..ops.mesh_db import build_mesh_db
from ..training.configs import make_cfg
from ..training.train_pose import train_pose
from ..utils.distributed import distributed_mode


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True, help="e.g. procedural-refiner, tless-coarse")
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--pretrain-run-id", default=None)
    parser.add_argument("--ds-root", default=None)
    parser.add_argument("--no-eval-bundle", action="store_true",
                        help="skip the default in-training evaluation bundle")
    parser.add_argument("--n-epochs", type=int, default=None,
                        help="override the config's epoch budget")
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
    cfg = make_cfg(args.config, debug=args.debug)
    if args.n_epochs is not None:
        cfg.train = dataclasses.replace(cfg.train, n_epochs=args.n_epochs)
    obj_ds = make_object_dataset(cfg.object_ds_name, ds_root=args.ds_root)
    mesh_db = build_mesh_db(obj_ds.mesh_specs(), device=device)

    resize = tuple(cfg.input_resize)
    # with the device jitter (train.rgb_aug_device) the host chain stays off
    host_jitter = cfg.rgb_augmentation and not cfg.train.rgb_aug_device
    train_sets = [(PoseDataset(make_scene_dataset(name, ds_root=args.ds_root), resize=resize,
                               apply_rgb_augmentation=host_jitter), repeat)
                  for name, repeat in cfg.train_ds_names]
    val_scenes = [(make_scene_dataset(name, ds_root=args.ds_root), repeat)
                  for name, repeat in cfg.val_ds_names]
    val_sets = [(PoseDataset(ds, resize=resize, apply_rgb_augmentation=False), repeat)
                for ds, repeat in val_scenes]
    eval_callback = None
    if val_scenes and not args.no_eval_bundle:
        eval_callback = make_eval_bundle(cfg, mesh_db, val_scenes[0][0], device=device)
    return train_pose(cfg, scene_datasets={"train": train_sets, "val": val_sets},
                      mesh_db=mesh_db, resume=args.resume,
                      pretrain_run_id=args.pretrain_run_id, exp_dir=args.exp_dir,
                      eval_callback=eval_callback, device=device, param_mode=args.param_mode)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
