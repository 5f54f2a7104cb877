"""Named training configurations (port of cosypose_tpu/training/configs.py).

A config name resolves to a full hyperparameter set, field for field the JAX
package's: lr 3e-4, batch 32, epoch_size 115200, 700 epochs, warmup 50,
lr/10 every 500 epochs, grad clip 0.5, pose_dim 9, n_points_loss 2600, coarse
input 'fixed' / 'fixed+trans_noise', refiner input 'gt+noise'. Names whose
model the port does not have yet (the FlowNet ablation, the procedural-diag*
arms and the *-mini* configs: WRN18, CorrNet, moment/flatten/lk pooling)
raise PosePredictorConfig's "not ported" error.
"""

from __future__ import annotations

import dataclasses

import torch

from ..models.pose_predictor import PosePredictorConfig
from .pose_training import PoseTrainConfig


@dataclasses.dataclass
class RunConfig:
    run_id: str
    train: PoseTrainConfig
    train_ds_names: tuple = ()
    val_ds_names: tuple = ()
    object_ds_name: str = ""
    n_dataloader_workers: int = 8
    val_epoch_interval: int = 10
    test_epoch_interval: int = 30
    save_epoch_interval: int = 1
    input_resize: tuple = (480, 640)  # dataset image size fed to the model
    rgb_augmentation: bool = True     # train-time photometric augmentation


BOP_DS = ("lm", "lmo", "tless", "tudl", "icbin", "itodd", "hb", "ycbv")


def make_cfg(config_name: str, debug: bool = False) -> RunConfig:
    predictor = PosePredictorConfig(backbone="efficientnet-b3")
    train = PoseTrainConfig(predictor=predictor)

    def base(run_id, **kw):
        return RunConfig(run_id=run_id, train=dataclasses.replace(train, **kw))

    if config_name.startswith("tless-coarse") or config_name.startswith("tless-refiner"):
        # tless-{coarse|refiner}[-ablation-{loss|network|rot|augm}]
        kind = "coarse" if config_name.startswith("tless-coarse") else "refiner"
        kw = dict(input_generator="fixed" if kind == "coarse" else "gt+noise",
                  n_iterations=1 if kind == "coarse" else 3)
        rgb_augmentation = True
        if config_name.endswith("-ablation-loss"):
            kw["loss_disentangled"] = False
        elif config_name.endswith("-ablation-network"):
            kw["predictor"] = dataclasses.replace(predictor, backbone="flownet")
        elif config_name.endswith("-ablation-rot"):
            kw["predictor"] = dataclasses.replace(predictor, pose_dim=7)
        elif config_name.endswith("-ablation-augm"):
            rgb_augmentation = False
        elif config_name not in ("tless-coarse", "tless-refiner"):
            raise ValueError(f"Unknown config {config_name}")
        cfg = base(config_name, **kw)
        cfg.train_ds_names = (("synthetic.tless-1M.train", 1), ("tless.primesense.train", 5))
        cfg.val_ds_names = (("synthetic.tless-1M.val", 1),)
        cfg.object_ds_name = "tless.cad"
        cfg.input_resize = (540, 720)
        cfg.rgb_augmentation = rgb_augmentation
    elif config_name == "ycbv-refiner-syntonly":
        cfg = base(config_name, input_generator="gt+noise", n_iterations=3)
        cfg.train_ds_names = (("synthetic.ycbv-1M.train", 1),)
        cfg.object_ds_name = "ycbv.bop-compat"
    elif config_name == "ycbv-refiner-finetune":
        cfg = base(config_name, input_generator="gt+noise", n_iterations=3)
        cfg.train_ds_names = (("synthetic.ycbv-1M.train", 1), ("ycbv.train.synt.real", 3))
        cfg.object_ds_name = "ycbv.bop-compat"
    elif config_name in ("procedural-coarse", "procedural-refiner"):
        # short schedule over the recorded procedural pile dataset
        small = dataclasses.replace(predictor, compute_dtype=torch.bfloat16)
        if config_name == "procedural-coarse":
            gen, n_iterations = "fixed+trans_noise", 1
        else:
            gen, n_iterations = "gt+noise", 3
        cfg = base(config_name, predictor=small, input_generator=gen,
                   n_iterations=n_iterations, batch_size=32, epoch_size=6400, n_epochs=40,
                   n_epochs_warmup=2, n_points_loss=600)
        cfg.train_ds_names = (("synthetic.procedural-4k.train", 1),)
        cfg.val_ds_names = (("synthetic.procedural-4k.val", 1),)
        cfg.object_ds_name = "procedural"
        cfg.input_resize = (240, 320)
        cfg.val_epoch_interval = 5
    elif config_name.startswith("procedural-diag") or \
            config_name.startswith("procedural-refiner-mini"):
        # WRN18 / CorrNet backbones with moment, flatten or lk pooling: raises
        dataclasses.replace(predictor,
                            backbone="corrnet" if "-corr" in config_name else "wide-resnet18")
    elif config_name.startswith("bop-"):
        # bop-<ds>-{pbr|synt+real}-{coarse|refiner}
        ds, data, kind = config_name.split("-")[1:4]
        if ds not in BOP_DS:
            raise ValueError(f"Unknown BOP dataset {ds} in {config_name}")
        if kind == "coarse":
            cfg = base(config_name, input_generator="fixed+trans_noise", n_iterations=1)
        else:
            cfg = base(config_name, input_generator="gt+noise", n_iterations=3)
        split = "train.pbr" if data == "pbr" else "train.synt.real"
        cfg.train_ds_names = ((f"{ds}.{split}", 1),)
        cfg.object_ds_name = f"{ds}.models"
    else:
        raise ValueError(f"Unknown config {config_name}")

    if debug:
        cfg.train = dataclasses.replace(cfg.train, n_epochs=4, batch_size=4, epoch_size=16,
                                        n_epochs_warmup=1)
        cfg.n_dataloader_workers = 0
        # a debug run never writes into (and prunes) the real run's checkpoints
        cfg.run_id = f"{cfg.run_id}-debug"
    return cfg
