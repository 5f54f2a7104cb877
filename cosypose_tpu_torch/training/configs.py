"""Named training configurations (port of cosypose_tpu/training/configs.py).

A config name resolves to a full hyperparameter set, field for field the JAX
package's: lr 3e-4, batch 32, epoch_size 115200, 700 epochs, warmup 50,
lr/10 every 500 epochs, grad clip 0.5, pose_dim 9, n_points_loss 2600, coarse
input 'fixed' / 'fixed+trans_noise', refiner input 'gt+noise'. Every name
of the JAX package resolves: the T-LESS ablations (FlowNetS among them), the
procedural-diag* arms (WideResNet-18 or CorrNet, moment/scale/flatten/lk
pooling, the 9-channel input) and procedural-refiner-mini[-moments].
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
    elif config_name.startswith("procedural-diag"):
        # procedural-diag[-corr][-gap|-flat][-lk][-sc][-nodiff][-coarse] and
        # the numeric levers lr, vs, aux, ep, it, lev, rot, hi, zw; b3, fp32
        # and dc0 switch the backbone to B3, fp32 and no drop-connect
        parts = config_name.split("-")
        mini = dataclasses.replace(
            predictor, backbone="corrnet" if "-corr" in config_name else "wide-resnet18",
            render_size=(120, 160), compute_dtype=torch.bfloat16,
            pooling=("gap" if "-gap" in config_name else
                     "gap+moments+flatten" if "-flat" in config_name else "gap+moments")
            + ("+scale" if "sc" in parts else "") + ("+lk" if "-lk" in config_name else ""),
            input_mode="obs+render" if "-nodiff" in config_name else "obs+render+diff")
        lr, aux, lever, n_epochs, n_iterations, z_weight, rot_deg = \
            1e-3, None, 0.05, None, 1, 1.0, 0.0
        for part in parts:
            if part.startswith("lr"):
                lr = float(part[2:])
            elif part.startswith("vs"):
                mini = dataclasses.replace(mini, vxvy_scale=float(part[2:]))
            elif part.startswith("aux"):
                aux = float(part[3:])
            elif part.startswith("ep"):
                n_epochs = int(part[2:])
            elif part.startswith("it"):
                n_iterations = int(part[2:])
            elif part.startswith("lev"):
                lever = float(part[3:])
            elif part == "rot":
                rot_deg = 15.0
            elif part.startswith("rot"):
                rot_deg = float(part[3:])
            elif part.startswith("hi"):
                mini = dataclasses.replace(mini, head_init_scale=float(part[2:]))
            elif part == "b3":
                mini = dataclasses.replace(mini, backbone="efficientnet-b3")
            elif part == "fp32":
                mini = dataclasses.replace(mini, compute_dtype=torch.float32)
            elif part == "dc0":
                mini = dataclasses.replace(mini, drop_connect_rate=0.0)
            elif part.startswith("zw"):
                z_weight = float(part[2:])
        coarse = "-coarse" in config_name
        if aux is None:
            aux = 0.3 if (coarse or rot_deg > 0.0) else 0.0
        if n_epochs is None:
            n_epochs = 60 if coarse else 20
        cfg = base(config_name, predictor=mini,
                   input_generator="fixed+trans_noise" if coarse else "gt+noise",
                   n_iterations=n_iterations, batch_size=64, epoch_size=6400,
                   n_epochs=n_epochs, n_epochs_warmup=1, n_points_loss=600, lr=lr,
                   noise_euler_deg=(rot_deg,) * 3, noise_trans=(0.01, 0.01, 0.03),
                   aux_regression_weight=aux, aux_rot_lever_m=lever, z_loss_weight=z_weight,
                   rgb_aug_device="-devaug" in config_name)
        ds = ("procedural-texsolo" if "-texsolo" in config_name else
              "procedural-solo" if "-solo" in config_name else "procedural-canon")
        cfg.train_ds_names = ((f"synthetic.{ds}.train", 1),)
        cfg.val_ds_names = ((f"synthetic.{ds}.val", 1),)
        cfg.object_ds_name = "procedural-tex" if "-texsolo" in config_name else "procedural"
        cfg.input_resize = (120, 160)
        cfg.val_epoch_interval = 10
        cfg.test_epoch_interval = 5
    elif config_name in ("procedural-refiner-mini", "procedural-refiner-mini-moments"):
        # WRN18 bf16 at 120x160, one iteration, gentler noise; -moments adds
        # spatial-moment pooling
        mini = dataclasses.replace(
            predictor, backbone="wide-resnet18", render_size=(120, 160),
            compute_dtype=torch.bfloat16,
            pooling="gap+moments" if config_name.endswith("-moments") else "gap")
        cfg = base(config_name, predictor=mini, input_generator="gt+noise", n_iterations=1,
                   batch_size=64, epoch_size=6400,
                   n_epochs=150 if config_name.endswith("-moments") else 60,
                   n_epochs_warmup=1, n_points_loss=600, lr=1e-3,
                   noise_euler_deg=(10.0, 10.0, 10.0), noise_trans=(0.01, 0.01, 0.03))
        cfg.train_ds_names = (("synthetic.procedural-canon.train", 1),)
        cfg.val_ds_names = (("synthetic.procedural-canon.val", 1),)
        cfg.object_ds_name = "procedural"
        cfg.input_resize = (120, 160)
        cfg.val_epoch_interval = 10
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
