"""Detector training: the CenterNet losses, the train state and step, and the
training loop (port of cosypose_tpu/training/detector_training.py and the
loop of cosypose_tpu/scripts/run_detector_training.py).

The loss: penalty-reduced focal loss on the centre heatmap (in cls_mode
'softmax': on the objectness heatmap, plus the class head's cross-entropy at
the GT centres), L1 on width/height and centre offset at the GT centres,
BCE of the prototypes' mean against the segmentation shrunk to the head's
grid (bilinear with antialiasing, as jax.image.resize shrinks), and the
per-instance YOLACT mask BCE, foreground pixels weighted by
mask_pos_weight. The update: clip by global norm, then Adam at the pose
training's lr schedule.

Data parallel (a `param_mode`, under a process group) as the pose step: each
rank holds its rows of the global batch, the counts that normalise the
losses' sums (positives, objects) are the global batch's (parallel.ddp.
mean_count), BatchNorm runs over the global batch, and the metrics are the
global batch's, as the JAX package's sharded step computes them.
"""

from __future__ import annotations

import dataclasses
import pathlib
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..data.detection_dataset import DetectionDataset
from ..data.wrappers import PartialSampler
from ..models.detector import CenterNetDetector, DetectorConfig, init_detector_weights
from ..parallel.ddp import DataParallel, loss_through, mean_count, mean_over_ranks
from ..utils.device import resolve_device
from ..utils.distributed import get_rank, get_world_size, reduce_dict
from ..utils.logging import get_logger
from .checkpoint import (latest_checkpoint, load_checkpoint, load_net_state, restore_into_state,
                         save_checkpoint, save_config)
from .logs import MetricsAccumulator, RunLogger
from .pose_training import PoseTrainConfig, clip_and_step, lr_schedule
from .train_pose import make_loader, reseed_datasets

logger = get_logger(__name__)


@dataclasses.dataclass(frozen=True)
class DetectorTrainConfig:
    detector: DetectorConfig = DetectorConfig()
    lr: float = 2e-4
    n_epochs_warmup: int = 5
    lr_epoch_decay: int = 100
    clip_grad_norm: float = 10.0
    batch_size: int = 16
    epoch_size: int = 115200
    n_epochs: int = 200
    w_heatmap: float = 1.0
    w_wh: float = 0.1
    w_offset: float = 1.0
    w_mask: float = 1.0
    w_cls: float = 1.0            # softmax cls_mode: the class head's cross-entropy
    mask_pos_weight: float = 1.0  # BCE weight of foreground pixels in the instance masks


@dataclasses.dataclass
class DetectorTrainState:
    net: CenterNetDetector
    optimizer: torch.optim.Optimizer
    step: int = 0
    dp: DataParallel | None = None


def focal_loss(logits: torch.Tensor, targets: torch.Tensor, alpha: float = 2.0,
               beta: float = 4.0, group=None) -> torch.Tensor:
    """CenterNet's penalty-reduced pixelwise focal loss, over the positives'
    count (the global batch's over `group`, see mean_count)."""
    p = torch.sigmoid(logits)
    pos = (targets >= 1.0 - 1e-6).to(logits.dtype)
    eps = 1e-7
    pos_loss = -torch.log(p.clamp(eps, 1.0)) * (1 - p) ** alpha * pos
    neg_loss = -torch.log((1 - p).clamp(eps, 1.0)) * p ** alpha * (1 - targets) ** beta * (1 - pos)
    return (pos_loss.sum() + neg_loss.sum()) / mean_count(pos.sum(), group)


def detector_loss(model: CenterNetDetector, cfg: DetectorTrainConfig, batch: dict, group=None):
    """batch: images (B,3,H,W) uint8 or float in [0,1], heatmap (B,Hm,Wm,C),
    wh (B,N,2), offset (B,N,2), inds (B,N), classes (B,N), obj_mask (B,N),
    seg_mask (B,H,W), inst_masks (B,N,Hm,Wm) (optional), on the model's
    device. Runs the model as it is (train mode moves its BatchNorm running
    statistics). With `group`, batch is one rank's rows and the counts that
    normalise the sums are the global batch's. Returns (loss with its graph,
    detached metrics)."""
    images = batch["images"]
    if images.dtype == torch.uint8:  # the float conversion happens on the device
        images = images.float() / 255.0
    outputs = model(images)
    B, Hm, Wm, _ = outputs["wh"].shape
    inds = batch["inds"]

    def gather_at(field):  # (B, Hm, Wm, D) → (B, N, D)
        D = field.shape[-1]
        return field.reshape(B, Hm * Wm, D).gather(1, inds[..., None].expand(-1, -1, D))

    obj = batch["obj_mask"].float()
    l_cls = None
    if "cls_logits" in outputs:
        l_heat = focal_loss(outputs["heatmap"], batch["heatmap"].amax(dim=-1, keepdim=True),
                            group=group)
        logp = torch.log_softmax(gather_at(outputs["cls_logits"]), dim=-1)
        picked = logp.gather(-1, batch["classes"][..., None])[..., 0]
        l_cls = -(picked * obj).sum() / mean_count(obj.sum(), group)
    else:
        l_heat = focal_loss(outputs["heatmap"], batch["heatmap"], group=group)
    m = obj[..., None]
    n_obj = mean_count(m.sum(), group)
    l_wh = ((gather_at(outputs["wh"]) - batch["wh"]).abs() * m).sum() / n_obj
    l_off = ((gather_at(outputs["offset"]) - batch["offset"]).abs() * m).sum() / n_obj

    seg_small = F.interpolate(batch["seg_mask"].float()[:, None], size=(Hm, Wm), mode="bilinear",
                              align_corners=False, antialias=True)[:, 0]
    l_mask = F.binary_cross_entropy_with_logits(outputs["protos"].mean(dim=-1), seg_small)
    if "inst_masks" in batch:
        inst_logits = torch.einsum("bnp,bhwp->bnhw", gather_at(outputs["mask_coeffs"]),
                                   outputs["protos"])
        inst_gt = batch["inst_masks"].float()
        bce = F.binary_cross_entropy_with_logits(inst_logits, inst_gt, reduction="none")
        if cfg.mask_pos_weight != 1.0:
            bce = bce * (1.0 + (cfg.mask_pos_weight - 1.0) * inst_gt)
        l_mask = l_mask + (bce * obj[..., None, None]).mean(dim=(2, 3)).sum() / n_obj

    loss = cfg.w_heatmap * l_heat + cfg.w_wh * l_wh + cfg.w_offset * l_off + cfg.w_mask * l_mask
    if l_cls is not None:
        loss = loss + cfg.w_cls * l_cls
    metrics = dict(loss_total=loss, loss_heatmap=l_heat, loss_wh=l_wh, loss_offset=l_off,
                   loss_mask=l_mask)
    if l_cls is not None:
        metrics["loss_cls"] = l_cls
    return loss, {k: v.detach() for k, v in metrics.items()}


def schedule_config(cfg: DetectorTrainConfig) -> PoseTrainConfig:
    """The pose training config whose lr_schedule is the detector's."""
    return PoseTrainConfig(lr=cfg.lr, n_epochs_warmup=cfg.n_epochs_warmup,
                           lr_epoch_decay=cfg.lr_epoch_decay, batch_size=cfg.batch_size,
                           epoch_size=cfg.epoch_size)


def create_detector_train_state(cfg: DetectorTrainConfig, device: str | torch.device = "cuda",
                                generator: torch.Generator | None = None,
                                param_mode: str | None = None) -> DetectorTrainState:
    """A seeded detector in train mode on `device` and its Adam (optax's
    defaults: betas 0.9/0.999, eps 1e-8); with `param_mode`, trained
    data-parallel over the process group."""
    net = CenterNetDetector(cfg.detector)
    init_detector_weights(net, generator or torch.Generator().manual_seed(0))
    net.to(resolve_device(device)).train()
    dp = DataParallel(net, param_mode) if param_mode is not None else None
    optimizer = torch.optim.Adam(dp.parameters() if dp is not None else net.parameters(),
                                 lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8)
    return DetectorTrainState(net=net, optimizer=optimizer, dp=dp)


def make_detector_train_step(cfg: DetectorTrainConfig):
    """train_step(state, batch) → metrics (detached, with grad_norm): one
    update of `state`, in place; on a state made with a param_mode, data
    parallel as the pose step (pose_training.make_train_step) on this rank's
    rows of the batch."""
    schedule = lr_schedule(schedule_config(cfg))

    def train_step(state: DetectorTrainState, batch: dict) -> dict:
        state.optimizer.zero_grad(set_to_none=True)
        group = None if state.dp is None else torch.distributed.group.WORLD
        loss, metrics = loss_through(state.dp, detector_loss, state.net, cfg, batch, group)
        loss.backward()
        metrics["grad_norm"] = clip_and_step(state.net.parameters(), state.optimizer,
                                             cfg.clip_grad_norm, schedule(state.step))
        state.step += 1
        return metrics if state.dp is None else mean_over_ranks(metrics)

    return train_step


def load_pretrain(state: DetectorTrainState, run_dir) -> int:
    """Copy every parameter and statistic of another run's latest checkpoint
    whose name and shape match (heads sized by the class count keep their
    init). Returns how many were copied."""
    ckpt = latest_checkpoint(run_dir)
    if ckpt is None:
        raise FileNotFoundError(f"no checkpoint under {run_dir}")
    src = load_checkpoint(ckpt)["net"]
    own = state.net.state_dict()  # under FSDP, DTensors of the whole shapes
    match = {k: v for k, v in src.items() if k in own and own[k].shape == v.shape}
    load_net_state(state, match, strict=False)
    return len(match)


def train_detector(tcfg: DetectorTrainConfig, det_ds: DetectionDataset, run_dir,
                   n_workers: int = 8, resume: bool = False, pretrain_dir=None,
                   device: str | torch.device = "cuda",
                   param_mode: str = "replicated") -> DetectorTrainState:
    """The epoch loop: epoch_size samples an epoch (PartialSampler seeded by
    the epoch), full batches, a checkpoint after each epoch, jsonlines log
    with the per-epoch host data wait and step time. Writes config.yaml (the
    DetectorTrainConfig) into run_dir. Under a process group it is data
    parallel as train_pose is: global batches of batch_size × world, each
    rank loading its rows, rank 0 writing (param_mode 'replicated' or
    'fsdp', read only there)."""
    device = resolve_device(device)
    rank, world = get_rank(), get_world_size()
    run_dir = pathlib.Path(run_dir)
    run_logger = None
    if rank == 0:
        save_config(run_dir, tcfg)
        run_logger = RunLogger(run_dir)
    mode = param_mode if torch.distributed.is_initialized() else None
    state = create_detector_train_state(tcfg, device, param_mode=mode)
    if pretrain_dir is not None:
        logger.info(f"pretrain {pretrain_dir}: loaded {load_pretrain(state, pretrain_dir)} "
                    "matching tensors")
    start_epoch = 0
    if resume and (ckpt := latest_checkpoint(run_dir)) is not None:
        payload = load_checkpoint(ckpt)
        restore_into_state(state, payload)
        start_epoch = int(payload["epoch"]) + 1
        logger.info(f"Resumed from {ckpt} at epoch {start_epoch}")
    step_fn = make_detector_train_step(tcfg)
    if rank and not n_workers:  # each rank's copy of the dataset its own streams
        reseed_datasets(det_ds, [], rank)
    pin = device.type == "cuda"
    for epoch in range(start_epoch, tcfg.n_epochs):
        loader = make_loader(det_ds, PartialSampler(det_ds, tcfg.epoch_size, seed=epoch),
                             tcfg.batch_size * world, n_workers, pin, epoch,
                             collate_fn=DetectionDataset.collate_fn, rank=rank, world=world)
        acc = MetricsAccumulator()
        waits, t_step, n_steps = [], 0.0, 0
        t_mark = time.perf_counter()
        for batch in loader:
            waits.append(time.perf_counter() - t_mark)
            batch["images"] = batch.pop("image")
            metrics = step_fn(state, {k: v.to(device, non_blocking=True)
                                      for k, v in batch.items()})
            acc.add(metrics)
            n_steps += 1
            t_step += time.perf_counter() - t_mark
            t_mark = time.perf_counter()
        if n_steps:
            float(metrics["loss_total"])  # wait for the card's last step
            t_step += time.perf_counter() - t_mark
            acc.add({"data_s_per_step": sum(waits) / n_steps, "step_s_per_step": t_step / n_steps,
                     "data_s_first_batch": waits[0],
                     "data_s_second_half": float(np.mean(waits[n_steps // 2:]))})
        record = reduce_dict(acc.means())
        if rank == 0:
            record = run_logger.append(epoch, record)
            logger.info(f"epoch {epoch}: {record}")
        save_checkpoint(run_dir, state, epoch)
    return state
