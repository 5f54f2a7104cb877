"""Pose-model training: the loss, the optimizer and the train step (port of
cosypose_tpu/training/pose_training.py).

One step: input poses from the ground truth (or the boxes) → n
render-and-compare iterations in train mode (each renders through the raster
kernels on the card) → the disentangled symmetric loss per iteration →
backward → clip by global norm 0.5 → Adam (AdamW with weight decay) at the
scheduled lr. The train state is updated in place.

The JAX package draws its random numbers inside the jitted step from a key;
the port draws them on the CPU from a torch.Generator before the step
(`draw_step`), so the card and the CPU see the same numbers and a test can
hand the step the JAX package's draws.

Data parallel (`param_mode` 'replicated' or 'fsdp', under a process group):
each rank holds its contiguous rows of the global batch and of the global
batch's draws, the net runs through parallel.DataParallel (gradients
averaged, BatchNorm over the global batch), the clip reads the whole
gradient's norm and the metrics are the global batch's: the step the JAX
package's sharded step computes.
"""

from __future__ import annotations

import dataclasses

import torch

from ..models.efficientnet import frozen_stats
from ..models.pose_predictor import PosePredictor, PosePredictorConfig, gather_mesh_data
from ..ops.image_aug import apply_color_jitter, jitter_draws
from ..ops.losses import (compute_ADD_L1_loss, loss_refiner_aux_regression,
                          loss_refiner_CO_disentangled)
from ..ops.pose_ops import TCO_init_from_boxes, TCO_init_from_boxes_zup_autodepth
from ..ops.transforms import apply_pose_noise, pose_noise_draws
from ..parallel.ddp import (DataParallel, global_grad_norm, local_part, loss_through,
                            mean_over_ranks, rank_rows)

INPUT_GENERATORS = ("fixed", "gt+noise", "fixed+trans_noise")


@dataclasses.dataclass(frozen=True)
class PoseTrainConfig:
    # model
    predictor: PosePredictorConfig = PosePredictorConfig()
    n_iterations: int = 1                 # train-time refinement iterations
    input_generator: str = "fixed"        # fixed | gt+noise | fixed+trans_noise
    loss_disentangled: bool = True
    n_points_loss: int = 2600
    # auxiliary L2 regression to the closed-form optimal head outputs
    # (ops/losses.py:loss_refiner_aux_regression); 0 is the reference's loss
    aux_regression_weight: float = 0.0
    aux_rot_lever_m: float = 0.05
    z_loss_weight: float = 1.0            # z-hypothesis weight; 1 is the reference's
    # gt+noise input-generator magnitudes
    noise_euler_deg: tuple = (15.0, 15.0, 15.0)
    noise_trans: tuple = (0.01, 0.01, 0.05)
    # photometric jitter on the device inside the step (ops/image_aug.py)
    rgb_aug_device: bool = False
    rgb_aug_p: float = 0.4
    # optimizer
    lr: float = 3e-4
    weight_decay: float = 0.0
    n_epochs_warmup: int = 50
    lr_epoch_decay: int = 500
    clip_grad_norm: float = 0.5
    batch_size: int = 32
    epoch_size: int = 115200
    n_epochs: int = 700

    def __post_init__(self):
        if self.input_generator not in INPUT_GENERATORS:
            raise ValueError(f"Unknown input generator {self.input_generator}")


@dataclasses.dataclass
class TrainState:
    """The predictor (net, BatchNorm running statistics), its optimizer, the
    count of updates made and, in a data-parallel run, the net's wrapper.
    train_step updates it in place."""

    pp: PosePredictor
    optimizer: torch.optim.Optimizer
    step: int = 0
    dp: DataParallel | None = None

    @property
    def net(self) -> torch.nn.Module:
        return self.pp.net


def lr_schedule(cfg: PoseTrainConfig):
    """lr of the update made at a step count: linear warmup over the warmup
    epochs, then ×0.1 every lr_epoch_decay epochs. As in optax, the count is
    that of the updates before the current one (0 at the first step)."""
    steps_per_epoch = max(1, cfg.epoch_size // cfg.batch_size)
    warmup_steps = cfg.n_epochs_warmup * steps_per_epoch

    def schedule(step: int) -> float:
        warm = min(1.0, (step + 1) / max(warmup_steps, 1))
        epoch = step // steps_per_epoch
        decay_exp = epoch // cfg.lr_epoch_decay if epoch >= cfg.n_epochs_warmup else 0
        return cfg.lr * warm * 0.1 ** decay_exp

    return schedule


def make_optimizer(cfg: PoseTrainConfig, params) -> torch.optim.Optimizer:
    """Adam, or AdamW when weight_decay (optax's defaults: betas 0.9/0.999,
    eps 1e-8). The lr is set from lr_schedule before each update, and the
    gradient clip is apply_gradients'."""
    if cfg.weight_decay:
        return torch.optim.AdamW(params, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=cfg.weight_decay)
    return torch.optim.Adam(params, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8)


def create_train_state(cfg: PoseTrainConfig, device: str | torch.device = "cuda",
                       generator: torch.Generator | None = None,
                       param_mode: str | None = None) -> TrainState:
    """A freshly initialised predictor (seeded by `generator`) and optimizer;
    with `param_mode` ('replicated' or 'fsdp'), trained data-parallel over
    the process group (rank 0's initial weights on every rank)."""
    pp = PosePredictor(cfg.predictor, device=device,
                       generator=generator or torch.Generator().manual_seed(0))
    dp = DataParallel(pp.net, param_mode) if param_mode is not None else None
    params = dp.parameters() if dp is not None else pp.net.parameters()
    return TrainState(pp=pp, optimizer=make_optimizer(cfg, params), dp=dp)


def shard_draws(draws: dict, rank: int, world: int) -> dict:
    """Rank r's rows of a global batch's draws: its contiguous rows of
    pose_noise, drop_masks and jitter; point_ids is shared."""
    def rows(t):
        return t[rank_rows(len(t), rank, world)]

    return dict(point_ids=draws["point_ids"],
                pose_noise=tuple(rows(t) for t in draws["pose_noise"]),
                drop_masks=[None if masks is None else [None if m is None else rows(m)
                                                        for m in masks]
                            for masks in draws["drop_masks"]],
                jitter=None if draws["jitter"] is None else
                {op: tuple(rows(t) for t in v) for op, v in draws["jitter"].items()})


def draw_step(cfg: PoseTrainConfig, pp: PosePredictor, batch_size: int, n_points: int,
              generator: torch.Generator, rank: int = 0, world: int = 1) -> dict:
    """The random numbers of one step of a global batch of `batch_size`, on
    the CPU from `generator`: point_ids (the per-step loss point subset,
    shared across the batch), pose_noise (input-generator draws), drop_masks
    (per iteration, per block) and jitter (when cfg.rgb_aug_device). Every
    rank draws the global batch's numbers from the same generator and keeps
    its rows (shard_draws), so the ranks together see one stream."""
    n_pts = min(cfg.n_points_loss, n_points)
    return shard_draws(dict(
        point_ids=torch.randperm(n_points, generator=generator)[:n_pts],
        pose_noise=pose_noise_draws(batch_size, generator),
        drop_masks=[pp.net.backbone.draw_drop_masks(batch_size, generator)
                    for _ in range(cfg.n_iterations)],
        jitter=jitter_draws(batch_size, generator) if cfg.rgb_aug_device else None,
    ), rank, world)


def make_TCO_init(cfg: PoseTrainConfig, batch: dict, points: torch.Tensor,
                  pose_noise) -> torch.Tensor:
    """Train-time input poses (ref: pose_forward_loss.py:32-43)."""
    gen = cfg.input_generator
    if gen == "fixed":
        return TCO_init_from_boxes(batch["bboxes"], batch["K"], z_range=(1.0, 1.0))
    if gen == "gt+noise":
        return apply_pose_noise(batch["TCO"], *pose_noise, euler_deg_std=cfg.noise_euler_deg,
                                trans_std=cfg.noise_trans)
    TCO0 = TCO_init_from_boxes_zup_autodepth(batch["bboxes"], points, batch["K"])
    return apply_pose_noise(TCO0, *pose_noise, euler_deg_std=(0.0, 0.0, 0.0),
                            trans_std=(0.01, 0.01, 0.05))


def pose_loss(pp: PosePredictor, cfg: PoseTrainConfig, mesh_db, batch: dict, draws: dict,
              augment: bool = True):
    """Forward + per-iteration disentangled loss.

    batch: {images (B,3,H,W) uint8 or float in [0,1], K (B,3,3), TCO (B,4,4)
    GT, bboxes (B,4), label_ids (B,)} on the predictor's device; draws from
    draw_step. Returns (loss, metrics): the scalar loss with its graph, and
    detached metrics (loss_total, loss_TCO-iter=n, the components).
    """
    images = batch["images"]
    if images.dtype == torch.uint8:  # the float conversion happens on the device
        images = images.float() / 255.0
    if cfg.rgb_aug_device and augment:
        images = apply_color_jitter(images, draws["jitter"], p=cfg.rgb_aug_p)
    label_ids = batch["label_ids"]
    mesh_data = gather_mesh_data(mesh_db, label_ids, n_points_crop=cfg.predictor.n_points_crop)
    points = mesh_db.points[label_ids][:, draws["point_ids"].to(images.device)]
    TCO_possible_gt = torch.einsum("bij,bsjk->bsik", batch["TCO"],
                                   mesh_db.symmetries[label_ids])
    TCO_init = make_TCO_init(cfg, batch, points, draws["pose_noise"])
    outs = pp.forward_train(mesh_data, images, batch["K"], TCO_init,
                            n_iterations=cfg.n_iterations, drop_masks=draws["drop_masks"])

    losses, comps = [], {}
    for n in range(cfg.n_iterations):
        TCO_input, TCO_output = outs["TCO_input"][n], outs["TCO_output"][n]
        K_crop, pose_outputs = outs["K_crop"][n], outs["pose_outputs"][n]
        if cfg.loss_disentangled:
            loss, parts = loss_refiner_CO_disentangled(
                TCO_possible_gt, TCO_input, pose_outputs, K_crop, points,
                pose_dim=cfg.predictor.pose_dim, return_components=True,
                z_weight=cfg.z_loss_weight)
        else:
            loss = compute_ADD_L1_loss(TCO_possible_gt[:, 0], TCO_output, points)
            parts = dict(loss_orn=loss, loss_xy=loss, loss_z=loss)
        if cfg.aux_regression_weight > 0.0:
            aux = loss_refiner_aux_regression(
                TCO_possible_gt[:, 0], TCO_input, pose_outputs, K_crop,
                pose_dim=cfg.predictor.pose_dim, rot_lever_m=cfg.aux_rot_lever_m)
            loss = loss + cfg.aux_regression_weight * aux
            parts = dict(parts, loss_aux=aux)
        losses.append(loss)
        for k, v in parts.items():
            comps.setdefault(k, []).append(v)
    losses = torch.stack(losses)  # (n_iter, B)
    loss = losses.mean()
    metrics = {"loss_total": loss.detach()}
    for n in range(cfg.n_iterations):
        metrics[f"loss_TCO-iter={n + 1}"] = losses[n].detach().mean()
    for k, v in comps.items():
        metrics[k] = torch.stack(v).detach().mean()
    return loss, metrics


def clip_and_step(params, optimizer: torch.optim.Optimizer, clip_grad_norm: float,
                  lr: float) -> torch.Tensor:
    """Clip the gradients by their global norm as optax does (scaled by
    max/norm where the norm is at least max, no epsilon), set the lr, step
    the optimizer. Returns the global norm of the unclipped gradients (of
    the whole gradient where FSDP shards it)."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = global_grad_norm(grads)
    factor = torch.where(norm < clip_grad_norm, torch.ones_like(norm), clip_grad_norm / norm)
    for g in grads:
        local_part(g).mul_(factor)
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.step()
    return norm.detach()


def apply_gradients(state: TrainState, cfg: PoseTrainConfig) -> torch.Tensor:
    """clip_and_step at the scheduled lr of this update, and count the step.
    Returns the global norm of the unclipped gradients."""
    norm = clip_and_step(state.pp.net.parameters(), state.optimizer, cfg.clip_grad_norm,
                         lr_schedule(cfg)(state.step))
    state.step += 1
    return norm


def make_train_step(cfg: PoseTrainConfig, mesh_db):
    """train_step(state, batch, draws) → metrics (detached tensors, with
    grad_norm): one update of `state`, in place. On a state made with a
    param_mode (create_train_state) it is a data-parallel step over the
    process group, on this rank's rows of the global batch
    (parallel.shard_batch) and draws (draw_step with rank and world); its
    metrics are then the global batch's."""

    def train_step(state: TrainState, batch: dict, draws: dict) -> dict:
        state.optimizer.zero_grad(set_to_none=True)
        loss, metrics = loss_through(state.dp, pose_loss, state.pp, cfg, mesh_db, batch, draws)
        loss.backward()
        metrics["grad_norm"] = apply_gradients(state, cfg)
        return metrics if state.dp is None else mean_over_ranks(metrics)

    return train_step


def make_val_step(cfg: PoseTrainConfig, mesh_db):
    """val_step(state, batch, draws) → metrics: the train forward and loss
    (train-mode net, as in the JAX package) without augmentation, gradient or
    running-statistics update; data parallel as make_train_step."""

    def val_step(state: TrainState, batch: dict, draws: dict) -> dict:
        with torch.no_grad(), frozen_stats(state.pp.net):
            _, metrics = loss_through(state.dp, pose_loss, state.pp, cfg, mesh_db, batch, draws,
                                      False)
        return metrics if state.dp is None else mean_over_ranks(metrics)

    return val_step
