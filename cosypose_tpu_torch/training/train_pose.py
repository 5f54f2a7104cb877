"""Pose-model training loop (port of cosypose_tpu/training/train_pose.py).

Dataset concat with repeat factors, an epoch loop over a fixed epoch_size
sampler, validation every val_epoch_interval epochs, checkpoints every
save_epoch_interval epochs, jsonlines logging with the per-epoch split of
host data time and step time, resume and pretrain. Batches come from a
torch.utils.data.DataLoader over the JAX package's sampler and batch order
(full batches only), in place of its threaded PrefetchLoader. Its worker
processes each hold a copy of the datasets: `seed_worker` gives each copy its
own random streams, from the epoch, the worker's id and the rank.

Under a process group (torchrun, utils.distributed.init_distributed_mode)
the run is data parallel: the global batch is batch_size × world, every rank
walks the same sampler order of global batches and loads its contiguous
slice of each (RankBatchSampler), so the ranks together consume the JAX
package's batches; rank 0 writes the config, the log and the checkpoints and
runs the evaluation callback while the others wait.
"""

from __future__ import annotations

import contextlib
import functools
import pathlib
import time

import numpy as np
import torch
from torch.utils.data import DataLoader

from ..config import EXP_DIR
from ..data.pose_dataset import collate
from ..data.wrappers import ConcatDataset, PartialSampler, RankBatchSampler
from ..utils.device import resolve_device
from ..utils.distributed import barrier, get_rank, get_world_size, reduce_dict
from ..utils.logging import get_logger
from ..utils.profiling import maybe_start_trace, stop_trace
from .checkpoint import (latest_checkpoint, load_checkpoint, load_net_state, restore_into_state,
                         save_checkpoint, save_config)
from .logs import MetricsAccumulator, RunLogger
from .pose_training import create_train_state, draw_step, make_train_step, make_val_step

logger = get_logger(__name__)


def reseed_datasets(dataset, entropy: list, rank: int = 0) -> None:
    """Reseed each dataset (of a ConcatDataset) that has random streams
    (`reseed`), from (entropy, its index) and, on ranks other than 0, the
    rank."""
    datasets = getattr(dataset, "datasets", [dataset])
    for i, ds in enumerate({id(d): d for d in datasets}.values()):
        if hasattr(ds, "reseed"):
            seq = np.random.SeedSequence([*entropy, i, *([rank] if rank else [])])
            ds.reseed(int(seq.generate_state(1)[0]))


def seed_worker(epoch: int, worker_id: int, rank: int = 0) -> None:
    """DataLoader worker_init_fn: reseed the worker's copy of the datasets
    from (epoch, worker id) and the rank."""
    reseed_datasets(torch.utils.data.get_worker_info().dataset, [epoch, worker_id], rank)


def make_loader(dataset, sampler, batch_size: int, n_workers: int, pin_memory: bool,
                epoch: int = 0, collate_fn=collate, rank: int = 0, world: int = 1):
    """Full global batches of `batch_size` in the sampler's order, of which
    this rank loads its contiguous rows; worker processes (spawned, reseeded
    by seed_worker) when n_workers > 0."""
    if len(sampler) < batch_size:
        raise ValueError(f"epoch_size {len(sampler)} < batch {batch_size}: "
                         "no full batch can be formed")
    return DataLoader(dataset, batch_sampler=RankBatchSampler(sampler, batch_size, rank, world),
                      collate_fn=collate_fn, num_workers=n_workers, pin_memory=pin_memory,
                      multiprocessing_context="spawn" if n_workers > 0 else None,
                      worker_init_fn=functools.partial(seed_worker, epoch, rank=rank)
                      if n_workers else None)


@contextlib.contextmanager
def on_rank_zero(state):
    """Rank 0 runs the block while the others wait (at a barrier after it);
    under FSDP every rank first gathers the whole parameters. Yields whether
    this rank runs the block."""
    with state.dp.full_params() if state.dp is not None else contextlib.nullcontext():
        try:
            yield get_rank() == 0
        finally:
            barrier()


def train_pose(cfg, scene_datasets, mesh_db, resume: bool = False,
               pretrain_run_id: str | None = None, exp_dir=None, eval_callback=None,
               device: str | torch.device = "cuda", param_mode: str = "replicated"):
    """Run the training loop; returns (train state, run directory).

    cfg: training.configs.RunConfig. scene_datasets: {'train': [(ds, repeat)],
    'val': [...]} of PoseDataset-shaped datasets (items: image uint8 CHW, K,
    TCO, bbox, label). mesh_db: BatchedMeshes of the training objects on
    `device`. eval_callback: fn(state, epoch) → metrics dict, run every
    cfg.test_epoch_interval epochs and at the last one (on rank 0).
    param_mode: 'replicated' or 'fsdp' under a process group (read only
    there).
    """
    device = resolve_device(device)
    if mesh_db.device != device:
        raise ValueError(f"mesh_db is on {mesh_db.device}, training on {device}")
    rank, world = get_rank(), get_world_size()
    exp_dir = pathlib.Path(exp_dir or EXP_DIR)
    run_dir = exp_dir / cfg.run_id
    run_logger = None
    if rank == 0:
        run_dir.mkdir(parents=True, exist_ok=True)
        save_config(run_dir, cfg)
        run_logger = RunLogger(run_dir)

    tcfg = cfg.train
    mode = param_mode if torch.distributed.is_initialized() else None
    state = create_train_state(tcfg, device, torch.Generator().manual_seed(0), mode)
    start_epoch = 0
    if pretrain_run_id:
        ckpt = latest_checkpoint(exp_dir / pretrain_run_id)
        if ckpt is None:
            raise FileNotFoundError(f"no checkpoint for pretrain run {pretrain_run_id}")
        load_net_state(state, load_checkpoint(ckpt)["net"])
        logger.info(f"Loaded pretrain weights from {ckpt}")
    if resume:
        ckpt = latest_checkpoint(run_dir)
        if ckpt is not None:
            payload = load_checkpoint(ckpt)
            restore_into_state(state, payload)
            start_epoch = int(payload["epoch"]) + 1
            logger.info(f"Resumed from {ckpt} at epoch {start_epoch}")

    step_fn = make_train_step(tcfg, mesh_db)
    val_fn = make_val_step(tcfg, mesh_db)
    train_ds = ConcatDataset(scene_datasets["train"])
    val_ds = ConcatDataset(scene_datasets["val"]) if scene_datasets.get("val") else None
    if rank and not cfg.n_dataloader_workers:  # each rank's copy of the datasets its own streams
        reseed_datasets(train_ds, [], rank)
    global_batch = tcfg.batch_size * world
    generator = torch.Generator().manual_seed(1)
    n_points = mesh_db.points.shape[1]
    pin = device.type == "cuda"

    def device_batch(batch):
        return dict(images=batch["images"].to(device, non_blocking=True),
                    K=batch["K"].to(device, non_blocking=True),
                    TCO=batch["TCO"].to(device, non_blocking=True),
                    bboxes=batch["bboxes"].to(device, non_blocking=True),
                    label_ids=mesh_db.ids_for(batch["labels"]))

    maybe_start_trace()  # honours COSYPOSE_TPU_TRACE_DIR
    try:
        for epoch in range(start_epoch, tcfg.n_epochs):
            loader = make_loader(train_ds, PartialSampler(train_ds, tcfg.epoch_size, seed=epoch),
                                 global_batch, cfg.n_dataloader_workers, pin, epoch, rank=rank,
                                 world=world)
            acc = MetricsAccumulator()
            # per-epoch split: host data wait vs dispatch + device time of the steps
            waits, t_step = [], 0.0
            t_last, n_steps = time.time(), 0
            t_mark = time.perf_counter()
            for batch in loader:
                waits.append(time.perf_counter() - t_mark)  # the first starts the workers
                draws = draw_step(tcfg, state.pp, global_batch, n_points, generator, rank, world)
                metrics = step_fn(state, device_batch(batch), draws)
                acc.add(metrics)  # tensors; converted at epoch end
                n_steps += 1
                if time.time() - t_last > 60.0:
                    logger.info(f"epoch {epoch}: step {n_steps}, "
                                f"loss {float(metrics['loss_total']):.4f}")
                    t_last = time.time()
                t_step += time.perf_counter() - t_mark
                t_mark = time.perf_counter()
            if n_steps:
                # the steps run ahead of the card: wait for the last one, and
                # charge the tail to the step time
                float(metrics["loss_total"])
                t_step += time.perf_counter() - t_mark
                # the later half's wait: batches asked for after training began,
                # past what the loader's workers queue before the first step when
                # the epoch is longer than twice that queue
                acc.add({"data_s_per_step": sum(waits) / n_steps,
                         "step_s_per_step": t_step / n_steps,
                         "data_s_first_batch": waits[0],
                         "data_s_second_half": float(np.mean(waits[n_steps // 2:]))})

            # the step metrics are the global batch's already; the host timings
            # are averaged over the ranks
            record = reduce_dict(acc.means())
            if rank == 0:
                record = run_logger.append(epoch, record)
                logger.info(f"epoch {epoch}: {record}")
            if epoch % cfg.save_epoch_interval == 0:
                save_checkpoint(run_dir, state, epoch)
            if eval_callback is not None and (epoch % cfg.test_epoch_interval == 0
                                              or epoch == tcfg.n_epochs - 1):
                with on_rank_zero(state) as runs:
                    test_metrics = eval_callback(state, epoch) if runs else None
                    if test_metrics:
                        run_logger.append(epoch, {},
                                          extra={f"test/{k}": v for k, v in test_metrics.items()})
            if val_ds is not None and epoch % cfg.val_epoch_interval == 0:
                val_sampler = PartialSampler(val_ds, max(global_batch, tcfg.epoch_size // 10),
                                             seed=0)
                val_acc = MetricsAccumulator()
                for batch in make_loader(val_ds, val_sampler, global_batch,
                                         cfg.n_dataloader_workers, pin, epoch, rank=rank,
                                         world=world):
                    draws = draw_step(tcfg, state.pp, global_batch, n_points, generator, rank,
                                      world)
                    val_acc.add(val_fn(state, device_batch(batch), draws))
                if rank == 0:
                    run_logger.append(epoch, {},
                                      extra={f"val/{k}": v for k, v in val_acc.means().items()})
    finally:
        stop_trace()
    save_checkpoint(run_dir, state, tcfg.n_epochs - 1)
    return state, run_dir
