"""Process-group set-up and host-side helpers of data-parallel runs (port of
cosypose_tpu/utils/distributed.py).

The JAX package runs one controller over a device mesh; the port runs one
process per rank under torch.distributed, launched by torchrun (which sets
RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT) or by
`parallel.spawn`. The backend is explicit: NCCL for CUDA devices, gloo for
the CPU, or the one the caller names (gloo for two ranks sharing one card,
which NCCL refuses). Nothing here switches backend or device on its own.
"""

from __future__ import annotations

import contextlib
import os
import pathlib
import pickle
import time

import torch
import torch.distributed as dist

from ..config import LOCAL_DATA_DIR
from .device import resolve_device
from .logging import get_logger

logger = get_logger(__name__)

BACKEND_OF = {"cuda": "nccl", "cpu": "gloo"}


def init_distributed_mode(backend: str | None = None, rank: int | None = None,
                          world_size: int | None = None, local_rank: int | None = None,
                          init_method: str | None = None,
                          device: str | torch.device = "cuda") -> torch.device:
    """Join the process group and return this rank's device.

    Rank, world size and local rank come from the arguments, else from
    torchrun's environment; the rendezvous from `init_method`, else
    MASTER_ADDR/MASTER_PORT. Without a world size from either, this is a
    no-op at world size 1 (a single process, no group), as in the JAX
    package. `device` "cuda" gives cuda:LOCAL_RANK; a device with an index
    (e.g. "cuda:0" for two gloo ranks on one card) is kept as it is. The
    backend is `backend`, else NCCL for CUDA and gloo for the CPU.
    """
    device = torch.device(device)
    if world_size is None and "WORLD_SIZE" not in os.environ:
        return resolve_device(device)
    if dist.is_initialized():
        raise RuntimeError("the process group is already initialised")
    rank = int(os.environ["RANK"]) if rank is None else rank
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    local_rank = int(os.environ.get("LOCAL_RANK", rank)) if local_rank is None else local_rank
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", local_rank)
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = backend or BACKEND_OF[device.type]
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                            world_size=world_size)
    logger.info(f"rank {rank}/{world_size} on {device}, backend {backend}")
    return device


@contextlib.contextmanager
def distributed_mode(backend: str | None = None, device: str | torch.device = "cuda"):
    """init_distributed_mode for the block (yields the rank's device); the
    group it joined is left after the block. Inside a group the caller
    already joined, the block runs in it."""
    if dist.is_initialized():
        yield resolve_device(device)
        return
    device = init_distributed_mode(backend, device=device)
    try:
        yield device
    finally:
        destroy()


def destroy() -> None:
    """Leave the process group, where there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def get_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def get_world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def barrier() -> None:
    """Wait for every rank (nothing to wait for without a group)."""
    if dist.is_initialized():
        dist.barrier()


def collective_device() -> torch.device:
    """Where to make a tensor for the group's collectives: the current card
    under NCCL (which takes CUDA tensors only), host memory under gloo (which
    takes CPU and CUDA tensors)."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def get_tmp_dir() -> pathlib.Path:
    """Shared scratch directory of the file-based gathers: COSYPOSE_TPU_TMP,
    else <data dir>/tmp."""
    d = pathlib.Path(os.environ.get("COSYPOSE_TPU_TMP", LOCAL_DATA_DIR / "tmp"))
    d.mkdir(parents=True, exist_ok=True)
    return d


def reduce_dict(metrics: dict, average: bool = True) -> dict:
    """Sum (or average) a dict of numbers over the ranks: sorted keys, one
    all_reduce of a float64 vector. Returns floats; a copy at world size 1."""
    if get_world_size() == 1:
        return {k: float(v) for k, v in metrics.items()}
    keys = sorted(metrics)
    vec = torch.tensor([float(metrics[k]) for k in keys], dtype=torch.float64,
                       device=collective_device())
    dist.all_reduce(vec)
    if average:
        vec /= get_world_size()
    return {k: float(v) for k, v in zip(keys, vec.tolist())}


def file_all_gather(obj, gather_dir, process_id: int | None = None,
                    n_processes: int | None = None, timeout_s: float = 600.0):
    """Every process's `obj`, in process order, through a shared directory:
    each publishes <gather_dir>/<pid>.pkl atomically and polls for the rest
    until `timeout_s`. Needs no process group (process id and count default
    to its rank and world size). Returns None for one process. A shard left
    by an earlier gather in the same directory raises: use a fresh one."""
    process_id = get_rank() if process_id is None else process_id
    n_processes = get_world_size() if n_processes is None else n_processes
    if n_processes == 1:
        return None
    gather_dir = pathlib.Path(gather_dir)
    gather_dir.mkdir(parents=True, exist_ok=True)
    final = gather_dir / f"{process_id}.pkl"
    if final.exists():
        raise FileExistsError(f"{final} already exists: gather_dir was already used by a "
                              f"previous gather; point each run at a fresh directory")
    tmp = gather_dir / f"{process_id}.pkl.tmp"
    tmp.write_bytes(pickle.dumps(obj))
    tmp.rename(final)
    deadline = time.time() + timeout_s
    paths = [gather_dir / f"{p}.pkl" for p in range(n_processes)]
    while not all(p.exists() for p in paths):
        if time.time() > deadline:
            raise TimeoutError(f"gather timed out: missing "
                               f"{[str(p) for p in paths if not p.exists()]}")
        time.sleep(0.05)
    return [pickle.loads(p.read_bytes()) for p in paths]
