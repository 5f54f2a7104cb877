"""Run a function on N ranks, each a spawned process in one process group:
the launcher of the multi-process checks and of `dryrun_multichip` (torchrun
launches the training CLIs).

Children start from a fresh interpreter (the spawn start method: CUDA and
thread pools do not survive fork) and import the module that defines the
function, so it must be a module-level function of an importable module.
"""

from __future__ import annotations

import faulthandler
import pathlib
import socket
import tempfile
import time

import torch
import torch.multiprocessing as mp

from ..utils.device import resolve_device
from ..utils.distributed import destroy, get_tmp_dir, init_distributed_mode


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, fn, args, port, backend, device, n_threads, out_dir):
    faulthandler.enable()  # a rank that crashes prints its Python stack
    if n_threads is not None:
        torch.set_num_threads(n_threads)
    device = init_distributed_mode(backend, rank, world, local_rank=rank,
                                   init_method=f"tcp://localhost:{port}", device=device)
    try:
        result = fn(rank, world, device, *args)
        torch.save(result, pathlib.Path(out_dir) / f"rank{rank}.pt")
    finally:
        destroy()


def spawn(fn, world: int, args: tuple = (), backend: str = "gloo", device: str = "cuda",
          n_threads: int | None = None, timeout_s: float = 900.0) -> list:
    """fn(rank, world, device, *args) on `world` spawned ranks joined over
    `backend` (tcp://localhost on a free port) on `device` ("cuda" gives
    cuda:<rank>, "cuda:0" puts every rank on card 0, "cpu" runs on the host).
    Returns each rank's result in rank order. A rank that raises stops the
    others and raises here; so does a run past `timeout_s`. Without a card,
    a CUDA device raises resolve_device's error before any rank starts."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        resolve_device(device)
    with tempfile.TemporaryDirectory(dir=get_tmp_dir()) as out_dir:
        ctx = mp.start_processes(
            _rank_main, args=(world, fn, args, free_port(), backend, device, n_threads, out_dir),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.time() + timeout_s
        while not ctx.join(timeout=1.0):
            if time.time() > deadline:
                for p in ctx.processes:
                    p.terminate()
                for p in ctx.processes:
                    p.join(10.0)
                raise TimeoutError(f"{fn.__qualname__} on {world} ranks ran past {timeout_s} s")
        return [torch.load(pathlib.Path(out_dir) / f"rank{r}.pt", weights_only=False)
                for r in range(world)]
