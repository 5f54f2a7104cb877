"""Small cross-cutting utilities (port of cosypose_tpu/utils/misc.py)."""

from __future__ import annotations

import contextlib

import numpy as np


@contextlib.contextmanager
def temp_numpy_seed(seed):
    """Seed numpy's global generator for the enclosed block, then restore
    its state."""
    state = np.random.get_state()
    np.random.seed(seed)
    try:
        yield
    finally:
        np.random.set_state(state)


def get_total_memory_mb() -> float:
    """This process's resident memory in MB (0.0 where /proc is absent)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    return float(line.split()[1]) / 1024.0
    except OSError:
        pass
    return 0.0


def assign_gpu():
    """The reference pins CUDA_VISIBLE_DEVICES per process; here each entry
    point takes its device (`device=`, `cuda:LOCAL_RANK` under torchrun), so
    this is a no-op kept for the API's sake."""
    return None


def patch_tqdm():
    """The reference redirects tqdm to stdout; progress goes through
    utils.logging here, so this is a no-op kept for the API's sake."""
    return None
