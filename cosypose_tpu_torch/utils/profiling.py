"""Profiling surface: torch.profiler traces (port of
cosypose_tpu/utils/profiling.py, which captures jax.profiler traces).

  with trace("/tmp/traces"):            # capture one region
      run_step()

  COSYPOSE_TPU_TRACE_DIR=/tmp/traces python -m cosypose_tpu_torch.scripts...
      → train_pose calls `maybe_start_trace()` / `stop_trace()` around its
        epoch loop when the variable is set.

A trace records the host's operators and, where a CUDA card is present, the
card's kernels (CUPTI), and is written as a Chrome trace
(`<log_dir>/trace_<pid>_<n>.json`, for chrome://tracing or Perfetto).
"""

from __future__ import annotations

import contextlib
import itertools
import os
import pathlib

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from .logging import get_logger

logger = get_logger(__name__)

ENV_VAR = "COSYPOSE_TPU_TRACE_DIR"
_COUNTER = itertools.count()
# the trace maybe_start_trace opened, until stop_trace closes it
_ACTIVE: dict = {"profiler": None, "dir": None}


def _start(log_dir) -> profile:
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def _stop(prof: profile, log_dir) -> pathlib.Path:
    prof.stop()
    log_dir = pathlib.Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    path = log_dir / f"trace_{os.getpid()}_{next(_COUNTER)}.json"
    prof.export_chrome_trace(str(path))
    logger.info(f"profiler trace written to {path}")
    return path


@contextlib.contextmanager
def trace(log_dir):
    """Capture a torch.profiler trace of the enclosed region into log_dir.
    Yields the profiler (its key_averages() read what was recorded); the
    file's path is its `trace_path` once the region ends."""
    prof = _start(log_dir)
    try:
        yield prof
    finally:
        prof.trace_path = _stop(prof, log_dir)


def annotate(name: str):
    """A named range inside an active trace (shows up on the timeline)."""
    return record_function(name)


def maybe_start_trace():
    """Start a trace iff COSYPOSE_TPU_TRACE_DIR is set (the CLIs' hook)."""
    log_dir = os.environ.get(ENV_VAR)
    if log_dir and _ACTIVE["profiler"] is None:
        _ACTIVE.update(profiler=_start(log_dir), dir=log_dir)
        logger.info(f"profiler tracing to {log_dir} (env {ENV_VAR})")


def stop_trace():
    """Write and close the trace maybe_start_trace opened, if any."""
    if _ACTIVE["profiler"] is not None:
        _stop(_ACTIVE["profiler"], _ACTIVE["dir"])
        _ACTIVE.update(profiler=None, dir=None)
