"""Profiling surface: the program's spans and counters, and torch.profiler
traces (port of cosypose_tpu/utils/profiling.py, which captures jax.profiler
traces).

Spans. `annotate(name, **attrs)` opens a span. The port's serving path opens
its own, named `cosypose.<layer>` (below). A span is one of three things:

- tracing off and no profiler session (the default): one flag check and one
  check of the profiler's state, then a shared no-op context;
- a torch.profiler session active (`trace(dir)`, or any other): a
  `record_function` range of the same name, on the profiler's timeline and
  clock beside the kernels and copies it launched;
- inside `tracing()`, also a record kept in memory: the name and attributes,
  its id, its parent's id and its request id (the id of the outermost span
  open around it), host start and end (`time.perf_counter_ns`) and, where
  the process had used the card when tracing began, device start and end from
  two CUDA events, on the host's clock.

`count(name, n)` adds to a counter of the request the innermost open span
belongs to (request None outside any span), inside `tracing()` only.
`collect()` synchronises once, resolves the events and returns
{"spans": [...], "counters": {request: {name: n}}}, then forgets them.

    with tracing():
        predictor.get_predictions(...)
    records = collect()

Inside `tracing()` on the card, every host-device synchronisation that
torch's sync debug mode sees (each one caught as its warning; the mode does
not see them all, so this is a floor) adds 1 to the innermost open span's
`syncs` and to its request's `syncs` counter. The raster kernels' ctypes
launchers make no synchronising call. While torch.export or
torch.compile traces the code, a span and a counter do nothing, so the
exported graph is the same with tracing on or off.

The port's spans (`cosypose.` left out):

  serve.request    CoarseRefinePosePredictor.get_predictions  detections, chunks (a model's)
  serve.init       make_TCO_init
  serve.chunk      one chunk of batched_model_predictions      model; counters rows,
                                                              useful_rows (x iterations)
  serve.gather     the chunk's ids, labels, image ids, mesh data
  serve.collect    the chunk's per-iteration TensorCollections
  model.iteration  PosePredictor._iteration (eval and train)   counter iterations
  model.crop       PosePredictor.crop
  model.render     the render of network_input                 rows, pixels
  model.backbone   PoseNet.forward (backbone, pooling, head)
  backbone.stem, backbone.stage1 ... stage7, backbone.head     EfficientNet.forward,
                                                              a span a row of BASE_BLOCKS
  model.update     PosePredictor.update_pose
  detector.request   MaskRCNN.forward                            images
  detector.backbone  MaskRCNN.features: ResNet-50, FPN
  detector.rpn       MaskRCNN.region_proposals: head, top-k,     counters anchors, nms_in,
                     decoding, NMS, the cut                      proposals
  detector.box       MaskRCNN.detect: RoIAlign 7x7, MLP,         counters nms_in, detections
                     postprocess
  detector.mask      MaskRCNN.segment: RoIAlign 14x14, mask head,
                     pasting
  detector.nms       each NMS call, inside rpn and box           boxes; counter nms (launches,
                                                              ops/nms_cuda.py)

Traces. `trace(dir)` captures a torch.profiler trace of a region (the host's
operators, the program's ranges and, on a CUDA card, its kernels by CUPTI)
and writes it as a Chrome trace (`<log_dir>/trace_<pid>_<n>.json`, for
chrome://tracing or Perfetto):

  with trace("/tmp/traces"):
      run_step()

  COSYPOSE_TPU_TRACE_DIR=/tmp/traces python -m cosypose_tpu_torch.scripts...
      → train_pose calls `maybe_start_trace()` / `stop_trace()` around its
        epoch loop when the variable is set.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import pathlib
import time
import warnings

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from .logging import get_logger

logger = get_logger(__name__)

ENV_VAR = "COSYPOSE_TPU_TRACE_DIR"
SYNC_WARNING = "called a synchronizing CUDA operation"  # torch's sync debug mode
_COUNTER = itertools.count()
# the trace maybe_start_trace opened, until stop_trace closes it
_ACTIVE: dict = {"profiler": None, "dir": None}

_ON = False  # inside tracing()
_OFF = contextlib.nullcontext()
_profiler_on = torch._C._autograd._profiler_enabled
# open spans (innermost last), spans since the last collect(), counters by
# request, span ids, and the (event, host ns) pair device times are read from
_STATE: dict = {"open": [], "spans": [], "counters": {}, "ids": itertools.count(1),
                "anchor": None}


def _compiling() -> bool:
    return torch.compiler.is_compiling() or torch.compiler.is_exporting()


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


class _Span:
    __slots__ = ("name", "attrs", "range", "record")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs, self.range, self.record = name, attrs, None, None

    def __enter__(self):
        if _profiler_on():
            self.range = record_function(self.name)
            self.range.__enter__()
        if _ON:
            self.record = _open(self.name, self.attrs)
        return self

    def __exit__(self, *exc):
        if self.record is not None:
            _close(self.record)
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def annotate(name: str, **attrs):
    """A span named `name` with attributes `attrs` (module docstring): a
    no-op unless a profiler session is active or tracing() is on."""
    if not _ON and not _profiler_on():
        return _OFF
    if _compiling():
        return _OFF
    return _Span(name, attrs)


def _open(name: str, attrs: dict) -> dict:
    st = _STATE
    parent = st["open"][-1] if st["open"] else None
    sid = next(st["ids"])
    record = {"name": name, "attrs": attrs, "id": sid,
              "parent": parent["id"] if parent else None,
              "request": parent["request"] if parent else sid, "syncs": 0,
              "host_start_ns": time.perf_counter_ns(), "host_end_ns": None,
              "device_start_ns": None, "device_end_ns": None}
    if st["anchor"] is not None:
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        record["_events"] = (st["anchor"], start)
    st["open"].append(record)
    st["spans"].append(record)
    return record


def _close(record: dict) -> None:
    if "_events" in record:
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        record["_events"] += (end,)
    record["host_end_ns"] = time.perf_counter_ns()
    _STATE["open"].pop()  # spans nest: the record is the innermost


def _add(request, name: str, n) -> None:
    counters = _STATE["counters"].setdefault(request, {})
    counters[name] = counters.get(name, 0) + n


def count(name: str, n=1) -> None:
    """Add n to the counter `name` of the current request, inside tracing()."""
    if not _ON or _compiling():
        return
    st = _STATE
    _add(st["open"][-1]["request"] if st["open"] else None, name, n)


def _on_warning(show, message, category, filename, lineno, file=None, line=None):
    """showwarning inside tracing(): a sync is counted, not shown."""
    if SYNC_WARNING not in str(message):
        show(message, category, filename, lineno, file, line)
    elif _STATE["open"]:
        innermost = _STATE["open"][-1]
        innermost["syncs"] += 1
        _add(innermost["request"], "syncs", 1)


@contextlib.contextmanager
def tracing():
    """Keep the program's spans and counters in memory (module docstring)
    until collect()."""
    global _ON
    with contextlib.ExitStack() as stack:
        stack.enter_context(warnings.catch_warnings())
        warnings.filterwarnings("always", message=SYNC_WARNING)
        # torch warns that the mode does not see every sync: `syncs` is a floor
        warnings.filterwarnings("ignore", message="Synchronization debug mode is a prototype")
        show = warnings.showwarning
        warnings.showwarning = lambda *a, **k: _on_warning(show, *a, **k)
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
            anchor = torch.cuda.Event(enable_timing=True)
            anchor.record()
            _STATE["anchor"] = (anchor, time.perf_counter_ns())
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
            stack.callback(torch.cuda.set_sync_debug_mode, mode)
        _ON = True
        try:
            yield
        finally:
            _ON = False
            _STATE["anchor"] = None


def collect() -> dict:
    """The spans and counters kept since the last collect(), device times
    resolved (one synchronise); forgets them. Call it with no span open."""
    st = _STATE
    if st["open"]:
        raise RuntimeError(f"collect() inside the open span {st['open'][-1]['name']!r}")
    spans, counters = st["spans"], st["counters"]
    st["spans"], st["counters"] = [], {}
    if any("_events" in s for s in spans):
        torch.cuda.synchronize()
    for s in spans:
        if "_events" in s:
            (anchor, host_ns), *events = s.pop("_events")
            s["device_start_ns"], s["device_end_ns"] = (
                host_ns + round(1e6 * anchor.elapsed_time(e)) for e in events)
    return {"spans": spans, "counters": counters}


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
