"""What the traced run records, from the benchmark's own files: spans around
the calls into the program's layers (CUDA events on the card, the host clock
elsewhere), counters the wrappers keep, and one short torch.profiler session
over a steady stretch of the cell's traffic.

The wrappers replace attributes of the program's objects at run time, for the
traced run only, and edit nothing. The profiler session is short and comes
first in the process: on the card the profiler loses device records of
sessions in a process that has run for long.
"""

from __future__ import annotations

import contextlib
import functools
import time

import torch


class Spans:
    """Named spans and counters. `wrap(owner, attr, name)` times every call of
    owner.attr; `count(name, n)` adds to a counter."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.open: dict[str, list] = {}
        self.counters: dict[str, float] = {}
        self.restore: list = []

    def mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def count(self, name: str, n: float = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    @contextlib.contextmanager
    def span(self, name: str):
        start = self.mark()
        with torch.profiler.record_function(f"bench.{name}"):
            yield
        self.open.setdefault(name, []).append((start, self.mark()))

    def wrap(self, owner, attr: str, name: str, before=None):
        """Time owner.attr under `name`; before(*args, **kwargs), where given,
        runs first (a wrapper's counters)."""
        inner = getattr(owner, attr)
        had_own = attr in vars(owner) if hasattr(owner, "__dict__") else False

        @functools.wraps(inner)
        def timed(*args, **kwargs):
            if before is not None:
                before(*args, **kwargs)
            with self.span(name):
                return inner(*args, **kwargs)

        setattr(owner, attr, timed)
        self.restore.append((owner, attr, inner if had_own else None))
        return timed

    def unwrap(self) -> None:
        for owner, attr, inner in reversed(self.restore):
            if inner is None:
                delattr(owner, attr)
            else:
                setattr(owner, attr, inner)
        self.restore.clear()

    def ms(self) -> dict[str, list[float]]:
        """Milliseconds of every closed span, by name (waits for the device)."""
        if self.cuda:
            torch.cuda.synchronize()
            return {k: [a.elapsed_time(b) for a, b in v] for k, v in self.open.items()}
        return {k: [1e3 * (b - a) for a, b in v] for k, v in self.open.items()}


def profile(fn, device, host: bool = False) -> dict:
    """Run fn() under torch.profiler. Returns {kernels: {name: (seconds,
    count)}, busy_s, window_s, gaps: [(label, seconds)], render_kernel_s}:
    busy_s is the union of the card's kernel, copy and set intervals, window_s
    the session's length on the host clock.

    host=False records the card's activity alone, which leaves the host's
    pace as it is: the session for busy and idle time. host=True records the
    host's ops as well, which slows the host: the session that attributes
    kernels to the harness's spans (render_kernel_s, the card time of the
    kernels launched inside `bench.render` spans) and labels each idle gap
    by the innermost `bench.` span the host was in when it began."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    cuda = torch.device(device).type == "cuda"
    acts = ([ProfilerActivity.CPU] if host or not cuda else []) + \
        ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        if cuda:
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    events = prof.events()
    # the card's own work, not the annotations that mirror host spans on it
    work = [e for e in events if e.device_type == DeviceType.CUDA
            and not e.name.startswith("bench.") and not getattr(e, "is_user_annotation", False)]
    spans = [e for e in events if e.device_type == DeviceType.CPU and e.name.startswith("bench.")]
    kernels: dict[str, list] = {}
    for e in work:
        k = kernels.setdefault(e.name, [0.0, 0])
        k[0] += (e.time_range.end - e.time_range.start) / 1e6
        k[1] += 1
    merged = []
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in work):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged) / 1e6
    # each kernel is listed once, on the host op that launched it
    renders = [h.time_range for h in spans if h.name == "bench.render"]
    render_s = 0.0
    for e in events:
        if e.device_type == DeviceType.CPU and getattr(e, "kernels", None) and any(
                r.start <= e.time_range.start <= r.end for r in renders):
            render_s += sum(k.duration for k in e.kernels) / 1e6
    gaps = []
    for (_, end), (nxt, _) in zip(merged, merged[1:]):
        inside = [h for h in spans if h.time_range.start <= end < h.time_range.end]
        label = min(inside, key=lambda h: h.time_range.end - h.time_range.start).name \
            if inside else ("outside bench spans" if host else "unlabelled")
        gaps.append((label, (nxt - end) / 1e6))
    return dict(kernels={k: tuple(v) for k, v in kernels.items()}, busy_s=busy,
                window_s=window_s, gaps=gaps, render_kernel_s=render_s)


def breakdown(prof: dict) -> dict:
    """The ten device operations that took most time, and the ten longest
    idle gaps summed by what the host was doing."""
    ops = sorted(((k, v[0]) for k, v in prof["kernels"].items()), key=lambda kv: -kv[1])
    by_label: dict[str, float] = {}
    for label, s in prof["gaps"]:
        by_label[label] = by_label.get(label, 0.0) + s
    gaps = sorted(by_label.items(), key=lambda kv: -kv[1])
    return dict(device_ops=[[k, v] for k, v in ops[:10]],
                idle_gaps=[[k, v] for k, v in gaps[:10]])
