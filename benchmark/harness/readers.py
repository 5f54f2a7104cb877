"""Arithmetic the per-layer readers share. Each returns None where the run
has nothing to read (an untraced run, a span that never ran)."""

from __future__ import annotations

from benchmark.harness import counts


def mean_ms(run, span: str):
    ms = run.spans.get(span)
    return sum(ms) / len(ms) if ms else None


def idle_pct(run):
    p = run.profile
    if not p or p["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])


def render_roofline_pct(run):
    """The render calls' least time (their bytes at the card's peak
    bandwidth) over the device time of the kernels they launched, in the
    profiled stretch."""
    p = run.profile
    if not p or not p.get("render_kernel_s"):
        return None
    c = p["counters"]
    least = counts.render_bytes(c["render_rows"], p["render_faces"], c["render_pixels"]) \
        / counts.PEAK_BYTES_PER_S
    return 100.0 * least / p["render_kernel_s"]


def mfu_pct(run):
    """Useful FLOPs of the window over the window, against the peak of the
    configuration's dtype."""
    t = run.totals
    if run.window_s <= 0 or not t.get("useful_flops"):
        return None
    return 100.0 * t["useful_flops"] / run.window_s / t["peak_flops"]
