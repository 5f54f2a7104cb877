"""Useful FLOPs of the window (the plain Mask R-CNN's, at each frame's own
counts of proposals and detections; harness/detect_counts.py) over the
window, against the bf16 peak."""

from benchmark.harness.readers import mfu_pct


def read(run):
    return mfu_pct(run)
