"""The NMS kernel's least time (its calls' bytes, harness/detect_counts.py,
at 3.35 TB/s) over its device time in the profiled stretch with the
harness's wrappers: a latency-bound kernel reads far below 100."""

from benchmark.harness import counts


def read(run):
    p = run.profile
    if not p or not p.get("nms_kernel_s") or not p["counters"].get("nms_bytes"):
        return None
    return 100.0 * p["counters"]["nms_bytes"] / counts.PEAK_BYTES_PER_S / p["nms_kernel_s"]
