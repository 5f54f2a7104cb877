"""The render calls' least time (inputs read once, outputs written once,
at 3.35 TB/s) over the device time of the kernels they launched."""

from benchmark.harness.readers import render_roofline_pct


def read(run):
    return render_roofline_pct(run)
