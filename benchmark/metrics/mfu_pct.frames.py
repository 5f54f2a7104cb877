"""Useful FLOPs (the plain network's, per detection or sample and
iteration; padding is no work) over the window, against the peak of the
configuration's dtype."""

from benchmark.harness.readers import mfu_pct


def read(run):
    return mfu_pct(run)
