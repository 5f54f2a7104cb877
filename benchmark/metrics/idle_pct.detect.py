"""Share of the profiled stretch of detection requests in which no kernel
or copy ran on the card."""

from benchmark.harness.readers import idle_pct


def read(run):
    return idle_pct(run)
