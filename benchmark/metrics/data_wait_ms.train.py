"""Host ms a step waited for the loader's next batch, over the window."""

from benchmark.harness.readers import mean_ms


def read(run):
    return mean_ms(run, "data_wait")
