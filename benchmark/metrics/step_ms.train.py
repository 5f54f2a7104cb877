"""Device ms a train step: CUDA events around each call of the step."""

from benchmark.harness.readers import mean_ms


def read(run):
    return mean_ms(run, "step")
