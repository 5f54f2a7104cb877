"""Device ms of the DeepIM crop an iteration: CUDA events around each
PosePredictor.crop call."""

from benchmark.harness.readers import mean_ms


def read(run):
    return mean_ms(run, "crop")
