"""Device ms of the network (backbone, pooling, head) an iteration: CUDA
events around each PoseNet call."""

from benchmark.harness.readers import mean_ms


def read(run):
    return mean_ms(run, "backbone")
