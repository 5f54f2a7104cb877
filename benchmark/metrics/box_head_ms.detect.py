"""Device ms of the box head a frame (RoIAlign 7x7 of the proposals, the
MLP, the postprocess with its class NMS): CUDA events around each
MaskRCNN.detect call."""

from benchmark.harness.readers import mean_ms


def read(run):
    return mean_ms(run, "box_head")
