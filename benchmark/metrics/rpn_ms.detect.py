"""Device ms of the RPN a frame (head, top-k, decoding, NMS, the cut):
CUDA events around each MaskRCNN.region_proposals call."""

from benchmark.harness.readers import mean_ms


def read(run):
    return mean_ms(run, "rpn")
