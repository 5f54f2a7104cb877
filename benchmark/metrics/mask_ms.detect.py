"""Device ms of the mask branch a frame (RoIAlign 14x14 of the detections,
the mask head, the pasting): CUDA events around each MaskRCNN.segment
call."""

from benchmark.harness.readers import mean_ms


def read(run):
    return mean_ms(run, "mask")
