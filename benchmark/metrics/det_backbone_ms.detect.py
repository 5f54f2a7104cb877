"""Device ms of Mask R-CNN's backbone (ResNet-50 and the FPN) a frame: CUDA
events around each MaskRCNN.features call."""

from benchmark.harness.readers import mean_ms


def read(run):
    return mean_ms(run, "det_backbone")
