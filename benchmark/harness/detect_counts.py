"""The detect cell's yardstick: the plain Mask R-CNN's useful FLOPs a frame,
at the frame's own counts of proposals and detections, and the least bytes
of an NMS call.

FLOPs are counted by FlopCounterMode on the meta device over the plain
reference (benchmark/reference/maskrcnn.py): its convolutions, transposed
convolution and linear layers, 2 a multiply-add. RoIAlign, NMS, decoding
and pasting are not counted (no multiply-adds of a matrix engine). Like
harness/counts.py, the counts depend on the configuration and the frame's
counts only, never on how the program lays out its work.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference import maskrcnn as ref_mrcnn


def _counted(fn) -> float:
    counter = FlopCounterMode(display=False)
    with counter:
        fn()
    return float(counter.get_total_flops())


@functools.lru_cache(maxsize=None)
def _params(n_classes: int) -> dict:
    return {k: torch.zeros(s, device="meta") for k, s in ref_mrcnn.param_shapes(n_classes).items()}


@functools.lru_cache(maxsize=None)
def frame_flops(padded_hw: tuple, n_classes: int) -> float:
    """ResNet-50, the FPN and the RPN head over one padded frame."""
    p = _params(n_classes)
    x = torch.zeros(1, 3, *padded_hw, device="meta")
    return _counted(lambda: ref_mrcnn.rpn_head(p, ref_mrcnn.features(p, x, 1e-5)))


@functools.lru_cache(maxsize=None)
def proposal_flops(n_classes: int) -> float:
    """The box head (two linear layers of 1,024 and the predictor) on one
    proposal's 256 x 7 x 7 RoI."""
    p = _params(n_classes)
    x = torch.zeros(1, ref_mrcnn.FPN_CH * 7 * 7, device="meta")
    rh = "roi_heads"

    def head():
        h = ref_mrcnn.linear(p, f"{rh}.box_head.fc7", ref_mrcnn.linear(p, f"{rh}.box_head.fc6", x))
        ref_mrcnn.linear(p, f"{rh}.box_predictor.cls_score", h)
        ref_mrcnn.linear(p, f"{rh}.box_predictor.bbox_pred", h)

    return _counted(head)


@functools.lru_cache(maxsize=None)
def detection_flops(n_classes: int) -> float:
    """The mask head (four 3x3 convs, the 2x deconv, the 1x1 logits) on one
    detection's 256 x 14 x 14 RoI."""
    p = _params(n_classes)
    x = torch.zeros(1, ref_mrcnn.FPN_CH, 14, 14, device="meta")
    rh = "roi_heads"

    def head():
        y = x
        for k in range(1, 5):
            y = ref_mrcnn.conv(p, f"{rh}.mask_head.mask_fcn{k}", y, padding=1)
        name = f"{rh}.mask_predictor.conv5_mask"
        y = torch.nn.functional.conv_transpose2d(y, p[f"{name}.weight"], p[f"{name}.bias"],
                                                 stride=2)
        ref_mrcnn.conv(p, f"{rh}.mask_predictor.mask_fcn_logits", y)

    return _counted(head)


def useful_flops(frames: int, proposals: int, detections: int, padded_hw: tuple,
                 n_classes: int) -> float:
    return (frames * frame_flops(tuple(padded_hw), n_classes)
            + proposals * proposal_flops(n_classes) + detections * detection_flops(n_classes))


def nms_bytes(n_boxes: int, n_groups: int) -> int:
    """The least traffic of one NMS call over n_boxes in n_groups: each box
    (16 bytes), its valid flag and the group offsets read once, each keep
    flag written once."""
    return n_boxes * (16 + 1 + 1) + (n_groups + 1) * 8
