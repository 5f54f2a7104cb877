"""Faults planted under the detect cell's timed path, to show that its check
catches them. Importing this module adds them to checks/faults.py's table
(kind `detect`), so that `faults.get` and the readings find them; each takes
the Mask R-CNN model after set-up and before the first request.

    python3 benchmark/checks/detect_readings.py --workload ycbv-maskrcnn.frames \
        --seeds 1 2 3 --fault proposals_cut

The pasting faults break only what the model pastes, so they read in
`paste_px_share` alone: its limit lies between the program's readings and
theirs.
"""

from __future__ import annotations

import dataclasses

import torch

from benchmark.checks import faults
from cosypose_tpu_torch.ops import boxes as box_ops


def detect_proposals_cut(model):
    """The RPN keeps 500 proposals an image in place of 1,000."""
    model.cfg = dataclasses.replace(model.cfg, rpn_post_nms_top_n=500)


def detect_class_nms_skipped(model):
    """The box head's class NMS keeps every candidate (an IoU never passes
    1)."""
    model.cfg = dataclasses.replace(model.cfg, box_nms_thresh=1.0)


def _paste_with(model, paste):
    """model.segment with its pasting replaced by paste(probs, boxes, out_hw)."""
    def segment(feats, det, image_hw, out_hw, boxes):
        logits = model.mask_head(feats, det["boxes"], det["image_ids"], image_hw)
        idx = torch.arange(len(det["labels"]), device=logits.device)
        probs = logits[idx, det["labels"]].sigmoid()
        return logits, probs, paste(probs, boxes, out_hw)

    model.segment = segment


def detect_paste_unpadded(model):
    """Masks pasted without the one-cell pad: each 28x28 mask resized into
    its box as given, not into the box expanded by 30 / 28."""
    _paste_with(model, lambda probs, boxes, hw: box_ops.paste_masks(probs, boxes, hw, padding=0))


def detect_paste_shifted(model):
    """Masks pasted one pixel to the right of their boxes."""
    shift = torch.tensor([1.0, 0.0, 1.0, 0.0])
    _paste_with(model, lambda probs, boxes, hw: box_ops.paste_masks(
        probs, boxes + shift.to(boxes.device), hw))


faults.FAULTS["detect"] = ("proposals_cut", "class_nms_skipped", "paste_unpadded",
                           "paste_shifted")
faults.detect_proposals_cut = detect_proposals_cut
faults.detect_class_nms_skipped = detect_class_nms_skipped
faults.detect_paste_unpadded = detect_paste_unpadded
faults.detect_paste_shifted = detect_paste_shifted
