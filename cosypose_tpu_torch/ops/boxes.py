"""Box arithmetic of Mask R-CNN's eval path, in float32, as torchvision
computes it: anchors, the box coder's decoding, clipping, the small-box test,
and pasting masks into the image (the level of a box in the feature pyramid
is ops/roi_align.py's, beside the RoIAlign that reads it).

Every function takes and returns tensors without a host sync, and repeats
torchvision's float32 operations in their order, so that a plain reference
written from torchvision gets the same bits from the same inputs
(tests/torch_reference/maskrcnn.py).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

XFORM_CLIP = math.log(1000.0 / 16)


def base_anchors(size: float, aspect_ratios, device) -> torch.Tensor:
    """(A, 4) anchors of one size centred on 0, rounded (AnchorGenerator)."""
    scales = torch.tensor([size], dtype=torch.float32, device=device)
    ratios = torch.tensor(aspect_ratios, dtype=torch.float32, device=device)
    h_ratios = torch.sqrt(ratios)
    w_ratios = 1 / h_ratios
    ws = (w_ratios[:, None] * scales[None, :]).view(-1)
    hs = (h_ratios[:, None] * scales[None, :]).view(-1)
    return (torch.stack([-ws, -hs, ws, hs], dim=1) / 2).round()


def grid_anchors(grid_hw: tuple, padded_hw: tuple, size: float, aspect_ratios,
                 device) -> torch.Tensor:
    """(H * W * A, 4) anchors of one level in (y, x, anchor) order; the
    strides are the padded image's size // the grid's, as torchvision's."""
    fh, fw = grid_hw
    sy, sx = padded_hw[0] // fh, padded_hw[1] // fw
    shifts_x = torch.arange(0, fw, dtype=torch.int32, device=device) * sx
    shifts_y = torch.arange(0, fh, dtype=torch.int32, device=device) * sy
    shift_y, shift_x = torch.meshgrid(shifts_y, shifts_x, indexing="ij")
    shift_x, shift_y = shift_x.reshape(-1), shift_y.reshape(-1)
    shifts = torch.stack((shift_x, shift_y, shift_x, shift_y), dim=1)
    base = base_anchors(size, aspect_ratios, device)
    return (shifts.view(-1, 1, 4) + base.view(1, -1, 4)).reshape(-1, 4)


def decode(rel_codes: torch.Tensor, boxes: torch.Tensor, weights) -> torch.Tensor:
    """BoxCoder.decode_single: rel_codes (..., 4K) float32 against boxes
    (..., 4) -> (..., K, 4), the log-size deltas clipped at log(1000/16)."""
    widths = boxes[..., 2] - boxes[..., 0]
    heights = boxes[..., 3] - boxes[..., 1]
    ctr_x = boxes[..., 0] + 0.5 * widths
    ctr_y = boxes[..., 1] + 0.5 * heights
    wx, wy, ww, wh = weights
    dx = rel_codes[..., 0::4] / wx
    dy = rel_codes[..., 1::4] / wy
    dw = torch.clamp(rel_codes[..., 2::4] / ww, max=XFORM_CLIP)
    dh = torch.clamp(rel_codes[..., 3::4] / wh, max=XFORM_CLIP)
    pred_ctr_x = dx * widths[..., None] + ctr_x[..., None]
    pred_ctr_y = dy * heights[..., None] + ctr_y[..., None]
    c_to_c_w = 0.5 * (torch.exp(dw) * widths[..., None])
    c_to_c_h = 0.5 * (torch.exp(dh) * heights[..., None])
    return torch.stack((pred_ctr_x - c_to_c_w, pred_ctr_y - c_to_c_h, pred_ctr_x + c_to_c_w,
                        pred_ctr_y + c_to_c_h), dim=-1)


def clip(boxes: torch.Tensor, hw: tuple) -> torch.Tensor:
    """Boxes (..., 4) clamped into [0, w] x [0, h] (clip_boxes_to_image)."""
    h, w = hw
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack((x1.clamp(min=0, max=w), y1.clamp(min=0, max=h), x2.clamp(min=0, max=w),
                        y2.clamp(min=0, max=h)), dim=-1)


def not_small(boxes: torch.Tensor, min_size: float) -> torch.Tensor:
    """remove_small_boxes' test: both sides at least min_size."""
    return ((boxes[..., 2] - boxes[..., 0]) >= min_size) & \
        ((boxes[..., 3] - boxes[..., 1]) >= min_size)


def _paste_weights(lo: torch.Tensor, hi: torch.Tensor, size: int, cells: int) -> torch.Tensor:
    """(N, size, cells) bilinear weights of F.interpolate (align_corners
    False) from `cells` cells onto the integer span [lo, hi] of each row,
    cut to [0, size): pixel p takes output index p - lo of a resize to
    hi - lo + 1 pixels; outside the span its weights are 0."""
    n_out = torch.clamp(hi - lo + 1, min=1)
    p = torch.arange(size, device=lo.device)
    k = p[None, :] - lo[:, None]
    inside = (k >= 0) & (p[None, :] <= hi[:, None]) & (k < n_out[:, None])
    scale = cells / n_out.to(torch.float32)
    src = (scale[:, None] * (k.to(torch.float32) + 0.5) - 0.5).clamp(min=0)
    i0 = src.to(torch.int64)
    i1 = torch.where(i0 < cells - 1, i0 + 1, i0)
    l1 = src - i0.to(torch.float32)
    l0 = 1.0 - l1
    w = torch.zeros(*k.shape, cells, device=lo.device)
    w.scatter_add_(-1, i0.clamp(max=cells - 1)[..., None], l0[..., None])
    w.scatter_add_(-1, i1.clamp(max=cells - 1)[..., None], l1[..., None])
    return torch.where(inside[..., None], w, 0.0)


def paste_masks(probs: torch.Tensor, boxes: torch.Tensor, image_hw: tuple,
                padding: int = 1) -> torch.Tensor:
    """paste_masks_in_image for all masks at once: probs (N, M, M) float32,
    boxes (N, 4) in the image's pixels -> (N, H, W) float32. Each mask is
    padded by `padding` cells, its box expanded by (M + 2 padding) / M and
    truncated to integers, and the bilinear resize into the box (separable:
    rows and columns) is two batched matrix products with the resize's
    weights; pixels outside the box are 0."""
    M = probs.shape[-1]
    scale = float(M + 2 * padding) / M
    padded = F.pad(probs, (padding,) * 4)
    w_half = (boxes[:, 2] - boxes[:, 0]) * 0.5
    h_half = (boxes[:, 3] - boxes[:, 1]) * 0.5
    x_c = (boxes[:, 2] + boxes[:, 0]) * 0.5
    y_c = (boxes[:, 3] + boxes[:, 1]) * 0.5
    w_half = w_half * scale
    h_half = h_half * scale
    ib = torch.stack([x_c - w_half, y_c - h_half, x_c + w_half, y_c + h_half], 1).to(torch.int64)
    H, W = image_hw
    cells = M + 2 * padding
    ry = _paste_weights(ib[:, 1], ib[:, 3], H, cells)
    rx = _paste_weights(ib[:, 0], ib[:, 2], W, cells)
    return ry @ padded @ rx.transpose(1, 2)
