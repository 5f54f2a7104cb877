"""roi_align crop extraction as two batched matmuls (port of the separable form
in cosypose_tpu/ops/roi_align.py).

Bilinear sampling is linear in the image and roi_align's sample grid is
axis-separable, so one crop is `Wy[b] @ image[b] @ Wx[b]^T`, with banded
interpolation-weight matrices Wy (out_h, H) and Wx (out_w, W). Semantics are
torchvision's aligned=False: samples below -1 or beyond the size contribute
0, others are clamped into the image.
"""

from __future__ import annotations

import torch


def _axis_weights(start: torch.Tensor, roi_extent: torch.Tensor, out: int, s: int,
                  size: int) -> torch.Tensor:
    """(B, out, size) bilinear weights, averaged over the s samples of each bin."""
    bin_size = roi_extent / out
    i = (torch.arange(out * s, dtype=torch.float32, device=start.device) + 0.5) / s
    coords = start[:, None] + i[None, :] * bin_size[:, None]  # (B, out*s)

    oob = (coords < -1.0) | (coords > size)
    c = coords.clamp(0.0, size - 1)
    c0 = torch.floor(c)
    frac = c - c0
    c1 = (c0 + 1.0).clamp_max(size - 1)

    p = torch.arange(size, dtype=torch.float32, device=start.device)
    w = ((p == c0[..., None]) * (1.0 - frac[..., None])
         + (p == c1[..., None]) * frac[..., None])  # (B, out*s, size)
    w = torch.where(oob[..., None], 0.0, w)
    return w.reshape(start.shape[0], out, s, size).mean(dim=2)


def roi_align(images: torch.Tensor, boxes: torch.Tensor, output_size: tuple[int, int],
              sampling_ratio: int = 4) -> torch.Tensor:
    """images (B,C,H,W); boxes (B,4) as (x1,y1,x2,y2), one per image →
    crops (B, C, out_h, out_w)."""
    out_h, out_w = output_size
    H, W = images.shape[-2:]
    Wy = _axis_weights(boxes[:, 1], boxes[:, 3] - boxes[:, 1], out_h, sampling_ratio, H)
    Wx = _axis_weights(boxes[:, 0], boxes[:, 2] - boxes[:, 0], out_w, sampling_ratio, W)
    tmp = Wy[:, None] @ images  # (B, C, out_h, W)
    return tmp @ Wx.transpose(1, 2)[:, None]
