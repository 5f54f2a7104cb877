"""roi_align crop extraction as two batched matmuls (port of the separable form
in cosypose_tpu/ops/roi_align.py).

Bilinear sampling is linear in the image and roi_align's sample grid is
axis-separable, so one crop is `Wy[b] @ image[b] @ Wx[b]^T`, with banded
interpolation-weight matrices Wy (out_h, H) and Wx (out_w, W). Semantics are
torchvision's aligned=False: samples below -1 or beyond the size contribute
0, others are clamped into the image.

`roi_align_gather` is the same function in its gather form (bilinear samples
at sampling_ratio² points a bin, averaged), as the JAX package keeps it: the
tests' oracle, off the serving path.
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


def _bilinear_sample(image: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """image (C, H, W) at the points (ys, xs) -> (C, N); 0 below -1 or beyond the size."""
    C, H, W = image.shape
    oob = (ys < -1.0) | (ys > H) | (xs < -1.0) | (xs > W)
    y = ys.clamp(0.0, H - 1)
    x = xs.clamp(0.0, W - 1)
    y0, x0 = torch.floor(y), torch.floor(x)
    y1, x1 = (y0 + 1).clamp_max(H - 1), (x0 + 1).clamp_max(W - 1)
    ly, lx = y - y0, x - x0
    hy, hx = 1.0 - ly, 1.0 - lx
    y0i, y1i, x0i, x1i = (t.long() for t in (y0, y1, x0, x1))
    out = (hy * hx * image[:, y0i, x0i] + hy * lx * image[:, y0i, x1i]
           + ly * hx * image[:, y1i, x0i] + ly * lx * image[:, y1i, x1i])
    return torch.where(oob[None], 0.0, out)


def roi_align_gather(images: torch.Tensor, boxes: torch.Tensor, output_size: tuple[int, int],
                     sampling_ratio: int = 4) -> torch.Tensor:
    """roi_align by gathering the four neighbours of every sample: images
    (B,C,H,W), boxes (B,4) as (x1,y1,x2,y2) -> (B, C, out_h, out_w)."""
    out_h, out_w = output_size
    s = sampling_ratio
    x1, y1, x2, y2 = boxes.unbind(-1)
    bin_w, bin_h = (x2 - x1) / out_w, (y2 - y1) / out_h
    dev = images.device
    iy = (torch.arange(out_h * s, dtype=torch.float32, device=dev) + 0.5) / s
    ix = (torch.arange(out_w * s, dtype=torch.float32, device=dev) + 0.5) / s
    ys = y1[:, None] + iy[None, :] * bin_h[:, None]
    xs = x1[:, None] + ix[None, :] * bin_w[:, None]
    crops = []
    for image, ys_i, xs_i in zip(images, ys, xs):
        vals = _bilinear_sample(image, ys_i.repeat_interleave(out_w * s), xs_i.repeat(out_h * s))
        crops.append(vals.reshape(image.shape[0], out_h, s, out_w, s).mean(dim=(2, 4)))
    return torch.stack(crops)
