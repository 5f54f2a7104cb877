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

`multiscale_roi_align` is the detector's form (Mask R-CNN's
MultiScaleRoIAlign): many boxes an image, each read from the pyramid level
its size picks, sampling 2, torchvision's aligned=False arithmetic (a box at
least 1 cell wide). Each output bin is a weighted sum of 16 feature rows (2 x
2 samples, 4 neighbours each), computed by one `embedding_bag` over the
levels' features laid out channels-last in one table: no host sync, no loop
over levels.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F


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


def pyramid_level(boxes: torch.Tensor, k_min: int, k_max: int, canonical_scale: float = 224,
                  canonical_level: int = 4, eps: float = 1e-6) -> torch.Tensor:
    """MultiScaleRoIAlign's LevelMapper: the index (0 = k_min) of each box's
    level, floor(4 + log2(sqrt(area) / 224) + eps) clamped to [k_min, k_max]."""
    s = torch.sqrt((boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1]))
    lvl = torch.floor(canonical_level + torch.log2(s / canonical_scale)
                      + torch.tensor(eps, dtype=s.dtype))
    return torch.clamp(lvl, min=k_min, max=k_max).to(torch.int64) - k_min


def _axis_samples(start: torch.Tensor, end: torch.Tensor, out: int, s: int, size: torch.Tensor):
    """Rows and weights of torchvision's bilinear_interpolate along one axis,
    for s samples in each of `out` bins of each box (aligned=False): (R, out,
    s, 2) indices (low, high) and weights (their share; 0 where the sample
    lies outside [-1, size])."""
    extent = torch.clamp(end - start, min=1.0)
    bin_size = extent / out
    i = torch.arange(out, dtype=torch.float32, device=start.device)
    g = torch.arange(s, dtype=torch.float32, device=start.device) + 0.5
    c = start[:, None, None] + i[None, :, None] * bin_size[:, None, None] \
        + g[None, None, :] * bin_size[:, None, None] / s
    lim = size[:, None, None]
    outside = (c < -1.0) | (c > lim)
    c = c.clamp(min=0)
    low = c.to(torch.int64)
    top = low >= lim - 1
    low = torch.where(top, lim - 1, low)
    high = torch.where(top, lim - 1, low + 1)
    c = torch.where(top, low.to(c.dtype), c)
    frac = c - low
    w = torch.stack([1.0 - frac, frac], -1)
    return torch.stack([low, high], -1), torch.where(outside[..., None], 0.0, w)


@functools.lru_cache(maxsize=64)
def _level_table(shapes: tuple, image_hw: tuple, device):
    """(k_min, k_max, and on the device each level's scale, height, width
    and first row in the channels-last table) for features of these shapes:
    made once a shape, so that a call copies nothing from the host."""
    scales = [2.0 ** round(math.log2(sh[-2] / image_hw[0])) for sh in shapes]
    sizes = [sh[0] * sh[-2] * sh[-1] for sh in shapes]
    starts = [sum(sizes[:k]) for k in range(len(shapes))]
    return (round(-math.log2(scales[0])), round(-math.log2(scales[-1])),
            torch.tensor(scales, device=device), torch.tensor([sh[-2] for sh in shapes],
                                                              device=device),
            torch.tensor([sh[-1] for sh in shapes], device=device),
            torch.tensor(starts, device=device))


def multiscale_roi_align(feats: list, boxes: torch.Tensor, image_ids: torch.Tensor,
                         image_hw: tuple, output_size: int,
                         sampling_ratio: int = 2) -> torch.Tensor:
    """feats [(B, C, H_l, W_l)] the pyramid's levels (finest first, strides
    powers of 2 of the image); boxes (R, 4) x1 y1 x2 y2 in the image's
    pixels, image_ids (R,) int64 -> (R, C, out, out) float32. The level of a
    box is MultiScaleRoIAlign's (`pyramid_level`), its scale
    2^round(log2(H_l / image height))."""
    P, s = output_size, sampling_ratio
    C = feats[0].shape[1]
    k_min, k_max, scales, hs, ws, starts = _level_table(
        tuple(tuple(f.shape) for f in feats), tuple(image_hw), boxes.device)
    level = pyramid_level(boxes, k_min, k_max)
    table = torch.cat([f.permute(0, 2, 3, 1).reshape(-1, C) for f in feats]).float()
    h, w = hs[level], ws[level]
    scaled = boxes * scales[level][:, None]
    yi, yw = _axis_samples(scaled[:, 1], scaled[:, 3], P, s, h)
    xi, xw = _axis_samples(scaled[:, 0], scaled[:, 2], P, s, w)
    R = boxes.shape[0]
    base = starts[level] + image_ids * h * w
    # (R, P, P, sy, 2, sx, 2): bin (i, j), sample (a, c), neighbour (y, x)
    idx = base[:, None, None, None, None, None, None] \
        + yi[:, :, None, :, :, None, None] * w[:, None, None, None, None, None, None] \
        + xi[:, None, :, None, None, :, :]
    wt = yw[:, :, None, :, :, None, None] * xw[:, None, :, None, None, :, :] / (s * s)
    out = F.embedding_bag(idx.reshape(R * P * P, 4 * s * s), table, mode="sum",
                          per_sample_weights=wt.reshape(R * P * P, 4 * s * s))
    return out.reshape(R, P, P, C).permute(0, 3, 1, 2)
