"""The Pillow operations of the host augmentations, in numpy.

The JAX package's host augmentations (cosypose_tpu/data/augmentations.py)
call Pillow, which the port does not use. These functions repeat Pillow's C
arithmetic (Resample.c, Geometry.c, BoxBlur.c, Filter.c, Blend.c, Convert.c)
on uint8 arrays, so their outputs equal Pillow's bit for bit;
tests/test_torch_port_data.py holds them against PIL.

  resize_bilinear   Image.resize(BILINEAR): separable, horizontal pass first,
                    an antialiasing triangle filter whose support widens by
                    the scale when downsizing, 22-bit fixed-point weights,
                    uint8 between the passes;
  resize_nearest    Image.resize(NEAREST) on any dtype: source positions
                    accumulated in float64 from the first pixel centre;
  gaussian_blur     ImageFilter.GaussianBlur: three box blurs along x, then
                    three along y, each with fractional end weights in 24-bit
                    fixed point and edge pixels repeated;
  smooth            ImageFilter.SMOOTH: the 3x3 kernel in float32, borders kept;
  luminance         convert("L"): (19595 R + 38470 G + 7471 B + 32768) >> 16;
  cmyk_to_rgb       convert("RGB") of CMYK: each channel nk - x·nk/255 with
                    nk = 255 - K, Convert.c's rounded MULDIV255;
  blend             Image.blend(degenerate, image, f) in float32, truncated;
  sharpness, contrast, brightness, colour
                    ImageEnhance's four enhancers: blend against SMOOTH, the
                    rounded mean of L, black and L.
"""

from __future__ import annotations

import math

import numpy as np

PRECISION_BITS = 22  # Resample.c, 8 bits per channel


def _bilinear_coeffs(in_size: int, out_size: int):
    """Pillow's precompute_coeffs + normalize_coeffs_8bpc for the bilinear
    filter over the whole input: (first source index (out,), int weights
    (out, ksize)), weights past a row's taps zero."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    weights = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        ss = 1.0 / filterscale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [max(0.0, 1.0 - abs((x + xmin - center + 0.5) * ss)) for x in range(xmax)]
        total = 0.0
        for v in w:
            total += v
        for x, v in enumerate(w):
            k = v / total if total != 0.0 else v
            weights[xx, x] = int((0.5 if k >= 0 else -0.5) + k * (1 << PRECISION_BITS))
        first[xx] = xmin
    return first, weights


def _resample_axis(image: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    in_size = image.shape[axis]
    first, weights = _bilinear_coeffs(in_size, out_size)
    src = np.moveaxis(image, axis, 0).astype(np.int64)
    acc = np.full((out_size,) + src.shape[1:], 1 << (PRECISION_BITS - 1), np.int64)
    extra = (1,) * (src.ndim - 1)
    for k in range(weights.shape[1]):
        idx = np.minimum(first + k, in_size - 1)
        acc += src[idx] * weights[:, k].reshape(-1, *extra)
    out = np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize_bilinear(image: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """Image.fromarray(image).resize((w, h), BILINEAR) for uint8 (H, W[, C]);
    size is (h, w)."""
    h, w = size
    out = image
    if w != image.shape[1]:
        out = _resample_axis(out, w, 1)
    if h != image.shape[0]:
        out = _resample_axis(out, h, 0)
    return out.copy() if out is image else out


def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    step = in_size / out_size
    pos = np.cumsum(np.r_[step * 0.5, np.full(out_size - 1, step)])
    idx = np.where(pos < 0.0, -1, pos.astype(np.int64))
    if (idx < 0).any() or (idx >= in_size).any():
        raise ValueError("nearest resize left the source image")
    return idx


def resize_nearest(image: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """Image.resize((w, h), NEAREST) of a 2-D array of any dtype (mode "I"
    for int32); size is (h, w)."""
    h, w = size
    if (h, w) == image.shape[:2]:
        return image.copy()
    return image[_nearest_index(image.shape[0], h)[:, None], _nearest_index(image.shape[1], w)]


def _box_radius(radius: float, passes: int = 3) -> np.float32:
    """BoxBlur.c's _gaussian_blur_radius: the fractional box radius whose
    `passes` box blurs have the variance of a Gaussian of this radius."""
    f32 = np.float32
    r = f32(radius)
    sigma2 = r * r / f32(passes)
    L = f32(math.sqrt(12.0 * float(sigma2) + 1.0))
    l = f32(math.floor((float(L) - 1.0) / 2.0))
    a = (f32(2) * l + f32(1)) * (l * (l + f32(1)) - f32(3) * sigma2)
    a /= f32(6) * (sigma2 - (l + f32(1)) * (l + f32(1)))
    return l + a


def _box_blur_last_axis(a: np.ndarray, radius: np.float32) -> np.ndarray:
    """One ImagingLineBoxBlur pass along the last axis: the 2r+1 window at
    weight ww, the two pixels beyond it at fw, in 24-bit fixed point."""
    r = int(radius)
    ww = int(np.float32(1 << 24) / (radius * np.float32(2) + np.float32(1)))
    fw = ((1 << 24) - (2 * r + 1) * ww) // 2
    n = a.shape[-1]
    # uint32 as in C: the weighted sums stay below 255 * 2^24 + 2^23 < 2^32
    p = np.pad(a.astype(np.uint32), [(0, 0)] * (a.ndim - 1) + [(r + 1, r + 1)], mode="edge")
    c = np.cumsum(p, axis=-1, dtype=np.uint32)
    window = c[..., 2 * r + 1:2 * r + 1 + n] - c[..., :n]   # p[x+1 .. x+2r+1]
    far = p[..., :n] + p[..., 2 * r + 2:2 * r + 2 + n]
    out = window * np.uint32(ww) + far * np.uint32(fw) + np.uint32(1 << 23)
    return (out >> np.uint32(24)).astype(np.uint8)


def gaussian_blur(image: np.ndarray, radius: float, passes: int = 3) -> np.ndarray:
    """image.filter(ImageFilter.GaussianBlur(radius)) for uint8 (H, W[, C])."""
    if radius == 0:
        return image.copy()
    box = _box_radius(radius, passes)
    a = np.moveaxis(image, 1, -1)      # x last
    for _ in range(passes):
        a = _box_blur_last_axis(a, box)
    a = np.moveaxis(np.moveaxis(a, -1, 1), 0, -1)   # y last
    for _ in range(passes):
        a = _box_blur_last_axis(a, box)
    return np.ascontiguousarray(np.moveaxis(a, -1, 0))


def smooth(image: np.ndarray) -> np.ndarray:
    """image.filter(ImageFilter.SMOOTH): kernel (1 1 1; 1 5 1; 1 1 1) / 13 in
    float32, rows summed in Filter.c's order, +0.5 and truncated; the border
    pixels are kept."""
    f32 = np.float32
    edge, centre = f32(1) / f32(13), f32(5) / f32(13)
    x = image.astype(np.float32)
    out = image.copy()
    if image.shape[0] < 3 or image.shape[1] < 3:
        return out

    def row(r, mid):   # (in[x-1]*k0 + in[x]*k1) + in[x+1]*k2 along row r
        return (r[:, :-2] * edge + r[:, 1:-1] * mid) + r[:, 2:] * edge

    ss = f32(0.5) + row(x[2:], edge)
    ss = ss + row(x[1:-1], centre)
    ss = ss + row(x[:-2], edge)
    out[1:-1, 1:-1] = np.clip(ss, 0, 255).astype(np.uint8)
    return out


def luminance(rgb: np.ndarray) -> np.ndarray:
    """convert("L") of uint8 (H, W, 3)."""
    c = rgb.astype(np.int64)
    return ((c[..., 0] * 19595 + c[..., 1] * 38470 + c[..., 2] * 7471 + 0x8000) >> 16).astype(
        np.uint8)


def cmyk_to_rgb(cmyk: np.ndarray) -> np.ndarray:
    """(..., 4) uint8 CMYK -> (..., 3) uint8 RGB as Pillow's cmyk2rgb."""
    x = cmyk.astype(np.int32)
    nk = 255 - x[..., 3:4]
    tmp = x[..., :3] * nk + 128
    return np.clip(nk - (((tmp >> 8) + tmp) >> 8), 0, 255).astype(np.uint8)


def blend(degenerate: np.ndarray, image: np.ndarray, factor: float) -> np.ndarray:
    """Image.blend(degenerate, image, factor): in1 + f * (in2 - in1) in float32
    with f rounded to float32, clipped to [0, 255] and truncated."""
    d = degenerate.astype(np.int32)
    v = d.astype(np.float32) + np.float32(factor) * (image.astype(np.int32) - d).astype(np.float32)
    return np.clip(v, 0, 255).astype(np.uint8)


def sharpness(rgb: np.ndarray, factor: float) -> np.ndarray:
    return blend(smooth(rgb), rgb, factor)


def contrast(rgb: np.ndarray, factor: float) -> np.ndarray:
    lum = luminance(rgb)
    mean = int(int(lum.sum(dtype=np.int64)) / lum.size + 0.5)
    return blend(np.full_like(rgb, mean), rgb, factor)


def brightness(rgb: np.ndarray, factor: float) -> np.ndarray:
    return blend(np.zeros_like(rgb), rgb, factor)


def colour(rgb: np.ndarray, factor: float) -> np.ndarray:
    return blend(np.repeat(luminance(rgb)[..., None], 3, axis=-1), rgb, factor)
