"""On-device photometric augmentation, the train-time RGB jitter chain (port
of cosypose_tpu/ops/image_aug.py).

Gaussian blur, sharpness, contrast, brightness and colour, each applied per
sample with probability p, with Pillow's ImageEnhance semantics:
enhance(f) = degenerate + f·(image − degenerate), clamped to [0, 1]
(brightness: black; contrast: the mean of the L channel, rounded as Pillow
rounds it on the 0-255 scale; colour: grayscale; sharpness: the 3×3 SMOOTH
filter with the 1-px border kept). The random numbers are drawn apart from
the arithmetic (`jitter_draws`), so a test can feed both packages the same
draws.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# parameter ranges of the host chain (cosypose_tpu/data/augmentations.py:142-159)
BLUR_RADIUS = (1.0, 3.0)
SHARPNESS = (0.0, 50.0)
CONTRAST = (0.2, 50.0)
BRIGHTNESS = (0.1, 6.0)
COLOR = (0.0, 20.0)
GAUSS_R = 9  # taps cover ±3σ at the largest radius
_RANGES = {"blur": BLUR_RADIUS, "sharpness": SHARPNESS, "contrast": CONTRAST,
           "brightness": BRIGHTNESS, "color": COLOR}


def _luminance(images: torch.Tensor) -> torch.Tensor:
    """ITU-R 601-2 L channel of (B,3,H,W) → (B,H,W)."""
    w = torch.tensor([0.299, 0.587, 0.114], dtype=images.dtype, device=images.device)
    return torch.einsum("c,bchw->bhw", w, images)


def _blend(images, degenerate, factor):
    """Pillow's enhance with a per-sample factor (B,)."""
    f = factor[:, None, None, None]
    return (degenerate + f * (images - degenerate)).clamp(0.0, 1.0)


def _depthwise(images: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Valid depthwise conv of (B,C,H',W') with one kernel per (item, channel):
    weight (B*C,1,kh,kw)."""
    B, C, H, W = images.shape
    out = F.conv2d(images.reshape(1, B * C, H, W), weight, groups=B * C)
    return out.reshape(B, C, out.shape[-2], out.shape[-1])


def _gaussian_blur(images: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Separable per-sample gaussian blur with edge padding; sigma (B,)."""
    C = images.shape[1]
    x = torch.arange(-GAUSS_R, GAUSS_R + 1, dtype=images.dtype, device=images.device)
    taps = torch.exp(-0.5 * (x[None, :] / sigma[:, None]) ** 2)
    taps = taps / taps.sum(dim=1, keepdim=True)
    rhs = taps.repeat_interleave(C, dim=0)[:, None, None, :]            # (B*C,1,1,K)
    out = _depthwise(F.pad(images, (GAUSS_R, GAUSS_R, 0, 0), mode="replicate"), rhs)
    out = _depthwise(F.pad(out, (0, 0, GAUSS_R, GAUSS_R), mode="replicate"),
                     rhs.transpose(2, 3))
    return out.clamp(0.0, 1.0)


def _smooth3x3(images: torch.Tensor) -> torch.Tensor:
    """Pillow's ImageFilter.SMOOTH ([[1,1,1],[1,5,1],[1,1,1]]/13), the
    original 1-px border pasted back as Pillow does."""
    B, C = images.shape[:2]
    k = torch.tensor([[1, 1, 1], [1, 5, 1], [1, 1, 1]], dtype=images.dtype,
                     device=images.device) / 13.0
    out = _depthwise(F.pad(images, (1, 1, 1, 1), mode="replicate"),
                     k.expand(B * C, 1, 3, 3))
    out[:, :, 0, :] = images[:, :, 0, :]
    out[:, :, -1, :] = images[:, :, -1, :]
    out[:, :, :, 0] = images[:, :, :, 0]
    out[:, :, :, -1] = images[:, :, :, -1]
    return out


def jitter_draws(batch_size: int, generator: torch.Generator) -> dict:
    """Uniform draws of color_jitter on the CPU from `generator`:
    {op: (factor (B,) in the op's range, coin (B,) in [0,1))} for the five
    ops, in the chain's order."""
    draws = {}
    for op, (lo, hi) in _RANGES.items():
        factor = lo + (hi - lo) * torch.rand(batch_size, generator=generator)
        draws[op] = (factor, torch.rand(batch_size, generator=generator))
    return draws


def apply_color_jitter(images: torch.Tensor, draws: dict, p: float = 0.4) -> torch.Tensor:
    """The jitter chain on (B,3,H,W) float images in [0,1] with given draws
    (see jitter_draws); an op fires on a sample where its coin is below p."""
    def maybe(op, aug):
        use = draws[op][1].to(images.device) < p
        return torch.where(use[:, None, None, None], aug, images)

    def factor(op):
        return draws[op][0].to(images.device, images.dtype)

    images = maybe("blur", _gaussian_blur(images, factor("blur")))
    images = maybe("sharpness", _blend(images, _smooth3x3(images), factor("sharpness")))
    mean = torch.round(_luminance(images).mean(dim=(1, 2)) * 255.0 + 0.5) / 255.0
    images = maybe("contrast", _blend(images, mean[:, None, None, None], factor("contrast")))
    images = maybe("brightness", _blend(images, torch.zeros_like(images), factor("brightness")))
    gray = _luminance(images)[:, None]
    images = maybe("color", _blend(images, gray, factor("color")))
    return images


def color_jitter(images: torch.Tensor, generator: torch.Generator, p: float = 0.4) -> torch.Tensor:
    """The full jitter chain, its draws from `generator`."""
    return apply_color_jitter(images, jitter_draws(images.shape[0], generator), p)
