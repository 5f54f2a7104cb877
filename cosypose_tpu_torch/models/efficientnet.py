"""EfficientNet B0–B7 feature extractor (port of cosypose_tpu/models/efficientnet.py).

MBConv blocks with squeeze-excitation (convs with bias), swish, compound
width/depth scaling and a configurable input channel count; no classifier.
Module names follow the reference's EfficientNet-PyTorch (`_conv_stem`,
`_bn0`, `_blocks.N._expand_conv`, …, `_conv_head`, `_bn1`), so
`cosypose_tpu.utils.torch_compat` reads this state_dict as it reads the
reference's. Inference only: BatchNorm uses its running statistics and
drop-connect is the identity.

Convolutions pad as TensorFlow's "SAME", as flax does: total padding
max((ceil(n/s)-1)*s + k - n, 0), split (p//2, p - p//2). On stride-2 convs
this is asymmetric, which torch's `padding=k//2` is not.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

# (width_mult, depth_mult, resolution, dropout): compound scaling table
EFFICIENTNET_PARAMS = {
    "efficientnet-b0": (1.0, 1.0, 224, 0.2),
    "efficientnet-b1": (1.0, 1.1, 240, 0.2),
    "efficientnet-b2": (1.1, 1.2, 260, 0.3),
    "efficientnet-b3": (1.2, 1.4, 300, 0.3),
    "efficientnet-b4": (1.4, 1.8, 380, 0.4),
    "efficientnet-b5": (1.6, 2.2, 456, 0.4),
    "efficientnet-b6": (1.8, 2.6, 528, 0.5),
    "efficientnet-b7": (2.0, 3.1, 600, 0.5),
}

# base (B0) stages: (num_repeat, kernel, stride, expand_ratio, in_ch, out_ch, se_ratio)
BASE_BLOCKS = [
    (1, 3, 1, 1, 32, 16, 0.25),
    (2, 3, 2, 6, 16, 24, 0.25),
    (2, 5, 2, 6, 24, 40, 0.25),
    (3, 3, 2, 6, 40, 80, 0.25),
    (3, 5, 1, 6, 80, 112, 0.25),
    (4, 5, 2, 6, 112, 192, 0.25),
    (1, 3, 1, 6, 192, 320, 0.25),
]

BN_EPS = 1e-3
BN_MOMENTUM = 0.01  # flax's 0.99 in torch's convention


def round_filters(filters: int, width_mult: float, divisor: int = 8) -> int:
    """Channel rounding to multiples of 8."""
    filters *= width_mult
    new_f = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new_f < 0.9 * filters:
        new_f += divisor
    return int(new_f)


def round_repeats(repeats: int, depth_mult: float) -> int:
    return int(math.ceil(depth_mult * repeats))


def block_names(variant: str) -> list[str]:
    """The JAX package's block names, in the order of `_blocks.N`."""
    _, d_mult, _, _ = EFFICIENTNET_PARAMS[variant]
    return [f"block{stage}_{i}" for stage, (repeat, *_rest) in enumerate(BASE_BLOCKS)
            for i in range(round_repeats(repeat, d_mult))]


class Conv2dSame(nn.Conv2d):
    """Unpadded conv after an explicit TF-"SAME" pad."""

    def forward(self, x):
        pads = []
        for n, k, s in zip(x.shape[-2:], self.kernel_size, self.stride):
            p = max((math.ceil(n / s) - 1) * s + k - n, 0)
            pads.append((p // 2, p - p // 2))
        (top, bottom), (left, right) = pads
        if top or bottom or left or right:
            x = F.pad(x, (left, right, top, bottom))
        return F.conv2d(x, self.weight, self.bias, self.stride, 0, self.dilation, self.groups)


def _bn(ch: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(ch, eps=BN_EPS, momentum=BN_MOMENTUM)


class MBConvBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int,
                 expand_ratio: int, se_ratio: float):
        super().__init__()
        mid = in_ch * expand_ratio
        self.has_expand = expand_ratio != 1
        if self.has_expand:
            self._expand_conv = Conv2dSame(in_ch, mid, 1, bias=False)
            self._bn0 = _bn(mid)
        self._depthwise_conv = Conv2dSame(mid, mid, kernel, stride=stride, groups=mid, bias=False)
        self._bn1 = _bn(mid)
        se_ch = max(1, int(in_ch * se_ratio))
        self._se_reduce = Conv2dSame(mid, se_ch, 1)
        self._se_expand = Conv2dSame(se_ch, mid, 1)
        self._project_conv = Conv2dSame(mid, out_ch, 1, bias=False)
        self._bn2 = _bn(out_ch)
        self.residual = stride == 1 and in_ch == out_ch

    def forward(self, x):
        inp = x
        if self.has_expand:
            x = F.silu(self._bn0(self._expand_conv(x)))
        x = F.silu(self._bn1(self._depthwise_conv(x)))
        s = x.mean(dim=(2, 3), keepdim=True)
        s = self._se_expand(F.silu(self._se_reduce(s)))
        x = x * torch.sigmoid(s)
        x = self._bn2(self._project_conv(x))
        return x + inp if self.residual else x


class EfficientNet(nn.Module):
    """Input (B, in_channels, H, W) → final conv features (B, head_ch, H/32, W/32)."""

    def __init__(self, variant: str = "efficientnet-b3", in_channels: int = 6):
        super().__init__()
        w_mult, d_mult, _, _ = EFFICIENTNET_PARAMS[variant]
        self.variant = variant
        stem_ch = round_filters(32, w_mult)
        self._conv_stem = Conv2dSame(in_channels, stem_ch, 3, stride=2, bias=False)
        self._bn0 = _bn(stem_ch)
        blocks = []
        for repeat, kernel, stride, expand, cin, cout, se in BASE_BLOCKS:
            cin_r, cout_r = round_filters(cin, w_mult), round_filters(cout, w_mult)
            for i in range(round_repeats(repeat, d_mult)):
                blocks.append(MBConvBlock(cin_r if i == 0 else cout_r, cout_r, kernel,
                                          stride if i == 0 else 1, expand, se))
        self._blocks = nn.ModuleList(blocks)
        self.n_features = round_filters(1280, w_mult)
        self._conv_head = Conv2dSame(round_filters(320, w_mult), self.n_features, 1, bias=False)
        self._bn1 = _bn(self.n_features)

    def forward(self, x):
        x = F.silu(self._bn0(self._conv_stem(x)))
        for block in self._blocks:
            x = block(x)
        return F.silu(self._bn1(self._conv_head(x)))
