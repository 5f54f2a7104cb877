"""EfficientNet (Tan & Le 2019) with CosyPose's pose head, as plain functions
over a dict of tensors.

The parameter names are those of the public EfficientNet-PyTorch package
(`_conv_stem`, `_blocks.N._depthwise_conv`, ...) under `backbone.`, and the
head is `pose_fc`. Convolutions pad as TensorFlow's "SAME" (split p//2,
p - p//2). BatchNorm uses eps 1e-3; in train mode it normalises with the
batch statistics (biased variance). Drop-connect zeroes a sample's residual
branch where its keep mask is False and scales kept ones by 1/(1 - rate),
the rate 0.2 x block index / block count on residual blocks only.

`quant`, where given, is applied to the input and the weight of every
convolution and of the head: the lower-precision control of the benchmark's
correctness check uses it to compute in float8.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# name: (width multiplier, depth multiplier)
SCALING = {"efficientnet-b0": (1.0, 1.0), "efficientnet-b3": (1.2, 1.4)}
# B0 stages: (repeats, kernel, stride, expansion, in, out); squeeze-excite 0.25
STAGES = [(1, 3, 1, 1, 32, 16), (2, 3, 2, 6, 16, 24), (2, 5, 2, 6, 24, 40),
          (3, 3, 2, 6, 40, 80), (3, 5, 1, 6, 80, 112), (4, 5, 2, 6, 112, 192),
          (1, 3, 1, 6, 192, 320)]
BN_EPS = 1e-3
DROP_CONNECT = 0.2


def width(ch: int, mult: float) -> int:
    ch *= mult
    new = max(8, int(ch + 4) // 8 * 8)
    return int(new + 8 if new < 0.9 * ch else new)


def blocks(variant: str) -> list[dict]:
    """One dict per MBConv block: cin, cout, kernel, stride, expand, se, rate."""
    wm, dm = SCALING[variant]
    out = []
    n = sum(math.ceil(dm * r) for r, *_ in STAGES)
    for r, k, s, e, cin, cout in STAGES:
        ci, co = width(cin, wm), width(cout, wm)
        for i in range(math.ceil(dm * r)):
            b = dict(cin=ci if i == 0 else co, cout=co, kernel=k, stride=s if i == 0 else 1,
                     expand=e, se=max(1, int((ci if i == 0 else co) * 0.25)))
            b["residual"] = b["stride"] == 1 and b["cin"] == co
            b["rate"] = DROP_CONNECT * len(out) / n if b["residual"] else 0.0
            out.append(b)
    return out


def n_features(variant: str) -> int:
    return width(1280, SCALING[variant][0])


def param_shapes(variant: str, in_ch: int = 6, pose_dim: int = 9) -> dict:
    """{name: shape} of every parameter and BatchNorm statistic."""
    wm = SCALING[variant][0]
    shapes = {}

    def conv(name, cout, cin, k, bias=False):
        shapes[f"backbone.{name}.weight"] = (cout, cin, k, k)
        if bias:
            shapes[f"backbone.{name}.bias"] = (cout,)

    def bn(name, ch):
        for p in ("weight", "bias", "running_mean", "running_var"):
            shapes[f"backbone.{name}.{p}"] = (ch,)

    stem = width(32, wm)
    conv("_conv_stem", stem, in_ch, 3)
    bn("_bn0", stem)
    for i, b in enumerate(blocks(variant)):
        mid, p = b["cin"] * b["expand"], f"_blocks.{i}."
        if b["expand"] != 1:
            conv(p + "_expand_conv", mid, b["cin"], 1)
            bn(p + "_bn0", mid)
        conv(p + "_depthwise_conv", mid, 1, b["kernel"])
        bn(p + "_bn1", mid)
        conv(p + "_se_reduce", b["se"], mid, 1, bias=True)
        conv(p + "_se_expand", mid, b["se"], 1, bias=True)
        conv(p + "_project_conv", b["cout"], mid, 1)
        bn(p + "_bn2", b["cout"])
    conv("_conv_head", n_features(variant), width(320, wm), 1)
    bn("_bn1", n_features(variant))
    shapes["pose_fc.weight"] = (pose_dim, n_features(variant))
    shapes["pose_fc.bias"] = (pose_dim,)
    return shapes


def same_pad(x, k: int, s: int):
    pads = []
    for n in x.shape[-2:]:
        p = max((math.ceil(n / s) - 1) * s + k - n, 0)
        pads.append((p // 2, p - p // 2))
    (t, b), (l, r) = pads
    return F.pad(x, (l, r, t, b)) if t or b or l or r else x


class Net:
    """The backbone and head over `params`; `train` selects batch statistics.
    A BatchNorm's batch statistics are reported to `on_batch_stats(name,
    mean, biased var)` where given."""

    def __init__(self, params: dict, variant: str, train: bool = False, quant=None,
                 on_batch_stats=None):
        self.p, self.variant, self.train = params, variant, train
        self.quant = quant or (lambda t: t)
        self.on_batch_stats = on_batch_stats

    def conv(self, name, x, stride=1, groups=1):
        w = self.p[f"backbone.{name}.weight"]
        x = same_pad(x, w.shape[-1], stride)
        return F.conv2d(self.quant(x), self.quant(w), self.p.get(f"backbone.{name}.bias"),
                        stride, 0, 1, groups)

    def bn(self, name, x):
        g = lambda k: self.p[f"backbone.{name}.{k}"]  # noqa: E731
        if not self.train:
            return F.batch_norm(x, g("running_mean"), g("running_var"), g("weight"), g("bias"),
                                False, 0.0, BN_EPS)
        y = F.batch_norm(x, None, None, g("weight"), g("bias"), True, 0.0, BN_EPS)
        if self.on_batch_stats is not None:
            xf = x.detach().float()
            self.on_batch_stats(name, xf.mean((0, 2, 3)), xf.var((0, 2, 3), unbiased=False))
        return y

    def features(self, x, drop_masks=None):
        x = F.silu(self.bn("_bn0", self.conv("_conv_stem", x, 2)))
        for i, b in enumerate(blocks(self.variant)):
            p, inp = f"_blocks.{i}.", x
            if b["expand"] != 1:
                x = F.silu(self.bn(p + "_bn0", self.conv(p + "_expand_conv", x)))
            x = F.silu(self.bn(p + "_bn1", self.conv(p + "_depthwise_conv", x, b["stride"],
                                                     groups=x.shape[1])))
            s = self.conv(p + "_se_expand", F.silu(self.conv(p + "_se_reduce",
                                                             x.mean((2, 3), keepdim=True))))
            x = self.bn(p + "_bn2", self.conv(p + "_project_conv", x * torch.sigmoid(s)))
            if b["residual"]:
                keep = None if drop_masks is None else drop_masks[i]
                if keep is not None:
                    x = torch.where(keep.to(x.device)[:, None, None, None],
                                    x / (1.0 - b["rate"]), torch.zeros((), dtype=x.dtype,
                                                                       device=x.device))
                x = x + inp
        return F.silu(self.bn("_bn1", self.conv("_conv_head", x)))

    def __call__(self, x, dtype=torch.float32, drop_masks=None):
        """x (B,6,H,W) → head outputs (B,9) float32; the backbone under
        autocast to `dtype` where that is not float32, the pooling and the
        head in float32."""
        if dtype == torch.float32:
            feats = self.features(x, drop_masks)
        else:
            with torch.autocast(x.device.type, dtype=dtype):
                feats = self.features(x, drop_masks)
        pooled = feats.float().mean((2, 3))
        return F.linear(self.quant(pooled), self.quant(self.p["pose_fc.weight"]),
                        self.p["pose_fc.bias"])


def drop_keep_rates(variant: str) -> list[float]:
    """Each block's keep probability (1 for a block that drops nothing)."""
    return [1.0 - b["rate"] for b in blocks(variant)]


def fp8_quant(t: torch.Tensor) -> torch.Tensor:
    """Round to float8 e4m3 under a per-tensor scale (amax to 448), back in
    the input's dtype: the arithmetic of an fp8 matrix engine's operands."""
    amax = t.detach().abs().amax().float().clamp_min(1e-30)
    scale = 448.0 / amax
    return ((t.float() * scale).to(torch.float8_e4m3fn).float() / scale).to(t.dtype)
