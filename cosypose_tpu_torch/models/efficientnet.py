"""EfficientNet B0–B7 feature extractor (port of cosypose_tpu/models/efficientnet.py).

MBConv blocks with squeeze-excitation (convs with bias), swish, compound
width/depth scaling and a configurable input channel count; no classifier.
Module names follow the reference's EfficientNet-PyTorch (`_conv_stem`,
`_bn0`, `_blocks.N._expand_conv`, …, `_conv_head`, `_bn1`), so
`cosypose_tpu.utils.torch_compat` reads this state_dict as it reads the
reference's.

Train mode (`net.train()`) follows the JAX package's flax modules:
BatchNorm normalises with the batch statistics and moves its running
statistics the flax way (momentum 0.99, the BIASED batch variance, where
torch.nn.BatchNorm2d would take the unbiased one); drop-connect zeroes a whole
sample's residual branch at rate `drop_connect_rate · block_idx / n_blocks`
and scales the kept ones by 1/(1 - rate). The drop-connect masks are drawn
outside the forward (`draw_drop_masks`) and passed in, so a rematerialised
forward sees the same masks.

In a data-parallel run (`global_batch_stats`), train mode normalises with
the statistics of the GLOBAL batch, as the JAX package's sharded step does:
each channel's count, sum and sum of squares are all-reduced over the ranks,
the gradient flowing back through the same reduction.

Convolutions pad as TensorFlow's "SAME", as flax does: total padding
max((ceil(n/s)-1)*s + k - n, 0), split (p//2, p - p//2). On stride-2 convs
this is asymmetric, which torch's `padding=k//2` is not.

The depthwise convs take one of the JAX package's three lowerings
(`dw_impl`, selected by a `+dwshift` / `+dwdense` suffix on the backbone
name): "conv", the grouped conv (cuDNN); "shift", k² shifted multiply-adds
over the padded input; "dense", a dense conv whose weight is eye(C) times the
depthwise kernel (9·C² work in place of 9·C). All three keep the grouped
conv's parameter, so a state dict loads into any of them.

In eval mode on the card, an MBConv block of the "conv" lowering computes its
depthwise half (the depthwise conv, `_bn1`, swish and the SE squeeze's mean)
in one launch of a hand-written kernel, `ops.depthwise_cuda.
dw_bn_silu_squeeze`, from the same parameters, wherever no gradient is being
recorded (the kernel has no backward: inference and no_grad, as serving,
export and the bench run); train mode (validation's passes too: they run the
train-mode net under `frozen_stats`), the CPU and the other lowerings run the
modules as they are.
"""

from __future__ import annotations

import contextlib
import itertools
import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..ops.depthwise_cuda import dw_bn_silu_squeeze, same_pad
from ..utils.profiling import annotate

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

# the program's span of each row (utils/profiling.py)
STAGE_SPANS = [f"cosypose.backbone.stage{i}" for i in range(1, len(BASE_BLOCKS) + 1)]

BN_EPS = 1e-3
FLAX_MOMENTUM = 0.99


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
        (_, top, bottom), (_, left, right) = (
            same_pad(n, k, s) for n, k, s in zip(x.shape[-2:], self.kernel_size, self.stride))
        if top or bottom or left or right:
            x = F.pad(x, (left, right, top, bottom))
        return F.conv2d(x, self.weight, self.bias, self.stride, 0, self.dilation, self.groups)


DW_IMPLS = ("conv", "shift", "dense")


def split_dw_impl(backbone: str) -> tuple[str, str]:
    """'efficientnet-b3+dwshift' -> ('efficientnet-b3', 'shift'); no suffix: 'conv'."""
    variant, _, dw = backbone.partition("+dw")
    return variant, dw or "conv"


class DepthwiseConv2dSame(Conv2dSame):
    """The depthwise conv in the lowering `impl` names (DW_IMPLS), weight
    (C, 1, k, k) in each."""

    def __init__(self, channels: int, kernel: int, stride: int, impl: str = "conv"):
        if impl not in DW_IMPLS:
            raise ValueError(f"unknown depthwise lowering {impl!r}")
        super().__init__(channels, channels, kernel, stride=stride, groups=channels, bias=False)
        self.impl = impl

    def forward(self, x):
        if self.impl == "conv":
            return super().forward(x)
        (kh, kw), (s, _) = self.kernel_size, self.stride
        oh, top, bottom = same_pad(x.shape[-2], kh, s)
        ow, left, right = same_pad(x.shape[-1], kw, s)
        xp = F.pad(x, (left, right, top, bottom))
        if self.impl == "dense":
            C = self.weight.shape[0]
            eye = torch.eye(C, dtype=self.weight.dtype, device=self.weight.device)
            return F.conv2d(xp, eye[:, :, None, None] * self.weight, None, self.stride)
        # shift: in the autocast dtype where autocast is on, as the JAX
        # module computes in its compute dtype, accumulator included
        dev = x.device.type
        dtype = torch.get_autocast_dtype(dev) if torch.is_autocast_enabled(dev) else x.dtype
        xp, w = xp.to(dtype), self.weight.to(dtype)
        acc = torch.zeros(x.shape[0], x.shape[1], oh, ow, dtype=dtype, device=x.device)
        for a in range(kh):
            for b in range(kw):
                sl = xp[:, :, a:a + (oh - 1) * s + 1:s, b:b + (ow - 1) * s + 1:s]
                acc = acc + sl * w[:, 0, a, b][None, :, None, None]
        return acc


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm with flax's running-statistics update in train mode:
    running = m·running + (1 - m)·batch, the batch variance biased, with
    flax's momentum m (0.99 here; 0.9 in the WideResNet, CorrNet and
    detector modules) and epsilon.

    `update_stats` False (see `frozen_stats`) leaves the running statistics
    alone: a replayed forward under activation checkpointing, validation.
    `process_group` (see `global_batch_stats`), where it spans more than one
    rank, makes the batch statistics those of the global batch.
    """

    def __init__(self, ch: int, eps: float = BN_EPS, flax_momentum: float = FLAX_MOMENTUM):
        super().__init__(ch, eps=eps, momentum=1 - flax_momentum)
        self.flax_momentum = flax_momentum
        self.update_stats = True
        self.process_group = None

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        if self.process_group is not None and dist.get_world_size(self.process_group) > 1:
            return self._forward_global(x)
        # torch's fused batch norm hands back the batch mean and the UNBIASED
        # batch variance in buffers given to it at momentum 1. A replayed
        # forward takes the same path, so that it saves the same tensors.
        mean = torch.zeros_like(self.running_mean)
        var = torch.ones_like(self.running_var)
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True, 1.0, self.eps)
        if not self.update_stats:
            return y
        n = x.numel() // x.shape[1]
        m = self.flax_momentum
        with torch.no_grad():
            self.running_mean.mul_(m).add_(mean, alpha=1 - m)
            self.running_var.mul_(m).add_(var * ((n - 1) / n), alpha=1 - m)
        return y

    def _forward_global(self, x):
        """Train mode over the global batch: one all_reduce of the float64
        count, per-channel sums and sums of squares (and one of their
        gradients in backward); the biased variance E[x²] − E[x]², as flax
        computes it, accumulated in float64; the normalisation in float32."""
        xf = x.float()
        dims = (0, 2, 3)
        count = torch.full((1,), xf.numel() // xf.shape[1], dtype=torch.float64, device=x.device)
        local = torch.cat([count, xf.sum(dims, dtype=torch.float64),
                           (xf * xf).sum(dims, dtype=torch.float64)])
        total = AllReduceSum.apply(local, self.process_group)
        C = xf.shape[1]
        n = total[0]
        mean = total[1:1 + C] / n
        var = (total[1 + C:] / n - mean * mean).clamp_min(0.0)
        scale = torch.rsqrt(var + self.eps).float() * self.weight
        y = (xf - mean.float()[None, :, None, None]) * scale[None, :, None, None] \
            + self.bias[None, :, None, None]
        if self.update_stats:
            m = self.flax_momentum
            with torch.no_grad():
                self.running_mean.mul_(m).add_(mean.float(), alpha=1 - m)
                self.running_var.mul_(m).add_(var.float(), alpha=1 - m)
        return y.to(x.dtype)


class AllReduceSum(torch.autograd.Function):
    """Sum over the ranks of a process group, in forward and in backward:
    each rank's gradient of its own loss w.r.t. the sum reaches every rank's
    summands."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def global_batch_stats(module: nn.Module, group) -> None:
    """Every BatchNorm2d in `module` normalises in train mode with the
    statistics of the global batch over `group` (None: the local batch)."""
    for m in module.modules():
        if isinstance(m, BatchNorm2d):
            m.process_group = group


@contextlib.contextmanager
def frozen_stats(module: nn.Module):
    """No BatchNorm2d in `module` moves its running statistics inside the block."""
    bns = [m for m in module.modules() if isinstance(m, BatchNorm2d)]
    saved = [m.update_stats for m in bns]
    for m in bns:
        m.update_stats = False
    try:
        yield
    finally:
        for m, s in zip(bns, saved):
            m.update_stats = s


class MBConvBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int,
                 expand_ratio: int, se_ratio: float, drop_rate: float = 0.0,
                 dw_impl: str = "conv"):
        super().__init__()
        mid = in_ch * expand_ratio
        self.has_expand = expand_ratio != 1
        if self.has_expand:
            self._expand_conv = Conv2dSame(in_ch, mid, 1, bias=False)
            self._bn0 = BatchNorm2d(mid)
        self._depthwise_conv = DepthwiseConv2dSame(mid, kernel, stride, dw_impl)
        self._bn1 = BatchNorm2d(mid)
        se_ch = max(1, int(in_ch * se_ratio))
        self._se_reduce = Conv2dSame(mid, se_ch, 1)
        self._se_expand = Conv2dSame(se_ch, mid, 1)
        self._project_conv = Conv2dSame(mid, out_ch, 1, bias=False)
        self._bn2 = BatchNorm2d(out_ch)
        self.residual = stride == 1 and in_ch == out_ch
        # drop-connect applies to residual blocks only, as in the JAX package
        self.drop_rate = drop_rate if self.residual else 0.0

    def forward(self, x, keep: torch.Tensor | None = None):
        """keep: (B,) bool drop-connect mask of this block (train mode, drop_rate
        > 0); None leaves the residual branch whole."""
        inp = x
        if self.has_expand:
            x = F.silu(self._bn0(self._expand_conv(x)))
        if self.training or not x.is_cuda or self._depthwise_conv.impl != "conv" \
                or torch.is_grad_enabled():
            x = F.silu(self._bn1(self._depthwise_conv(x)))
            s = x.mean(dim=(2, 3), keepdim=True)
        else:
            x, s = self._depthwise_half(x)
        s = self._se_expand(F.silu(self._se_reduce(s)))
        x = x * torch.sigmoid(s)
        x = self._bn2(self._project_conv(x))
        if not self.residual:
            return x
        if keep is not None:
            keep_prob = 1.0 - self.drop_rate
            x = torch.where(keep.to(x.device)[:, None, None, None], x / keep_prob,
                            torch.zeros((), dtype=x.dtype, device=x.device))
        return x + inp

    def _depthwise_half(self, x):
        """The depthwise conv, `_bn1`, swish and the squeeze in one kernel
        launch (eval mode, CUDA, the "conv" lowering, no gradient recorded):
        (x, s (B, C, 1, 1)), in the autocast dtype where autocast is on, as
        the conv computes."""
        if torch.is_autocast_enabled("cuda"):
            x = x.to(torch.get_autocast_dtype("cuda"))
        dw, bn = self._depthwise_conv, self._bn1
        y, s = dw_bn_silu_squeeze(x.contiguous(), dw.weight, bn.weight, bn.bias, bn.running_mean,
                                  bn.running_var, bn.eps, dw.kernel_size[0], dw.stride[0])
        return y, s[:, :, None, None]


class EfficientNet(nn.Module):
    """Input (B, in_channels, H, W) → final conv features (B, head_ch, H/32, W/32)."""

    n_halvings = 5  # stride-2 "SAME" convs, each giving ⌈n/2⌉

    def __init__(self, variant: str = "efficientnet-b3", in_channels: int = 6,
                 drop_connect_rate: float = 0.2, dw_impl: str = "conv"):
        super().__init__()
        w_mult, d_mult, _, _ = EFFICIENTNET_PARAMS[variant]
        self.variant = variant
        self.dw_impl = dw_impl
        stem_ch = round_filters(32, w_mult)
        self._conv_stem = Conv2dSame(in_channels, stem_ch, 3, stride=2, bias=False)
        self._bn0 = BatchNorm2d(stem_ch)
        blocks = []
        n_blocks = len(block_names(variant))
        for repeat, kernel, stride, expand, cin, cout, se in BASE_BLOCKS:
            cin_r, cout_r = round_filters(cin, w_mult), round_filters(cout, w_mult)
            for i in range(round_repeats(repeat, d_mult)):
                rate = drop_connect_rate * len(blocks) / n_blocks
                blocks.append(MBConvBlock(cin_r if i == 0 else cout_r, cout_r, kernel,
                                          stride if i == 0 else 1, expand, se, rate,
                                          dw_impl))
        self._blocks = nn.ModuleList(blocks)
        # blocks a row of BASE_BLOCKS: the span of each row (STAGE_SPANS) holds them
        self.stage_repeats = [round_repeats(row[0], d_mult) for row in BASE_BLOCKS]
        self.n_features = round_filters(1280, w_mult)
        self._conv_head = Conv2dSame(round_filters(320, w_mult), self.n_features, 1, bias=False)
        self._bn1 = BatchNorm2d(self.n_features)

    def depthwise_shapes(self, image_hw) -> list[tuple[int, int, int, int, int]]:
        """(channels, kernel, stride, H, W) of each block's depthwise conv
        input, in block order, for an input image of image_hw."""
        h, w = (-(-n // 2) for n in image_hw)  # the stem's stride 2
        shapes = []
        for b in self._blocks:
            dw = b._depthwise_conv
            s = dw.stride[0]
            shapes.append((dw.weight.shape[0], dw.kernel_size[0], s, h, w))
            h, w = -(-h // s), -(-w // s)
        return shapes

    def draw_drop_masks(self, batch_size: int, generator: torch.Generator) -> list:
        """Drop-connect keep masks for one train-mode forward, drawn on the CPU
        from `generator`: per block a (B,) bool tensor, kept with probability
        1 - rate, or None for a block that drops nothing."""
        return [torch.rand(batch_size, generator=generator) < 1.0 - b.drop_rate
                if b.drop_rate > 0 else None for b in self._blocks]

    def forward(self, x, drop_masks: list | None = None):
        """x (B, in_channels, H, W); drop_masks from draw_drop_masks, or None
        for no drop-connect (eval)."""
        with annotate("cosypose.backbone.stem"):
            x = F.silu(self._bn0(self._conv_stem(x)))
        blocks = enumerate(self._blocks)
        for name, repeats in zip(STAGE_SPANS, self.stage_repeats):
            with annotate(name):
                for i, block in itertools.islice(blocks, repeats):
                    x = block(x, None if drop_masks is None else drop_masks[i])
        with annotate("cosypose.backbone.head"):
            return F.silu(self._bn1(self._conv_head(x)))
