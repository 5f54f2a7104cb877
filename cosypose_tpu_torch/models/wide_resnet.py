"""Pre-activation WideResNet-18/34 and the FlowNetS encoder (port of
cosypose_tpu/models/wide_resnet.py).

WideResNet: a 5×5/stride-2 stem conv, BatchNorm, ReLU, a 3×3/stride-2 max
pool with padding 1, then four stages of pre-activation BasicBlocks
([2,2,2,2] or [3,4,6,3]) of 64·w, 128·w, 256·w and 512·w channels; a block's
1×1 downsample conv reads the PRE-ACTIVATED input, as in the JAX package.
FlowNetS: the contracting half only, biased convs, leaky ReLU 0.1, 1024
features. Convolutions pad symmetrically as the JAX package's explicit
paddings do. Module names are the JAX package's (`stem_conv`,
`stage{s}_block{i}.bn1`, `conv3_1`, …), so utils/weights.py maps the flax
trees by name. BatchNorm follows flax (momentum 0.9, epsilon 1e-5).
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from .efficientnet import BatchNorm2d

BN_EPS = 1e-5
FLAX_MOMENTUM = 0.9


def batch_norm(ch: int) -> BatchNorm2d:
    return BatchNorm2d(ch, eps=BN_EPS, flax_momentum=FLAX_MOMENTUM)


class PreActBasicBlock(nn.Module):
    def __init__(self, in_ch: int, planes: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.bn1 = batch_norm(in_ch)
        self.downsample = (nn.Conv2d(in_ch, planes, 1, stride=stride, bias=False)
                           if downsample else None)
        self.conv1 = nn.Conv2d(in_ch, planes, 3, stride=stride, padding=1, bias=False)
        self.bn2 = batch_norm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)

    def forward(self, x):
        out = F.relu(self.bn1(x))
        residual = self.downsample(out) if self.downsample is not None else x
        out = F.relu(self.bn2(self.conv1(out)))
        return self.conv2(out) + residual


class WideResNet(nn.Module):
    """Input (B, in_channels, H, W) → (B, 512·width, ⌈H/32⌉, ⌈W/32⌉)."""

    n_halvings = 5  # stem, pool and three strided stages each give ⌈n/2⌉

    def __init__(self, layers=(2, 2, 2, 2), width: float = 1.0, in_channels: int = 6):
        super().__init__()
        chs = [int(v * width) for v in (64, 128, 256, 512)]
        self.n_features = int(512 * width)
        self.stem_conv = nn.Conv2d(in_channels, chs[0], 5, stride=2, padding=2, bias=False)
        self.stem_bn = batch_norm(chs[0])
        self.block_names = []
        in_ch = chs[0]
        for stage, (planes, n_blocks) in enumerate(zip(chs, layers)):
            for i in range(n_blocks):
                s = (1 if stage == 0 else 2) if i == 0 else 1
                name = f"stage{stage}_block{i}"
                self.add_module(name, PreActBasicBlock(
                    in_ch, planes, s, downsample=i == 0 and (s != 1 or in_ch != planes)))
                self.block_names.append(name)
                in_ch = planes

    def draw_drop_masks(self, batch_size, generator):
        return None  # no drop-connect in this backbone

    def forward(self, x):
        x = F.relu(self.stem_bn(self.stem_conv(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for name in self.block_names:
            x = getattr(self, name)(x)
        return x


def WideResNet18(width: float = 1.0, in_channels: int = 6) -> WideResNet:
    return WideResNet((2, 2, 2, 2), width, in_channels)


def WideResNet34(width: float = 1.0, in_channels: int = 6) -> WideResNet:
    return WideResNet((3, 4, 6, 3), width, in_channels)


class FlowNetSEncoder(nn.Module):
    """The contracting half of FlowNetS: (B, in_channels, H, W) → (B, 1024,
    ⌈H/64⌉, ⌈W/64⌉)."""

    n_features = 1024
    n_halvings = 6
    LAYERS = (("conv1", 64, 7, 2), ("conv2", 128, 5, 2), ("conv3", 256, 5, 2),
              ("conv3_1", 256, 3, 1), ("conv4", 512, 3, 2), ("conv4_1", 512, 3, 1),
              ("conv5", 512, 3, 2), ("conv5_1", 512, 3, 1), ("conv6", 1024, 3, 2),
              ("conv6_1", 1024, 3, 1))

    def __init__(self, in_channels: int = 6):
        super().__init__()
        ch = in_channels
        for name, out, k, s in self.LAYERS:
            self.add_module(name, nn.Conv2d(ch, out, k, stride=s, padding=(k - 1) // 2))
            ch = out

    def draw_drop_masks(self, batch_size, generator):
        return None

    def forward(self, x):
        for name, *_ in self.LAYERS:
            x = F.leaky_relu(getattr(self, name)(x), 0.1)
        return x
