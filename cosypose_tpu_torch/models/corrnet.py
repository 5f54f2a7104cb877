"""Correlation backbone (port of cosypose_tpu/models/corrnet.py).

One shared stride-4 stem encodes the observed crop (channels 0:3), the
render (3:6) and, with 9 input channels, their difference (6:9); a local
correlation volume between the observation's and the render's features,
concatenated with those features, feeds a plain conv trunk of 512 features.
The stem is one module applied two or three times: in train mode its
BatchNorm running statistics move once per application, in that order, as
in the JAX package. Module names are the JAX package's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .wide_resnet import batch_norm

CORR_RADIUS = 6
STEM_FEATURES = 64


def local_correlation(f1: torch.Tensor, f2: torch.Tensor, radius: int) -> torch.Tensor:
    """corr[b, (dy,dx), h, w] = mean over C of f1[b, :, h+dy-r, w+dx-r] ·
    f2[b, :, h, w], f1 zero-padded. f1, f2 (B, C, H, W) → (B, (2r+1)², H, W)
    fp32, the shifts in (dy, dx) row-major order; products and means in the
    inputs' dtype, as in the JAX package."""
    H, W = f1.shape[-2:]
    pad = F.pad(f1, (radius, radius, radius, radius))
    n = 2 * radius + 1
    out = [(pad[:, :, dy:dy + H, dx:dx + W] * f2).mean(dim=1)
           for dy in range(n) for dx in range(n)]
    return torch.stack(out, dim=1).float()


class Stem(nn.Module):
    """Shared-weight encoder: two stride-2 convs with BatchNorm and ReLU."""

    def __init__(self):
        super().__init__()
        features = STEM_FEATURES
        self.conv1 = nn.Conv2d(3, features // 2, 5, stride=2, padding=2, bias=False)
        self.bn1 = batch_norm(features // 2)
        self.conv2 = nn.Conv2d(features // 2, features, 3, stride=2, padding=1, bias=False)
        self.bn2 = batch_norm(features)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(x)))


class CorrNet(nn.Module):
    """Input (B, 6|9, H, W) → (B, 512, H/16, W/16) (each halving ⌈n/2⌉)."""

    n_halvings = 4
    n_features = 512

    def __init__(self, in_channels: int = 6):
        super().__init__()
        self.stem = Stem()
        n_views = 3 if in_channels > 6 else 2
        trunk_in = (2 * CORR_RADIUS + 1) ** 2 + n_views * STEM_FEATURES
        self.conv3 = nn.Conv2d(trunk_in, 128, 3, padding=1, bias=False)
        self.bn3 = batch_norm(128)
        self.conv4 = nn.Conv2d(128, 256, 3, stride=2, padding=1, bias=False)
        self.bn4 = batch_norm(256)
        self.conv5 = nn.Conv2d(256, self.n_features, 3, stride=2, padding=1, bias=False)
        self.bn5 = batch_norm(self.n_features)

    def draw_drop_masks(self, batch_size, generator):
        return None

    def forward(self, x):
        f_obs = self.stem(x[:, 0:3])
        f_rend = self.stem(x[:, 3:6])
        corr = local_correlation(f_obs, f_rend, CORR_RADIUS).to(f_obs.dtype)
        feats = [corr, f_obs, f_rend]
        if x.shape[1] > 6:
            feats.append(self.stem(x[:, 6:9]))
        y = torch.cat(feats, dim=1)
        y = F.relu(self.bn3(self.conv3(y)))
        y = F.relu(self.bn4(self.conv4(y)))
        return F.relu(self.bn5(self.conv5(y)))
