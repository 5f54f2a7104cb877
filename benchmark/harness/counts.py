"""The yardstick's arithmetic: the card's peaks, the useful FLOPs of one row
of the configuration's network, and the bytes of a render call.

Both counts depend only on the configuration and the call's shapes, never on
how the program lays out or pads its work, so a share reads the same work
whatever implements it.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference import efficientnet as ref_net

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit
PEAK_FLOPS = {"bfloat16": 989.4e12, "float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12


@functools.lru_cache(maxsize=None)
def network_flops(variant: str, render_hw: tuple, train: bool) -> float:
    """FLOPs of the plain network on one row at the render size: the forward
    counted by FlopCounterMode on the meta device, and with `train` the
    backward to every parameter added as twice the forward (the gradients of
    each layer's input and weight) less the gradient of the network's input,
    which no step needs. FlopCounterMode itself counts the backward of a
    grouped (depthwise) convolution as if it had one group."""
    shapes = ref_net.param_shapes(variant)
    params = {k: torch.zeros(s, device="meta") for k, s in shapes.items()}
    x = torch.zeros(1, 6, *render_hw, device="meta")
    counter = FlopCounterMode(display=False)
    with counter:
        ref_net.Net(params, variant)(x)
    forward = float(counter.get_total_flops())
    if not train:
        return forward
    stem = FlopCounterMode(display=False)
    with stem:
        ref_net.Net(params, variant).conv("_conv_stem", x, 2)
    return 3 * forward - float(stem.get_total_flops())


def render_bytes(rows: int, valid_faces: int, pixels: int) -> int:
    """The least traffic of render calls: each input read once (the valid
    triangles: corners and corner colours, 2 x 36 bytes a face; a pose and
    intrinsics a row) and each output written once (rgb float32, depth
    float32, mask bool: 17 bytes a pixel)."""
    return valid_faces * 72 + rows * (64 + 36) + pixels * 17
