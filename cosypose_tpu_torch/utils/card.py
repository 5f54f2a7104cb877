"""What the port's benches know of a card: its dense peak FLOP/s, keyed by the
name `torch.cuda.get_device_name` reports, and its name and power limit as
nvidia-smi reads them.

One table for every reader (bench.py, scripts/bench_stages.py,
ops/raster_bounds.py). A card that is not in it has no peak: its MFU is
null, never another card's.
"""

from __future__ import annotations

import subprocess

import torch

H100_SXM = "NVIDIA H100 80GB HBM3"
# NVIDIA H100 Tensor Core GPU data sheet, H100 SXM5 at its 700 W limit, dense
# (without sparsity): bf16 on the tensor cores, fp32 outside them (TF32 off)
PEAK_FLOPS = {
    H100_SXM: {torch.bfloat16: 989.4e12, torch.float32: 67e12},
}


def peak_flops(device_name: str, dtype: torch.dtype) -> float | None:
    """The card's dense peak FLOP/s for `dtype`, or None where the table has
    no such card or type."""
    return PEAK_FLOPS.get(device_name, {}).get(dtype)


def card_identity() -> str:
    """The first card's `name, power.limit` as nvidia-smi prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]
