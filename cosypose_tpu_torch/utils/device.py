"""Device selection for the port's entry points: the card unless asked otherwise."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """`torch.device(device)` with an explicit index for CUDA, raising when a
    CUDA device is asked for and absent.

    The port never falls back to the CPU on its own: a caller that wants the
    CPU (the tests) passes `device="cpu"`.
    """
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a CUDA device was requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run on the CPU"
            )
        if device.index is None:  # "cuda" → "cuda:N", as tensors report it
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def synchronize(device) -> None:
    """Waits for a CUDA device's queued work (nothing to wait for elsewhere),
    so that a host clock read after it holds the card's time."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
