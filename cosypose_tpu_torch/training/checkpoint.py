"""Checkpoint save/restore in a torch format (port of
cosypose_tpu/training/checkpoint.py), with the JAX package's run layout:

    <exp_dir>/<run_id>/config.yaml                 (JSON of the RunConfig)
    <exp_dir>/<run_id>/checkpoint/epoch_NNNNN.pt   (the last `keep` epochs)
    <exp_dir>/<run_id>/log.txt                     (jsonlines, logs.py)

A checkpoint is the whole train state, so a resume is exact: the net's state
dict (parameters and BatchNorm running statistics), the optimizer's (Adam
moments and counts), the step and the epoch. A state is any object with
`net`, `optimizer` and `step` (the pose and the detector train states).
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
from typing import Any

import torch


def save_checkpoint(run_dir, state, epoch: int, keep: int = 2) -> pathlib.Path:
    """Write the train state as checkpoint/epoch_NNNNN.pt and drop all but
    the newest `keep` checkpoints."""
    ckpt_dir = pathlib.Path(run_dir) / "checkpoint"
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    payload = dict(net=state.net.state_dict(), optimizer=state.optimizer.state_dict(),
                   step=int(state.step), epoch=int(epoch))
    path = ckpt_dir / f"epoch_{epoch:05d}.pt"
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    torch.save(payload, tmp)
    os.replace(tmp, path)
    for old in sorted(ckpt_dir.glob("epoch_*.pt"))[:-keep]:
        old.unlink()
    return path


def latest_checkpoint(run_dir) -> pathlib.Path | None:
    ckpts = sorted((pathlib.Path(run_dir) / "checkpoint").glob("epoch_*.pt"))
    return ckpts[-1] if ckpts else None


def load_checkpoint(path) -> dict:
    """The payload of save_checkpoint, its tensors on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


def restore_into_state(state, payload: dict) -> None:
    """Load a payload's net, optimizer and step into `state` (same config),
    in place."""
    state.net.load_state_dict(payload["net"])
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])


def save_config(run_dir, cfg: Any) -> None:
    """JSON dump of a (nested) dataclass config, dtypes by name."""
    run_dir = pathlib.Path(run_dir)
    run_dir.mkdir(parents=True, exist_ok=True)

    def encode(o):
        if dataclasses.is_dataclass(o):
            return {f.name: encode(getattr(o, f.name)) for f in dataclasses.fields(o)}
        if isinstance(o, (list, tuple)):
            return [encode(v) for v in o]
        if isinstance(o, torch.dtype):
            return str(o)
        return o

    (run_dir / "config.yaml").write_text(json.dumps(encode(cfg), indent=2, default=str))
