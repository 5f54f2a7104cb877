"""Checkpoint save/restore in a torch format (port of
cosypose_tpu/training/checkpoint.py), with the JAX package's run layout:

    <exp_dir>/<run_id>/config.yaml                 (JSON of the RunConfig)
    <exp_dir>/<run_id>/checkpoint/epoch_NNNNN.pt   (the last `keep` epochs)
    <exp_dir>/<run_id>/log.txt                     (jsonlines, logs.py)

A checkpoint is the whole train state, so a resume is exact: the net's state
dict (parameters and BatchNorm running statistics), the optimizer's (Adam
moments and counts), the step and the epoch. A state is any object with
`net`, `optimizer`, `step` and `dp` (the pose and the detector train
states). A data-parallel run saves the same format: every rank calls
save_checkpoint (under FSDP it gathers the whole state dicts), rank 0 writes,
and the others wait for it; every rank loads.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
from typing import Any

import torch

from ..utils.distributed import barrier, get_rank


def save_checkpoint(run_dir, state, epoch: int, keep: int = 2) -> pathlib.Path:
    """Write the train state as checkpoint/epoch_NNNNN.pt and drop all but
    the newest `keep` checkpoints (rank 0 writes; every rank returns once it
    has)."""
    if state.dp is None:
        net, optimizer = state.net.state_dict(), state.optimizer.state_dict()
    else:
        net, optimizer = state.dp.state_dict(), state.dp.optimizer_state_dict(state.optimizer)
    ckpt_dir = pathlib.Path(run_dir) / "checkpoint"
    path = ckpt_dir / f"epoch_{epoch:05d}.pt"
    if get_rank() == 0:
        ckpt_dir.mkdir(parents=True, exist_ok=True)
        payload = dict(net=net, optimizer=optimizer, step=int(state.step), epoch=int(epoch))
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        torch.save(payload, tmp)
        os.replace(tmp, path)
        for old in sorted(ckpt_dir.glob("epoch_*.pt"))[:-keep]:
            old.unlink()
    barrier()
    return path


def latest_checkpoint(run_dir) -> pathlib.Path | None:
    ckpts = sorted((pathlib.Path(run_dir) / "checkpoint").glob("epoch_*.pt"))
    return ckpts[-1] if ckpts else None


def load_checkpoint(path) -> dict:
    """The payload of save_checkpoint, its tensors on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


def load_net_state(state, net_state: dict, strict: bool = True) -> None:
    """Load a net state dict into `state`'s net (sharded where FSDP shards it);
    `strict` False loads the entries it has and leaves the rest."""
    if state.dp is None:
        state.net.load_state_dict(net_state, strict=strict)
    else:
        state.dp.load_state_dict(net_state, strict=strict)


def restore_into_state(state, payload: dict) -> None:
    """Load a payload's net, optimizer and step into `state` (same config),
    in place."""
    load_net_state(state, payload["net"])
    if state.dp is None:
        state.optimizer.load_state_dict(payload["optimizer"])
    else:
        state.dp.load_optimizer_state_dict(state.optimizer, payload["optimizer"])
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
