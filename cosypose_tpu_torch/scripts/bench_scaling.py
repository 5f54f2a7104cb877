"""Data-parallel scaling, measured (port of the measured half of
cosypose_tpu/scripts/bench_scaling.py).

Step time of the dryrun's train step (parallel/dryrun.py: WideResNet-18,
32x32 renders, one iteration) at a FIXED global batch over n ∈ {1, 2, 4}
spawned ranks, each holding global/n rows, and the gradient's bytes that the
all-reduce moves each step. On one device the ranks share it, so the ideal
is a flat step time and a rise over n=1 is what splitting the step costs.

  python -m cosypose_tpu_torch.scripts.bench_scaling [--ranks 1 2 4] [--batch 32]
      [--steps 8] [--device cuda | cuda:0 | cpu] [--dist-backend gloo] [--json OUT]

"cuda" (the default) gives rank r cuda:r over NCCL, one card a rank, so n
needs n cards; "cuda:0" with --dist-backend gloo puts every rank on card 0;
"cpu" runs gloo ranks on the host.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from ..parallel.ddp import shard_batch
from ..parallel.dryrun import dryrun_batch, dryrun_config, dryrun_specs
from ..parallel.spawn import spawn
from ..training.pose_training import create_train_state, draw_step, make_train_step
from ..ops.mesh_db import build_mesh_db
from ..utils.device import synchronize


def measure_rank(rank: int, world: int, device: torch.device, batch: int, steps: int) -> dict:
    """Three warm-up steps, then `steps` timed ones, on this rank."""
    cfg = dryrun_config(batch // world, batch * steps)
    state = create_train_state(cfg, device, param_mode="replicated")
    db = build_mesh_db(dryrun_specs(), device=device)
    rows = {k: torch.as_tensor(v).to(device) for k, v in
            shard_batch(dryrun_batch(batch), rank, world).items()}
    rows["label_ids"] = rows["label_ids"].long()
    step = make_train_step(cfg, db)
    gen = torch.Generator().manual_seed(1)
    draws = [draw_step(cfg, state.pp, batch, db.points.shape[1], gen, rank, world)
             for _ in range(3 + steps)]
    for d in draws[:3]:
        metrics = step(state, rows, d)
    synchronize(device)
    t0 = time.perf_counter()
    for d in draws[3:]:
        metrics = step(state, rows, d)
    float(metrics["loss_total"])
    synchronize(device)
    return dict(step_ms=1e3 * (time.perf_counter() - t0) / steps,
                grad_bytes=sum(p.numel() * p.element_size() for p in state.pp.net.parameters()),
                loss=float(metrics["loss_total"]))


def main(argv=None) -> list:
    parser = argparse.ArgumentParser()
    parser.add_argument("--ranks", type=int, nargs="+", default=[1, 2, 4])
    parser.add_argument("--batch", type=int, default=32, help="the global batch")
    parser.add_argument("--steps", type=int, default=8)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--dist-backend", default=None)
    parser.add_argument("--json", default=None)
    args = parser.parse_args(argv)
    backend = args.dist_backend or ("gloo" if args.device == "cpu" else "nccl")
    if args.device == "cuda" and max(args.ranks) > torch.cuda.device_count():
        raise SystemExit(f"--device cuda puts each rank on a card of its own: {max(args.ranks)} "
                         f"ranks, {torch.cuda.device_count()} cards (--device cuda:0 "
                         "--dist-backend gloo shares card 0)")
    rows = []
    for n in args.ranks:
        per_rank = spawn(measure_rank, n, (args.batch, args.steps), backend=backend,
                         device=args.device, n_threads=1 if args.device == "cpu" else None)
        rows.append(dict(n_ranks=n, batch=args.batch, device=args.device, backend=backend,
                         step_ms=max(r["step_ms"] for r in per_rank),
                         grad_bytes=per_rank[0]["grad_bytes"], loss=per_rank[0]["loss"]))
        print(f"measured n={n}: {rows[-1]['step_ms']:.1f} ms/step", flush=True)
    base = rows[0]["step_ms"]
    print(f"\nDP scaling at a fixed global batch of {args.batch} on {args.device} "
          f"({backend}); ideal on one shared device: a flat step time")
    print(f"{'ranks':>6s} {'step ms':>9s} {'vs n=1':>8s}")
    for r in rows:
        r["vs_1"] = r["step_ms"] / base
        print(f"{r['n_ranks']:6d} {r['step_ms']:9.1f} {r['vs_1']:7.2f}x")
    print(f"gradient: {rows[0]['grad_bytes'] / 1e6:.2f} MB all-reduced a step (float32)")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=2)
    return rows


if __name__ == "__main__":
    main()
