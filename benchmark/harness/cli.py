"""One run of one cell: arguments, the card check, the driver of the cell's
mix, the per-layer readers, the check of the modules loaded, the result line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

from benchmark.harness import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "cosypose_tpu"}


@dataclasses.dataclass
class Run:
    """What a driver hands the per-layer readers."""

    config: dict
    window_s: float                 # the measured window, host clock
    spans: dict                     # name -> [ms of each call]
    counters: dict                  # name -> count
    profile: dict | None            # harness.trace.profile's result, traced run only
    totals: dict                    # driver's sums over the window (rows, flops, ...)


@dataclasses.dataclass
class Outcome:
    """A driver's result: end-to-end values by name, the readers' input,
    requests or steps attempted and failed, the checks as (name, value,
    limit) and the device's peak memory."""

    end_to_end: dict
    run: Run
    attempted: int
    failed: int
    checks: list
    memory_peak_bytes: int


def stage(t_start: float, what: str) -> None:
    """One line of the set-up's progress on standard error."""
    print(f"[{time.perf_counter() - t_start:9.3f} s] {what}", file=sys.stderr, flush=True)


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def execute(cell: spec.Cell, seed: int, seconds: float, trace: bool, device: str,
            t_start: float) -> dict:
    """Run the cell once on `device`; returns the result object (without the
    module check, which main makes once the window has closed)."""
    import torch

    out: Outcome = spec.driver(cell.traffic["kind"]).run(
        cell=cell, seed=seed, seconds=seconds, trace=trace, device=device, t_start=t_start)
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = spec.reader(m["name"])(out.run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out.end_to_end[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    cuda = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips if cuda else 0,
           "memory_peak_bytes": out.memory_peak_bytes}
    result = {"correct": out.failed == 0 and all(v <= lim for _, v, lim in out.checks),
              "attempted": out.attempted, "failed": out.failed, "metrics": metrics,
              "device": dev}
    if trace and out.run.profile is not None:
        from benchmark.harness.trace import breakdown

        dev["busy_s"] = out.run.profile["busy_s"]
        dev["window_s"] = out.run.profile["window_s"]
        result["breakdown"] = breakdown(out.run.profile)
    result["check"] = {name: {"value": v, "limit": lim} for name, v, lim in out.checks}
    return result


def main(argv: list, t_start: float) -> int:
    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload")
    p.add_argument("--seed", type=int)
    p.add_argument("--seconds", type=float)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--list", action="store_true",
                   help="print each cell with its configuration, mix and metrics, and exit")
    args = p.parse_args(argv)
    if args.list:
        for name, row in spec.listing().items():
            print(name, json.dumps(row))
        return 0
    if args.workload is None or args.seed is None or args.seconds is None:
        p.error("--workload, --seed and --seconds are required")
    cell = spec.cell(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    result = execute(cell, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
    bad = loaded_forbidden()
    if bad:
        print(f"the run loaded {bad}: the benchmark measures the PyTorch port alone",
              file=sys.stderr)
        return 4
    for name, c in result["check"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
