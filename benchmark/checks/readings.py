"""The readings that a cell's correctness limits are set from: for each seed,
one run of the cell (a short window) with its numbers against the plain
reference, and the same numbers of the lower-precision control against the
reference. One process for all seeds.

    python3 benchmark/checks/readings.py --workload ycbv-b3.frames --seconds 5 --seeds 1 2 3
    python3 benchmark/checks/readings.py --workload tless-refiner.train --seeds 1 2 3 \
        --fault half_batch

Prints one JSON line a seed: {"seed", "fault", "program": {...}, "control": {...},
"detail": {...}}. With --fault the program's numbers are those of the broken
program and no control is read.
Needs a CUDA card, as a run does.
"""

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

from benchmark.checks import faults  # noqa: E402
from benchmark.harness import spec  # noqa: E402


def readings(cell, seeds, seconds: float, device: str, control: str, fault: str | None = None):
    """One row a seed: the numbers of the program (broken by `fault`, where
    given) and of the control, each against the reference."""
    kind = cell.traffic["kind"]
    drv = spec.driver(kind)
    for seed in seeds:
        out = drv.run(cell=cell, seed=seed, seconds=seconds, trace=False, device=device,
                      t_start=time.perf_counter(), control=None if fault else control,
                      faults=faults.get(kind, fault) if fault else None, all_checks=True)
        yield {"seed": seed, "fault": fault, "program": {k: v for k, v, _ in out.checks},
               "control": out.run.totals["control"], "detail": out.run.totals.get("detail"),
               "attempted": out.attempted, "failed": out.failed}


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--fault", choices=sorted({f for fs in faults.FAULTS.values() for f in fs}),
                   help="plant this fault under the timed path, in place of reading the control")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    cell = spec.cell(args.workload)
    for row in readings(cell, args.seeds, args.seconds, "cuda", cell.workload["control"],
                        args.fault):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
