"""Run one cell of the benchmark once and print its result as the last line.

    python3 benchmark/run.py --workload ycbv-b3.frames --seed 7 --seconds 30 --trace 0
    python3 benchmark/run.py --list

Needs a CUDA card (exits 3 without one) and the port, cosypose_tpu_torch, in
the checkout. See benchmark/README.md.
"""

import time

T_START = time.perf_counter()

import pathlib  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from benchmark.harness.cli import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
