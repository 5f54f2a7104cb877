"""Render the interactive multi-run HTML dashboard from run directories (port
of cosypose_tpu/scripts/make_dashboard.py).

  python -m cosypose_tpu_torch.scripts.make_dashboard [RUN_ID ...] \\
      [--exp-dir DIR] [--out local_data/experiments/dashboard.html]

With no RUN_IDs, every run under the experiments directory with a log.txt is
included (debug runs excluded).
"""

import argparse
import pathlib

from ..config import EXP_DIR
from ..utils.logging import get_logger
from ..visualization.dashboard import make_dashboard

logger = get_logger(__name__)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("run_ids", nargs="*",
                        help="run ids under EXP_DIR (default: all with logs)")
    parser.add_argument("--exp-dir", default=None)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)

    exp_dir = pathlib.Path(args.exp_dir or EXP_DIR)
    if args.run_ids:
        run_dirs = [exp_dir / r for r in args.run_ids]
    else:
        run_dirs = sorted(d for d in exp_dir.iterdir()
                          if (d / "log.txt").exists() and "debug" not in d.name)
    out = make_dashboard(run_dirs, args.out or (exp_dir / "dashboard.html"))
    logger.info(f"wrote {out} ({out.stat().st_size / 1e3:.0f} kB, {len(run_dirs)} runs)")
    return out


if __name__ == "__main__":
    main()
