"""Evaluate the BOP20 predictions of every dataset of a result id (port of
cosypose_tpu/scripts/run_bop20_eval_multi.py): each
<results>/<result_id>/dataset=<ds>/ directory's first predictions CSV goes
through run_bop_eval (the official toolkit with --bop-toolkit-dir, the
native metrics otherwise), one spawned process a dataset or, with --serial,
one after the other in this process; the toolkit's score files are printed
at the end.

  python -m cosypose_tpu_torch.scripts.run_bop20_eval_multi --result-id bop-pbr-1 \\
      [--results-dir DIR] [--bop-toolkit-dir PATH] [--ds-root DIR] [--serial] [--device cpu]
"""

from __future__ import annotations

import argparse
import multiprocessing
import pathlib

from .. import config
from ..utils.logging import get_logger

logger = get_logger(__name__)


def eval_one(ds_name: str, csv_path, bop_toolkit_dir, ds_root, device: str):
    """run_bop_eval on one dataset's CSV; its (metrics, AR), or None when the
    toolkit scored it."""
    from .run_bop_eval import main as eval_main

    argv = ["--csv", str(csv_path), "--dataset", ds_name, "--device", device]
    if bop_toolkit_dir:
        argv += ["--bop-toolkit-dir", str(bop_toolkit_dir)]
    if ds_root:
        argv += ["--ds-root", str(ds_root)]
    return eval_main(argv)


def main(argv=None):
    parser = argparse.ArgumentParser("BOP multi evaluation")
    parser.add_argument("--result-id", required=True)
    parser.add_argument("--results-dir", default=None,
                        help="default: config.RESULTS_DIR")
    parser.add_argument("--bop-toolkit-dir", default=None)
    parser.add_argument("--ds-root", default=None)
    parser.add_argument("--serial", action="store_true")
    parser.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    args = parser.parse_args(argv)

    result_dir = pathlib.Path(args.results_dir or config.RESULTS_DIR) / args.result_id
    if not result_dir.exists():
        raise FileNotFoundError(result_dir)
    jobs = []
    for ds_dir in sorted(result_dir.iterdir()):
        if "=" not in ds_dir.name:
            continue
        csvs = sorted(ds_dir.glob("*.csv"))
        if not csvs:
            logger.warning(f"no prediction CSV under {ds_dir}")
            continue
        jobs.append((ds_dir.name.split("=")[-1], csvs[0]))

    results = {}
    if args.serial:
        for ds_name, csv_path in jobs:
            results[ds_name] = eval_one(ds_name, csv_path, args.bop_toolkit_dir, args.ds_root,
                                        args.device)
    else:
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=eval_one, args=(ds, csv, args.bop_toolkit_dir, args.ds_root,
                                                    args.device)) for ds, csv in jobs]
        for p in procs:
            p.start()
        for p in procs:
            p.join()
        failed = [ds for (ds, _), p in zip(jobs, procs) if p.exitcode != 0]
        if failed:
            raise RuntimeError(f"the evaluation of {failed} failed")

    print("-" * 80)
    for ds_name, csv_path in jobs:
        scores = csv_path.parent / "bop_eval" / "scores_bop19.json"
        print(f"{ds_name}: {scores}")
        if scores.exists():
            print(scores.read_text())
    return results


if __name__ == "__main__":
    main()
