"""BOP evaluation of a predictions CSV (port of
cosypose_tpu/scripts/run_bop_eval.py).

  python -m cosypose_tpu_torch.scripts.run_bop_eval --csv <predictions.csv> \\
      --dataset ycbv [--bop-toolkit-dir PATH] [--ds-root DIR] [--device cpu]

With --bop-toolkit-dir the official bop_toolkit scores the CSV in a
subprocess. Without it the native metrics run: the ADD(-S) meter's AUC, AP
and 0.1d recall over '<dataset>.test.bop19', then the BOP19 Average Recall
(VSD from depth renders through BatchRenderer, MSSD, MSPD). Frames may be
PNG or JPEG (BOP's PBR splits are JPEG); both decode as Pillow's do.
"""

from __future__ import annotations

import argparse
import logging
import pathlib
import subprocess
import sys

import torch

logger = logging.getLogger(__name__)


def run_toolkit_eval(csv_path, toolkit_dir, results_dir):
    """Run the official eval in a subprocess."""
    script = pathlib.Path(toolkit_dir) / "scripts" / "eval_bop19.py"
    cmd = [sys.executable, str(script), "--renderer_type", "python",
           "--result_filenames", str(csv_path),
           "--results_path", str(pathlib.Path(csv_path).parent),
           "--eval_path", str(results_dir)]
    logger.info(f"Running official BOP eval: {' '.join(cmd)}")
    return subprocess.run(cmd, check=True)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--csv", required=True)
    parser.add_argument("--dataset", required=True)
    parser.add_argument("--bop-toolkit-dir", default=None)
    parser.add_argument("--ds-root", default=None)
    parser.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    args = parser.parse_args(argv)

    if args.bop_toolkit_dir and pathlib.Path(args.bop_toolkit_dir).exists():
        run_toolkit_eval(args.csv, args.bop_toolkit_dir, pathlib.Path(args.csv).parent / "bop_eval")
        return None

    logger.info("bop_toolkit not available: computing the native metrics")
    from ..data.datasets_cfg import make_object_dataset, make_scene_dataset
    from ..evaluation.bop_export import csv_to_candidates
    from ..evaluation.bop_metrics import compute_bop19_ar
    from ..evaluation.eval_runners import PoseEvaluation
    from ..evaluation.meters import PoseErrorMeter
    from ..ops.mesh_db import build_mesh_db
    from ..rendering.scene_renderer import BatchRenderer
    from ..utils.tensor_collection import TensorCollection

    infos, poses = csv_to_candidates(args.csv)
    preds = TensorCollection(infos, poses=torch.as_tensor(poses))
    scene_ds = make_scene_dataset(f"{args.dataset}.test.bop19", ds_root=args.ds_root,
                                  load_depth=True)
    obj_ds = make_object_dataset(f"{args.dataset}.models", ds_root=args.ds_root)
    mesh_db = build_mesh_db(obj_ds.mesh_specs(), device=args.device)
    for o in obj_ds.objects:
        mesh_db.infos[o["label"]]["diameter_m"] = o["diameter_m"]

    meters = {"ADD(-S)": PoseErrorMeter(mesh_db, error_type="ADD(-S)", report_error_AUC=True,
                                        report_AP=True, sample_n_points=2000)}
    metrics, _ = PoseEvaluation(scene_ds, meters).evaluate(preds)
    for name, summary in metrics.items():
        logger.info(f"{name}: {summary}")

    # the native BOP19 Average Recall: VSD over the split's depth, MSSD, MSPD
    ar = compute_bop19_ar(preds, scene_ds, mesh_db, renderer=BatchRenderer(mesh_db))
    logger.info(f"BOP19 AR: AR={ar['AR']:.4f} vsd={ar['AR_vsd']:.4f} mssd={ar['AR_mssd']:.4f} "
                f"mspd={ar['AR_mspd']:.4f} (n_gt={ar['n_gt']})")
    return metrics, ar


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
