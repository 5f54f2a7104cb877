"""Paper-style single- and multi-view evaluation CLI (port of
cosypose_tpu/scripts/run_cosypose_eval.py).

  python -m cosypose_tpu_torch.scripts.run_cosypose_eval --dataset ycbv \\
      --detections posecnn_init|pix2pose_detections|pix2pose_coarse_init|<candidates CSV> \\
      [--coarse RUN] --refiner RUN [--use-detections-tco] [--nviews N] \\
      [--n-refiner-iterations 4] [--object-ds NAME] [--ds-root DIR] [--exp-dir DIR] \\
      [--out-dir DIR] [--debug] [--device cpu]

Coarse + refiner (or the refiner alone from the detections' poses) over the
scene dataset <dataset>.test in view groups of --nviews frames, with the
multiview predictor when --nviews > 1; every prediction key is evaluated by
the paper's meters (ADD(-S) and ADD-S, AUC and AP) and the summary written to
<out-dir>/results.pkl (default <results>/eval-<dataset>). main returns the
predictions, the metrics and the summary text.
"""

from __future__ import annotations

import argparse
import logging
import pathlib
import pickle

import numpy as np
import torch

from .. import config
from ..data.datasets_cfg import make_object_dataset, make_scene_dataset
from ..data.wrappers import MultiViewWrapper
from ..evaluation.bop_export import csv_to_candidates
from ..evaluation.eval_runners import PoseEvaluation
from ..evaluation.meters import PoseErrorMeter
from ..evaluation.pred_runners import MultiviewPredictionRunner
from ..evaluation.runner_utils import format_results
from ..integrated.multiview_predictor import MultiviewScenePredictor
from ..integrated.pose_predictor import CoarseRefinePosePredictor
from ..ops.mesh_db import build_mesh_db
from ..utils.tensor_collection import TensorCollection
from .run_bop_inference import load_pose_model

logger = logging.getLogger(__name__)


def get_pose_meters(mesh_db, obj_ds, n_top=1) -> dict:
    """The paper's meter set; diameters from the object set where it has them."""
    for o in getattr(obj_ds, "objects", []):
        if o.get("diameter_m") is not None:
            mesh_db.infos[o["label"]]["diameter_m"] = o["diameter_m"]
    return {
        "ADD(-S)_ntop=1": PoseErrorMeter(mesh_db, error_type="ADD(-S)", n_top=n_top,
                                         sample_n_points=2000, report_error_AUC=True,
                                         report_AP=True),
        "ADD-S_ntop=1": PoseErrorMeter(mesh_db, error_type="ADD-S", n_top=n_top,
                                       sample_n_points=2000, report_error_AUC=True),
    }


def load_detections(name: str, nviews: int):
    """(detections, use their poses): a saved paper-protocol set or a BOP
    candidates CSV (whose poses the refiner starts from)."""
    from ..evaluation import saved_detections

    if name == "posecnn_init":
        return saved_detections.load_posecnn_results(), True
    if name in ("pix2pose_detections", "pix2pose_coarse_init"):
        coarse_init = name == "pix2pose_coarse_init"
        return saved_detections.load_pix2pose_results(all_detections=nviews > 1,
                                                      remove_incorrect_poses=coarse_init), \
            coarse_init
    infos, poses = csv_to_candidates(name)
    return TensorCollection(infos, poses=torch.as_tensor(poses)), None


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", required=True,
                        help="scene dataset prefix: <dataset>.test is evaluated")
    parser.add_argument("--detections", required=True,
                        help="a BOP CSV of candidate poses, or a saved paper-protocol set: "
                             "posecnn_init (YCB-V PoseCNN), pix2pose_detections / "
                             "pix2pose_coarse_init (T-LESS)")
    parser.add_argument("--coarse", default=None)
    parser.add_argument("--refiner", required=True)
    parser.add_argument("--use-detections-tco", action="store_true",
                        help="start the refiner from the detections' poses")
    parser.add_argument("--nviews", type=int, default=1)
    parser.add_argument("--n-refiner-iterations", type=int, default=4)
    parser.add_argument("--object-ds", default=None,
                        help="object set (default <dataset>.models)")
    parser.add_argument("--ds-root", default=None)
    parser.add_argument("--exp-dir", default=None, help="runs directory (default config.EXP_DIR)")
    parser.add_argument("--out-dir", default=None,
                        help="results directory (default <results>/eval-<dataset>)")
    parser.add_argument("--debug", action="store_true", help="the first 4 frames")
    parser.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    args = parser.parse_args(argv)

    scene_ds = make_scene_dataset(f"{args.dataset}.test", ds_root=args.ds_root)
    if args.debug:
        scene_ds.frame_index = scene_ds.frame_index.select(np.arange(min(4, len(scene_ds))))
    obj_ds = make_object_dataset(args.object_ds or f"{args.dataset}.models",
                                 ds_root=args.ds_root)
    mesh_db = build_mesh_db(obj_ds.mesh_specs(), device=args.device)

    detections, use_tco = load_detections(args.detections, args.nviews)
    use_tco = args.use_detections_tco if use_tco is None else use_tco
    if not use_tco and not args.coarse:
        raise SystemExit("box-seeded evaluation runs a coarse iteration: pass --coarse RUN "
                         "(or --use-detections-tco to start the refiner from the poses)")
    if not use_tco and "bboxes" not in detections.tensors:
        raise SystemExit("box-seeded evaluation needs detections with boxes; use "
                         "--use-detections-tco to start the refiner from the CSV's poses")
    refiner = load_pose_model(args.refiner, mesh_db, exp_dir=args.exp_dir, device=args.device)
    coarse = (load_pose_model(args.coarse, mesh_db, exp_dir=args.exp_dir, device=args.device)
              if args.coarse else None)
    predictor = CoarseRefinePosePredictor(coarse, refiner, device=args.device)
    mv_predictor = MultiviewScenePredictor(build_mesh_db(
        obj_ds.mesh_specs(), aabb=True, keep_geometry=False, device=args.device)) \
        if args.nviews > 1 else None

    runner = MultiviewPredictionRunner(MultiViewWrapper(scene_ds, n_views=args.nviews),
                                       n_coarse_iterations=0 if use_tco else 1,
                                       n_refiner_iterations=args.n_refiner_iterations)
    preds = runner.get_predictions(predictor, mv_predictor=mv_predictor, detections=detections,
                                   use_detections_TCO=use_tco)

    evaluator = PoseEvaluation(scene_ds, get_pose_meters(mesh_db, obj_ds))
    metrics, dfs = {}, {}
    for key, tc in preds.items():
        if "poses" in tc.tensors:  # the scene's objects and cameras are world poses
            metrics[key], dfs[key] = evaluator.evaluate(tc)
    results = format_results(preds, metrics, dfs)
    out = pathlib.Path(args.out_dir or config.RESULTS_DIR / f"eval-{args.dataset}")
    out.mkdir(parents=True, exist_ok=True)
    with open(out / "results.pkl", "wb") as f:
        pickle.dump(dict(summary=results["summary"], summary_txt=results["summary_txt"]), f)
    logger.info(results["summary_txt"])
    return dict(predictions=preds, metrics=metrics, summary_txt=results["summary_txt"])


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
