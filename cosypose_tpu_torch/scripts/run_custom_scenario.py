"""Multi-view scene reconstruction from a scenario directory (port of
cosypose_tpu/scripts/run_custom_scenario.py).

  python -m cosypose_tpu_torch.scripts.run_custom_scenario --scenario DIR \\
      [--sv_score_th 0.3] [--ransac_n_iter 2000] [--ransac_dist_threshold 0.02] \\
      [--ba_n_iter 100] [--nms_th 0.04] [--device cpu]

Reads DIR/candidates.csv (BOP CSV of single-view candidates), DIR/
scene_camera.json (BOP cameras) and DIR/models/ (BOP models), runs the
multiview predictor (RANSAC matching + bundle adjustment) and writes
DIR/results/predicted_scene.json (objects and cameras in the world frame) and
DIR/results/scene_reprojected.csv (every object in every camera, after
nms3d). main returns the scene and the predictions.
"""

from __future__ import annotations

import argparse
import json
import logging
import pathlib

import numpy as np
import torch

from ..data.bop import BOPObjectDataset
from ..evaluation.bop_export import csv_to_candidates, predictions_to_bop_csv
from ..integrated.multiview_predictor import MultiviewScenePredictor
from ..ops.mesh_db import build_mesh_db
from ..utils.tensor_collection import TensorCollection
from ..visualization.multiview import nms3d

logger = logging.getLogger(__name__)


def load_scene_cameras(path) -> TensorCollection:
    """BOP scene_camera.json → infos view_id, batch_im_id, scene_id (0); K
    and TWC (identity without cam_R_w2c)."""
    cams = json.loads(pathlib.Path(path).read_text())
    K_l, TWC_l = [], []
    for cam in cams.values():
        K_l.append(np.asarray(cam["cam_K"], np.float32).reshape(3, 3))
        TWC = np.eye(4, dtype=np.float32)
        if "cam_R_w2c" in cam:
            T_w2c = np.eye(4, dtype=np.float32)
            T_w2c[:3, :3] = np.asarray(cam["cam_R_w2c"], np.float32).reshape(3, 3)
            T_w2c[:3, 3] = np.asarray(cam["cam_t_w2c"], np.float32) / 1000.0
            TWC = np.linalg.inv(T_w2c)
        TWC_l.append(TWC)
    n = len(cams)
    infos = dict(view_id=np.asarray([int(v) for v in cams], np.int64),
                 batch_im_id=np.arange(n), scene_id=np.zeros(n, np.int64))
    return TensorCollection(infos, K=torch.as_tensor(np.stack(K_l)),
                            TWC=torch.as_tensor(np.stack(TWC_l)))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--scenario", required=True)
    parser.add_argument("--sv_score_th", type=float, default=0.3)
    parser.add_argument("--ransac_n_iter", type=int, default=2000)
    parser.add_argument("--ransac_dist_threshold", type=float, default=0.02)
    parser.add_argument("--ba_n_iter", type=int, default=100)
    parser.add_argument("--nms_th", type=float, default=0.04)
    parser.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    args = parser.parse_args(argv)

    scenario = pathlib.Path(args.scenario)
    infos, poses = csv_to_candidates(scenario / "candidates.csv")
    infos["group_id"] = np.zeros(len(poses), np.int64)
    candidates = TensorCollection(infos, poses=torch.as_tensor(poses))
    cameras = load_scene_cameras(scenario / "scene_camera.json")
    mesh_db = build_mesh_db(BOPObjectDataset(scenario / "models").mesh_specs(), aabb=True,
                            keep_geometry=False, device=args.device)
    preds = MultiviewScenePredictor(mesh_db).predict_scene_state(
        candidates, cameras, score_th=args.sv_score_th, ransac_n_iter=args.ransac_n_iter,
        ransac_dist_threshold=args.ransac_dist_threshold, ba_n_iter=args.ba_n_iter)

    objects, cams = preds["scene/objects"], preds["scene/cameras"]
    TWO, TWC, K = (t.cpu().numpy() for t in (objects.TWO, cams.TWC, cams.K))
    scene = dict(
        objects=[dict(label=str(objects.infos["label"][n]),
                      score=float(objects.infos["score"][n]),
                      n_cand=int(objects.infos["n_cand"][n]), TWO=TWO[n].tolist())
                 for n in range(len(objects))],
        cameras=[dict(view_id=int(cams.infos["view_id"][n]), TWC=TWC[n].tolist(),
                      K=K[n].tolist()) for n in range(len(cams))])
    (scenario / "results").mkdir(exist_ok=True)
    out_json = scenario / "results" / "predicted_scene.json"
    out_json.write_text(json.dumps(scene, indent=2))
    out_csv = scenario / "results" / "scene_reprojected.csv"
    predictions_to_bop_csv(nms3d(preds["ba_output"], th=args.nms_th), out_csv)
    logger.info(f"Wrote {out_json} and {out_csv}")
    return dict(scene=scene, predictions=preds)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
