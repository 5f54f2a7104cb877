"""Inference API for stages 2 and 3: multi-view scene reconstruction (port of
cosypose_tpu/integrated/multiview_predictor.py).

Score filter → candidate matching → view groups → bundle adjustment of each
group → every reconstructed object reprojected into every camera (score +
1, from_ba True). The prediction keys are the JAX package's: cand_inputs,
cand_matched, scene/objects, scene/cameras, ba_input, ba_output and
ba_output+all_cand, with their rows in its order.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..evaluation import table
from ..multiview.bundle_adjustment import MultiviewRefinement, make_view_groups
from ..multiview.ransac import multiview_candidate_matching
from ..ops.transforms import invert_T
from ..utils.tensor_collection import TensorCollection, concatenate

logger = logging.getLogger(__name__)


class MultiviewScenePredictor:
    def __init__(self, mesh_db_ransac, mesh_db_ba=None):
        """mesh_db_ransac: a mesh database built with aabb=True (8 corner
        points); mesh_db_ba: a point set for the bundle adjustment (the same
        by default, as in the reference)."""
        self.mesh_db_ransac = mesh_db_ransac
        self.mesh_db_ba = mesh_db_ba if mesh_db_ba is not None else mesh_db_ransac

    def reproject_scene(self, objects: TensorCollection, cameras: TensorCollection):
        """Every object into every camera, object-major: infos scene_id,
        view_id, score (+1), view_group, label, batch_im_id, obj_id, from_ba;
        poses TCO = TWC⁻¹ @ TWO (host float32)."""
        TCW = invert_T(cameras.TWC.to(torch.float32)).cpu().numpy()
        TWO = objects.TWO.to(torch.float32).cpu().numpy()
        n_o, n_v = len(objects), len(cameras)
        o, v = np.repeat(np.arange(n_o), n_v), np.tile(np.arange(n_v), n_o)
        cam, obj = cameras.infos, objects.infos
        infos = dict(scene_id=np.asarray(cam["scene_id"])[v], view_id=np.asarray(cam["view_id"])[v],
                     score=np.asarray(obj["score"])[o] + 1.0,
                     view_group=np.asarray(obj["view_group"])[o],
                     label=np.asarray(obj["label"])[o],
                     batch_im_id=np.asarray(cam["batch_im_id"])[v],
                     obj_id=np.asarray(obj["obj_id"])[o], from_ba=np.ones(len(o), bool))
        poses = np.stack([TCW[j] @ TWO[i] for i, j in zip(o, v)]) if len(o) \
            else np.zeros((0, 4, 4), np.float32)
        return TensorCollection(infos, poses=torch.as_tensor(poses))

    def predict_scene_state(self, candidates: TensorCollection, cameras: TensorCollection,
                            score_th: float = 0.3, use_known_camera_poses: bool = False,
                            ransac_n_iter: int = 2000, ransac_dist_threshold: float = 0.02,
                            ba_n_iter: int = 100) -> dict:
        """candidates: one scene's infos scene_id, group_id, view_id, label,
        score and poses; cameras: infos scene_id, view_id, batch_im_id and K
        (and TWC for use_known_camera_poses)."""
        predictions = {}
        cand_inputs = candidates
        if len(np.unique(candidates.infos["scene_id"])) != 1:
            raise ValueError("predict_scene_state takes the candidates of one scene")
        scene_id = candidates.infos["scene_id"][0]
        group_id = candidates.infos["group_id"][0]
        candidates = candidates[np.flatnonzero(np.asarray(candidates.infos["score"]) >= score_th)]
        predictions["cand_inputs"] = candidates
        logger.debug(f"Num candidates: {len(candidates)}, num views: {len(cameras)}")

        matching = multiview_candidate_matching(
            candidates=candidates, mesh_db=self.mesh_db_ransac, n_ransac_iter=ransac_n_iter,
            dist_threshold=ransac_dist_threshold,
            cameras=cameras if use_known_camera_poses else None)
        pairs_TC1C2 = matching["pairs_TC1C2"]
        candidates = matching["filtered_candidates"]
        predictions["cand_matched"] = candidates
        candidates = candidates.merge_df(make_view_groups(pairs_TC1C2), on="view_id")

        pred_objects, pred_cameras, pred_reproj, pred_reproj_init = [], [], [], []
        for (view_group,), rows in table.groups(candidates.infos, ["view_group"]).items():
            ba = MultiviewRefinement(candidates[rows], cameras, pairs_TC1C2,
                                     self.mesh_db_ba).solve(
                n_iterations=ba_n_iter, optimize_cameras=not use_known_camera_poses)
            for key in ("objects", "cameras", "objects_init", "cameras_init"):
                infos = ba[key].infos
                infos.update(view_group=np.full(len(ba[key]), view_group),
                             group_id=np.full(len(ba[key]), group_id),
                             scene_id=np.full(len(ba[key]), scene_id))
            for key in ("cameras", "cameras_init"):
                coll = ba[key]
                if "batch_im_id" not in coll.infos and "batch_im_id" in cameras.infos:
                    lookup = dict(zip(np.asarray(cameras.infos["view_id"]).tolist(),
                                      np.asarray(cameras.infos["batch_im_id"])))
                    coll.infos["batch_im_id"] = np.asarray(
                        [lookup[v] for v in np.asarray(coll.infos["view_id"]).tolist()])
            pred_reproj.append(self.reproject_scene(ba["objects"], ba["cameras"]))
            pred_reproj_init.append(self.reproject_scene(ba["objects_init"], ba["cameras_init"]))
            pred_objects.append(ba["objects"])
            pred_cameras.append(ba["cameras"])

        predictions["scene/objects"] = concatenate(pred_objects)
        predictions["scene/cameras"] = concatenate(pred_cameras)
        predictions["ba_output"] = concatenate(pred_reproj)
        predictions["ba_input"] = concatenate(pred_reproj_init)
        cand_inputs = TensorCollection(dict(cand_inputs.infos, from_ba=np.zeros(len(cand_inputs),
                                                                               bool)),
                                       poses=cand_inputs.poses.cpu())
        predictions["ba_output+all_cand"] = concatenate([predictions["ba_output"], cand_inputs])
        return predictions
