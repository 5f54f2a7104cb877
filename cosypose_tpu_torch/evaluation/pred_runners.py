"""Prediction runners over scene datasets (port of
cosypose_tpu/evaluation/pred_runners.py: `_group_images_K` and
MultiviewPredictionRunner).

MultiviewPredictionRunner iterates view groups, joins saved detections to
the group's frames by (scene_id, view_id) and runs coarse + refiner on them
(or the refiner from the detections' own poses). The multiview predictor
(ROADMAP queue 1 item 17), BopPredictionRunner and DetectionRunner (the
detector, item 15) are not ported yet.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np
import torch

from ..utils.tensor_collection import TensorCollection, concatenate
from . import table
from .data_utils import parse_camera_data

MULTIVIEW_NOT_PORTED = "multiview not ported (ROADMAP queue 1 item 17)"


def _group_images_K(group_obs):
    images = np.stack([np.transpose(rgb, (2, 0, 1)).astype(np.float32) / 255.0
                       for rgb, _, _ in group_obs])
    cam_rows = [parse_camera_data(obs, batch_im_id=n) for n, (_, _, obs) in enumerate(group_obs)]
    return images, np.stack([c["K"] for c in cam_rows]), cam_rows


class MultiviewPredictionRunner:
    def __init__(self, scene_ds_multiview, n_coarse_iterations=1, n_refiner_iterations=4):
        self.ds = scene_ds_multiview
        self.n_coarse = n_coarse_iterations
        self.n_refiner = n_refiner_iterations

    def get_predictions(self, pose_predictor, mv_predictor=None, detections=None,
                        use_detections_TCO=False, **mv_kwargs):
        """pose_predictor: CoarseRefinePosePredictor; detections:
        TensorCollection with infos scene_id, view_id, label, score and
        bboxes (and poses when use_detections_TCO). Returns {stage key:
        TensorCollection of every group's predictions}."""
        if mv_predictor is not None:
            raise NotImplementedError(MULTIVIEW_NOT_PORTED)
        if detections is None:
            raise ValueError("give saved detections")
        predictions = defaultdict(list)
        for group_idx in range(len(self.ds)):
            images, K, cam_rows = _group_images_K(self.ds[group_idx])
            frames = {k: np.asarray([c[k] for c in cam_rows])
                      for k in ("scene_id", "view_id", "batch_im_id", "group_id")}
            rows, fi = table.merge(detections.infos, frames, ["scene_id", "view_id"])
            if len(rows) == 0:
                continue
            group_dets = detections[rows]
            infos = dict(group_dets.infos, batch_im_id=frames["batch_im_id"][fi],
                         group_id=frames["group_id"][fi])
            dev = pose_predictor.device
            images, K = torch.as_tensor(images, device=dev), torch.as_tensor(K, device=dev)
            if use_detections_TCO:
                _, preds = pose_predictor.get_predictions(
                    images, K,
                    data_TCO_init=TensorCollection(infos, poses=group_dets.poses.to(dev)),
                    n_coarse_iterations=0, n_refiner_iterations=self.n_refiner)
            else:
                _, preds = pose_predictor.get_predictions(
                    images, K, detections=TensorCollection(infos, **group_dets.tensors),
                    n_coarse_iterations=self.n_coarse, n_refiner_iterations=self.n_refiner)
            for k, v in preds.items():
                predictions[k].append(v)
        return {k: concatenate(v) for k, v in predictions.items() if v}
