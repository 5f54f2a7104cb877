"""Evaluation runners: iterate the GT, feed every meter, summarize (port of
cosypose_tpu/evaluation/eval_runners.py)."""

from __future__ import annotations

import numpy as np

from ..utils.tensor_collection import concatenate
from .data_utils import parse_obs_data


class PoseEvaluation:
    def __init__(self, scene_ds, meters: dict, chunk_views: int = 200):
        self.scene_ds = scene_ds
        self.meters = meters
        # a meter's add() works on the frames of one chunk of views at a time
        self.chunk_views = chunk_views

    def collect_gt(self):
        gts = [gt for gt in (parse_obs_data(self.scene_ds[i][2]) for i in range(len(self.scene_ds)))
               if len(gt)]
        return concatenate(gts)

    def evaluate(self, predictions):
        """predictions: TensorCollection with infos scene_id, view_id, label,
        score. Returns ({meter: summary}, {meter: tables}). The meters match
        within a (scene, view) only, so chunking leaves the results as they
        are."""
        gt = self.collect_gt()
        gt_key = list(zip(gt.infos["scene_id"].tolist(), gt.infos["view_id"].tolist()))
        keys = list(dict.fromkeys(gt_key))
        pred_key = list(zip(np.asarray(predictions.infos["scene_id"]).tolist(),
                            np.asarray(predictions.infos["view_id"]).tolist()))
        metrics, dfs = {}, {}
        for name, meter in self.meters.items():
            meter.reset()
            for start in range(0, len(keys), self.chunk_views):
                chunk = set(keys[start:start + self.chunk_views])
                p_ids = np.asarray([i for i, k in enumerate(pred_key) if k in chunk], np.int64)
                g_ids = np.asarray([i for i, k in enumerate(gt_key) if k in chunk], np.int64)
                if len(g_ids):
                    meter.add(predictions[p_ids], gt[g_ids])
            metrics[name], dfs[name] = meter.summary()
        return metrics, dfs


class DetectionEvaluation(PoseEvaluation):
    """The same loop; detection meters read the boxes instead of the poses."""
