"""nms3d, the part of cosypose_tpu/visualization/multiview.py that
run_custom_scenario needs (the scene renderings stay with ROADMAP queue 1
item 19): greedy score-ordered suppression of predictions whose translations
lie within a threshold, on the host."""

from __future__ import annotations

import numpy as np

from ..utils.tensor_collection import TensorCollection


def nms3d(preds: TensorCollection, th: float = 0.04, poses_attr: str = "poses"):
    """Keep the highest-scored prediction of each cluster of translations
    within `th` meters, in the JAX package's order (np.argsort of −score)."""
    TCO = getattr(preds, poses_attr).detach().cpu().numpy()
    all_t = TCO[:, :3, 3]
    tested, keep = set(), []
    for idx in np.argsort(-np.asarray(preds.infos["score"])):
        if idx in tested:
            continue
        dists = np.linalg.norm(TCO[idx, :3, 3] - all_t, axis=-1)
        dists[idx] = np.inf
        tested.update(int(j) for j in np.flatnonzero(dists <= th))
        keep.append(int(idx))
    return preds[np.asarray(keep, np.int64)]
