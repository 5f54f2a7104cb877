"""Loaders of the detections and poses the paper's protocol evaluates from
(port of cosypose_tpu/evaluation/saved_detections.py):

  * load_posecnn_results: YCB-V PoseCNN rois and poses, each pose corrected
    by its object's offset (bop_datasets/ycbv/offsets.txt);
  * load_pix2pose_results: T-LESS Pix2Pose RetinaNet detections (the ViVo
    "all" or SiSo "top1" file), boxes from yxyx to xyxy.

Both return a TensorCollection with infos scene_id, view_id, score, label,
poses (N,4,4) and bboxes (N,4), float32 on the CPU. As in the reference,
PoseCNN's score is its rois' object-id column. The pickles are downloads;
the tests write files of their format.
"""

from __future__ import annotations

import json
import pickle

import numpy as np
import torch

from .. import config
from ..ops.transform import Transform
from ..utils.tensor_collection import TensorCollection


def _load_ycb_offsets(ds_dir) -> dict:
    offsets = {}
    for line in (ds_dir / "offsets.txt").read_text().strip().split("\n"):
        offsets[int(line[:2])] = np.array(json.loads(line[3:])) * 0.001
    return offsets


def _collection(infos: list, poses: list, bboxes: list) -> TensorCollection:
    cols = {k: np.asarray([row[k] for row in infos]) for k in infos[0]} if infos else {}
    return TensorCollection(cols, poses=torch.as_tensor(np.stack(poses), dtype=torch.float32),
                            bboxes=torch.as_tensor(np.stack(bboxes), dtype=torch.float32))


def load_posecnn_results(local_data_dir=None) -> TensorCollection:
    local = local_data_dir or config.LOCAL_DATA_DIR
    results = pickle.loads((local / "saved_detections" / "ycbv_posecnn.pkl").read_bytes())
    offsets = _load_ycb_offsets(local / "bop_datasets" / "ycbv")

    def mat_from_qt(qt):
        w, x, y, z = qt[:4].tolist()
        return Transform(np.asarray([x, y, z, w]), qt[4:])

    infos, poses, bboxes = [], [], []
    for scene_view, result in results.items():
        scene_id, view_id = map(int, scene_view.split("/"))
        for n in range(result["rois"].shape[0]):
            obj_id = int(result["rois"][:, 1].astype(np.int64)[n])
            infos.append(dict(scene_id=scene_id, view_id=view_id, score=result["rois"][n, 1],
                              label=f"obj_{obj_id:06d}"))
            bboxes.append(result["rois"][n, 2:6])
            pose = mat_from_qt(result["poses"][n])
            pose = pose * Transform(np.asarray([0.0, 0, 0, 1]), offsets[obj_id]).inverse()
            poses.append(pose.toHomogeneousMatrix())
    return _collection(infos, poses, bboxes)


def load_pix2pose_results(all_detections: bool = True, remove_incorrect_poses: bool = False,
                          local_data_dir=None) -> TensorCollection:
    local = local_data_dir or config.LOCAL_DATA_DIR
    name = ("tless_pix2pose_retinanet_vivo_all.pkl" if all_detections
            else "tless_pix2pose_retinanet_siso_top1.pkl")
    results = pickle.loads((local / "saved_detections" / name).read_bytes())
    infos, poses, bboxes = [], [], []
    for key, result in results.items():
        scene_id, view_id = map(int, key.split("/"))
        boxes = np.asarray(result["rois"])[:, [1, 0, 3, 2]]  # yxyx → xyxy
        for o, label in enumerate(result["labels_txt"]):
            t = np.asarray(result["poses"][o])[:3, -1]
            if remove_incorrect_poses and (np.sum(t) == 0 or np.max(t) > 100):
                continue
            infos.append(dict(scene_id=scene_id, view_id=view_id,
                              score=float(result["scores"][o]), label=label))
            bboxes.append(boxes[o])
            poses.append(np.asarray(result["poses"][o]))
    return _collection(infos, poses, bboxes)
