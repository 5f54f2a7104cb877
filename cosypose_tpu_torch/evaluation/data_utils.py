"""Ground truth of a scene dataset's observations for the meters (port of
cosypose_tpu/evaluation/data_utils.py): object poses in the camera frame,
boxes and visible fractions, with the frame's ids."""

from __future__ import annotations

import numpy as np
import torch

from ..utils.tensor_collection import TensorCollection


def parse_obs_data(obs: dict) -> TensorCollection:
    """obs → TensorCollection(infos {scene_id, view_id, label, visib_fract},
    poses (N,4,4) TCO, bboxes (N,4)), float32 on the CPU."""
    frame = obs["frame_info"]
    TWC = np.asarray(obs["camera"].get("TWC", np.eye(4)), np.float32)
    TCW = np.linalg.inv(TWC)
    objects = obs["objects"]
    infos = dict(scene_id=np.asarray([frame["scene_id"]] * len(objects), np.int64),
                 view_id=np.asarray([frame["view_id"]] * len(objects), np.int64),
                 label=np.asarray([o["label"] for o in objects], dtype=str),
                 visib_fract=np.asarray([o.get("visib_fract", 1.0) for o in objects],
                                        np.float64))
    poses = np.stack([TCW @ np.asarray(o["TWO"], np.float32) for o in objects]) if objects \
        else np.zeros((0, 4, 4), np.float32)
    bboxes = np.stack([np.asarray(o.get("bbox", np.zeros(4)), np.float32) for o in objects]) \
        if objects else np.zeros((0, 4), np.float32)
    return TensorCollection(infos, poses=torch.as_tensor(poses.astype(np.float32)),
                            bboxes=torch.as_tensor(bboxes))


def parse_camera_data(obs: dict, batch_im_id: int) -> dict:
    frame = obs["frame_info"]
    return dict(scene_id=frame["scene_id"], view_id=frame["view_id"],
                group_id=frame.get("group_id", 0), batch_im_id=batch_im_id,
                K=np.asarray(obs["camera"]["K"], np.float32),
                TWC=np.asarray(obs["camera"].get("TWC", np.eye(4)), np.float32))
