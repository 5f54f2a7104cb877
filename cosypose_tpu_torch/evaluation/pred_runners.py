"""Prediction runners over scene datasets (port of
cosypose_tpu/evaluation/pred_runners.py).

MultiviewPredictionRunner iterates view groups, joins saved detections to
the group's frames by (scene_id, view_id) and runs coarse + refiner on them
(or the refiner from the detections' own poses), then optionally the
multiview predictor. BopPredictionRunner runs the detector over a window of
groups' frames in fixed padded batches, then each group's pose stage on its
own detections, optionally the multiview predictor (groups of more than one
view) and ICP against the group's depth, masked by the detections' masks;
it records each image's time (the first detector batch and the first pose
group, which warm up, excluded) and each stage's wall seconds.
DetectionRunner runs the detector alone.
"""

from __future__ import annotations

import time
from collections import defaultdict

import numpy as np
import torch

from ..utils.device import synchronize
from ..utils.tensor_collection import TensorCollection, concatenate
from . import table
from .data_utils import parse_camera_data

MULTIVIEW_KEYS = ("cand_inputs", "cand_matched", "ba_input", "ba_output", "ba_output+all_cand")


def _group_images_K(group_obs):
    images = np.stack([np.transpose(rgb, (2, 0, 1)).astype(np.float32) / 255.0
                       for rgb, _, _ in group_obs])
    cam_rows = [parse_camera_data(obs, batch_im_id=n) for n, (_, _, obs) in enumerate(group_obs)]
    return images, np.stack([c["K"] for c in cam_rows]), cam_rows


def _cameras(cam_rows, K) -> TensorCollection:
    """The group's cameras: infos scene_id, view_id, group_id, batch_im_id;
    K and TWC."""
    infos = {k: np.asarray([c[k] for c in cam_rows])
             for k in ("scene_id", "view_id", "group_id", "batch_im_id")}
    return TensorCollection(infos, K=torch.as_tensor(K),
                            TWC=torch.as_tensor(np.stack([c["TWC"] for c in cam_rows])))


class MultiviewPredictionRunner:
    def __init__(self, scene_ds_multiview, n_coarse_iterations=1, n_refiner_iterations=4):
        self.ds = scene_ds_multiview
        self.n_coarse = n_coarse_iterations
        self.n_refiner = n_refiner_iterations

    def get_predictions(self, pose_predictor, mv_predictor=None, detections=None,
                        use_detections_TCO=False, **mv_kwargs):
        """pose_predictor: CoarseRefinePosePredictor; mv_predictor:
        MultiviewScenePredictor or None (its keyword arguments in
        mv_kwargs); detections: TensorCollection with infos scene_id,
        view_id, label, score and bboxes (and poses when
        use_detections_TCO). Returns {stage key: TensorCollection of every
        group's predictions}, with multiview/* keys when mv_predictor runs."""
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
                data_TCO, preds = pose_predictor.get_predictions(
                    images, K,
                    data_TCO_init=TensorCollection(infos, poses=group_dets.poses.to(dev)),
                    n_coarse_iterations=0, n_refiner_iterations=self.n_refiner)
            else:
                data_TCO, preds = pose_predictor.get_predictions(
                    images, K, detections=TensorCollection(infos, **group_dets.tensors),
                    n_coarse_iterations=self.n_coarse, n_refiner_iterations=self.n_refiner)
            for k, v in preds.items():
                predictions[k].append(v)
            if mv_predictor is not None:
                mv = mv_predictor.predict_scene_state(
                    TensorCollection(dict(data_TCO.infos), poses=data_TCO.poses),
                    _cameras(cam_rows, K.cpu().numpy()), **mv_kwargs)
                for k in MULTIVIEW_KEYS:
                    predictions[f"multiview/{k}"].append(mv[k])
                predictions["multiview/scene_objects"].append(mv["scene/objects"])
                predictions["multiview/scene_cameras"].append(mv["scene/cameras"])
        return {k: concatenate(v) for k, v in predictions.items() if v}


def _padded_batch(rgbs: list, size: int) -> np.ndarray:
    """(size, 3, H, W) uint8 of the frames, the last repeated to fill."""
    ims = np.stack([np.transpose(rgb, (2, 0, 1)) for rgb in rgbs])
    return np.concatenate([ims, np.repeat(ims[-1:], size - len(ims), axis=0)])


class BopPredictionRunner:
    """End-to-end BOP inference: detector → coarse + refiner → [multiview]
    → [ICP], per view group."""

    def __init__(self, scene_ds_multiview, n_coarse_iterations=1, n_refiner_iterations=4,
                 det_batch_size: int = 16):
        self.ds = scene_ds_multiview
        self.n_coarse = n_coarse_iterations
        self.n_refiner = n_refiner_iterations
        self.det_batch_size = det_batch_size
        # wall seconds of the last get_predictions: detection, pose, multiview, ICP
        self.seconds = {}

    def _detect_window(self, detector, rgbs, detection_th, already_warm, output_masks=False):
        """Detections of each frame in batches of det_batch_size; each frame's
        share of its batch's seconds; True for the frames of the warm-up
        batch (the first one unless already_warm)."""
        bsz = self.det_batch_size
        dets, det_time = [None] * len(rgbs), np.zeros(len(rgbs))
        first = np.zeros(len(rgbs), bool)
        for start in range(0, len(rgbs), bsz):
            chunk = rgbs[start:start + bsz]
            t0 = time.perf_counter()
            out = detector.get_detections(_padded_batch(chunk, bsz), detection_th=detection_th,
                                          output_masks=output_masks)
            dt = time.perf_counter() - t0
            for j in range(len(chunk)):
                dets[start + j] = out[np.flatnonzero(out.infos["batch_im_id"] == j)]
                det_time[start + j] = dt / len(chunk)
                first[start + j] = start == 0 and not already_warm
        return dets, det_time, first

    def get_predictions(self, detector, pose_predictor, mv_predictor=None, icp_refiner=None,
                        detection_th=0.3, window_groups: int = 16, **mv_kwargs):
        """detector: integrated.detector.Detector; pose_predictor:
        CoarseRefinePosePredictor on the same device; mv_predictor:
        MultiviewScenePredictor or None (its keyword arguments in
        mv_kwargs); icp_refiner: ICPRefiner or None (the dataset then loads
        depth). Returns {'pose': TensorCollection} with infos batch_im_id,
        label, score, time, scene_id, view_id, group_id and the final poses;
        'multiview' (ba_output+all_cand of each group of more than one view)
        and 'icp' (the pose stage's poses refined, an icp_ok column) when
        those run."""
        dev = pose_predictor.device
        predictions = defaultdict(list)
        warm_pose = warm_det = False
        self.seconds = {"detection": 0.0, "pose": 0.0}
        if mv_predictor is not None:
            self.seconds["multiview"] = 0.0
        if icp_refiner is not None:
            self.seconds["icp"] = 0.0
        for w0 in range(0, len(self.ds), window_groups):
            gids = range(w0, min(w0 + window_groups, len(self.ds)))
            groups = {g: self.ds[g] for g in gids}
            frames = [(g, rgb) for g in gids for rgb, _, _ in groups[g]]
            dets, det_time, det_first = self._detect_window(
                detector, [rgb for _, rgb in frames], detection_th, warm_det,
                output_masks=icp_refiner is not None)
            self.seconds["detection"] += float(det_time.sum())
            warm_det = True
            by_group = defaultdict(list)
            for fi, (g, _) in enumerate(frames):
                by_group[g].append(fi)

            for g in gids:
                images, K, cam_rows = _group_images_K(groups[g])
                frame_ids = by_group[g]
                group_dets = [dets[fi] for fi in frame_ids]
                for i, d in enumerate(group_dets):
                    d.infos["batch_im_id"] = np.full(len(d), i, np.int64)
                group_dets = [d for d in group_dets if len(d)]
                if not group_dets:
                    continue
                detections = concatenate(group_dets)
                t0 = time.perf_counter()
                data_TCO, _ = pose_predictor.get_predictions(
                    torch.as_tensor(images, device=dev), torch.as_tensor(K, device=dev),
                    detections=detections, n_coarse_iterations=self.n_coarse,
                    n_refiner_iterations=self.n_refiner)
                synchronize(dev)
                pose_dt = time.perf_counter() - t0
                self.seconds["pose"] += pose_dt
                if not warm_pose:
                    warm_pose, pose_dt = True, float("nan")
                times = det_time[frame_ids] + pose_dt / len(groups[g])
                times[det_first[frame_ids]] = float("nan")
                im = data_TCO.infos["batch_im_id"]
                data_TCO.infos["time"] = times[im]
                for k in ("scene_id", "view_id", "group_id"):
                    data_TCO.infos[k] = np.asarray([c[k] for c in cam_rows], np.int64)[im]
                predictions["pose"].append(data_TCO)

                if mv_predictor is not None and len(groups[g]) > 1:
                    t0 = time.perf_counter()
                    mv = mv_predictor.predict_scene_state(
                        TensorCollection(dict(data_TCO.infos), poses=data_TCO.poses),
                        _cameras(cam_rows, K), **mv_kwargs)
                    predictions["multiview"].append(mv["ba_output+all_cand"])
                    self.seconds["multiview"] += time.perf_counter() - t0
                if icp_refiner is not None:
                    t0 = time.perf_counter()
                    depths = np.stack([obs["camera"]["depth"] for _, _, obs in groups[g]])
                    predictions["icp"].append(icp_refiner.refine_poses(
                        data_TCO, detections.tensors.get("masks"), depths, K))
                    synchronize(dev)
                    self.seconds["icp"] += time.perf_counter() - t0
        return {k: concatenate(v) for k, v in predictions.items() if v}


class DetectionRunner:
    """The detector over a scene dataset in fixed padded batches."""

    def __init__(self, scene_ds, batch_size: int = 16):
        self.ds = scene_ds
        self.batch_size = batch_size

    def get_predictions(self, detector, detection_th=0.0, output_masks=False, mask_th=0.05):
        """Returns {'detections': TensorCollection} with infos batch_im_id,
        label, score, scene_id, view_id, bboxes (and masks)."""
        preds = []
        for start in range(0, len(self.ds), self.batch_size):
            items = [self.ds[i] for i in range(start, min(start + self.batch_size, len(self.ds)))]
            dets = detector.get_detections(_padded_batch([it[0] for it in items],
                                                         self.batch_size),
                                           detection_th=detection_th, output_masks=output_masks,
                                           mask_th=mask_th)
            dets = dets[np.flatnonzero(dets.infos["batch_im_id"] < len(items))]
            frames = [it[2]["frame_info"] for it in items]
            for k in ("scene_id", "view_id"):
                dets.infos[k] = np.asarray([frames[b][k] for b in dets.infos["batch_im_id"]],
                                           np.int64)
            preds.append(dets)
        return {"detections": concatenate(preds)}
