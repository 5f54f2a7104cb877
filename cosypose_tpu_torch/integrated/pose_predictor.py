"""Inference API: coarse + refiner orchestration (port of
cosypose_tpu/integrated/pose_predictor.py).

Builds the TCO init from detection boxes, runs the detections through the
coarse model and chains into the refiner, in chunks padded to a fixed object
batch size (the last row repeated), and returns per-iteration predictions
keyed 'coarse/iteration=n' / 'refiner/iteration=n' plus the final poses.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models.pose_predictor import PosePredictor, gather_mesh_data
from ..ops.mesh_db import BatchedMeshes
from ..ops.pose_ops import TCO_init_from_boxes, TCO_init_from_boxes_zup_autodepth
from ..utils.device import resolve_device
from ..utils.profiling import annotate, count
from ..utils.tensor_collection import TensorCollection, concatenate


@dataclasses.dataclass
class LoadedPoseModel:
    """A pose model ready for inference: predictor (network + weights) and
    mesh database, on one device."""

    predictor: PosePredictor
    mesh_db: BatchedMeshes
    init_method: str = "v0"  # 'v0' (paper) | 'z-up+auto-depth' (BOP20)
    device: str | torch.device = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.predictor.device != self.device:
            raise ValueError(f"predictor is on {self.predictor.device}, model wants {self.device}")
        self.mesh_db = self.mesh_db.to(self.device)


class CoarseRefinePosePredictor:
    def __init__(self, coarse_model: LoadedPoseModel | None = None,
                 refiner_model: LoadedPoseModel | None = None, bsz_objects: int = 64,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        for m in (coarse_model, refiner_model):
            if m is not None and m.device != self.device:
                raise ValueError(f"a model is on {m.device}, the predictor on {self.device}")
        self.coarse_model = coarse_model
        self.refiner_model = refiner_model
        self.bsz_objects = bsz_objects

    def _as_tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def batched_model_predictions(self, model: LoadedPoseModel, images, K,
                                  obj_data: TensorCollection, n_iterations: int = 1) -> dict:
        images, K = self._as_tensor(images), self._as_tensor(K)
        n_obj = len(obj_data)
        bsz = self.bsz_objects
        preds = {f"iteration={n}": [] for n in range(1, n_iterations + 1)}
        which = "coarse" if model is self.coarse_model else "refiner"
        for start in range(0, n_obj, bsz):
            with annotate("cosypose.serve.chunk", model=which):
                with annotate("cosypose.serve.gather"):
                    ids = np.arange(start, min(start + bsz, n_obj))
                    n_valid = len(ids)
                    ids_padded = np.concatenate([ids, np.full(bsz - n_valid, ids[-1], ids.dtype)])
                    obj_inputs = obj_data[ids_padded]
                    label_ids = model.mesh_db.ids_for(obj_inputs.infos["label"])
                    im_ids = torch.as_tensor(obj_inputs.infos["batch_im_id"], device=self.device)
                    mesh_data = gather_mesh_data(model.mesh_db, label_ids,
                                                 model.predictor.cfg.n_points_crop)
                count("rows", bsz * n_iterations)
                count("useful_rows", n_valid * n_iterations)
                outputs = model.predictor.forward(mesh_data, images[im_ids], K[im_ids],
                                                  obj_inputs.poses, n_iterations)
                with annotate("cosypose.serve.collect"):
                    valid_infos = {k: v[:n_valid] for k, v in obj_inputs.infos.items()}
                    for n in range(1, n_iterations + 1):
                        it = n - 1
                        preds[f"iteration={n}"].append(TensorCollection(
                            valid_infos,
                            poses=outputs["TCO_output"][it][:n_valid],
                            poses_input=outputs["TCO_input"][it][:n_valid],
                            K_crop=outputs["K_crop"][it][:n_valid],
                            boxes_rend=outputs["boxes_rend"][it][:n_valid],
                            boxes_crop=outputs["boxes_crop"][it][:n_valid],
                        ))
        return {k: concatenate(v) for k, v in preds.items()}

    def make_TCO_init(self, detections: TensorCollection, K) -> TensorCollection:
        """Box-seeded init; without a coarse model, the refiner's mesh_db and
        init method are used."""
        with annotate("cosypose.serve.init"):
            model = self.coarse_model or self.refiner_model
            im_ids = torch.as_tensor(detections.infos["batch_im_id"], device=self.device)
            K_dets = self._as_tensor(K)[im_ids]
            boxes = self._as_tensor(detections.bboxes)
            if model.init_method == "z-up+auto-depth":
                label_ids = model.mesh_db.ids_for(detections.infos["label"])
                points = model.mesh_db.sample_points(label_ids, 2000)
                TCO_init = TCO_init_from_boxes_zup_autodepth(boxes, points, K_dets)
            else:
                TCO_init = TCO_init_from_boxes(boxes, K_dets, z_range=(1.0, 1.0))
            return TensorCollection(detections.infos, poses=TCO_init)

    def get_predictions(self, images, K, detections: TensorCollection | None = None,
                        data_TCO_init: TensorCollection | None = None,
                        n_coarse_iterations: int = 1, n_refiner_iterations: int = 1):
        """images (B_img,3,H,W), K (B_img,3,3); detections with infos
        'batch_im_id' and 'label' and tensor 'bboxes' (N,4), or data_TCO_init
        with tensor 'poses'. Returns (final predictions, dict of all stages)."""
        dets = detections if data_TCO_init is None else data_TCO_init
        n_dets = 0 if dets is None else len(dets)
        with annotate("cosypose.serve.request", detections=n_dets,
                      chunks=-(-n_dets // self.bsz_objects)):
            preds = {}
            if data_TCO_init is None:
                if detections is None:
                    raise ValueError("give detections or data_TCO_init")
                data_TCO_init = self.make_TCO_init(detections, K)
                if n_coarse_iterations > 0:
                    if self.coarse_model is None:
                        raise ValueError("coarse iterations asked for without a coarse model")
                    coarse_preds = self.batched_model_predictions(
                        self.coarse_model, images, K, data_TCO_init,
                        n_iterations=n_coarse_iterations)
                    for n in range(1, n_coarse_iterations + 1):
                        preds[f"coarse/iteration={n}"] = coarse_preds[f"iteration={n}"]
                    data_TCO = coarse_preds[f"iteration={n_coarse_iterations}"]
                else:
                    data_TCO = data_TCO_init
                    preds["coarse/box_init"] = data_TCO_init
            else:
                if n_coarse_iterations != 0:
                    raise ValueError("an external init takes no coarse iterations")
                data_TCO = data_TCO_init
                preds["external_coarse"] = data_TCO

            if n_refiner_iterations >= 1:
                if self.refiner_model is None:
                    raise ValueError("refiner iterations asked for without a refiner model")
                refiner_preds = self.batched_model_predictions(
                    self.refiner_model, images, K, data_TCO, n_iterations=n_refiner_iterations)
                for n in range(1, n_refiner_iterations + 1):
                    preds[f"refiner/iteration={n}"] = refiner_preds[f"iteration={n}"]
                data_TCO = refiner_preds[f"iteration={n_refiner_iterations}"]
            return data_TCO, preds
