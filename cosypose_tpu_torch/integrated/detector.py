"""Inference API: 2D detection → TensorCollection (port of
cosypose_tpu/integrated/detector.py).

`Detector.get_detections` normalises a batch (÷255 when its maximum is above
1), runs the detector and its decoder on the model's device, keeps the
detections above the score threshold whose class has a label, optionally
upsamples each one's mask logits bilinearly to the image, thresholds them
and crops them to the box, and optionally keeps the best detection of each
label. `load_saved_detections` wraps detections computed elsewhere.

The model is the JAX package's CenterNet (models/detector.py) or the
published Mask R-CNN (models/mask_rcnn.py), whose eval forward decodes,
suppresses and pastes its masks itself (its class ids start at 1, after the
background: `mask_rcnn.maskrcnn_category_ids`); both give the same
TensorCollection.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..evaluation import table
from ..models.detector import CenterNetDetector, decode_detections
from ..models.mask_rcnn import MaskRCNN
from ..utils.tensor_collection import TensorCollection


class Detector:
    def __init__(self, model: CenterNetDetector | MaskRCNN, label_to_category_id: dict,
                 nms_iou: float | None = 0.5, nms_cross_iou: float | None = None):
        """model: on its device, its weights loaded; nms_iou: CenterNet's
        same-class greedy box NMS on the decoded top-k (None or 0 disables
        it; Mask R-CNN's NMS is its config's)."""
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self.label_to_category_id = label_to_category_id
        self.category_id_to_label = {v: k for k, v in label_to_category_id.items()}
        self.nms_iou = nms_iou
        self.nms_cross_iou = nms_cross_iou

    @torch.inference_mode()
    def get_detections(self, images, detection_th=None, output_masks=False, mask_th=0.05,
                       one_instance_per_class=False) -> TensorCollection:
        """images (B, 3, H, W) or (B, H, W, 3), float in [0, 1] or uint8 in
        [0, 255]. Returns infos batch_im_id, label, score and bboxes (N, 4)
        on the model's device, plus masks (N, H, W) bool with output_masks."""
        images = torch.as_tensor(images, device=self.device)
        if not (images.ndim == 4 and images.shape[1] == 3):
            images = images.permute(0, 3, 1, 2)
        images = images.float()
        images = torch.where(images.max() > 1.0, images / 255.0, images)
        if isinstance(self.model, MaskRCNN):
            return self._maskrcnn_detections(images, detection_th, output_masks, mask_th,
                                             one_instance_per_class)
        out = decode_detections(self.model(images), self.model.cfg.max_detections,
                                nms_iou=self.nms_iou, nms_cross_iou=self.nms_cross_iou)
        scores = out["scores"].cpu().numpy()
        cls = out["class_ids"].cpu().numpy()
        keep = (scores > 0.0) & np.isin(cls, list(self.category_id_to_label))
        if detection_th is not None:
            keep &= scores > detection_th
        b, k = np.nonzero(keep)  # image-major, then rank: the JAX package's loop order
        H, W = images.shape[-2:]
        infos = dict(batch_im_id=b.astype(np.int64),
                     label=np.asarray([self.category_id_to_label[int(c)] for c in cls[b, k]],
                                      dtype=str),
                     score=scores[b, k].astype(np.float64))
        bt, kt = torch.as_tensor(b, device=self.device), torch.as_tensor(k, device=self.device)
        tensors = dict(bboxes=out["boxes"][bt, kt])
        if output_masks:
            probs = torch.sigmoid(F.interpolate(out["mask_logits"][bt, kt][:, None], size=(H, W),
                                                mode="bilinear", align_corners=False)[:, 0])
            bx = tensors["bboxes"]
            yy = torch.arange(H, device=self.device)[None, :, None]
            xx = torch.arange(W, device=self.device)[None, None, :]
            inside = ((xx >= bx[:, None, None, 0]) & (xx <= bx[:, None, None, 2])
                      & (yy >= bx[:, None, None, 1]) & (yy <= bx[:, None, None, 3]))
            tensors["masks"] = (probs > mask_th) & inside
        return self._finish(TensorCollection(infos, **tensors), one_instance_per_class)

    def _maskrcnn_detections(self, images, detection_th, output_masks, mask_th,
                             one_instance_per_class) -> TensorCollection:
        """Mask R-CNN's detections (image by image, each by descending
        score) with a label and above detection_th; masks its pasted
        probabilities above mask_th."""
        out = self.model(images, masks=output_masks)
        scores = out["scores"].cpu().numpy()
        cls = out["labels"].cpu().numpy()
        b = out["image_ids"].cpu().numpy()
        keep = np.isin(cls, list(self.category_id_to_label))
        if detection_th is not None:
            keep &= scores > detection_th
        idx = np.flatnonzero(keep)
        infos = dict(batch_im_id=b[idx].astype(np.int64),
                     label=np.asarray([self.category_id_to_label[int(c)] for c in cls[idx]],
                                      dtype=str),
                     score=scores[idx].astype(np.float64))
        it = torch.as_tensor(idx, device=self.device)
        tensors = dict(bboxes=out["boxes"][it])
        if output_masks:
            tensors["masks"] = out["masks"][it] > mask_th
        return self._finish(TensorCollection(infos, **tensors), one_instance_per_class)

    @staticmethod
    def _finish(outputs: TensorCollection, one_instance_per_class: bool) -> TensorCollection:
        """With one_instance_per_class, each label's best detection alone."""
        if one_instance_per_class and len(outputs):
            infos = outputs.infos
            order = table.argsort_desc(infos["score"])
            first = table.drop_duplicates({"label": infos["label"][order]}, ["label"])
            outputs = outputs[np.sort(order[first])]
        return outputs

    def __call__(self, *args, **kwargs):
        return self.get_detections(*args, **kwargs)


def load_saved_detections(infos: dict, bboxes) -> TensorCollection:
    """Detections computed elsewhere: infos with at least scene_id, view_id,
    label and score, and their boxes (N, 4), on the CPU."""
    return TensorCollection(infos, bboxes=torch.as_tensor(np.asarray(bboxes, np.float32)))
