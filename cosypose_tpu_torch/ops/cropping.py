"""DeepIM crop boxes and crop extraction (port of cosypose_tpu/ops/cropping.py)."""

from __future__ import annotations

import torch

from .camera import boxes_from_uv, project_points_robust
from .roi_align import roi_align


def deepim_boxes(rend_center_uv: torch.Tensor, obs_boxes: torch.Tensor,
                 rend_boxes: torch.Tensor, im_size: tuple[int, int],
                 lamb: float = 1.4) -> torch.Tensor:
    """Aspect-preserving boxes centred on the projected object centre, covering
    the observed and rendered boxes with margin `lamb`.
    rend_center_uv (B,1,2); obs_boxes, rend_boxes (B,4) → (B,4)."""
    h, w = min(im_size), max(im_size)
    r = w / h
    xc = rend_center_uv[:, 0, 0]
    yc = rend_center_uv[:, 0, 1]
    xdist = torch.maximum(
        torch.maximum((obs_boxes[:, 0] - xc).abs(), (rend_boxes[:, 0] - xc).abs()),
        torch.maximum((obs_boxes[:, 2] - xc).abs(), (rend_boxes[:, 2] - xc).abs()),
    )
    ydist = torch.maximum(
        torch.maximum((obs_boxes[:, 1] - yc).abs(), (rend_boxes[:, 1] - yc).abs()),
        torch.maximum((obs_boxes[:, 3] - yc).abs(), (rend_boxes[:, 3] - yc).abs()),
    )
    width = torch.maximum(xdist, ydist * r) * 2 * lamb
    height = torch.maximum(xdist / r, ydist) * 2 * lamb
    return torch.stack(
        [xc - width / 2, yc - height / 2, xc + width / 2, yc + height / 2], dim=-1
    )


def deepim_crops(images: torch.Tensor, obs_boxes: torch.Tensor, K: torch.Tensor,
                 TCO_pred: torch.Tensor, O_vertices: torch.Tensor,
                 output_size: tuple[int, int], lamb: float = 1.4,
                 sampling_ratio: int = 4):
    """images (B,C,H,W), obs_boxes (B,4), K (B,3,3), TCO_pred (B,4,4),
    O_vertices (B,P,3) → (boxes (B,4), crops (B,C,out_h,out_w))."""
    B, _, h, w = images.shape
    rend_boxes = boxes_from_uv(project_points_robust(O_vertices, K, TCO_pred))
    origin = torch.zeros((B, 1, 3), dtype=images.dtype, device=images.device)
    centers = project_points_robust(origin, K, TCO_pred)
    boxes = deepim_boxes(centers, obs_boxes, rend_boxes, im_size=(h, w), lamb=lamb)
    return boxes, roi_align(images, boxes, output_size, sampling_ratio)
