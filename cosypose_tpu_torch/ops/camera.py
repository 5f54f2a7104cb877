"""Batched pinhole camera geometry (port of cosypose_tpu/ops/camera.py)."""

from __future__ import annotations

import torch


def _project_suv(points_3d, K, TCO):
    pts_cam = torch.einsum("bij,bpj->bpi", TCO[:, :3, :3], points_3d) + TCO[:, None, :3, 3]
    return torch.einsum("bij,bpj->bpi", K, pts_cam)


def project_points(points_3d: torch.Tensor, K: torch.Tensor, TCO: torch.Tensor) -> torch.Tensor:
    """points_3d (B,P,3), K (B,3,3), TCO (B,4,4) → uv (B,P,2)."""
    suv = _project_suv(points_3d, K, TCO)
    return suv[..., :2] / suv[..., 2:3]


def project_points_robust(points_3d: torch.Tensor, K: torch.Tensor, TCO: torch.Tensor,
                          z_min: float = 0.1) -> torch.Tensor:
    """Projection with depth clamped to z_min, so the crop and update math stay
    finite when an intermediate pose puts the object behind the camera."""
    suv = _project_suv(points_3d, K, TCO)
    return suv[..., :2] / suv[..., 2:3].clamp_min(z_min)


def boxes_from_uv(uv: torch.Tensor) -> torch.Tensor:
    """uv (B,P,2) → axis-aligned boxes (B,4) as (x1,y1,x2,y2)."""
    return torch.cat([uv.amin(dim=1), uv.amax(dim=1)], dim=-1)


def masked_boxes_from_uv(uv: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """boxes_from_uv over the rows where valid (B,P) is True; a box with no
    valid row is (inf, inf, -inf, -inf)."""
    keep = valid[..., None]
    inf = torch.tensor(float("inf"), dtype=uv.dtype, device=uv.device)
    mins = torch.where(keep, uv, inf).amin(dim=1)
    maxs = torch.where(keep, uv, -inf).amax(dim=1)
    return torch.cat([mins, maxs], dim=-1)


def get_K_crop_resize(K: torch.Tensor, boxes: torch.Tensor, orig_size,
                      crop_resize) -> torch.Tensor:
    """Intrinsics after cropping to `boxes` and resizing to `crop_resize`.

    The final width is max(crop_resize) and the final height min(crop_resize),
    the reference's convention. `orig_size` is unused, as in the JAX package.
    """
    final_width = float(max(crop_resize))
    final_height = float(min(crop_resize))
    crop_width = boxes[:, 2] - boxes[:, 0]
    crop_height = boxes[:, 3] - boxes[:, 1]
    crop_cj = (boxes[:, 0] + boxes[:, 2]) / 2.0
    crop_ci = (boxes[:, 1] + boxes[:, 3]) / 2.0

    cx = K[:, 0, 2] + (crop_width - 1) / 2.0 - crop_cj
    cy = K[:, 1, 2] + (crop_height - 1) / 2.0 - crop_ci

    orig_cx_diff = cx - (crop_width - 1) / 2.0
    orig_cy_diff = cy - (crop_height - 1) / 2.0
    scale_x = final_width / crop_width
    scale_y = final_height / crop_height

    new_K = K.clone()
    new_K[:, 0, 0] = scale_x * K[:, 0, 0]
    new_K[:, 1, 1] = scale_y * K[:, 1, 1]
    new_K[:, 0, 2] = (final_width - 1) / 2.0 + scale_x * orig_cx_diff
    new_K[:, 1, 2] = (final_height - 1) / 2.0 + scale_y * orig_cy_diff
    return new_K
