"""Pose initialisation and the image-space pose update (port of
cosypose_tpu/ops/pose_ops.py)."""

from __future__ import annotations

import torch

from .transforms import make_T, transform_pts


def apply_imagespace_predictions(TCO: torch.Tensor, K: torch.Tensor,
                                 vxvyvz: torch.Tensor, dRCO: torch.Tensor) -> torch.Tensor:
    """vx, vy: image-plane offsets over the focal length; vz: multiplicative
    depth update; dRCO premultiplies the rotation. TCO (B,4,4), K (B,3,3),
    vxvyvz (B,3), dRCO (B,3,3) → (B,4,4)."""
    zsrc = TCO[:, 2, 3]
    ztgt = vxvyvz[:, 2] * zsrc
    fxfy = torch.stack([K[:, 0, 0], K[:, 1, 1]], dim=-1)
    xsrcysrc = TCO[:, :2, 3]
    xy = (vxvyvz[:, :2] / fxfy + xsrcysrc / zsrc[:, None]) * ztgt[:, None]
    t = torch.cat([xy, ztgt[:, None]], dim=-1)
    return make_T(dRCO @ TCO[:, :3, :3], t)


def TCO_init_from_boxes(boxes: torch.Tensor, K: torch.Tensor, z_range=(1.0, 1.0)) -> torch.Tensor:
    """Paper-style coarse init: identity rotation, z = mean(z_range), xy from
    the box centre back-projected at that depth. boxes (B,4), K (B,3,3)."""
    bsz = boxes.shape[0]
    z = torch.full((bsz,), (z_range[0] + z_range[1]) / 2.0, dtype=boxes.dtype,
                   device=boxes.device)
    uv_centers = (boxes[:, :2] + boxes[:, 2:4]) / 2.0
    fxfy = torch.stack([K[:, 0, 0], K[:, 1, 1]], dim=-1)
    cxcy = torch.stack([K[:, 0, 2], K[:, 1, 2]], dim=-1)
    xy = (uv_centers - cxcy) * z[:, None] / fxfy
    R = torch.eye(3, dtype=boxes.dtype, device=boxes.device).expand(bsz, 3, 3)
    return make_T(R, torch.cat([xy, z[:, None]], dim=-1))


_R_ZUP = ((0.0, 1.0, 0.0), (0.0, 0.0, -1.0), (-1.0, 0.0, 0.0))


def TCO_init_from_boxes_zup_autodepth(boxes_2d: torch.Tensor, model_points_3d: torch.Tensor,
                                      K: torch.Tensor,
                                      points_valid: torch.Tensor | None = None) -> torch.Tensor:
    """BOP20-style coarse init: canonical z-up rotation, depth from the ratio of
    the model's projected extent at z=1 to the detected box.
    boxes_2d (B,4), model_points_3d (B,P,3), K (B,3,3) → TCO (B,4,4);
    points_valid (B,P) bool, where given, leaves padded points out of the
    extent (an item with no valid point gets nan)."""
    bsz = boxes_2d.shape[0]
    dtype, device = boxes_2d.dtype, boxes_2d.device
    z_guess = 1.0
    fxfy = torch.stack([K[:, 0, 0], K[:, 1, 1]], dim=-1)
    cxcy = torch.stack([K[:, 0, 2], K[:, 1, 2]], dim=-1)
    bb_xy_centers = (boxes_2d[:, :2] + boxes_2d[:, 2:4]) / 2.0
    xy_init = (bb_xy_centers - cxcy) * z_guess / fxfy

    R = torch.tensor(_R_ZUP, dtype=dtype, device=device).expand(bsz, 3, 3)
    t0 = torch.cat([xy_init, torch.full((bsz, 1), z_guess, dtype=dtype, device=device)], dim=-1)
    C_pts = transform_pts(make_T(R, t0), model_points_3d)
    if points_valid is None:
        deltax = C_pts[..., 0].amax(dim=1) - C_pts[..., 0].amin(dim=1)
        deltay = C_pts[..., 1].amax(dim=1) - C_pts[..., 1].amin(dim=1)
    else:
        inf = torch.tensor(float("inf"), dtype=dtype, device=device)

        def extent(c):
            e = torch.where(points_valid, c, -inf).amax(dim=1) \
                - torch.where(points_valid, c, inf).amin(dim=1)
            return torch.where(points_valid.any(dim=1), e, torch.nan)

        deltax, deltay = extent(C_pts[..., 0]), extent(C_pts[..., 1])

    bb_deltax = boxes_2d[:, 2] - boxes_2d[:, 0] + 1.0
    bb_deltay = boxes_2d[:, 3] - boxes_2d[:, 1] + 1.0
    z = (fxfy[:, 0] * deltax / bb_deltax + fxfy[:, 1] * deltay / bb_deltay) / 2.0

    xy = (bb_xy_centers - cxcy) * z[:, None] / fxfy
    return make_T(R, torch.cat([xy, z[:, None]], dim=-1))
