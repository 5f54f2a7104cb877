"""Pose training losses (port of cosypose_tpu/ops/losses.py).

Symmetry-aware through a padded (B, S, 4, 4) set of symmetry-equivalent
ground-truth poses (identity padding is valid by construction, so the
validity mask is optional). All float32; the JAX package pins its matmuls to
full precision, and the port keeps TF32 off for them (PyTorch's default for
matmuls).
"""

from __future__ import annotations

import torch

from .transforms import make_T, quat_to_matrix, rot6d_to_matrix, transform_pts


def _split_outputs(refiner_outputs: torch.Tensor, pose_dim: int):
    """Head outputs → (dR (B,3,3), vxvyvz (B,3))."""
    if pose_dim == 9:
        return rot6d_to_matrix(refiner_outputs[:, 0:6]), refiner_outputs[:, 6:9]
    if pose_dim == 7:
        return quat_to_matrix(refiner_outputs[:, 0:4]), refiner_outputs[:, 4:7]
    raise ValueError(f"pose_dim={pose_dim} not supported")


def loss_CO_symmetric(TCO_possible_gt: torch.Tensor, TCO_pred: torch.Tensor,
                      points: torch.Tensor, points_valid: torch.Tensor | None = None
                      ) -> torch.Tensor:
    """Min over symmetry-equivalent GTs of the mean |Δxyz| point displacement.
    TCO_possible_gt (B,S,4,4), TCO_pred (B,4,4), points (B,P,3) → (B,)."""
    gt_pts = transform_pts(TCO_possible_gt, points)            # (B,S,P,3)
    pred_pts = transform_pts(TCO_pred, points)[:, None]        # (B,1,P,3)
    diff = (pred_pts - gt_pts).abs()
    if points_valid is not None:
        w = points_valid[:, None, :, None].to(diff.dtype)
        losses = (diff * w).sum(dim=(-1, -2)) / w.sum(dim=(-1, -2)).clamp_min(1.0)
    else:
        losses = diff.mean(dim=(-1, -2))                       # (B,S)
    return losses.amin(dim=1)


def _xy_head_pose(TCO_gt, TCO_input, vxvy, K_crop):
    z_gt = TCO_gt[:, 2, 3]
    z_input = TCO_input[:, 2, 3]
    fxfy = torch.stack([K_crop[:, 0, 0], K_crop[:, 1, 1]], dim=-1)
    xy = (vxvy / fxfy + TCO_input[:, :2, 3] / z_input[:, None]) * z_gt[:, None]
    return make_T(TCO_gt[:, :3, :3], torch.cat([xy, z_gt[:, None]], dim=-1))


def loss_refiner_CO_disentangled(TCO_possible_gt: torch.Tensor, TCO_input: torch.Tensor,
                                 refiner_outputs: torch.Tensor, K_crop: torch.Tensor,
                                 points: torch.Tensor, points_valid: torch.Tensor | None = None,
                                 pose_dim: int = 9, return_components: bool = False,
                                 z_weight: float = 1.0):
    """Disentangled loss: the rotation, xy and z hypotheses each swapped into
    the GT pose and scored with the symmetric point loss, then summed (z
    weighted by z_weight). refiner_outputs (B,9) rot6d + v or (B,7) quat + v;
    TCO_possible_gt (B,S,4,4) with the canonical GT at index 0. → (B,), and
    the three components when return_components."""
    dR, vxvyvz = _split_outputs(refiner_outputs, pose_dim)
    TCO_gt = TCO_possible_gt[:, 0]
    TCO_pred_orn = make_T(dR @ TCO_input[:, :3, :3], TCO_gt[:, :3, 3])
    TCO_pred_xy = _xy_head_pose(TCO_gt, TCO_input, vxvyvz[:, :2], K_crop)
    z_pred = vxvyvz[:, 2] * TCO_input[:, 2, 3]
    t_z = torch.cat([TCO_gt[:, :2, 3], z_pred[:, None]], dim=-1)
    TCO_pred_z = make_T(TCO_gt[:, :3, :3], t_z)

    loss_orn = loss_CO_symmetric(TCO_possible_gt, TCO_pred_orn, points, points_valid)
    loss_xy = loss_CO_symmetric(TCO_possible_gt, TCO_pred_xy, points, points_valid)
    loss_z = loss_CO_symmetric(TCO_possible_gt, TCO_pred_z, points, points_valid)
    loss = loss_orn + loss_xy + z_weight * loss_z
    if return_components:
        return loss, dict(loss_orn=loss_orn, loss_xy=loss_xy, loss_z=loss_z)
    return loss


def loss_refiner_aux_regression(TCO_gt: torch.Tensor, TCO_input: torch.Tensor,
                                refiner_outputs: torch.Tensor, K_crop: torch.Tensor,
                                pose_dim: int = 9, rot_lever_m: float = 0.05) -> torch.Tensor:
    """L2 regression to the closed-form optimal head outputs, in meters → (B,):
    vxvy* = f_crop·(xy_gt/z_gt − xy_in/z_in), vz* = z_gt/z_in,
    dR* = R_gt·R_inᵀ (its residual scaled by a lever arm)."""
    dR, vxvyvz = _split_outputs(refiner_outputs, pose_dim)
    R_in = TCO_input[:, :3, :3]
    R_gt = TCO_gt[:, :3, :3]
    dR_star = R_gt @ R_in.transpose(-1, -2)
    z_in = TCO_input[:, 2, 3]
    z_gt = TCO_gt[:, 2, 3]
    fxfy = torch.stack([K_crop[:, 0, 0], K_crop[:, 1, 1]], dim=-1)
    vxvy_star = fxfy * (TCO_gt[:, :2, 3] / z_gt[:, None] - TCO_input[:, :2, 3] / z_in[:, None])
    vz_star = z_gt / z_in
    d_xy = (vxvyvz[:, :2] - vxvy_star) / fxfy * z_gt[:, None]
    d_z = (vxvyvz[:, 2] - vz_star) * z_in
    d_R = dR - dR_star
    return (d_xy ** 2).sum(-1) + d_z ** 2 + rot_lever_m ** 2 * (d_R ** 2).sum((-1, -2))


def compute_ADD_L1_loss(TCO_gt: torch.Tensor, TCO_pred: torch.Tensor,
                        points: torch.Tensor) -> torch.Tensor:
    """Plain ADD-L1: mean |Δxyz| between GT- and pred-posed points → (B,)."""
    diff = transform_pts(TCO_gt, points) - transform_pts(TCO_pred, points)
    return diff.abs().mean(dim=(-1, -2))


def compute_ADDS_loss(TCO_gt: torch.Tensor, TCO_pred: torch.Tensor,
                      points: torch.Tensor) -> torch.Tensor:
    """ADD-S (symmetric nearest-point) squared loss → (B,): for each GT point
    the squared distance to the nearest predicted point, averaged over points
    and the 3 coordinates."""
    gt_pts = transform_pts(TCO_gt, points)
    pred_pts = transform_pts(TCO_pred, points)
    d2 = ((gt_pts[:, :, None] - pred_pts[:, None, :]) ** 2).sum(-1)  # (B,Pgt,Ppred)
    return d2.amin(dim=2).mean(dim=-1) / 3.0
