"""Batched SE(3) / rotation math on tensors (port of cosypose_tpu/ops/transforms.py).

Pose math stays float32: rotations degrade quickly in bf16.
"""

from __future__ import annotations

import torch


def transform_pts(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """T (B,4,4) applied to point sets pts (B,P,3) → (B,P,3)."""
    return torch.einsum("bij,bpj->bpi", T[:, :3, :3], pts) + T[:, None, :3, 3]


def _bottom_row(like: torch.Tensor, lead: torch.Size) -> torch.Tensor:
    row = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=like.dtype, device=like.device)
    return row.expand(*lead, 1, 4)


def invert_T(T: torch.Tensor) -> torch.Tensor:
    """Closed-form SE(3) inverse."""
    R_inv = T[..., :3, :3].transpose(-2, -1)
    t_inv = -(R_inv @ T[..., :3, 3:4])
    top = torch.cat([R_inv, t_inv], dim=-1)
    return torch.cat([top, _bottom_row(T, T.shape[:-2])], dim=-2)


def make_T(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Assemble (...,4,4) from R (...,3,3) and t (...,3)."""
    top = torch.cat([R, t[..., :, None]], dim=-1)
    return torch.cat([top, _bottom_row(R, R.shape[:-2])], dim=-2)


def rot6d_to_matrix(rot6d: torch.Tensor) -> torch.Tensor:
    """Continuous 6D → rotation matrix by Gram–Schmidt; the two 3-vectors
    become the first two COLUMNS. Input (..., 6) → (..., 3, 3)."""
    x_raw = rot6d[..., 0:3]
    y_raw = rot6d[..., 3:6]
    # guard only against exact 0/0: raw head outputs can be ~1e-9 at init
    eps = 1e-20
    x = x_raw / torch.linalg.norm(x_raw, dim=-1, keepdim=True).clamp_min(eps)
    z = torch.cross(x, y_raw, dim=-1)
    z = z / torch.linalg.norm(z, dim=-1, keepdim=True).clamp_min(eps)
    y = torch.cross(z, x, dim=-1)
    return torch.stack([x, y, z], dim=-1)


def quat_to_matrix(quat_xyzw: torch.Tensor) -> torch.Tensor:
    """Normalized quaternion (xyzw) → rotation matrix. Input (..., 4)."""
    q = quat_xyzw / torch.linalg.norm(quat_xyzw, dim=-1, keepdim=True).clamp_min(1e-12)
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))
