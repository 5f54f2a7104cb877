"""Batched SE(3) / rotation math on tensors (port of cosypose_tpu/ops/transforms.py).

Pose math stays float32: rotations degrade quickly in bf16.
"""

from __future__ import annotations

import torch


def transform_pts(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """T (B,4,4) applied to point sets pts (B,P,3) → (B,P,3); T (B,S,4,4)
    (a set of S poses per item) → (B,S,P,3)."""
    if T.ndim == pts.ndim:
        return torch.einsum("bij,bpj->bpi", T[:, :3, :3], pts) + T[:, None, :3, 3]
    if T.ndim == pts.ndim + 1:
        return torch.einsum("bsij,bpj->bspi", T[..., :3, :3], pts) + T[..., None, :3, 3]
    raise ValueError(f"unsupported shapes T={tuple(T.shape)} pts={tuple(pts.shape)}")


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


def matrix_to_rot6d(R: torch.Tensor) -> torch.Tensor:
    """Inverse of rot6d_to_matrix: the first two columns, flattened. (...,3,3) → (...,6)."""
    return torch.cat([R[..., :, 0], R[..., :, 1]], dim=-1)


def euler_to_matrix(euler_xyz: torch.Tensor) -> torch.Tensor:
    """Static-frame sxyz euler angles (radians) → R = Rz @ Ry @ Rx. (...,3) → (...,3,3)."""
    ax, ay, az = euler_xyz.unbind(-1)
    cx, sx = torch.cos(ax), torch.sin(ax)
    cy, sy = torch.cos(ay), torch.sin(ay)
    cz, sz = torch.cos(az), torch.sin(az)
    m = torch.stack(
        [
            cy * cz, sx * sy * cz - cx * sz, cx * sy * cz + sx * sz,
            cy * sz, sx * sy * sz + cx * cz, cx * sy * sz - sx * cz,
            -sy, sx * cy, cx * cy,
        ],
        dim=-1,
    )
    return m.reshape(euler_xyz.shape[:-1] + (3, 3))


def pose9d_to_T(pose9d: torch.Tensor) -> torch.Tensor:
    """9D (rot6d + translation) → (...,4,4)."""
    return make_T(rot6d_to_matrix(pose9d[..., :6]), pose9d[..., 6:9])


def T_to_pose9d(T: torch.Tensor) -> torch.Tensor:
    """(...,4,4) → 9D (rot6d + translation)."""
    return torch.cat([matrix_to_rot6d(T[..., :3, :3]), T[..., :3, 3]], dim=-1)


def pose_noise_draws(batch_size: int, generator: torch.Generator) -> tuple:
    """Standard-normal draws of add_pose_noise, (euler (B,3), trans (B,3)), on
    the CPU from `generator`, so every device sees the same numbers."""
    return (torch.randn(batch_size, 3, generator=generator),
            torch.randn(batch_size, 3, generator=generator))


def apply_pose_noise(TCO: torch.Tensor, euler_normal: torch.Tensor, trans_normal: torch.Tensor,
                     euler_deg_std=(15.0, 15.0, 15.0),
                     trans_std=(0.01, 0.01, 0.05)) -> torch.Tensor:
    """The deterministic part of add_pose_noise: R ← R @ R_noise (object-frame
    rotation noise), t ← t + n, from standard-normal draws (B,3) each.
    TCO (B,4,4) → (B,4,4)."""
    dtype, device = TCO.dtype, TCO.device
    euler_std = torch.tensor(euler_deg_std, dtype=dtype, device=device) * (torch.pi / 180.0)
    euler = euler_normal.to(device, dtype) * euler_std
    trans = trans_normal.to(device, dtype) * torch.tensor(trans_std, dtype=dtype, device=device)
    R = TCO[..., :3, :3] @ euler_to_matrix(euler)
    return make_T(R, TCO[..., :3, 3] + trans)


def add_pose_noise(TCO: torch.Tensor, generator: torch.Generator,
                   euler_deg_std=(15.0, 15.0, 15.0), trans_std=(0.01, 0.01, 0.05)) -> torch.Tensor:
    """Perturb poses with gaussian euler-angle and translation noise (the
    refiner's training input generator); draws from `generator`."""
    return apply_pose_noise(TCO, *pose_noise_draws(TCO.shape[0], generator),
                            euler_deg_std=euler_deg_std, trans_std=trans_std)


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
