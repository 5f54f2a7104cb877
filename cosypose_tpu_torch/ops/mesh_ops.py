"""Mesh point-set helpers on tensors (port of cosypose_tpu/ops/mesh_ops.py)."""

from __future__ import annotations

import numpy as np
import torch


def get_meshes_bounding_boxes(pts: torch.Tensor) -> torch.Tensor:
    """The 8 AABB corners of each point set, in the reference's corner order.
    pts (B, P, 3) → (B, 8, 3)."""
    (x0, y0, z0), (x1, y1, z1) = pts.amin(dim=-2).unbind(-1), pts.amax(dim=-2).unbind(-1)
    corners = [(x0, y1, z1), (x1, y1, z1), (x1, y0, z1), (x0, y0, z1),
               (x0, y1, z0), (x1, y1, z0), (x1, y0, z0), (x0, y0, z0)]
    return torch.stack([torch.stack(c, dim=-1) for c in corners], dim=-2)


def get_meshes_center(pts: torch.Tensor) -> torch.Tensor:
    """SE(3) translation to each point set's AABB centre → (B, 4, 4)."""
    T = torch.eye(4, dtype=pts.dtype, device=pts.device).repeat(*pts.shape[:-2], 1, 1)
    T[..., :3, 3] = get_meshes_bounding_boxes(pts).mean(dim=-2)
    return T


def sample_points(points: torch.Tensor, n_points: int, deterministic: bool = False,
                  seed: int = 0) -> torch.Tensor:
    """n_points columns of points (B, P, 3) → (B, n, 3), chosen by the JAX
    package's host RandomState (seed 0 when deterministic)."""
    P = points.shape[1]
    if n_points > P:
        raise ValueError(f"cannot sample {n_points} of {P} points without replacement")
    rng = np.random.RandomState(0 if deterministic else seed)
    ids = torch.as_tensor(rng.choice(P, size=n_points, replace=False), device=points.device)
    return points[:, ids]
