"""Symmetry-aware pose distances (port of cosypose_tpu/ops/symmetric.py).

Every object carries a fixed-shape (S, 4, 4) identity-padded symmetry set, so
the minimum over symmetries is a masked reduction over a tensor axis. All in
float32. The products of rotations and of rotations with points are written
as elementwise products summed over three terms (`_matmul`, `transform_pts`),
not as matmuls, so they stay at full float32 precision whatever the TF32
settings are: the JAX package pins Precision.HIGHEST on the same products.
"""

from __future__ import annotations

import torch


def _matmul(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A (..., i, j) @ B (..., j, k) as a sum of products, never a TF32 GEMM."""
    return (A[..., :, :, None] * B[..., None, :, :]).sum(-2)


def transform_pts(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """T (B,4,4) on pts (B,P,3) → (B,P,3); T (B,S,4,4) → (B,S,P,3), at full
    float32 precision."""
    if T.ndim == pts.ndim + 1:
        pts = pts[:, None]
    R, t = T[..., None, :3, :3], T[..., None, :3, 3]
    return (R * pts[..., None, :]).sum(-1) + t


def _project(points: torch.Tensor, K: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """uv (B,P,2) of points (B,P,3) under T (B,4,4) and K (B,3,3)."""
    suv = (K[:, None] * transform_pts(T, points)[..., None, :]).sum(-1)
    return suv[..., :2] / suv[..., 2:3]


def mesh_points_dist(T1: torch.Tensor, T2: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Mean Euclidean displacement of posed point sets → (B,)."""
    d = transform_pts(T1, points) - transform_pts(T2, points)
    return torch.linalg.norm(d, dim=-1).mean(dim=-1)


def reprojected_dist(T1: torch.Tensor, T2: torch.Tensor, K: torch.Tensor,
                     points: torch.Tensor) -> torch.Tensor:
    """Mean 2D reprojection displacement → (B,)."""
    d = _project(points, K, T1) - _project(points, K, T2)
    return torch.linalg.norm(d, dim=-1).mean(dim=-1)


def symmetric_distance_batched_fast(T1: torch.Tensor, T2: torch.Tensor, points: torch.Tensor,
                                    symmetries: torch.Tensor,
                                    sym_valid: torch.Tensor | None = None):
    """Symmetry-minimal mean point distance.

    T1, T2 (B,4,4); points (B,P,3); symmetries (B,S,4,4) identity-padded;
    sym_valid (B,S) optional. The best symmetry is chosen by mean squared
    distance and the value returned is the mean distance under it. Returns
    (min_dists (B,), the minimizing symmetry (B,4,4)).
    """
    T1_sym = _matmul(T1[:, None], symmetries)                 # (B,S,4,4)
    T1_pts = transform_pts(T1_sym, points)                    # (B,S,P,3)
    T2_pts = transform_pts(T2, points)[:, None]               # (B,1,P,3)
    d2 = ((T1_pts - T2_pts) ** 2).sum(-1)                     # (B,S,P)
    mean_d2 = d2.mean(-1)
    if sym_valid is not None:
        mean_d2 = torch.where(sym_valid, mean_d2, torch.inf)
    best = torch.argmin(mean_d2, dim=1)
    b = torch.arange(T1.shape[0], device=T1.device)
    return torch.sqrt(d2[b, best]).mean(dim=-1), symmetries[b, best]


def symmetric_distance_reprojected(T1: torch.Tensor, T2: torch.Tensor, K: torch.Tensor,
                                   points: torch.Tensor, symmetries: torch.Tensor,
                                   sym_valid: torch.Tensor | None = None):
    """Symmetry-minimal mean 2D reprojection distance. Returns (min_dists
    (B,), the minimizing symmetry (B,4,4))."""
    T1_sym = _matmul(T1[:, None], symmetries)                 # (B,S,4,4)
    B, S = symmetries.shape[:2]
    rep = lambda x: x[:, None].expand(B, S, *x.shape[1:]).reshape(B * S, *x.shape[1:])  # noqa: E731
    dists = reprojected_dist(T1_sym.reshape(B * S, 4, 4), rep(T2), rep(K),
                             rep(points)).reshape(B, S)
    if sym_valid is not None:
        dists = torch.where(sym_valid, dists, torch.inf)
    best = torch.argmin(dists, dim=1)
    b = torch.arange(B, device=T1.device)
    return dists[b, best], symmetries[b, best]


def chamfer_dist(T1: torch.Tensor, T2: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """One-directional chamfer distance between posed point sets → (B,): for
    each point of T2's set, the distance to its nearest point of T1's."""
    p1 = transform_pts(T1, points)
    p2 = transform_pts(T2, points)
    d2 = ((p1[:, :, None] - p2[:, None, :]) ** 2).sum(-1)     # (B,P1,P2)
    return torch.sqrt(d2.amin(dim=1)).mean(dim=-1)
