"""Depth-based ICP pose refinement on a device (port of
cosypose_tpu/integrated/icp_refiner.py).

For each predicted pose, the object's depth is rendered at the full image
through ops/render (on the card: the setup and resolve kernels, at the JAX
package's accelerator tile (24, 320) and budget 768), both rendered and
observed depth are lifted to camera-frame points, and the pose is refined by
batched projective point-to-point ICP: each of a fixed number of iterations
looks the observed depth up at the moved model points' pixels, keeps pairs
closer than a threshold and solves a weighted Kabsch alignment. All
detections are refined together as tensors; the iterations are a Python loop
that reads nothing back itself (on the card torch.linalg.svd checks its
convergence flags on the host, once an iteration). A centroid pre-alignment
comes first, as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.render import render
from ..ops.symmetric import _matmul
from ..ops.transforms import make_T
from ..utils.tensor_collection import TensorCollection

ICP_TILE = (24, 320)
ICP_BUDGET = 768


def _depth_to_points(depth: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """depth (B, H, W), K (B, 3, 3) → (B, H, W, 3) camera-frame points at the
    pixel centres (z = 0 where there is no depth)."""
    B, H, W = depth.shape
    us = torch.arange(W, dtype=torch.float32, device=depth.device) + 0.5
    vs = torch.arange(H, dtype=torch.float32, device=depth.device) + 0.5
    x = (us[None, None, :] - K[:, 0, 2, None, None]) / K[:, 0, 0, None, None] * depth
    y = (vs[None, :, None] - K[:, 1, 2, None, None]) / K[:, 1, 1, None, None] * depth
    return torch.stack([x, y, depth], dim=-1)


def sample_ids(n_pixels: int, n_points: int) -> np.ndarray:
    """jnp.linspace(0, n_pixels - 1, n_points).astype(int32) as the JAX
    package's CPU run computes it: XLA turns (stop · (i / (n − 1))) into
    (stop · (1 / (n − 1))) · i in float32, the last entry the stop itself;
    truncated. torch.linspace, and the division as written, round otherwise
    and give other ids at 240x320 and 480x640."""
    step = np.float32(n_pixels - 1) * (np.float32(1) / np.float32(n_points - 1))
    out = np.concatenate([step * np.arange(n_points - 1, dtype=np.float32),
                          [np.float32(n_pixels - 1)]])
    return out.astype(np.float32).astype(np.int32)


def _kabsch(P: torch.Tensor, Q: torch.Tensor, w: torch.Tensor):
    """Weighted rigid alignment P → Q per item: (R (B,3,3), t (B,3))
    minimizing Σ w‖R p + t − q‖². P, Q (B, N, 3), w (B, N).

    An item with no weight gives R = I and t = 0: LAPACK's SVD of the zero
    matrix (U = V = I) gives that, which the JAX package computes on the
    CPU; another solver (cuSOLVER) may return another orthogonal basis for it.
    """
    wsum = w.sum(1).clamp_min(1e-6)[:, None]
    mu_p = (P * w[..., None]).sum(1) / wsum
    mu_q = (Q * w[..., None]).sum(1) / wsum
    Pc, Qc = P - mu_p[:, None], Q - mu_q[:, None]
    H = ((Pc * w[..., None])[..., :, None] * Qc[..., None, :]).sum(1)
    U, _, Vt = torch.linalg.svd(H)
    V, Ut = Vt.transpose(-2, -1), U.transpose(-2, -1)
    d = torch.sign(torch.linalg.det(_matmul(V, Ut)))
    D = torch.diag_embed(torch.stack([torch.ones_like(d), torch.ones_like(d), d], -1))
    R = _matmul(_matmul(V, D), Ut)
    none = (w.sum(1) == 0)[:, None, None]
    R = torch.where(none, torch.eye(3, dtype=R.dtype, device=R.device), R)
    t = mu_q - (R * mu_p[:, None, :]).sum(-1)
    return R, t


def _icp_refine_batch(TCO: torch.Tensor, rendered_depth: torch.Tensor,
                      observed_depth: torch.Tensor, K: torch.Tensor, n_iterations: int = 10,
                      n_points: int = 1024, dist_threshold: float = 0.02):
    """Projective ICP for a batch of detections.

    TCO (B,4,4); rendered_depth and observed_depth (B,H,W); K (B,3,3).
    Returns the refined TCO (B,4,4), kept where the last iteration had more
    than 16 inliers, and that flag (B,).
    """
    B, H, W = rendered_depth.shape
    dev = rendered_depth.device
    model_img = _depth_to_points(rendered_depth, K)
    obs_img = _depth_to_points(observed_depth, K)

    # a fixed stratified set of pixels, rolled onto the valid ones (valid first, stably)
    flat_valid = (rendered_depth > 0).reshape(B, -1)
    ids = torch.as_tensor(sample_ids(H * W, n_points), device=dev).long()
    order = torch.argsort((~flat_valid).to(torch.uint8), dim=1, stable=True)
    n_valid = flat_valid.sum(1).clamp_min(1)
    ids = torch.gather(order, 1, ids[None] % n_valid[:, None])
    model_pts = torch.gather(model_img.reshape(B, -1, 3), 1, ids[..., None].expand(-1, -1, 3))
    model_valid = torch.gather(flat_valid, 1, ids)

    # centroid pre-alignment: shift the model cloud by the difference of visible centroids
    w_obs = (observed_depth > 0).float()[..., None]
    mu_obs = (obs_img * w_obs).sum((1, 2)) / w_obs.sum((1, 2)).clamp_min(1.0)
    w_rend = (rendered_depth > 0).float()[..., None]
    mu_rend = (model_img * w_rend).sum((1, 2)) / w_rend.sum((1, 2)).clamp_min(1.0)
    R = torch.eye(3, device=dev).expand(B, 3, 3)
    t = mu_obs - mu_rend

    obs_flat = obs_img.reshape(B, H * W, 3)
    fx, fy, cx, cy = (K[:, 0, 0, None], K[:, 1, 1, None], K[:, 0, 2, None], K[:, 1, 2, None])
    n_inl = torch.zeros(B, device=dev)
    for _ in range(n_iterations):
        cur = (model_pts[..., None, :] * R[:, None]).sum(-1) + t[:, None]
        z = cur[..., 2].clamp_min(1e-6)
        u = fx * cur[..., 0] / z + cx
        v = fy * cur[..., 1] / z + cy
        # clamped before the cast, which then truncates as astype(int32) does
        ui = u.clamp(-1.0, float(W)).to(torch.int32).clamp(0, W - 1).long()
        vi = v.clamp(-1.0, float(H)).to(torch.int32).clamp(0, H - 1).long()
        target = torch.gather(obs_flat, 1, (vi * W + ui)[..., None].expand(-1, -1, 3))
        in_img = (u >= 0) & (u < W) & (v >= 0) & (v < H)
        d = torch.linalg.vector_norm(target - cur, dim=-1)
        w = (model_valid & in_img & (target[..., 2] > 0) & (d < dist_threshold)).float()
        dR, dt = _kabsch(cur, target, w)
        R, t = _matmul(dR, R), (dR * t[:, None, :]).sum(-1) + dt
        n_inl = w.sum(1)
    ok = n_inl > 16
    refined = _matmul(make_T(R, t), TCO)
    return torch.where(ok[:, None, None], refined, TCO), ok


class ICPRefiner:
    """Post-refine predicted poses against observed depth (BOP20's --icp).
    `resolution` is kept as the JAX package keeps it, unread: the depth
    renders at the observed depth's size."""

    def __init__(self, mesh_db, resolution=(240, 320)):
        self.mesh_db = mesh_db
        self.resolution = resolution

    def render_depth(self, predictions: TensorCollection, K: torch.Tensor, image_size):
        """Each detection's depth at its pose, (B, H, W), and its K (B, 3, 3)."""
        db = self.mesh_db
        im_ids = torch.as_tensor(predictions.infos["batch_im_id"], device=db.device).long()
        label_ids = db.ids_for(predictions.infos["label"])
        K_dets = torch.as_tensor(K, dtype=torch.float32, device=db.device)[im_ids]
        TCO = predictions.poses.to(db.device, torch.float32)
        depth = render(db.tri_verts[label_ids], db.tri_valid[label_ids], TCO, K_dets,
                       image_size=tuple(image_size), tile=ICP_TILE,
                       max_tris_per_tile=ICP_BUDGET).depth
        return depth, K_dets

    def refine_poses(self, predictions: TensorCollection, masks, depth, K,
                     n_iterations: int = 10) -> TensorCollection:
        """predictions: infos batch_im_id, label, ... and poses (B,4,4); masks
        (B,H,W) of the detections or None; depth (n_img,H,W); K (n_img,3,3).
        Returns the predictions with refined poses and an icp_ok column."""
        dev = self.mesh_db.device
        depth = torch.as_tensor(depth, dtype=torch.float32, device=dev)
        rendered, K_dets = self.render_depth(predictions, K, depth.shape[-2:])
        im_ids = torch.as_tensor(predictions.infos["batch_im_id"], device=dev).long()
        observed = depth[im_ids]
        if masks is not None:
            observed = torch.where(torch.as_tensor(masks, device=dev).bool(), observed, 0.0)
        TCO = predictions.poses.to(dev, torch.float32)
        refined, ok = _icp_refine_batch(TCO, rendered, observed, K_dets,
                                        n_iterations=n_iterations)
        out = TensorCollection(predictions.clone().infos, poses=refined)
        out.infos["icp_ok"] = ok.cpu().numpy()
        return out
