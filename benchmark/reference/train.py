"""The plain reference of CosyPose's refiner training step (Labbé et al. 2020):
noisy input poses from the ground truth, n render-and-compare iterations with
the network in train mode (the pose detached between iterations, no gradient
through crop or render), the disentangled symmetric point loss of each
iteration averaged, backward, the gradient clipped by its global norm, and
an Adam update. Written with autograd over the plain network, imports
nothing of the program under test.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import geometry as g
from .efficientnet import Net
from .raster import render


def symmetries(continuous: bool, n: int, device) -> torch.Tensor:
    """(S,4,4): the identity, or n rotations about z (2 pi k / n) for an
    object with a continuous symmetry about its z axis."""
    if not continuous:
        return torch.eye(4, device=device)[None]
    a = torch.arange(n, dtype=torch.float64) * (2 * math.pi / n)
    R = g.euler_to_matrix(torch.stack([torch.zeros_like(a), torch.zeros_like(a), a], -1))
    return g.make_T(R, torch.zeros(n, 3, dtype=torch.float64)).float().to(device)


def symmetric_loss(T_sym_gt, T_pred, points):
    """Min over the symmetric ground truths of the mean |xyz| gap of the
    points. T_sym_gt (B,S,4,4), T_pred (B,4,4), points (B,P,3) → (B,)."""
    gt = g.transform(T_sym_gt, points)                  # (B,S,P,3)
    pred = g.transform(T_pred, points)[:, None]
    return (pred - gt).abs().mean(dim=(-1, -2)).amin(1)


def disentangled_loss(T_sym_gt, T_in, out, Kc, points):
    """Rotation, xy and depth of the head's update each put into the ground
    truth pose and scored by the symmetric loss, summed (B,)."""
    dR, v = g.rot6d_to_matrix(out[:, :6]), out[:, 6:9]
    T_gt = T_sym_gt[:, 0]
    R_gt, t_gt = T_gt[:, :3, :3], T_gt[:, :3, 3]
    f = torch.stack([Kc[:, 0, 0], Kc[:, 1, 1]], -1)
    z_in, z_gt = T_in[:, 2, 3], t_gt[:, 2]
    xy = (v[:, :2] / f + T_in[:, :2, 3] / z_in[:, None]) * z_gt[:, None]
    orn = g.make_T(dR @ T_in[:, :3, :3], t_gt)
    trans_xy = g.make_T(R_gt, torch.cat([xy, z_gt[:, None]], -1))
    trans_z = g.make_T(R_gt, torch.cat([t_gt[:, :2], (v[:, 2] * z_in)[:, None]], -1))
    return sum(symmetric_loss(T_sym_gt, T, points) for T in (orn, trans_xy, trans_z))


def train_steps(params: dict, variant: str, objects, syms: list, steps: list, cfg: dict) -> dict:
    """Run the given steps from `params` (the network's parameters and
    BatchNorm statistics). Each step is (batch, draws): batch {images uint8
    (B,3,H,W), K, TCO, labels (object indices)} and draws {point_ids,
    pose_noise (euler, trans standard normals), drop_masks}. Returns {loss:
    [each step's loss], grads: {name: the first step's clipped gradient},
    grad_norms: [each step's global norm before the clip], params: {name:
    the parameters after the steps}}."""
    trained = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()
               if "running_" not in k}
    stats = {k: v for k, v in params.items() if "running_" in k}
    m = {k: torch.zeros_like(v) for k, v in trained.items()}
    s2 = {k: torch.zeros_like(v) for k, v in trained.items()}
    b1, b2 = cfg["adam_betas"]
    losses, first_grads, norms = [], {}, []
    dev = next(iter(params.values())).device
    euler_std = torch.tensor(cfg["noise_euler_deg"], device=dev) * (math.pi / 180)
    trans_std = torch.tensor(cfg["noise_trans"], device=dev)
    for t, (batch, draws) in enumerate(steps, start=1):
        images = batch["images"].to(dev).float() / 255.0
        K, T_gt, lab = batch["K"].to(dev), batch["TCO"].to(dev), batch["labels"].to(dev)
        pts_crop = objects.subset(lab)
        ids = draws["point_ids"].to(dev)
        pts_loss = torch.stack([objects.points[int(k)][ids] for k in lab])
        S = max(s.shape[0] for s in syms)
        sym = torch.stack([torch.cat([s, torch.eye(4, device=dev).expand(S - len(s), 4, 4)])
                           for s in (syms[int(k)] for k in lab)])
        T_sym_gt = T_gt[:, None] @ sym
        eu, tr = (d.to(dev) for d in draws["pose_noise"])
        T = g.make_T(T_gt[:, :3, :3] @ g.euler_to_matrix(eu * euler_std),
                     T_gt[:, :3, 3] + tr * trans_std)
        net = Net({**trained, **stats}, variant, train=True)
        step_losses = []
        for n in range(cfg["train_iterations"]):
            with torch.no_grad():
                crops, Kc, _, _ = g.crop(images, None, K, T, pts_crop, cfg["render_size"],
                                         cfg["lamb"])
                rgb, _ = render(objects.tri[lab], objects.valid[lab], T, Kc, cfg["render_size"],
                                objects.col[lab])
            out = net(torch.cat([crops, rgb], 1), drop_masks=draws["drop_masks"][n])
            step_losses.append(disentangled_loss(T_sym_gt, T, out, Kc, pts_loss))
            T = g.update_pose(T, Kc, out).detach()
        loss = torch.stack(step_losses).mean()
        names = list(trained)
        grads = torch.autograd.grad(loss, [trained[k] for k in names])
        norm = torch.sqrt(sum((gr.double() ** 2).sum() for gr in grads)).float()
        norms.append(float(norm))
        factor = 1.0 if norm < cfg["clip_grad_norm"] else cfg["clip_grad_norm"] / norm
        with torch.no_grad():
            for k, gr in zip(names, grads):
                gr = gr * factor
                m[k].mul_(b1).add_(gr, alpha=1 - b1)
                s2[k].mul_(b2).addcmul_(gr, gr, value=1 - b2)
                denom = (s2[k] / (1 - b2 ** t)).sqrt() + cfg["adam_eps"]
                trained[k] -= cfg["lr"] * (m[k] / (1 - b1 ** t)) / denom
                if t == 1:
                    first_grads[k] = gr
        losses.append(float(loss.detach()))
    return {"loss": losses, "grads": first_grads, "grad_norms": norms,
            "params": {k: v.detach() for k, v in trained.items()}}


def leaf_gaps(prog: dict, ref: dict, floor_of: dict | None = None) -> list:
    """Each leaf's |norm(prog) - norm(ref)| / max(norm(ref), the median
    leaf's norm(ref)); with floor_of, only the leaves whose floor_of norm is
    at least a thousandth of the median leaf's."""
    names = list(ref)
    if floor_of is not None:
        f = {k: float(floor_of[k].double().norm()) for k in names}
        med = float(np.median(list(f.values())))
        names = [k for k in names if f[k] >= 1e-3 * med]
    r = {k: float(ref[k].double().norm()) for k in names}
    p = {k: float(prog[k].double().norm()) for k in names}
    med = float(np.median(list(r.values())))
    return [abs(p[k] - r[k]) / max(r[k], med) for k in names]
