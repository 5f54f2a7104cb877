"""Plain geometry of CosyPose's render-and-compare loop, in float32 PyTorch.

Written from the published method (DeepIM crops, the image-space pose update,
BOP20's z-up auto-depth init) and kept frozen beside the benchmark; it imports
nothing of the program under test. Every function works on a batch of rows.
"""

from __future__ import annotations

import numpy as np
import torch


def make_T(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    T = torch.zeros(R.shape[:-2] + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def transform(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """T (B,4,4) applied to pts (B,P,3); T (B,S,4,4) gives (B,S,P,3)."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    if T.ndim == pts.ndim:
        return (pts[:, :, None, :] * R[:, None]).sum(-1) + t[:, None]
    return (pts[:, None, :, None, :] * R[:, :, None]).sum(-1) + t[:, :, None]


def project(pts: torch.Tensor, K: torch.Tensor, T: torch.Tensor, z_min: float = 0.1):
    """Pinhole projection with the depth clamped to z_min: (B,P,2)."""
    cam = transform(T, pts)
    suv = (cam[:, :, None, :] * K[:, None]).sum(-1)
    return suv[..., :2] / suv[..., 2:3].clamp_min(z_min)


def boxes_of(uv: torch.Tensor) -> torch.Tensor:
    return torch.cat([uv.amin(1), uv.amax(1)], dim=-1)


def deepim_box(center: torch.Tensor, obs: torch.Tensor, rend: torch.Tensor,
               im_size, lamb: float) -> torch.Tensor:
    """The aspect-preserving square-ish crop around the projected centre that
    covers both boxes with margin lamb (DeepIM)."""
    r = max(im_size) / min(im_size)
    xc, yc = center[:, 0], center[:, 1]
    xd = torch.stack([(obs[:, 0] - xc).abs(), (rend[:, 0] - xc).abs(),
                      (obs[:, 2] - xc).abs(), (rend[:, 2] - xc).abs()]).amax(0)
    yd = torch.stack([(obs[:, 1] - yc).abs(), (rend[:, 1] - yc).abs(),
                      (obs[:, 3] - yc).abs(), (rend[:, 3] - yc).abs()]).amax(0)
    w = torch.maximum(xd, yd * r) * 2 * lamb
    h = torch.maximum(xd / r, yd) * 2 * lamb
    return torch.stack([xc - w / 2, yc - h / 2, xc + w / 2, yc + h / 2], dim=-1)


def roi_align(images: torch.Tensor, boxes: torch.Tensor, out_hw, s: int = 4) -> torch.Tensor:
    """torchvision's roi_align (aligned=False), one box an image, by sampling
    s x s bilinear points a bin and averaging them. images (B,C,H,W)."""
    B, C, H, W = images.shape
    oh, ow = out_hw
    dev = images.device
    x1, y1, x2, y2 = boxes.unbind(-1)
    iy = (torch.arange(oh * s, device=dev, dtype=torch.float32) + 0.5) / s
    ix = (torch.arange(ow * s, device=dev, dtype=torch.float32) + 0.5) / s
    ys = y1[:, None] + iy[None] * ((y2 - y1) / oh)[:, None]  # (B, oh*s)
    xs = x1[:, None] + ix[None] * ((x2 - x1) / ow)[:, None]

    def axis(c, size):
        out = (c < -1.0) | (c > size)
        c = c.clamp(0.0, size - 1)
        c0 = c.floor()
        return c0.long(), (c0 + 1).clamp_max(size - 1).long(), c - c0, out

    y0, y1i, ly, oy = axis(ys, H)
    x0, x1i, lx, ox = axis(xs, W)
    flat = images.reshape(B, C, H * W)

    def at(yy, xx):  # (B, oh*s, ow*s) gathered for every channel
        idx = (yy[:, :, None] * W + xx[:, None, :]).reshape(B, 1, -1).expand(B, C, -1)
        return torch.gather(flat, 2, idx).reshape(B, C, yy.shape[1], xx.shape[1])

    wy0, wy1 = (1 - ly)[:, None, :, None], ly[:, None, :, None]
    wx0, wx1 = (1 - lx)[:, None, None, :], lx[:, None, None, :]
    v = (wy0 * wx0 * at(y0, x0) + wy0 * wx1 * at(y0, x1i)
         + wy1 * wx0 * at(y1i, x0) + wy1 * wx1 * at(y1i, x1i))
    v = torch.where((oy[:, None, :, None] | ox[:, None, None, :]), 0.0, v)
    return v.reshape(B, C, oh, s, ow, s).mean(dim=(3, 5))


def K_crop(K: torch.Tensor, boxes: torch.Tensor, out_hw) -> torch.Tensor:
    """Intrinsics of the crop resized to out_hw (width the larger side)."""
    fw, fh = float(max(out_hw)), float(min(out_hw))
    cw, ch = boxes[:, 2] - boxes[:, 0], boxes[:, 3] - boxes[:, 1]
    sx, sy = fw / cw, fh / ch
    Kc = K.clone()
    Kc[:, 0, 0] = sx * K[:, 0, 0]
    Kc[:, 1, 1] = sy * K[:, 1, 1]
    Kc[:, 0, 2] = (fw - 1) / 2 + sx * (K[:, 0, 2] - (boxes[:, 0] + boxes[:, 2]) / 2)
    Kc[:, 1, 2] = (fh - 1) / 2 + sy * (K[:, 1, 2] - (boxes[:, 1] + boxes[:, 3]) / 2)
    return Kc


def crop(images, boxes_obs, K, TCO, crop_points, out_hw, lamb):
    """One DeepIM crop: (crops (B,3,h,w), K_crop, boxes_rend, boxes_crop).
    The observed box is the render box of the current pose, as in CosyPose's
    refiner."""
    boxes_rend = boxes_of(project(crop_points, K, TCO))
    if boxes_obs is None:
        boxes_obs = boxes_rend
    center = project(torch.zeros_like(crop_points[:, :1]), K, TCO)[:, 0]
    boxes_crop = deepim_box(center, boxes_obs, boxes_rend, images.shape[-2:], lamb)
    crops = roi_align(images, boxes_crop, out_hw)
    return crops, K_crop(K, boxes_crop, out_hw), boxes_rend, boxes_crop


def rot6d_to_matrix(r: torch.Tensor) -> torch.Tensor:
    """Gram-Schmidt of the two 3-vectors into the first two columns."""
    x = r[:, 0:3] / torch.linalg.norm(r[:, 0:3], dim=-1, keepdim=True).clamp_min(1e-20)
    z = torch.cross(x, r[:, 3:6], dim=-1)
    z = z / torch.linalg.norm(z, dim=-1, keepdim=True).clamp_min(1e-20)
    y = torch.cross(z, x, dim=-1)
    return torch.stack([x, y, z], dim=-1)


def update_pose(TCO, Kc, out):
    """The image-space update of a 9-d head output (rot6d, vx, vy, vz)."""
    dR, v = rot6d_to_matrix(out[:, :6]), out[:, 6:9]
    z0 = TCO[:, 2, 3]
    z1 = v[:, 2] * z0
    f = torch.stack([Kc[:, 0, 0], Kc[:, 1, 1]], dim=-1)
    xy = (v[:, :2] / f + TCO[:, :2, 3] / z0[:, None]) * z1[:, None]
    return make_T(dR @ TCO[:, :3, :3], torch.cat([xy, z1[:, None]], dim=-1))


R_ZUP = ((0.0, 1.0, 0.0), (0.0, 0.0, -1.0), (-1.0, 0.0, 0.0))


def init_zup_autodepth(boxes, points, K):
    """BOP20's init: canonical z-up rotation, depth from the model's projected
    extent at 1 m against the box (CosyPose's TCO_init_from_boxes_zup_autodepth)."""
    B = boxes.shape[0]
    f = torch.stack([K[:, 0, 0], K[:, 1, 1]], dim=-1)
    c = torch.stack([K[:, 0, 2], K[:, 1, 2]], dim=-1)
    mid = (boxes[:, :2] + boxes[:, 2:]) / 2
    R = torch.tensor(R_ZUP, device=boxes.device).expand(B, 3, 3)
    T0 = make_T(R, torch.cat([(mid - c) / f, torch.ones(B, 1, device=boxes.device)], -1))
    P = transform(T0, points)
    dx = P[..., 0].amax(1) - P[..., 0].amin(1)
    dy = P[..., 1].amax(1) - P[..., 1].amin(1)
    z = (f[:, 0] * dx / (boxes[:, 2] - boxes[:, 0] + 1) + f[:, 1] * dy / (boxes[:, 3] - boxes[:, 1] + 1)) / 2
    return make_T(R, torch.cat([(mid - c) * z[:, None] / f, z[:, None]], -1))


def euler_to_matrix(e: torch.Tensor) -> torch.Tensor:
    """Static-frame sxyz angles: R = Rz Ry Rx."""
    ax, ay, az = e.unbind(-1)
    one, zero = torch.ones_like(ax), torch.zeros_like(ax)
    Rx = torch.stack([one, zero, zero, zero, ax.cos(), -ax.sin(), zero, ax.sin(), ax.cos()], -1)
    Ry = torch.stack([ay.cos(), zero, ay.sin(), zero, one, zero, -ay.sin(), zero, ay.cos()], -1)
    Rz = torch.stack([az.cos(), -az.sin(), zero, az.sin(), az.cos(), zero, zero, zero, one], -1)
    shape = e.shape[:-1] + (3, 3)
    return Rz.reshape(shape) @ Ry.reshape(shape) @ Rx.reshape(shape)


def sample_ids(n_points: int, k: int) -> np.ndarray:
    """The fixed subset of mesh points CosyPose's crop and init use:
    RandomState(0).choice(n, k, replace=False)."""
    return np.random.RandomState(0).choice(n_points, size=min(k, n_points), replace=False)


def decimate(verts: np.ndarray, faces: np.ndarray, colors: np.ndarray, max_faces: int):
    """Vertex clustering on a grid that coarsens (64, 32, ... 4 cells along
    the diagonal) until at most max_faces distinct, non-degenerate faces are
    left; cluster positions and colours are the means of their vertices."""
    if faces.shape[0] <= max_faces:
        return verts, faces, colors
    lo = verts.min(0)
    diag = float(np.linalg.norm(verts.max(0) - lo)) + 1e-9
    res = 64
    while res >= 4:
        keys = np.floor((verts - lo) / (diag / res)).astype(np.int64)
        _, cid, cnt = np.unique(keys, axis=0, return_inverse=True, return_counts=True)
        cid = cid.reshape(-1)
        nv = np.zeros((len(cnt), 3))
        np.add.at(nv, cid, verts)
        nv /= cnt[:, None]
        nc = np.zeros((len(cnt), 3))
        np.add.at(nc, cid, colors)
        nc /= cnt[:, None]
        nf = cid[faces]
        nf = nf[(nf[:, 0] != nf[:, 1]) & (nf[:, 1] != nf[:, 2]) & (nf[:, 0] != nf[:, 2])]
        _, first = np.unique(np.sort(nf, axis=1), axis=0, return_index=True)
        nf = nf[np.sort(first)]
        if nf.shape[0] <= max_faces:
            break
        res //= 2
    return nv, nf.astype(np.int64), nc


def angle_deg(Ra: torch.Tensor, Rb: torch.Tensor) -> torch.Tensor:
    """Angle of the rotation between Ra and Rb, in degrees, from their
    Frobenius distance (2 sqrt(2) sin(angle / 2)), which keeps its precision
    at small angles where the trace's arccos loses it."""
    d = torch.linalg.matrix_norm(Ra.double() - Rb.double())
    return torch.rad2deg(2 * torch.arcsin((d / (2 * 2 ** 0.5)).clamp(max=1.0)))
