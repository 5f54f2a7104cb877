"""A plain dense rasterizer: every pixel against every triangle.

The same image model as the program's renderer promises: pixel centres at
+0.5, a pixel inside a triangle where its three barycentric coordinates are
at least -1e-6, the nearest surface by interpolated 1/z (the lowest face
index on a tie), perspective-correct colour, two-sided headlight shading
0.35 + 0.65 |n_z|, triangles with a corner nearer than z_near or with a
doubled screen area under 1e-9 dropped, and 0 where nothing is hit. No
tiles, no bins, no sort: the rows are evaluated densely in blocks of pixels.
"""

from __future__ import annotations

import torch


def planes(tri_verts, tri_valid, T, K, colors, z_near: float = 0.05):
    """Screen-space affine planes of the barycentrics, 1/z and colour/z of
    each triangle: a dict of (B,F,...) tensors."""
    R, t = T[:, None, None, :3, :3], T[:, None, None, :3, 3]
    cam = (R * tri_verts[..., None, :]).sum(-1) + t  # (B,F,3 corners,3)
    z = cam[..., 2]
    behind = (z < z_near).any(-1)
    zs = z.clamp_min(z_near)
    fx, fy = K[:, 0, 0, None, None], K[:, 1, 1, None, None]
    cx, cy = K[:, 0, 2, None, None], K[:, 1, 2, None, None]
    u, v = fx * cam[..., 0] / zs + cx, fy * cam[..., 1] / zs + cy
    n = torch.cross(cam[:, :, 1] - cam[:, :, 0], cam[:, :, 2] - cam[:, :, 0], dim=-1)
    n = n / torch.linalg.norm(n, dim=-1, keepdim=True).clamp_min(1e-12)
    col = colors * (0.35 + 0.65 * n[..., 2].abs())[..., None, None]
    (x0, x1, x2), (y0, y1, y2) = u.unbind(-1), v.unbind(-1)
    area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
    degenerate = area.abs() < 1e-9
    inv = torch.where(degenerate, 0.0, 1.0 / torch.where(degenerate, 1.0, area))
    a = torch.stack([y1 - y2, y2 - y0, y0 - y1], -1) * inv[..., None]
    b = torch.stack([x2 - x1, x0 - x2, x1 - x0], -1) * inv[..., None]
    c = torch.stack([x1 * y2 - x2 * y1, x2 * y0 - x0 * y2, x0 * y1 - x1 * y0], -1) * inv[..., None]
    iz = 1.0 / zs
    ciz = col * iz[..., None]  # (B,F,3 corners,3 channels)
    return dict(a=a, b=b, c=c,
                iz=torch.stack([(a * iz).sum(-1), (b * iz).sum(-1), (c * iz).sum(-1)], -1),
                ca=(a[..., None] * ciz).sum(-2), cb=(b[..., None] * ciz).sum(-2),
                cc=(c[..., None] * ciz).sum(-2),
                valid=tri_valid & ~behind & ~degenerate)


@torch.no_grad()
def render(tri_verts, tri_valid, T, K, image_size, colors):
    """tri_verts (B,F,3,3) object frame, tri_valid (B,F), T (B,4,4), K
    (B,3,3), colors (B,F,3,3) → (rgb (B,3,H,W), depth (B,H,W))."""
    H, W = image_size
    B, F = tri_verts.shape[:2]
    dev = tri_verts.device
    p = planes(tri_verts, tri_valid, T, K, colors)
    ys, xs = torch.meshgrid(torch.arange(H, device=dev, dtype=torch.float32) + 0.5,
                            torch.arange(W, device=dev, dtype=torch.float32) + 0.5,
                            indexing="ij")
    xs, ys = xs.reshape(-1), ys.reshape(-1)
    rgb = torch.zeros(B, H * W, 3, device=dev)
    depth = torch.zeros(B, H * W, device=dev)
    face = torch.arange(F, device=dev)
    pixels_per_block = max(256, 2 ** 25 // max(1, B * F))  # ~128 MB a (B,P,F) tensor
    for s in range(0, H * W, pixels_per_block):
        x = xs[s:s + pixels_per_block][None, :, None]  # (1,P,1)
        y = ys[s:s + pixels_per_block][None, :, None]

        inside = p["valid"][:, None, :].expand(-1, x.shape[1], -1).clone()
        for i in range(3):
            lam = p["a"][:, None, :, i] * x + p["b"][:, None, :, i] * y + p["c"][:, None, :, i]
            inside &= lam >= -1e-6
        izv = p["iz"][:, None, :, 0] * x + p["iz"][:, None, :, 1] * y + p["iz"][:, None, :, 2]
        izv = torch.where(inside & (izv > 0), izv, 0.0)
        best = izv.amax(-1)
        hit = best > 0
        win = torch.where(izv == best[..., None], face, F).amin(-1).clamp_max(F - 1)  # (B,P)

        def take(q):  # (B,F,3) → (B,P,3)
            return torch.gather(q, 1, win[..., None].expand(-1, -1, 3))

        col = take(p["ca"]) * x + take(p["cb"]) * y + take(p["cc"])
        safe = best.clamp_min(1e-12)
        rgb[:, s:s + pixels_per_block] = torch.where(hit[..., None], col / safe[..., None], 0.0)
        depth[:, s:s + pixels_per_block] = torch.where(hit, 1.0 / safe, 0.0)
    rgb = rgb.clamp(0.0, 1.0).reshape(B, H, W, 3).permute(0, 3, 1, 2)
    return rgb, depth.reshape(B, H, W)
