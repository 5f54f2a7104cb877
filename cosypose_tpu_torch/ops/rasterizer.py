"""Batched triangle rasterizer, plain PyTorch (port of cosypose_tpu/ops/rasterizer.py).

Geometry is reduced to per-triangle affine screen-space planes: barycentric
edge functions, 1/z and colour·(1/z) are all affine in (x, y). `triangle_planes`
builds them and is shared with the kernel path (ops/rasterizer_cuda.py).
`rasterize` is the port of the JAX package's per-tile XLA formulation: per tile,
the first `max_tris_per_tile` overlapping triangle ids, all evaluated at once,
the nearest surface kept with a first-in-list tie-break. It is a plain version
and runs on any device; the render-and-compare loop uses the kernel path.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class RenderOutput(NamedTuple):
    rgb: torch.Tensor    # (B, 3, H, W) float32 in [0, 1]
    depth: torch.Tensor  # (B, H, W) float32, 0 where no hit
    mask: torch.Tensor   # (B, H, W) bool
    attr: torch.Tensor | None = None  # (B, H, W) winner's flat per-triangle attribute


def camera_corners(tri_verts: torch.Tensor, TCO: torch.Tensor) -> torch.Tensor:
    """Object-frame corners (B,F,3,3) posed by TCO (B,4,4) into the camera frame.

    Each coordinate is ((R_i0 v_0 + R_i1 v_1) + R_i2 v_2) + t_i, one rounding
    an op in that order, as kernel A (csrc/raster_setup.cu) computes it: a
    batched GEMM (einsum) leaves its order and FMA use unspecified, and the
    corners of a triangle that is degenerate up to rounding (the pole
    triangles of a UV-sphere mesh) then project to equal or to different
    floats in the two versions, which flips its validity.
    """
    R, t = TCO[:, None, None, :3, :3], TCO[:, None, None, :3, 3]
    return ((R[..., 0] * tri_verts[..., 0:1] + R[..., 1] * tri_verts[..., 1:2])
            + R[..., 2] * tri_verts[..., 2:3]) + t


def triangle_planes(tv: torch.Tensor, tri_valid: torch.Tensor, K: torch.Tensor,
                    tri_colors: torch.Tensor, z_near: float) -> dict:
    """Per-triangle affine plane coefficients in screen space; the projection,
    the barycentric planes and the sums over corners round each op in kernel
    A's order (csrc/raster_setup.cu), the normal's length is torch's own.

    tv (B,F,3,3) camera-frame corners, tri_valid (B,F), K (B,3,3),
    tri_colors (B,F,3,3) per-corner albedo. Returns (B,F,...) tensors:
    lam_a/lam_b/lam_c (B,F,3) with barycentric_i(x,y) = a_i x + b_i y + c_i;
    iz_abc (B,F,3), the plane of 1/z; col_a/col_b/col_c (B,F,3), the planes of
    colour·(1/z); bbox (B,F,4) as (xmin, ymin, xmax, ymax); valid (B,F).
    """
    z = tv[..., 2]
    tbehind = (z < z_near).any(dim=-1)
    zs = z.clamp_min(z_near)
    fx, fy = K[:, 0, 0, None, None], K[:, 1, 1, None, None]
    cx, cy = K[:, 0, 2, None, None], K[:, 1, 2, None, None]
    u = fx * tv[..., 0] / zs + cx  # (B, F, 3)
    v = fy * tv[..., 1] / zs + cy
    tiz = 1.0 / zs

    # face shading: headlight Lambertian on the camera-frame normal, two-sided
    n = torch.cross(tv[:, :, 1] - tv[:, :, 0], tv[:, :, 2] - tv[:, :, 0], dim=-1)
    n = n / torch.linalg.norm(n, dim=-1, keepdim=True).clamp_min(1e-12)
    intensity = 0.35 + 0.65 * n[..., 2].abs()
    tcol = tri_colors * intensity[..., None, None]

    x0, x1, x2 = u.unbind(-1)
    y0, y1, y2 = v.unbind(-1)
    area2 = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
    degenerate = area2.abs() < 1e-9
    inv_area2 = torch.where(degenerate, 0.0, 1.0 / torch.where(degenerate, 1.0, area2))

    a = torch.stack([y1 - y2, y2 - y0, y0 - y1], dim=-1) * inv_area2[..., None]
    b = torch.stack([x2 - x1, x0 - x2, x1 - x0], dim=-1) * inv_area2[..., None]
    c = torch.stack([x1 * y2 - x2 * y1, x2 * y0 - x0 * y2, x0 * y1 - x1 * y0],
                    dim=-1) * inv_area2[..., None]

    # 1/z and colour/z are affine: coeff = sum_i lambda_coeff_i * attr_i, summed
    # over the corners in order (a plane of a sliver cancels terms ~1e6 apart,
    # so the order decides its last bits)
    def corner_sum(t, dim):
        t0, t1, t2 = t.unbind(dim)
        return (t0 + t1) + t2

    ctiz = tcol * tiz[..., None]  # (B, F, 3 corners, 3 channels)
    return dict(
        lam_a=a, lam_b=b, lam_c=c,
        iz_abc=torch.stack([corner_sum(a * tiz, -1), corner_sum(b * tiz, -1),
                            corner_sum(c * tiz, -1)], dim=-1),
        col_a=corner_sum(a[..., None] * ctiz, -2),
        col_b=corner_sum(b[..., None] * ctiz, -2),
        col_c=corner_sum(c[..., None] * ctiz, -2),
        bbox=torch.stack([u.amin(-1), v.amin(-1), u.amax(-1), v.amax(-1)], dim=-1),
        valid=tri_valid & ~tbehind & ~degenerate,
    )


def tile_origins(nty: int, ntx: int, th: int, tw: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-left corners (x0, y0) of the row-major tile grid, each (n_tiles,) float32."""
    tile_x0 = (torch.arange(ntx, device=device) * tw).repeat(nty).float()
    tile_y0 = (torch.arange(nty, device=device) * th).repeat_interleave(ntx).float()
    return tile_x0, tile_y0


def overlap(x0, y0, x1, y1, valid, tile_x0, tile_y0, tw, th) -> torch.Tensor:
    """(B, n_tiles, N) bool: box n of item b touches tile t (closed intervals)."""
    return ((x0[:, None, :] <= (tile_x0 + tw)[None, :, None])
            & (x1[:, None, :] >= tile_x0[None, :, None])
            & (y0[:, None, :] <= (tile_y0 + th)[None, :, None])
            & (y1[:, None, :] >= tile_y0[None, :, None])
            & valid[:, None, :])


def first_k_true(ov: torch.Tensor, k: int):
    """Ascending indices of the first k True entries along the last axis.

    Explicit compaction (cumsum + scatter), so the list order never depends
    on how a top-k orders ties. Returns (idx (..., k) long, padded with 0;
    counts (...,) long, at most k).
    """
    pos = ov.long().cumsum(-1) - 1
    keep = ov & (pos < k)
    slot = torch.where(keep, pos, k)  # overflow and misses land in a dump slot
    ids = torch.arange(ov.shape[-1], device=ov.device).expand_as(ov)
    idx = torch.zeros(ov.shape[:-1] + (k + 1,), dtype=torch.long, device=ov.device)
    idx.scatter_(-1, slot, ids)
    return idx[..., :k], keep.sum(-1)


def rasterize(tri_verts: torch.Tensor, tri_valid: torch.Tensor, TCO: torch.Tensor,
              K: torch.Tensor, image_size: tuple[int, int] = (240, 320),
              colors: torch.Tensor | None = None, tile: tuple[int, int] = (24, 64),
              max_tris_per_tile: int = 128, z_near: float = 0.05,
              tri_attr: torch.Tensor | None = None) -> RenderOutput:
    """Render one posed mesh per batch item under per-item intrinsics.

    tri_verts (B,F,3,3) object-frame corners, tri_valid (B,F), TCO (B,4,4),
    K (B,3,3), colors (B,F,3,3) or None for a flat 0.7 albedo, tri_attr (B,F).
    """
    H, W = image_size

    def fit(size, t):
        while size % t != 0:
            t -= 1
        return t

    th, tw = fit(H, tile[0]), fit(W, tile[1])
    nty, ntx = H // th, W // tw
    B, F = tri_verts.shape[:2]
    kcap = min(max_tris_per_tile, F)
    dev = tri_verts.device
    if colors is None:
        colors = torch.full_like(tri_verts, 0.7)

    planes = triangle_planes(camera_corners(tri_verts, TCO), tri_valid, K, colors, z_near)
    tile_x0, tile_y0 = tile_origins(nty, ntx, th, tw, dev)
    bbox = planes["bbox"]
    ov = overlap(bbox[..., 0], bbox[..., 1], bbox[..., 2], bbox[..., 3],
                 planes["valid"], tile_x0, tile_y0, tw, th)
    tri_idx, counts = first_k_true(ov, kcap)  # (B, n_tiles, kcap)
    tri_ok = torch.arange(kcap, device=dev) < counts[..., None]

    px = torch.arange(tw, dtype=torch.float32, device=dev) + 0.5
    py = torch.arange(th, dtype=torch.float32, device=dev) + 0.5
    rgb = torch.zeros(B, H, W, 3, device=dev)
    depth = torch.zeros(B, H, W, device=dev)
    mask = torch.zeros(B, H, W, dtype=torch.bool, device=dev)
    attr = torch.zeros(B, H, W, device=dev) if tri_attr is not None else None
    for t in range(nty * ntx):
        idx = tri_idx[:, t]  # (B, kcap)

        def take(x):  # (B, F, 3) → (B, 1, 1, kcap, 3)
            return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))[:, None, None]

        la, lb, lc = take(planes["lam_a"]), take(planes["lam_b"]), take(planes["lam_c"])
        iz = take(planes["iz_abc"])
        xe = (tile_x0[t] + px)[None, None, :, None]
        ye = (tile_y0[t] + py)[None, :, None, None]
        lam = [la[..., i] * xe + lb[..., i] * ye + lc[..., i] for i in range(3)]
        inside = ((lam[0] >= -1e-6) & (lam[1] >= -1e-6) & (lam[2] >= -1e-6)
                  & tri_ok[:, t, None, None, :])
        izv = iz[..., 0] * xe + iz[..., 1] * ye + iz[..., 2]  # (B, th, tw, kcap)
        izv = torch.where(inside & (izv > 0), izv, 0.0)
        iz_win = izv.amax(-1)
        hit = iz_win > 0
        # winner = the first list entry holding the max
        eq = (izv == iz_win[..., None]) & hit[..., None]
        first = ((eq.long().cumsum(-1) == 1) & eq).long().argmax(-1)  # (B, th, tw)

        def winner(x):  # (B, 1, 1, kcap, C) → (B, th, tw, C)
            x = x.expand(-1, th, tw, -1, -1)
            return torch.gather(x, 3, first[..., None, None].expand(-1, -1, -1, 1, x.shape[-1]))[..., 0, :]

        colz = winner(take(planes["col_a"])) * xe + winner(take(planes["col_b"])) * ye \
            + winner(take(planes["col_c"]))
        safe = iz_win.clamp_min(1e-12)
        ys, xs = slice(int(tile_y0[t]), int(tile_y0[t]) + th), slice(int(tile_x0[t]), int(tile_x0[t]) + tw)
        rgb[:, ys, xs] = torch.where(hit[..., None], colz / safe[..., None], 0.0)
        depth[:, ys, xs] = torch.where(hit, 1.0 / safe, 0.0)
        mask[:, ys, xs] = hit
        if tri_attr is not None:
            a_t = torch.gather(tri_attr.float(), 1, idx)[:, None, None, :, None]
            attr[:, ys, xs] = torch.where(hit, winner(a_t)[..., 0], 0.0)
    return RenderOutput(rgb=rgb.clamp(0.0, 1.0).permute(0, 3, 1, 2), depth=depth,
                        mask=mask, attr=attr)
