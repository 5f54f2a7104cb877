"""The least time an H100 could take for one call of each raster kernel, on
given inputs: the larger of the bytes it must move over HBM3's rate and the
operations it must do over the fp32 rate outside the tensor cores.

One bound for every reader: scripts/bench_stages.py and chip_smoke.py.
"""

from __future__ import annotations

import math

import torch

from ..utils.card import H100_SXM, PEAK_FLOPS
from . import rasterizer_cuda as rc

# H100 SXM (NVIDIA data sheet, at the 700 W limit): fp32 outside the tensor
# cores, from the port's one peak table, and HBM3 bandwidth
PEAK_FP32 = PEAK_FLOPS[H100_SXM][torch.float32]
PEAK_BYTES = 3.35e12
# fp32 operations of one (pixel, row) visit of kernel B: 4 planes of 2 mul +
# 2 add, 3 inside tests and the depth test. A winner's 3 colour planes come on
# top; they are not counted, so the bound is a lower bound.
FLOPS_PER_VISIT = 20
# fp32 operations of kernel A per triangle, counted in csrc/raster_setup.cu:
# corners 54, projection 21, shading 24, area and inverse 8, the 9 barycentric
# coefficients 24, 1/z plane 15, colour/z 18 + 45, bbox and key 10
FLOPS_PER_TRIANGLE = 219


def bound(n_ops: float, n_bytes: float):
    """(bound_ms, 'operations' or 'bytes')."""
    t_ops, t_bytes = n_ops / PEAK_FP32, n_bytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def resolve_bound(rows, order, image, tile, budget, with_attr):
    """(bound_ms, by, visits, bytes) of one resolve on these inputs, read
    through the plain binning, so the same whatever implements the kernel:
    20 operations per visit of a pixel centre inside a listed row's own bbox
    within its tile; the rows and the order read once, the outputs written
    once."""
    (H, W), (th, tw) = image, tile
    nty, ntx = rc.tile_grid(image, tile)
    srt, idx, counts = rc.bin_chunks(rows, order, image, tile, budget)
    B, T, Kc = idx.shape
    dev = rows.device
    row_ids = (idx.long()[..., None] * rc.CHUNK + torch.arange(rc.CHUNK, device=dev)).flatten(1)
    lanes = srt[..., [rc.LANE_BBOX, rc.LANE_BBOX + 1, rc.LANE_BBOX + 2, rc.LANE_BBOX + 3,
                      rc.LANE_VALID]]
    box = torch.gather(lanes, 1, row_ids[..., None].expand(-1, -1, 5))
    box = box.reshape(B, T, Kc * rc.CHUNK, 5).double()
    listed = (torch.arange(Kc, device=dev) < counts[..., None]).repeat_interleave(rc.CHUNK, -1)
    listed &= box[..., 4] != 0
    t = torch.arange(T, device=dev)
    x_lo, y_lo = ((t % ntx) * tw).double(), ((t // ntx) * th).double()
    x_hi, y_hi = torch.clamp(x_lo + tw, max=W) - 1, torch.clamp(y_lo + th, max=H) - 1

    def span(lo_edge, hi_edge, lo, hi):  # pixels p in [lo, hi] with p + 0.5 in [lo_edge, hi_edge]
        first = torch.maximum(torch.ceil(lo_edge - 0.5), lo[None, :, None])
        last = torch.minimum(torch.floor(hi_edge - 0.5), hi[None, :, None])
        return (last - first + 1).clamp_min(0)

    visits = float((span(box[..., 0], box[..., 2], x_lo, x_hi)
                    * span(box[..., 1], box[..., 3], y_lo, y_hi) * listed).sum())
    n_bytes = 4 * rows.numel() + 8 * order.numel() + 4 * B * H * W * (4 + int(with_attr))
    return (*bound(visits * FLOPS_PER_VISIT, n_bytes), visits, n_bytes)


def setup_bound(tri_verts, tri_valid, colors, tri_attr, rows, ykey):
    """(bound_ms, by, bytes) of one setup: corners, colours, validity, poses,
    intrinsics (and attributes) read once; rows, keys and the int64 order
    (one entry a key) written once. The sort itself moves no device memory:
    kernel A sorts in shared memory."""
    B, F = tri_valid.shape
    n_bytes = (4 * tri_verts.numel() + tri_valid.numel() + 4 * colors.numel() + 4 * B * (16 + 9)
               + (4 * tri_attr.numel() if tri_attr is not None else 0)
               + 4 * (rows.numel() + ykey.numel()) + 8 * ykey.numel())
    return (*bound(B * F * FLOPS_PER_TRIANGLE, n_bytes), n_bytes)


def rank_bound(B: int, Fp: int):
    """(bound_ms, by) of kernel A's merge (its regime of sorted runs in
    device memory), all its passes: the runs (8 B a row) read once and the
    order (8 B a row) written once. It compares integers: no fp32
    operations."""
    return bound(0.0, 16 * B * Fp)


def bin_bound(rows, order, image, tile, budget):
    """(bound_ms, by, bytes) of kernel B's binning launch: the order (8 B a
    row) and each row's valid and bbox lanes (20 B) read once, the lists (4 B
    a slot of Kc) and the counts (4 B a tile) written once; its overlap
    tests, 4 comparisons a (chunk, tile), are counted as operations."""
    B, Fp = order.shape
    n_tiles = math.prod(rc.tile_grid(image, tile))
    Kc = rc.chunk_budget(budget, Fp)
    n_bytes = 28 * B * Fp + 4 * B * n_tiles * (Kc + 1)
    return (*bound(4 * B * n_tiles * (Fp // rc.CHUNK), n_bytes), n_bytes)


def listed_bound(rows, order, image, tile, budget, with_attr):
    """(bound_ms, by, visits, bytes) of kernel B's listed resolve alone: the
    work and bytes of resolve_bound, with the binning launch's lists (4 B a
    slot of Kc) and counts (4 B a tile) read once on top."""
    B, Fp = order.shape
    n_tiles = math.prod(rc.tile_grid(image, tile))
    visits, n_bytes = resolve_bound(rows, order, image, tile, budget, with_attr)[2:]
    n_bytes += 4 * B * n_tiles * (rc.chunk_budget(budget, Fp) + 1)
    return (*bound(visits * FLOPS_PER_VISIT, n_bytes), visits, n_bytes)
