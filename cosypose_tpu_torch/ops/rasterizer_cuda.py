"""Binned tile rasterizer: two Hopper kernels, and their plain versions.

Port of cosypose_tpu/ops/rasterizer_pallas.py. Same contract and math as
ops/rasterizer.py (affine screen-space planes, perspective-correct 1/z,
headlight shading baked into the colour planes). A call is

  setup    kernel A (csrc/raster_setup.cu): one packed 32-float row per
           triangle, its y-sort key, and the rows' stable order by key
           (sorted inside the kernel, where the JAX package argsorts): in
           one block an item, in a cluster of blocks, or, for the largest
           items, in sorted runs that a merge kernel (raster_setup_merge,
           one launch a pass) merges;
  resolve  kernel B (csrc/raster_resolve.cu): per (tile, item) block, bins
           the sorted chunks itself, culls rows per warp and resolves depth,
           reading the rows through that permutation, an item's rows in
           shared memory; above one window of shared memory, a binning
           launch (raster_resolve_bin) lists each tile's chunks once per
           item and the listed resolve (raster_resolve_listed) stages each
           tile's listed rows only.

Both take any number of items and rows an item: device memory is the only
limit. `setup` and `resolve` call the kernels as registered PyTorch
operators, `cosypose::raster_setup` and `cosypose::raster_resolve`
(torch.library), so that torch.export can trace a render as two opaque
calls. Each operator's CUDA implementation launches the kernels, its CPU
implementation runs the plain version, and no other device has one. The
plain versions:

  setup_plain     camera_corners + triangle_planes + packing, in PyTorch ops;
  sort_order      the stable sort of the keys (torch.sort), which with
                  setup_plain makes kernel A's function;
  composite_keys, sort_composite_keys  the kernel's own sort key in PyTorch
                  (its float map and composites), held to sort_order by the
                  tests; rank_runs, its sort as clusters do it, slice by
                  slice; merge_runs (with co_rank, its split), its sort as
                  the runs and the merge passes do it;
  bin_chunks      the chunk binning of the JAX package (chunk AABBs, overlap,
                  first_k_true), on the sorted rows, and the binning launch's
                  function; bin_chunks_segmented, the same as that launch
                  computes it, segment by segment;
  resolve_plain   the per-pixel resolve with the kernel's exact arithmetic,
                  vectorised over all pixels, one chunk slot at a time;
  resolve_plain_binned  bin_chunks composed with resolve_plain: kernel B's
                  function.

`row_may_cover` is the cull rule kernel B applies; tests hold it to never
skipping a row that wins. RASTER_KERNEL builds both sources with nvcc at first
use (ops/nvcc_build.py, in parallel), launches them on the current stream and
counts launches per kernel and variant (`RASTER_KERNEL.launches`).
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from .nvcc_build import build_libraries
from .rasterizer import camera_corners, first_k_true, overlap, tile_origins, triangle_planes

ROW = 32   # packed row: 0:3 lam_a, 3:6 lam_b, 6:9 lam_c, 9:12 iz_abc, 12:15 col_a, 15:18 col_b,
#            18:21 col_c, 21 attr, 22 0, 23 valid, 24:28 bbox (x0, y0, x1, y1), 28:32 cover box
LANE_ATTR, LANE_VALID, LANE_BBOX, LANE_COVER = 21, 23, 24, 28
CHUNK = 8  # rows per chunk: the unit of binning
WARP_PIXELS = 64  # kernel B's warps take 64 consecutive pixels of a tile, two a lane
CULL_SLACK = 2.0 ** -20  # rounding slack of row_may_cover, per unit magnitude
MIN_RUN_ROWS = 256  # kernel A's shortest sorted runs, where it takes runs


def tile_grid(image_size: tuple[int, int], tile: tuple[int, int]) -> tuple[int, int]:
    """(nty, ntx): tiles cover the image, the last row/column may be ragged."""
    return math.ceil(image_size[0] / tile[0]), math.ceil(image_size[1] / tile[1])


def chunk_budget(max_tris_per_tile: int, Fp: int) -> int:
    """Kc: how many 8-row chunks a tile lists at most."""
    return math.ceil(min(max_tris_per_tile, Fp) / CHUNK)


def padded_rows(F: int) -> int:
    return -(-F // CHUNK) * CHUNK  # integer arithmetic: F may be symbolic under tracing


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def cover_box(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
              image_size: tuple[int, int]) -> torch.Tensor:
    """(..., 4) float32 (x0, y0, x1, y1): a box holding every pixel centre of
    the image at which the float32 inside tests of planes (a_i, b_i, c_i)
    (each (..., 3)) can pass, as csrc/raster_setup.cu explains: the float64
    triangle of the half-planes a_i x + b_i y + c_i >= -t_i,
    t_i = 1e-6 + 2^-20 (|a_i| W + |b_i| H + |c_i|), widened and clipped to the
    image; the image where the normals do not positively span the plane; all
    zero where the box is empty."""
    H, W = image_size
    a, b, c = a.double(), b.double(), c.double()
    t = 1e-6 + 2.0 ** -20 * (a.abs() * W + b.abs() * H + c.abs())
    i, j = [0, 1, 2], [1, 2, 0]
    det = a[..., i] * b[..., j] - a[..., j] * b[..., i]
    norm = torch.sqrt(a * a + b * b)
    spans = ((det.abs() >= 1e-6 * norm[..., i] * norm[..., j]).all(-1)
             & ((det > 0).all(-1) | (det < 0).all(-1)))
    r = -t - c
    vx = (r[..., i] * b[..., j] - r[..., j] * b[..., i]) / det
    vy = (a[..., i] * r[..., j] - a[..., j] * r[..., i]) / det

    def widen(v, d):
        return v + d * (1e-3 + 1e-6 * v.abs())

    box = torch.stack([widen(vx.amin(-1), -1).clamp_min(0), widen(vy.amin(-1), -1).clamp_min(0),
                       widen(vx.amax(-1), 1).clamp_max(W), widen(vy.amax(-1), 1).clamp_max(H)], -1)
    image = torch.tensor([0.0, 0.0, W, H], dtype=torch.float64, device=a.device)
    box = torch.where(spans[..., None], box, image)
    empty = (box[..., 0] > box[..., 2]) | (box[..., 1] > box[..., 3])
    box = torch.where(empty[..., None], 0.0, box)
    f = box.float()  # rounded outward: down for x0, y0, up for x1, y1
    down = torch.tensor([True, True, False, False], device=a.device)
    away = torch.where(down, f.double() > box, f.double() < box)
    return torch.where(away, torch.nextafter(f, torch.where(down, -torch.inf, torch.inf)), f)


def setup_plain(tri_verts: torch.Tensor, tri_valid: torch.Tensor, TCO: torch.Tensor,
                K: torch.Tensor, image_size: tuple[int, int], colors: torch.Tensor | None = None,
                z_near: float = 0.05, tri_attr: torch.Tensor | None = None):
    """Kernel A's function: (rows (B,Fp,32) fp32, ykey (B,Fp) fp32).

    Rows in mesh order, padded to whole chunks; invalid and padding rows are
    zero with key +inf, valid rows carry 1.0 in the valid lane, their cover
    box on the image_size (H, W) image, and sort by their projected y-centre.
    """
    B, Fn = tri_verts.shape[:2]
    if colors is None:
        colors = torch.full_like(tri_verts, 0.7)
    planes = triangle_planes(camera_corners(tri_verts, TCO), tri_valid, K, colors, z_near)
    valid = planes["valid"]
    bbox = planes["bbox"]
    attr_col = (tri_attr.float()[..., None] if tri_attr is not None
                else torch.zeros_like(bbox[..., :1]))
    rows = torch.cat([planes["lam_a"], planes["lam_b"], planes["lam_c"], planes["iz_abc"],
                      planes["col_a"], planes["col_b"], planes["col_c"], attr_col,
                      torch.zeros_like(attr_col), torch.ones_like(attr_col), bbox,
                      cover_box(planes["lam_a"], planes["lam_b"], planes["lam_c"], image_size)],
                     dim=-1)
    rows = torch.where(valid[..., None], rows, 0.0)
    ykey = torch.where(valid, 0.5 * (bbox[..., 1] + bbox[..., 3]), torch.inf)
    Fp = padded_rows(Fn)
    return (F.pad(rows, (0, 0, 0, Fp - Fn)).contiguous(),
            F.pad(ykey, (0, Fp - Fn), value=torch.inf).contiguous())


# Tolerance of kernel A against setup_plain, in units u = 2^-24 of float32
# rounding. Both versions round the corners, the projection, the barycentric
# planes and the sums over corners op for op in the same order
# (ops/rasterizer.py), so validity and the 1/z plane agree bit for bit; the
# normal's length (torch.linalg.norm against a rounded sum of squares) may
# differ in its last bit, and with it the colour planes. Those are sums: the barycentric planes,
# weighted by the corners' values t_k. The barycentric planes nearly cancel in
# the image (they sum to 1), so a last-bit difference in a term moves a plane's
# value by up to u * t_k * sum_k mag(lambda_k), which grows as the triangle
# shrinks, not by u times the plane's own size. A plane p = (a, b, c) is
# therefore measured as (|da| X + |db| Y + |dc|) / (mag(p) * sum_k mag(lambda_k)),
# where mag(p) = |a| X + |b| Y + |c| and X, Y are the image size or the
# triangle's farthest corner, if larger. With equal corners the two versions
# then differ by at most ~8 u (two roundings of a 3-term sum each); 64 u leaves
# room for the corners' own last bits. Bbox and key lanes are pixel positions:
# their differences over X (or Y), held to the same 64 u.
SETUP_TOL = 2.0 ** -18


def setup_error(rows_a: torch.Tensor, key_a: torch.Tensor, rows_b: torch.Tensor,
                key_b: torch.Tensor, image_size: tuple[int, int],
                K: torch.Tensor | None = None) -> dict:
    """How far setup outputs a and b (the reference) lie apart, as SETUP_TOL
    reads it: the largest plane and bbox/key errors over rows valid in both,
    the number of rows whose validity differs, and the largest attribute
    difference. With the intrinsics K (B,3,3), a bbox or key lane is measured
    against the terms it sums, u = fx·x/z + cx: |u| + |cx| (v: |v| + |cy|)
    where that exceeds the image. Crop intrinsics can put the principal
    point far outside the crop, and u then cancels two large terms, each
    rounded to its own size."""
    H, W = image_size
    valid_a, valid_b = rows_a[..., LANE_VALID] != 0, rows_b[..., LANE_VALID] != 0
    both = valid_a & valid_b
    if not both.any():
        return dict(plane=0.0, bbox_key=0.0, valid_differs=int((valid_a != valid_b).sum()),
                    attr=0.0)
    a, b = rows_a[both].double(), rows_b[both].double()
    d = (a - b).abs()
    box = b[:, LANE_BBOX:LANE_BBOX + 4].abs()
    X = torch.maximum(box[:, 0], box[:, 2]).clamp_min(W)
    Y = torch.maximum(box[:, 1], box[:, 3]).clamp_min(H)
    if K is not None:
        item = both.nonzero()[:, 0]
        X = torch.maximum(X, torch.maximum(box[:, 0], box[:, 2]) + K[item, 0, 2].double().abs())
        Y = torch.maximum(Y, torch.maximum(box[:, 1], box[:, 3]) + K[item, 1, 2].double().abs())

    def mag(t, i, j, k):
        return t[:, i].abs() * X + t[:, j].abs() * Y + t[:, k].abs()

    cond = sum(mag(b, k, k + 3, k + 6) for k in range(3))
    planes = [(k, k + 3, k + 6) for k in range(3)] + [(9, 10, 11)] + [
        (12 + c, 15 + c, 18 + c) for c in range(3)]
    plane = max(float((mag(d, *p) / (mag(b, *p) * cond).clamp_min(1e-30)).max()) for p in planes)
    box_err = float((d[:, LANE_BBOX:LANE_BBOX + 4] / torch.stack([X, Y, X, Y], -1)).max())
    key_err = float(((key_a[both] - key_b[both]).abs().double() / Y).max())
    return dict(plane=plane, bbox_key=max(box_err, key_err),
                valid_differs=int((valid_a != valid_b).sum()), attr=float(d[:, LANE_ATTR].max()))


def sort_order(ykey: torch.Tensor) -> torch.Tensor:
    """(B, Fp) int64: rows in order of ykey, equal keys in mesh order. The
    plain version of kernel A's order (the CPU path and the tests)."""
    return torch.sort(ykey, dim=1, stable=True).indices


def composite_keys(ykey: torch.Tensor) -> torch.Tensor:
    """(B, Fp) int64: kernel A's unique sort key of each row, an
    order-preserving integer map of the float key in the high 32 bits and
    the row index f in the low 32. The map orders as torch.sort does on the
    card: -0.0 tied with +0.0, denormals by value, a NaN by its bits (a
    positive one above +inf, a negative one below -inf; on the CPU
    torch.sort puts every NaN last). Here the map is the signed one
    (non-negative floats as their bits, negative ones with all but the sign
    bit flipped), which orders as the kernel's unsigned map does."""
    bits = torch.where(ykey == 0, 0, ykey.float().contiguous().view(torch.int32).long())
    mapped = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    return mapped * 2 ** 32 + torch.arange(ykey.shape[1], device=ykey.device)


def sort_composite_keys(ykey: torch.Tensor) -> torch.Tensor:
    """(B, Fp) int64: kernel A's sort in PyTorch, over the whole list: the
    sorted composite keys' low halves are the order."""
    return torch.sort(composite_keys(ykey), dim=1).values & 0xFFFFFFFF


def rank_runs(ykey: torch.Tensor, run_rows: int) -> torch.Tensor:
    """(B, Fp) int64: kernel A's order as its clusters build it (each slice
    ranking its composites in the others' distributed shared memory), in
    PyTorch. The composite keys are cut into runs of run_rows rows (the last
    one shorter), each run sorted on its own; a composite's rank is its place
    in its run plus its lower bound in each other run, and order[rank] = f.
    Equal to sort_composite_keys for any run_rows >= 1: the tests hold it so."""
    B, Fp = ykey.shape
    keys = composite_keys(ykey)
    runs = [torch.sort(keys[:, lo:lo + run_rows], dim=1).values for lo in range(0, Fp, run_rows)]
    order = torch.empty_like(keys)
    for j, run in enumerate(runs):
        rank = torch.arange(run.shape[1], device=ykey.device).expand_as(run).clone()
        for other in (r for i, r in enumerate(runs) if i != j):
            rank += torch.searchsorted(other, run, side="left")
        order.scatter_(1, rank, run & 0xFFFFFFFF)
    return order


MERGE_TILE = 2048  # outputs a block of the merge kernel writes


def co_rank(a: torch.Tensor, b: torch.Tensor, d: int) -> int:
    """How many of the d smallest values of the merge of sorted 1-D a and b
    (no value in both) come from a: the split of the merge kernel's blocks
    and threads, found by the same binary search (the kernel's warps probe
    32 places a step; the answer is the same)."""
    lo, hi = max(0, d - len(b)), min(d, len(a))
    while lo < hi:
        mid = (lo + hi) // 2
        if a[mid] < b[d - 1 - mid]:
            lo = mid + 1
        else:
            hi = mid
    return lo


def merge_runs(ykey: torch.Tensor, run_rows: int, tile: int = MERGE_TILE) -> torch.Tensor:
    """(B, Fp) int64: kernel A's order as regime 3 builds it, in PyTorch.
    The composite keys are cut into runs of run_rows rows (the last one
    shorter), each sorted on its own (kernel A's blocks); then each merge
    pass (a launch of the merge kernel) merges runs 2p and 2p + 1 into one,
    `tile` outputs at a time: a tile takes the spans of the two runs between
    the co_rank splits of its first and last output and merges them. The
    passes run until one run holds the item (at least one pass); the last
    one's low halves are the order. Equal to sort_composite_keys for any
    run_rows and tile >= 1: the tests hold it so."""
    B, Fp = ykey.shape
    keys = composite_keys(ykey)
    runs = torch.cat([torch.sort(keys[:, lo:lo + run_rows], dim=1).values
                      for lo in range(0, Fp, run_rows)], dim=1)
    width = run_rows
    while True:
        out = torch.empty_like(runs)
        for b in range(B):
            for a0 in range(0, Fp, 2 * width):
                a = runs[b, a0:a0 + width]
                c = runs[b, a0 + len(a):a0 + 2 * width]
                for d0 in range(0, len(a) + len(c), tile):
                    d1 = min(d0 + tile, len(a) + len(c))
                    i0, i1 = co_rank(a, c, d0), co_rank(a, c, d1)
                    span = torch.cat([a[i0:i1], c[d0 - i0:d1 - i1]])
                    out[b, a0 + d0:a0 + d1] = torch.sort(span).values
        runs = out
        if 2 * width >= Fp:
            return runs & 0xFFFFFFFF
        width *= 2


def _chunk_overlap(rows: torch.Tensor, order: torch.Tensor, image_size: tuple[int, int],
                   tile: tuple[int, int]):
    """(sorted rows (B,Fp,32), overlap (B, n_tiles, C) bool): which chunks'
    AABBs (over their valid rows) touch which tiles."""
    th, tw = tile
    nty, ntx = tile_grid(image_size, tile)
    B, Fp, _ = rows.shape
    C = Fp // CHUNK
    srt = torch.gather(rows, 1, order[..., None].expand(-1, -1, ROW))
    valid = srt[..., LANE_VALID] != 0
    big = 1e9

    def chunk_extreme(lane, fill, reduce):
        return reduce(torch.where(valid, srt[..., lane], fill).reshape(B, C, CHUNK), -1)

    bx0 = chunk_extreme(LANE_BBOX, big, torch.amin)
    by0 = chunk_extreme(LANE_BBOX + 1, big, torch.amin)
    bx1 = chunk_extreme(LANE_BBOX + 2, -big, torch.amax)
    by1 = chunk_extreme(LANE_BBOX + 3, -big, torch.amax)
    cvalid = valid.reshape(B, C, CHUNK).any(-1)
    tile_x0, tile_y0 = tile_origins(nty, ntx, th, tw, rows.device)
    return srt, overlap(bx0, by0, bx1, by1, cvalid, tile_x0, tile_y0, tw, th)


def bin_chunks(rows: torch.Tensor, order: torch.Tensor, image_size: tuple[int, int],
               tile: tuple[int, int], max_tris_per_tile: int):
    """The JAX package's chunk binning on the sorted rows: (sorted rows
    (B,Fp,32), chunk_idx (B,n_tiles,Kc) int32, counts (B,n_tiles) int32).

    Each tile lists the ascending ids of the chunks whose AABB (over their
    valid rows) touches it; a tile that touches more than Kc drops the highest.
    """
    srt, ov = _chunk_overlap(rows, order, image_size, tile)
    chunk_idx, counts = first_k_true(ov, chunk_budget(max_tris_per_tile, rows.shape[1]))
    return srt, chunk_idx.int(), counts.int()


BIN_SEGMENT = 2048  # chunks a unit of the binning launch tests against its tile


def bin_chunks_segmented(rows: torch.Tensor, order: torch.Tensor, image_size: tuple[int, int],
                         tile: tuple[int, int], max_tris_per_tile: int,
                         segment: int = BIN_SEGMENT):
    """bin_chunks as kernel B's binning launch computes it: each tile's
    chunks cut into segments of `segment`, the chunks of each segment that
    touch the tile counted, then listed from the segment's place in the list
    (the counts of the segments before it), none from Kc on; the count is
    the segments' sum, at most Kc. The same outputs as bin_chunks for any
    segment: the tests hold it so."""
    srt, ov = _chunk_overlap(rows, order, image_size, tile)
    B, T, C = ov.shape
    Kc = chunk_budget(max_tris_per_tile, rows.shape[1])
    segs = [ov[..., c0:c0 + segment] for c0 in range(0, C, segment)]
    seg_count = torch.stack([s.sum(-1) for s in segs], -1)  # (B, T, n_seg)
    before = seg_count.cumsum(-1) - seg_count
    chunk_idx = torch.zeros(B, T, Kc + 1, dtype=torch.long, device=rows.device)
    for k, ov_s in enumerate(segs):
        pos = before[..., k:k + 1] + ov_s.long().cumsum(-1) - 1
        keep = ov_s & (pos < Kc)
        ids = torch.arange(k * segment, k * segment + ov_s.shape[-1], device=rows.device)
        chunk_idx.scatter_(-1, torch.where(keep, pos, Kc), ids.expand_as(ov_s))
    return srt, chunk_idx[..., :Kc].int(), seg_count.sum(-1).clamp_max(Kc).int()


def row_may_cover(rows: torch.Tensor, x0, x1, y0, y1) -> torch.Tensor:
    """The cull rule of kernel B: False only where the row cannot win at any
    pixel centre (x, y) of [x0, x1] x [y0, y1] (0 <= x0 <= x1, 0 <= y0 <= y1)
    of the image whose cover boxes the rows carry.

    rows (..., 32); the bounds are tensors or numbers broadcasting with
    rows[..., 0]. Two conservative tests, and a row must pass both:
    - its cover box (lanes 28:32, cover_box) meets the rectangle;
    - for each plane, the largest value its evaluation ((a*x + b*y) + c) can
      take in the rectangle, bounded by the value at the maximising corner plus
      a slack of 2^-20 times the plane's magnitude |a|*x1 + |b|*y1 + |c| (more
      than the rounding of both evaluations, below 2^-22 of it each), passes
      the inside tests (lambda_i >= -1e-6) and the depth test (1/z > 0).
    """
    def plane_max(a, b, c):
        a, b, c = rows[..., a], rows[..., b], rows[..., c]
        top = a * torch.where(a >= 0, x1, x0) + b * torch.where(b >= 0, y1, y0) + c
        mag = a.abs() * x1 + b.abs() * y1 + c.abs()
        return top + mag * CULL_SLACK

    box = rows[..., LANE_COVER:LANE_COVER + 4]
    return ((box[..., 0] <= x1) & (box[..., 2] >= x0) & (box[..., 1] <= y1) & (box[..., 3] >= y0)
            & (rows[..., LANE_VALID] != 0) & (plane_max(0, 3, 6) >= -1e-6)
            & (plane_max(1, 4, 7) >= -1e-6) & (plane_max(2, 5, 8) >= -1e-6)
            & (plane_max(9, 10, 11) >= 0))


def warp_rects(image_size: tuple[int, int], tile: tuple[int, int], device=None):
    """Kernel B's warps, WARP_PIXELS consecutive pixels of a tile in row-major
    order: (warp_of (H, W) long, each pixel's warp within its tile; x0, x1,
    y0, y1 (n_tiles, n_warps) float32, each warp's pixel-centre rectangle,
    ragged-edge pixels included)."""
    H, W = image_size
    th, tw = tile
    nty, ntx = tile_grid(image_size, tile)
    tid = torch.arange(th * tw, device=device)
    warp = tid // WARP_PIXELS
    n_w = int(warp.max()) + 1
    lx, ly = (tid % tw).float(), (tid // tw).float()
    tile_x0, tile_y0 = tile_origins(nty, ntx, th, tw, device)

    def extreme(origin, local, fill, reduce):
        per_warp = torch.full((n_w,), fill, device=device).scatter_reduce(0, warp, local, reduce)
        return origin[:, None] + 0.5 + per_warp[None, :]

    ys = torch.arange(H, device=device)
    xs = torch.arange(W, device=device)
    warp_of = warp.reshape(th, tw)[(ys % th)[:, None], (xs % tw)[None, :]]
    return (warp_of,
            extreme(tile_x0, lx, math.inf, "amin"), extreme(tile_x0, lx, -math.inf, "amax"),
            extreme(tile_y0, ly, math.inf, "amin"), extreme(tile_y0, ly, -math.inf, "amax"))


def resolve_plain(rows: torch.Tensor, chunk_idx: torch.Tensor, counts: torch.Tensor,
                  image_size: tuple[int, int], tile: tuple[int, int], with_attr: bool = False,
                  *, cull: bool = False):
    """The per-pixel resolve of the sorted rows in plain PyTorch, on any device.

    Loops over chunk slots and their 8 rows; each step gathers one row per
    (item, tile), spreads its lanes to the tile's pixels and updates with
    torch.where. Every plane is ((a*x + b*y) + c) in separately rounded ops,
    as in the kernel. With `cull`, a row takes part at a pixel only where
    row_may_cover holds on the pixel's warp rectangle, as in kernel B; the
    image is the same, which the tests check. Returns (rgb (B,3,H,W) clipped
    to [0,1], depth (B,H,W), attr (B,H,W) or None).
    """
    H, W = image_size
    th, tw = tile
    nty, ntx = tile_grid(image_size, tile)
    B = rows.shape[0]
    dev = rows.device
    ys = torch.arange(H, device=dev)
    xs = torch.arange(W, device=dev)
    tile_of = (ys // th)[:, None] * ntx + (xs // tw)[None, :]  # (H, W)
    py = (ys.float() + 0.5)[:, None]
    px = (xs.float() + 0.5)[None, :]
    live = counts.long()[:, tile_of]  # (B, H, W)
    if cull:
        warp_of, *rect = warp_rects(image_size, tile, dev)

    iz = torch.zeros(B, H, W, device=dev)
    colz = [torch.zeros(B, H, W, device=dev) for _ in range(3)]
    attr = torch.zeros(B, H, W, device=dev)
    n_max = int(counts.max()) if counts.numel() else 0
    for k in range(n_max):
        active = k < live
        first_row = chunk_idx[:, :, k].long() * CHUNK  # (B, n_tiles)
        for j in range(CHUNK):
            row = torch.gather(rows, 1, (first_row + j)[..., None].expand(-1, -1, ROW))

            def lane(i):  # lane i of each tile's row, spread to its pixels: (B, H, W)
                return row[:, :, i][:, tile_of]

            def plane(a, b, c):
                return lane(a) * px + lane(b) * py + lane(c)

            lmin = torch.minimum(plane(0, 3, 6), torch.minimum(plane(1, 4, 7), plane(2, 5, 8)))
            izv = plane(9, 10, 11)
            win = active & (lmin >= -1e-6) & (izv > iz)
            if cull:
                win &= row_may_cover(row[:, :, None, :], *rect)[:, tile_of, warp_of]
            iz = torch.where(win, izv, iz)
            for c in range(3):
                colz[c] = torch.where(win, plane(12 + c, 15 + c, 18 + c), colz[c])
            if with_attr:
                attr = torch.where(win, lane(LANE_ATTR), attr)

    hit = iz > 0.0
    safe = iz.clamp_min(1e-12)
    depth = torch.where(hit, torch.reciprocal(safe), 0.0)
    rgb = torch.stack([torch.where(hit, c / safe, 0.0) for c in colz], dim=1).clamp(0.0, 1.0)
    return rgb, depth, (torch.where(hit, attr, 0.0) if with_attr else None)


def resolve_plain_binned(rows: torch.Tensor, order: torch.Tensor, image_size: tuple[int, int],
                         tile: tuple[int, int], max_tris_per_tile: int = 1024,
                         with_attr: bool = False):
    """Kernel B's function in plain PyTorch: bin_chunks, then resolve_plain."""
    srt, chunk_idx, counts = bin_chunks(rows, order, image_size, tile, max_tris_per_tile)
    return resolve_plain(srt, chunk_idx, counts, image_size, tile, with_attr)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------


def _check(name, x, device, dtype, shape):
    if x.device != device or x.dtype != dtype or tuple(x.shape) != tuple(shape) \
            or not x.is_contiguous():
        raise ValueError(f"{name}: want a contiguous {dtype} tensor of shape {tuple(shape)} on "
                         f"{device}, got {x.dtype} {tuple(x.shape)} on {x.device}")


def check_setup_args(tri_verts, tri_valid, TCO, K, colors=None, tri_attr=None) -> int:
    """Kernel A's checks, on any device: dtypes, shapes and contiguity. Any
    number of items and rows. Returns Fp, the rows an item (padded to whole
    chunks)."""
    dev = tri_verts.device
    B, Fn = tri_verts.shape[:2]
    _check("tri_verts", tri_verts, dev, torch.float32, (B, Fn, 3, 3))
    _check("tri_valid", tri_valid, dev, torch.bool, (B, Fn))
    _check("TCO", TCO, dev, torch.float32, (B, 4, 4))
    _check("K", K, dev, torch.float32, (B, 3, 3))
    if colors is not None:
        _check("colors", colors, dev, torch.float32, (B, Fn, 3, 3))
    if tri_attr is not None:
        _check("tri_attr", tri_attr, dev, torch.float32, (B, Fn))
    return padded_rows(Fn)


def check_resolve_args(rows, order, tile) -> None:
    """Kernel B's checks, on any device: rows (B, Fp, 32) float32 in whole
    chunks, 16-byte aligned, order (B, Fp) int64, a tile of whole warps
    (th*tw a positive multiple of 64). Any number of items and rows."""
    th, tw = tile
    B, Fp = rows.shape[:2]
    _check("rows", rows, rows.device, torch.float32, (B, Fp, ROW))
    _check("order", order, rows.device, torch.int64, (B, Fp))
    if Fp % CHUNK or th * tw <= 0 or th * tw % WARP_PIXELS \
            or (rows.device.type != "meta" and rows.data_ptr() % 16):
        raise ValueError(f"raster_resolve does not take rows {tuple(rows.shape)} (whole chunks "
                         f"of {CHUNK}, 16-byte aligned) with tile {tile} (th*tw a multiple of "
                         f"{WARP_PIXELS})")


class RasterKernels:
    """ctypes bindings of csrc/raster_setup.cu and csrc/raster_resolve.cu, with
    a count of launches of each kernel and variant: 'raster_setup',
    'raster_setup_merge' (kernel A's merge passes, one launch each, where an
    item's rows are sorted in runs in device memory), 'raster_resolve' and
    'raster_resolve_attr' (kernel B's one-window kernel, WITH_ATTR apart),
    'raster_resolve_bin' (its binning launch above one window) and
    'raster_resolve_listed' (its listed resolve above one window, with or
    without the attribute)."""

    def __init__(self):
        self.launches = {"raster_setup": 0, "raster_setup_merge": 0, "raster_resolve": 0,
                         "raster_resolve_attr": 0, "raster_resolve_bin": 0,
                         "raster_resolve_listed": 0}
        self._fns = None
        self._rows = {}

    def load(self):
        if self._fns is None:
            libs = build_libraries()
            setup_lib = ctypes.CDLL(str(libs["setup"][0]))
            lib = ctypes.CDLL(str(libs["resolve"][0]))
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            fns = {"setup": setup_lib.cosypose_raster_setup,
                   "setup_merge": setup_lib.cosypose_raster_setup_merge,
                   "merge_passes": setup_lib.cosypose_raster_setup_merge_passes,
                   "setup_plan": setup_lib.cosypose_raster_setup_plan,
                   "sort_block_rows": setup_lib.cosypose_raster_setup_block_rows,
                   "resolve": lib.cosypose_raster_resolve,
                   "resolve_bin": lib.cosypose_raster_resolve_bin,
                   "bin_scratch": lib.cosypose_raster_resolve_bin_scratch,
                   "resolve_listed": lib.cosypose_raster_resolve_listed,
                   "window_rows": lib.cosypose_raster_resolve_window_rows}
            argtypes = {"setup": [ptr] * 10 + [i32] * 5 + [ctypes.c_float] + [i32] * 3 + [ptr],
                        "setup_merge": [ptr] * 2 + [i32] * 4 + [ptr],
                        "merge_passes": [i32] * 2, "setup_plan": [i32] * 3,
                        "sort_block_rows": [i32], "window_rows": [i32],
                        "resolve": [ptr] * 5 + [i32] * 11 + [ptr],
                        "resolve_bin": [ptr] * 5 + [i32] * 8 + [ptr],
                        "bin_scratch": [i32] * 3,
                        "resolve_listed": [ptr] * 7 + [i32] * 11 + [ptr]}
            for name, fn in fns.items():
                fn.argtypes = argtypes[name]
                fn.restype = ctypes.c_longlong if name == "bin_scratch" else ctypes.c_int
            self._fns = fns
        return self._fns

    def _shared_rows(self, which: str, device: torch.device) -> int:
        index = device.index or 0
        if (which, index) not in self._rows:
            n = self.load()[which](index)
            if n <= 0:
                raise RuntimeError(f"{which}: cannot read the shared memory limit "
                                   f"(cudaError {-n})")
            self._rows[which, index] = n
        return self._rows[which, index]

    def window_rows(self, device: torch.device) -> int:
        """The rows of one window of kernel B on `device`: it stages 22 B a
        sorted row in shared memory, so whole chunks within the shared memory
        a block may opt in to (10,560 on an H100). An item of more rows takes
        the binning launch and the listed resolve."""
        return self._shared_rows("window_rows", device)

    def sort_block_rows(self, device: torch.device) -> int:
        """The rows one block of kernel A sorts on `device`: 8 B a row in
        shared memory, padded to a power of two, within the shared memory a
        block may opt in to (16,384 on an H100). An item of more rows is
        sorted by a cluster of blocks, or in runs and their merge."""
        return self._shared_rows("sort_block_rows", device)

    def setup_plan(self, B: int, Fp: int, device: torch.device) -> int:
        """The launcher's choice for B items of Fp rows: the blocks of a
        cluster an item (1 to 8), or -1 for runs in device memory and their
        merge. Read from the card (its occupancy query) before any launch."""
        c = self.load()["setup_plan"](B, Fp, device.index or 0)
        if c < 0:
            raise RuntimeError(f"raster_setup: cannot plan the launch (cudaError {-c})")
        return c if c > 0 else -1

    def run_rows(self, B: int, Fp: int, device: torch.device) -> int:
        """The rows of each sorted run where kernel A takes runs: the
        shortest power of two from MIN_RUN_ROWS with which the runs launch
        is one wave (B x runs at most the SM count: a block of kernel A
        holds an SM's registers), at most sort_block_rows(). On an H100 this
        was the fastest run length at every size of chip_smoke.py phase 14
        (PERF.md §6): a shorter run adds a wave, a longer one a bitonic
        sort of more rows in each block, against one merge pass fewer."""
        rows, block = MIN_RUN_ROWS, self.sort_block_rows(device)
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        while rows < block and B * -(-Fp // rows) > sms:
            rows *= 2
        return rows

    def merge_passes(self, Fp: int, run_rows: int) -> int:
        """The merge kernel's launches for runs of run_rows rows."""
        return self.load()["merge_passes"](Fp, run_rows)

    def setup(self, tri_verts, tri_valid, TCO, K, image_size, colors=None, z_near=0.05,
              tri_attr=None, cluster=0, run_rows=None):
        """Kernel A on CUDA tensors: (rows (B,Fp,32), ykey (B,Fp), order
        (B,Fp) int64), for any number of items and rows. `cluster` is the
        number of blocks an item (1 to 8, enough that no block sorts more
        than sort_block_rows()), -1 for runs in device memory merged by a
        second kernel (raster_setup_merge, a launch a pass), or 0, which
        every render passes, to let the launcher choose by shape and by the
        card's occupancy query (setup_plan); with runs, `run_rows` sets
        their length (at most sort_block_rows(); run_rows() by default). The
        outputs are the same for every choice (tests and measurements set
        them)."""
        if not tri_verts.is_cuda:
            raise ValueError("the raster kernels take CUDA tensors")
        dev = tri_verts.device
        B, Fn = tri_verts.shape[:2]
        Fp = check_setup_args(tri_verts, tri_valid, TCO, K, colors, tri_attr)
        block = self.sort_block_rows(dev)
        if cluster == 0 and Fp > block:
            cluster = self.setup_plan(B, Fp, dev)
        if not -1 <= cluster <= 8 or cluster > 0 and -(-Fp // cluster) > block:
            raise ValueError(f"raster_setup: clusters of {cluster} blocks do not hold {Fp} rows "
                             f"an item ({block} a block, clusters of 1 to 8, -1 for runs, 0 "
                             f"to choose)")
        if cluster < 0:
            run_rows = self.run_rows(B, Fp, dev) if run_rows is None else int(run_rows)
            if not 0 < run_rows <= block:
                raise ValueError(f"raster_setup: runs of {run_rows} rows (1 to {block})")
        rows = torch.empty(B, Fp, ROW, device=dev)
        ykey = torch.empty(B, Fp, device=dev)
        order = torch.empty(B, Fp, dtype=torch.int64, device=dev)
        fns, stream = self.load(), torch.cuda.current_stream(dev).cuda_stream
        runs = passes = None
        if cluster < 0 and B and Fp:
            passes = self.merge_passes(Fp, run_rows)
            scratch = torch.empty(B, Fp, dtype=torch.int64, device=dev)
            runs = scratch if passes % 2 else order  # the last pass reads scratch
        err = fns["setup"](
            tri_verts.data_ptr(), tri_valid.data_ptr(), TCO.data_ptr(), K.data_ptr(),
            None if colors is None else colors.data_ptr(),
            None if tri_attr is None else tri_attr.data_ptr(), rows.data_ptr(),
            ykey.data_ptr(), order.data_ptr(), None if runs is None else runs.data_ptr(), B, Fn,
            Fp, int(image_size[0]), int(image_size[1]), float(z_near), max(cluster, 0),
            run_rows or 0, dev.index or 0, stream)
        if err != 0:
            raise RuntimeError(f"raster_setup launch failed: cudaError {err}")
        self.launches["raster_setup"] += 1
        if runs is not None:
            err = fns["setup_merge"](scratch.data_ptr(), order.data_ptr(), B, Fp, run_rows,
                                     dev.index or 0, stream)
            if err != 0:
                raise RuntimeError(f"raster_setup_merge launch failed: cudaError {err}")
            self.launches["raster_setup_merge"] += passes
        return rows, ykey, order

    def bin_chunks(self, rows, order, image_size, tile, max_tris_per_tile=1024):
        """Kernel B's binning launch on CUDA tensors: (chunk_idx (B,n_tiles,Kc)
        int32, counts (B,n_tiles) int32), bin_chunks' lists, in one launch
        for any number of items."""
        if not rows.is_cuda:
            raise ValueError("the raster kernels take CUDA tensors")
        check_resolve_args(rows, order, tile)
        dev = rows.device
        B, Fp = rows.shape[:2]
        (th, tw), (nty, ntx) = tile, tile_grid(image_size, tile)
        Kc = chunk_budget(max_tris_per_tile, Fp)
        chunk_idx = torch.empty(B, nty * ntx, Kc, dtype=torch.int32, device=dev)
        counts = torch.empty(B, nty * ntx, dtype=torch.int32, device=dev)
        fns = self.load()
        scratch = torch.empty(max(1, fns["bin_scratch"](B, Fp, nty * ntx)), dtype=torch.uint8,
                              device=dev)
        err = fns["resolve_bin"](rows.data_ptr(), order.data_ptr(), chunk_idx.data_ptr(),
                                 counts.data_ptr(), scratch.data_ptr(), B, Fp, Kc, th, tw, nty,
                                 ntx, dev.index or 0, torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"raster_resolve_bin launch failed: cudaError {err}")
        self.launches["raster_resolve_bin"] += 1
        return chunk_idx, counts

    def resolve(self, rows, order, image_size, tile, max_tris_per_tile=1024, with_attr=False):
        """Kernel B on CUDA tensors: (rgb (B,3,H,W), depth (B,H,W), attr or
        None), for any number of items (a launch for each 65,535) and rows
        an item. An item of at most window_rows() rows takes one launch with
        its rows in shared memory; an item of more, the binning launch
        (bin_chunks) and the listed resolve (resolve_listed)."""
        if not rows.is_cuda:
            raise ValueError("the raster kernels take CUDA tensors")
        check_resolve_args(rows, order, tile)
        dev = rows.device
        B, Fp = rows.shape[:2]
        Kc = chunk_budget(max_tris_per_tile, Fp)
        if Fp > self.window_rows(dev):
            lists = self.bin_chunks(rows, order, image_size, tile, max_tris_per_tile)
            return self.resolve_listed(rows, order, *lists, image_size, tile, with_attr)
        return self._resolve("resolve", rows, order, (), Kc, image_size, tile, with_attr)

    def resolve_listed(self, rows, order, chunk_idx, counts, image_size, tile, with_attr=False):
        """Kernel B's resolve of the lists of bin_chunks (its budget in
        chunk_idx's last dimension) on CUDA tensors: (rgb, depth, attr or
        None), each tile's listed rows staged in shared memory 2,048 at a
        time (the second launch of resolve above one window)."""
        if not rows.is_cuda:
            raise ValueError("the raster kernels take CUDA tensors")
        check_resolve_args(rows, order, tile)
        T, Kc = math.prod(tile_grid(image_size, tile)), chunk_idx.shape[-1]
        _check("chunk_idx", chunk_idx, rows.device, torch.int32, (rows.shape[0], T, Kc))
        _check("counts", counts, rows.device, torch.int32, (rows.shape[0], T))
        return self._resolve("resolve_listed", rows, order, (chunk_idx.data_ptr(),
                                                             counts.data_ptr()),
                             Kc, image_size, tile, with_attr)

    def _resolve(self, fn, rows, order, lists, Kc, image_size, tile, with_attr):
        (H, W), (th, tw), (nty, ntx) = image_size, tile, tile_grid(image_size, tile)
        dev = rows.device
        B, Fp = rows.shape[:2]
        rgb = torch.empty(B, 3, H, W, device=dev)
        depth = torch.empty(B, H, W, device=dev)
        attr = torch.empty(B, H, W, device=dev) if with_attr else None
        err = self.load()[fn](
            rows.data_ptr(), order.data_ptr(), *lists, rgb.data_ptr(), depth.data_ptr(),
            attr.data_ptr() if with_attr else None, B, Fp, Kc, H, W, th, tw, nty, ntx,
            int(with_attr), dev.index or 0, torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"raster_resolve launch failed: cudaError {err}")
        # one launch for each 65,535 items (grid.y)
        name = ("raster_resolve_listed" if fn == "resolve_listed"
                else "raster_resolve_attr" if with_attr else "raster_resolve")
        self.launches[name] += -(-B // 65535)
        return rgb, depth, attr


RASTER_KERNEL = RasterKernels()


# ---------------------------------------------------------------------------
# the registered operators
# ---------------------------------------------------------------------------
#
# Both kernels are PyTorch operators, so that torch.export (and anything else
# that traces with fake tensors, which have no data pointer) can take a call
# in as one opaque node: `cosypose::raster_setup` and
# `cosypose::raster_resolve`. Each has a CUDA implementation (the kernel,
# never its plain version), a CPU implementation (the plain version) and a
# fake one that gives the output shapes. No other device has one. A schema
# cannot return None, so raster_resolve returns an empty tensor for the
# attribute when with_attr is false; `resolve` hands back None for it.

@torch.library.custom_op(
    "cosypose::raster_setup", mutates_args=(), device_types="cpu",
    schema="(Tensor tri_verts, Tensor tri_valid, Tensor TCO, Tensor K, int[] image_size, "
           "Tensor? colors, float z_near, Tensor? tri_attr) -> (Tensor, Tensor, Tensor)")
def raster_setup_op(tri_verts, tri_valid, TCO, K, image_size, colors, z_near, tri_attr):
    """CPU: setup_plain, then sort_order."""
    rows, ykey = setup_plain(tri_verts, tri_valid, TCO, K, tuple(image_size), colors, z_near,
                             tri_attr)
    return rows, ykey, sort_order(ykey)


@raster_setup_op.register_kernel("cuda")
def _setup_cuda(tri_verts, tri_valid, TCO, K, image_size, colors, z_near, tri_attr):
    return RASTER_KERNEL.setup(tri_verts, tri_valid, TCO, K, tuple(image_size), colors, z_near,
                               tri_attr)


@raster_setup_op.register_fake
def _setup_fake(tri_verts, tri_valid, TCO, K, image_size, colors, z_near, tri_attr):
    B, Fn = tri_verts.shape[:2]
    Fp = padded_rows(Fn)
    return (tri_verts.new_empty(B, Fp, ROW), tri_verts.new_empty(B, Fp),
            tri_verts.new_empty(B, Fp, dtype=torch.int64))


@torch.library.custom_op(
    "cosypose::raster_resolve", mutates_args=(), device_types="cpu",
    schema="(Tensor rows, Tensor order, int[] image_size, int[] tile, int max_tris_per_tile, "
           "bool with_attr) -> (Tensor, Tensor, Tensor)")
def raster_resolve_op(rows, order, image_size, tile, max_tris_per_tile, with_attr):
    """CPU: resolve_plain_binned."""
    rgb, depth, attr = resolve_plain_binned(rows, order, tuple(image_size), tuple(tile),
                                            max_tris_per_tile, with_attr)
    return rgb, depth, rows.new_empty(0) if attr is None else attr


@raster_resolve_op.register_kernel("cuda")
def _resolve_cuda(rows, order, image_size, tile, max_tris_per_tile, with_attr):
    rgb, depth, attr = RASTER_KERNEL.resolve(rows, order, tuple(image_size), tuple(tile),
                                             max_tris_per_tile, with_attr)
    return rgb, depth, rows.new_empty(0) if attr is None else attr


@raster_resolve_op.register_fake
def _resolve_fake(rows, order, image_size, tile, max_tris_per_tile, with_attr):
    B, (H, W) = rows.shape[0], image_size
    return (rows.new_empty(B, 3, H, W), rows.new_empty(B, H, W),
            rows.new_empty(B, H, W) if with_attr else rows.new_empty(0))


def _on_raster_device(x: torch.Tensor) -> None:
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no rasterizer for device {x.device}")


def setup(tri_verts, tri_valid, TCO, K, image_size, colors=None, z_near=0.05, tri_attr=None):
    """cosypose::raster_setup: kernel A on CUDA tensors, setup_plain and
    sort_order on CPU tensors, on float32 copies of the inputs: (rows, ykey,
    order), order the stable y-sort that resolve takes."""
    _on_raster_device(tri_verts)

    def f32(x):
        return None if x is None else x.float().contiguous()

    return raster_setup_op(f32(tri_verts), tri_valid.bool().contiguous(), f32(TCO), f32(K),
                           [int(s) for s in image_size], f32(colors), float(z_near),
                           f32(tri_attr))


def resolve(rows, order, image_size, tile, max_tris_per_tile=1024, with_attr=False):
    """cosypose::raster_resolve: kernel B on CUDA tensors, resolve_plain_binned
    on CPU tensors: (rgb, depth, attr or None)."""
    _on_raster_device(rows)
    rgb, depth, attr = raster_resolve_op(rows, order, [int(s) for s in image_size],
                                         [int(s) for s in tile], int(max_tris_per_tile),
                                         bool(with_attr))
    return rgb, depth, attr if with_attr else None
