"""Binned tile rasterizer: PyTorch prologue, Hopper kernel wrapper, plain version.

Port of cosypose_tpu/ops/rasterizer_pallas.py. Same contract and math as
ops/rasterizer.py (affine screen-space planes, perspective-correct 1/z,
headlight shading baked into the colour planes), with the per-tile depth
resolve in a hand-written CUDA kernel (csrc/rasterizer.cu).

  prepare        the prologue in PyTorch: planes, packing into 24-wide rows,
                 stable y-sort, chunk AABBs and per-tile chunk lists.
  resolve        the kernel's wrapper on CUDA tensors, its plain version on
                 CPU tensors; nothing else.
  RASTER_KERNEL  the kernel's wrapper: builds csrc/rasterizer.cu with nvcc at
                 first use, launches it on the current stream and counts the
                 launches of each variant (`RASTER_KERNEL.launches`).
  resolve_plain  the same function in plain PyTorch, with the kernel's exact
                 arithmetic, vectorised over all pixels, one chunk slot at a
                 time (memory stays O(B·H·W)).

Unlike the TPU kernel, which takes a per-tile copy of every binned chunk, the
kernel takes the sorted rows once plus per-tile chunk-id lists and counts.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import pathlib
import shutil
import subprocess

import torch
import torch.nn.functional as F

from .rasterizer import camera_corners, first_k_true, overlap, tile_origins, triangle_planes

COEF_DIM = 24  # packed row: 0:3 lam_a, 3:6 lam_b, 6:9 lam_c, 9:12 iz_abc,
#                12:15 col_a, 15:18 col_b, 18:21 col_c, 21 attr, 22:24 bbox y0/y1
CHUNK = 8      # triangle rows per chunk: the unit of binning

SOURCE = pathlib.Path(__file__).resolve().parents[1] / "csrc" / "rasterizer.cu"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def tile_grid(image_size: tuple[int, int], tile: tuple[int, int]) -> tuple[int, int]:
    """(nty, ntx): tiles cover the image, the last row/column may be ragged."""
    return math.ceil(image_size[0] / tile[0]), math.ceil(image_size[1] / tile[1])


def prepare(tri_verts: torch.Tensor, tri_valid: torch.Tensor, TCO: torch.Tensor,
            K: torch.Tensor, image_size: tuple[int, int], colors: torch.Tensor | None = None,
            tile: tuple[int, int] = (16, 32), max_tris_per_tile: int = 1024,
            z_near: float = 0.05, tri_attr: torch.Tensor | None = None):
    """The kernel's inputs: (coef (B,Fp,24) fp32, chunk_idx (B,n_tiles,Kc) int32,
    counts (B,n_tiles) int32).

    Rows are sorted by projected y-centre (stable, so equal keys keep mesh
    order), invalid rows are zeroed and sort to the tail, and each tile lists
    the ascending ids of the chunks whose AABB touches it. A tile that touches
    more than Kc chunks drops the highest ids.
    """
    th, tw = tile
    nty, ntx = tile_grid(image_size, tile)
    B, Fn = tri_verts.shape[:2]
    if colors is None:
        colors = torch.full_like(tri_verts, 0.7)
    planes = triangle_planes(camera_corners(tri_verts, TCO), tri_valid, K, colors, z_near)
    valid = planes["valid"]
    bbox = planes["bbox"]
    attr_col = (tri_attr.float()[..., None] if tri_attr is not None
                else torch.zeros_like(bbox[..., :1]))
    coef = torch.cat([planes["lam_a"], planes["lam_b"], planes["lam_c"], planes["iz_abc"],
                      planes["col_a"], planes["col_b"], planes["col_c"], attr_col,
                      bbox[..., 1:2], bbox[..., 3:4]], dim=-1)
    coef = torch.where(valid[..., None], coef, 0.0)

    Fp = math.ceil(Fn / CHUNK) * CHUNK
    if Fp > Fn:
        coef = F.pad(coef, (0, 0, 0, Fp - Fn))
        bbox = F.pad(bbox, (0, 0, 0, Fp - Fn))
        valid = F.pad(valid, (0, Fp - Fn))
    C = Fp // CHUNK

    ykey = torch.where(valid, 0.5 * (bbox[..., 1] + bbox[..., 3]), torch.inf)
    order = torch.sort(ykey, dim=1, stable=True).indices
    coef = torch.gather(coef, 1, order[..., None].expand(-1, -1, COEF_DIM))
    bbox = torch.gather(bbox, 1, order[..., None].expand(-1, -1, 4))
    valid = torch.gather(valid, 1, order)

    big = 1e9
    bx0 = torch.where(valid, bbox[..., 0], big).reshape(B, C, CHUNK).amin(-1)
    by0 = torch.where(valid, bbox[..., 1], big).reshape(B, C, CHUNK).amin(-1)
    bx1 = torch.where(valid, bbox[..., 2], -big).reshape(B, C, CHUNK).amax(-1)
    by1 = torch.where(valid, bbox[..., 3], -big).reshape(B, C, CHUNK).amax(-1)
    cvalid = valid.reshape(B, C, CHUNK).any(-1)

    Kc = math.ceil(min(max_tris_per_tile, Fp) / CHUNK)
    tile_x0, tile_y0 = tile_origins(nty, ntx, th, tw, coef.device)
    ov = overlap(bx0, by0, bx1, by1, cvalid, tile_x0, tile_y0, tw, th)  # (B, n_tiles, C)
    chunk_idx, counts = first_k_true(ov, Kc)
    return coef.contiguous(), chunk_idx.int().contiguous(), counts.int().contiguous()


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def resolve_plain(coef: torch.Tensor, chunk_idx: torch.Tensor, counts: torch.Tensor,
                  image_size: tuple[int, int], tile: tuple[int, int], with_attr: bool = False):
    """The kernel's function in plain PyTorch, on any device.

    Loops over chunk slots and their 8 rows; each step gathers one row per
    (item, tile), spreads its lanes to the tile's pixels and updates with
    torch.where. Every plane is ((a*x + b*y) + c) in separately rounded ops,
    as in the kernel. Returns (rgb (B,3,H,W) clipped to [0,1], depth (B,H,W),
    attr (B,H,W) or None).
    """
    H, W = image_size
    th, tw = tile
    nty, ntx = tile_grid(image_size, tile)
    B = coef.shape[0]
    dev = coef.device
    ys = torch.arange(H, device=dev)
    xs = torch.arange(W, device=dev)
    tile_of = (ys // th)[:, None] * ntx + (xs // tw)[None, :]  # (H, W)
    py = (ys.float() + 0.5)[:, None]
    px = (xs.float() + 0.5)[None, :]
    live = counts.long()[:, tile_of]  # (B, H, W)

    iz = torch.zeros(B, H, W, device=dev)
    colz = [torch.zeros(B, H, W, device=dev) for _ in range(3)]
    attr = torch.zeros(B, H, W, device=dev)
    n_max = int(counts.max()) if counts.numel() else 0
    for k in range(n_max):
        active = k < live
        first_row = chunk_idx[:, :, k].long() * CHUNK  # (B, n_tiles)
        for j in range(CHUNK):
            row = torch.gather(coef, 1, (first_row + j)[..., None].expand(-1, -1, COEF_DIM))

            def lane(i):  # lane i of each tile's row, spread to its pixels: (B, H, W)
                return row[:, :, i][:, tile_of]

            def plane(a, b, c):
                return lane(a) * px + lane(b) * py + lane(c)

            lmin = torch.minimum(plane(0, 3, 6), torch.minimum(plane(1, 4, 7), plane(2, 5, 8)))
            izv = plane(9, 10, 11)
            win = active & (lmin >= -1e-6) & (izv > iz)
            iz = torch.where(win, izv, iz)
            for c in range(3):
                colz[c] = torch.where(win, plane(12 + c, 15 + c, 18 + c), colz[c])
            if with_attr:
                attr = torch.where(win, lane(21), attr)

    hit = iz > 0.0
    safe = iz.clamp_min(1e-12)
    depth = torch.where(hit, torch.reciprocal(safe), 0.0)
    rgb = torch.stack([torch.where(hit, c / safe, 0.0) for c in colz], dim=1).clamp(0.0, 1.0)
    return rgb, depth, (torch.where(hit, attr, 0.0) if with_attr else None)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------


def build_library() -> tuple[pathlib.Path, str]:
    """Compile csrc/rasterizer.cu into build/ if that build is missing.

    Returns (path of the shared library, nvcc's report: '' when the build
    was already there). The file name carries a hash of source and flags.
    """
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libcosypose_raster_{digest}.so"
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    tmp = BUILD_DIR / f"libcosypose_raster_{digest}.{os.getpid()}.so"
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr


class RasterKernel:
    """ctypes binding of csrc/rasterizer.cu with a count of launches for each of
    its two variants: 'raster_resolve' and 'raster_resolve_attr' (WITH_ATTR)."""

    def __init__(self):
        self.launches = {"raster_resolve": 0, "raster_resolve_attr": 0}
        self._fn = None

    def load(self):
        if self._fn is None:
            path, _ = build_library()
            fn = ctypes.CDLL(str(path)).cosypose_raster_resolve
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, coef: torch.Tensor, chunk_idx: torch.Tensor, counts: torch.Tensor,
                 image_size: tuple[int, int], tile: tuple[int, int], with_attr: bool = False):
        H, W = image_size
        th, tw = tile
        nty, ntx = tile_grid(image_size, tile)
        n_tiles = nty * ntx
        if not coef.is_cuda:
            raise ValueError("the raster kernel takes CUDA tensors")
        for name, x, dtype, ndim in (("coef", coef, torch.float32, 3),
                                     ("chunk_idx", chunk_idx, torch.int32, 3),
                                     ("counts", counts, torch.int32, 2)):
            if x.device != coef.device or x.dtype != dtype or x.ndim != ndim or not x.is_contiguous():
                raise ValueError(f"{name}: want a contiguous {ndim}-d {dtype} tensor on "
                                 f"{coef.device}, got {x.dtype} {tuple(x.shape)} on {x.device}")
        B, Fp, dim = coef.shape
        Kc = chunk_idx.shape[2]
        if dim != COEF_DIM or Fp % CHUNK or chunk_idx.shape[:2] != (B, n_tiles) \
                or counts.shape != (B, n_tiles) or not 0 < th * tw <= 1024 or B > 65535:
            raise ValueError(f"shapes do not fit: coef {tuple(coef.shape)}, chunk_idx "
                             f"{tuple(chunk_idx.shape)}, counts {tuple(counts.shape)}, "
                             f"tile {tile}, image {image_size}")
        fn = self.load()
        rgb = torch.empty(B, 3, H, W, device=coef.device)
        depth = torch.empty(B, H, W, device=coef.device)
        attr = torch.empty(B, H, W, device=coef.device) if with_attr else None
        err = fn(coef.data_ptr(), chunk_idx.data_ptr(), counts.data_ptr(), rgb.data_ptr(),
                 depth.data_ptr(), attr.data_ptr() if with_attr else None,
                 B, Fp, n_tiles, Kc, H, W, th, tw, ntx, int(with_attr),
                 coef.device.index or 0, torch.cuda.current_stream(coef.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"raster kernel launch failed: cudaError {err}")
        self.launches["raster_resolve_attr" if with_attr else "raster_resolve"] += 1
        return rgb, depth, attr


RASTER_KERNEL = RasterKernel()


def resolve(coef, chunk_idx, counts, image_size, tile, with_attr=False):
    """The kernel on CUDA tensors, its plain version on CPU tensors."""
    if coef.is_cuda:
        return RASTER_KERNEL(coef, chunk_idx, counts, image_size, tile, with_attr)
    if coef.device.type == "cpu":
        return resolve_plain(coef, chunk_idx, counts, image_size, tile, with_attr)
    raise ValueError(f"no rasterizer for device {coef.device}")

