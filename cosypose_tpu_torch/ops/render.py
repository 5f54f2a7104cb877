"""Rendering dispatcher by tensor device (port of cosypose_tpu/ops/render.py).

Two steps (ops/rasterizer_cuda.py): the triangle setup, which also sorts the
rows by projected y-centre (a stable order), and the binned depth resolve
through that order. CUDA tensors go through the two hand-written kernels
(csrc/raster_setup.cu, csrc/raster_resolve.cu), two launches a render, and
CPU tensors through their plain PyTorch versions, both behind the registered
operators cosypose::raster_setup and cosypose::raster_resolve, so that
torch.export takes a render in as two calls. There is no fallback: a CUDA
input that a kernel refuses raises. The render has no gradient (the kernels
are outside autograd, and the JAX package's train forward stops the gradient
at the pose and intrinsics it renders from): an input that would carry one is
refused rather than cut silently.
"""

from __future__ import annotations

import torch

from .rasterizer import RenderOutput
from .rasterizer_cuda import resolve, setup


def render(tri_verts, tri_valid, TCO, K, image_size=(240, 320), colors=None,
           tile=(16, 32), max_tris_per_tile=1024, z_near=0.05,
           tri_attr=None) -> RenderOutput:
    """tri_verts (B,F,3,3), tri_valid (B,F), TCO (B,4,4), K (B,3,3) → RenderOutput
    with rgb (B,3,H,W), depth and mask (B,H,W), attr (B,H,W) when tri_attr is given.

    A tile that touches more than max_tris_per_tile triangles (in chunks of 8
    sorted rows) drops the highest chunks, as the JAX package's binning does.
    """
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (tri_verts, TCO, K, colors, tri_attr)):
        raise ValueError("render has no gradient: pass inputs that do not require grad "
                         "(detach them, or call it under torch.no_grad())")
    rows, _, order = setup(tri_verts, tri_valid, TCO, K, image_size, colors, z_near, tri_attr)
    rgb, depth, attr = resolve(rows, order, image_size, tile, max_tris_per_tile,
                               with_attr=tri_attr is not None)
    return RenderOutput(rgb=rgb, depth=depth, mask=depth > 0, attr=attr)
