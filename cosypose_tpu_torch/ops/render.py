"""Rendering dispatcher by tensor device (port of cosypose_tpu/ops/render.py).

The PyTorch prologue bins the triangles (ops/rasterizer_cuda.prepare); then
CUDA tensors go to the hand-written kernel (csrc/rasterizer.cu) and CPU
tensors to its plain PyTorch version (ops/rasterizer_cuda.resolve). There is
no fallback: a CUDA input that the kernel refuses raises.
"""

from __future__ import annotations

from .rasterizer import RenderOutput
from .rasterizer_cuda import prepare, resolve


def render(tri_verts, tri_valid, TCO, K, image_size=(240, 320), colors=None,
           tile=(16, 32), max_tris_per_tile=1024, z_near=0.05,
           tri_attr=None) -> RenderOutput:
    """tri_verts (B,F,3,3), tri_valid (B,F), TCO (B,4,4), K (B,3,3) → RenderOutput
    with rgb (B,3,H,W), depth and mask (B,H,W), attr (B,H,W) when tri_attr is given."""
    coef, chunk_idx, counts = prepare(tri_verts, tri_valid, TCO, K, image_size, colors,
                                      tile, max_tris_per_tile, z_near, tri_attr)
    rgb, depth, attr = resolve(coef, chunk_idx, counts, image_size, tile,
                               with_attr=tri_attr is not None)
    return RenderOutput(rgb=rgb, depth=depth, mask=depth > 0, attr=attr)
