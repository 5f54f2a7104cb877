"""Texture domain randomization for synthetic recording (port of
cosypose_tpu/recording/textures.py: numpy only, the same RandomState draws in
the same order).

Capability match for the reference's texture randomization — it applies random
ShapeNet texture images + specular/shininess to every body and cage plane with
probability p_textured (ref: cosypose/simulator/textures.py:6-23,
bop_recording_scene.py:91-108,127-135). The rebuild's rasterizer interpolates
per-corner colors (no UV pipeline), so textures are BAKED ONTO GEOMETRY at
sampling time:

  * procedural mode: band-limited value noise (random 3D cosine series)
    evaluated at triangle corners, mapped through a random two-color ramp —
    gives blotch/stripe/gradient families similar in spirit to randomized
    texture images;
  * image mode: a texture image (data/texture_dataset.py) is projected onto
    the mesh by tri-planar mapping (dominant-normal-axis UV), sampled at the
    corners.

Baking at corners is exact for the renderer (it is the same linear
interpolation the rasterizer performs) as long as triangles are small relative
to texture frequency — mesh_db geometry is decimated to a bounded triangle
budget, so low frequencies are used by default.
"""

from __future__ import annotations

import numpy as np


def _value_noise(points: np.ndarray, rng: np.random.RandomState,
                 n_waves: int = 8, freq_range=(4.0, 40.0)) -> np.ndarray:
    """Random cosine-series noise in [0, 1] at 3D points (..., 3)."""
    scale = np.linalg.norm(points.reshape(-1, 3).max(0)
                           - points.reshape(-1, 3).min(0)) + 1e-9
    val = np.zeros(points.shape[:-1], np.float64)
    for _ in range(n_waves):
        f = rng.uniform(*freq_range) / scale
        w = rng.normal(size=3)
        w = f * w / (np.linalg.norm(w) + 1e-12)
        phi = rng.uniform(0, 2 * np.pi)
        val += rng.uniform(0.3, 1.0) * np.cos(points @ w + phi)
    lo, hi = val.min(), val.max()
    return ((val - lo) / (hi - lo + 1e-9)).astype(np.float32)


def procedural_corner_colors(tri_verts: np.ndarray,
                             rng: np.random.RandomState) -> np.ndarray:
    """Random two-color ramp over value noise → per-corner colors (F, 3, 3)."""
    c0 = rng.uniform(0.05, 0.95, size=3)
    c1 = rng.uniform(0.05, 0.95, size=3)
    t = _value_noise(np.asarray(tri_verts, np.float64), rng)  # (F, 3)
    # optional hard edges (binarized blotches) half the time
    if rng.rand() < 0.5:
        sharp = rng.uniform(4.0, 20.0)
        t = 1.0 / (1.0 + np.exp(-sharp * (t - 0.5)))
    return (c0[None, None] + (c1 - c0)[None, None] * t[..., None]).astype(
        np.float32
    )


def triplanar_corner_colors(tri_verts: np.ndarray, texture: np.ndarray,
                            rng: np.random.RandomState) -> np.ndarray:
    """Project a texture image onto corners by dominant-axis planar mapping.

    tri_verts (F, 3, 3) object/world-frame corners; texture (H, W, 3) float
    in [0, 1]. A random rotation decorrelates the projection axis from the
    object frame; per-face dominant normal axis picks which two coordinates
    become UV (standard tri-planar without blending — corner colors are
    interpolated by the rasterizer anyway).
    """
    tv = np.asarray(tri_verts, np.float64)
    A = rng.normal(size=(3, 3))
    Q, _ = np.linalg.qr(A)
    tvr = tv @ Q.T
    n = np.cross(tvr[:, 1] - tvr[:, 0], tvr[:, 2] - tvr[:, 0])  # (F, 3)
    axis = np.abs(n).argmax(axis=-1)  # (F,)
    uv_axes = np.array([[1, 2], [0, 2], [0, 1]])[axis]  # (F, 2)
    u = np.take_along_axis(tvr, uv_axes[:, None, 0:1], axis=2)[..., 0]  # (F,3)
    v = np.take_along_axis(tvr, uv_axes[:, None, 1:2], axis=2)[..., 0]
    span = max(np.ptp(tvr.reshape(-1, 3), axis=0).max(), 1e-9)
    tiling = rng.uniform(0.5, 3.0)
    H, W = texture.shape[:2]
    ui = (np.abs(u / span * tiling * W) % W).astype(np.int64)
    vi = (np.abs(v / span * tiling * H) % H).astype(np.int64)
    return texture[vi, ui].astype(np.float32)


class TextureSampler:
    """Per-instance texture randomization (ref: textures.py:6-23 behavior).

    With probability `p_textured` an object's colors are replaced; image
    textures are used when a texture dataset is provided, else procedural
    noise ramps. `apply(tri_verts, rng)` → (F, 3, 3) colors or None (keep
    the mesh's own colors).
    """

    def __init__(self, texture_dataset=None, p_textured: float = 0.8):
        self.texture_dataset = texture_dataset
        self.p_textured = p_textured

    def apply(self, tri_verts: np.ndarray,
              rng: np.random.RandomState) -> np.ndarray | None:
        if rng.rand() > self.p_textured:
            return None
        if self.texture_dataset is not None and len(self.texture_dataset) > 0:
            tex = self.texture_dataset.sample(rng)
            return triplanar_corner_colors(tri_verts, tex, rng)
        return procedural_corner_colors(tri_verts, rng)
