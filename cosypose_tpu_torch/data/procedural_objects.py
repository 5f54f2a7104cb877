"""Procedural object set for data-free synthetic training (port of
cosypose_tpu/data/procedural_objects.py: the same RandomState draws in the
same order, so the specs are equal bit for bit).

The reference's recording configs assume downloaded BOP model packs
(ref: cosypose/scripts/run_dataset_recording.py:22-59 +
datasets_cfg.make_object_dataset). For environments without the packs (CI,
smoke runs, the framework's own end-to-end accuracy regression) this module
generates a reproducible family of closed superellipsoid meshes — varied
aspect ratios, squareness exponents, axial twist and per-vertex albedo — that
exercise the full pipeline (distinct silhouettes for the detector, curvature
and asymmetry for pose refinement).

Meshes follow the BOP convention used everywhere else in the package:
vertices in millimeters, labels ``obj_XXXXXX``.
"""

from __future__ import annotations

import numpy as np

from ..ops.mesh_db import MeshSpec


def _superellipsoid(rng, n_theta=20, n_phi=32):
    """Watertight superellipsoid with random shape parameters → (V, F)."""
    # radii 25-60 mm per axis, squareness exponents in [0.4, 1.6]
    radii = rng.uniform(0.025, 0.06, size=3) * 1000.0  # mm
    e1 = rng.uniform(0.4, 1.6)   # north-south squareness
    e2 = rng.uniform(0.4, 1.6)   # east-west squareness
    twist = rng.uniform(-0.8, 0.8)  # axial twist rad over full height

    def spow(x, e):
        return np.sign(x) * np.abs(x) ** e

    thetas = np.linspace(-np.pi / 2, np.pi / 2, n_theta)
    phis = np.linspace(0, 2 * np.pi, n_phi, endpoint=False)
    T, P = np.meshgrid(thetas, phis, indexing="ij")
    x = spow(np.cos(T), e1) * spow(np.cos(P), e2)
    y = spow(np.cos(T), e1) * spow(np.sin(P), e2)
    z = spow(np.sin(T), e1)
    # axial twist breaks the z-rotational near-symmetry of round exponents
    ang = twist * z
    xr = x * np.cos(ang) - y * np.sin(ang)
    yr = x * np.sin(ang) + y * np.cos(ang)
    verts = np.stack([xr * radii[0], yr * radii[1], z * radii[2]],
                     axis=-1).reshape(-1, 3)

    faces = []
    for i in range(n_theta - 1):
        for j in range(n_phi):
            a = i * n_phi + j
            b = i * n_phi + (j + 1) % n_phi
            c = (i + 1) * n_phi + j
            d = (i + 1) * n_phi + (j + 1) % n_phi
            faces.append((a, b, c))
            faces.append((b, d, c))
    return verts.astype(np.float64), np.asarray(faces, np.int64)


def _vertex_colors(verts, rng):
    """Two-tone albedo split along a random plane + mild per-vertex noise —
    gives every object an orientation-revealing appearance."""
    n = rng.normal(size=3)
    n /= np.linalg.norm(n)
    side = (verts @ n) > 0
    c0 = rng.uniform(0.15, 0.95, size=3)
    c1 = rng.uniform(0.15, 0.95, size=3)
    colors = np.where(side[:, None], c0[None], c1[None])
    colors = np.clip(colors + rng.normal(0, 0.03, colors.shape), 0, 1)
    return colors.astype(np.float32)


def _vertex_colors_sine(verts, rng):
    """Dense 3-axis sinusoidal albedo field — rotation-determining texture.

    Measured motivation: the two-tone objects are rotationally near-ambiguous
    in appearance — photometric hypothesis ranking over 24 rotations leaves a
    best-of median of 88° even against a perfectly matched self-render, and
    every first-order alignment statistic (LK pyramid, finite-difference
    render Jacobians) carries R²≈0 rotation signal on recorded frames. A
    smooth multi-frequency color field c_j = 0.5 + 0.45·sin(2π f_j·v + φ_j)
    with periods 12–25 mm breaks all rotational symmetry with oriented
    features visible from every viewpoint, and survives the recording blur
    (periods ≫ the ~2 px antialiasing scale)."""
    colors = np.empty((len(verts), 3), np.float32)
    for j in range(3):
        f = rng.normal(size=3)
        f /= np.linalg.norm(f)
        period = rng.uniform(12.0, 25.0)  # mm
        phase = rng.uniform(0, 2 * np.pi)
        colors[:, j] = 0.5 + 0.45 * np.sin(
            2 * np.pi * (verts @ f) / period + phase)
    return np.clip(colors, 0, 1).astype(np.float32)


def make_procedural_specs(n_objects: int = 8, seed: int = 0,
                          texture: str = "twotone") -> list[MeshSpec]:
    """Reproducible procedural object set → MeshSpecs for build_mesh_db.

    texture: 'twotone' (plane-split albedo) | 'sine' (dense 3-axis sinusoid,
    rotation-determining — see _vertex_colors_sine)."""
    color_fn = {"twotone": _vertex_colors, "sine": _vertex_colors_sine}[texture]
    specs = []
    for i in range(n_objects):
        rng = np.random.RandomState(seed * 1000 + i)
        verts, faces = _superellipsoid(rng)
        specs.append(
            MeshSpec(
                label=f"obj_{i + 1:06d}",
                vertices=verts,
                faces=faces,
                colors=color_fn(verts, rng),
            )
        )
    return specs


class ProceduralObjectDataset:
    """Object-dataset shim exposing the same mesh_specs() surface as
    BOPObjectDataset, so recording/training CLIs can run data-free."""

    def __init__(self, n_objects: int = 8, seed: int = 0,
                 texture: str = "twotone"):
        self.specs = make_procedural_specs(n_objects, seed, texture=texture)
        self.labels = [s.label for s in self.specs]

    def mesh_specs(self):
        return self.specs

    def __len__(self):
        return len(self.specs)
