"""Fixed-shape batched mesh database on a device (port of cosypose_tpu/ops/mesh_db.py).

Meshes are loaded on the host, converted to meters, padded to a common point
count (random-resample padding) and a common symmetry count (identity padding
with a validity mask), and stored as tensors:

    points     (n_objects, P_max, 3) float32
    valid      (n_objects, P_max)    bool
    symmetries (n_objects, S_max, 4, 4) float32
    sym_valid  (n_objects, S_max)    bool
    tri_verts  (n_objects, F_max, 3, 3) float32  triangle-major corner positions
    tri_colors (n_objects, F_max, 3, 3) float32  per-corner albedo
    tri_valid  (n_objects, F_max)    bool
    (the three tri_* are None when built with keep_geometry=False)

The host-side construction is the JAX package's, call for call, so both
packages draw the same random padding, the same surface samples and the same
decimated geometry.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..utils.device import resolve_device
from .mesh_io import decimate_mesh, load_mesh
from .symmetries import make_bop_symmetries


@dataclasses.dataclass
class MeshSpec:
    """Host-side description of one object."""

    label: str
    mesh_path: str | None = None
    mesh_units: str = "mm"
    symmetries_discrete: list | None = None
    symmetries_continuous: list | None = None
    diameter_m: float | None = None
    vertices: np.ndarray | None = None  # (V, 3) in mesh units
    faces: np.ndarray | None = None  # (F, 3) int
    colors: np.ndarray | None = None  # (V, 3) albedo in [0, 1]


_FIELDS = ("points", "valid", "symmetries", "sym_valid", "tri_verts", "tri_colors",
           "tri_valid")


@dataclasses.dataclass
class BatchedMeshes:
    """Padded mesh set on one device, with a label → id mapping."""

    labels: list
    points: torch.Tensor
    valid: torch.Tensor
    symmetries: torch.Tensor
    sym_valid: torch.Tensor
    tri_verts: torch.Tensor | None = None
    tri_colors: torch.Tensor | None = None
    tri_valid: torch.Tensor | None = None
    infos: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self.label_to_id = {l: i for i, l in enumerate(self.labels)}

    @property
    def device(self) -> torch.device:
        return self.points.device

    def to(self, device) -> "BatchedMeshes":
        moved = {k: None if getattr(self, k) is None else getattr(self, k).to(device)
                 for k in _FIELDS}
        return BatchedMeshes(self.labels, infos=self.infos, **moved)

    @property
    def n_objects(self) -> int:
        return self.points.shape[0]

    @property
    def n_sym(self) -> int:
        return self.symmetries.shape[1]

    def ids_for(self, labels: Sequence[str]) -> torch.Tensor:
        return torch.tensor([self.label_to_id[l] for l in labels], dtype=torch.long,
                            device=self.device)

    def select(self, label_ids: torch.Tensor) -> "SelectedMeshes":
        """Each candidate's points, validity and symmetries, gathered by object id
        on the meshes' device."""
        label_ids = torch.as_tensor(label_ids, dtype=torch.long, device=self.device)
        return SelectedMeshes(self.points[label_ids], self.valid[label_ids],
                              self.symmetries[label_ids], self.sym_valid[label_ids])

    def sample_points(self, label_ids: torch.Tensor, n_points: int, deterministic: bool = True,
                      seed: int = 0) -> torch.Tensor:
        """Per-candidate point subsets: column ids drawn on the host as the JAX
        package draws them (RandomState(0), or RandomState(seed) when not
        deterministic), gathered on the device."""
        P = self.points.shape[1]
        rng = np.random.RandomState(0 if deterministic else seed)
        ids = torch.as_tensor(rng.choice(P, size=min(n_points, P), replace=False),
                              device=self.device)
        return self.points[label_ids][:, ids]


@dataclasses.dataclass
class SelectedMeshes:
    points: torch.Tensor      # (B, P, 3)
    valid: torch.Tensor       # (B, P)
    symmetries: torch.Tensor  # (B, S, 4, 4)
    sym_valid: torch.Tensor   # (B, S)


def _pad_points(arrs: list[np.ndarray], rng: np.random.RandomState):
    """Pad to the max row count by resampling existing rows, plus a validity mask."""
    n_max = max(a.shape[0] for a in arrs)
    out, valid = [], []
    for a in arrs:
        n_orig = a.shape[0]
        if n_max > n_orig:
            a = np.concatenate([a, a[rng.choice(n_orig, size=n_max - n_orig)]], axis=0)
        out.append(a)
        valid.append(np.arange(n_max) < n_orig)
    return np.stack(out), np.stack(valid)


def _pad_with(arrs: list[np.ndarray], fill: np.ndarray):
    n_max = max(a.shape[0] for a in arrs)
    out, valid = [], []
    for a in arrs:
        n_orig = a.shape[0]
        if n_max > n_orig:
            pad = np.broadcast_to(fill, (n_max - n_orig,) + fill.shape)
            a = np.concatenate([a, pad], axis=0)
        out.append(a)
        valid.append(np.arange(n_max) < n_orig)
    return np.stack(out), np.stack(valid)


def aabb_corners(verts: np.ndarray) -> np.ndarray:
    """The 8 corners of the vertices' axis-aligned box, in the reference's
    corner order (ops/mesh_ops.get_meshes_bounding_boxes's)."""
    (x0, y0, z0), (x1, y1, z1) = verts.min(0), verts.max(0)
    return np.array([(x0, y1, z1), (x1, y1, z1), (x1, y0, z1), (x0, y0, z1),
                     (x0, y1, z0), (x1, y1, z0), (x1, y0, z0), (x0, y0, z0)])


def build_mesh_db(specs: Sequence[MeshSpec], aabb: bool = False,
                  resample_n_points: int | None = None, n_sym: int = 64,
                  keep_geometry: bool = True, max_faces: int | None = 8192,
                  render_max_faces: int | None = None,
                  device: str | torch.device = "cuda") -> BatchedMeshes:
    """Load and convert all objects and assemble the padded tensors on `device`.

    Points are the 8 AABB corners with aabb=True (RANSAC and bundle
    adjustment), resample_n_points area-weighted surface samples, else the raw
    vertices. keep_geometry=False leaves out the triangles. render_max_faces
    decimates the RENDER geometry only (tri_verts/tri_colors); the point sets
    keep full fidelity.
    """
    if aabb and resample_n_points is not None:
        raise ValueError("aabb and resample_n_points exclude each other")
    device = resolve_device(device)
    rng = np.random.RandomState(0)
    labels, points_l, syms_l, triverts_l, tricols_l = [], [], [], [], []
    infos = {}
    for spec in specs:
        if spec.vertices is not None:
            verts = np.asarray(spec.vertices, dtype=np.float64)
            faces = np.asarray(spec.faces if spec.faces is not None else np.zeros((0, 3)),
                               dtype=np.int64)
            colors = spec.colors
        else:
            verts, faces, colors = load_mesh(spec.mesh_path, with_colors=True)
        scale = {"mm": 0.001, "m": 1.0}[spec.mesh_units]
        verts = verts * scale
        if max_faces is not None and faces.shape[0] > max_faces:
            verts, faces, colors = decimate_mesh(verts, faces, colors, max_faces)
        if aabb:
            pts = aabb_corners(verts)
        elif resample_n_points:
            pts = _sample_surface(verts, faces, resample_n_points, rng)
        else:
            pts = verts

        syms = make_bop_symmetries(
            {"symmetries_discrete": spec.symmetries_discrete,
             "symmetries_continuous": spec.symmetries_continuous},
            n_symmetries_continuous=n_sym, scale=scale,
        )
        labels.append(spec.label)
        points_l.append(pts.astype(np.float32))
        syms_l.append(syms)

        if keep_geometry:
            rverts, rfaces, rcolors = verts, faces, colors
            if render_max_faces is not None and faces.shape[0] > render_max_faces:
                rverts, rfaces, rcolors = decimate_mesh(verts, faces, colors, render_max_faces)
            f = rfaces.astype(np.int64)
            triverts_l.append(rverts.astype(np.float32)[f])
            if rcolors is not None:
                tricols_l.append(rcolors.astype(np.float32)[f])
            else:
                tricols_l.append(np.full((f.shape[0], 3, 3), 0.7, np.float32))

        diameter_m = spec.diameter_m
        if diameter_m is None:
            sub = pts[:: max(1, pts.shape[0] // 1500)]
            diameter_m = float(np.sqrt(((sub[:, None] - sub[None]) ** 2).sum(-1).max()))
        infos[spec.label] = dict(label=spec.label, n_points=pts.shape[0],
                                 n_sym=syms.shape[0], diameter_m=diameter_m)

    points, valid = _pad_points(points_l, rng)
    symmetries, sym_valid = _pad_with(syms_l, np.eye(4, dtype=np.float32))

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    geometry = {}
    if keep_geometry:
        # degenerate zero-area padding triangles: the rasterizer masks them out
        tri_verts, tri_valid = _pad_with(triverts_l, np.zeros((3, 3), np.float32))
        tri_colors, _ = _pad_with(tricols_l, np.zeros((3, 3), np.float32))
        geometry = dict(tri_verts=dev(tri_verts), tri_colors=dev(tri_colors),
                        tri_valid=dev(tri_valid))
    return BatchedMeshes(labels, dev(points), dev(valid), dev(symmetries), dev(sym_valid),
                         infos=infos, **geometry)


def _sample_surface(verts: np.ndarray, faces: np.ndarray, n: int,
                    rng: np.random.RandomState) -> np.ndarray:
    """Area-weighted uniform surface sampling, the JAX package's draws."""
    if faces.shape[0] == 0:
        return verts[rng.choice(verts.shape[0], size=n)]
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    areas = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=-1)
    face_ids = rng.choice(faces.shape[0], size=n, p=areas / max(areas.sum(), 1e-12))
    r1 = np.sqrt(rng.uniform(size=(n, 1)))
    r2 = rng.uniform(size=(n, 1))
    a, b, c = v0[face_ids], v1[face_ids], v2[face_ids]
    return (1 - r1) * a + r1 * (1 - r2) * b + r1 * r2 * c
