"""Procedural demo objects and inputs (the port's copy of `_sphere_mesh`,
`_demo_specs` and `_make_inputs` in the repo's `__graft_entry__.py`).

Two UV-spheres (5 cm and 7.5 cm radius, the second with a continuous
symmetry) and seeded random images/intrinsics/poses, as numpy arrays, so the
JAX package and the port can be fed identical inputs; `DemoPoseDataset`,
an in-memory training set of PoseDataset-shaped items made the same way;
`cube_specs`, two cubes for small recorded scenes; and `dense_specs`, closed
meshes of 8,192 faces for scene soups of ycbv-1M's size.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.pose_predictor import PosePredictor, gather_mesh_data
from .ops.camera import boxes_from_uv, get_K_crop_resize, project_points_robust
from .ops.cropping import deepim_boxes
from .ops.mesh_db import MeshSpec, build_mesh_db


def sphere_mesh(n_theta: int = 24, n_phi: int = 48, radius: float = 0.05):
    """UV-sphere: (verts (V,3) float64, faces (F,3) int64), ~2k triangles."""
    thetas = np.linspace(0, np.pi, n_theta)
    phis = np.linspace(0, 2 * np.pi, n_phi, endpoint=False)
    verts = np.asarray(
        [(radius * np.sin(t) * np.cos(p), radius * np.sin(t) * np.sin(p), radius * np.cos(t))
         for t in thetas for p in phis],
        dtype=np.float64,
    )
    faces = []
    for i in range(n_theta - 1):
        for j in range(n_phi):
            a = i * n_phi + j
            b = i * n_phi + (j + 1) % n_phi
            c = (i + 1) * n_phi + j
            d = (i + 1) * n_phi + (j + 1) % n_phi
            faces.append((a, b, c))
            faces.append((b, d, c))
    return verts, np.asarray(faces, dtype=np.int64)


def demo_specs() -> list[MeshSpec]:
    verts, faces = sphere_mesh()
    return [
        MeshSpec(label="obj_000001", vertices=verts * 1000.0, faces=faces),
        MeshSpec(label="obj_000002", vertices=verts * 1500.0, faces=faces,
                 symmetries_continuous=[{"axis": [0, 0, 1], "offset": [0, 0, 0]}]),
    ]


def cube_specs() -> list[MeshSpec]:
    """Two cubes of 10 and 15 cm, 12 triangles each (tests/test_pose_predictor.py's
    cube_specs): small scenes to record on the CPU."""
    s = 50.0  # mm
    verts = np.array([[x, y, z] for x in (-s, s) for y in (-s, s) for z in (-s, s)], np.float64)
    tris = []
    for a, b, c, d in [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6), (0, 2, 6, 4),
                       (1, 5, 7, 3)]:
        tris += [(a, b, c), (a, c, d)]
    return [MeshSpec(label="obj_000001", vertices=verts, faces=np.asarray(tris)),
            MeshSpec(label="obj_000002", vertices=verts * 1.5, faces=np.asarray(tris))]


# 65 x 64 vertices, 2 x 64 x 64 triangles: 8,192 faces a mesh, what
# build_mesh_db's default max_faces keeps (a YCB-V or T-LESS mesh decimated to it)
DENSE_GRID = (65, 64)


def dense_specs(n_objects: int = 8, seed: int = 0) -> list[MeshSpec]:
    """n_objects closed superellipsoids of 8,192 faces each, with two-tone
    albedo (data/procedural_objects.py's shapes and colours at a 65 x 64
    vertex grid): scene soups of the size ycbv-1M and tless-1M record (up to
    8 x 8,192 rows and the cage) without the YCB-V or T-LESS meshes."""
    from .data.procedural_objects import _superellipsoid, _vertex_colors

    specs = []
    for i in range(n_objects):
        rng = np.random.RandomState(seed * 1000 + i)
        verts, faces = _superellipsoid(rng, *DENSE_GRID)
        specs.append(MeshSpec(label=f"obj_{i + 1:06d}", vertices=verts, faces=faces,
                              colors=_vertex_colors(verts, rng)))
    return specs


@torch.no_grad()
def demo_weights(pp: PosePredictor, mesh_data: dict, images: torch.Tensor, K: torch.Tensor,
                 TCO: torch.Tensor, generator: torch.Generator, out_std: float = 0.02) -> None:
    """Draw a random pose kernel that moves poses, as a trained head does.

    The identity-initialised head (zero kernel) leaves TCO unchanged, and at a
    random init the pooled features are tiny (~1e-8: each squeeze-excite gate
    halves the signal). The kernel is drawn from a normal with `generator` (on
    the CPU) and scaled so that, on the network's own first-iteration input
    for these poses, the head's output moves by about `out_std` around the
    identity update.
    """
    x = pp.network_input(mesh_data, images, K, TCO)[0]
    rms = pp.net.pooled_features(x).pow(2).mean().sqrt()
    fc = pp.net.pose_fc
    w = torch.randn(fc.weight.shape, generator=generator)
    fc.weight.copy_(w.to(fc.weight.device) * (out_std / (rms * fc.in_features ** 0.5)))


def make_inputs(B: int, H: int = 480, W: int = 640):
    """(images (B,3,H,W) f32, K (B,3,3) f32, TCO (B,4,4) f32, label_ids (B,) int32)."""
    rng = np.random.RandomState(0)
    K = np.zeros((B, 3, 3), np.float32)
    K[:, 0, 0] = K[:, 1, 1] = 600.0
    K[:, 0, 2], K[:, 1, 2], K[:, 2, 2] = W / 2, H / 2, 1.0
    TCO = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    TCO[:, 0, 3] = rng.uniform(-0.1, 0.1, B)
    TCO[:, 1, 3] = rng.uniform(-0.1, 0.1, B)
    TCO[:, 2, 3] = rng.uniform(0.5, 1.2, B)
    images = rng.uniform(size=(B, 3, H, W)).astype(np.float32)
    label_ids = rng.randint(0, 2, B).astype(np.int32)
    return images, K, TCO, label_ids


def first_render_inputs(B: int, image_size=(480, 640), render_size=(240, 320), lod: int = 512,
                        device="cuda") -> dict:
    """The first iteration's render call at the demo inputs of make_inputs,
    with the crop intrinsics PosePredictor.network_input computes: dict of
    tri_verts, tri_valid, TCO, K_crop and colors on `device`."""
    db = build_mesh_db(demo_specs(), render_max_faces=lod, device=device)
    _, K_np, TCO_np, labels_np = make_inputs(B, *image_size)
    K = torch.as_tensor(K_np, device=device)
    TCO = torch.as_tensor(TCO_np, device=device)
    md = gather_mesh_data(db, torch.as_tensor(labels_np, device=device).long(), 2000)
    boxes_rend = boxes_from_uv(project_points_robust(md["crop_points"], K, TCO))
    centers = project_points_robust(torch.zeros(B, 1, 3, device=device), K, TCO)
    K_crop = get_K_crop_resize(K, deepim_boxes(centers, boxes_rend, boxes_rend, image_size),
                               image_size, render_size).contiguous()
    return dict(tri_verts=md["tri_verts"], tri_valid=md["tri_valid"], TCO=TCO, K_crop=K_crop,
                colors=md["tri_colors"])


class DemoPoseDataset:
    """n PoseDataset-shaped items made in memory from a seed: {image (3,H,W)
    uint8, K (3,3), TCO (4,4) float32, bbox (4,) float32, label}.

    Poses, intrinsics and labels are drawn as `make_inputs` draws them (f =
    600 px at the image centre, identity rotation, x, y in ±0.1 m, z in
    0.5–1.2 m); images are uniform noise; the bbox is the box of the object's
    mesh points projected at its pose.
    """

    def __init__(self, n: int, image_size=(480, 640), seed: int = 0, specs=None):
        specs = specs if specs is not None else demo_specs()
        H, W = image_size
        rng = np.random.RandomState(seed)
        self.K = np.zeros((n, 3, 3), np.float32)
        self.K[:, 0, 0] = self.K[:, 1, 1] = 600.0
        self.K[:, 0, 2], self.K[:, 1, 2], self.K[:, 2, 2] = W / 2, H / 2, 1.0
        self.TCO = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
        self.TCO[:, 0, 3] = rng.uniform(-0.1, 0.1, n)
        self.TCO[:, 1, 3] = rng.uniform(-0.1, 0.1, n)
        self.TCO[:, 2, 3] = rng.uniform(0.5, 1.2, n)
        label_ids = rng.randint(0, len(specs), n)
        self.labels = [specs[i].label for i in label_ids]
        self.images = rng.randint(0, 256, (n, 3, H, W), dtype=np.uint8)
        scale = {"mm": 0.001, "m": 1.0}
        pts = [np.asarray(s.vertices, np.float64) * scale[s.mesh_units] for s in specs]
        self.bboxes = np.zeros((n, 4), np.float32)
        for i, obj in enumerate(label_ids):
            cam = pts[obj] @ self.TCO[i, :3, :3].T.astype(np.float64) + self.TCO[i, :3, 3]
            uvw = cam @ self.K[i].T.astype(np.float64)
            uv = uvw[:, :2] / uvw[:, 2:3]
            self.bboxes[i] = np.concatenate([uv.min(0), uv.max(0)])

    def __len__(self):
        return len(self.labels)

    def __getitem__(self, idx):
        return dict(image=self.images[idx], K=self.K[idx], TCO=self.TCO[idx],
                    bbox=self.bboxes[idx], label=self.labels[idx])
