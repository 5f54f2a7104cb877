"""Domain-randomized synthetic scene sampling (port of
cosypose_tpu/recording/scene_sampler.py).

The JAX package's RecordingSceneSampler, draw for draw: the same
np.random.RandomState calls in the same order, so a seed gives the same
scene, the same cage and the same cameras. The reference's pybullet pile is a
sphere-proxy drop-and-stack pass; each scene renders with all its candidate
cameras in one SceneRenderer call (the resolve kernel's attribute variant,
instance ids in the same pass), and the amodal statistics (visibility
fraction, amodal box) come from one BatchRenderer call that renders every
object alone under every kept camera (the plain variant), reduced on the
device by `mask_stats`.

The sampler counts its render calls (`counts["scene_renders"]`,
`counts["amodal_renders"]`) and the wall time of each part of a scene
(`times`: "scene_render" and "amodal_render" include the host work around
the render call and the copy back, "sample" is all of sample_scene_frames),
so a caller can hold the kernels' launch counts to its calls and split a
frame's time.
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch

from ..rendering.scene_renderer import BatchRenderer, SceneRenderer
from .textures import TextureSampler, procedural_corner_colors


def mask_stats(mask: torch.Tensor):
    """(B, H, W) bool → per-item pixel count (B,) and xyxy bbox (B, 4) float32,
    on the mask's device."""
    B, H, W = mask.shape
    counts = mask.reshape(B, -1).sum(dim=1)
    row_any = mask.any(dim=2)  # (B, H)
    col_any = mask.any(dim=1)  # (B, W)
    yi = torch.arange(H, device=mask.device)
    xi = torch.arange(W, device=mask.device)
    big = 1 << 30
    ymin = torch.where(row_any, yi, big).amin(dim=1)
    ymax = torch.where(row_any, yi, -1).amax(dim=1)
    xmin = torch.where(col_any, xi, big).amin(dim=1)
    xmax = torch.where(col_any, xi, -1).amax(dim=1)
    bbox = torch.stack([xmin, ymin, xmax + 1, ymax + 1], dim=1)
    return counts, bbox.float()


class SceneSamplerError(RuntimeError):
    pass


def _grid_quad(origin, eu, ev, n=6):
    """Subdivided quad: origin + u*eu + v*ev, u,v ∈ [0,1] → (2n², 3, 3)."""
    origin, eu, ev = (np.asarray(a, np.float64) for a in (origin, eu, ev))
    us = np.linspace(0.0, 1.0, n + 1)
    tris = []
    for i in range(n):
        for j in range(n):
            p00 = origin + us[i] * eu + us[j] * ev
            p10 = origin + us[i + 1] * eu + us[j] * ev
            p01 = origin + us[i] * eu + us[j + 1] * ev
            p11 = origin + us[i + 1] * eu + us[j + 1] * ev
            tris.append([p00, p10, p11])
            tris.append([p00, p11, p01])
    return np.asarray(tris, np.float32)


class RecordingSceneSampler:
    def __init__(
        self,
        mesh_db,
        resolution=(480, 640),
        focal_interval=(1060.0, 1080.0),
        n_objects_interval=(2, 9),
        xyz_box=((-0.15, -0.15, 0.0), (0.15, 0.15, 0.15)),
        camera_distance_interval=(0.8, 2.4),
        min_visible_pixels=200,
        border_check=True,
        n_retries_cam=3,
        n_retries_scene=50,
        place_mode="pile",          # "pile" (drop-and-stack) | "floating"
        texture_sampler: TextureSampler | None = None,
        p_cage=0.9,                 # probability the cage walls are present
        amodal_stats=True,          # solo re-render for visib_fract/bbox_obj
        contact_scale=0.75,         # sphere-proxy shrink for resting contacts
        n_views_per_scene=1,        # frames recorded per sampled scene
    ):
        self.mesh_db = mesh_db
        self.renderer = SceneRenderer(mesh_db)
        self.batch_renderer = BatchRenderer(mesh_db, resolution=resolution)
        self.resolution = resolution
        self.focal_interval = focal_interval
        self.n_objects_interval = n_objects_interval
        self.xyz_box = np.asarray(xyz_box)
        self.camera_distance_interval = camera_distance_interval
        self.min_visible_pixels = min_visible_pixels
        self.border_check = border_check
        self.n_retries_cam = n_retries_cam
        self.n_retries_scene = n_retries_scene
        self.place_mode = place_mode
        self.texture_sampler = texture_sampler or TextureSampler(p_textured=0.0)
        self.p_cage = p_cage
        self.amodal_stats = amodal_stats
        self.contact_scale = contact_scale
        self.n_views_per_scene = n_views_per_scene
        # object bounding radii for placement
        pts = mesh_db.points.cpu().numpy()
        self.radii = np.linalg.norm(pts, axis=-1).max(axis=-1)
        self.counts = collections.Counter()
        self.times = collections.Counter()

    # -- placement -----------------------------------------------------------
    def _random_R(self, rng):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        x, y, z, w = q
        return np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
            ]
        )

    def _place_floating(self, labels, rng):
        """Rejection-sampled non-contact placement (round-1 behavior)."""
        placed = []
        for label in labels:
            oid = self.mesh_db.label_to_id[label]
            r = self.radii[oid]
            for _ in range(100):
                pos = rng.uniform(self.xyz_box[0], self.xyz_box[1])
                if all(np.linalg.norm(pos - p["t"]) > 0.6 * (r + p["r"])
                       for p in placed):
                    break
            else:
                raise SceneSamplerError("cannot place object without overlap")
            placed.append(dict(label=label, t=pos, r=r))
        return placed

    def _place_pile(self, labels, rng):
        """Sphere-proxy drop-and-stack: occlusion-rich resting piles.

        Each object falls at a random xy inside a shrunken working area and
        rests at the lowest z where its (contact-scaled) bounding sphere
        touches the ground plane or any already-placed sphere — the discrete
        fixed point of the reference's pybullet settle
        (ref: bop_recording_scene.py:118-135).
        """
        lo, hi = self.xyz_box
        cxy = (lo[:2] + hi[:2]) / 2
        half = (hi[:2] - lo[:2]) / 2
        placed = []
        for label in labels:
            oid = self.mesh_db.label_to_id[label]
            r = float(self.radii[oid]) * self.contact_scale
            # denser xy → more stacking/occlusion
            xy = cxy + rng.uniform(-0.7, 0.7, size=2) * half
            z = r
            for p in placed:
                d = np.linalg.norm(xy - p["t"][:2])
                R = r + p["r_c"]
                if d < R:
                    z = max(z, p["t"][2] + np.sqrt(max(R * R - d * d, 0.0)))
            placed.append(
                dict(label=label, t=np.array([xy[0], xy[1], z]),
                     r=self.radii[oid], r_c=r)
            )
        return placed

    def _sample_objects(self, rng):
        n_obj = rng.randint(*self.n_objects_interval)
        labels = [
            self.mesh_db.labels[rng.randint(len(self.mesh_db.labels))]
            for _ in range(n_obj)
        ]
        placed = (
            self._place_pile(labels, rng) if self.place_mode == "pile"
            else self._place_floating(labels, rng)
        )
        obj_infos = []
        for p in placed:
            TWO = np.eye(4, dtype=np.float32)
            TWO[:3, :3] = self._random_R(rng)
            TWO[:3, 3] = p["t"]
            info = dict(label=p["label"], TWO=TWO)
            oid = self.mesh_db.label_to_id[p["label"]]
            colors = self.texture_sampler.apply(self.renderer.tri_verts[oid], rng)
            if colors is not None:
                info["colors"] = colors
            obj_infos.append(info)
        return obj_infos

    def _cage_geometry(self, rng):
        """Textured ground plane (+ walls with prob p_cage), instance id 0
        (ref: bop_recording_scene.py:91-108)."""
        lo, hi = self.xyz_box
        s = 2.5 * float(max(hi[0] - lo[0], hi[1] - lo[1]))
        h = 1.5 * s
        c = (lo + hi) / 2
        quads = [
            _grid_quad([c[0] - s, c[1] - s, 0.0], [2 * s, 0, 0], [0, 2 * s, 0]),
        ]
        if rng.rand() < self.p_cage:
            quads += [
                _grid_quad([c[0] - s, c[1] - s, 0], [2 * s, 0, 0], [0, 0, h]),
                _grid_quad([c[0] - s, c[1] + s, 0], [2 * s, 0, 0], [0, 0, h]),
                _grid_quad([c[0] - s, c[1] - s, 0], [0, 2 * s, 0], [0, 0, h]),
                _grid_quad([c[0] + s, c[1] - s, 0], [0, 2 * s, 0], [0, 0, h]),
            ]
        geoms = []
        for q in quads:
            colors = self.texture_sampler.apply(q, rng)
            if colors is None:
                colors = procedural_corner_colors(q, rng)
            geoms.append(dict(geometry=dict(tri_verts=q, colors=colors)))
        return geoms

    def _sample_camera(self, rng):
        """Spherical sampling looking at the working volume center
        (ref: bop_recording_scene.py:137-156)."""
        h, w = self.resolution
        f = rng.uniform(*self.focal_interval) * max(self.resolution) / 640.0
        K = np.array(
            [[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], dtype=np.float32
        )
        d = rng.uniform(*self.camera_distance_interval)
        theta = rng.uniform(0, np.pi / 2.2)  # elevation from the up axis
        phi = rng.uniform(0, 2 * np.pi)
        eye = d * np.array(
            [np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi),
             np.cos(theta)]
        )
        target = self.xyz_box.mean(axis=0)
        # look-at: camera z toward target
        zc = target - eye
        zc = zc / np.linalg.norm(zc)
        up = np.array([0.0, 0.0, 1.0])
        xc = np.cross(zc, up)
        if np.linalg.norm(xc) < 1e-6:
            xc = np.array([1.0, 0.0, 0.0])
        xc = xc / np.linalg.norm(xc)
        yc = np.cross(zc, xc)
        TWC = np.eye(4, dtype=np.float32)
        TWC[:3, 0], TWC[:3, 1], TWC[:3, 2], TWC[:3, 3] = xc, yc, zc, eye
        return dict(K=K, TWC=TWC, resolution=self.resolution)

    # -- validity (ref: bop_recording_scene.py:158-181) --------------------
    def _valid_objects(self, render, n_objects):
        """Indices of objects passing the visibility/border checks.

        With occlusion-rich piles, buried objects are expected; rather than
        rejecting the whole frame (which would filter piles out of the data
        distribution), objects failing the checks are dropped from GT while
        remaining in the image as occluders — the frame is valid if at least
        one object passes.
        """
        ids = render["instance_ids"]
        h, w = ids.shape
        keep = []
        for n in range(1, n_objects + 1):
            ys, xs = np.where(ids == n)
            if len(ys) < self.min_visible_pixels:
                continue
            if self.border_check and (
                ys.min() == 0 or xs.min() == 0 or ys.max() == h - 1
                or xs.max() == w - 1
            ):
                continue
            keep.append(n - 1)
        return keep

    def _amodal_multi(self, obj_infos, cams):
        """Batched solo re-render → per-(view, object) amodal count + bbox.

        Replaces the reference's per-body visibility queries: ONE rasterizer
        call renders every object alone under every frame camera. The batch
        keeps the JAX package's padded shape, n_views_per_scene x
        max-object-count, with the padding far behind the camera (empty).
        """
        n = len(obj_infos)
        n_pad = int(self.n_objects_interval[1])
        v_pad = max(len(cams), int(self.n_views_per_scene))
        far = np.eye(4, dtype=np.float32)
        far[2, 3] = 1e3  # padded instances rendered far behind everything

        label_ids = np.zeros((v_pad, n_pad), np.int32)
        TCO = np.tile(far[None, None], (v_pad, n_pad, 1, 1))
        K = np.tile(np.eye(3, dtype=np.float32)[None, None],
                    (v_pad, n_pad, 1, 1))
        lids = np.array(
            [self.mesh_db.label_to_id[o["label"]] for o in obj_infos], np.int32
        )
        TWOs = np.stack([np.asarray(o["TWO"], np.float64) for o in obj_infos])
        for v, cam in enumerate(cams):
            TCW = np.linalg.inv(np.asarray(cam["TWC"], np.float64))
            label_ids[v, :n] = lids
            TCO[v, :n] = np.einsum("ij,njk->nik", TCW, TWOs).astype(np.float32)
            K[v] = np.asarray(cam["K"], np.float32)[None]

        t0 = time.perf_counter()
        out = self.batch_renderer.render(
            label_ids.reshape(-1), TCO.reshape(-1, 4, 4), K.reshape(-1, 3, 3),
            resolution=self.resolution, render_depth=True,
        )
        # counts and boxes reduced on the device: only (V*N, 5) numbers come back
        counts_d, bboxes_d = mask_stats(out.mask)
        counts = counts_d.cpu().numpy().reshape(v_pad, n_pad)
        bboxes = bboxes_d.cpu().numpy().reshape(v_pad, n_pad, 4)
        bboxes[counts == 0] = 0.0
        self.counts["amodal_renders"] += 1
        self.times["amodal_render"] += time.perf_counter() - t0
        return counts, bboxes

    def _build_frame(self, obj_infos, cam, render, valid_idx,
                     amodal_counts, amodal_boxes):
        rgb = (render["rgb"] * 255).astype(np.uint8)
        mask = render["instance_ids"]
        objects = []
        for n in valid_idx:
            obj = obj_infos[n]
            ys, xs = np.where(mask == n + 1)
            bbox = np.array(
                [xs.min(), ys.min(), xs.max() + 1, ys.max() + 1], np.float32
            )
            visib = 1.0
            bbox_obj = bbox
            if amodal_counts is not None:
                visib = float(len(ys) / max(int(amodal_counts[n]), 1))
                bbox_obj = amodal_boxes[n]
            objects.append(
                dict(
                    label=obj["label"],
                    TWO=obj["TWO"],
                    bbox=bbox,
                    bbox_obj=bbox_obj,
                    id_in_segm=n + 1,
                    visib_fract=min(visib, 1.0),
                )
            )
        obs = dict(
            objects=objects,
            camera=dict(K=cam["K"], TWC=cam["TWC"],
                        resolution=self.resolution,
                        depth=render["depth"]),
            frame_info={},
        )
        return rgb, mask, obs

    # -- public api ---------------------------------------------------------
    def sample_scene_frames(self, seed: int, n_views: int = 1):
        """One sampled scene, up to n_views validated camera frames.

        Multi-view recording amortizes scene setup and batches ALL candidate
        cameras into one rasterizer dispatch (render_scene stacks them) — the
        BOP PBR datasets are likewise many-views-per-scene. Returns a
        non-empty list of (rgb, mask, obs); raises after bounded retries
        (ref: bop_recording_scene.py:217-237).
        """
        t_start = time.perf_counter()
        try:
            return self._sample_scene_frames(np.random.RandomState(seed), n_views)
        finally:
            self.times["sample"] += time.perf_counter() - t_start

    def _sample_scene_frames(self, rng, n_views):
        for _ in range(self.n_retries_scene):
            try:
                obj_infos = self._sample_objects(rng)
            except SceneSamplerError:
                continue
            scene = list(obj_infos)
            if self.place_mode == "pile":
                scene = scene + self._cage_geometry(rng)
            frames = []
            for _ in range(self.n_retries_cam):
                # a full candidate batch every retry round, as in the JAX package
                cams = [self._sample_camera(rng) for _ in range(n_views)]
                t0 = time.perf_counter()
                renders = self.renderer.render_scene(
                    scene, cams, render_depth=True
                )
                self.counts["scene_renders"] += 1
                self.times["scene_render"] += time.perf_counter() - t0
                valids = [
                    (cam, render, self._valid_objects(render, len(obj_infos)))
                    for cam, render in zip(cams, renders)
                ]
                valids = [v for v in valids if v[2]]
                valids = valids[: n_views - len(frames)]
                counts = boxes = None
                if self.amodal_stats and valids:
                    counts, boxes = self._amodal_multi(
                        obj_infos, [v[0] for v in valids]
                    )
                for i, (cam, render, valid_idx) in enumerate(valids):
                    frames.append(
                        self._build_frame(
                            obj_infos, cam, render, valid_idx,
                            None if counts is None else counts[i],
                            None if boxes is None else boxes[i],
                        )
                    )
                if len(frames) >= n_views:
                    return frames
            if frames:
                return frames
        raise SceneSamplerError(
            f"no valid frame after {self.n_retries_scene} scene retries"
        )

    def sample_frame(self, seed: int):
        """→ (rgb uint8, instance mask, obs dict) with bounded retries
        (ref: bop_recording_scene.py:217-237)."""
        return self.sample_scene_frames(seed, n_views=1)[0]
