"""Multi-view visualization (port of cosypose_tpu/visualization/multiview.py):
nms3d, the greedy score-ordered suppression of predictions whose translations
lie within a threshold, on the host; and make_scene_renderings, orbit views
of a reconstructed scene through SceneRenderer (the attribute variant of the
resolve kernel on the card)."""

from __future__ import annotations

import numpy as np

from ..utils.tensor_collection import TensorCollection


def nms3d(preds: TensorCollection, th: float = 0.04, poses_attr: str = "poses"):
    """Keep the highest-scored prediction of each cluster of translations
    within `th` meters, in the JAX package's order (np.argsort of −score)."""
    TCO = getattr(preds, poses_attr).detach().cpu().numpy()
    all_t = TCO[:, :3, 3]
    tested, keep = set(), []
    for idx in np.argsort(-np.asarray(preds.infos["score"])):
        if idx in tested:
            continue
        dists = np.linalg.norm(TCO[idx, :3, 3] - all_t, axis=-1)
        dists[idx] = np.inf
        tested.update(int(j) for j in np.flatnonzero(dists <= th))
        keep.append(int(idx))
    return preds[np.asarray(keep, np.int64)]


def orbit_cameras(center, n_frames: int, resolution, orbit_radius: float):
    """The JAX package's orbit: n_frames cameras around `center`, looking at
    it from 0.6 · orbit_radius above, each {K, TWC, resolution}."""
    h, w = resolution
    f = 1.2 * max(resolution)
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)
    cams = []
    for i in range(n_frames):
        phi = 2 * np.pi * i / n_frames
        eye = center + orbit_radius * np.array([np.cos(phi) * 0.8, np.sin(phi) * 0.8, -0.6])
        zc = center - eye
        zc = zc / np.linalg.norm(zc)
        xc = np.cross(zc, np.array([0.0, 0.0, 1.0]))
        xc = xc / max(np.linalg.norm(xc), 1e-6)
        yc = np.cross(zc, xc)
        TWC = np.eye(4, dtype=np.float32)
        TWC[:3, 0], TWC[:3, 1], TWC[:3, 2], TWC[:3, 3] = xc, yc, zc, eye
        cams.append(dict(K=K, TWC=TWC, resolution=tuple(resolution)))
    return cams


def make_scene_renderings(objects: TensorCollection, cameras, mesh_db, n_frames: int = 16,
                          resolution=(240, 320), orbit_radius: float = 1.5,
                          use_nms3d: bool = True):
    """Orbit renderings of a reconstructed scene → list of (H, W, 3) uint8.

    objects: infos 'label' (and 'score') with tensor TWO (N,4,4); `cameras`
    is unused, as in the JAX package (the orbit is centred on the objects).
    The n_frames views render in one SceneRenderer call (the JAX package
    renders one call a view; the images are the same).
    """
    from ..rendering.scene_renderer import SceneRenderer

    if use_nms3d and "score" in objects.infos:
        objects = nms3d(objects, poses_attr="TWO")
    TWO = objects.TWO.detach().cpu().numpy()
    obj_infos = [dict(label=str(objects.infos["label"][n]), TWO=TWO[n])
                 for n in range(len(objects))]
    center = np.mean([o["TWO"][:3, 3] for o in obj_infos], axis=0)
    cams = orbit_cameras(center, n_frames, resolution, orbit_radius)
    outs = SceneRenderer(mesh_db).render_scene(obj_infos, cams, resolution=tuple(resolution))
    return [(out["rgb"] * 255).astype(np.uint8) for out in outs]
