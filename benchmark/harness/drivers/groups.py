"""Driver of `groups` mixes: one client in a closed loop sends one group of
views a request to CoarseRefinePosePredictor.get_predictions, the port's
serving entry as CosyPose's multi-view stage 1 calls it (every view of a
group in one call, each detection with its view's image id), and waits for
the final poses on the host.

A group is a seeded scene of `objects` distinct objects (uniform rotations,
positions in a box of `scene_half_extent` about the scene's centre) seen by
`views` cameras at seeded poses `camera_distance` from the centre, looking
at it (uniform direction and roll); every object is detected in every view,
its box the projection of its mesh. The images are seeded noise made on the
device, as the frames mix's are.

Everything else is the `frames` driver's (harness/drivers/frames.py, whose
functions this imports): the weights and calibration, the wrappers of a
traced run, the window, and the check against the plain reference, each
iteration from the program's input pose, with each detection's own view as
its image.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from benchmark.harness import counts, generate, scene
from benchmark.harness.cli import Outcome, Run, stage
from benchmark.harness.drivers import frames as frames_driver
from benchmark.harness.trace import Spans, profile

WARM_BASE, PROFILE_BASE = frames_driver.WARM_BASE, frames_driver.PROFILE_BASE


@dataclasses.dataclass
class Group:
    index: int
    images: torch.Tensor   # (V, 3, H, W) float32 in [0, 1], on the device
    K_views: torch.Tensor  # (V, 3, 3)
    labels: np.ndarray     # (V * n,) object indices, view by view
    views: np.ndarray      # (V * n,) the view of each detection
    boxes: np.ndarray      # (V * n, 4) float32

    @property
    def image(self) -> torch.Tensor:
        """Each detection's view image, (V * n, 3, H, W): the reference's rows."""
        return self.images[torch.as_tensor(self.views, device=self.images.device)]

    @property
    def K(self) -> torch.Tensor:
        return self.K_views[torch.as_tensor(self.views, device=self.K_views.device)]


class Sizes:
    """Every group has the same number of detections."""

    def __init__(self, n: int):
        self.n = n

    def __getitem__(self, k: int) -> int:
        return self.n


def look_at(rng: np.random.RandomState, distance: float) -> np.ndarray:
    """A camera's pose (camera from scene, 4x4) at `distance` from the
    scene's centre in a uniform direction, its optical axis through the
    centre, a uniform roll about it."""
    d = rng.normal(size=3)
    d /= np.linalg.norm(d)
    z = -d
    up = rng.normal(size=3)
    x = np.cross(up, z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    R_wc = np.stack([x, y, z], 1)
    T = np.eye(4)
    T[:3, :3] = R_wc.T
    T[:3, 3] = -R_wc.T @ (d * distance)
    return T


class GroupRequests:
    """Request i of a `groups` mix, the same for the same (seed, i)."""

    def __init__(self, mix: dict, cfg: dict, seed: int, objects: list, device):
        self.mix, self.seed, self.device = mix, seed, device
        self.size = tuple(cfg["image_size"])
        self.K = generate.camera(mix)
        self.points_m = [m["verts"] * 1e-3 for m in objects]
        self.n_det = Sizes(mix["views"] * mix["objects"])

    def __call__(self, i: int) -> Group:
        mix = self.mix
        V, n = mix["views"], mix["objects"]
        rng = np.random.RandomState(scene.stream(self.seed, "group", i) % 2 ** 32)
        objects = rng.choice(len(self.points_m), size=n, replace=False)
        T_wo = np.tile(np.eye(4), (n, 1, 1))
        T_wo[:, :3, :3] = generate.random_rotations(rng, n)
        T_wo[:, :3, 3] = (2 * rng.uniform(size=(n, 3)) - 1) * np.array(mix["scene_half_extent"])
        lo, hi = mix["camera_distance"]
        cams = [look_at(rng, rng.uniform(lo, hi)) for _ in range(V)]
        boxes = np.zeros((V * n, 4), np.float32)
        for v, T_cw in enumerate(cams):
            for k, obj in enumerate(objects):
                T = T_cw @ T_wo[k]
                cam = self.points_m[obj] @ T[:3, :3].T + T[:3, 3]
                uv = cam @ self.K.T.astype(np.float64)
                uv = uv[:, :2] / uv[:, 2:3]
                boxes[v * n + k] = np.concatenate([uv.min(0), uv.max(0)])
        gen = torch.Generator(device=self.device).manual_seed(scene.stream(self.seed, "image", i))
        images = torch.rand(V, 3, *self.size, generator=gen, device=self.device)
        K = torch.as_tensor(self.K, device=self.device)[None].expand(V, 3, 3).contiguous()
        return Group(i, images, K, np.tile(objects, V), np.repeat(np.arange(V), n), boxes)


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        control=None, faults=None, all_checks: bool = False) -> Outcome:
    """One run, as frames_driver.run (its arguments)."""
    from cosypose_tpu_torch.integrated.pose_predictor import (CoarseRefinePosePredictor,
                                                              LoadedPoseModel)
    from cosypose_tpu_torch.models import pose_predictor as pp_mod
    from cosypose_tpu_torch.ops.mesh_db import MeshSpec, build_mesh_db
    from cosypose_tpu_torch.utils.tensor_collection import TensorCollection

    from benchmark.reference import serve as ref_serve

    cfg, mix, wl = cell.config, cell.traffic, cell.workload
    cuda = torch.device(device).type == "cuda"
    dtype = getattr(torch, cfg["compute_dtype"])
    torch.backends.cuda.matmul.allow_tf32 = cfg["tf32"]
    torch.backends.cudnn.allow_tf32 = cfg["tf32"]

    stage(t_start, "imports")
    meshes = scene.meshes(cfg)
    groups = GroupRequests(mix, cfg, seed, meshes, device)
    t_ref = time.perf_counter()
    objects = ref_serve.Objects(meshes, cfg["render_faces"], cfg["n_points_crop"], device)
    ref_s = time.perf_counter() - t_ref  # the reference's own decimation: no set-up of the port
    x_cal = frames_driver.calibration_inputs(groups, objects, cfg)
    weights = [scene.make_weights(cfg, seed, tag, x_cal) for tag in ("coarse", "refiner")]
    del x_cal
    stage(t_start, "meshes, reference objects, weights")
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    db = build_mesh_db([MeshSpec(label=m["label"], vertices=m["verts"], faces=m["faces"],
                                 colors=m["colors"]) for m in meshes],
                       render_max_faces=cfg["render_faces"], device=device)
    pcfg = pp_mod.PosePredictorConfig(backbone=cfg["backbone"],
                                      render_size=tuple(cfg["render_size"]),
                                      n_points_crop=cfg["n_points_crop"], lamb=cfg["lamb"],
                                      compute_dtype=dtype,
                                      raster_max_tris_per_tile=cfg["raster_max_tris_per_tile"])
    models = []
    for w in weights:
        pp = pp_mod.PosePredictor(pcfg, device=device)
        frames_driver.load_weights(pp.net, w)
        models.append(LoadedPoseModel(pp, db, init_method=cfg["init_method"], device=device))
    server = CoarseRefinePosePredictor(*models, bsz_objects=cfg["bsz_objects"], device=device)
    stage(t_start, "mesh database, models")
    if faults is not None:
        faults(server)
    labels = [m["label"] for m in meshes]
    n_it = cfg["coarse_iterations"] + cfg["refiner_iterations"]

    def send(i: int):
        g = groups(i)
        dets = TensorCollection(dict(batch_im_id=g.views.astype(np.int64),
                                     label=[labels[k] for k in g.labels]),
                                bboxes=torch.as_tensor(g.boxes, device=device))
        t0 = time.perf_counter()
        final, preds = server.get_predictions(g.images, g.K_views, detections=dets,
                                              n_coarse_iterations=cfg["coarse_iterations"],
                                              n_refiner_iterations=cfg["refiner_iterations"])
        final_poses = final.poses.cpu()
        return time.perf_counter() - t0, len(g.labels), (preds, final_poses)

    for k in range(2):
        send(WARM_BASE + k)
    stage(t_start, "warm requests")

    spans = Spans(device) if trace else None
    prof = None
    if trace:
        n_prof = wl["profiled_requests"]
        prof = profile(lambda: [send(PROFILE_BASE + k) for k in range(n_prof)], device)
        for m in models:
            pp = m.predictor
            spans.wrap(pp, "forward", "forward",
                       before=lambda md, im, K, T, n=1: (spans.count("rows", T.shape[0] * n),
                                                         spans.count("iterations", n)))
            spans.wrap(pp, "crop", "crop")
            spans.wrap(pp.net, "forward", "backbone")
        faces = []

        def on_render(tri_verts, tri_valid, TCO, K, image_size=(240, 320), **_):
            spans.count("renders")
            spans.count("render_rows", tri_verts.shape[0])
            spans.count("render_pixels", tri_verts.shape[0] * image_size[0] * image_size[1])
            faces.append(tri_valid.sum())

        spans.wrap(pp_mod, "render", "render", before=on_render)
        detail = profile(lambda: [send(PROFILE_BASE + n_prof + k)
                                  for k in range(wl["detailed_requests"])], device, host=True)
        prof.update(render_kernel_s=detail["render_kernel_s"], gaps=detail["gaps"],
                    counters=dict(spans.counters),
                    render_faces=int(sum(int(f) for f in faces)))
        spans.counters.clear()
        spans.open.clear()
        faces.clear()
        stage(t_start, "profiled stretch")

    setup_s = time.perf_counter() - t_start - ref_s
    lat, dets, kept, failed = [], [], {}, 0
    t_w0 = time.perf_counter()
    i = 0
    while True:
        try:
            s, n, preds = send(i)
            lat.append(s)
            dets.append(n)
            kept[i] = preds
        except (RuntimeError, ValueError) as e:  # a request that fails counts, and is wrong
            failed += 1
            print(f"request {i} failed: {e!r}", flush=True)
        i += 1
        if time.perf_counter() - t_w0 >= seconds:
            break
    if cuda:
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t_w0
    span_ms = spans.ms() if trace else {}
    counters = dict(spans.counters) if trace else {}
    if trace:
        spans.unwrap()
        counters["render_faces"] = int(sum(int(f) for f in faces))
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    done = sorted(kept)
    rng = np.random.RandomState(scene.stream(seed, "check") % 2 ** 32)
    pick = sorted(rng.choice(done, size=min(len(done), wl["check_requests"]),
                             replace=False).tolist())
    keys = frames_driver.stage_keys(cfg)
    preds = {k: kept[k][0] for k in pick}
    prog = {"init": torch.cat([preds[k][keys[0]].poses_input for k in pick]).cpu(),
            "poses": [torch.cat([preds[k][s].poses for k in pick]).cpu() for s in keys],
            "inputs": [torch.cat([preds[k][s].poses_input for k in pick]) for s in keys],
            "boxes_crop": [torch.cat([preds[k][s].boxes_crop for k in pick]).cpu() for s in keys],
            "final": torch.cat([kept[k][1] for k in pick])}
    del preds
    del kept, server, models, db
    if cuda:
        torch.cuda.empty_cache()

    checks, control_readings = frames_driver.reference_checks(cfg, objects, weights, groups, pick,
                                                              prog, dtype, control)
    flops = counts.network_flops(cfg["backbone"], tuple(cfg["render_size"]), False)
    useful = sum(dets) * n_it
    totals = dict(requests=len(lat), detections=sum(dets), useful_rows=useful,
                  useful_flops=useful * flops, peak_flops=counts.PEAK_FLOPS[cfg["compute_dtype"]],
                  control=control_readings)
    lat_ms = sorted(1e3 * x for x in lat)
    q = np.percentile(lat_ms, [50, 95]) if lat_ms else [float("nan")] * 2
    print(f"{len(lat)} groups, {failed} failed, {sum(dets)} detections in {window_s:.3f} s; "
          f"latency median {q[0]:.3f} ms, p95 {q[1]:.3f} ms; set-up {setup_s:.3f} s", flush=True)
    e2e = {"setup_s": setup_s, "frame_ms_p95": float(q[1]), "poses_per_s": sum(dets) / window_s}
    run_rec = Run(config=cfg, window_s=window_s, spans=span_ms, counters=counters,
                  profile=prof, totals=totals)
    return Outcome(end_to_end=e2e, run=run_rec, attempted=len(lat) + failed, failed=failed,
                   checks=[(k, v, wl["limits"].get(k)) for k, v in checks.items()
                           if all_checks or k in wl["limits"]],
                   memory_peak_bytes=int(peak))
