"""Driver of `frames` mixes: one client in a closed loop sends one frame and
its detections a request to CoarseRefinePosePredictor.get_predictions, the
port's single-view serving entry, and waits for the final poses on the host.

Set-up: the configuration's meshes into the port's mesh database, the
harness's weights into both models, one warm request of each size. Traced
runs first profile a short stretch of requests as they run untraced, then a
shorter one with the harness's wrappers and the host's ops, then run the
window with CUDA-event spans around the layers' calls. After the window a seeded sample
of the finished requests (with the one of most detections) goes through the
plain reference, and each stage's poses, crop boxes and the init are compared;
so are the hand-offs: each iteration starts from the pose the one before it
returned (the refiner's first from the coarse model's last), and the final
poses are the last iteration's.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness import counts, generate, scene
from benchmark.harness.cli import Outcome, Run, stage
from benchmark.harness.trace import Spans, profile
from benchmark.reference import efficientnet as ref_net
from benchmark.reference import geometry as ref_geo
from benchmark.reference import serve as ref_serve

WARM_BASE = 10 ** 6     # request indices of the warm-up, the profiled stretch and
PROFILE_BASE = 2 * 10 ** 6  # the weights' calibration batch
CALIBRATION_BASE = 3 * 10 ** 6


def load_weights(net: torch.nn.Module, weights: dict) -> None:
    missing, unexpected = net.load_state_dict(weights, strict=False)
    if unexpected or any(not k.endswith("num_batches_tracked") for k in missing):
        raise KeyError(f"weights do not fit the network: missing {missing}, "
                       f"unexpected {unexpected}")


def stage_keys(cfg: dict) -> list:
    return [f"coarse/iteration={n}" for n in range(1, cfg["coarse_iterations"] + 1)] + \
        [f"refiner/iteration={n}" for n in range(1, cfg["refiner_iterations"] + 1)]


def compare(prog: dict, ref: dict, step: dict | None = None) -> dict:
    """The widest gaps between the program's and the reference's rows: rotation
    (degrees) and translation (relative) of the init and of every stage's
    poses, and the crop boxes (pixels); with `step` (the reference's
    iterations each started from the program's input pose), the widest gaps
    of single iterations too."""
    def t_rel(a, b):
        return float(((a[:, :3, 3].double() - b[:, :3, 3].double()).norm(dim=-1)
                      / b[:, :3, 3].double().norm(dim=-1)).max())

    rot = max(float(ref_geo.angle_deg(p[:, :3, :3], r[:, :3, :3]).max())
              for p, r in zip(prog["poses"], ref["poses"]))
    trans = max(t_rel(p, r) for p, r in zip(prog["poses"], ref["poses"]))
    box = max(float((p.double() - r.double()).abs().max())
              for p, r in zip(prog["boxes_crop"], ref["boxes_crop"]))
    init = max(t_rel(prog["init"], ref["init"]),
               float(ref_geo.angle_deg(prog["init"][:, :3, :3], ref["init"][:, :3, :3]).max()))
    out = {"pose_rot_deg": rot, "pose_trans_rel": trans, "crop_box_px": box, "init_gap": init,
           "handoff_gap": handoff_gap(prog)}
    if step is not None:
        out["step_rot_deg"] = max(float(ref_geo.angle_deg(p[:, :3, :3], r[:, :3, :3]).max())
                                  for p, r in zip(prog["poses"], step["poses"]))
        out["step_trans_rel"] = max(t_rel(p, r) for p, r in zip(prog["poses"], step["poses"]))
    return out


def handoff_gap(prog: dict) -> float:
    """The widest gap between a pose as one iteration returned it and as the
    next one took it (the refiner's first from the coarse model's last), and
    between the last iteration's poses and the final poses the caller got:
    the same tensors passed on, so 0 exactly."""
    outs = [p.double() for p in prog["poses"]]
    ins = [t.cpu().double() for t in prog["inputs"][1:]] + [prog["final"].double()]
    return max(float((a - b).abs().max()) for a, b in zip(outs, ins))


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        control=None, faults=None, all_checks: bool = False) -> Outcome:
    """One run. `control`, where given, names a lower precision ('fp8') whose
    reference is compared as well (its readings in totals['control']);
    `faults` (tests only) is a callable that breaks the server after set-up;
    `all_checks` reports every number compared, with or without a limit."""
    from cosypose_tpu_torch.integrated.pose_predictor import (CoarseRefinePosePredictor,
                                                              LoadedPoseModel)
    from cosypose_tpu_torch.models import pose_predictor as pp_mod
    from cosypose_tpu_torch.ops.mesh_db import MeshSpec, build_mesh_db
    from cosypose_tpu_torch.utils.tensor_collection import TensorCollection

    cfg, mix, wl = cell.config, cell.traffic, cell.workload
    cuda = torch.device(device).type == "cuda"
    dtype = getattr(torch, cfg["compute_dtype"])
    torch.backends.cuda.matmul.allow_tf32 = cfg["tf32"]
    torch.backends.cudnn.allow_tf32 = cfg["tf32"]

    stage(t_start, "imports")
    meshes = scene.meshes(cfg)
    frames = generate.FrameRequests(mix, cfg, seed, meshes, device)
    t_ref = time.perf_counter()
    objects = ref_serve.Objects(meshes, cfg["render_faces"], cfg["n_points_crop"], device)
    ref_s = time.perf_counter() - t_ref  # the reference's own decimation: no set-up of the port
    x_cal = calibration_inputs(frames, objects, cfg)
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
        load_weights(pp.net, w)
        models.append(LoadedPoseModel(pp, db, init_method=cfg["init_method"], device=device))
    server = CoarseRefinePosePredictor(*models, bsz_objects=cfg["bsz_objects"], device=device)
    stage(t_start, "mesh database, models")
    if faults is not None:
        faults(server)
    labels = [m["label"] for m in meshes]
    n_it = cfg["coarse_iterations"] + cfg["refiner_iterations"]

    def send(i: int):
        fr = frames(i)
        dets = TensorCollection(dict(batch_im_id=np.zeros(len(fr.labels), np.int64),
                                     label=[labels[k] for k in fr.labels]),
                                bboxes=torch.as_tensor(fr.boxes, device=device))
        t0 = time.perf_counter()
        final, preds = server.get_predictions(fr.image, fr.K, detections=dets,
                                              n_coarse_iterations=cfg["coarse_iterations"],
                                              n_refiner_iterations=cfg["refiner_iterations"])
        final_poses = final.poses.cpu()
        return time.perf_counter() - t0, len(fr.labels), (preds, final_poses)

    warm = len(mix["sizes"]) * WARM_BASE
    for k in range(len(mix["sizes"])):
        send(warm + k)
    stage(t_start, "warm requests")

    spans = Spans(device) if trace else None
    prof = None
    if trace:
        n_prof = wl["profiled_requests"]
        # the card's busy time over a steady stretch, before any wrapper: the
        # host's pace as it is
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
        # then with the wrappers and the host's ops, over a shorter stretch:
        # the render's kernels and what the host did in each idle gap
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

    # the sample, moved off the program's state, which is then freed
    done = sorted(kept)
    rng = np.random.RandomState(scene.stream(seed, "check") % 2 ** 32)
    longest = max(done, key=lambda k: frames.n_det[k])
    pick = sorted({longest, *rng.choice(done, size=min(len(done), wl["check_requests"]) - 1,
                                        replace=False).tolist()})
    keys = stage_keys(cfg)
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

    checks, control_readings = reference_checks(cfg, objects, weights, frames, pick, prog,
                                                dtype, control)
    flops = counts.network_flops(cfg["backbone"], tuple(cfg["render_size"]), False)
    useful = sum(dets) * n_it
    totals = dict(requests=len(lat), detections=sum(dets), useful_rows=useful,
                  useful_flops=useful * flops, peak_flops=counts.PEAK_FLOPS[cfg["compute_dtype"]],
                  control=control_readings)
    lat_ms = sorted(1e3 * x for x in lat)
    q = np.percentile(lat_ms, [50, 95]) if lat_ms else [float("nan")] * 2
    print(f"{len(lat)} requests, {failed} failed, {sum(dets)} detections in {window_s:.3f} s; "
          f"latency median {q[0]:.3f} ms, p95 {q[1]:.3f} ms; set-up {setup_s:.3f} s", flush=True)
    e2e = {"setup_s": setup_s, "frame_ms_p95": float(q[1]),
           "poses_per_s": sum(dets) / window_s}
    run_rec = Run(config=cfg, window_s=window_s, spans=span_ms, counters=counters,
                  profile=prof, totals=totals)
    return Outcome(end_to_end=e2e, run=run_rec, attempted=len(lat) + failed, failed=failed,
                   checks=[(k, v, wl["limits"].get(k)) for k, v in checks.items()
                           if all_checks or k in wl["limits"]],
                   memory_peak_bytes=int(peak))


def rows_of(frames, indices: list):
    """The reference's rows of requests: (images, K, boxes, labels), each
    detection with its frame."""
    frs = [frames(k) for k in indices]
    dev = frs[0].image.device
    return (torch.cat([fr.image.expand(len(fr.labels), -1, -1, -1) for fr in frs]),
            torch.cat([fr.K.expand(len(fr.labels), -1, -1) for fr in frs]),
            torch.as_tensor(np.concatenate([fr.boxes for fr in frs]), device=dev),
            torch.as_tensor(np.concatenate([fr.labels for fr in frs]), device=dev))


def calibration_inputs(frames, objects, cfg) -> torch.Tensor:
    """First-iteration network inputs of seeded requests (outside the
    traffic's indices), at least `calibration_batch` rows."""
    idx, rows = [], 0
    while rows < cfg["calibration_batch"]:
        idx.append(CALIBRATION_BASE + len(idx))
        rows += frames.n_det[idx[-1]]
    images, K, boxes, labels = rows_of(frames, idx)
    return ref_serve.first_inputs(objects, images, K, labels, cfg, boxes=boxes)


def reference_checks(cfg, objects, weights, frames, pick, prog, dtype, control):
    """The plain reference over the sampled requests, compared with the
    program's rows; with `control`, the control's gaps to the reference too."""
    images, K, boxes, labels = rows_of(frames, pick)
    stages = [cfg["coarse_iterations"], cfg["refiner_iterations"]]

    def reference(quant=None, inputs=None):
        out = ref_serve.serve(objects, ref_serve.nets_for(weights, cfg["backbone"], quant), stages,
                              images, K, boxes, labels, cfg, dtype, inputs)
        return {k: ([t.cpu() for t in v] if isinstance(v, list) else v.cpu())
                for k, v in out.items()}

    # `step`: each iteration of the reference from the program's input pose
    # (the first from the reference's own init), so a gap is one iteration's
    ref = reference()
    checks = compare(prog, ref, reference(inputs=[None] + prog["inputs"][1:]))
    control_readings = None
    if control == "fp8":
        fp8 = reference(ref_net.fp8_quant)
        fp8["final"] = fp8["poses"][-1]
        control_readings = compare(fp8, ref, reference(inputs=[None] + fp8["inputs"][1:]))
    return checks, control_readings
