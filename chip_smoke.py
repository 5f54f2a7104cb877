"""Smoke run of the PyTorch/CUDA port (cosypose_tpu_torch) on one card.

    python3 chip_smoke.py        # from the repo root, on a machine with a CUDA card

Phases, none of them caught; any failure exits non-zero:
  1. device line, and the raster kernel built from csrc/ with nvcc;
  2. the kernel against its plain PyTorch version at the main path's shapes
     (demo inputs, B=128, 240x320 renders, LOD 512): plain variant, a
     small-budget case, the attribute variant on a two-instance scene, and a
     sweep of tile shapes; kernel, plain and prologue times and the bound;
  3. the slice (PosePredictor, EfficientNet-B3, fp32, TF32 off) at B=4 on
     the card (kernel) against the CPU (plain version);
  4. serving: coarse + refiner B3 (bf16 backbone) behind
     CoarseRefinePosePredictor(bsz_objects=128), 3 requests of 4 images and
     160 detections at 1 coarse + 4 refiner iterations, with the kernel's
     launch count checked; then one profiled request.
The last lines are the card's name and power limit, one JSON line of kernel
numbers, and the contract line {"ok": true, "device": {...}}. Without a card,
or outside the repo, it exits non-zero and prints no result. The profiler
table goes to build/chip_smoke_profile.txt.
"""

from __future__ import annotations

import json
import math
import pathlib
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent
OUT_DIR = REPO / "build"
RENDER = (240, 320)
IMAGE = (480, 640)
LOD = 512
BATCH = 128
N_COARSE, N_REFINER = 1, 4
N_IMAGES, N_DETECTIONS = 4, 160
# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): fp32 outside the
# tensor cores, and HBM3 bandwidth
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# fp32 operations of one (pixel, triangle) visit: 4 planes of 2 mul + 2 add,
# 3 inside tests and the depth test. A winner's 3 colour planes come on top;
# they are not counted, so the bound is a lower bound.
FLOPS_PER_VISIT = 20
ATOL_KERNEL = 1e-4   # depth and rgb, kernel vs plain (same arithmetic: expect 0)
ATOL_SLICE = 1e-3    # TCO_final, card vs CPU (cuDNN vs oneDNN summation order)
SOURCE = "cosypose_tpu_torch/csrc/rasterizer.cu"
REPLACES = "cosypose_tpu/ops/rasterizer_pallas.py:49"


def log(msg: str) -> None:
    print(msg, flush=True)


def card_identity() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of fn() over reps calls, by CUDA events, after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_bound(coef, chunk_idx, counts, image, tile, with_attr):
    """(bound_ms, 'operations' or 'bytes', visits, bytes) for one resolve on these inputs."""
    import torch

    (H, W), (th, tw) = image, tile
    rows = torch.tensor([min(th, H - y) for y in range(0, H, th)], dtype=torch.float64)
    cols = torch.tensor([min(tw, W - x) for x in range(0, W, tw)], dtype=torch.float64)
    px = torch.outer(rows, cols).flatten().to(counts.device)  # in-image pixels per tile
    visits = float((counts.double() * 8 * px[None]).sum())
    B = coef.shape[0]
    n_bytes = 4 * (coef.numel() + chunk_idx.numel() + counts.numel()
                   + B * H * W * (4 + int(with_attr)))
    t_ops, t_bytes = visits * FLOPS_PER_VISIT / PEAK_FP32, n_bytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), visits,
            n_bytes)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    from cosypose_tpu_torch import demo
    from cosypose_tpu_torch.integrated.pose_predictor import (CoarseRefinePosePredictor,
                                                              LoadedPoseModel)
    from cosypose_tpu_torch.models.pose_predictor import (PosePredictor, PosePredictorConfig,
                                                          gather_mesh_data)
    from cosypose_tpu_torch.ops import rasterizer_cuda
    from cosypose_tpu_torch.ops.camera import (boxes_from_uv, get_K_crop_resize, project_points,
                                               project_points_robust)
    from cosypose_tpu_torch.ops.cropping import deepim_boxes
    from cosypose_tpu_torch.ops.mesh_db import build_mesh_db
    from cosypose_tpu_torch.ops.rasterizer import camera_corners
    from cosypose_tpu_torch.utils.tensor_collection import TensorCollection

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_identity()
    tag = f"[{card}]"
    kernel = rasterizer_cuda.RASTER_KERNEL

    # -- 1. device and build ------------------------------------------------
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}, nvidia-smi: {card}")
    t0 = time.perf_counter()
    lib, report = rasterizer_cuda.build_library()
    log(f"{tag} build: {SOURCE} -> {lib.name} in {time.perf_counter() - t0:.2f} s")
    for line in report.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"  ptxas: {line.strip()}")
    kernel.load()

    # -- 2. kernel vs plain at the main path's shapes -------------------------
    db = build_mesh_db(demo.demo_specs(), render_max_faces=LOD, device=dev)
    images_np, K_np, TCO_np, labels_np = demo.make_inputs(BATCH, *IMAGE)
    K = torch.as_tensor(K_np, device=dev)
    TCO = torch.as_tensor(TCO_np, device=dev)
    md = gather_mesh_data(db, torch.as_tensor(labels_np, device=dev).long(), 2000)
    # the first iteration's crop intrinsics, as PosePredictor.network_input computes them
    boxes_rend = boxes_from_uv(project_points_robust(md["crop_points"], K, TCO))
    centers = project_points_robust(torch.zeros(BATCH, 1, 3, device=dev), K, TCO)
    K_crop = get_K_crop_resize(K, deepim_boxes(centers, boxes_rend, boxes_rend, IMAGE),
                               IMAGE, RENDER)
    cfg = PosePredictorConfig()
    tile, budget = cfg.raster_tile, cfg.raster_max_tris_per_tile

    def check(name, coef, idx, counts, tile, with_attr, time_it):
        out_k = kernel(coef, idx, counts, RENDER, tile, with_attr)
        torch.cuda.synchronize()
        out_p = rasterizer_cuda.resolve_plain(coef, idx, counts, RENDER, tile, with_attr)
        err = max(float((out_k[0] - out_p[0]).abs().max()), float((out_k[1] - out_p[1]).abs().max()))
        if err > ATOL_KERNEL or not torch.equal(out_k[1] > 0, out_p[1] > 0):
            raise AssertionError(f"{name}: kernel vs plain max err {err}, or masks differ")
        if with_attr and not torch.equal(out_k[2], out_p[2]):
            raise AssertionError(f"{name}: attribute differs")
        hit = float((out_k[1] > 0).float().mean())
        row = dict(max_abs_err=err)
        if time_it:
            row["ms"] = time_cuda_ms(lambda: kernel(coef, idx, counts, RENDER, tile, with_attr), 20)
            row["plain_ms"] = time_cuda_ms(
                lambda: rasterizer_cuda.resolve_plain(coef, idx, counts, RENDER, tile, with_attr),
                2, warmup=1)
            row["bound_ms"], row["bound_by"], visits, n_bytes = kernel_bound(
                coef, idx, counts, RENDER, tile, with_attr)
            log(f"{tag} {name}: max_abs_err {err:.3g} (<= {ATOL_KERNEL}), masks equal, "
                f"coverage {hit:.3f}, kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.2f} ms, "
                f"bound {row['bound_ms']:.4f} ms by {row['bound_by']} "
                f"({visits:.4g} pixel-triangle visits, max chunks/tile {int(counts.max())}; "
                f"{n_bytes / 1e6:.1f} MB moved, {1e3 * n_bytes / PEAK_BYTES:.4f} ms at peak), "
                f"library_ms: none (no single PyTorch call computes this function)")
        else:
            log(f"{tag} {name}: max_abs_err {err:.3g} (<= {ATOL_KERNEL}), masks equal, "
                f"coverage {hit:.3f}, max chunks/tile {int(counts.max())}")
        return row

    args = (md["tri_verts"], md["tri_valid"], TCO, K_crop, RENDER, md["tri_colors"])
    prep = lambda t=tile, b=budget: rasterizer_cuda.prepare(*args, t, b)  # noqa: E731
    coef, idx, counts = prep()
    log(f"{tag} kernel inputs: coef {tuple(coef.shape)}, chunk lists {tuple(idx.shape)}, "
        f"tile {tile}, budget {budget}; prologue {time_cuda_ms(prep, 10):.3f} ms")
    rows = {"raster_resolve": check("raster_resolve", coef, idx, counts, tile, False, True)}
    small = rasterizer_cuda.prepare(*args, tile, 40)
    rows["raster_resolve"]["max_abs_err"] = max(
        rows["raster_resolve"]["max_abs_err"],
        check("raster_resolve small budget (40)", *small, tile, False, False)["max_abs_err"])

    # two instances per item, the second behind and to the side: the attr variant
    tv_cam = camera_corners(md["tri_verts"], TCO)
    shift = torch.tensor([0.03, 0.01, 0.05], device=dev)
    n_f = tv_cam.shape[1]
    attr = torch.cat([torch.ones(BATCH, n_f), torch.full((BATCH, n_f), 2.0)], 1).to(dev)
    two = rasterizer_cuda.prepare(
        torch.cat([tv_cam, tv_cam + shift], 1), torch.cat([md["tri_valid"]] * 2, 1),
        torch.eye(4, device=dev).expand(BATCH, 4, 4), K_crop, RENDER,
        torch.cat([md["tri_colors"]] * 2, 1), tile, budget, tri_attr=attr)
    rows["raster_resolve_attr"] = check("raster_resolve_attr (two instances)", *two, tile,
                                        True, True)

    for t in [(8, 32), (16, 16), (16, 32), (32, 32), (8, 64)]:
        c = prep(t)
        ms_k = time_cuda_ms(lambda: kernel(*c, RENDER, t), 20)
        log(f"{tag} tile {t}: prologue {time_cuda_ms(lambda: prep(t), 5):.3f} ms, "
            f"kernel {ms_k:.4f} ms, bound {kernel_bound(*c, RENDER, t, False)[0]:.4f} ms")

    # -- 3. the slice on the card vs on the CPU -------------------------------
    cfg32 = PosePredictorConfig()
    B = 4
    imgs4, K4, TCO4, lab4 = demo.make_inputs(B, *IMAGE)
    outs, state = {}, None
    for d in ("cpu", "cuda"):
        pp = PosePredictor(cfg32, device=d)
        db_d = build_mesh_db(demo.demo_specs(), render_max_faces=LOD, device=d)
        md_d = gather_mesh_data(db_d, torch.as_tensor(lab4, device=d).long(), cfg32.n_points_crop)
        a = [torch.as_tensor(x, device=d) for x in (imgs4, K4, TCO4)]
        if state is None:
            demo.demo_weights(pp, md_d, *a, torch.Generator().manual_seed(1))
            state = pp.net.state_dict()
        pp.net.load_state_dict(state)
        t0 = time.perf_counter()
        outs[d] = {k: v.cpu() for k, v in pp.forward(md_d, *a, n_iterations=2).items()}
        log(f"slice B3 fp32 B={B} n=2 on {d}: {time.perf_counter() - t0:.2f} s (first call)")
    errs = {k: float((outs["cuda"][k] - outs["cpu"][k]).abs().max()) for k in outs["cpu"]}
    moved = float((outs["cpu"]["TCO_final"] - torch.as_tensor(TCO4)).abs().max())
    log(f"{tag} slice card vs CPU max abs err: " + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
        + f"; TCO_final moved {moved:.3g} from the init")
    if not errs["TCO_final"] <= ATOL_SLICE or moved <= 1e-4:
        raise AssertionError(f"slice: TCO_final err {errs['TCO_final']} > {ATOL_SLICE} "
                             f"or poses did not move ({moved})")

    # -- 4. serving -------------------------------------------------------------
    cfg16 = PosePredictorConfig(compute_dtype=torch.bfloat16)

    def request(seed):
        rng = torch.Generator(device="cpu").manual_seed(seed)
        images = torch.rand(N_IMAGES, 3, *IMAGE, generator=rng).to(dev)
        Kr = K[:N_IMAGES].clone()
        im_ids = torch.randint(0, N_IMAGES, (N_DETECTIONS,), generator=rng)
        labels = torch.randint(0, 2, (N_DETECTIONS,), generator=rng)
        T = torch.eye(4).repeat(N_DETECTIONS, 1, 1)
        T[:, :2, 3] = torch.rand(N_DETECTIONS, 2, generator=rng) * 0.3 - 0.15
        T[:, 2, 3] = torch.rand(N_DETECTIONS, generator=rng) * 0.7 + 0.5
        uv = project_points(db.points[labels.to(dev)], Kr[im_ids.to(dev)], T.to(dev))
        boxes = boxes_from_uv(uv) + (torch.rand(N_DETECTIONS, 4, generator=rng) * 6 - 3).to(dev)
        dets = TensorCollection(
            dict(batch_im_id=im_ids.numpy(), label=[db.labels[i] for i in labels.tolist()],
                 score=torch.rand(N_DETECTIONS, generator=rng).numpy()), bboxes=boxes)
        return images, Kr, dets

    models = []
    warm = request(100)
    for seed in (10, 11):
        pp = PosePredictor(cfg16, device=dev, generator=torch.Generator().manual_seed(seed))
        models.append(LoadedPoseModel(pp, db, device=dev))
    server = CoarseRefinePosePredictor(models[0], models[1], bsz_objects=BATCH, device=dev)
    init = server.make_TCO_init(warm[2], warm[1])[:BATCH]
    im_ids = torch.as_tensor(init.infos["batch_im_id"], device=dev)
    md_w = gather_mesh_data(db, db.ids_for(init.infos["label"]), cfg16.n_points_crop)
    for i, m in enumerate(models):
        demo.demo_weights(m.predictor, md_w, warm[0][im_ids], warm[1][im_ids], init.poses,
                          torch.Generator().manual_seed(20 + i))

    def serve(req):
        images, Kr, dets = req
        t0 = time.perf_counter()
        final, preds = server.get_predictions(images, Kr, detections=dets,
                                              n_coarse_iterations=N_COARSE,
                                              n_refiner_iterations=N_REFINER)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, final, preds

    serve(warm)  # first calls: cuDNN plans, allocator
    reqs = [request(seed) for seed in (1, 2, 3)]
    chunks = math.ceil(N_DETECTIONS / BATCH)
    kernel.launches = {k: 0 for k in kernel.launches}
    results = [serve(r) for r in reqs]
    launches = dict(kernel.launches)
    expected = len(reqs) * (N_COARSE + N_REFINER) * chunks
    if launches["raster_resolve"] != expected:
        raise AssertionError(f"serving launched the kernel {launches} times, want {expected}")
    for lat, final, preds in results:
        poses = final.poses
        moved = float((poses - preds["coarse/iteration=1"].poses_input).abs().max())
        if len(final) != N_DETECTIONS or not torch.isfinite(poses).all() or moved <= 1e-4:
            raise AssertionError(f"serving: {len(final)} rows, finite "
                                 f"{bool(torch.isfinite(poses).all())}, moved {moved}")
        n_it = N_DETECTIONS * (N_COARSE + N_REFINER)
        log(f"{tag} request: {N_IMAGES} images, {N_DETECTIONS} detections, {chunks} chunks of "
            f"{BATCH}, {N_COARSE}+{N_REFINER} iterations: {1e3 * lat:.1f} ms, "
            f"{n_it / lat:.1f} crop-iterations/s ({chunks * BATCH * (N_COARSE + N_REFINER) / lat:.1f} "
            f"with padding), poses moved up to {moved:.3g}")
    log(f"{tag} kernel launches while serving: {launches} (want {expected} of raster_resolve)")

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        lat, _, _ = serve(reqs[0])
    table = prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=40)
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke_profile.txt").write_text(f"{card}\n{table}\n")
    # device-side events only: a CPU op's device time repeats its kernels'
    attr = "self_device_time_total" if hasattr(prof.key_averages()[0], "self_device_time_total") \
        else "self_cuda_time_total"
    dev_us = {e.key: getattr(e, attr) for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA}
    busy = sum(dev_us.values()) / 1e3
    raster = sum(v for k, v in dev_us.items() if "raster_resolve" in k) / 1e3
    conv = sum(v for k, v in dev_us.items() if "conv" in k.lower() or "cudnn" in k.lower()
               or "xmma" in k or "sm90" in k) / 1e3
    log(f"{tag} profiled request: wall {1e3 * lat:.1f} ms, device busy {busy:.1f} ms "
        f"(idle share {1 - busy / (1e3 * lat):.3f}), raster kernel {raster:.2f} ms, "
        f"conv/GEMM-named kernels {conv:.1f} ms; top kernels:")
    for k, v in sorted(dev_us.items(), key=lambda kv: -kv[1])[:8]:
        log(f"    {v / 1e3:9.2f} ms  {k[:90]}")

    # -- results --------------------------------------------------------------
    kernels = [dict(name=name, route="cuda", source=SOURCE, replaces=REPLACES,
                    launches=launches[name], library_ms=None, **rows[name])
               for name in ("raster_resolve", "raster_resolve_attr")]
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
