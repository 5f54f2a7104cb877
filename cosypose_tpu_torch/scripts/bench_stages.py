"""Per-stage profile of one refiner iteration (port of
cosypose_tpu/scripts/bench_stages.py).

Times each stage of the render-and-compare iteration on its own — the crop
(roi_align), the setup kernel (rows, keys and their y-order), the resolve
kernel, the whole render call, the backbone with its head, the pose update —
and the whole iteration,
at the demo inputs (`demo.make_inputs`, 480x640 frames) with random weights.
Each stage is read against what bounds it: the raster kernels against
ops/raster_bounds.py (an H100's least time for the bytes or fp32 operations
of these inputs; the share of it is given on the card only), the matmul
and convolution stages by their FLOPs (torch.utils.flop_counter, which counts
matmuls and convolutions) as achieved TFLOP/s and a share of the card's peak
for their type (utils/card.PEAK_FLOPS; null on a card the table lacks).

  python -m cosypose_tpu_torch.scripts.bench_stages [--batch 64] [--render-lod 512] \\
      [--reps 20] [--backbone efficientnet-b3] [--json OUT] [--device cuda]

On the card `ms` is device time by CUDA events over warmed repetitions and
`ms_per_call` the host's wall time a call, both ending in a synchronize; on
the CPU (`--device cpu`) both are the host's clock. Each row holds the
stage's kernel launches over its timed calls, which must equal the calls
times the launches a call (`calls`, `launches`, `launches_per_call`). The
JSON is the list of rows, with the device's name in each.
"""

from __future__ import annotations

import argparse
import json
import time

import torch
from torch.utils.flop_counter import FlopCounterMode

from .. import demo
from ..models.pose_predictor import PosePredictor, PosePredictorConfig, gather_mesh_data
from ..ops import rasterizer_cuda as rc
from ..ops.mesh_db import build_mesh_db
from ..ops.raster_bounds import resolve_bound, setup_bound
from ..ops.render import render
from ..utils.card import peak_flops
from ..utils.device import resolve_device

WARMUP = 2
KERNELS = ("raster_setup", "raster_resolve")


def timed(fn, reps: int, device: torch.device):
    """(ms, ms_per_call, calls) of fn() after WARMUP calls: device time by CUDA
    events and the host's wall time a call on the card; the host's clock on
    the CPU."""
    for _ in range(WARMUP):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        ms = 1e3 * (time.perf_counter() - t0) / reps
        return ms, ms, WARMUP + reps
    torch.cuda.synchronize(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    return start.elapsed_time(end) / reps, 1e3 * wall / reps, WARMUP + reps


def flops(fn) -> float:
    with FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--render-lod", type=int, default=None,
                        help="decimate the render geometry to at most this many faces per mesh")
    parser.add_argument("--backbone", default="efficientnet-b3")
    parser.add_argument("--json", default=None)
    parser.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    args = parser.parse_args(argv)

    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device_name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    B = args.batch
    cfg = PosePredictorConfig(backbone=args.backbone, compute_dtype=torch.bfloat16)
    pp = PosePredictor(cfg, device=dev)
    db = build_mesh_db(demo.demo_specs(), render_max_faces=args.render_lod, device=dev)
    images, K, TCO, labels = (torch.as_tensor(a, device=dev) for a in demo.make_inputs(B))
    md = gather_mesh_data(db, labels.long(), cfg.n_points_crop)
    size, tile, budget = cfg.render_size, cfg.raster_tile, cfg.raster_max_tris_per_tile

    with torch.inference_mode():
        images_crop, K_crop, _, _ = pp.crop(md, images, K, TCO)
        raster_args = (md["tri_verts"], md["tri_valid"], TCO, K_crop, size, md["tri_colors"])
        rows, key, order = rc.setup(*raster_args)
        rendered = rc.resolve(rows, order, size, tile, budget)[0]
        x = torch.cat([images_crop, rendered], dim=1)
        pose_outputs = pp.net(x)
        # (name, fn, launches of (setup, resolve) a call, peak FLOP/s type)
        stages = [
            ("crop(roi_align)", lambda: pp.crop(md, images, K, TCO), (0, 0), torch.float32),
            ("raster setup kernel", lambda: rc.setup(*raster_args), (1, 0), None),
            ("raster resolve kernel", lambda: rc.resolve(rows, order, size, tile, budget),
             (0, 1), None),
            ("raster full (setup+resolve)",
             lambda: render(*raster_args[:4], image_size=size, colors=raster_args[5], tile=tile,
                            max_tris_per_tile=budget), (1, 1), None),
            (f"backbone {args.backbone} bf16", lambda: pp.net(x), (0, 0), torch.bfloat16),
            ("pose update", lambda: pp.update_pose(TCO, K_crop, pose_outputs), (0, 0), None),
            ("full iteration", lambda: pp.forward(md, images, K, TCO, n_iterations=1), (1, 1),
             None),
        ]
        bounds = {"raster setup kernel": setup_bound(md["tri_verts"], md["tri_valid"],
                                                     md["tri_colors"], None, rows, key)[:2],
                  "raster resolve kernel": resolve_bound(rows, order, size, tile, budget,
                                                         False)[:2]}
        rows_out = []
        for name, fn, per_call, peak_type in stages:
            fl = flops(fn)
            before = dict(rc.RASTER_KERNEL.launches)
            ms, ms_call, calls = timed(fn, args.reps, dev)
            launches = {k: rc.RASTER_KERNEL.launches[k] - before[k] for k in KERNELS}
            want = {k: calls * n if dev.type == "cuda" else 0 for k, n in zip(KERNELS, per_call)}
            if launches != want:
                raise RuntimeError(f"{name}: kernel launches {launches} over {calls} calls, "
                                   f"want {want}")
            tflops = fl / ms / 1e9 if fl else 0.0
            peak = peak_flops(device_name, peak_type) if peak_type is not None else None
            row = dict(stage=name, ms=ms, ms_per_call=ms_call, gflop=fl / 1e9, tflops=tflops,
                       mfu_pct=100 * 1e12 * tflops / peak if peak and fl else None,
                       calls=calls, launches=launches,
                       launches_per_call=dict(zip(KERNELS, per_call)), device=device_name)
            if name in bounds:
                b_ms, by = bounds[name]
                row.update(bound_ms=b_ms, bound_by=by,
                           pct_of_bound=100 * b_ms / ms if dev.type == "cuda" else None)
            rows_out.append(row)

    H, W = size
    print(f"\nper-stage profile  B={B} F={rows.shape[1]} render={H}x{W} device={device_name} "
          f"(ms = {'device time by CUDA events' if dev.type == 'cuda' else 'host clock'}, mean "
          f"of {args.reps} after {WARMUP} warm-up calls)")
    print(f"{'stage':36s} {'ms':>9s} {'ms/call':>9s} {'GFLOP':>8s} {'TFLOP/s':>8s} {'MFU%':>6s} "
          f"{'bound ms':>9s} {'% bound':>8s}")
    for r in rows_out:
        mfu = f"{r['mfu_pct']:6.2f}" if r["mfu_pct"] is not None else "     -"
        bnd = f"{r['bound_ms']:9.4f}" if "bound_ms" in r else f"{'-':>9s}"
        bnd += f" {r['pct_of_bound']:8.1f}" if r.get("pct_of_bound") is not None else f" {'-':>8s}"
        print(f"{r['stage']:36s} {r['ms']:9.4f} {r['ms_per_call']:9.4f} {r['gflop']:8.2f} "
              f"{r['tflops']:8.2f} {mfu} {bnd}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows_out, f, indent=2)
    return rows_out


if __name__ == "__main__":
    main()
