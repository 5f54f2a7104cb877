"""Headline bench of the port: refiner crop-iterations per second on one card
(the counterpart of the repo's bench.py, step by step).

    python -m cosypose_tpu_torch.bench [--save-output PATH]

The flagship configuration: the EfficientNet-B3 refiner at 240x320 renders
of 480x640 images, batch 128, 4 iterations a call (the BOP20 inference
config), the backbone in bfloat16 under autocast and the geometry in fp32,
TF32 off; the demo spheres at render LOD 512; the port's seeded init (a zero
pose kernel, as the JAX init's, so every iteration renders the same poses).
A call is `gather_mesh_data` and `PosePredictor.forward` — the eager path
serving runs, each render through the raster kernels (`cosypose::raster_setup`,
`cosypose::raster_resolve`).

Measured: one warm-up call and a host read-back, then REPS calls dispatched
back to back, a synchronize and a read-back of the last output;
value = REPS * B * N_ITER / wall. `device_ms_per_call` is the device time a
call by CUDA events around the REPS calls.

FLOPs: torch.utils.flop_counter over one call. It counts the convolutions,
the linear layers and roi_align's two batched matmuls; the two raster
operators have no FLOP formula and are not counted, as the JAX bench's
XLA cost analysis gets no estimate for its Pallas call, so both benches count
the same work. tflops = FLOPs / wall a call; mfu_pct is that over the card's
dense bf16 peak (utils/card.PEAK_FLOPS), null for a card the table lacks.

vs_baseline: against the same pipeline at B=4, 2 reps, on the host CPU
(device="cpu": the raster kernels' plain versions), cached in
build/bench_cpu_baseline.json under the CPU's model name and torch's thread
count and measured again where either differs. The secondary arm is the
same pipeline with WideResNet-18 (`wrn18_*`).

Prints the card's name and power limit and each arm's kernel launches, then
ONE JSON line as its last: bench.py's keys, plus `device_ms_per_call`. Every
failure exits non-zero: without a card it exits 2 and prints no result; it
never runs the timed path on the CPU or through the plain raster versions.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import platform
import sys
import time

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from . import demo
from .entry import refiner_fn
from .models.pose_predictor import PosePredictor, PosePredictorConfig
from .ops import depthwise_cuda as dwc
from .ops import rasterizer_cuda as rc
from .ops.mesh_db import build_mesh_db
from .utils.card import card_identity, peak_flops
from .utils.device import resolve_device, synchronize

REPO = pathlib.Path(__file__).resolve().parents[1]
CPU_CACHE = REPO / "build" / "bench_cpu_baseline.json"

BATCH = 128
N_ITER = 4  # refiner iterations per call (the BOP20 inference config)
REPS = 6
# render geometry at most this many faces a mesh: matched to the 240x320
# render-and-compare resolution (the point sets keep full fidelity)
RENDER_LOD = 512
BASELINE_BATCH = 4  # a B=128 run on the host CPU is impractically slow
BASELINE_REPS = 2
METRIC = "refiner_crop_iterations_per_sec_gpu"
KERNELS = ("raster_setup", "raster_resolve")
ARMS = ("efficientnet-b3", "wide-resnet18")


def build(B: int, dtype: torch.dtype | None = None, backbone: str = "efficientnet-b3",
          device: str | torch.device = "cuda"):
    """(fn, args): one bench call at batch B; args = (predictor, images, K,
    TCO, label_ids) on `device`, fn(*args) -> TCO_final (B,4,4)."""
    dev = resolve_device(device)
    cfg = PosePredictorConfig(backbone=backbone, compute_dtype=dtype or torch.bfloat16)
    pp = PosePredictor(cfg, device=dev)
    mesh_db = build_mesh_db(demo.demo_specs(), render_max_faces=RENDER_LOD, device=dev)
    images, K, TCO, label_ids = (torch.as_tensor(a, device=dev) for a in demo.make_inputs(B))
    return refiner_fn(mesh_db, cfg, N_ITER), (pp, images, K, TCO, label_ids)


def measure(fn, args, reps: int):
    """(crop-iterations/s, wall s a call, device ms a call by CUDA events or
    None off the card, the last call's output)."""
    dev = args[1].device
    float(fn(*args).sum())  # warm-up and a full host read-back
    events = None
    if dev.type == "cuda":
        events = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    if events:
        events[0].record()
    outs = [fn(*args) for _ in range(reps)]
    if events:
        events[1].record()
    synchronize(dev)
    float(outs[-1].sum())
    dt = time.perf_counter() - t0
    device_ms = events[0].elapsed_time(events[1]) / reps if events else None
    return reps * args[1].shape[0] * N_ITER / dt, dt / reps, device_ms, outs[-1]


def flops_per_call(fn, args) -> float:
    """FLOPs of one call: torch's FLOP counter, plus the depthwise kernel's
    launches, which it cannot see."""
    dw_before = dwc.DW_KERNEL.flops
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    flops = float(counter.get_total_flops() + dwc.DW_KERNEL.flops - dw_before)
    if flops <= 0:
        raise RuntimeError("the FLOP counter counted nothing in a bench call")
    return flops


def host_key() -> dict:
    """What a CPU baseline is valid for: the CPU's model name and torch's
    thread count."""
    name = ""
    cpuinfo = pathlib.Path("/proc/cpuinfo")
    if cpuinfo.exists():
        for line in cpuinfo.read_text().splitlines():
            if line.startswith("model name"):
                name = line.split(":", 1)[1].strip()
                break
    return {"cpu": name or platform.processor() or platform.machine(),
            "threads": torch.get_num_threads()}


def cpu_baseline(cache: pathlib.Path = CPU_CACHE) -> float:
    """Crop-iterations/s of the pipeline at BASELINE_BATCH on the host CPU,
    read from `cache` when it was measured on this CPU model with this many
    threads, else measured and written there."""
    key = host_key()
    if cache.exists():
        saved = json.loads(cache.read_text())
        if {k: saved.get(k) for k in key} == key:
            return float(saved["crops_per_sec"])
    fn, args = build(BASELINE_BATCH, device="cpu")
    value = measure(fn, args, BASELINE_REPS)[0]
    cache.parent.mkdir(parents=True, exist_ok=True)
    cache.write_text(json.dumps({**key, "crops_per_sec": value}))
    return value


def result_line(b3: dict, wrn18: dict, baseline: float, peak: float | None, batch: int) -> dict:
    """The result JSON of bench.py's keys plus device_ms_per_call, from each
    arm's {value, sec_per_call, flops, device_ms} and the CPU baseline; the
    MFU is null where `peak` (the card's bf16 FLOP/s) is."""
    if baseline <= 0:
        raise ValueError(f"CPU baseline {baseline} crop-iterations/s")

    def tflops(arm):
        return arm["flops"] / arm["sec_per_call"] / 1e12

    def mfu(arm):
        return round(100.0 * tflops(arm) * 1e12 / peak, 2) if peak else None

    return {"metric": METRIC,
            "value": round(b3["value"], 2),
            "unit": "crop-iterations/s",
            "vs_baseline": round(b3["value"] / baseline, 2),
            "tflops": round(tflops(b3), 2),
            "mfu_pct": mfu(b3),
            "batch": batch,
            "dtype": "bfloat16",
            "wrn18_crop_it_per_s": round(wrn18["value"], 2),
            "wrn18_tflops": round(tflops(wrn18), 2),
            "wrn18_mfu_pct": mfu(wrn18),
            "baseline_batch": BASELINE_BATCH,
            "device_ms_per_call": round(b3["device_ms"], 4)}


def run_arm(backbone: str, device: torch.device, save_output: str | None = None) -> dict:
    """One arm at BATCH on the card: {value, sec_per_call, flops, device_ms,
    launches} with each raster kernel's launches, and the depthwise kernel's
    (dw_bn_silu_squeeze, once an MBConv block), over the warm-up, the REPS
    timed calls and the FLOP-counting call."""
    fn, args = build(BATCH, backbone=backbone, device=device)
    counts = rc.RASTER_KERNEL.launches
    before, dw_before = dict(counts), dwc.DW_KERNEL.launches
    value, sec, device_ms, out = measure(fn, args, REPS)
    if save_output:
        np.save(save_output, out.cpu().numpy())
    flops = flops_per_call(fn, args)
    return dict(value=value, sec_per_call=sec, flops=flops, device_ms=device_ms,
                launches={**{k: counts[k] - before[k] for k in KERNELS},
                          "dw_bn_silu_squeeze": dwc.DW_KERNEL.launches - dw_before})


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--save-output", default=None,
                        help="write the B3 arm's last timed TCO_final here (.npy)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench: no CUDA card (torch.cuda.is_available() is False); the bench runs on "
              "the card only", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = resolve_device("cuda")
    name = torch.cuda.get_device_name(dev)
    peak = peak_flops(name, torch.bfloat16)
    print(f"card: {card_identity()}", flush=True)
    if peak is None:
        print(f"bench: {name!r} has no bf16 peak in utils/card.PEAK_FLOPS: mfu_pct and "
              "wrn18_mfu_pct are null", flush=True)
    b3 = run_arm(ARMS[0], dev, args.save_output)
    baseline = cpu_baseline()
    wrn18 = run_arm(ARMS[1], dev)
    # each arm: (the warm-up + REPS timed + the FLOP-counting call) x N_ITER renders
    print("launches: " + json.dumps({ARMS[0]: b3["launches"], ARMS[1]: wrn18["launches"]}),
          flush=True)
    print(json.dumps(result_line(b3, wrn18, baseline, peak, BATCH)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
