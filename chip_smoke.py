"""Smoke run of the PyTorch/CUDA port (cosypose_tpu_torch) on one card.

    python3 chip_smoke.py        # from the repo root, on a machine with a CUDA card

Phases, none of them caught; any failure exits non-zero:
  1. device line, and the port's nvcc sources built from csrc/ (both raster
     kernels and the MBConv block's depthwise half, in parallel);
  2. the raster path at the main path's shapes (demo inputs, B=128, 240x320
     renders, LOD 512): the device kernels of one render() call, read from a
     short torch.profiler trace early in the process (one raster_setup, one
     raster_resolve, no sort kernel); kernel A (raster_setup: rows, keys and
     their stable y-order) against its plain version at its stated tolerance
     and its order equal to torch.sort's on the card; kernel B
     (raster_resolve) against its plain version on the same sorted rows, at
     budgets 1024 and 40, on the attribute variant (two-instance scene) and
     on every tile of a sweep (one ragged); device times of A, of torch.sort
     of its keys alone (the sort the port no longer calls) and of B by
     torch.profiler, of the whole render() call by CUDA events; their
     bounds, and how many rows the cull keeps;
  3. the slice (PosePredictor, EfficientNet-B3, fp32, TF32 off) at B=4 on
     the card (kernels) against the CPU (plain versions);
  4. serving: coarse + refiner B3 (bf16 backbone) behind
     CoarseRefinePosePredictor(bsz_objects=128), 3 requests of 4 images and
     160 detections at 1 coarse + 4 refiner iterations, with both kernels'
     launch counts checked; then one profiled request;
  5. training: one train step of a small configuration (EfficientNet-B0,
     48x64 renders, batch 8, 2 iterations) on the card against the CPU from
     the same weights, batch and draws; then the full-width trainer,
     train_pose with make_cfg("tless-refiner") (B3, 240x320, fp32, 3
     iterations, batch 32, 540x720 images) over the in-memory demo dataset:
     a warm-up step, a checkpoint resume round trip, 8 timed steps with both
     kernels' launch counts checked (3 a step); peak memory and time of a
     step with remat on and off; one step split into forward, backward and
     optimizer by CUDA events, and one profiled step;
  6. recording and data: kernel A on a full-width procedural scene soup (8
     objects and the cage, >= 8,872 rows, 10 cameras) against its plain
     version; the attribute kernel on it (240x320, tile (8, 320), budget
     6144) against its plain version on the CPU, exactly, and at the
     config's largest scene (7 objects) on the card; both kernels at the
     amodal re-render's shape as the sampler builds it (80 items, tile (24,
     320), budget 768), exactly; record_dataset with CONFIGS["procedural"]
     (55 chunks x 20 frames) and "procedural-canon" (2 x 10) into
     build/chip_smoke_data/, with the kernels' launches held to the
     sampler's render calls, frames/s and a frame's split; the set read back
     through make_scene_dataset and held to what the sampler produced, and
     its decode time; the trainer with make_cfg("procedural-refiner") over
     it, 8 timed steps with 0 loader workers and 32 with 8 (3 launches of
     each kernel a step); one small scene recorded on the card and on the
     CPU, equal;
  7. evaluation, on what phase 6 leaves: run_procedural_accuracy at full
     width (the procedural-refiner-w0 checkpoint, B3 bf16, 240x320, the 60
     recorded val frames, 4 iterations from gt + noise), with the kernels'
     launches held to its chunks of 64 objects; compute_bop19_ar of its
     predictions over the same frames, VSD through BatchRenderer on the
     recorded depth, launches held to the (image, label) groups, a frame's
     time split into VSD renders, host VSD and MSSD/MSPD; both kernels at
     the VSD shape (the largest group) against their plain versions, and the
     object pixels BatchRenderer's budget keeps over all groups; train_pose
     of procedural-refiner with its validation set and the evaluation bundle
     (test/... metrics in log.txt, the state dict bitwise unchanged across a
     callback); the whole evaluation of 3 frames on the card and on the CPU;
  8. the detection path, on what phase 6 records: the CenterNet detector
     (WideResNet-18, 21 classes) forward and decode at 480x640, batch 16, in
     both cls_modes (ms a batch, frames/s, peak memory), and card vs CPU on
     2 frames at 240x320; detector-procedural trained on the recorded train
     frames with 8 loader workers, a checkpoint saved; procedural-refiner-mini
     (WideResNet-18 bf16, 120x160, batch 64) trained on procedural-canon,
     launches held to its steps, its checkpoint and config.yaml saved; the
     CorrNet flatten+lk and FlowNetS predictors card vs CPU; both kernels at
     the mini refiner's render shape (B=64, 120x160) against their plain
     versions; run_bop_inference --dataset procedural over the 60 val frames
     with those two checkpoints (detector -> refiner -> CSV, ADD(-S) and
     BOP19 AR), launches held to its refiner chunks x 4 iterations plus one
     per AR group;
  9. CosyPose stages 2-3 and ICP: ICPRefiner on the 60 recorded val frames
     (each frame a group, its GT poses 1 cm in x and 2 cm in z off with
     seeded noise, observed depth masked by the GT visible masks): median
     translation error before and after, icp_ok share, ms a group split into
     render, ICP loop and host, one launch of each kernel a group; both
     kernels at ICP's render shape (a frame's detections at 240x320, tile
     (24, 320), budget 768) against their plain versions; ICP card vs CPU on
     the same depths; multiview at the reference's protocol scale
     (bench_multiview.make_scenario's defaults: 8 views, 12 objects, 2,000
     RANSAC hypotheses a view pair, BA at 100 iterations) with its stages'
     times, LM iterations, final loss and peak memory, relative camera poses
     held to the scene's within 0.02, and card vs CPU (matched candidates
     and best view pairs equal); the CLIs run_bop_inference --icp on phase
     8's models, run_cosypose_eval --use-detections-tco --nviews 4 on a CSV
     of noisy GT poses of the val frames, and run_custom_scenario on the
     protocol-scale scene written as a scenario directory;
 10. data parallelism (data_parallel_phase): tless-refiner 8 steps under
     DDP at world size 1 over NCCL against one process without a group
     (phase 5's step tolerances, parameters to the Adam updates' spread,
     ms/step both ways), then two gloo ranks sharing the card (16 rows
     each) against one process at 32 (2 compared steps, 6 timed ones), both
     kernels against their plain versions on each rank, FSDP2 against DDP
     on those ranks, and the gathers (reduce_dict, TensorCollection, the
     meters) against one process;
 11. serving export and inspection (serving_export_phase): phase 4's B3
     bf16 refiner exported with torch.export at B=128, 4 iterations, saved
     under build/ and loaded back, held to the eager forward with 4
     launches of each kernel a call and both timed; the artifact in a fresh
     process with torch and the operators' module only, equal; bench_stages
     at B=128 with the raster bounds and its launches; a torch.profiler trace
     of one call in a fresh process (both kernels' events and the annotation)
     and in this process; run_procedural_accuracy --save-overlays,
     make_scene_renderings and test_render_objects on the card, both kernels
     held to their plain versions at their shapes;
 12. the JPEG data path and the depthwise lowerings (jpeg_phase): every
     committed JPEG fixture (tests/torch_port_data/jpeg) through the C++ and
     the numpy decoder, both equal to the Pillow arrays stored beside them
     (arithmetic-coded, lossless, CMYK, YCCK and block-smoothed files among
     them), with host decode times (a 480x640 frame, the VOC frames, the same
     frame as PNG, the 480x640 arithmetic-coded and CMYK frames); the CMYK
     fixtures through data/bop.py, the texture dataset and the background
     paste; masked_boxes_from_uv, BatchedMeshes.select and
     sample_points(deterministic=False, seed=3) card vs CPU; procedural-refiner trained with VOC backgrounds
     (PoseDataset(voc_root=...)) at 0 and 8 loader workers, an item's
     background held to the decoded, resized VOC image; one refiner
     iteration at B=128, B3 bf16, LOD 512 in each depthwise lowering
     (efficientnet-b3, +dwshift, +dwdense) from the same weights, features
     held to the grouped conv's, each timed by CUDA events; a BOP split of
     JPEG frames read through data/bop.py and run through phase 8's detector
     and refiner; both kernels held to their plain versions at the training
     step's, the lowerings' and the split's render shapes;
 13. the port's headline bench and entry point (bench_phase): `python -m
     cosypose_tpu_torch.bench` in a fresh process (B3 bf16 and WideResNet-18
     arms at B=128, 4 iterations, LOD 512; its CPU baseline at B=4), its
     result line's keys (bench.py's plus device_ms_per_call) and ranges, each
     arm's launches of both kernels held to (warm-up + REPS + the
     FLOP-counting call) x N_ITER; items 0-3 of its B=128 card output against
     bench.build on the CPU over the same inputs; entry() on the card, one
     launch of each kernel, both kernels against their plain versions at its
     render shape (full spheres, B=4), its output against entry(device="cpu");
 14. soups of any row count (large_soups_phase): two items of each of
     16,392, 65,896, 131,072 and 262,144 rows through render() (launches of
     kernel A, of its merge passes, of the binning launch and of the
     attribute kernel counted), then kernel A against its plain version
     with the launcher's choice (sorted runs and their merge), clusters of 8
     and runs of every length from 256 to 16,384 rows (the order equal to
     torch.sort's), each timed, with its runs launch and its merge alone
     beside torch.sort of the keys, and kernel B's binning launch and listed
     resolve against bin_chunks and resolve_plain bit for bit, each timed
     alone and together with its bound; record_dataset at ycbv-1M's sampler
     settings over eight seeded 8,192-face meshes (demo.dense_specs); an
     8-object scene with the cage (65,896 rows, 480x640) through both
     kernels against their plain versions on the card, timed as above;
 15. the MBConv block's depthwise half (dw_kernel_phase): the kernel at each
     of EfficientNet-B3's 26 blocks at B=64, 240x320, bf16, against its plain
     version within depthwise_cuda.error_limit and bit for bit against a
     second call, in fp32 and fp16 at four shapes, and at odd sizes; the 26
     launches timed together and each shape alone beside the byte bound, the
     plain version and the ATen chain it replaces (library_ms); host us a call
     of the ctypes launcher, the registered operator and the ATen chain.
 16. Mask R-CNN's NMS (nms_kernel_phase): the published Mask R-CNN at
     480x640, 22 classes, bf16, with the benchmark reference's seeded
     weights; the kernel at the RPN's call (4,140 boxes in 5 level groups)
     and the box head's (its candidates in their class groups), as the
     model makes them, EQUAL in kept rows to nms_plain, timed beside the byte
     bound and the plain version; three frames through
     Detector.get_detections with 2 launches a frame.
Wherever kernel A is held to its plain version (setup_vs_plain), its order is
also held to torch.sort's element for element, and where it is timed
(setup_timing) so are one block an item and torch.sort of its keys alone.
Phases 5-6 also log what torch.profiler still records in this process
(profiler_device_events). The last lines are the card's name and power
limit, one JSON line of kernel numbers (launches while serving, training,
recording, evaluating, on the detection path, in ICP, data parallel, a call
of the exported program, bench_stages, the inspection surfaces, the JPEG
phase's training runs, BOP split and lowerings, the bench's arms and entry(),
phase 14's large soups and recording;
the shapes each kernel was held to its plain version at; the attribute
kernel's times at the scene shape), and the contract line
{"ok": true, "device": {...}}. Without a card, or outside the repo, it exits
non-zero and prints no result. The profiler tables go to
build/chip_smoke_profile.txt and build/chip_smoke_train_profile.txt.
"""

from __future__ import annotations

import dataclasses
import json
import math
import pathlib
import subprocess
import sys
import tempfile
import time

REPO = pathlib.Path(__file__).resolve().parent
OUT_DIR = REPO / "build"
RENDER = (240, 320)
IMAGE = (480, 640)
LOD = 512
BATCH = 128
N_COARSE, N_REFINER = 1, 4
N_IMAGES, N_DETECTIONS = 4, 160
TILES = [(8, 32), (16, 16), (16, 32), (32, 32), (8, 64), (16, 64)]  # (32, 32): ragged rows
ATOL_KERNEL = 1e-4   # depth and rgb, kernel B vs plain (same arithmetic: expect 0)
ATOL_SLICE = 1e-3    # TCO_final, card vs CPU (cuDNN vs oneDNN summation order)
SOURCES = {"raster_setup": "cosypose_tpu_torch/csrc/raster_setup.cu",
           "raster_setup_merge": "cosypose_tpu_torch/csrc/raster_setup.cu",
           "raster_resolve": "cosypose_tpu_torch/csrc/raster_resolve.cu",
           "raster_resolve_attr": "cosypose_tpu_torch/csrc/raster_resolve.cu",
           "raster_resolve_bin": "cosypose_tpu_torch/csrc/raster_resolve.cu",
           "raster_resolve_listed": "cosypose_tpu_torch/csrc/raster_resolve.cu"}
REPLACES = {"raster_setup": "cosypose_tpu/ops/rasterizer_pallas.py:149",
            "raster_setup_merge": "cosypose_tpu/ops/rasterizer_pallas.py:200",
            "raster_resolve": "cosypose_tpu/ops/rasterizer_pallas.py:49",
            "raster_resolve_attr": "cosypose_tpu/ops/rasterizer_pallas.py:49",
            "raster_resolve_bin": "cosypose_tpu/ops/rasterizer_pallas.py:202",
            "raster_resolve_listed": "cosypose_tpu/ops/rasterizer_pallas.py:49"}
# MBConv blocks of EfficientNet-B3: an eval B3 call on the card launches the
# depthwise kernel (ops/depthwise_cuda.py) once a block
B3_BLOCKS = 26
PR1 = "PR 1: prologue 2.433 ms + kernel 0.2628 ms per call, request ~490 ms, idle 0.098"
# training: the small card-vs-CPU step, and the full-width trainer's run
SMALL_B, SMALL_RENDER, SMALL_IMAGE = 8, (48, 64), (240, 320)
TRAIN_IMAGE = (540, 720)    # make_cfg("tless-refiner").input_resize
TRAIN_STEPS = 8
# card vs CPU tolerances of one train step: those the CPU tests state between
# two float32 implementations of it (tests/test_torch_port_training.py, the
# port against the JAX package)
RTOL_STEP = 3e-5            # loss, its components, grad_norm
REL_GRAD = 4e-3             # of each gradient tensor's max
REL_STATS = 1e-4            # BatchNorm running statistics, of their scale
ATOL_PARAM = 1e-6           # beyond what the gradients' difference moves Adam's step
REL_ZERO = 1e-6             # a gradient that is 0 in exact arithmetic, of the largest
# recording and data: CONFIGS["procedural"] (240x320, 10 views a scene), a
# scene of 8 objects and the cage for the attribute kernel (>= 8,872 rows),
# the recorded set, and the trainer over it (make_cfg("procedural-refiner"))
SCENE_OBJECTS, SCENE_CAMERAS = 8, 10
# chunks x frames a chunk: 55 x 20 puts 1,040 frames in the train split, one
# distinct frame for each sample of the trainer's longest run
RECORD = {"procedural": (55, 20), "procedural-canon": (2, 10)}
SMALL_SCENE = (96, 128)
DATA_ROOT = OUT_DIR / "chip_smoke_data"
# timed steps of 32 with n loader workers: with 8, twice the 8 x 2 batches
# that DataLoader's workers queue before the first step, so the run's later
# half waits on batches asked for while it trains
LOADER_STEPS = {0: 8, 8: 32}
# the recorder writes depth as trunc(depth * 1000) of the sampler's whole
# millimetres / 1000, as the JAX package does: a value may come back 1 mm lower
DEPTH_TOL = 1e-3 + 1e-6
# evaluation: the recorded val split (3 chunks of 20 frames) and the
# procedural-refiner-w0 run of phase 6
EVAL_FRAMES, EVAL_ITERATIONS, EVAL_BSZ = 60, 4, 64
EVAL_CPU_FRAMES = 3         # the evaluation card vs CPU
BUNDLE_FRAMES, BUNDLE_STEPS = 30, 2   # the bundle's frames; train steps an epoch, 2 epochs
# evaluation card vs CPU over 3 frames: BOP19 AR of the accuracy CLI's seeded
# initial poses, and the meters of the GT poses with this noise (poses they
# match: the CLI's initial poses lie beyond the 0.1-diameter threshold). The
# procedural objects have no symmetry, so ADD(-S) is ADD there; the ADD-S
# meter drives the nearest-point errors on the card.
METER_NOISE = dict(euler_deg_std=(1.0, 1.0, 1.0), trans_std=(0.002, 0.002, 0.002))
METER_TYPES = ("ADD(-S)", "ADD-S")
# |card - CPU| limits (0 where not listed) and pixel counts, as measured on
# an H100. The AR metrics and the meters' counts, AP and match sets come out
# equal; the meters' float32 errors and what derives from them differ by up
# to 1.02e-9 (ADD-S AUC). The two setups' rows
# differ in their last bits (the setup kernel's tolerance, SETUP_TOL), and
# with the same sort order, at any budget, that alone changes the winning
# surface at 273 of 1,228,800 rendered pixels, by up to 7.04 cm, and the
# place in e_VSD of 5 of 6,597 pixels.
EVAL_CPU_LIMITS = {**{f"{t} {k}": 1.1e-9 for t in METER_TYPES
                      for k in ("norm", "AUC", "AUC/objects/mean", "matched errors (m)")},
                   "largest depth difference where both draw (m)": 0.0705}
# the detection path: the detector at BOP's width (bop_config input 640x480,
# batch 16, 21 classes, 64 detections); card vs CPU at 240x320 on 2 frames
# (head outputs within ATOL_SLICE; decoded sets differ at near-tie peaks,
# counted, at most DET_SET_DIFF an image); detector-procedural trained for
# DET_STEPS steps with its 8 loader workers; procedural-refiner-mini for
# MINI_STEPS; run_bop_inference over the 60 recorded val frames, keeping
# every positive-score detection (a detector this briefly trained scores
# below the CLI's 0.3 default)
DET_BATCH, DET_CLASSES, DET_REPS = 16, 21, 5
DET_CPU_SIZE, DET_SET_DIFF = (240, 320), 4
DET_STEPS, MINI_STEPS = 24, 8
BOP_DETECTION_TH = 0.0
# CosyPose stages 2-3 and ICP: the GT poses' offset (m) and its seeded noise;
# ICP card vs CPU on one frame within the gpu test's limit; bench_multiview's
# protocol scale with BA at run_custom_scenario's iterations; relative camera
# poses to the scene's: rotation entries within tests/test_multiview.py's
# 0.02, translations within 5 cm (on this scene the JAX package's own BA, on
# the CPU, lands 40.3 mm and 0.0162 from them: the reprojection residual of
# 4-12 cm cubes 1 m away holds a camera's depth loosely); card vs CPU: the
# matches and view pairs equal; BA's objects in the cameras' frames (free of
# its gauge) within 2e-3 and its final loss within 1e-5 relative, and no
# limit on the LM iterations: both stop on |Δloss| < 1e-5 at the float32
# noise of a 180x180 pinv (ROADMAP §3; measured on an NVIDIA H100 80GB HBM3,
# 700.00 W: 53 iterations on the card, 49 on the CPU, losses 3.6e-6
# relative apart, world poses 9.0e-4 apart); the noisy GT poses
# run_cosypose_eval starts from (2 mm, 1 deg), of the objects visible at
# MV_VISIB_MIN or more, for the view groups in which
# some pair of views shares at least MV_SHARED_MIN of them (RANSAC's least
# inlier count, so that the group has a view pair to match)
ICP_OFFSET, ICP_NOISE = (0.01, 0.0, 0.02), 0.002
ICP_CPU_ATOL = 1e-3
BOP_VISIB_MIN = 0.1         # BOP's targets: GT objects at least 10 % visible
MV_SCALE = dict(n_views=8, n_objects=12, n_labels=6, dup=4, outliers=5)
MV_RANSAC_ITER, MV_BA_ITER = 2000, 100
MV_REL_ROT_ATOL, MV_REL_T_ATOL = 0.02, 0.05
MV_CPU_POSE_ATOL, MV_CPU_LOSS_RTOL, MV_CPU_TC1C2_ATOL = 2e-3, 1e-5, 1e-5
MV_NOISE_T, MV_NOISE_DEG = 0.002, 1.0
MV_SHARED_MIN, MV_VISIB_MIN, MV_NVIEWS = 3, BOP_VISIB_MIN, 4
# data parallelism: tless-refiner steps under DDP at world size 1 over NCCL
# (the card's one rank), then two gloo ranks sharing the card at half the
# batch each, FSDP2 (fsdp) against DDP (replicated) on them; the ranks'
# compared steps, then steps timed only
DP_STEPS = 8
DP_RANK_STEPS = 2
DP_RANK_TIMED = 6
DP_WORLD = 2
# serving export: the exported program against the eager forward (the same
# ATen ops and kernels on the same inputs: expect equal); overlay panels
EXPORT_ATOL = 1e-5
N_OVERLAYS = 4
# the JPEG data path: the committed fixtures and VOC-layout tree of
# tests/torch_port_data/jpeg (written with Pillow by
# tests/torch_port_make_jpeg_fixtures.py, which also reads Pillow's decode of
# each file stored beside them); host decode timings a file; procedural-refiner's
# steps with VOC backgrounds at 0 and 8 loader workers; the depthwise
# lowerings' outputs against the grouped conv's, relative to their largest
# magnitude (the CPU test's bf16 limit, tests/test_torch_port_backbone.py);
# the JPEG BOP split's frames (the 480x640 fixtures, each twice)
JPEG_FRAME = "frame_420_q95.jpg"
JPEG_DECODES = 20
# the 480x640 arithmetic-coded and CMYK frames (decode times) and the CMYK
# fixtures the readers take (data/bop.py, data/texture_dataset.py and the
# background paste), held to the stored Pillow arrays
JPEG_MODE_FRAMES = ("frame_arith_420_q90.jpg", "frame_cmyk_q90.jpg")
JPEG_CMYK = ("small_cmyk_q90.jpg", "small_ycck_2211.jpg", "frame_cmyk_q90.jpg")
VOC_STEPS = {0: 6, 8: 32}
DW_IMPLS = ("conv", "shift", "dense")
DW_REPS = 5
DW_BF16_RTOL_OF_MAX = 0.05
JPEG_BOP_FRAMES = ("frame_420_q95.jpg", "frame_420_q90_progressive.jpg") * 2
EVAL_CPU_COUNTS = {"render mask pixels that differ": 0,
                   f"depth pixels beyond {ATOL_KERNEL} m where both draw": 273,
                   "VSD pixels that differ": 5}


def log(msg: str) -> None:
    print(msg, flush=True)


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


# profiler sessions device_ms runs before it gives up on an empty one
PROFILER_SESSIONS = 3


def device_ms(fn, reps: int = 20) -> float:
    """Mean device time of the kernels fn() launches, by torch.profiler: for
    calls too short for CUDA events, which then time the host's dispatch.
    The profiler on the card can lose every device record of a short session
    (PERF.md §7: the longer the process has lived, the more), so a session
    that comes back empty is run again with four times the calls, up to
    PROFILER_SESSIONS times; raises where none records device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILER_SESSIONS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        averages = prof.key_averages()
        events = [e for e in averages if e.device_type == DeviceType.CUDA]
        if events:
            attr = "self_device_time_total" if hasattr(events[0], "self_device_time_total") \
                else "self_cuda_time_total"
            return sum(getattr(e, attr) for e in events) / 1e3 / reps
        log(f"torch.profiler recorded no device activity over {reps} calls "
            f"({len(averages)} host events); again with {4 * reps}")
        reps *= 4
    raise RuntimeError(f"torch.profiler recorded no device activity in {PROFILER_SESSIONS} "
                       "sessions")


def queued_ms(fn, reps: int) -> float:
    """Mean device time of fn() by CUDA events, its launches queued behind a
    spin kernel so that the host's enqueue time stays off the clock (fn must
    not synchronize)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)   # ~25 ms of spinning: longer than enqueuing reps calls
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cull_counts(rows, order, image, tile, budget):
    """(listed, kept): (row, warp) pairs of listed rows, and those that the
    resolve kernel's cull (rasterizer_cuda.row_may_cover on each warp's pixel
    rectangle) keeps, counted through the plain binning."""
    import torch

    from cosypose_tpu_torch.ops import rasterizer_cuda as rc

    srt, idx, counts = rc.bin_chunks(rows, order, image, tile, budget)
    B, T, Kc = idx.shape
    _, *rect = rc.warp_rects(image, tile, rows.device)
    row_ids = (idx.long()[..., None] * rc.CHUNK + torch.arange(rc.CHUNK, device=rows.device))
    listed_rows = torch.gather(srt, 1, row_ids.flatten(1)[..., None].expand(-1, -1, rc.ROW))
    listed_rows = listed_rows.reshape(B, T, Kc * rc.CHUNK, 1, rc.ROW)
    live = (torch.arange(Kc, device=rows.device) < counts[..., None]).repeat_interleave(
        rc.CHUNK, -1)[..., None]
    kept = rc.row_may_cover(listed_rows, *[r[None, :, None, :] for r in rect]) & live
    return int(live.sum()) * rect[0].shape[1], int(kept.sum())


def small_train_cfg():
    from cosypose_tpu_torch.models.pose_predictor import PosePredictorConfig
    from cosypose_tpu_torch.training.pose_training import PoseTrainConfig

    return PoseTrainConfig(
        predictor=PosePredictorConfig(backbone="efficientnet-b0", render_size=SMALL_RENDER,
                                      n_points_crop=200, head_init_scale=0.01,
                                      drop_connect_rate=0.0),
        n_iterations=2, n_points_loss=2600, input_generator="gt+noise", batch_size=SMALL_B,
        epoch_size=SMALL_B, n_epochs_warmup=1)


def train_step_card_vs_cpu(cfg=None) -> dict:
    """One train step on the card (raster kernels, cuDNN) and on the CPU (plain
    versions) from the same weights, batch (demo dataset, uint8 images) and
    draws. Returns {quantity: (error, tolerance)}; the caller checks them.

    Two float32 implementations of the step are held to the tolerances the
    CPU tests state between two float32 implementations (the port against
    the JAX package; each lies up to ~1e-3 of a gradient tensor's max from
    the float64 step at these sizes). Gradients are the clipped ones, of each
    tensor's max; a block's last BatchNorm bias has a gradient that is 0 in
    exact arithmetic (the next train-mode BatchNorm removes it), held at
    REL_ZERO of the largest gradient on both sides. Running statistics are
    of their scale, for a running mean the larger of its max and (1 - 0.99^n)
    times the channels' spread, since a batch mean's rounding follows the
    spread. A parameter may differ by what the two gradients move Adam's
    first step, lr·g/(|g| + 1e-8), plus ATOL_PARAM.
    """
    import torch

    from cosypose_tpu_torch import demo
    from cosypose_tpu_torch.ops.mesh_db import build_mesh_db
    from cosypose_tpu_torch.training import pose_training as tpt
    from cosypose_tpu_torch.training.train_pose import collate

    cfg = cfg or small_train_cfg()
    ds = demo.DemoPoseDataset(cfg.batch_size, SMALL_IMAGE, seed=2)
    host = collate([ds[i] for i in range(len(ds))])
    snaps, state_dict, draws = {}, None, None
    for d in ("cpu", "cuda"):
        db = build_mesh_db(demo.demo_specs(), render_max_faces=LOD, device=d)
        state = tpt.create_train_state(cfg, d)
        if state_dict is None:
            state_dict = {k: v.clone() for k, v in state.pp.net.state_dict().items()}
            draws = tpt.draw_step(cfg, state.pp, cfg.batch_size, db.points.shape[1],
                                  torch.Generator().manual_seed(3))
        state.pp.net.load_state_dict(state_dict)
        batch = {k: host[k].to(d) for k in ("images", "K", "TCO", "bboxes")}
        batch["label_ids"] = db.ids_for(host["labels"])
        metrics = tpt.make_train_step(cfg, db)(state, batch, draws)
        snaps[d] = step_snapshot(state.pp.net, metrics)
    return step_errors(snaps["cuda"], snaps["cpu"], cfg)


def step_snapshot(net, metrics: dict, optimizer=None) -> dict:
    """A train step's metrics, parameters, gradients and running statistics
    and, given the optimizer, its Adam moments, in float64 on the CPU, as
    step_errors compares them."""
    out = dict(metrics={k: float(v) for k, v in metrics.items()},
               params={n: p.detach().double().cpu() for n, p in net.named_parameters()},
               grads={n: p.grad.double().cpu() for n, p in net.named_parameters()},
               buffers={n: b.double().cpu() for n, b in net.named_buffers()
                        if n.endswith(("running_mean", "running_var"))})
    if optimizer is not None:
        for k in ("exp_avg", "exp_avg_sq"):
            out[k] = {n: optimizer.state[p][k].double().cpu() for n, p in net.named_parameters()}
    return out


def rank_snapshot(step: dict) -> dict:
    """A step of parallel.rank_checks.pose_steps (kept with its gradients,
    and its moments where kept) as step_snapshot gives it."""
    sd, grads = step["state_dict"], step["grads"]
    out = dict(metrics=step["metrics"], params={n: sd[n].double() for n in grads},
               grads={n: g.double() for n, g in grads.items()},
               buffers={n: b.double() for n, b in sd.items()
                        if n.endswith(("running_mean", "running_var"))})
    for k in ("exp_avg", "exp_avg_sq"):
        if k in step:
            out[k] = {n: m.double() for n, m in step[k].items()}
    return out


def update_spread(a: list, b: list, n_steps: int) -> dict:
    """By parameter name, the sum over the first n_steps of |a's Adam update
    - b's| (parallel.rank_checks.adam_updates of each step), in float64 on
    the CPU: the most two runs' parameters can differ after those steps."""
    return {n: sum((a[k][n].double().cpu() - b[k][n].double().cpu()).abs()
                   for k in range(n_steps)) for n in a[0]}


def step_errors(card: dict, cpu: dict, cfg, n_steps: int = 1, spread: dict | None = None) -> dict:
    """{quantity: (error, tolerance)} of two snapshots of the same train
    step(s) (see train_step_card_vs_cpu for the tolerances). After one step
    a parameter may differ by what the two gradients move Adam's first step
    plus ATOL_PARAM; after n_steps > 1, element by element, by `spread`
    (update_spread: the sum of the two runs' Adam updates' differences, as
    their moments give them) plus ATOL_PARAM. Where both snapshots hold Adam
    moments, the first is held as the gradients and the second within twice
    their tolerance, of each tensor's max (as the CPU tests hold them). A
    block's last BatchNorm bias has a zero gradient only without
    drop-connect; with it, that gradient is what the dropped samples leave
    of terms that cancel over the batch (up to ~1 % of the largest gradient,
    ~1e-9 in a block that dropped none), and is held within REL_GRAD of the
    largest gradient; its moments are of the largest tensor's max. The
    parameters' largest difference is given in units of the lr, against the
    most Adam can move them apart, 2·n_steps."""
    if n_steps > 1 and spread is None:
        raise ValueError("parameters after more than one step need the updates' spread")
    floor = max(float(g.abs().max()) for g in cpu["grads"].values())
    grad_err = zero_err = param_err = param_max = stats_err = 0.0
    structural = cfg.predictor.drop_connect_rate == 0.0
    for n, g in cpu["grads"].items():
        if n.endswith("_bn2.bias") and structural:
            zero_err = max(zero_err, float(g.abs().max()) / floor,
                           float(card["grads"][n].abs().max()) / floor)
        elif n.endswith("_bn2.bias"):
            grad_err = max(grad_err, float((card["grads"][n] - g).abs().max()) / floor)
        else:
            grad_err = max(grad_err, float((card["grads"][n] - g).abs().max() / g.abs().max()))

        def adam(g):
            return cfg.lr * g / (g.abs() + 1e-8)

        diff = (card["params"][n] - cpu["params"][n]).abs()
        param_max = max(param_max, float(diff.max()) / cfg.lr)
        if spread is None:
            bound = (adam(card["grads"][n]) - adam(g)).abs()
            param_err = max(param_err, float(diff.max()) - 2 * cfg.lr)
        else:
            bound = spread[n]
        param_err = max(param_err, float((diff - bound).max()))
    w = 1 - 0.99 ** (cfg.n_iterations * n_steps)
    for n, b in cpu["buffers"].items():
        scale = float(b.abs().max())
        if n.endswith("running_mean"):
            var = cpu["buffers"][n.replace("running_mean", "running_var")]
            scale = max(scale, w * float(var.sqrt().max()))
        stats_err = max(stats_err, float((card["buffers"][n] - b).abs().max()) / scale)
    out = {f"metric {k}": (abs(card["metrics"][k] / v - 1), RTOL_STEP)
           for k, v in cpu["metrics"].items()}
    out["gradients (of each tensor's max)"] = (grad_err, REL_GRAD)
    out["zero gradients (of the largest)"] = (zero_err, REL_ZERO)
    out["running statistics (of their scale)"] = (stats_err, REL_STATS)
    out["parameters (beyond the Adam spread)"] = (param_err, ATOL_PARAM)
    out["parameters' largest difference (in lr)"] = (param_max, 2.0 * n_steps)
    for k, tol in (("exp_avg", REL_GRAD), ("exp_avg_sq", 2 * REL_GRAD)):
        if k in card and k in cpu:
            top = max(float(m.abs().max()) for m in cpu[k].values())
            err = 0.0
            for n, m in cpu[k].items():
                scale = top if n.endswith("_bn2.bias") else float(m.abs().max())
                err = max(err, float((card[k][n] - m).abs().max()) / max(scale, REL_ZERO * top))
            out[f"Adam {k} (of each tensor's max)"] = (err, tol)
    return out


def check_errors(what: str, errs: dict) -> str:
    """Raise where an error of step_errors exceeds its tolerance; else the
    errors as a line."""
    bad = {k: v for k, v in errs.items() if not v[0] <= v[1]}
    if bad:
        raise AssertionError(f"{what} beyond tolerance: {bad}")
    return ", ".join(f"{k} {e:.3g} (<= {tol})" for k, (e, tol) in errs.items())


def meter_frames(seed: int, n_views: int = 6):
    """(pred columns, pred poses, GT columns, GT poses) over the demo
    spheres' labels: up to 2 instances a label a view, predictions near most
    GTs (2 mm to 3 cm off), far-off ones, tied scores."""
    import numpy as np

    rng = np.random.RandomState(seed)

    def pose():
        q = rng.normal(size=4)
        w, x, y, z = q / np.linalg.norm(q)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = [[1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                     [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                     [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]]
        T[:3, 3] = [*rng.uniform(-0.1, 0.1, 2), 0.7]
        return T

    gt, gt_T, pred, pred_T = [], [], [], []
    for view in range(n_views):
        for label in ("obj_000001", "obj_000002"):
            for _ in range(rng.randint(1, 3)):
                T = pose()
                gt.append((1, view, label, float(np.round(rng.rand(), 2))))
                gt_T.append(T)
                for k in range(rng.randint(0, 3)):
                    P = T.copy()
                    P[:3, 3] += rng.normal(0, [0.002, 0.03][k], 3)
                    pred.append((1, view, label, float(np.round(rng.rand(), 1))))
                    pred_T.append(P)
            pred.append((1, view, label, 0.5))
            pred_T.append(pose())
    keys = ["scene_id", "view_id", "label"]

    def cols(rows, names):
        return {n: np.asarray(v) for n, v in zip(names, zip(*rows))}

    return (cols(pred, keys + ["score"]), np.stack(pred_T), cols(gt, keys + ["visib_fract"]),
            np.stack(gt_T))


def data_parallel_phase(tag: str, checked: dict) -> dict:
    """Phase 10: tless-refiner (B3 fp32, batch 32, 3 iterations) on the demo
    spheres. (a) DP_STEPS steps under DDP at world size 1 over NCCL against
    the same steps in one process without a group; (b) DP_RANK_STEPS steps on
    two gloo ranks sharing the card, 16 rows each, against the one process at
    32, and both raster kernels against their plain versions on each rank at
    its render shape; (c) FSDP2 against DDP on the two gloo ranks; (d) the
    gathers across the two ranks against one process. Parameters after more
    than one step are held element by element to the two runs' Adam updates'
    spread (step_errors), moments beside them. Returns the kernels' launches
    on the world-1 run and on each rank."""
    import numpy as np
    import torch

    from cosypose_tpu_torch import demo
    from cosypose_tpu_torch.evaluation import meters as tm
    from cosypose_tpu_torch.models.efficientnet import BatchNorm2d
    from cosypose_tpu_torch.ops import rasterizer_cuda as rc
    from cosypose_tpu_torch.ops.mesh_db import build_mesh_db
    from cosypose_tpu_torch.parallel import rank_checks
    from cosypose_tpu_torch.parallel.spawn import free_port, spawn
    from cosypose_tpu_torch.training import pose_training as tpt
    from cosypose_tpu_torch.training.configs import make_cfg
    from cosypose_tpu_torch.training.train_pose import collate
    from cosypose_tpu_torch.utils import distributed as tdist
    from cosypose_tpu_torch.utils.tensor_collection import TensorCollection

    kernel = rc.RASTER_KERNEL
    dev = torch.device("cuda", 0)
    run = make_cfg("tless-refiner")
    tcfg = run.train
    B, n_it = tcfg.batch_size, tcfg.n_iterations
    pred = tcfg.predictor
    db = build_mesh_db(demo.demo_specs(), render_max_faces=LOD, device=dev)
    ds = demo.DemoPoseDataset(B, TRAIN_IMAGE, seed=3)
    host = collate([ds[i] for i in range(B)])
    batch_np = {k: host[k].numpy() for k in ("images", "K", "TCO", "bboxes")}
    batch_np["label_ids"] = db.ids_for(host["labels"]).cpu().numpy()
    batch = {k: torch.as_tensor(v).to(dev) for k, v in batch_np.items()}
    batch["label_ids"] = batch["label_ids"].long()
    state = tpt.create_train_state(tcfg, dev)
    sd0 = {k: v.detach().cpu().clone() for k, v in state.pp.net.state_dict().items()}
    n_bn = sum(isinstance(m, BatchNorm2d) for m in state.pp.net.modules())
    gen = torch.Generator().manual_seed(11)
    draws = [tpt.draw_step(tcfg, state.pp, B, db.points.shape[1], gen) for _ in range(DP_STEPS)]

    def steps(state, step):
        snaps, times, updates = [], [], []
        for i, d in enumerate(draws):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = step(state, batch, d)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            updates.append(rank_checks.adam_updates(state.pp.net, state.optimizer))
            snaps.append(step_snapshot(state.pp.net, metrics, state.optimizer)
                         if i in (0, 1, DP_STEPS - 1)
                         else dict(metrics={k: float(v) for k, v in metrics.items()}))
        return snaps, times, updates

    # (a) world size 1 over NCCL: DDP's gradient all-reduce, the global
    # BatchNorm's world-1 path, the metrics' mean
    t_phase = time.perf_counter()
    single, t_single, u_single = steps(state, tpt.make_train_step(tcfg, db))
    del state
    torch.cuda.empty_cache()
    tdist.init_distributed_mode("nccl", rank=0, world_size=1,
                                init_method=f"tcp://localhost:{free_port()}", device=dev)
    try:
        state = tpt.create_train_state(tcfg, dev, param_mode="replicated")
        state.dp.load_state_dict(sd0)
        kernel.launches = {k: 0 for k in kernel.launches}
        ddp, t_ddp, u_ddp = steps(state, tpt.make_train_step(tcfg, db))
        launches_world1 = dict(kernel.launches)
        backend = torch.distributed.get_backend()
        del state
    finally:
        tdist.destroy()
    torch.cuda.empty_cache()
    want = {"raster_setup": DP_STEPS * n_it, "raster_resolve": DP_STEPS * n_it,
            "raster_resolve_attr": 0, "raster_setup_merge": 0,
            "raster_resolve_bin": 0, "raster_resolve_listed": 0}
    if launches_world1 != want:
        raise AssertionError(f"DDP at world 1 launched {launches_world1}, want {want}")
    lines = [check_errors(f"DDP world 1 vs one process, step {i + 1}",
                          step_errors(ddp[i], single[i], tcfg, i + 1,
                                      update_spread(u_ddp, u_single, i + 1)))
             for i in (0, DP_STEPS - 1)]
    del u_ddp
    u_single = [{n: u.cpu() for n, u in us.items()} for us in u_single[:DP_RANK_STEPS]]
    torch.cuda.empty_cache()
    rel = max(abs(a["metrics"][k] / b["metrics"][k] - 1) for a, b in zip(ddp, single)
              for k in b["metrics"])
    if rel > RTOL_STEP:
        raise AssertionError(f"DDP world 1 vs one process: metrics {rel} apart over "
                             f"{DP_STEPS} steps (> {RTOL_STEP})")
    ms_single, ms_ddp = 1e3 * np.mean(t_single[1:]), 1e3 * np.mean(t_ddp[1:])
    log(f"{tag} (a) DDP at world size 1 over {backend}, tless-refiner ({pred.backbone}, "
        f"{pred.compute_dtype}, batch {B}, {n_it} iterations), {DP_STEPS} steps from the same "
        f"state and draws as one process without a group: metrics within {rel:.3g} over all "
        f"steps (<= {RTOL_STEP}); step 1: {lines[0]}; step {DP_STEPS}: {lines[1]}; ms/step "
        f"(steps 2-{DP_STEPS}, host clock to the device's end) one process {ms_single:.1f}, DDP "
        f"{ms_ddp:.1f} (DDP overhead {ms_ddp - ms_single:+.1f} ms, "
        f"{100 * (ms_ddp / ms_single - 1):+.2f} %); first steps {1e3 * t_single[0]:.1f} / "
        f"{1e3 * t_ddp[0]:.1f} ms; launches {launches_world1} (want {want})")

    # (b)-(d) two gloo ranks sharing the card
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_dp_", dir=OUT_DIR))
    pred_m, pred_T, gt_m, gt_T = meter_frames(5)
    meter_kw = dict(error_type="ADD(-S)", report_AP=True, report_error_AUC=True,
                    report_error_stats=True)
    coll = ({"view_id": pred_m["view_id"], "label": pred_m["label"], "score": pred_m["score"]},
            pred_T)
    n_rows = max(int((coll[0]["view_id"] % DP_WORLD == r).sum()) for r in range(DP_WORLD))
    pose = dict(cfg=tcfg, specs=[dataclasses.asdict(sp) for sp in demo.demo_specs()],
                render_max_faces=LOD, init=sd0, batch=batch_np, draws=draws[:DP_RANK_STEPS],
                keep=("grads", "moments", "updates"))
    cases = dict(
        kernels=("kernels_vs_plain", dict(batch=B // DP_WORLD, image_size=TRAIN_IMAGE,
                                          render_size=pred.render_size, tile=pred.raster_tile,
                                          budget=pred.raster_max_tris_per_tile, lod=LOD)),
        replicated=("pose_steps", dict(pose, param_mode="replicated", profile=True,
                                       timed_steps=DP_RANK_TIMED)),
        fsdp=("pose_steps", dict(pose, param_mode="fsdp")),
        gathers=("gathers", dict(collection=coll, n_rows=n_rows, dir=tmp,
                                 meter_frames=(pred_m, pred_T, gt_m, gt_T),
                                 meter_specs=[dataclasses.asdict(sp) for sp in demo.demo_specs()],
                                 meter_kw=meter_kw)))
    t0 = time.perf_counter()
    ranks = spawn(rank_checks.suite, DP_WORLD, (cases,), backend="gloo", device="cuda:0",
                  timeout_s=600)
    t_spawn = time.perf_counter() - t0
    launches_ranks = [r["replicated"]["launches"] for r in ranks]
    want = {"raster_setup": DP_RANK_STEPS * n_it, "raster_resolve": DP_RANK_STEPS * n_it,
            "raster_resolve_attr": 0, "raster_setup_merge": 0,
            "raster_resolve_bin": 0, "raster_resolve_listed": 0}
    for r, got in enumerate(ranks):
        k = got["kernels"]
        if k["setup_error"]["valid_differs"] or k["setup_error"]["plane"] > rc.SETUP_TOL \
                or k["setup_error"]["bbox_key"] > rc.SETUP_TOL or not k["order_equal"] \
                or k["resolve_max_abs_err"] != 0:
            raise AssertionError(f"rank {r}: raster kernels vs plain at {k['rows']}: {k}")
        if got["replicated"]["launches"] != want:
            raise AssertionError(f"rank {r} launched {got['replicated']['launches']}, want {want}")
    k0 = ranks[0]["kernels"]
    for name in ("raster_setup", "raster_resolve"):
        checked[name].append(f"data parallel rank: {k0['rows'][0]} x {k0['rows'][1]} rows, "
                             f"{pred.render_size}")
    rep = ranks[0]["replicated"]
    u_rep = [st["updates"] for st in rep["steps"]]
    lines = [check_errors(f"2 gloo ranks vs one process, step {i + 1}",
                          step_errors(rank_snapshot(rep["steps"][i]), single[i], tcfg, i + 1,
                                      update_spread(u_rep, u_single, i + 1)))
             for i in range(DP_RANK_STEPS)]
    same = all(ranks[1]["replicated"]["steps"][i]["metrics"] == rep["steps"][i]["metrics"]
               for i in range(DP_RANK_STEPS))
    if not same:
        raise AssertionError("the two ranks' metrics differ")
    prof = rep["profile"]
    coll_ms = max(prof["collectives_ms"].values(), default=float("nan"))
    ms_ranks = [[1e3 * t for t in r["replicated"]["timed_seconds"]] for r in ranks]
    log(f"{tag} (b) 2 gloo ranks on one card, {B // DP_WORLD} rows each (global {B}), "
        f"{DP_RANK_STEPS} steps from the same state and draws as one process at {B}: "
        + "; ".join(f"step {i + 1}: {line}" for i, line in enumerate(lines))
        + f"; ms/step over {DP_RANK_TIMED} timed steps after them, mean (min-max): "
        + ", ".join(f"rank {r} {np.mean(ms):.1f} ({min(ms):.1f}-{max(ms):.1f})"
                    for r, ms in enumerate(ms_ranks))
        + f" (one process at {B}: {ms_single:.1f}); one profiled step {prof['step_ms']:.1f} ms, "
        f"host time in collectives {coll_ms:.1f} ms ({100 * coll_ms / prof['step_ms']:.1f} %; "
        f"{ {k: round(v, 1) for k, v in prof['collectives_ms'].items()} }), "
        f"{2 * n_bn * n_it} BatchNorm all-reduces a step ({n_bn} layers x {n_it} iterations, "
        f"forward and backward); raster kernels vs plain on each rank at B={k0['rows'][0]} x "
        f"{k0['rows'][1]} rows: setup max abs err {max(r['kernels']['setup_max_abs_err'] for r in ranks):.3g}, "
        f"resolve equal; launches per rank {launches_ranks} (want {want}); spawn + run "
        f"{t_spawn:.1f} s")

    # (c) fsdp against replicated, on the two gloo ranks
    fsdp = ranks[0]["fsdp"]["steps"]
    u_fsdp = [st["updates"] for st in fsdp]
    lines = [check_errors(f"fsdp vs replicated (2 gloo ranks), step {i + 1}",
                          step_errors(rank_snapshot(fsdp[i]), rank_snapshot(rep["steps"][i]),
                                      tcfg, i + 1, update_spread(u_fsdp, u_rep, i + 1)))
             for i in range(DP_RANK_STEPS)]
    log(f"{tag} (c) fsdp (FSDP2) vs replicated (DDP) on the 2 gloo ranks sharing the card "
        f"(CUDA tensors; gloo takes FSDP2's reduce-scatter): "
        + "; ".join(f"step {i + 1}: {line}" for i, line in enumerate(lines)))

    # (d) the gathers against one process
    infos, poses = coll
    order = np.concatenate([np.flatnonzero(infos["view_id"] % DP_WORLD == r)
                            for r in range(DP_WORLD)])
    meter = tm.PoseErrorMeter(build_mesh_db(demo.demo_specs(), device=dev), **meter_kw)
    meter.add(TensorCollection(pred_m, poses=torch.as_tensor(pred_T).to(dev)),
              TensorCollection(gt_m, poses=torch.as_tensor(gt_T).to(dev)))
    ref = meter.summary()[0]
    for r, got in enumerate(ranks):
        g = got["gathers"]
        if g["reduce"] != {"a": 1.5, "b": 5.0, "c": 0.5} or g["reduce_sum"] != {"a": 3.0}:
            raise AssertionError(f"rank {r}: reduce_dict {g['reduce']}, {g['reduce_sum']}")
        for name in ("gather_distributed", "gather_multihost"):
            gi, gp = g[name]
            if not (all(np.array_equal(gi[k], v[order]) for k, v in infos.items())
                    and torch.equal(gp, torch.as_tensor(poses[order]))):
                raise AssertionError(f"rank {r}: {name} differs from the rows of one process")
        m = g["meter"]
        bad = [k for k, v in ref.items() if not (k in m and (m[k] == v or (
            isinstance(v, float) and (math.isnan(v) and math.isnan(m[k])
                                      or abs(m[k] - v) <= 1e-6 * abs(v) + 1e-12))))]
        if bad or set(m) != set(ref):
            raise AssertionError(f"rank {r}: the gathered meter differs in {bad}")
    log(f"{tag} (d) gathers over 2 ranks (CUDA tensors, gloo): reduce_dict, "
        f"TensorCollection.gather_distributed ({n_rows} rows a rank, padded) and "
        f"gather_multihost equal to one process; the meters' gather_multihost (default rank "
        f"and world) summarises {len(pred_m['label'])} predictions as one process does "
        f"(n_matched {ref.get('n_matched')}, AUC {ref.get('ADD(-S)_ntop=1_AUC', ref.get('AUC'))})")
    log(f"phase 10 took {time.perf_counter() - t_phase:.0f} s")
    return dict(nccl_world1=launches_world1, gloo_ranks=launches_ranks)


def profiler_device_events() -> dict:
    """What torch.profiler records in this process over one small matmul, by
    the activities asked for (CUDA alone, as device_ms asks; CPU and CUDA, as
    utils.profiling.trace asks): the device events in key_averages(), and the
    kernel events of the Chrome trace; 0 where it has stopped seeing the card
    (PERF.md §7). Then the device events of a CUDA-only session of 2,000
    small kernels: all of them, or all but a few."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(256, 256, device="cuda")
    out = {}
    for name, acts in (("cuda", [ProfilerActivity.CUDA]),
                       ("cpu+cuda", [ProfilerActivity.CPU, ProfilerActivity.CUDA])):
        with profile(activities=acts) as prof:
            float((x @ x).sum())
            torch.cuda.synchronize()
        path = OUT_DIR / "profiler_probe.json"
        prof.export_chrome_trace(str(path))
        out[name] = (sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                     sum(1 for e in json.loads(path.read_text())["traceEvents"]
                         if e.get("cat") == "kernel"))
    y = torch.zeros(64, device="cuda")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(2000):
            y += 1
        torch.cuda.synchronize()
    out["cuda, 2000 kernels"] = sum(e.count for e in prof.key_averages()
                                    if e.device_type == DeviceType.CUDA)
    return out


def captured_renders(fn, module=None):
    """(fn(), [(render args, kwargs), ...]): the ops.render calls that `module`
    (by default rendering.scene_renderer, whose scene and batch renderers
    amodal_inputs takes; or models.pose_predictor) makes inside fn."""
    from cosypose_tpu_torch.rendering import scene_renderer

    module = module or scene_renderer
    calls, render = [], module.render

    def keep(*args, **kwargs):
        calls.append((args, kwargs))
        return render(*args, **kwargs)

    module.render = keep
    try:
        return fn(), calls
    finally:
        module.render = render


def kernels_vs_plain_at(what: str, call, checked: dict) -> str:
    """Both kernels against their plain versions on the card at one captured
    render call's shape: setup within SETUP_TOL and its order equal to
    torch.sort's (setup_vs_plain), resolve (and its attribute) exactly equal
    on the same sorted rows."""
    import torch

    from cosypose_tpu_torch.ops import rasterizer_cuda as rc

    args, kw = call
    setup_args = (*args, kw["image_size"], kw["colors"])
    rows, key, order, _, err, abs_err = setup_vs_plain(setup_args, kw.get("tri_attr"))
    with_attr = kw.get("tri_attr") is not None
    size, tile, budget = kw["image_size"], kw["tile"], kw["max_tris_per_tile"]
    out_k = rc.RASTER_KERNEL.resolve(rows, order, size, tile, budget, with_attr)
    torch.cuda.synchronize()
    out_p = rc.resolve_plain_binned(rows, order, size, tile, budget, with_attr)
    n = 3 if with_attr else 2
    if not all(torch.equal(k, p) for k, p in zip(out_k[:n], out_p[:n])):
        raise AssertionError(f"{what}: the resolve kernel differs from its plain version")
    shape = f"{what}: {rows.shape[0]} x {rows.shape[1]} rows"
    checked["raster_setup"].append(shape)
    listed = rows.shape[1] > rc.RASTER_KERNEL.window_rows(rows.device)
    checked["raster_resolve_listed" if listed else "raster_resolve_attr" if with_attr
            else "raster_resolve"].append(f"{shape}, {tuple(size)}, tile {tuple(tile)}, "
                                          f"budget {budget}")
    return (f"{shape} at {size[0]}x{size[1]}, tile {tuple(tile)}, budget {budget}: setup plane "
            f"rel err {err['plane']:.3g}, max abs err {abs_err:.3g}, order equal to torch.sort's; "
            f"resolve"
            f"{' (attribute)' if with_attr else ''} equal")


# the subprocess of phase 11 (b) and (d): torch and the operators' modules
# only, the exported artifact and its inputs from build/
# the modules a loaded program imports: the operators' modules, and the ops
# and utils packages with what they re-export; no model, predictor, data,
# training or serving code
FRESH_MODULES = ["cosypose_tpu_torch"] + [f"cosypose_tpu_torch.{m}" for m in (
    "config", "ops", "ops.camera", "ops.cropping", "ops.depthwise_cuda", "ops.losses",
    "ops.mesh_db", "ops.mesh_io", "ops.mesh_ops", "ops.nvcc_build", "ops.pose_ops",
    "ops.rasterizer", "ops.rasterizer_cuda", "ops.render", "ops.roi_align", "ops.symmetric",
    "ops.symmetries", "ops.transform", "ops.transforms", "utils", "utils.device",
    "utils.distributed", "utils.logging", "utils.profiling", "utils.tensor_collection",
    "utils.timer")]

FRESH_LOAD = """
import sys, json, numpy as np, torch
import cosypose_tpu_torch.ops.depthwise_cuda as dwc
import cosypose_tpu_torch.ops.rasterizer_cuda as rc
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
art, inputs, out, trace_dir = sys.argv[1:5]
program = torch.export.load(art)
x = np.load(inputs)
dev = torch.device("cuda", 0)
args = [torch.as_tensor(x[k], device=dev) for k in ("images", "K", "TCO")]
args.append(torch.as_tensor(x["labels"], device=dev).long())
fn = program.module()
with torch.no_grad():
    rc.RASTER_KERNEL.launches = {k: 0 for k in rc.RASTER_KERNEL.launches}
    dwc.DW_KERNEL.launches = 0
    y = fn(*args)
    torch.cuda.synchronize()
    launches = dict(rc.RASTER_KERNEL.launches)
    np.save(out, y.cpu().numpy())
    report = dict(launches=launches, dw_launches=dwc.DW_KERNEL.launches,
                  modules=sorted(m for m in sys.modules if m.startswith("cosypose_tpu")))
    if trace_dir != "-":
        from cosypose_tpu_torch.utils.profiling import annotate, trace
        with trace(trace_dir) as prof:
            with annotate("served_request"):
                fn(*args)
                torch.cuda.synchronize()
        report["trace"] = str(prof.trace_path)
print(json.dumps(report))
"""


def serving_export_phase(tag: str, checked: dict, refiner, db, acc_args: list, val_ds,
                         mesh_db_p) -> dict:
    """Phase 11: the serving export and the inspection surfaces. (a) the
    serving refiner (phase 4's B3 bf16) exported at B=128, 480x640 frames,
    240x320 renders, LOD 512, N_REFINER iterations, saved under build/,
    loaded back and held to the eager forward (within EXPORT_ATOL), 4
    launches of each raster kernel and 4 x B3_BLOCKS of the depthwise kernel
    a call, ms a call both ways; (b) the artifact in a fresh process that
    imports torch and the operators' modules only, equal to (a), with the
    same launches; (c) bench_stages at B=128 with the raster stages' bounds and
    launches; (d) a torch.profiler trace of one call in a fresh process
    (both kernels' events and the annotation), then the same in this
    process; (e) run_procedural_accuracy --save-overlays on phase 7's
    checkpoint, make_scene_renderings of a recorded val frame and
    test_render_objects on the procedural set, each through the kernels with
    both kernels held to their plain versions at its shapes. Returns the
    kernels' launches per part."""
    import shutil

    import numpy as np
    import torch

    from cosypose_tpu_torch import demo
    from cosypose_tpu_torch.models.pose_predictor import gather_mesh_data
    from cosypose_tpu_torch.ops import depthwise_cuda as dwc
    from cosypose_tpu_torch.ops import rasterizer_cuda as rc
    from cosypose_tpu_torch.scripts import bench_stages, run_procedural_accuracy
    from cosypose_tpu_torch.scripts import test_render_objects
    from cosypose_tpu_torch.serving import export_pose_model, load_exported
    from cosypose_tpu_torch.utils import png
    from cosypose_tpu_torch.utils.profiling import annotate, trace
    from cosypose_tpu_torch.utils.tensor_collection import TensorCollection
    from cosypose_tpu_torch.visualization.multiview import make_scene_renderings

    kernel = rc.RASTER_KERNEL
    dev = torch.device("cuda", 0)
    out = {}
    t_phase = time.perf_counter()

    def reset():
        kernel.launches = {k: 0 for k in kernel.launches}
        dwc.DW_KERNEL.launches = 0

    # (a) export at full width, load back, hold to eager
    images, K, TCO, labels = demo.make_inputs(BATCH, *IMAGE)
    art = OUT_DIR / f"refiner_b{BATCH}_it{N_REFINER}.pt2"
    t0 = time.perf_counter()
    export_pose_model(refiner, BATCH, IMAGE, n_iterations=N_REFINER, out_path=art)
    t_export = time.perf_counter() - t0
    t0 = time.perf_counter()
    fn = load_exported(art, device=dev)
    t_load = time.perf_counter() - t0
    args = [torch.as_tensor(a, device=dev) for a in (images, K, TCO)]
    md = gather_mesh_data(db, torch.as_tensor(labels, device=dev).long(),
                          refiner.predictor.cfg.n_points_crop)
    with torch.no_grad():
        got = fn(images, K, TCO, labels)          # warm: cuDNN plans
        reset()
        got = fn(images, K, TCO, labels)
        torch.cuda.synchronize()
        out["export"] = dict(kernel.launches)
        out["dw_export"] = dwc.DW_KERNEL.launches
    want = refiner.predictor.forward(md, *args, n_iterations=N_REFINER)["TCO_final"]
    err = float((got - want).abs().max())
    moved = float((want - args[2]).abs().max())
    want_l = {"raster_setup": N_REFINER, "raster_resolve": N_REFINER, "raster_resolve_attr": 0,
              "raster_setup_merge": 0, "raster_resolve_bin": 0, "raster_resolve_listed": 0}
    want_dw = B3_BLOCKS * N_REFINER  # the exported program's B3 calls the registered operator
    if out["export"] != want_l or out["dw_export"] != want_dw or not err <= EXPORT_ATOL \
            or moved <= 1e-4 or not torch.isfinite(got).all():
        raise AssertionError(f"export: launches {out['export']} (want {want_l}), "
                             f"dw_bn_silu_squeeze {out['dw_export']} (want {want_dw}), max "
                             f"|exported - eager| {err} (<= {EXPORT_ATOL}), poses moved {moved}")
    with torch.no_grad():
        ms_eager = time_cuda_ms(lambda: refiner.predictor.forward(md, *args,
                                                                  n_iterations=N_REFINER), 10)
        ms_export = time_cuda_ms(lambda: fn(*args, torch.as_tensor(labels, device=dev)), 10)
    # what the registered operator adds to a launch: back-to-back calls of
    # the setup kernel at the main path's shape, through the operator and
    # straight through the ctypes binding (both host-bound at this size)
    first = demo.first_render_inputs(BATCH, IMAGE, RENDER, LOD, dev)
    s_args = (first["tri_verts"], first["tri_valid"], first["TCO"], first["K_crop"], RENDER,
              first["colors"])
    ms_op = time_cuda_ms(lambda: rc.setup(*s_args), 500, warmup=20)
    ms_raw = time_cuda_ms(lambda: kernel.setup(*s_args), 500, warmup=20)
    ms_op2 = time_cuda_ms(lambda: rc.setup(*s_args), 500, warmup=20)
    log(f"{tag} dispatch: raster_setup back to back, {BATCH} x {first['tri_valid'].shape[1]} "
        f"triangles: {ms_op:.4f} / {ms_op2:.4f} ms a call through cosypose::raster_setup, "
        f"{ms_raw:.4f} ms through the ctypes binding alone (CUDA events over 500 calls)")
    log(f"{tag} export: B3 bf16 refiner, B={BATCH}, {IMAGE[0]}x{IMAGE[1]} frames, {RENDER[0]}x"
        f"{RENDER[1]} renders, LOD {LOD}, {N_REFINER} iterations: exported in {t_export:.1f} s "
        f"({art.stat().st_size / 1e6:.1f} MB in {art.relative_to(REPO)}), loaded in "
        f"{t_load:.1f} s; max |exported - eager| {err:.3g} (<= {EXPORT_ATOL}; bit-equal "
        f"{torch.equal(got, want)}), poses moved up to {moved:.3g}; launches a call "
        f"{out['export']}, dw_bn_silu_squeeze {out['dw_export']}; ms a call by CUDA events over 10 warmed calls: eager {ms_eager:.2f}, "
        f"exported {ms_export:.2f} ({100 * (ms_export / ms_eager - 1):+.1f} %)")

    # (b) a fresh process with torch and the operators' modules only
    inputs = OUT_DIR / "export_inputs.npz"
    np.savez(inputs, images=images, K=K, TCO=TCO, labels=labels)
    y_path = OUT_DIR / "export_fresh_out.npy"
    trace_dir = OUT_DIR / "chip_smoke_trace"
    shutil.rmtree(trace_dir, ignore_errors=True)
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-c", FRESH_LOAD, str(art), str(inputs), str(y_path),
                          str(trace_dir)], cwd=REPO, capture_output=True, text=True, timeout=600)
    if run.returncode != 0:
        raise AssertionError(f"fresh-process load failed ({run.returncode}):\n"
                             f"{run.stderr[-3000:]}")
    report = json.loads(run.stdout.strip().splitlines()[-1])
    fresh = torch.as_tensor(np.load(y_path))
    same = torch.equal(fresh, got.cpu())
    out["dw_fresh"] = report["dw_launches"]
    if not same or report["launches"] != want_l or report["dw_launches"] != want_dw \
            or report["modules"] != FRESH_MODULES:
        raise AssertionError(f"fresh-process load: equal to (a) {same} (max diff "
                             f"{float((fresh - got.cpu()).abs().max())}), launches "
                             f"{report['launches']}, dw_bn_silu_squeeze {report['dw_launches']} "
                             f"(want {want_dw}), modules {report['modules']}")
    log(f"{tag} fresh process ({time.perf_counter() - t0:.1f} s, torch and the operators' "
        f"modules, which load {len(FRESH_MODULES)} modules of the port; no checkpoint, no mesh "
        f"files): output equal to (a) bit for bit, launches {report['launches']}, "
        f"dw_bn_silu_squeeze {report['dw_launches']}")

    # (d) the trace that process wrote around one served call
    events = json.loads(pathlib.Path(report["trace"]).read_text())["traceEvents"]
    kern = [e for e in events if e.get("cat") == "kernel"]
    counts = {k: sum(1 for e in kern if f"{k}_kernel" in e["name"]) for k in
              ("raster_setup", "raster_resolve")}
    sorts = sum(1 for e in kern if "sort" in e["name"].lower())
    annot = [e for e in events if e.get("name") == "served_request"]
    dev_ms = sum(e.get("dur", 0) for e in kern) / 1e3
    span = (max(e["ts"] + e.get("dur", 0) for e in kern) - min(e["ts"] for e in kern)) / 1e3 \
        if kern else 0.0
    if counts != {"raster_setup": N_REFINER, "raster_resolve": N_REFINER} or not annot or sorts:
        raise AssertionError(f"trace in a fresh process: raster kernel events {counts} (want "
                             f"{N_REFINER} each), sort kernels {sorts} (want none), annotation "
                             f"events {len(annot)}")
    log(f"{tag} utils.profiling.trace in a fresh process around one exported call: "
        f"{len(kern)} kernel events ({dev_ms:.2f} ms of kernels over a {span:.2f} ms span), "
        f"raster kernels {counts}, no sort kernel, the 'served_request' range present; trace "
        f"{pathlib.Path(report['trace']).relative_to(REPO)}")
    with trace(OUT_DIR / "chip_smoke_trace_main") as prof:
        with annotate("served_request"), torch.no_grad():
            fn(*args, torch.as_tensor(labels, device=dev))
            torch.cuda.synchronize()
    main_events = json.loads(prof.trace_path.read_text())["traceEvents"]
    main_kern = [e for e in main_events if e.get("cat") == "kernel"]
    log(f"{tag} the same trace in this process (after phases 1-10): {len(main_kern)} kernel "
        f"events, {sum(1 for e in main_events if e.get('name') == 'served_request')} annotation "
        f"events, {len(main_events)} events in all; profiler_device_events() "
        f"{profiler_device_events()}")

    # (c) bench_stages at B=128
    reset()
    t0 = time.perf_counter()
    stage_rows = bench_stages.main(["--batch", str(BATCH), "--render-lod", str(LOD), "--json",
                                    str(OUT_DIR / "bench_stages.json")])
    out["bench_stages"] = dict(kernel.launches)
    # each stage's timed calls and its FLOP-counting call, and the one render
    # that makes the rows the raster stages take
    want_b = {k: 1 + sum((r["calls"] + 1) * r["launches_per_call"][k] for r in stage_rows)
              for k in ("raster_setup", "raster_resolve")}
    got_b = {k: out["bench_stages"][k] for k in want_b}
    by_stage = {r["stage"]: r for r in stage_rows}
    if got_b != want_b or len(stage_rows) != 7 or not all(r["ms"] > 0 for r in stage_rows) \
            or not all(by_stage[s].get("pct_of_bound") for s in ("raster setup kernel",
                                                                  "raster resolve kernel")):
        raise AssertionError(f"bench_stages: launches {got_b} (want {want_b}), rows {stage_rows}")
    log(f"{tag} bench_stages --batch {BATCH} --render-lod {LOD} ({time.perf_counter() - t0:.1f} "
        f"s): launches {got_b} (= calls x launches a call)")
    for r in stage_rows:
        extra = (f", bound {r['bound_ms']:.4f} ms by {r['bound_by']} ({r['pct_of_bound']:.1f} % "
                 f"of it)" if "bound_ms" in r else "")
        extra += f", {r['gflop']:.2f} GFLOP, {r['tflops']:.2f} TFLOP/s" if r["gflop"] else ""
        extra += f", {r['mfu_pct']:.2f} % of peak" if r["mfu_pct"] else ""
        log(f"    {r['stage']:34s} {r['ms']:9.4f} ms on the device, {r['ms_per_call']:9.4f} ms "
            f"a call on the host{extra}")

    # (e) overlays, scene renderings, test_render_objects
    overlay_dir = OUT_DIR / "chip_smoke_overlays"
    reset()
    acc = run_procedural_accuracy.main(acc_args + ["--n-frames", "4", "--n-iterations", "1",
                                                   "--save-overlays", str(overlay_dir),
                                                   "--n-overlays", str(N_OVERLAYS), "--out",
                                                   str(OUT_DIR / "chip_smoke_overlays.json")])
    out["overlays"] = dict(kernel.launches)
    n_obj = len(acc["TCO_init"])
    want_o = math.ceil(n_obj / EVAL_BSZ) + 2 * N_OVERLAYS
    panels = [png.imread(p) for p in acc["overlays"]]
    if out["overlays"] != {"raster_setup": want_o, "raster_resolve": want_o,
                           "raster_resolve_attr": 0, "raster_setup_merge": 0,
                           "raster_resolve_bin": 0, "raster_resolve_listed": 0} \
            or len(panels) != N_OVERLAYS \
            or not all(p.ndim == 3 and p.std() > 0 for p in panels):
        raise AssertionError(f"overlays: launches {out['overlays']} (want {want_o} each), "
                             f"{len(panels)} panels")
    log(f"{tag} run_procedural_accuracy --save-overlays ({n_obj} objects of 4 frames, 1 "
        f"iteration): {len(panels)} PNG panels of {panels[0].shape[1]}x{panels[0].shape[0]} in "
        f"{overlay_dir.relative_to(REPO)}; launches {out['overlays']} (= 1 chunk + 2 renders "
        f"a panel)")

    _, _, obs = val_ds[0]
    objs = obs["objects"]
    objects = TensorCollection(dict(label=np.array([o["label"] for o in objs])),
                               TWO=torch.as_tensor(np.stack([o["TWO"] for o in objs]),
                                                   dtype=torch.float32))
    reset()
    t0 = time.perf_counter()
    frames, calls = captured_renders(lambda: make_scene_renderings(objects, None, mesh_db_p))
    t_scene = time.perf_counter() - t0
    out["scene_renderings"] = dict(kernel.launches)
    if out["scene_renderings"] != {"raster_setup": 1, "raster_resolve": 0,
                                   "raster_resolve_attr": 1, "raster_setup_merge": 0,
                                   "raster_resolve_bin": 0, "raster_resolve_listed": 0} \
            or len(frames) != 16 \
            or not all(f.any() for f in frames):
        raise AssertionError(f"make_scene_renderings: launches {out['scene_renderings']}, "
                             f"{len(frames)} frames")
    msg = kernels_vs_plain_at("scene renderings", calls[0], checked)
    log(f"{tag} make_scene_renderings of a recorded val frame ({len(objs)} objects, 16 orbit "
        f"views in one call, {t_scene:.2f} s): launches {out['scene_renderings']}; {msg}")

    reset()
    renders, calls = captured_renders(lambda: test_render_objects.main(
        ["--object-ds", "procedural"]))
    out["test_render_objects"] = dict(kernel.launches)
    if out["test_render_objects"] != {"raster_setup": 1, "raster_resolve": 1,
                                      "raster_resolve_attr": 0, "raster_setup_merge": 0,
                                      "raster_resolve_bin": 0, "raster_resolve_listed": 0}:
        raise AssertionError(f"test_render_objects: launches {out['test_render_objects']}")
    msg = kernels_vs_plain_at("test_render_objects", calls[0], checked)
    log(f"{tag} test_render_objects --object-ds procedural ({renders.shape[0]} objects): every "
        f"render non-empty, launches {out['test_render_objects']}; {msg}")
    log(f"phase 11 took {time.perf_counter() - t_phase:.0f} s")
    return out


def time_kernels_at(what: str, call) -> str:
    """Both kernels' device ms at one captured render call's shape (CUDA
    events behind a spin kernel; setup_timing), their bounds and their plain
    versions' ms on the card."""
    from cosypose_tpu_torch.ops import rasterizer_cuda as rc
    from cosypose_tpu_torch.ops.raster_bounds import resolve_bound, setup_bound

    args, kw = call
    sa = (*args, kw["image_size"], kw["colors"])
    size, tile, budget = kw["image_size"], kw["tile"], kw["max_tris_per_tile"]
    rows, key, order = rc.setup(*sa)
    t_s = setup_timing(sa, key)
    ms_r = queued_ms(lambda: rc.RASTER_KERNEL.resolve(rows, order, size, tile, budget, False), 50)
    plain_s = time_cuda_ms(lambda: rc.setup_plain(*sa), 10)
    plain_r = time_cuda_ms(lambda: rc.resolve_plain_binned(rows, order, size, tile, budget, False),
                           3, warmup=1)
    b_s, by_s = setup_bound(sa[0], sa[1], sa[5], None, rows, key)[:2]
    b_r, by_r = resolve_bound(rows, order, size, tile, budget, False)[:2]
    return (f"{what} ({rows.shape[0]} x {rows.shape[1]} rows, {size[0]}x{size[1]}, tile "
            f"{tuple(tile)}, budget {budget}; CUDA events behind a spin kernel): "
            f"{setup_timing_text(t_s, b_s, by_s)}, plain {plain_s:.3f} ms; raster_resolve "
            f"{ms_r:.4f} ms (bound {b_r:.4f} ms by {by_r}, "
            f"{100 * b_r / ms_r:.1f} %), plain {plain_r:.2f} ms; library_ms: none")

def jpeg_fixtures():
    """tests/torch_port_make_jpeg_fixtures.py, loaded from its path: the card's
    machine may have another top-level `tests` package, which would win over
    the repo's directory of that name."""
    import importlib.util

    path = REPO / "tests" / "torch_port_make_jpeg_fixtures.py"
    spec = importlib.util.spec_from_file_location("torch_port_make_jpeg_fixtures", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module

def jpeg_phase(tag: str, checked: dict, ctx: dict) -> dict:
    """Phase 12, the JPEG data path and the depthwise lowerings, on what
    phases 6 and 8 leave: (a) every committed fixture through the C++ and the
    numpy decoder, both equal to the stored Pillow arrays, and host decode
    times; (b) procedural-refiner trained with VOC backgrounds at 0 and 8
    loader workers; (c) one refiner iteration at bench.py's setting in each
    depthwise lowering, from the same weights; (d) a BOP split of JPEG frames
    through data/bop.py, the detector and the refiner. Returns the kernels'
    launches in (b), (c) and (d), and the depthwise kernel's in (c) (the
    "conv" lowering's B3 alone takes it)."""
    import random
    import shutil
    import statistics

    import numpy as np
    import torch

    from cosypose_tpu_torch import demo
    from cosypose_tpu_torch.data import pillow_ops
    from cosypose_tpu_torch.data.augmentations import SceneObservation
    from cosypose_tpu_torch.data.bop import BOPDataset
    from cosypose_tpu_torch.data.datasets_cfg import make_object_dataset, make_scene_dataset
    from cosypose_tpu_torch.data.pose_dataset import PoseDataset
    from cosypose_tpu_torch.data.wrappers import MultiViewWrapper
    from cosypose_tpu_torch.evaluation.pred_runners import BopPredictionRunner
    from cosypose_tpu_torch.integrated.pose_predictor import CoarseRefinePosePredictor
    from cosypose_tpu_torch.models import pose_predictor
    from cosypose_tpu_torch.models.pose_predictor import (PosePredictor, PosePredictorConfig,
                                                          gather_mesh_data)
    from cosypose_tpu_torch.ops import depthwise_cuda as dwc
    from cosypose_tpu_torch.ops import rasterizer_cuda as rc
    from cosypose_tpu_torch.ops.mesh_db import build_mesh_db
    from cosypose_tpu_torch.scripts import run_bop_inference, run_detector_training
    from cosypose_tpu_torch.training.train_pose import train_pose
    from cosypose_tpu_torch.utils import jpeg, jpeg_cext, png

    dev, kernel = torch.device("cuda"), rc.RASTER_KERNEL
    t_phase = time.perf_counter()
    fx = jpeg_fixtures()
    jpeg_root, voc_root = fx.ROOT, fx.VOC_ROOT

    # (a) the decoders on every fixture; the library is built here, before
    # any loader worker starts
    t0 = time.perf_counter()
    lib = jpeg_cext.build_library()
    t_build = time.perf_counter() - t0
    arrays = fx.expected()
    t_numpy = {}
    for rel, ref in arrays.items():
        data = (jpeg_root / rel).read_bytes()
        got_c = jpeg_cext.decode(data, rel)
        t0 = time.perf_counter()
        got_n = jpeg.decode(data, rel)
        t_numpy[rel] = time.perf_counter() - t0
        if not (np.array_equal(got_c, ref) and np.array_equal(got_n, ref)):
            raise AssertionError(f"JPEG fixture {rel}: C++ equal {np.array_equal(got_c, ref)}, "
                                 f"numpy equal {np.array_equal(got_n, ref)} to Pillow's array")

    def median_ms(fn, data):
        times = []
        for _ in range(JPEG_DECODES):
            t0 = time.perf_counter()
            fn(data)
            times.append(time.perf_counter() - t0)
        return 1e3 * statistics.median(times)

    frame_bytes = (jpeg_root / JPEG_FRAME).read_bytes()
    ms_frame = median_ms(jpeg_cext.decode, frame_bytes)
    png_bytes = png.encode(arrays[JPEG_FRAME])
    ms_png = median_ms(png.decode, png_bytes)
    voc = sorted(k for k in arrays if k.startswith("VOCdevkit/"))
    ms_voc = [median_ms(jpeg_cext.decode, (jpeg_root / k).read_bytes()) for k in voc]
    log(f"{tag} JPEG decoders: {lib.name} built by g++ in {t_build:.2f} s; {len(arrays)} "
        f"fixtures ({', '.join(sorted(arrays))}): C++ and numpy both equal to the stored Pillow "
        f"arrays; host decode, median of {JPEG_DECODES}: {JPEG_FRAME} (480x640 4:2:0 q95, "
        f"{len(frame_bytes)} bytes) {ms_frame:.3f} ms by the C++ library, "
        f"{1e3 * t_numpy[JPEG_FRAME]:.1f} ms once by numpy; the same frame as PNG "
        f"({len(png_bytes)} bytes) {ms_png:.3f} ms by utils/png.decode; the VOC frames "
        f"(500x375 / 375x500 q75 4:2:0) {', '.join(f'{m:.3f}' for m in ms_voc)} ms")
    for name in JPEG_MODE_FRAMES:
        data = (jpeg_root / name).read_bytes()
        log(f"{tag} JPEG host decode, median of {JPEG_DECODES}: {name} (480x640, {len(data)} "
            f"bytes) {median_ms(jpeg_cext.decode, data):.3f} ms by the C++ library, "
            f"{1e3 * t_numpy[name]:.1f} ms once by numpy")
    log(f"{tag} " + cmyk_readers(fx, arrays))

    # (b) procedural-refiner with VOC backgrounds, 0 and 8 loader workers
    run_p = ctx["make_cfg"]("procedural-refiner")
    tcfg_p = run_p.train
    Bp, n_it_p = tcfg_p.batch_size, tcfg_p.n_iterations
    jitter = run_p.rgb_augmentation and not tcfg_p.rgb_aug_device
    resize = tuple(run_p.input_resize)
    train_name = "synthetic.procedural.train"

    def voc_dataset(**kw):
        return PoseDataset(make_scene_dataset(train_name, ds_root=ctx["data_root"]),
                           resize=resize, voc_root=voc_root, **kw)

    # an item's background is the decoded, resized VOC image; its foreground the frame's
    probe = voc_dataset(apply_rgb_augmentation=False)
    probe.background_aug.p = 1.0
    checked_items = 0
    for idx in range(4):
        r = random.Random()
        r.setstate(probe.background_aug.rng.getstate())
        r.random()
        path = r.choice(probe.background_aug.image_paths)
        rgb, mask, obs = probe.scene_ds[idx]
        s = probe.crop_resize(SceneObservation(np.asarray(rgb), np.asarray(mask), obs))
        item = probe.get_data(idx)
        if item is None:
            continue
        img = np.transpose(item["image"], (1, 2, 0))
        bg = pillow_ops.resize_bilinear(arrays[str(path.relative_to(jpeg_root))], resize)
        fg = s.mask > 0
        if not (np.array_equal(img[~fg], bg[~fg]) and np.array_equal(img[fg], s.rgb[fg])):
            raise AssertionError(f"VOC paste of {path.name} on frame {idx}: background or "
                                 f"foreground differs")
        checked_items += 1
    if not checked_items:
        raise AssertionError("no item with a valid object to check the VOC paste on")
    log(f"{tag} VOC paste: {checked_items} items' backgrounds equal the decoded, resized "
        f"{resize[0]}x{resize[1]} VOC image and their foregrounds the frame's")

    launches_train = {}
    for workers, steps in VOC_STEPS.items():
        pose_ds = voc_dataset(apply_rgb_augmentation=jitter)
        cfg_w = dataclasses.replace(run_p, run_id=f"procedural-refiner-voc-w{workers}",
                                    n_dataloader_workers=workers, val_ds_names=())
        cfg_w.train = dataclasses.replace(tcfg_p, n_epochs=1, epoch_size=Bp * steps)
        kernel.launches = {k: 0 for k in kernel.launches}
        t0 = time.perf_counter()
        if workers == 0:
            (trained, run_dir), calls = captured_renders(lambda: train_pose(
                cfg_w, {"train": [(pose_ds, 1)]}, ctx["db_p"], exp_dir=ctx["exp_p"], device=dev),
                pose_predictor)
        else:
            trained, run_dir = train_pose(cfg_w, {"train": [(pose_ds, 1)]}, ctx["db_p"],
                                          exp_dir=ctx["exp_p"], device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = dict(kernel.launches)
        launches_train[workers] = got
        want = {"raster_setup": steps * n_it_p, "raster_resolve": steps * n_it_p,
                "raster_resolve_attr": 0, "raster_setup_merge": 0,
                "raster_resolve_bin": 0, "raster_resolve_listed": 0}
        rec = [json.loads(line) for line in (run_dir / "log.txt").read_text().splitlines()][-1]
        if got != want or trained.step != steps or not math.isfinite(rec["train/loss_total"]):
            raise AssertionError(f"VOC training with {workers} workers: launches {got} (want "
                                 f"{want}), step {trained.step}, log {rec}")
        step_s, data_s = rec["train/step_s_per_step"], rec["train/data_s_per_step"]
        log(f"{tag} procedural-refiner with VOC backgrounds (p 0.3), {workers} loader workers: "
            f"{steps} steps in {wall:.1f} s with set-up; {1e3 * step_s:.1f} ms/step, "
            f"{Bp / step_s:.1f} samples/s; data wait {1e3 * data_s:.1f} ms/step "
            f"({1e3 * rec['train/data_s_first_batch']:.1f} ms before the first batch, "
            f"{1e3 * rec['train/data_s_second_half']:.1f} ms a step over the last "
            f"{steps - steps // 2}); loss {rec['train/loss_total']:.4f}; launches {got}")
        if workers == 0:
            log(f"{tag} kernels at the VOC training step's render shape: "
                + kernels_vs_plain_at("VOC training", calls[0], checked))
            log(f"{tag} " + time_kernels_at("VOC training", calls[0]))
        del trained

    # (c) one refiner iteration at bench.py's setting in each lowering
    images, K, TCO, labels = demo.make_inputs(BATCH, *IMAGE)
    db = build_mesh_db(demo.demo_specs(), render_max_faces=LOD, device=dev)
    cfg16 = PosePredictorConfig(compute_dtype=torch.bfloat16)
    md = gather_mesh_data(db, torch.as_tensor(labels, device=dev).long(), cfg16.n_points_crop)
    a = [torch.as_tensor(x, device=dev) for x in (images, K, TCO)]
    state, feats, outs, ms_it, ms_bb = None, {}, {}, {}, {}
    kernel.launches = {k: 0 for k in kernel.launches}
    dwc.DW_KERNEL.launches = 0
    nets = {}
    for impl in DW_IMPLS:
        name = "efficientnet-b3" + ("" if impl == "conv" else f"+dw{impl}")
        pp = PosePredictor(dataclasses.replace(cfg16, backbone=name), device=dev)
        if state is None:
            demo.demo_weights(pp, md, *a, torch.Generator().manual_seed(1))
            state = pp.net.state_dict()
            kernel.launches = {k: 0 for k in kernel.launches}
            dwc.DW_KERNEL.launches = 0
        pp.net.load_state_dict(state)
        seen = {}
        hook = pp.net.backbone.register_forward_hook(
            lambda m, inp, out: seen.update(x=inp[0].detach(), y=out.detach()))
        with torch.no_grad():
            out, calls = captured_renders(lambda: pp.forward(md, *a, n_iterations=1),
                                          pose_predictor)
        hook.remove()
        feats[impl], outs[impl], nets[impl] = seen, out, pp
    launches_dw = dict(kernel.launches)
    dw_lowerings = dwc.DW_KERNEL.launches  # the "conv" lowering's iteration alone takes it
    if launches_dw != {"raster_setup": 3, "raster_resolve": 3, "raster_resolve_attr": 0,
                       "raster_setup_merge": 0,
                       "raster_resolve_bin": 0, "raster_resolve_listed": 0} \
            or dw_lowerings != B3_BLOCKS:
        raise AssertionError(f"lowerings: launches {launches_dw} (want 3, one an iteration), "
                             f"dw_bn_silu_squeeze {dw_lowerings} (want {B3_BLOCKS})")
    log(f"{tag} kernels at the lowerings' iteration (B={BATCH}, LOD {LOD}): "
        + kernels_vs_plain_at("depthwise lowerings", calls[0], checked))
    x_in = feats["conv"]["x"]
    errs = {}
    for impl in DW_IMPLS[1:]:
        if not torch.equal(feats[impl]["x"], x_in):
            raise AssertionError(f"+dw{impl}: the backbone's input differs from the grouped conv's")
        ref, got = feats["conv"]["y"].float(), feats[impl]["y"].float()
        errs[impl] = float((got - ref).abs().max() / ref.abs().max())
        t_err = max(float((outs[impl][k] - outs["conv"][k]).abs().max())
                    for k in outs["conv"] if k.startswith("TCO"))
        if not errs[impl] <= DW_BF16_RTOL_OF_MAX or not torch.isfinite(got).all():
            raise AssertionError(f"+dw{impl}: features {errs[impl]} of their max from the "
                                 f"grouped conv's (> {DW_BF16_RTOL_OF_MAX})")
        log(f"{tag} +dw{impl} vs the grouped conv (B3 bf16, B={BATCH}): features max |diff| "
            f"{errs[impl]:.4g} of their max (<= {DW_BF16_RTOL_OF_MAX}); TCO outputs max |diff| "
            f"{t_err:.3g}")
    for impl, pp in nets.items():
        with torch.no_grad():
            ms_it[impl] = time_cuda_ms(lambda: pp.forward(md, *a, n_iterations=1), DW_REPS, 1)
            with torch.autocast("cuda", dtype=torch.bfloat16):
                ms_bb[impl] = time_cuda_ms(lambda: pp.net.backbone(x_in), DW_REPS, 1)
    log(f"{tag} depthwise lowerings, one refiner iteration at B={BATCH}, B3 bf16, 240x320, LOD "
        f"{LOD} (CUDA events, {DW_REPS} calls): " + ", ".join(
            f"{impl} {ms_it[impl]:.2f} ms (backbone {ms_bb[impl]:.2f} ms)" for impl in DW_IMPLS))
    del nets, feats, outs

    # (d) a BOP split of JPEG frames: data/bop.py, the detector, the refiner
    split = ctx["data_root"] / "jpeg_bop"
    shutil.rmtree(split, ignore_errors=True)
    scene = split / "test" / "000000"
    (scene / "rgb").mkdir(parents=True)
    cam = {}
    for view, name in enumerate(JPEG_BOP_FRAMES):
        shutil.copyfile(jpeg_root / name, scene / "rgb" / f"{view:06d}.jpg")
        cam[str(view)] = {"cam_K": [600.0, 0.0, 320.0, 0.0, 600.0, 240.0, 0.0, 0.0, 1.0],
                          "depth_scale": 1.0}
    (scene / "scene_camera.json").write_text(json.dumps(cam))
    ds = BOPDataset(split, split="test")
    for view, name in enumerate(JPEG_BOP_FRAMES):
        rgb, mask, obs = ds[view]
        if not np.array_equal(rgb, arrays[name]) or obs["objects"] or mask.any():
            raise AssertionError(f"JPEG BOP frame {view}: not the fixture {name} as Pillow reads it")
    labels_d = run_detector_training.label_to_category_id(make_object_dataset("procedural"))
    detector = run_bop_inference.load_detector(ctx["run_d"].run_id, labels_d,
                                               exp_dir=ctx["exp_p"], device=dev)
    refiner = run_bop_inference.load_pose_model(ctx["run_m"].run_id, ctx["db_p"],
                                                exp_dir=ctx["exp_p"], device=dev)
    n_ref = 4
    runner = BopPredictionRunner(MultiViewWrapper(ds, n_views=1), n_coarse_iterations=0,
                                 n_refiner_iterations=n_ref)
    server = CoarseRefinePosePredictor(None, refiner, device=dev)
    kernel.launches = {k: 0 for k in kernel.launches}
    t0 = time.perf_counter()
    preds, calls = captured_renders(lambda: runner.get_predictions(
        detector, server, detection_th=ctx["detection_th"]), pose_predictor)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches_bop = dict(kernel.launches)
    poses = preds["pose"]
    per_frame = {}
    for v in poses.infos["view_id"].tolist():
        per_frame[v] = per_frame.get(v, 0) + 1
    chunks = sum(math.ceil(n / ctx["eval_bsz"]) for n in per_frame.values())
    want = {"raster_setup": chunks * n_ref, "raster_resolve": chunks * n_ref,
            "raster_resolve_attr": 0, "raster_setup_merge": 0,
            "raster_resolve_bin": 0, "raster_resolve_listed": 0}
    if launches_bop != want or not len(poses) or not torch.isfinite(poses.poses).all():
        raise AssertionError(f"JPEG BOP split: launches {launches_bop} (want {want}), "
                             f"{len(poses)} poses")
    log(f"{tag} JPEG BOP split ({len(ds)} frames of 480x640, {ctx['run_d'].run_id} -> "
        f"{ctx['run_m'].run_id}, {n_ref} iterations, threshold {ctx['detection_th']}): "
        f"{wall:.2f} s, detection {runner.seconds['detection']:.2f} s, pose "
        f"{runner.seconds['pose']:.2f} s; {len(poses)} detections ({chunks} refiner chunks); "
        f"launches {launches_bop} (want {want}); "
        + kernels_vs_plain_at("JPEG BOP split", calls[0], checked))
    log(f"{tag} " + public_names_card_vs_cpu())
    log(f"phase 12 took {time.perf_counter() - t_phase:.0f} s")
    return {"training": launches_train, "dw": launches_dw, "bop": launches_bop,
            "dw_bn_silu_squeeze": dw_lowerings}


# bench.py's keys, in its order, plus the device time a call
BENCH_KEYS = ["metric", "value", "unit", "vs_baseline", "tflops", "mfu_pct", "batch", "dtype",
              "wrn18_crop_it_per_s", "wrn18_tflops", "wrn18_mfu_pct", "baseline_batch",
              "device_ms_per_call"]
BENCH_ITEMS = 4             # items of the bench's B=128 output held to the CPU


def bench_phase(tag: str, checked: dict) -> dict:
    """Phase 13, the port's headline bench and entry point: (a) `python -m
    cosypose_tpu_torch.bench` in a fresh process, its result line's keys and
    ranges and each arm's launches of both kernels, (warm-up + REPS + the
    FLOP-counting call) x N_ITER; (b) the bench's B=128 card output, items
    0-3, against bench.build on the CPU over the same four inputs sliced from
    the B=128 draw; (c) entry() on the card, one launch of each kernel, both
    kernels against their plain versions at its render shape, and its output
    against entry(device="cpu"). Returns the launches of (a) and (c)."""
    import numpy as np
    import torch

    from cosypose_tpu_torch import bench, demo
    from cosypose_tpu_torch.entry import entry
    from cosypose_tpu_torch.models import pose_predictor
    from cosypose_tpu_torch.ops import depthwise_cuda as dwc
    from cosypose_tpu_torch.ops import rasterizer_cuda as rc

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    # (a) the bench in a fresh process
    out_path = OUT_DIR / "bench_b128_tco.npy"
    out_path.unlink(missing_ok=True)
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", "cosypose_tpu_torch.bench", "--save-output",
                          str(out_path)], cwd=REPO, capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    if run.returncode != 0:
        raise AssertionError(f"python -m cosypose_tpu_torch.bench exited {run.returncode}:\n"
                             f"{run.stdout[-2000:]}\n{run.stderr[-3000:]}")
    lines = run.stdout.strip().splitlines()
    for line in lines:
        log(f"{tag} bench: {line}")
    result = json.loads(lines[-1])
    launches = json.loads(next(x for x in lines if x.startswith("launches: ")).split(": ", 1)[1])
    n_want = (1 + bench.REPS + 1) * bench.N_ITER
    want = {arm: {**{k: n_want for k in bench.KERNELS},
                  "dw_bn_silu_squeeze": B3_BLOCKS * n_want if arm == "efficientnet-b3" else 0}
            for arm in bench.ARMS}
    wrn18 = ("wrn18_crop_it_per_s", "wrn18_tflops", "wrn18_mfu_pct")
    faults = [f for f, bad in [
        (f"keys {list(result)}", list(result) != BENCH_KEYS),
        (f"metric {result.get('metric')}",
         result.get("metric") != "refiner_crop_iterations_per_sec_gpu"),
        (f"value {result.get('value')}", not (result.get("value") or 0) > 0),
        (f"mfu_pct {result.get('mfu_pct')}", not 0 < (result.get("mfu_pct") or 0) <= 100),
        (f"wrn18 {[result.get(k) for k in wrn18]}", any(result.get(k) is None for k in wrn18)),
        (f"launches {launches} (want {want})", launches != want)] if bad]
    if faults:
        raise AssertionError("bench: " + "; ".join(faults))
    log(f"{tag} bench ({wall:.1f} s in a fresh process, baseline cache "
        f"{bench.CPU_CACHE.relative_to(REPO)}): {result['value']} crop-iterations/s, "
        f"{result['device_ms_per_call']} device ms a call, mfu {result['mfu_pct']} %, wrn18 "
        f"{result['wrn18_crop_it_per_s']} crop-iterations/s; launches {launches} (want {want}: "
        f"(1 + {bench.REPS} + 1) x {bench.N_ITER} calls of the net, {B3_BLOCKS} depthwise "
        f"launches a B3 call)")

    # (b) the bench's card output against the CPU on the same four inputs
    card_out = torch.as_tensor(np.load(out_path))
    if card_out.shape != (bench.BATCH, 4, 4) or not torch.isfinite(card_out).all():
        raise AssertionError(f"bench output {tuple(card_out.shape)}, finite "
                             f"{bool(torch.isfinite(card_out).all())}")
    fn_c, args_c = bench.build(BENCH_ITEMS, device="cpu")
    inputs = demo.make_inputs(bench.BATCH)
    draw = [torch.as_tensor(a[:BENCH_ITEMS]) for a in inputs]
    t0 = time.perf_counter()
    cpu_out = fn_c(args_c[0], *draw)
    t_cpu = time.perf_counter() - t0
    err = float((card_out[:BENCH_ITEMS] - cpu_out).abs().max())
    moved = float((card_out - torch.as_tensor(inputs[2])).abs().max())
    log(f"{tag} bench output, items 0-{BENCH_ITEMS - 1} card vs CPU ({t_cpu:.1f} s on the CPU): "
        f"TCO_final max |diff| {err:.3g} (<= {ATOL_SLICE}); the zero pose kernel moved the "
        f"poses by {moved:.3g}")
    if err > ATOL_SLICE:
        raise AssertionError(f"bench output card vs CPU {err:.3g} > {ATOL_SLICE}")

    # (c) entry() on the card against the CPU
    fn, args = entry()
    kernel = rc.RASTER_KERNEL
    kernel.launches = {k: 0 for k in kernel.launches}
    dwc.DW_KERNEL.launches = 0
    out, calls = captured_renders(lambda: fn(*args), pose_predictor)
    torch.cuda.synchronize()
    launches_entry = dict(kernel.launches)
    dw_entry = dwc.DW_KERNEL.launches
    want_e = {"raster_setup": 1, "raster_resolve": 1, "raster_resolve_attr": 0,
              "raster_setup_merge": 0, "raster_resolve_bin": 0, "raster_resolve_listed": 0}
    fn_c, args_c = entry(device="cpu")
    err = float((out.cpu() - fn_c(*args_c)).abs().max())
    log(f"{tag} entry() (B3 fp32, B=4, 1 iteration, full spheres): launches {launches_entry} "
        f"(want {want_e}), dw_bn_silu_squeeze {dw_entry} (want {B3_BLOCKS}); TCO_final card vs CPU max |diff| {err:.3g} (<= {ATOL_SLICE}); "
        + kernels_vs_plain_at("entry", calls[0], checked))
    if launches_entry != want_e or dw_entry != B3_BLOCKS or len(calls) != 1 \
            or err > ATOL_SLICE or not torch.isfinite(out).all():
        raise AssertionError(f"entry(): launches {launches_entry}, dw_bn_silu_squeeze "
                             f"{dw_entry}, renders {len(calls)}, card vs CPU {err:.3g}")
    log(f"phase 13 took {time.perf_counter() - t_phase:.0f} s")
    return {"bench": launches, "entry": launches_entry, "dw_entry": dw_entry}


# phase 14: rows an item past one block of kernel A (16,384 on an H100) and
# one window of kernel B (10,560): just past both, a ycbv-1M scene soup (8
# objects of 8,192 faces and the cage), 8 full blocks, and past the largest
# cluster; two items each, at the scene's tile and budget on a 240x320 image.
# Above one block kernel A takes sorted runs and their merge; above one window
# kernel B takes its binning launch and the listed resolve.
LARGE_ROWS = (16_392, 65_896, 131_072, 262_144)
LARGE_IMAGE = (240, 320)
RUN_ROWS = (256, 512, 1024, 2048, 4096, 8192, 16384)  # kernel A's run lengths, each timed
YCBV_FRAMES = 20            # recorded at ycbv-1M's sampler settings
YCBV_OBJECTS = 8            # dense_specs meshes in the mesh DB (ycbv-1M draws 2-8 a scene)


def large_soup(B: int, F: int, image, seed: int = 0, device="cuda"):
    """Setup inputs (tri_verts, tri_valid, TCO, K, colors) of B items of F
    small triangles spread over the whole image (centres uniform in pixels,
    1-3 px wide, depths 0.5-1 m, about a tenth invalid, the second half of
    each item repeating the first so that keys tie), and attributes (B, F)."""
    import numpy as np
    import torch

    H, W = image
    rng = np.random.RandomState(seed)
    f = 500.0
    u, v = rng.uniform(0, W, (B, F, 1)), rng.uniform(0, H, (B, F, 1))
    z = rng.uniform(0.5, 1.0, (B, F, 1))
    uv = np.stack([u, v], -1) + rng.uniform(-1.5, 1.5, (B, F, 3, 2))
    zc = np.repeat(z, 3, axis=-1)[..., None] + rng.uniform(-0.01, 0.01, (B, F, 3, 1))
    xy = (uv - np.array([W / 2, H / 2])) * zc / f
    tv = np.concatenate([xy, zc], -1)
    tv[:, F // 2:] = tv[:, :F - F // 2].copy()
    valid = rng.uniform(size=(B, F)) > 0.1
    K = np.tile(np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]]), (B, 1, 1))
    TCO = np.tile(np.eye(4), (B, 1, 1))
    colors = rng.uniform(0, 1, (B, F, 3, 3))
    attr = rng.randint(1, 9, (B, F))
    out = [torch.as_tensor(a, dtype=torch.float32, device=device).contiguous()
           for a in (tv, valid, TCO, K, colors, attr)]
    out[1] = out[1].bool()
    return tuple(out[:5]), out[5]


def merge_launch(rows_args, run_rows):
    """Kernel A's two parts alone, on rows_args (tri_verts, tri_valid, TCO,
    K, image size, colors, attributes) in runs of run_rows rows: (the runs
    launch, which writes the sorted runs; a call that restores the runs
    it wrote and merges them; the restore alone; the keys; the order the
    merge writes). The merge passes overwrite the runs, so the merge alone
    is timed as (restore + merge) - restore."""
    import torch

    from cosypose_tpu_torch.ops import rasterizer_cuda as rc

    kernel = rc.RASTER_KERNEL
    tv, valid, TCO, K, image, colors, attr = rows_args
    B, F = valid.shape
    Fp = rc.padded_rows(F)
    dev = tv.device
    scratch = torch.empty(B, Fp, dtype=torch.int64, device=dev)
    order = torch.empty(B, Fp, dtype=torch.int64, device=dev)
    runs = scratch if kernel.merge_passes(Fp, run_rows) % 2 else order
    rows = torch.empty(B, Fp, rc.ROW, device=dev)
    key = torch.empty(B, Fp, device=dev)
    fns, stream = kernel.load(), torch.cuda.current_stream(dev).cuda_stream

    def sort_runs():
        err = fns["setup"](tv.data_ptr(), valid.data_ptr(), TCO.data_ptr(), K.data_ptr(),
                           colors.data_ptr(), attr.data_ptr(), rows.data_ptr(), key.data_ptr(),
                           order.data_ptr(), runs.data_ptr(), B, F, Fp, image[0], image[1], 0.05,
                           0, run_rows, dev.index or 0, stream)
        if err:
            raise RuntimeError(f"raster_setup (runs) failed: cudaError {err}")

    sort_runs()
    saved = runs.clone()

    def restore():
        runs.copy_(saved)

    def merge():
        restore()
        err = fns["setup_merge"](scratch.data_ptr(), order.data_ptr(), B, Fp, run_rows,
                                 dev.index or 0, stream)
        if err:
            raise RuntimeError(f"raster_setup_merge failed: cudaError {err}")

    return sort_runs, merge, restore, key, order


def regime_timing(setup_args, attr, key) -> dict:
    """Kernel A's regimes on one soup of more rows than a block sorts, each
    giving the launcher's rows, keys and order: {"runs": {run_rows: (total,
    runs launch, merge alone) ms}, "merge_ok": {run_rows: order equal to
    torch.sort's}, "clusters_ms": clusters of 8 (where they hold the item)
    or None, "torch_sort_ms": torch.sort of the keys}, by CUDA events behind
    a spin kernel."""
    import torch

    from cosypose_tpu_torch.ops import rasterizer_cuda as rc

    kernel = rc.RASTER_KERNEL
    tv, valid, TCO, K, image, colors = setup_args
    B, Fp = key.shape
    want = torch.sort(key, dim=1, stable=True).indices
    out = {"runs": {}, "merge_ok": {}, "clusters_ms": None,
           "torch_sort_ms": queued_ms(lambda: torch.sort(key, dim=1, stable=True), 20)}
    for run in RUN_ROWS:
        got = kernel.setup(*setup_args[:4], image, colors, tri_attr=attr, cluster=-1,
                           run_rows=run)[2]
        sort_runs, merge, restore, _, order = merge_launch((*setup_args, attr), run)
        merge()
        torch.cuda.synchronize()
        out["merge_ok"][run] = torch.equal(got, want) and torch.equal(order, want)
        total = queued_ms(lambda: kernel.setup(*setup_args[:4], image, colors, tri_attr=attr,
                                               cluster=-1, run_rows=run), 20)
        out["runs"][run] = (total, queued_ms(sort_runs, 20),
                            queued_ms(merge, 20) - queued_ms(restore, 20))
    if Fp <= 8 * kernel.sort_block_rows(key.device):
        got = kernel.setup(*setup_args[:4], image, colors, tri_attr=attr, cluster=8)[2]
        if not torch.equal(got, want):
            raise AssertionError(f"raster_setup at {Fp} rows: clusters of 8 differ")
        out["clusters_ms"] = queued_ms(lambda: kernel.setup(*setup_args[:4], image, colors,
                                                            tri_attr=attr, cluster=8), 20)
    if not all(out["merge_ok"].values()):
        raise AssertionError(f"raster_setup_merge at {Fp} rows: the order differs from "
                             f"torch.sort's at runs of {out['merge_ok']}")
    return out


def binned_resolve_timing(rows, order, image, tile, budget) -> dict:
    """Kernel B above one window on these rows: the binning launch equal to
    bin_chunks and the listed resolve (with and without the attribute)
    bit-equal to resolve_plain on bin_chunks' lists, then each timed alone
    and together (resolve) by CUDA events behind a spin kernel, with their
    bounds and plain times: {"bin_ms", "listed_ms", "ms", "bin_bound",
    "listed_bound", "bound", "bin_plain_ms", "listed_plain_ms", "plain_ms",
    "bin_err", "listed_err", "most_listed", "Kc"}."""
    import torch

    from cosypose_tpu_torch.ops import rasterizer_cuda as rc
    from cosypose_tpu_torch.ops.raster_bounds import bin_bound, listed_bound, resolve_bound

    kernel = rc.RASTER_KERNEL
    lists = kernel.bin_chunks(rows, order, image, tile, budget)
    out_k = kernel.resolve(rows, order, image, tile, budget, True)
    out_n = kernel.resolve(rows, order, image, tile, budget, False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    srt, idx, counts = rc.bin_chunks(rows, order, image, tile, budget)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out_p = rc.resolve_plain(srt, idx, counts, image, tile, True)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    listed_err = max(float((k - p).abs().max()) for k, p in
                     [*zip(out_k, out_p), *zip(out_n[:2], out_p[:2])])
    bin_err = max(float((lists[0] - idx).abs().max()), float((lists[1] - counts).abs().max()))
    if bin_err:
        raise AssertionError(f"raster_resolve_bin at {tuple(rows.shape[:2])}: lists differ from "
                             f"bin_chunks'")
    if not all(torch.equal(k, p) for k, p in zip(out_k, out_p)) \
            or not all(torch.equal(k, p) for k, p in zip(out_n[:2], out_p[:2])) \
            or not (out_k[1] > 0).any():
        raise AssertionError(f"raster_resolve at {tuple(rows.shape[:2])}: kernel vs plain not "
                             f"equal")
    return dict(
        bin_ms=queued_ms(lambda: kernel.bin_chunks(rows, order, image, tile, budget), 20),
        listed_ms=queued_ms(lambda: kernel.resolve_listed(rows, order, *lists, image, tile,
                                                          True), 20),
        ms=queued_ms(lambda: kernel.resolve(rows, order, image, tile, budget, True), 20),
        bin_bound=bin_bound(rows, order, image, tile, budget)[:2],
        listed_bound=listed_bound(rows, order, image, tile, budget, True)[:2],
        bound=resolve_bound(rows, order, image, tile, budget, True)[:2],
        bin_plain_ms=time_cuda_ms(lambda: rc.bin_chunks(rows, order, image, tile, budget), 2),
        listed_plain_ms=1e3 * (t2 - t1), plain_ms=1e3 * (t2 - t0), bin_err=bin_err,
        listed_err=listed_err,
        most_listed=int(rc.bin_chunks(rows, order, image, tile, 1 << 30)[2].max()),
        Kc=rc.chunk_budget(budget, rows.shape[1]), out=out_k)


def regime_text(t: dict, run: int) -> str:
    runs = "; ".join(f"{r}: {a:.4f} ({b:.4f} + {c:.4f})" for r, (a, b, c) in t["runs"].items())
    clusters = "n/a" if t["clusters_ms"] is None else f"{t['clusters_ms']:.4f} ms"
    return (f"regime 3 by run length (rows: total ms (runs launch + merge alone)) {runs}; the "
            f"launcher's {run}; clusters of 8 {clusters}; torch.sort of the keys "
            f"{t['torch_sort_ms']:.4f} ms")


def binned_text(t: dict) -> str:
    (bb, bby), (lb, lby), (b, by) = t["bin_bound"], t["listed_bound"], t["bound"]
    return (f"kernel B above one window: binning launch {t['bin_ms']:.4f} ms (bound {bb:.4f} ms "
            f"by {bby}, plain bin_chunks {t['bin_plain_ms']:.2f} ms), listed resolve "
            f"{t['listed_ms']:.4f} ms (bound {lb:.4f} ms by {lby}, "
            f"{100 * lb / t['listed_ms']:.2f} %, plain resolve_plain {t['listed_plain_ms']:.1f} ms,"
            f" one call, host clock), together {t['ms']:.4f} ms (bound {b:.4f} ms by {by}, "
            f"{100 * b / t['ms']:.2f} %), plain {t['plain_ms']:.1f} ms (one call, host clock); "
            f"most chunks a tile touches {t['most_listed']}, budget {t['Kc']}; lists equal to "
            f"bin_chunks', images bit-equal with and without the attribute")


def large_soups_phase(tag: str, checked: dict) -> dict:
    """Phase 14, soups of any row count: (a) two items of each of LARGE_ROWS
    rows through render() (the entry point), counts zeroed before and read
    after (runs and their merge, the binning launch and the listed resolve at
    every size), then kernel A against its plain version (its order against
    torch.sort's) with the launcher's choice, clusters of 8 forced and runs
    of every length in RUN_ROWS, each timed with its runs launch and its
    merge alone beside torch.sort of the keys, and kernel B's binning launch
    and listed resolve against bin_chunks and resolve_plain, bit for bit,
    each timed with its bound and plain time; (b) record_dataset at
    ycbv-1M's sampler settings (480x640, focal 1060-1080, 2-8 objects, one
    view, cage p 0.9) over a mesh DB of YCBV_OBJECTS seeded 8,192-face
    meshes (demo.dense_specs, build_mesh_db's defaults): frames/s, launches
    held to the sampler's render calls; (c) a scene of all 8 objects and the
    cage (65,896 rows, one camera) through both kernels against their plain
    versions on the card, bit for bit, timed as in (a). Returns {"launches":
    of (a), "rows": the kernel line's numbers of the merge, the binning
    launch and the listed resolve (at the scene), "recording": launches of
    (b)}."""
    import shutil

    import numpy as np
    import torch

    from cosypose_tpu_torch import demo
    from cosypose_tpu_torch.ops import rasterizer_cuda as rc
    from cosypose_tpu_torch.ops.mesh_db import build_mesh_db
    from cosypose_tpu_torch.ops.raster_bounds import rank_bound, setup_bound
    from cosypose_tpu_torch.ops.render import render
    from cosypose_tpu_torch.ops.transforms import invert_T
    from cosypose_tpu_torch.recording import RecordingSceneSampler, record_dataset
    from cosypose_tpu_torch.recording.textures import TextureSampler
    from cosypose_tpu_torch.rendering.scene_renderer import SCENE_BUDGET, SCENE_TILE
    from cosypose_tpu_torch.scripts.run_dataset_recording import CONFIGS

    t_phase = time.perf_counter()
    kernel = rc.RASTER_KERNEL
    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    block, window = kernel.sort_block_rows(dev), kernel.window_rows(dev)
    log(f"{tag} phase 14: one block of kernel A sorts {block} rows, one window of kernel B "
        f"holds {window}")

    # (a) the entry point at each size, then each kernel against its plain version
    soups = {F: large_soup(2, F, LARGE_IMAGE, seed=F, device=dev) for F in LARGE_ROWS}
    budget = SCENE_BUDGET
    kernel.launches = {k: 0 for k in kernel.launches}
    for F, (args, attr) in soups.items():
        render(*args[:4], image_size=LARGE_IMAGE, colors=args[4], tile=SCENE_TILE,
               max_tris_per_tile=budget, tri_attr=attr)
    torch.cuda.synchronize()
    launches = dict(kernel.launches)
    plans = {F: kernel.setup_plan(2, F, dev) for F in LARGE_ROWS}
    runs = {F: kernel.run_rows(2, F, dev) for F in LARGE_ROWS}
    want = {"raster_setup": len(LARGE_ROWS),
            "raster_setup_merge": sum(kernel.merge_passes(F, runs[F]) for F in LARGE_ROWS),
            "raster_resolve": 0, "raster_resolve_attr": 0,
            "raster_resolve_bin": len(LARGE_ROWS), "raster_resolve_listed": len(LARGE_ROWS)}
    log(f"{tag} render() of 2 items at each of {LARGE_ROWS} rows ({LARGE_IMAGE}, tile "
        f"{SCENE_TILE}, budget {budget}): launches {launches} (want {want}; the launcher's "
        f"plans {plans}, runs of {runs} rows, merge passes "
        f"{ {F: kernel.merge_passes(F, runs[F]) for F in LARGE_ROWS} })")
    if launches != want or any(p != -1 for p in plans.values()):
        raise AssertionError(f"render() at large soups launched {launches}, want {want}")

    for F, (args, attr) in soups.items():
        setup_args = (*args[:4], LARGE_IMAGE, args[4])
        rows, key, order, _, err, abs_err = setup_vs_plain(setup_args, attr)
        checked["raster_setup"].append(f"large soup: 2 x {F} rows (runs of {runs[F]})")
        checked["raster_setup_merge"].append(f"large soup: 2 x {F} rows, runs of {RUN_ROWS}")
        regimes = regime_timing(setup_args, attr, key)
        ms_a = queued_ms(lambda: rc.setup(*setup_args, tri_attr=attr), 20)
        plain_a = time_cuda_ms(lambda: rc.sort_order(rc.setup_plain(*setup_args,
                                                                    tri_attr=attr)[1]), 2)
        b_a, by_a = setup_bound(args[0], args[1], args[4], attr, rows, key)[:2]
        b_m, by_m = rank_bound(2, F)
        b = binned_resolve_timing(rows, order, LARGE_IMAGE, SCENE_TILE, budget)
        for name in ("raster_resolve_listed", "raster_resolve_bin"):
            checked[name].append(f"large soup: 2 x {F} rows, {LARGE_IMAGE}, tile {SCENE_TILE}, "
                                 f"budget {budget}")
        log(f"{tag} 2 x {F} rows: raster_setup (runs of {runs[F]}) vs plain: plane rel err "
            f"{err['plane']:.3g}, bbox/key {err['bbox_key']:.3g} (<= {rc.SETUP_TOL}), max abs "
            f"err {abs_err:.3g}, order equal to torch.sort's; {ms_a:.4f} ms, bound {b_a:.4f} ms "
            f"by {by_a}, plain {plain_a:.2f} ms; {regime_text(regimes, runs[F])}; the merge's "
            f"bound {b_m:.4f} ms by {by_m}; {binned_text(b)}")
        del rows, key, order, b
    del soups

    # (b) recording at ycbv-1M's sampler settings over seeded 8,192-face meshes
    cfg = CONFIGS["ycbv-1M"]
    db = build_mesh_db(demo.dense_specs(YCBV_OBJECTS), device=dev)

    def sampler(**kw):
        return RecordingSceneSampler(db, resolution=cfg["resolution"],
                                     focal_interval=cfg["focal"],
                                     texture_sampler=TextureSampler(p_textured=0.8), **kw)

    out_dir = DATA_ROOT / "ycbv_sized"
    shutil.rmtree(out_dir, ignore_errors=True)
    record_dataset(sampler(), out_dir / "warm-up", n_chunks=1, n_frames_per_chunk=2)
    rec = sampler()
    kernel.launches = {k: 0 for k in kernel.launches}
    t0 = time.perf_counter()
    record_dataset(rec, out_dir / "recorded", n_chunks=1, n_frames_per_chunk=YCBV_FRAMES)
    wall = time.perf_counter() - t0
    got = dict(kernel.launches)
    n_scene, n_amodal = rec.counts["scene_renders"], rec.counts["amodal_renders"]
    if got["raster_setup"] != n_scene + n_amodal or got["raster_resolve"] != n_amodal \
            or got["raster_resolve_attr"] + got["raster_resolve_listed"] != n_scene \
            or got["raster_resolve_bin"] != got["raster_resolve_listed"]:
        raise AssertionError(f"ycbv-sized recording launched {got} for {n_scene} scene and "
                             f"{n_amodal} amodal renders")
    t = rec.times
    log(f"{tag} record_dataset at ycbv-1M's settings ({cfg['resolution']}, focal {cfg['focal']},"
        f" 2-8 of {YCBV_OBJECTS} objects of 8,192 faces, cage p 0.9, one view): {YCBV_FRAMES} "
        f"frames in {wall:.2f} s, {YCBV_FRAMES / wall:.2f} frames/s; a frame: scene render "
        f"{1e3 * t['scene_render'] / YCBV_FRAMES:.1f} ms, amodal render "
        f"{1e3 * t['amodal_render'] / YCBV_FRAMES:.1f} ms, PNG encode + write "
        f"{1e3 * t['write'] / YCBV_FRAMES:.1f} ms; launches {got} for {n_scene} scene and "
        f"{n_amodal} amodal render calls")

    # (c) the largest ycbv-1M scene: 8 objects and the cage, one camera
    full = sampler(n_objects_interval=(YCBV_OBJECTS, YCBV_OBJECTS + 1), p_cage=1.0)
    rng = np.random.RandomState(0)
    scene = full._sample_objects(rng) + full._cage_geometry(rng)
    cam = full._sample_camera(rng)
    tv, valid, colors, ids = full.renderer.soup(scene)
    on = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt, device=dev)[None]  # noqa: E731
    res = cfg["resolution"]
    setup_args = (on(tv), on(valid, torch.bool), invert_T(on(cam["TWC"])), on(cam["K"]), res,
                  on(colors))
    attr = on(ids)
    rows, key, order, _, err, abs_err = setup_vs_plain(setup_args, attr)
    Fp = rows.shape[1]
    if Fp != 65_896:
        raise AssertionError(f"the ycbv-sized scene has {Fp} rows, want 65,896")
    budget_s = min(Fp, SCENE_BUDGET)
    run = kernel.run_rows(1, Fp, dev)
    regimes = regime_timing(setup_args, attr, key)
    b = binned_resolve_timing(rows, order, res, SCENE_TILE, budget_s)
    checked["raster_setup"].append(f"ycbv-1M-sized scene: 1 x {Fp} rows, {res}")
    checked["raster_setup_merge"].append(f"ycbv-1M-sized scene: 1 x {Fp} rows, runs of "
                                         f"{RUN_ROWS}")
    for name in ("raster_resolve_listed", "raster_resolve_bin"):
        checked[name].append(f"ycbv-1M-sized scene: 1 x {Fp} rows, {res}, tile {SCENE_TILE}, "
                             f"budget {budget_s}")
    ms_a = queued_ms(lambda: rc.setup(*setup_args, tri_attr=attr), 20)
    b_a, by_a = setup_bound(setup_args[0], setup_args[1], setup_args[5], attr, rows, key)[:2]
    b_m, by_m = rank_bound(1, Fp)
    _, merge, _, key_m, order_m = merge_launch((*setup_args, attr), run)
    merge()
    torch.cuda.synchronize()
    e_merge = float((order_m - torch.sort(key_m, dim=1, stable=True).indices).abs().max())
    plain_m = time_cuda_ms(lambda: rc.merge_runs(key_m, run), 1, warmup=0)
    log(f"{tag} ycbv-1M-sized scene (1 camera x {Fp} rows, {res[0]}x{res[1]}, tile {SCENE_TILE},"
        f" budget {budget_s}; {int((b['out'][1] > 0).sum())} pixels drawn, ids "
        f"{sorted(b['out'][2].unique().tolist())}): raster_setup (plan "
        f"{kernel.setup_plan(1, Fp, dev)}, runs of {run}) vs plain plane rel err "
        f"{err['plane']:.3g}, bbox/key {err['bbox_key']:.3g}, order equal to torch.sort's, "
        f"{ms_a:.4f} ms, bound {b_a:.4f} ms by {by_a}; {regime_text(regimes, run)}; the merge's "
        f"bound {b_m:.4f} ms by {by_m}, plain (merge_runs) {plain_m:.1f} ms, its order vs "
        f"torch.sort's max abs err {e_merge:g}; {binned_text(b)}")
    if e_merge:
        raise AssertionError("raster_setup_merge at the ycbv-sized scene: the order differs")
    merge_ms = regimes["runs"][run][2]
    rows_out = {
        "raster_setup_merge": dict(max_abs_err=e_merge, ms=merge_ms, plain_ms=plain_m,
                                   bound_ms=b_m, bound_by=by_m,
                                   library_ms=regimes["torch_sort_ms"]),
        "raster_resolve_bin": dict(max_abs_err=b["bin_err"], ms=b["bin_ms"],
                                   plain_ms=b["bin_plain_ms"],
                                   bound_ms=b["bin_bound"][0], bound_by=b["bin_bound"][1],
                                   library_ms=None),
        "raster_resolve_listed": dict(max_abs_err=b["listed_err"], ms=b["listed_ms"],
                                      plain_ms=b["listed_plain_ms"],
                                      bound_ms=b["listed_bound"][0],
                                      bound_by=b["listed_bound"][1], library_ms=None)}
    del merge, key_m, order_m
    shutil.rmtree(out_dir, ignore_errors=True)
    log(f"phase 14 took {time.perf_counter() - t_phase:.0f} s")
    return {"launches": launches, "rows": rows_out, "recording": got}


# phase 15: one B=64 iteration of the serving cell's B3 at its render size
DW_BATCH, DW_IMAGE = 64, (240, 320)
DW_ODD = [(7, 3, 2, 13, 17), (5, 5, 2, 9, 11), (6, 5, 2, 10, 7), (4, 5, 1, 3, 4),
          (3, 3, 2, 1, 1), (2, 5, 1, 9, 3000)]  # the last: a band above 48 KB in fp32
HBM_BYTES_S = 3.35e12


def dw_inputs(shape, batch, dtype, seed, device):
    """(x, weight, bn_weight, bn_bias, running_mean, running_var, eps, k,
    stride) of one block's depthwise half, seeded, on the card, with the
    eval modules (DepthwiseConv2dSame, BatchNorm2d) that hold them."""
    import torch

    from cosypose_tpu_torch.models.efficientnet import BatchNorm2d, DepthwiseConv2dSame

    C, k, s, H, W = shape
    g = torch.Generator(device).manual_seed(seed)
    dw, bn = DepthwiseConv2dSame(C, k, s).to(device).eval(), BatchNorm2d(C).to(device).eval()
    with torch.no_grad():
        dw.weight.copy_(torch.randn(dw.weight.shape, generator=g, device=device) * 0.3)
        bn.weight.copy_(torch.rand(C, generator=g, device=device) + 0.5)
        bn.bias.copy_(torch.randn(C, generator=g, device=device) * 0.3)
        bn.running_mean.copy_(torch.randn(C, generator=g, device=device) * 0.3)
        bn.running_var.copy_(torch.rand(C, generator=g, device=device) * 2 + 0.2)
    x = torch.randn(batch, C, H, W, generator=g, device=device).to(dtype)
    return (x, dw.weight.detach(), bn.weight.detach(), bn.bias.detach(), bn.running_mean,
            bn.running_var, bn.eps, k, s), dw, bn


def dw_check(args) -> float:
    """The kernel against its plain version (the largest gap over its
    error_limit, at most 1) and against a second call, bit for bit."""
    import torch

    from cosypose_tpu_torch.ops import depthwise_cuda as dwc

    y, s = dwc.DW_KERNEL(*args)
    y2, s2 = dwc.DW_KERNEL(*args)
    yp, sp = dwc.dw_bn_silu_squeeze_plain(*args)
    ly, ls = dwc.error_limit(*args, yp)
    ratio = max(float(((y.float() - yp.float()).abs() / ly.clamp_min(1e-30)).max()),
                float(((s.float() - sp.float()).abs() / ls.clamp_min(1e-30)).max()))
    if not ratio <= 1 or not (torch.equal(y, y2) and torch.equal(s, s2)):
        raise AssertionError(f"dw_bn_silu_squeeze at {tuple(args[0].shape)} {args[0].dtype}, "
                             f"kernel {args[7]}, stride {args[8]}: gap {ratio:.3g} of its limit, "
                             f"deterministic {torch.equal(y, y2) and torch.equal(s, s2)}")
    return ratio


def host_us(fn, n: int = 300) -> float:
    """Host microseconds a call of fn (its enqueue), over n calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * t / n


def dw_kernel_phase(tag: str) -> dict:
    """Phase 15, the MBConv block's depthwise half (ops/depthwise_cuda.py):
    (a) at EfficientNet-B3's 14 distinct depthwise shapes at B=64, 240x320,
    bf16, the kernel against its plain version (dw_check), in fp32 and fp16
    at four of them (B=8) and at DW_ODD's sizes; (b) device ms of the 26
    launches of one iteration, by CUDA events behind a spin kernel, and of
    each shape alone, beside the byte bound (moved_bytes at 3.35 TB/s), the
    plain version's ms and library_ms, the ATen chain the block ran before
    (grouped conv after F.pad, eval BatchNorm, SiLU, mean, under bf16
    autocast); (c) host us a call of the ctypes launcher, the registered
    operator, the block's wrapper and the ATen chain, at the last block's
    shape with B=1 (the card outruns the host there). Returns the numbers."""
    import torch
    import torch.nn.functional as F

    from cosypose_tpu_torch.models.efficientnet import EfficientNet
    from cosypose_tpu_torch.ops import depthwise_cuda as dwc

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    shapes = EfficientNet("efficientnet-b3").depthwise_shapes(DW_IMAGE)
    distinct = sorted(set(shapes), key=shapes.index)
    before = dwc.DW_KERNEL.launches
    with torch.inference_mode():
        # (a) against the plain version
        ratios = {}
        for i, shape in enumerate(distinct):
            ratios[shape] = dw_check(dw_inputs(shape, DW_BATCH, torch.bfloat16, i, dev)[0])
        other = {}
        for dtype in (torch.float32, torch.float16):
            for i, shape in enumerate(distinct[:3] + distinct[-1:] + DW_ODD):
                batch = 8 if shape in distinct else 3
                other[str(dtype), shape] = dw_check(dw_inputs(shape, batch, dtype, i, dev)[0])
        for i, shape in enumerate(DW_ODD[:-1]):
            other["torch.bfloat16", shape] = dw_check(
                dw_inputs(shape, 3, torch.bfloat16, i, dev)[0])
        log(f"{tag} dw_bn_silu_squeeze vs plain: B3's 14 shapes at B={DW_BATCH} bf16, largest "
            f"gap {max(ratios.values()):.3g} of error_limit; fp32/fp16 at 4 shapes (B=8) and "
            f"odd sizes (B=3) {max(other.values()):.3g}; every call equal to a second one "
            f"bit for bit")

        # (b) device ms
        calls = [dw_inputs(shape, DW_BATCH, torch.bfloat16, i, dev) for i, shape in
                 enumerate(shapes)]

        def kernels():
            for args, _, _ in calls:
                dwc.DW_KERNEL(*args)

        def plain():
            for args, _, _ in calls:
                dwc.dw_bn_silu_squeeze_plain(*args)

        def chain(args, dw, bn):
            y = F.silu(bn(dw(args[0])))
            return y, y.mean(dim=(2, 3), keepdim=True)

        def library():
            with torch.autocast("cuda", dtype=torch.bfloat16):
                for c in calls:
                    chain(*c)

        ms = queued_ms(kernels, 10)
        lib_ms = queued_ms(library, 5)
        plain_ms = time_cuda_ms(plain, 2, warmup=1)
        bound = sum(dwc.moved_bytes(DW_BATCH, C, H, W, k, s, 2)
                    for C, k, s, H, W in shapes) / HBM_BYTES_S * 1e3
        per_shape = []
        for shape in distinct:
            args = calls[shapes.index(shape)][0]
            t = queued_ms(lambda: dwc.DW_KERNEL(*args), 20)
            C, k, stride, H, W = shape
            b_ms = dwc.moved_bytes(DW_BATCH, C, H, W, k, stride, 2) / HBM_BYTES_S * 1e3
            per_shape.append(dict(shape=shape, blocks=shapes.count(shape), ms=t, bound_ms=b_ms,
                                  share_pct=100 * b_ms / t))
        log(f"{tag} dw_bn_silu_squeeze, B3's 26 blocks at B={DW_BATCH}, {DW_IMAGE}, bf16 (CUDA "
            f"events behind a spin kernel): {ms:.4f} ms, bound {bound:.4f} ms by bytes "
            f"({100 * bound / ms:.1f} %); plain {plain_ms:.2f} ms; library_ms (F.pad + grouped "
            f"conv + BatchNorm + SiLU + mean under autocast) {lib_ms:.4f} ms")
        for r in per_shape:
            log(f"  {r['shape']} x{r['blocks']}: {r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                f"({r['share_pct']:.1f} %)")

        # (c) host us a call
        args1, dw1, bn1 = calls[-1]
        args1 = (args1[0][:1].contiguous(), *args1[1:])
        with torch.autocast("cuda", dtype=torch.bfloat16):
            host = dict(ctypes=host_us(lambda: dwc.DW_KERNEL(*args1)),
                        operator=host_us(lambda: dwc.dw_bn_silu_squeeze_op(*args1)),
                        wrapper=host_us(lambda: dwc.dw_bn_silu_squeeze(*args1)),
                        library=host_us(lambda: chain(args1, dw1, bn1)))
        log(f"{tag} dw_bn_silu_squeeze host us a call ({tuple(args1[0].shape)}): " + ", ".join(
            f"{k} {v:.1f}" for k, v in host.items()))
    torch.cuda.synchronize()
    launches = dwc.DW_KERNEL.launches - before
    log(f"phase 15 took {time.perf_counter() - t_phase:.0f} s")
    return dict(name="dw_bn_silu_squeeze", route="cuda",
                source="cosypose_tpu_torch/csrc/dw_bn_silu_squeeze.cu", replaces=None,
                ms=ms, bound_ms=bound, bound_by="bytes", share_pct=100 * bound / ms,
                plain_ms=plain_ms, library_ms=lib_ms, per_shape=per_shape, host_us=host,
                max_gap_of_limit=max([*ratios.values(), *other.values()]),
                launches_phase15=launches)


# phase 16: Mask R-CNN's NMS at the detector's own calls (480x640, 22 classes,
# bf16), the seeded weights calibrated on NMS_CAL_FRAMES random frames;
# frames sent one a call through Detector.get_detections
NMS_CAL_FRAMES, NMS_FRAMES = 2, 3


def nms_kernel_phase(tag: str) -> dict:
    """Phase 16, Mask R-CNN's NMS (ops/nms_cuda.py -> csrc/nms.cu): the
    published Mask R-CNN (benchmark/reference/maskrcnn.py's seeded weights)
    at 480x640 in bf16, its NMS calls captured as the main path makes them:
    the RPN's (4,140 boxes in 5 level groups, small boxes invalid) and the
    box head's (the candidates above the score threshold in their class
    groups). At each: the kernel's kept rows EQUAL to nms_plain's on CPU
    copies; its device ms by CUDA events behind a spin kernel beside the
    byte bound (detect_counts.nms_bytes at 3.35 TB/s) and the plain
    version's ms on the card's tensors. Then NMS_FRAMES frames through
    Detector.get_detections(output_masks=True) with NMS_KERNEL.launches set
    to 0 first: 2 launches a frame. Returns the kernel's numbers."""
    import torch

    from benchmark.harness import detect_counts
    from benchmark.reference import maskrcnn as ref_mrcnn
    from cosypose_tpu_torch.integrated.detector import Detector
    from cosypose_tpu_torch.models.mask_rcnn import MaskRCNN, MaskRCNNConfig
    from cosypose_tpu_torch.ops import nms_cuda

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(16)
    frames = torch.rand(NMS_CAL_FRAMES + NMS_FRAMES, 3, 480, 640, generator=g, device=dev)
    weights = ref_mrcnn.seeded_weights(22, g, frames[:NMS_CAL_FRAMES])
    model = MaskRCNN(MaskRCNNConfig(compute_dtype=torch.bfloat16)).to(dev).eval()
    model.load_state_dict(weights)
    del weights

    calls, sorted_nms = [], nms_cuda.nms_sorted

    def capture(boxes, offsets, iou, valid=None):
        calls.append((boxes.float().clone(), offsets.clone(), float(iou),
                      None if valid is None else valid.clone()))
        return sorted_nms(boxes, offsets, iou, valid)

    nms_cuda.nms_sorted = capture
    try:
        model(frames[NMS_CAL_FRAMES:NMS_CAL_FRAMES + 1], masks=True)
    finally:
        nms_cuda.nms_sorted = sorted_nms
    if len(calls) != 2:
        raise AssertionError(f"a Mask R-CNN call made {len(calls)} NMS calls, want 2")

    sites = []
    for site, (boxes, offsets, iou, valid) in zip(("rpn", "box_head"), calls):
        n, groups = boxes.shape[0], offsets.shape[0] - 1
        if site == "rpn" and (n, groups) != (4140, 5):
            raise AssertionError(f"the RPN's NMS took {n} boxes in {groups} groups, "
                                 "want 4,140 in 5")
        got = nms_cuda.NMS_KERNEL(boxes, offsets, iou, valid)
        want = nms_cuda.nms_plain(boxes.cpu(), offsets.cpu(), iou,
                                  None if valid is None else valid.cpu())
        if not torch.equal(got.cpu(), want):
            raise AssertionError(f"nms at the {site}'s call ({n} boxes, {groups} groups): "
                                 f"{int((got.cpu() != want).sum())} rows differ from nms_plain")
        ms = queued_ms(lambda: nms_cuda.NMS_KERNEL(boxes, offsets, iou, valid), 50)
        plain_ms = time_cuda_ms(lambda: nms_cuda.nms_plain(boxes, offsets, iou, valid), 5,
                                warmup=1)
        bound = detect_counts.nms_bytes(n, groups) / HBM_BYTES_S * 1e3
        sizes = (offsets[1:] - offsets[:-1]).tolist()
        sites.append(dict(site=site, boxes=n, groups=groups, largest_group=max(sizes),
                          valid=n if valid is None else int(valid.sum()), kept=int(want.sum()),
                          iou=iou, ms=ms, bound_ms=bound, share_pct=100 * bound / ms,
                          plain_ms=plain_ms))
        log(f"{tag} nms at the {site}'s call ({n} boxes in {groups} groups, largest "
            f"{max(sizes)}, {sites[-1]['valid']} valid, IoU {iou}): {sites[-1]['kept']} kept, "
            f"equal to nms_plain; kernel {ms:.4f} ms (CUDA events behind a spin kernel), bound "
            f"{bound:.6f} ms by bytes ({100 * bound / ms:.4f} %), plain {plain_ms:.3f} ms")

    det = Detector(model, {f"obj_{k:06d}": k for k in range(1, 22)})
    nms_cuda.NMS_KERNEL.launches = 0
    found = []
    for k in range(NMS_FRAMES):
        out = det.get_detections(frames[NMS_CAL_FRAMES + k:NMS_CAL_FRAMES + k + 1],
                                 output_masks=True)
        found.append(len(out))
    torch.cuda.synchronize()
    launches = nms_cuda.NMS_KERNEL.launches
    if launches != 2 * NMS_FRAMES:
        raise AssertionError(f"Detector.get_detections with Mask R-CNN launched the NMS kernel "
                             f"{launches} times over {NMS_FRAMES} frames, want "
                             f"{2 * NMS_FRAMES}")
    log(f"{tag} Detector.get_detections, Mask R-CNN at 480x640 bf16, {NMS_FRAMES} frames one a "
        f"call: {launches} NMS launches (2 a frame), detections {found}")
    log(f"phase 16 took {time.perf_counter() - t_phase:.0f} s")
    rpn = sites[0]
    return dict(name="nms", route="cuda", source="cosypose_tpu_torch/csrc/nms.cu",
                replaces=None, ms=rpn["ms"], bound_ms=rpn["bound_ms"], bound_by="bytes",
                share_pct=rpn["share_pct"], plain_ms=rpn["plain_ms"], library_ms=None,
                per_site=sites, launches_detector=launches, detections=found)


def cmyk_readers(fx, arrays: dict) -> str:
    """The CMYK fixtures through the port's readers, against the stored Pillow
    arrays: data/bop.py keeps the first three channels as Pillow presents
    them (the JAX package slices its raw array), the texture dataset and the
    background paste convert to RGB as Pillow does (data/pillow_ops.py)."""
    import random
    import shutil

    import numpy as np

    from cosypose_tpu_torch.data import pillow_ops
    from cosypose_tpu_torch.data.augmentations import BackgroundAugmentation, SceneObservation
    from cosypose_tpu_torch.data.bop import BOPDataset
    from cosypose_tpu_torch.data.texture_dataset import TextureDataset

    root = REPO / "build" / "chip_smoke_data" / "cmyk"
    shutil.rmtree(root, ignore_errors=True)
    scene = root / "test" / "000000"
    (scene / "rgb").mkdir(parents=True)
    (root / "textures").mkdir()
    cam = {}
    for view, name in enumerate(JPEG_CMYK):
        shutil.copyfile(fx.ROOT / name, scene / "rgb" / f"{view:06d}.jpg")
        shutil.copyfile(fx.ROOT / name, root / "textures" / name)
        cam[str(view)] = {"cam_K": [600.0, 0.0, 320.0, 0.0, 600.0, 240.0, 0.0, 0.0, 1.0]}
    (scene / "scene_camera.json").write_text(json.dumps(cam))
    bop = BOPDataset(root, split="test")
    textures = TextureDataset(root / "textures")
    for view, name in enumerate(JPEG_CMYK):
        ref = arrays[name]
        if ref.shape[2] != 4 or not np.array_equal(bop[view][0], ref[..., :3]):
            raise AssertionError(f"BOPDataset on {name}: not the first three CMYK channels")
        got = textures[textures.index.index(root / "textures" / name)]
        if not np.array_equal(got, pillow_ops.cmyk_to_rgb(ref).astype(np.float32) / 255.0):
            raise AssertionError(f"TextureDataset on {name}: not Pillow's convert('RGB')")
    h, w = 96, 128
    obs = SceneObservation(np.zeros((h, w, 3), np.uint8), np.zeros((h, w), np.int32), {})
    aug = BackgroundAugmentation([fx.ROOT / JPEG_CMYK[0]], p=1.0, rng=random.Random(0))
    want = pillow_ops.resize_bilinear(pillow_ops.cmyk_to_rgb(arrays[JPEG_CMYK[0]]), (h, w))
    if not np.array_equal(aug(obs).rgb, want):
        raise AssertionError("BackgroundAugmentation on a CMYK JPEG: not Pillow's RGB, resized")
    return (f"CMYK readers on {', '.join(JPEG_CMYK)}: BOPDataset's frames are the first three "
            f"channels as Pillow presents them, TextureDataset and BackgroundAugmentation "
            f"convert to RGB as Pillow does; all equal to the stored arrays")


def public_names_card_vs_cpu() -> str:
    """masked_boxes_from_uv, BatchedMeshes.select and sample_points(
    deterministic=False, seed=3) on the card against the CPU: gathers and
    minima, so equal."""
    import numpy as np
    import torch

    from cosypose_tpu_torch import demo
    from cosypose_tpu_torch.ops.camera import masked_boxes_from_uv
    from cosypose_tpu_torch.ops.mesh_db import build_mesh_db

    rng = np.random.RandomState(0)
    uv = rng.uniform(-50, 700, (BATCH, 2000, 2)).astype(np.float32)
    valid = rng.uniform(size=(BATCH, 2000)) > 0.3
    valid[1] = False
    boxes = [masked_boxes_from_uv(torch.as_tensor(uv, device=d), torch.as_tensor(valid, device=d))
             .cpu() for d in ("cuda", "cpu")]
    dbs = [build_mesh_db(demo.demo_specs(), render_max_faces=LOD, device=d) for d in ("cuda", "cpu")]
    ids = rng.randint(0, dbs[0].n_objects, BATCH)
    sel = [db.select(torch.as_tensor(ids, device=db.device)) for db in dbs]
    pts = [db.sample_points(torch.as_tensor(ids, device=db.device), 500, deterministic=False,
                            seed=3).cpu() for db in dbs]
    same = {"masked_boxes_from_uv": torch.equal(*boxes),
            "select": all(torch.equal(getattr(sel[0], f).cpu(), getattr(sel[1], f))
                          for f in ("points", "valid", "symmetries", "sym_valid")),
            "sample_points": torch.equal(*pts)}
    if not all(same.values()) or not torch.isinf(boxes[0][1]).all():
        raise AssertionError(f"card vs CPU: {same}")
    return (f"card vs CPU, equal: masked_boxes_from_uv ({BATCH} x 2000 points, an empty row "
            f"gives +-inf), BatchedMeshes.select ({BATCH} ids of {dbs[0].n_objects} objects), "
            f"sample_points(500, deterministic=False, seed=3)")


def setup_vs_plain(args, tri_attr=None):
    """Kernel A against its plain version on the same inputs (tri_verts,
    tri_valid, TCO, K, image_size, colors): rows held to setup_plain within
    SETUP_TOL as rasterizer_cuda.setup_error reads it, with validity and
    attributes equal, and the order equal element for element to
    torch.sort(key, dim=1, stable=True).indices on the card. Returns (rows,
    key, order, plain key, error dict, max abs error over rows valid in both).
    The bbox and key lanes are measured against the terms of the projection
    (setup_error with K): crop intrinsics of far-off poses put the principal
    point thousands of pixels outside the crop."""
    import torch

    from cosypose_tpu_torch.ops import rasterizer_cuda as rc

    rows, key, order = rc.setup(*args, tri_attr=tri_attr)
    rows_p, key_p = rc.setup_plain(*args, tri_attr=tri_attr)
    want = torch.sort(key, dim=1, stable=True).indices
    if not torch.equal(order, want):
        raise AssertionError(f"raster_setup: the order differs from torch.sort's in "
                             f"{int((order != want).any(1).sum())} of {order.shape[0]} items")
    err = rc.setup_error(rows, key, rows_p, key_p, args[4], K=args[3])
    both = (rows[..., rc.LANE_VALID] != 0) & (rows_p[..., rc.LANE_VALID] != 0)
    abs_err = max(float((rows[both] - rows_p[both]).abs().max()),
                  float((key[both] - key_p[both]).abs().max()))
    if err["valid_differs"] or err["attr"] or err["plane"] > rc.SETUP_TOL \
            or err["bbox_key"] > rc.SETUP_TOL:
        raise AssertionError(f"raster_setup vs plain: {err} (tolerance {rc.SETUP_TOL}; largest "
                             f"|cx|, |cy| {args[3][:, :2, 2].abs().max().item():.1f} px)")
    return rows, key, order, key_p, err, abs_err


def setup_timing(args, key, tri_attr=None) -> dict:
    """Kernel A's device ms at one shape, by CUDA events behind a spin kernel:
    with the clusters its launcher chooses (ms), with one block an item
    (one_block_ms), and torch.sort of its keys alone (torch_sort_ms), the
    sort that used to follow it and that the port no longer calls."""
    import torch

    from cosypose_tpu_torch.ops import rasterizer_cuda as rc

    kernel = rc.RASTER_KERNEL
    return dict(ms=queued_ms(lambda: rc.setup(*args, tri_attr=tri_attr), 50),
                one_block_ms=queued_ms(lambda: kernel.setup(*args, tri_attr=tri_attr, cluster=1),
                                       50),
                torch_sort_ms=queued_ms(lambda: torch.sort(key, dim=1, stable=True), 50))


def setup_timing_text(t: dict, bound_ms: float, by: str) -> str:
    return (f"raster_setup (rows, keys and order) {t['ms']:.4f} ms (bound {bound_ms:.4f} ms by "
            f"{by}, {100 * bound_ms / t['ms']:.1f} %), one block an item {t['one_block_ms']:.4f} "
            f"ms; torch.sort of the keys alone {t['torch_sort_ms']:.4f} ms (not called by the "
            f"port)")


def render_kernel_names(call) -> list:
    """The device kernels that one call of `call` launches, by name, from a
    torch.profiler trace of that call alone (after a warm-up call). Raises
    where the trace holds no kernel: the profiler has stopped seeing the card
    (PERF.md §7), which is why this runs early in the process."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    path = OUT_DIR / "render_trace.json"
    prof.export_chrome_trace(str(path))
    names = [e["name"] for e in json.loads(path.read_text())["traceEvents"]
             if e.get("cat") == "kernel"]
    if not names:
        raise RuntimeError("the trace of one render call holds no kernel")
    return names


def scene_inputs(device, n_objects=SCENE_OBJECTS, seed=0):
    """A full-width scene of CONFIGS["procedural"] with n_objects procedural
    objects and the cage, seen by SCENE_CAMERAS cameras, as SceneRenderer
    composes it: (setup args, instance ids) on `device`."""
    import numpy as np
    import torch

    from cosypose_tpu_torch.ops.transforms import invert_T
    from cosypose_tpu_torch.scripts.run_dataset_recording import _make_sampler

    sampler = _make_sampler("procedural", n_objects_interval=(n_objects, n_objects + 1),
                            device=device)
    rng = np.random.RandomState(seed)
    scene = sampler._sample_objects(rng)
    scene += sampler._cage_geometry(rng)
    cams = [sampler._sample_camera(rng) for _ in range(SCENE_CAMERAS)]
    tv, valid, colors, ids = sampler.renderer.soup(scene)

    def bc(x, dtype=torch.float32):
        return torch.as_tensor(x, dtype=dtype, device=device)[None].expand(
            SCENE_CAMERAS, *x.shape).contiguous()

    TCW = invert_T(torch.as_tensor(np.stack([c["TWC"] for c in cams]), device=device))
    K = torch.as_tensor(np.stack([c["K"] for c in cams]), device=device)
    return (bc(tv), bc(valid, torch.bool), TCW, K, sampler.resolution, bc(colors)), bc(ids)


def procedural_scene(device, n_objects=SCENE_OBJECTS, seed=0):
    """The attribute kernel's input at scene_inputs(...): (rows, order,
    image size) on `device`, from kernel A (card) or its plain version (CPU)."""
    from cosypose_tpu_torch.ops import rasterizer_cuda as rc

    args, ids = scene_inputs(device, n_objects, seed)
    rows, _, order = rc.setup(*args, tri_attr=ids)
    return rows, order, args[4]


def amodal_inputs(device, seed=0):
    """The render() inputs of the amodal re-render as RecordingSceneSampler
    builds them for one scene of CONFIGS["procedural"] (n_views_per_scene x
    the largest object count, one 1216-row procedural mesh an item, the
    padding far behind the camera), taken at the call: (setup args, tile,
    budget) on `device`."""
    from cosypose_tpu_torch.rendering import scene_renderer
    from cosypose_tpu_torch.scripts.run_dataset_recording import _make_sampler

    sampler = _make_sampler("procedural", device=device)
    calls, render = [], scene_renderer.render

    def keep(*args, **kwargs):
        calls.append((args, kwargs))
        return render(*args, **kwargs)

    scene_renderer.render = keep
    try:
        sampler.sample_scene_frames(seed, int(sampler.n_views_per_scene))
    finally:
        scene_renderer.render = render
    args, kw = [c for c in calls if c[1].get("tri_attr") is None][-1]
    return ((*args, kw["image_size"], kw["colors"]), kw["tile"], kw["max_tris_per_tile"])


def record_card_vs_cpu(root: pathlib.Path):
    """One small scene (the demo cubes at 96x128, 3 views, textures, cage)
    recorded on the card (raster kernels) and on the CPU (plain versions)
    from the same seed: ({quantity: (error, tolerance)}, {kind: (pixels that
    differ, pixels)}); the caller checks the first.

    The sampler's host draws are the same, so cameras, poses and the kept
    objects must agree. The resolve kernel is bit-exact against its plain
    version on the same rows; the setup kernel's rows differ from its plain
    version's in their last bits. Whole-millimetre depth is a truncation, so
    a pixel whose depth lies within those bits of a millimetre may come out
    1 mm apart: on this scene 2 of 36,864 depth pixels do (measured on an
    H100), and depth is held to 1 mm. Everything else, measured equal, is
    held exactly: GT JSON, boxes, visible fractions, rgb and mask pixels.
    """
    import numpy as np

    from cosypose_tpu_torch import demo
    from cosypose_tpu_torch.ops.mesh_db import build_mesh_db
    from cosypose_tpu_torch.recording import RecordingSceneSampler, record_dataset
    from cosypose_tpu_torch.recording.textures import TextureSampler
    from cosypose_tpu_torch.utils.png import imread

    scenes = []
    for d in ("cpu", "cuda"):
        sampler = RecordingSceneSampler(
            build_mesh_db(demo.cube_specs(), device=d), resolution=SMALL_SCENE,
            n_objects_interval=(3, 5), min_visible_pixels=10, border_check=False,
            camera_distance_interval=(0.5, 0.9), n_views_per_scene=3,
            texture_sampler=TextureSampler(p_textured=0.8))
        scenes.append(record_dataset(sampler, root / d, n_chunks=1,
                                     n_frames_per_chunk=3) / "train_synt" / "000000")
    cpu, card = scenes

    def numbers(scene_dir, name, key):
        rows = json.loads((scene_dir / name).read_text())
        return np.asarray([v for view in rows.values()
                           for row in (view if isinstance(view, list) else [view])
                           for v in np.ravel(row[key]).tolist()], np.float64)

    def err(name, key):
        a, b = numbers(cpu, name, key), numbers(card, name, key)
        return float(np.abs(a - b).max()) if a.shape == b.shape and a.size else math.inf

    files = sorted(p.relative_to(cpu) for p in cpu.rglob("*.png"))
    same_files = files == sorted(p.relative_to(card) for p in card.rglob("*.png"))
    off = {k: [0, 0, 0] for k in ("rgb", "depth", "mask_visib")}  # differ, largest, pixels
    for f in files if same_files else []:
        a, b = imread(cpu / f).astype(np.int64), imread(card / f).astype(np.int64)
        diff = np.abs(a - b) if a.ndim == 2 else np.abs(a - b).max(-1)
        o = off[f.parts[0]]
        o[0] += int((diff > 0).sum())
        o[1] = max(o[1], int(diff.max()))
        o[2] += diff.size
    largest = {k: (o[1] if same_files and o[2] else math.inf) for k, o in off.items()}
    errs = {"GT poses and cameras (mm)": (max(err("scene_gt.json", "cam_t_m2c"),
                                             err("scene_gt.json", "cam_R_m2c"),
                                             err("scene_camera.json", "cam_t_w2c"),
                                             err("scene_camera.json", "cam_K")), 0),
            "boxes (px)": (max(err("scene_gt_info.json", "bbox_visib"),
                               err("scene_gt_info.json", "bbox_obj")), 0),
            "visible fractions": (err("scene_gt_info.json", "visib_fract"), 0),
            "rgb (of 255)": (largest["rgb"], 0),
            "depth (mm)": (largest["depth"], 1),
            "masks (ids)": (largest["mask_visib"], 0)}
    return errs, {k: (o[0], o[2]) for k, o in off.items()}


def bop19_ar_timed(preds, scene_ds, mesh_db, n_frames: int, keep: bool = False):
    """compute_bop19_ar of preds over the first n_frames of scene_ds, VSD
    through BatchRenderer(mesh_db), with its time split. Returns (summary,
    {total, render, vsd, mssd_mspd}: seconds, the render calls [(label ids,
    poses, K, resolution, object pixels[, depth on the CPU])], and with keep
    the vsd calls' arguments). A render's time runs until its depth is on
    the host; the rest of the total is reading the frames."""
    from cosypose_tpu_torch.evaluation import bop_metrics as bm
    from cosypose_tpu_torch.rendering.scene_renderer import BatchRenderer

    renderer = BatchRenderer(mesh_db)
    times = dict(render=0.0, vsd=0.0, mssd_mspd=0.0)
    renders, vsds = [], []
    render = renderer.render

    def render_timed(label_ids, TCO, K, resolution=None, render_depth=False):
        t0 = time.perf_counter()
        out = render(label_ids, TCO, K, resolution=resolution, render_depth=render_depth)
        depth = out.depth.cpu()
        times["render"] += time.perf_counter() - t0
        renders.append((label_ids, TCO, K, resolution, int((depth > 0).sum()))
                       + ((depth,) if keep else ()))
        return out

    def timed(key, fn, calls=None):
        def run(*args):
            t0 = time.perf_counter()
            out = fn(*args)
            times[key] += time.perf_counter() - t0
            if calls is not None:
                calls.append(args)
            return out
        return run

    saved = {k: getattr(bm, k) for k in ("vsd", "mssd", "mspd")}
    renderer.render = render_timed
    bm.vsd = timed("vsd", saved["vsd"], vsds if keep else None)
    bm.mssd = timed("mssd_mspd", saved["mssd"])
    bm.mspd = timed("mssd_mspd", saved["mspd"])
    try:
        t0 = time.perf_counter()
        ar = bm.compute_bop19_ar(preds, scene_ds, mesh_db, renderer=renderer, n_frames=n_frames)
        times["total"] = time.perf_counter() - t0
    finally:
        for k, f in saved.items():
            setattr(bm, k, f)
    return ar, times, renders, vsds


def vsd_setup_args(mesh_db, label_ids, TCO, K, resolution):
    """The setup arguments of one BatchRenderer.render call, as it builds them."""
    import numpy as np
    import torch

    ids = torch.as_tensor(np.asarray(label_ids), dtype=torch.long, device=mesh_db.device)

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=mesh_db.device)

    return (mesh_db.tri_verts[ids], mesh_db.tri_valid[ids], f32(TCO), f32(K), tuple(resolution),
            mesh_db.tri_colors[ids])


def vsd_budget_drop(mesh_db, renders):
    """Over BatchRenderer calls: (object pixels drawn under its budget, those
    an unlimited budget draws, items with a tile listing more chunks than the
    budget, items)."""
    from cosypose_tpu_torch.ops import rasterizer_cuda as rc
    from cosypose_tpu_torch.rendering.scene_renderer import OBJECT_BUDGET, OBJECT_TILE

    kept = whole = over = items = 0
    for label_ids, TCO, K, res, n_px, *_ in renders:
        rows, _, order = rc.setup(*vsd_setup_args(mesh_db, label_ids, TCO, K, res))
        depth = rc.resolve(rows, order, tuple(res), OBJECT_TILE, rows.shape[1])[1]
        counts = rc.bin_chunks(rows, order, tuple(res), OBJECT_TILE, 1 << 30)[2]
        kept += n_px
        whole += int((depth > 0).sum())
        over += int((counts > rc.chunk_budget(OBJECT_BUDGET, rows.shape[1])).any(-1).sum())
        items += rows.shape[0]
    return kept, whole, over, items


def vsd_pixel_states(d_est, d_gt, d_scene, diameter):
    """What e_VSD counts at each pixel (bop_metrics.vsd's arithmetic): in the
    union of the visible masks (H, W), and matched within each τ (n_tau, H, W)."""
    import numpy as np

    from cosypose_tpu_torch.evaluation import bop_metrics as bm

    d_est, d_gt, d_scene = (np.asarray(d, np.float32) for d in (d_est, d_gt, d_scene))
    visib_gt = bm._visib_mask(d_scene, d_gt, bm.VSD_DELTA)
    visib_est = bm._visib_mask(d_scene, d_est, bm.VSD_DELTA) | ((d_est > 0) & visib_gt)
    diff = np.abs(d_gt - d_est)
    matched = (visib_gt & visib_est)[None] & (diff[None] <= bm.VSD_TAUS_REL[:, None, None]
                                              * diameter)
    return visib_gt | visib_est, matched


def evaluation_card_vs_cpu(preds, scene_ds, dbs: dict, n_frames: int):
    """compute_bop19_ar (VSD through BatchRenderer) of preds, and a
    PoseErrorMeter of each METER_TYPES of the GT poses with METER_NOISE, over
    the first n_frames of scene_ds, from the same poses with the mesh
    database on the card and on the CPU. Raises if a meter matches no pose on
    either side. Returns
    {quantity: |card - CPU|} (the metrics, the meter's summary and matched
    errors, the largest depth difference where both draw; inf where a value
    is nan on either side or the match sets differ) and {count: (n, out of)}:
    the meter's matches, render mask pixels, depth pixels beyond ATOL_KERNEL
    where both draw, and pixels whose place in e_VSD (union, matched at some
    τ) differs; then, to say where depth differs, both setups' rows through
    the card's sort and resolve: the items the two sort differently, and the
    depth pixels beyond ATOL_KERNEL at BatchRenderer's budget and at an
    unlimited one."""
    import numpy as np
    import torch

    from cosypose_tpu_torch.evaluation.data_utils import parse_obs_data
    from cosypose_tpu_torch.evaluation.meters import PoseErrorMeter
    from cosypose_tpu_torch.ops import rasterizer_cuda as rc
    from cosypose_tpu_torch.ops.transforms import add_pose_noise
    from cosypose_tpu_torch.rendering.scene_renderer import OBJECT_BUDGET, OBJECT_TILE
    from cosypose_tpu_torch.utils.tensor_collection import TensorCollection, concatenate

    gt = concatenate([parse_obs_data(scene_ds[i][2]) for i in range(n_frames)])
    frames = set(zip(gt.infos["scene_id"].tolist(), gt.infos["view_id"].tolist()))
    sub = preds[[i for i, k in enumerate(zip(preds.infos["scene_id"].tolist(),
                                             preds.infos["view_id"].tolist())) if k in frames]]
    near = TensorCollection({**{k: gt.infos[k] for k in ("scene_id", "view_id", "label")},
                             "score": np.ones(len(gt.infos["label"]))},
                            poses=add_pose_noise(gt.poses.cpu(), torch.Generator().manual_seed(0),
                                                 **METER_NOISE))
    runs = {}
    for d, db in dbs.items():
        ar, _, renders, vsds = bop19_ar_timed(sub, scene_ds, db, n_frames, keep=True)
        meters = {}
        for error_type in METER_TYPES:
            meter = PoseErrorMeter(db, error_type=error_type, report_AP=True,
                                   report_error_AUC=True, report_error_stats=True)
            meter.add(near, gt)
            summary, dfs = meter.summary()
            if not summary["n_matched"]:
                raise AssertionError(f"the {error_type} meter on the {d} matched no pose: "
                                     f"{summary}")
            meters[error_type] = (summary, dfs["matches"])
        runs[d] = (ar, meters, renders, vsds)
    (ar_k, met_k, ren_k, vsd_k), (ar_c, met_c, ren_c, vsd_c) = runs["cuda"], runs["cpu"]

    def diff(a, b):
        return math.inf if math.isnan(a) or math.isnan(b) else abs(a - b)

    errs = {f"BOP19 {k}": diff(ar_k[k], ar_c[k]) for k in ("AR", "AR_vsd", "AR_mssd", "AR_mspd",
                                                           "n_gt")}
    for error_type in METER_TYPES:
        (sum_k, m_k), (sum_c, m_c) = met_k[error_type], met_c[error_type]
        if list(sum_k) != list(sum_c):
            raise AssertionError(f"the {error_type} meter's summaries differ in keys: {sum_k}, "
                                 f"{sum_c}")
        errs.update({f"{error_type} {k}": diff(sum_k[k], sum_c[k]) for k in sum_c})
        same_matches = all(np.array_equal(m_k[k], m_c[k]) for k in (
            "scene_id", "view_id", "label", "pred_inst_id", "gt_inst_id"))
        errs[f"{error_type} matched errors (m)"] = (
            float(np.abs(m_k["norm"] - m_c["norm"]).max()) if same_matches else math.inf)
    depth_err, mask_px, depth_px, px = 0.0, 0, 0, 0
    for rk, rc_ in zip(ren_k, ren_c):
        dk, dc = rk[-1], rc_[-1]
        both = (dk > 0) & (dc > 0)
        if both.any():
            depth_err = max(depth_err, float((dk - dc)[both].abs().max()))
        depth_px += int(((dk - dc).abs() > ATOL_KERNEL)[both].sum())
        mask_px += int(((dk > 0) != (dc > 0)).sum())
        px += dk.numel()
    errs["largest depth difference where both draw (m)"] = depth_err
    vsd_px = union_px = 0
    for a, b in zip(vsd_k, vsd_c):
        (uk, mk), (uc, mc) = vsd_pixel_states(*a), vsd_pixel_states(*b)
        vsd_px += int(((uk != uc) | (mk != mc).any(0)).sum())
        union_px += int((uk | uc).sum())

    n_sorted, n_items, beyond = 0, 0, {"budget": 0, "unlimited": 0}
    for label_ids, TCO, K, res, *_ in ren_k:
        args = vsd_setup_args(dbs["cuda"], label_ids, TCO, K, res)
        rows_k, _, o_k = rc.setup(*args)
        rows_c, _, o_c = (x.to(rows_k.device) for x in rc.setup(
            *(a.cpu() if isinstance(a, torch.Tensor) else a for a in args)))
        n_sorted += int((o_k != o_c).any(1).sum())
        n_items += o_k.shape[0]
        for name, budget in (("budget", OBJECT_BUDGET), ("unlimited", rows_k.shape[1])):
            dk = rc.resolve(rows_k, o_k, tuple(res), OBJECT_TILE, budget)[1]
            dc = rc.resolve(rows_c, o_c, tuple(res), OBJECT_TILE, budget)[1]
            beyond[name] += int(((dk - dc).abs() > ATOL_KERNEL)[(dk > 0) & (dc > 0)].sum())
    counts = {**{f"{t} GT poses matched on the card": (met_k[t][0]["n_matched"],
                                                       met_k[t][0]["n_gt_valid"])
                 for t in METER_TYPES},
              "render mask pixels that differ": (mask_px, px),
              f"depth pixels beyond {ATOL_KERNEL} m where both draw": (depth_px, px),
              "VSD pixels that differ": (vsd_px, union_px),
              "render calls": (len(ren_k), len(ren_c)), "VSD pairs": (len(vsd_k), len(vsd_c)),
              "items the two setups sort differently": (n_sorted, n_items),
              f"depth pixels beyond {ATOL_KERNEL} m from the two setups' rows on the card, budget "
              f"{OBJECT_BUDGET}": (beyond["budget"], px),
              "the same, unlimited budget": (beyond["unlimited"], px)}
    return errs, counts


def icp_frame_inputs(ds, i, rng):
    """A recorded frame's GT objects as ICP's inputs: predictions at the GT
    poses moved by ICP_OFFSET plus seeded noise, the GT visible masks, the
    depth and K; with the GT poses and visible fractions."""
    import numpy as np
    import torch

    from cosypose_tpu_torch.utils.tensor_collection import TensorCollection

    _, mask, obs = ds[i]
    objs = obs["objects"]
    TCW = np.linalg.inv(obs["camera"]["TWC"])
    TCO = np.stack([TCW @ o["TWO"] for o in objs]).astype(np.float32)
    moved = TCO.copy()
    moved[:, :3, 3] += np.asarray(ICP_OFFSET) + rng.normal(0.0, ICP_NOISE, (len(objs), 3))
    preds = TensorCollection(dict(batch_im_id=np.zeros(len(objs), np.int64),
                                  label=np.asarray([o["label"] for o in objs]),
                                  score=np.ones(len(objs))), poses=torch.as_tensor(moved))
    return dict(preds=preds, masks=np.stack([mask == o["id_in_segm"] for o in objs]),
                depth=obs["camera"]["depth"][None], K=obs["camera"]["K"][None], TCO=TCO,
                visib=np.asarray([o["visib_fract"] for o in objs]))


def write_cube_ply(path: pathlib.Path, size_mm: float) -> None:
    """An axis-aligned cube of side size_mm, ASCII PLY, 12 triangles."""
    s = size_mm / 2
    verts = [(x, y, z) for x in (-s, s) for y in (-s, s) for z in (-s, s)]
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3)]
    tris = [t for a, b, c, d in quads for t in ((a, b, c), (a, c, d))]
    lines = ["ply", "format ascii 1.0", f"element vertex {len(verts)}", "property float x",
             "property float y", "property float z", f"element face {len(tris)}",
             "property list uchar int vertex_indices", "end_header"]
    lines += [f"{x} {y} {z}" for x, y, z in verts] + [f"3 {a} {b} {c}" for a, b, c in tris]
    path.write_text("\n".join(lines) + "\n")


def write_scenario(root: pathlib.Path, candidates, cameras, n_labels: int) -> None:
    """run_custom_scenario's inputs for a bench_multiview scene:
    candidates.csv, scene_camera.json (K, world-to-camera poses) and models/
    (bench_multiview.cube_specs' cubes as BOP models)."""
    import numpy as np

    from cosypose_tpu_torch.evaluation.bop_export import predictions_to_bop_csv

    (root / "models").mkdir(parents=True)
    predictions_to_bop_csv(candidates, root / "candidates.csv")
    cams = {}
    for v, (K, TWC) in enumerate(zip(cameras.K.numpy(), cameras.TWC.numpy())):
        TCW = np.linalg.inv(TWC.astype(np.float64))
        cams[str(v)] = dict(cam_K=K.reshape(-1).tolist(),
                            cam_R_w2c=TCW[:3, :3].reshape(-1).tolist(),
                            cam_t_w2c=(TCW[:3, 3] * 1000).tolist())
    (root / "scene_camera.json").write_text(json.dumps(cams))
    infos = {}
    for i in range(n_labels):
        side = 2 * (20.0 + 8.0 * i)   # bench_multiview.cube_specs: half-size 2 cm + 8 mm a label
        write_cube_ply(root / "models" / f"obj_{i:06d}.ply", side)
        infos[str(i)] = dict(diameter=side * 3 ** 0.5)
    (root / "models" / "models_info.json").write_text(json.dumps(infos))


def noisy_gt_csv(ds, path: pathlib.Path, rng) -> list:
    """A BOP CSV of the GT poses (MV_NOISE_T, MV_NOISE_DEG noise) of the
    objects visible at MV_VISIB_MIN or more, in the view groups of MV_NVIEWS
    frames (MultiViewWrapper's) in which some pair of views shares at least
    MV_SHARED_MIN of them. Returns the kept groups' ids."""
    import itertools

    import numpy as np
    import torch
    from scipy.spatial.transform import Rotation

    from cosypose_tpu_torch.data.wrappers import MultiViewWrapper
    from cosypose_tpu_torch.evaluation.bop_export import predictions_to_bop_csv
    from cosypose_tpu_torch.utils.tensor_collection import TensorCollection

    kept, rows, poses = [], [], []
    for g in MultiViewWrapper(ds, MV_NVIEWS).groups:
        frames = [ds[int(i)][2] for i in g["ds_ids"]]
        seen = [[o for o in f["objects"] if o["visib_fract"] >= MV_VISIB_MIN] for f in frames]

        def shared(a, b):  # the same object: its world pose within 5 mm, the same label
            return sum(any(p["label"] == q["label"] and np.linalg.norm(
                p["TWO"][:3, 3] - q["TWO"][:3, 3]) < 5e-3 for q in b) for p in a)

        if len(frames) < 2 or max(shared(a, b) for a, b in itertools.combinations(seen, 2)) \
                < MV_SHARED_MIN:
            continue
        kept.append(g["group_id"])
        for f, objs in zip(frames, seen):
            TCW = np.linalg.inv(f["camera"]["TWC"])
            for o in objs:
                T = TCW @ o["TWO"]
                T[:3, :3] = T[:3, :3] @ Rotation.from_euler(
                    "xyz", rng.normal(0, MV_NOISE_DEG, 3), degrees=True).as_matrix()
                T[:3, 3] += rng.normal(0, MV_NOISE_T, 3)
                poses.append(T)
                rows.append((f["frame_info"]["scene_id"], f["frame_info"]["view_id"], o["label"]))
    infos = dict(scene_id=np.asarray([r[0] for r in rows]),
                 view_id=np.asarray([r[1] for r in rows]),
                 label=np.asarray([r[2] for r in rows]), score=np.ones(len(rows)))
    predictions_to_bop_csv(TensorCollection(infos, poses=torch.as_tensor(np.stack(poses))), path)
    return kept


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    t_main = time.perf_counter()
    from cosypose_tpu_torch import demo
    from cosypose_tpu_torch.integrated.pose_predictor import (CoarseRefinePosePredictor,
                                                              LoadedPoseModel)
    from cosypose_tpu_torch.models.pose_predictor import (PosePredictor, PosePredictorConfig,
                                                          gather_mesh_data)
    from cosypose_tpu_torch.ops import depthwise_cuda as dwc
    from cosypose_tpu_torch.ops import nvcc_build
    from cosypose_tpu_torch.ops import rasterizer_cuda as rc
    from cosypose_tpu_torch.ops.camera import boxes_from_uv, project_points
    from cosypose_tpu_torch.ops.mesh_db import build_mesh_db
    from cosypose_tpu_torch.ops.raster_bounds import resolve_bound, setup_bound
    from cosypose_tpu_torch.ops.rasterizer import camera_corners
    from cosypose_tpu_torch.ops.render import render
    from cosypose_tpu_torch.utils.card import card_identity
    from cosypose_tpu_torch.utils.tensor_collection import TensorCollection

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_identity()
    tag = f"[{card}]"
    kernel, dw_kernel = rc.RASTER_KERNEL, dwc.DW_KERNEL
    dw_launches = {}  # the depthwise kernel's launches on each path that runs an eval B3

    # -- 1. device and build ------------------------------------------------
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}, nvidia-smi: {card}")
    t0 = time.perf_counter()
    libs = nvcc_build.build_libraries()
    built = ", ".join(f"{nvcc_build.SOURCES[n].name} -> {p.name}" for n, (p, _) in libs.items())
    log(f"{tag} build: {built}"
        f" in {time.perf_counter() - t0:.2f} s (parallel nvcc)")
    for name, (_, report) in libs.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  ptxas {name}: {line.strip()}")
    kernel.load()

    # -- 2. the raster path at the main path's shapes --------------------------
    db = build_mesh_db(demo.demo_specs(), render_max_faces=LOD, device=dev)
    K = torch.as_tensor(demo.make_inputs(BATCH, *IMAGE)[1], device=dev)
    first = demo.first_render_inputs(BATCH, IMAGE, RENDER, LOD, dev)
    TCO = first["TCO"]
    cfg = PosePredictorConfig()
    tile, budget = cfg.raster_tile, cfg.raster_max_tris_per_tile
    rows_json = {}
    checked = {name: [] for name in SOURCES}  # shapes each kernel was held to its plain version at

    # a card render is two launches: the kernels of one render() call, read
    # from a short trace while the profiler still sees the card (PERF.md §7)
    args = (first["tri_verts"], first["tri_valid"], TCO, first["K_crop"], RENDER, first["colors"])
    names = render_kernel_names(lambda: render(*args[:4], image_size=RENDER, colors=args[5],
                                               tile=tile, max_tris_per_tile=budget))
    n_setup = sum("raster_setup_kernel" in n for n in names)
    n_resolve = sum("raster_resolve_kernel" in n for n in names)
    sorts = [n for n in names if "sort" in n.lower()]
    log(f"{tag} one render() call launches {len(names)} device kernels: raster_setup {n_setup}, "
        f"raster_resolve {n_resolve}, sort kernels {len(sorts)}; the others "
        f"{sorted({n[:60] for n in names if 'raster_' not in n})} (the mask, depth > 0)")
    if (n_setup, n_resolve) != (1, 1) or sorts:
        raise AssertionError(f"a render call launched {names}: want one raster_setup, one "
                             f"raster_resolve and no sort kernel")

    # kernel A (rows, keys and the y-order) against setup_plain and torch.sort
    rows, key, order, key_p, err, abs_err = setup_vs_plain(args)
    checked["raster_setup"].append(f"main path: {rows.shape[0]} x {rows.shape[1]} rows, {RENDER}")
    both = rows[..., rc.LANE_VALID] != 0
    order_differs = int((order != rc.sort_order(key_p)).any(1).sum())
    ms_a, ev_a = device_ms(lambda: rc.setup(*args)), time_cuda_ms(lambda: rc.setup(*args), 50)
    plain_a = time_cuda_ms(lambda: rc.sort_order(rc.setup_plain(*args)[1]), 10)
    ms_sort = device_ms(lambda: torch.sort(key, dim=1, stable=True))
    ev_sort = time_cuda_ms(lambda: torch.sort(key, dim=1, stable=True), 50)
    bound_a, by_a, bytes_a = setup_bound(first["tri_verts"], first["tri_valid"], first["colors"],
                                         None, rows, key)
    log(f"{tag} raster_setup: rows {tuple(rows.shape)}, {int(both.sum())} valid; vs plain: "
        f"plane rel err {err['plane']:.3g}, bbox/key rel err {err['bbox_key']:.3g} "
        f"(<= {rc.SETUP_TOL}), max abs err {abs_err:.3g}, validity equal, order equal to "
        f"torch.sort's, {order_differs} items ordered differently from the plain keys; kernel "
        f"(rows, keys and order) {ms_a:.4f} ms on the device ({ev_a:.4f} ms per call by events, "
        f"{100 * bound_a / ms_a:.1f} % of bound), plain (setup_plain + sort_order) {plain_a:.3f} "
        f"ms, bound {bound_a:.4f} ms by {by_a} ({bytes_a / 1e6:.2f} MB); torch.sort of the keys "
        f"alone {ms_sort:.4f} ms on the device ({ev_sort:.4f} ms by events; not called by the "
        f"port); library_ms: none")
    rows_json["raster_setup"] = dict(max_abs_err=abs_err, ms=ms_a, plain_ms=plain_a,
                                     bound_ms=bound_a, bound_by=by_a, torch_sort_ms=ms_sort)

    def check(name, rows, order, tile, budget, with_attr, time_it):
        """Kernel B against resolve_plain_binned on the same sorted rows."""
        out_k = kernel.resolve(rows, order, RENDER, tile, budget, with_attr)
        torch.cuda.synchronize()
        out_p = rc.resolve_plain_binned(rows, order, RENDER, tile, budget, with_attr)
        e = max(float((out_k[0] - out_p[0]).abs().max()), float((out_k[1] - out_p[1]).abs().max()))
        if e > ATOL_KERNEL or not torch.equal(out_k[1] > 0, out_p[1] > 0):
            raise AssertionError(f"{name}: kernel vs plain max err {e}, or masks differ")
        if with_attr and not torch.equal(out_k[2], out_p[2]):
            raise AssertionError(f"{name}: attribute differs")
        checked["raster_resolve_attr" if with_attr else "raster_resolve"].append(
            f"{name}: {rows.shape[0]} x {rows.shape[1]} rows, {RENDER}, tile {tile}, "
            f"budget {budget}")
        counts = rc.bin_chunks(rows, order, RENDER, tile, budget)[2]
        b_ms, by, visits, n_bytes = resolve_bound(rows, order, RENDER, tile, budget, with_attr)
        listed, kept = cull_counts(rows, order, RENDER, tile, budget)
        row = dict(max_abs_err=e, bound_ms=b_ms, bound_by=by)
        msg = (f"{tag} {name}, tile {tile}, budget {budget}: max_abs_err {e:.3g} "
               f"(<= {ATOL_KERNEL}), masks equal, coverage {float((out_k[1] > 0).float().mean()):.3f}, "
               f"max chunks/tile {int(counts.max())}, bound {b_ms:.4f} ms by {by} "
               f"({visits:.4g} visits, {n_bytes / 1e6:.1f} MB); the cull keeps {kept} of {listed} "
               f"listed (row, warp) pairs")
        if time_it:
            row["ms"] = device_ms(lambda: kernel.resolve(rows, order, RENDER, tile, budget,
                                                         with_attr))
            ev = time_cuda_ms(lambda: kernel.resolve(rows, order, RENDER, tile, budget, with_attr),
                              50)
            row["plain_ms"] = time_cuda_ms(
                lambda: rc.resolve_plain_binned(rows, order, RENDER, tile, budget, with_attr),
                2, warmup=1)
            msg += (f"; kernel {row['ms']:.4f} ms on the device ({ev:.4f} ms by events; "
                    f"{100 * b_ms / row['ms']:.1f} % of bound), "
                    f"plain {row['plain_ms']:.2f} ms, library_ms: none")
        log(msg)
        return row

    rows_json["raster_resolve"] = check("raster_resolve", rows, order, tile, budget, False, True)
    small = check("raster_resolve", rows, order, tile, 40, False, False)
    rows_json["raster_resolve"]["max_abs_err"] = max(rows_json["raster_resolve"]["max_abs_err"],
                                                     small["max_abs_err"])
    # PR 1's bound counted every pixel of a tile for every listed row
    pr1_visits = float((rc.bin_chunks(rows, order, RENDER, tile, budget)[2].double() * 8).sum()
                       * tile[0] * tile[1])
    log(f"{tag} PR 1's bound would count {pr1_visits:.4g} visits here; PR 1's kernel at 0.2628 ms "
        f"is {100 * rows_json['raster_resolve']['bound_ms'] / 0.2628:.1f} % of the recounted bound")

    # sorted rows gathered first, then read in order, against reading through the permutation
    ident = torch.arange(rows.shape[1], device=dev).expand_as(order).contiguous()
    ms_gather = device_ms(lambda: kernel.resolve(
        torch.gather(rows, 1, order[..., None].expand(-1, -1, rc.ROW)), ident, RENDER, tile,
        budget))
    ms_call = time_cuda_ms(lambda: render(*args[:4], image_size=RENDER, colors=args[5], tile=tile,
                                          max_tris_per_tile=budget), 50)
    log(f"{tag} per call, device time: setup (with the sort) {ms_a:.4f} + resolve "
        f"{rows_json['raster_resolve']['ms']:.4f} ms; whole render() by events {ms_call:.4f} ms "
        f"(gather + resolve in sorted order instead: {ms_gather:.4f} ms on the device vs "
        f"{rows_json['raster_resolve']['ms']:.4f} ms through the permutation); {PR1}")

    # two instances per item, the second behind and to the side: the attr variant
    tv_cam = camera_corners(first["tri_verts"], TCO)
    shift = torch.tensor([0.03, 0.01, 0.05], device=dev)
    n_f = tv_cam.shape[1]
    attr = torch.cat([torch.ones(BATCH, n_f), torch.full((BATCH, n_f), 2.0)], 1).to(dev)
    rows2, _, order2 = rc.setup(torch.cat([tv_cam, tv_cam + shift], 1),
                           torch.cat([first["tri_valid"]] * 2, 1),
                           torch.eye(4, device=dev).expand(BATCH, 4, 4), first["K_crop"], RENDER,
                           torch.cat([first["colors"]] * 2, 1), tri_attr=attr)
    rows_json["raster_resolve_attr"] = check("raster_resolve_attr (two instances)", rows2,
                                             order2, tile, budget, True, True)

    for t in TILES:
        r = check("raster_resolve sweep", rows, order, t, budget, False, False)
        ms_b = device_ms(lambda: kernel.resolve(rows, order, RENDER, t, budget))
        ms_r = time_cuda_ms(lambda: render(*args[:4], image_size=RENDER, colors=args[5], tile=t,
                                           max_tris_per_tile=budget), 20)
        log(f"{tag} tile {t}: resolve {ms_b:.4f} ms on the device (bound {r['bound_ms']:.4f} ms), "
            f"whole render() {ms_r:.4f} ms")

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
        dw_kernel.launches = 0
        outs[d] = {k: v.cpu() for k, v in pp.forward(md_d, *a, n_iterations=2).items()}
        log(f"slice B3 fp32 B={B} n=2 on {d}: {time.perf_counter() - t0:.2f} s (first call)")
    dw_launches["slice"] = dw_kernel.launches  # the card's forward: 2 eval B3 calls
    errs = {k: float((outs["cuda"][k] - outs["cpu"][k]).abs().max()) for k in outs["cpu"]}
    moved = float((outs["cpu"]["TCO_final"] - torch.as_tensor(TCO4)).abs().max())
    log(f"{tag} slice card vs CPU max abs err: " + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
        + f"; TCO_final moved {moved:.3g} from the init")
    if not errs["TCO_final"] <= ATOL_SLICE or moved <= 1e-4 \
            or dw_launches["slice"] != 2 * B3_BLOCKS:
        raise AssertionError(f"slice: TCO_final err {errs['TCO_final']} > {ATOL_SLICE} "
                             f"or poses did not move ({moved}) or dw_bn_silu_squeeze launched "
                             f"{dw_launches['slice']} times (want {2 * B3_BLOCKS})")

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
    dw_kernel.launches = 0
    results = [serve(r) for r in reqs]
    launches = dict(kernel.launches)
    dw_launches["serving"] = dw_kernel.launches
    expected = len(reqs) * (N_COARSE + N_REFINER) * chunks
    if launches["raster_setup"] != expected or launches["raster_resolve"] != expected \
            or dw_launches["serving"] != B3_BLOCKS * expected:
        raise AssertionError(f"serving launched the kernels {launches} times, want {expected} "
                             f"of raster_setup and of raster_resolve, and dw_bn_silu_squeeze "
                             f"{dw_launches['serving']} times, want {B3_BLOCKS * expected}")
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
    log(f"{tag} kernel launches while serving: {launches} (want {expected} of raster_setup and "
        f"of raster_resolve), dw_bn_silu_squeeze {dw_launches['serving']} (want "
        f"{B3_BLOCKS} x {expected} B3 calls)")

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
    raster = sum(v for k, v in dev_us.items() if "raster_" in k) / 1e3
    sort = sum(v for k, v in dev_us.items() if "sort" in k.lower()) / 1e3
    conv = sum(v for k, v in dev_us.items() if "conv" in k.lower() or "cudnn" in k.lower()
               or "xmma" in k or "sm90" in k) / 1e3
    log(f"{tag} profiled request: wall {1e3 * lat:.1f} ms, device busy {busy:.1f} ms "
        f"(idle share {1 - busy / (1e3 * lat):.3f}), raster kernels {raster:.3f} ms, "
        f"sort-named kernels {sort:.3f} ms, "
        f"conv/GEMM-named kernels {conv:.1f} ms; top kernels:")
    for k, v in sorted(dev_us.items(), key=lambda kv: -kv[1])[:8]:
        log(f"    {v / 1e3:9.2f} ms  {k[:90]}")

    # -- 5. training -----------------------------------------------------------
    from cosypose_tpu_torch.training import pose_training as tpt
    from cosypose_tpu_torch.training.configs import make_cfg
    from cosypose_tpu_torch.training.train_pose import collate, train_pose

    t0 = time.perf_counter()
    errs = train_step_card_vs_cpu()
    log(f"{tag} train step, card vs CPU (B0, {SMALL_RENDER[0]}x{SMALL_RENDER[1]}, batch "
        f"{SMALL_B}, 2 iterations, {time.perf_counter() - t0:.1f} s): " +
        ", ".join(f"{k} {e:.3g} (<= {tol})" for k, (e, tol) in errs.items()))
    bad = {k: v for k, v in errs.items() if not v[0] <= v[1]}
    if bad:
        raise AssertionError(f"train step card vs CPU beyond tolerance: {bad}")

    run = make_cfg("tless-refiner")
    tcfg = run.train
    B, n_it = tcfg.batch_size, tcfg.n_iterations
    t0 = time.perf_counter()
    data = {"train": [(demo.DemoPoseDataset(B * (TRAIN_STEPS + 1), TRAIN_IMAGE, seed=0), 1)]}
    log(f"training data: {B * (TRAIN_STEPS + 1)} demo items of {TRAIN_IMAGE[0]}x{TRAIN_IMAGE[1]} "
        f"made in {time.perf_counter() - t0:.1f} s; config tless-refiner: {tcfg.predictor.backbone}"
        f", render {tcfg.predictor.render_size}, {tcfg.predictor.compute_dtype}, remat "
        f"{tcfg.predictor.remat}, {n_it} iterations, batch {B}, {tcfg.input_generator}, "
        f"n_points_loss {tcfg.n_points_loss}, lr {tcfg.lr}, clip {tcfg.clip_grad_norm}")
    exp_dir = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_train_", dir=OUT_DIR))

    def trainer(n_epochs, epoch_size, resume):
        cfg = dataclasses.replace(run, n_dataloader_workers=0, train=dataclasses.replace(
            tcfg, n_epochs=n_epochs, epoch_size=epoch_size))
        t0 = time.perf_counter()
        state, run_dir = train_pose(cfg, data, db, resume=resume, exp_dir=exp_dir, device=dev)
        torch.cuda.synchronize()
        return state, run_dir, time.perf_counter() - t0

    warm, run_dir, t_warm = trainer(1, B, False)  # one step: cuDNN plans, allocator
    back, _, _ = trainer(1, B, True)                # resumes at the end: nothing to run
    sd_w, sd_b = warm.pp.net.state_dict(), back.pp.net.state_dict()
    same = back.step == warm.step == 1 and all(torch.equal(sd_w[k], sd_b[k]) for k in sd_w)
    for p, q in zip(warm.pp.net.parameters(), back.pp.net.parameters()):
        same &= all(torch.equal(warm.optimizer.state[p][k], back.optimizer.state[q][k])
                    for k in ("exp_avg", "exp_avg_sq", "step"))
    if not same:
        raise AssertionError("checkpoint resume did not restore step, parameters, running "
                             "statistics and Adam moments")
    log(f"{tag} warm-up step {t_warm:.1f} s (with set-up); checkpoint save -> resume restores "
        f"step, parameters, running statistics and Adam moments exactly")
    before = {n: p.detach().clone() for n, p in warm.pp.net.named_parameters()}
    del warm, back

    kernel.launches = {k: 0 for k in kernel.launches}
    trained, _, t_run = trainer(2, B * TRAIN_STEPS, True)
    launches_train = dict(kernel.launches)
    want = TRAIN_STEPS * n_it
    if launches_train["raster_setup"] != want or launches_train["raster_resolve"] != want:
        raise AssertionError(f"training launched the kernels {launches_train} times, want {want}"
                             f" of raster_setup and of raster_resolve")
    rec = [json.loads(line) for line in (run_dir / "log.txt").read_text().splitlines()][-1]
    moved = max(float((p.detach() - before[n]).abs().max())
                for n, p in trained.pp.net.named_parameters())
    losses = [rec[k] for k in rec if k.startswith("train/loss")]
    if trained.step != 1 + TRAIN_STEPS or not all(math.isfinite(v) for v in losses) \
            or moved <= 0:
        raise AssertionError(f"trainer: step {trained.step}, losses {losses}, moved {moved}")
    step_s = rec["train/step_s_per_step"]
    log(f"{tag} trainer: {TRAIN_STEPS} steps of tless-refiner in {t_run:.1f} s with set-up; "
        f"{1e3 * step_s:.1f} ms/step, {B / step_s:.1f} samples/s, {B * n_it / step_s:.1f} "
        f"crop-iterations/s (data wait {1e3 * rec['train/data_s_per_step']:.1f} ms/step); loss "
        f"{rec['train/loss_total']:.4f}, grad_norm {rec['train/grad_norm']:.3f}, parameters moved "
        f"up to {moved:.3g}; kernel launches {launches_train} (want {want} of raster_setup and "
        f"of raster_resolve)")

    # peak memory and step time with remat on and off, a step on its own
    items = data["train"][0][0]
    host = collate([items[i] for i in range(B)])
    batch = {k: host[k].to(dev) for k in ("images", "K", "TCO", "bboxes")}
    batch["label_ids"] = db.ids_for(host["labels"])
    gen = torch.Generator().manual_seed(5)
    del trained
    for remat in (True, False):
        cfg_r = dataclasses.replace(tcfg, predictor=dataclasses.replace(tcfg.predictor,
                                                                       remat=remat))
        state = tpt.create_train_state(cfg_r, dev)
        step = tpt.make_train_step(cfg_r, db)
        step(state, batch, tpt.draw_step(cfg_r, state.pp, B, db.points.shape[1], gen))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        step(state, batch, tpt.draw_step(cfg_r, state.pp, B, db.points.shape[1], gen))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        log(f"{tag} remat {remat}: peak max_memory_allocated {peak / 2**30:.2f} GiB "
            f"({(peak - base) / 2**30:.2f} GiB above the {base / 2**30:.2f} GiB held between "
            f"steps), step {1e3 * dt:.1f} ms")
        if remat == tcfg.predictor.remat:  # the config's own: split and profiled below
            kept = state
        else:
            del state
    torch.cuda.empty_cache()

    # one step split by CUDA events, then one profiled step
    state = kept
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]

    def split_step():
        draws = tpt.draw_step(tcfg, state.pp, B, db.points.shape[1], gen)
        state.optimizer.zero_grad(set_to_none=True)
        ev[0].record()
        loss, _ = tpt.pose_loss(state.pp, tcfg, db, batch, draws)
        ev[1].record()
        loss.backward()
        ev[2].record()
        tpt.apply_gradients(state, tcfg)
        ev[3].record()
        torch.cuda.synchronize()
        return [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]

    split_step()  # the first step after empty_cache() allocates afresh
    fwd, bwd, opt = split_step()
    log(f"{tag} one step (remat {tcfg.predictor.remat}) by CUDA events on the stream: forward + "
        f"loss {fwd:.1f} ms, backward {bwd:.1f} ms, clip + Adam {opt:.1f} ms")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        span = sum(split_step())  # the step's span on the stream, by its events
    events = prof.key_averages()
    (OUT_DIR / "chip_smoke_train_profile.txt").write_text(
        f"{card}\n{events.table(sort_by='self_cuda_time_total', row_limit=50)}\n")
    dev_us = {e.key: getattr(e, attr) for e in events if e.device_type == DeviceType.CUDA}
    busy = sum(dev_us.values()) / 1e3
    raster = sum(v for k, v in dev_us.items() if "raster_" in k) / 1e3
    n_kernels = sum(e.count for e in events if e.device_type == DeviceType.CUDA)
    log(f"{tag} profiled step: span on the stream {span:.1f} ms, device busy {busy:.1f} ms (busy "
        f"share {busy / span:.3f}) in {n_kernels} kernels, raster kernels {raster:.3f} ms "
        f"({100 * raster / busy:.2f} % of busy); top kernels:")
    for k, v in sorted(dev_us.items(), key=lambda kv: -kv[1])[:10]:
        log(f"    {v / 1e3:9.2f} ms  {k[:90]}")

    del state, kept
    torch.cuda.empty_cache()
    log(f"profiler_device_events() after phase 5: {profiler_device_events()}")
    log(f"phases 1-5 done at {time.perf_counter() - t_main:.0f} s")

    # -- 6. recording and data ----------------------------------------------------
    import shutil

    import numpy as np

    from cosypose_tpu_torch.data.datasets_cfg import make_object_dataset, make_scene_dataset
    from cosypose_tpu_torch.data.pose_dataset import PoseDataset
    from cosypose_tpu_torch.rendering.scene_renderer import SCENE_BUDGET, SCENE_TILE
    from cosypose_tpu_torch.recording import record_dataset
    from cosypose_tpu_torch.scripts.run_dataset_recording import CONFIGS, _make_sampler

    # the setup kernel on the scene soup, then the attribute kernel at the
    # scene shape against its plain version on the CPU
    args_s, ids_s = scene_inputs(dev)
    rows_s, key_s, order_s, _, err_s, abs_s = setup_vs_plain(args_s, ids_s)
    checked["raster_setup"].append(f"scene soup: {rows_s.shape[0]} x {rows_s.shape[1]} rows")
    res_s = args_s[4]
    t_ss = setup_timing(args_s, key_s, ids_s)
    b_ss, by_ss = setup_bound(args_s[0], args_s[1], args_s[5], ids_s, rows_s, key_s)[:2]
    log(f"{tag} raster_setup at the scene soup ({SCENE_CAMERAS} cameras x {rows_s.shape[1]} rows):"
        f" vs plain: plane rel err {err_s['plane']:.3g}, bbox/key rel err {err_s['bbox_key']:.3g} "
        f"(<= {rc.SETUP_TOL}), max abs err {abs_s:.3g}, validity and instance ids equal, order "
        f"equal to torch.sort's; CUDA events behind a spin kernel: "
        f"{setup_timing_text(t_ss, b_ss, by_ss)}")
    Fp_s = rows_s.shape[1]
    budget_s = min(Fp_s, SCENE_BUDGET)
    out_k = kernel.resolve(rows_s, order_s, res_s, SCENE_TILE, budget_s, True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_p = rc.resolve_plain_binned(rows_s.cpu(), order_s.cpu(), res_s, SCENE_TILE, budget_s,
                                    True)
    cpu_plain_s = time.perf_counter() - t0
    same = all(torch.equal(k.cpu(), p) for k, p in zip(out_k, out_p))
    e_s = max(float((k.cpu() - p).abs().max()) for k, p in zip(out_k, out_p))
    if not same or Fp_s < 8872:
        raise AssertionError(f"raster_resolve_attr at the scene shape ({Fp_s} rows): kernel vs "
                             f"plain max err {e_s}, not equal")
    checked["raster_resolve_attr"].append(f"scene: {SCENE_CAMERAS} x {Fp_s} rows, {res_s}, tile "
                                          f"{SCENE_TILE}, budget {budget_s}")
    counts_s = rc.bin_chunks(rows_s, order_s, res_s, SCENE_TILE, 1 << 30)[2]
    b_s, by_s, visits_s, bytes_s = resolve_bound(rows_s, order_s, res_s, SCENE_TILE, budget_s,
                                                 True)
    ms_s = device_ms(lambda: kernel.resolve(rows_s, order_s, res_s, SCENE_TILE, budget_s, True))
    plain_s = time_cuda_ms(lambda: rc.resolve_plain_binned(rows_s, order_s, res_s, SCENE_TILE,
                                                           budget_s, True), 1, warmup=1)
    log(f"{tag} raster_resolve_attr at the scene shape ({SCENE_CAMERAS} cameras x {Fp_s} rows "
        f"of {SCENE_OBJECTS} procedural objects and the cage, {res_s[0]}x{res_s[1]}, tile "
        f"{SCENE_TILE}, budget {budget_s}; a window of kernel B holds {kernel.window_rows(dev)} "
        f"rows): "
        f"equal to the plain version on the CPU (rgb, depth, attr; {cpu_plain_s:.1f} s there); "
        f"most chunks a tile lists {int(counts_s.max())} of {rc.chunk_budget(budget_s, Fp_s)}; "
        f"kernel {ms_s:.4f} ms on the device, bound {b_s:.4f} ms by {by_s} ({visits_s:.4g} "
        f"visits, {bytes_s / 1e6:.1f} MB; {100 * b_s / ms_s:.1f} % of bound), plain on the card "
        f"{plain_s:.1f} ms, library_ms: none")
    rows_json["raster_resolve_attr"] = dict(max_abs_err=e_s, ms=ms_s, plain_ms=plain_s,
                                            bound_ms=b_s, bound_by=by_s)
    del rows_s, order_s, out_k, out_p

    # the config's own largest scene: CONFIGS["procedural"] draws 3-7 objects
    n_max = CONFIGS["procedural"]["sampler_kwargs"]["n_objects_interval"][1] - 1
    rows_7, order_7, _ = procedural_scene(dev, n_objects=n_max)
    budget_7 = min(rows_7.shape[1], SCENE_BUDGET)
    out_k = kernel.resolve(rows_7, order_7, res_s, SCENE_TILE, budget_7, True)
    torch.cuda.synchronize()
    out_p = rc.resolve_plain_binned(rows_7, order_7, res_s, SCENE_TILE, budget_7, True)
    if not all(torch.equal(k, p) for k, p in zip(out_k, out_p)):
        raise AssertionError(f"raster_resolve_attr at a {n_max}-object scene: kernel vs plain "
                             f"not equal")
    checked["raster_resolve_attr"].append(f"{n_max}-object scene: {rows_7.shape[0]} x "
                                          f"{rows_7.shape[1]} rows, budget {budget_7}")
    ms_7 = device_ms(lambda: kernel.resolve(rows_7, order_7, res_s, SCENE_TILE, budget_7, True))
    b_7, by_7 = resolve_bound(rows_7, order_7, res_s, SCENE_TILE, budget_7, True)[:2]
    log(f"{tag} raster_resolve_attr at a {n_max}-object scene (the config's largest; "
        f"{SCENE_CAMERAS} cameras x {rows_7.shape[1]} rows): equal to the plain version on the "
        f"card; kernel {ms_7:.4f} ms on the device, bound {b_7:.4f} ms by {by_7} "
        f"({100 * b_7 / ms_7:.1f} % of bound)")
    del rows_7, order_7, out_k, out_p

    # the plain resolve at the amodal re-render's shape, as the sampler builds it
    args_a, tile_a, budget_a = amodal_inputs(dev)
    rows_a, key_a, order_a, _, err_a, abs_a = setup_vs_plain(args_a)
    checked["raster_setup"].append(f"amodal: {rows_a.shape[0]} x {rows_a.shape[1]} rows")
    res_a = args_a[4]
    out_k = kernel.resolve(rows_a, order_a, res_a, tile_a, budget_a, False)
    torch.cuda.synchronize()
    out_p = rc.resolve_plain_binned(rows_a, order_a, res_a, tile_a, budget_a, False)
    if not all(torch.equal(k, p) for k, p in zip(out_k[:2], out_p[:2])):
        raise AssertionError("raster_resolve at the amodal shape: kernel vs plain not equal")
    checked["raster_resolve"].append(f"amodal: {rows_a.shape[0]} x {rows_a.shape[1]} rows, "
                                     f"{res_a}, tile {tile_a}, budget {budget_a}")
    ms_a6 = device_ms(lambda: kernel.resolve(rows_a, order_a, res_a, tile_a, budget_a, False))
    b_a6, by_a6 = resolve_bound(rows_a, order_a, res_a, tile_a, budget_a, False)[:2]
    counts_a = rc.bin_chunks(rows_a, order_a, res_a, tile_a, 1 << 30)[2]
    # what the budget drops: the same rows with every chunk of a tile listed
    whole = kernel.resolve(rows_a, order_a, res_a, tile_a, rows_a.shape[1], False)[1] > 0
    kept_px, whole_px = int((out_k[1] > 0).sum()), int(whole.sum())
    over = int((counts_a > rc.chunk_budget(budget_a, rows_a.shape[1])).any(-1).sum())
    log(f"{tag} amodal re-render: the budget keeps {kept_px} of the {whole_px} object pixels "
        f"an unlimited one renders; {over} of {rows_a.shape[0]} items have a tile beyond it (the "
        f"JAX package's accelerator tile and budget)")
    log(f"{tag} amodal re-render ({rows_a.shape[0]} items x {rows_a.shape[1]} rows, "
        f"{res_a[0]}x{res_a[1]}, tile {tile_a}, budget {budget_a}): raster_setup vs plain plane "
        f"rel err {err_a['plane']:.3g}, bbox/key {err_a['bbox_key']:.3g} (<= {rc.SETUP_TOL}), "
        f"max abs err {abs_a:.3g}; raster_resolve equal to the plain version on the card (rgb, "
        f"depth); most chunks a tile lists {int(counts_a.max())} of "
        f"{rc.chunk_budget(budget_a, rows_a.shape[1])}; kernel {ms_a6:.4f} ms on the device, "
        f"bound {b_a6:.4f} ms by {by_a6} ({100 * b_a6 / ms_a6:.1f} % of bound)")
    del rows_a, order_a, out_k, out_p
    log(f"profiler_device_events() after phase 6's kernel checks: {profiler_device_events()}")

    # recording: CONFIGS["procedural"], then "procedural-canon"
    shutil.rmtree(DATA_ROOT, ignore_errors=True)
    produced = []

    def recorder(name):
        sampler = _make_sampler(name, device=dev)
        sample = sampler.sample_scene_frames

        def keep(seed, n_views=1):   # the frames as the sampler produced them
            frames = sample(seed, n_views)
            if name == "procedural":
                produced.extend(frames)
            return frames

        sampler.sample_scene_frames = keep
        return sampler

    warm = _make_sampler("procedural", device=dev)
    record_dataset(warm, DATA_ROOT / "warm-up", n_chunks=1, n_frames_per_chunk=10)
    launches_rec = {}
    for name, (n_chunks, n_frames) in RECORD.items():
        sampler = recorder(name)
        kernel.launches = {k: 0 for k in kernel.launches}
        t0 = time.perf_counter()
        record_dataset(sampler, DATA_ROOT / "synt_datasets" / name, n_chunks=n_chunks,
                       n_frames_per_chunk=n_frames)
        wall = time.perf_counter() - t0
        got = dict(kernel.launches)
        n_scene, n_amodal = sampler.counts["scene_renders"], sampler.counts["amodal_renders"]
        want = {"raster_setup": n_scene + n_amodal, "raster_resolve": n_amodal,
                "raster_resolve_attr": n_scene, "raster_setup_merge": 0,
                "raster_resolve_bin": 0, "raster_resolve_listed": 0}
        if got != want:
            raise AssertionError(f"recording {name} launched {got}, want {want} (one attribute "
                                 f"launch a scene render, one plain launch an amodal render)")
        n = n_chunks * n_frames
        t = sampler.times
        host = t["sample"] - t["scene_render"] - t["amodal_render"]
        rest = wall - t["sample"] - t["write"]
        log(f"{tag} recording {name} ({CONFIGS[name]['resolution']}, "
            f"{CONFIGS[name]['sampler_kwargs']['n_views_per_scene']} views a scene): {n} frames "
            f"in {wall:.2f} s, {n / wall:.2f} frames/s; a frame: scene render "
            f"{1e3 * t['scene_render'] / n:.1f} ms, amodal render "
            f"{1e3 * t['amodal_render'] / n:.1f} ms, host validity/GT work {1e3 * host / n:.1f} "
            f"ms, PNG encode + write {1e3 * t['write'] / n:.1f} ms, the rest (JSON, ledger) "
            f"{1e3 * rest / n:.1f} ms; launches {got} for {n_scene} scene and {n_amodal} amodal "
            f"render calls")
        if name == "procedural":
            launches_rec = got

    log(f"profiler_device_events() after recording: {profiler_device_events()}")

    # reading back: the registry's synthetic splits, frame by frame against the sampler
    n_rec = RECORD["procedural"][0] * RECORD["procedural"][1]
    splits = {w: make_scene_dataset(f"synthetic.procedural.{w}", ds_root=DATA_ROOT,
                                    load_depth=True) for w in ("train", "val")}
    items = [splits[w][i] for w in ("train", "val") for i in range(len(splits[w]))]
    if len(items) != n_rec or len(produced) != n_rec:
        raise AssertionError(f"read {len(items)} frames back, the sampler made {len(produced)}")
    n_obj = 0
    for (rgb, mask, obs), (rgb0, mask0, obs0) in zip(items, produced):
        objs, objs0 = obs["objects"], obs0["objects"]
        ok = (np.array_equal(rgb, rgb0) and len(objs) == len(objs0)
              and np.array_equal(obs["camera"]["K"], obs0["camera"]["K"])
              and np.abs(obs["camera"]["depth"] - obs0["camera"]["depth"]).max() <= DEPTH_TOL)
        for n, (o, o0) in enumerate(zip(objs, objs0)):
            ok &= (o["label"] == o0["label"] and np.array_equal(o["bbox"], o0["bbox"])
                   and o["visib_fract"] == o0["visib_fract"]
                   and np.abs(o["TWO"] - o0["TWO"]).max() <= 1e-5
                   and np.array_equal(mask == n + 1, mask0 == o0["id_in_segm"]))
        n_obj += len(objs)
        if not ok:
            raise AssertionError(f"frame {obs['frame_info']} read back differs from the sampler's")
    ds_t = splits["train"]
    t0 = time.perf_counter()
    for i in range(len(ds_t)):
        ds_t._load_item(i)
    dec_depth = (time.perf_counter() - t0) / len(ds_t)
    ds_t.load_depth = False
    t0 = time.perf_counter()
    for i in range(len(ds_t)):
        ds_t._load_item(i)
    dec = (time.perf_counter() - t0) / len(ds_t)
    log(f"{tag} read back {n_rec} frames ({n_obj} GT objects) through "
        f"make_scene_dataset('synthetic.procedural.train|val'): rgb, masks, GT poses (<= 1e-5 m), "
        f"boxes, visible fractions and depth equal to what the sampler produced; decode "
        f"{1e3 * dec:.2f} ms a frame (rgb + masks + JSON), {1e3 * dec_depth:.2f} ms with depth")

    # training on the recorded set: make_cfg("procedural-refiner")
    run_p = make_cfg("procedural-refiner")
    tcfg_p = run_p.train
    Bp, n_it_p = tcfg_p.batch_size, tcfg_p.n_iterations
    jitter = run_p.rgb_augmentation and not tcfg_p.rgb_aug_device
    def pose_dataset():   # a fresh one: every frame decodes on its first read
        return PoseDataset(make_scene_dataset("synthetic.procedural.train", ds_root=DATA_ROOT),
                           resize=tuple(run_p.input_resize), apply_rgb_augmentation=jitter)

    db_p = build_mesh_db(make_object_dataset(run_p.object_ds_name).mesh_specs(), device=dev)
    log(f"training data: {len(pose_dataset())} recorded frames of {run_p.input_resize}, host jitter "
        f"{jitter}; config procedural-refiner: {tcfg_p.predictor.backbone}, render "
        f"{tcfg_p.predictor.render_size}, {tcfg_p.predictor.compute_dtype}, {n_it_p} iterations, "
        f"batch {Bp}, {tcfg_p.input_generator}, n_points_loss {tcfg_p.n_points_loss}")
    exp_p = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_train_procedural_", dir=OUT_DIR))
    for workers, steps in LOADER_STEPS.items():
        pose_ds = pose_dataset()
        if len(pose_ds) < Bp * steps:
            raise AssertionError(f"{len(pose_ds)} recorded frames for {steps} steps of {Bp}")
        cfg_w = dataclasses.replace(run_p, run_id=f"procedural-refiner-w{workers}",
                                    n_dataloader_workers=workers, val_ds_names=())
        cfg_w.train = dataclasses.replace(tcfg_p, n_epochs=1, epoch_size=Bp)
        train_pose(cfg_w, {"train": [(pose_ds, 1)]}, db_p, exp_dir=exp_p, device=dev)  # warm-up
        cfg_w.train = dataclasses.replace(tcfg_p, n_epochs=2, epoch_size=Bp * steps)
        kernel.launches = {k: 0 for k in kernel.launches}
        t0 = time.perf_counter()
        trained_p, run_dir_p = train_pose(cfg_w, {"train": [(pose_ds, 1)]}, db_p, resume=True,
                                          exp_dir=exp_p, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = dict(kernel.launches)
        want = {"raster_setup": steps * n_it_p, "raster_resolve": steps * n_it_p,
                "raster_resolve_attr": 0, "raster_setup_merge": 0,
                "raster_resolve_bin": 0, "raster_resolve_listed": 0}
        rec = [json.loads(line) for line in (run_dir_p / "log.txt").read_text().splitlines()][-1]
        losses = [rec[k] for k in rec if k.startswith("train/loss")]
        if got != want or trained_p.step != 1 + steps or not all(
                math.isfinite(v) for v in losses):
            raise AssertionError(f"procedural-refiner with {workers} workers: launches {got} "
                                 f"(want {want}), step {trained_p.step}, losses {losses}")
        step_s, data_s = rec["train/step_s_per_step"], rec["train/data_s_per_step"]
        first, later = rec["train/data_s_first_batch"], rec["train/data_s_second_half"]
        log(f"{tag} trainer on the recorded set, {workers} loader workers: {steps} steps of "
            f"procedural-refiner in {wall:.1f} s with set-up; {1e3 * step_s:.1f} ms/step, "
            f"{Bp / step_s:.1f} samples/s, {Bp * n_it_p / step_s:.1f} crop-iterations/s; data "
            f"wait {1e3 * data_s:.1f} ms/step ({1e3 * first:.1f} ms before the first batch, "
            f"{1e3 * later:.1f} ms a step over the last {steps - steps // 2} steps); step "
            f"without its wait {1e3 * (step_s - data_s):.1f} ms; loss "
            f"{rec['train/loss_total']:.4f}; launches {got} (3 a step of raster_setup and "
            f"raster_resolve)")
        del trained_p
        log(f"profiler_device_events() after the trainer with {workers} loader workers: "
            f"{profiler_device_events()}")

    # a small scene recorded on the card and on the CPU
    errs, differ = record_card_vs_cpu(DATA_ROOT / "card_vs_cpu")
    log(f"{tag} recording card vs CPU (demo cubes, {SMALL_SCENE[0]}x{SMALL_SCENE[1]}, 3 views), "
        f"largest differences: "
        + ", ".join(f"{k} {e:.3g} (<= {tol})" for k, (e, tol) in errs.items())
        + "; pixels that differ: " + ", ".join(f"{k} {n} of {t}" for k, (n, t) in differ.items()))
    bad = {k: v for k, v in errs.items() if not v[0] <= v[1]}
    if bad:
        raise AssertionError(f"recording card vs CPU beyond tolerance: {bad}")
    log(f"profiler_device_events() after phase 6: {profiler_device_events()}")
    log(f"phase 6 done at {time.perf_counter() - t_main:.0f} s")

    # -- 7. evaluation ------------------------------------------------------------
    from cosypose_tpu_torch.evaluation.eval_bundle import make_eval_bundle
    from cosypose_tpu_torch.rendering.scene_renderer import OBJECT_BUDGET, OBJECT_TILE
    from cosypose_tpu_torch.scripts import run_procedural_accuracy

    # the accuracy CLI at full width on the recorded val split
    acc_args = ["--run-id", "procedural-refiner-w0", "--config", "procedural-refiner",
                "--dataset", "synthetic.procedural.val", "--ds-root", str(DATA_ROOT),
                "--exp-dir", str(exp_p), "--init", "gt+noise",
                "--out", str(OUT_DIR / "chip_smoke_accuracy.json")]
    run_procedural_accuracy.main(acc_args + ["--n-frames", "4", "--n-iterations", "1"])  # warm-up
    kernel.launches = {k: 0 for k in kernel.launches}
    t0 = time.perf_counter()
    acc = run_procedural_accuracy.main(acc_args + ["--n-frames", str(EVAL_FRAMES),
                                                   "--n-iterations", str(EVAL_ITERATIONS)])
    torch.cuda.synchronize()
    wall_acc = time.perf_counter() - t0
    launches_acc = dict(kernel.launches)
    n_eval = len(acc["TCO_init"])
    chunks_e = math.ceil(n_eval / EVAL_BSZ)
    want = {"raster_setup": chunks_e * EVAL_ITERATIONS, "raster_resolve": chunks_e * EVAL_ITERATIONS,
            "raster_resolve_attr": 0, "raster_setup_merge": 0,
            "raster_resolve_bin": 0, "raster_resolve_listed": 0}
    per_pair = acc["per_pair"]
    final_e = acc["predictions"][f"iteration={EVAL_ITERATIONS}"]
    if launches_acc != want or not all(math.isfinite(v) for e in per_pair.values()
                                       for v in e.values()) \
            or not torch.isfinite(final_e.poses).all():
        raise AssertionError(f"accuracy CLI: launches {launches_acc} (want {want}), per-pair "
                             f"errors {per_pair}")
    init_e, last_e = per_pair["init"], per_pair[f"iteration={EVAL_ITERATIONS}"]
    log(f"{tag} run_procedural_accuracy (procedural-refiner-w0, {EVAL_FRAMES} val frames, "
        f"{n_eval} objects, {chunks_e} chunks of {EVAL_BSZ}, {EVAL_ITERATIONS} iterations, "
        f"gt+noise): {wall_acc:.2f} s with set-up, {EVAL_FRAMES / wall_acc:.2f} frames/s, "
        f"{n_eval * EVAL_ITERATIONS / wall_acc:.1f} crop-iterations/s; ADD median "
        f"{1e3 * init_e['ADD_median']:.2f} -> {1e3 * last_e['ADD_median']:.2f} mm, rotation "
        f"{init_e['rot_deg_median']:.2f} -> {last_e['rot_deg_median']:.2f} deg, matched-AUC "
        f"ADD(-S) {acc['matched_auc']['init'].get('AUC', math.nan):.4f} -> "
        f"{acc['matched_auc']['refined'].get('AUC', math.nan):.4f}; launches {launches_acc} "
        f"(want {want})")

    # BOP19 Average Recall of those predictions, VSD on the recorded depth
    val_depth = make_scene_dataset("synthetic.procedural.val", ds_root=DATA_ROOT, load_depth=True)
    groups = {(s, v, lab) for s, v, lab in zip(final_e.infos["scene_id"].tolist(),
                                               final_e.infos["view_id"].tolist(),
                                               final_e.infos["label"].tolist())}
    kernel.launches = {k: 0 for k in kernel.launches}
    ar, ar_t, renders, _ = bop19_ar_timed(final_e, val_depth, db_p, EVAL_FRAMES)
    launches_ar = dict(kernel.launches)
    want = {"raster_setup": len(groups), "raster_resolve": len(groups), "raster_resolve_attr": 0,
            "raster_setup_merge": 0, "raster_resolve_bin": 0, "raster_resolve_listed": 0}
    if launches_ar != want or len(renders) != len(groups) or ar["n_gt"] <= 0 \
            or not all(0.0 <= ar[k] <= 1.0 for k in ("AR", "AR_vsd", "AR_mssd", "AR_mspd")):
        raise AssertionError(f"compute_bop19_ar: launches {launches_ar} (want {want}), "
                             f"{len(renders)} renders, {ar}")
    per_frame = {k: 1e3 * v / EVAL_FRAMES for k, v in ar_t.items()}
    sizes = sorted(len(r[0]) for r in renders)
    log(f"{tag} compute_bop19_ar over {EVAL_FRAMES} frames ({ar['n_gt']} valid GT, {len(groups)} "
        f"(image, label) groups of {sizes[0]}-{sizes[-1]} renders, median {sizes[len(sizes) // 2]}): "
        f"AR {ar['AR']:.4f}, AR_vsd {ar['AR_vsd']:.4f}, AR_mssd {ar['AR_mssd']:.4f}, AR_mspd "
        f"{ar['AR_mspd']:.4f}; {per_frame['total']:.1f} ms a frame: VSD renders "
        f"{per_frame['render']:.1f}, host VSD {per_frame['vsd']:.1f}, MSSD/MSPD "
        f"{per_frame['mssd_mspd']:.1f}, reading the frame and the rest "
        f"{per_frame['total'] - per_frame['render'] - per_frame['vsd'] - per_frame['mssd_mspd']:.1f}"
        f"; launches {launches_ar} (want one a group)")
    launches_eval = {k: launches_acc[k] + launches_ar[k] for k in launches_acc}

    # both kernels at the VSD shape: the largest group, as _vsd_matrix builds it
    big = max(renders, key=lambda r: len(r[0]))
    args_v = vsd_setup_args(db_p, *big[:4])
    rows_v, key_v, order_v, _, err_v, abs_v = setup_vs_plain(args_v)
    checked["raster_setup"].append(f"VSD: {rows_v.shape[0]} x {rows_v.shape[1]} rows")
    res_v = args_v[4]
    out_k = kernel.resolve(rows_v, order_v, res_v, OBJECT_TILE, OBJECT_BUDGET, False)
    torch.cuda.synchronize()
    out_p = rc.resolve_plain_binned(rows_v, order_v, res_v, OBJECT_TILE, OBJECT_BUDGET, False)
    if not all(torch.equal(k, p) for k, p in zip(out_k[:2], out_p[:2])):
        raise AssertionError("raster_resolve at the VSD shape: kernel vs plain not equal")
    checked["raster_resolve"].append(f"VSD: {rows_v.shape[0]} x {rows_v.shape[1]} rows, {res_v}, "
                                     f"tile {OBJECT_TILE}, budget {OBJECT_BUDGET}")
    # after phase 6 torch.profiler records no device activity in this process
    # (PERF.md §7), so this phase times by CUDA events behind a spin kernel
    ms_v = queued_ms(lambda: kernel.resolve(rows_v, order_v, res_v, OBJECT_TILE, OBJECT_BUDGET,
                                            False), 50)
    plain_v = time_cuda_ms(lambda: rc.resolve_plain_binned(rows_v, order_v, res_v, OBJECT_TILE,
                                                           OBJECT_BUDGET, False), 5, warmup=1)
    t_va = setup_timing(args_v, key_v)
    b_v, by_v, visits_v, bytes_v = resolve_bound(rows_v, order_v, res_v, OBJECT_TILE,
                                                 OBJECT_BUDGET, False)
    b_va, by_va = setup_bound(args_v[0], args_v[1], args_v[5], None, rows_v, key_v)[:2]
    kept_v, whole_v, over_v, items_v = vsd_budget_drop(db_p, renders)
    log(f"{tag} VSD shape (B={rows_v.shape[0]}: estimates and GTs of one group, "
        f"{rows_v.shape[1]} rows, {res_v[0]}x{res_v[1]}, tile {OBJECT_TILE}, budget "
        f"{OBJECT_BUDGET}; device times by CUDA events behind a spin kernel): raster_setup vs "
        f"plain plane rel err {err_v['plane']:.3g}, bbox/key {err_v['bbox_key']:.3g} (<= "
        f"{rc.SETUP_TOL}), max abs err {abs_v:.3g}, order equal to torch.sort's; "
        f"{setup_timing_text(t_va, b_va, by_va)}; raster_resolve equal to the plain version "
        f"(rgb, depth), {ms_v:.4f} ms on the device, bound {b_v:.4f} ms by {by_v} ({visits_v:.4g} "
        f"visits, {bytes_v / 1e6:.2f} MB; {100 * b_v / ms_v:.1f} % of bound), plain on the card "
        f"{plain_v:.2f} ms, library_ms: none")
    log(f"{tag} VSD renders over all {len(renders)} groups: the budget keeps {kept_v} of the "
        f"{whole_v} object pixels an unlimited one draws ({100 * (1 - kept_v / max(whole_v, 1)):.2f}"
        f" % dropped); {over_v} of {items_v} items have a tile beyond it")
    del rows_v, order_v, out_k, out_p

    # the evaluation bundle in training: procedural-refiner with its validation set
    run_e = make_cfg("procedural-refiner")
    cfg_e = dataclasses.replace(run_e, run_id="procedural-refiner-eval", n_dataloader_workers=0,
                                val_ds_names=(("synthetic.procedural.val", 1),),
                                test_epoch_interval=1)
    cfg_e.train = dataclasses.replace(run_e.train, n_epochs=2, epoch_size=Bp * BUNDLE_STEPS)
    val_scene = make_scene_dataset("synthetic.procedural.val", ds_root=DATA_ROOT)
    t0 = time.perf_counter()
    bundle = make_eval_bundle(cfg_e, db_p, val_scene, n_frames=BUNDLE_FRAMES, device=dev)
    t_bundle = time.perf_counter() - t0
    t_calls = []

    def callback(state, epoch):
        t0 = time.perf_counter()
        metrics = bundle(state, epoch)
        t_calls.append(time.perf_counter() - t0)
        return metrics

    val_pose = PoseDataset(val_scene, resize=tuple(run_e.input_resize), apply_rgb_augmentation=False)
    state_e, run_dir_e = train_pose(cfg_e, {"train": [(pose_dataset(), 1)],
                                            "val": [(val_pose, 1)]}, db_p, exp_dir=exp_p,
                                    eval_callback=callback, device=dev)
    recs = [json.loads(line) for line in (run_dir_e / "log.txt").read_text().splitlines()]
    tests = [r for r in recs if "test/init/ADD_median" in r]
    last_key = f"test/iter={run_e.train.n_iterations}/ADD_median"
    if len(tests) != 2 or not all(math.isfinite(r.get(last_key, math.nan)) for r in tests) \
            or not any("val/loss_total" in r for r in recs):
        raise AssertionError(f"train_pose with the evaluation bundle: log {recs}")
    before = {k: v.clone() for k, v in state_e.pp.net.state_dict().items()}
    was_training = state_e.pp.net.training
    state_e.pp.net.train()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics_e = bundle(state_e, 2)
    torch.cuda.synchronize()
    t_one = time.perf_counter() - t0
    after = state_e.pp.net.state_dict()
    if not state_e.pp.net.training or not all(torch.equal(before[k], after[k]) for k in before):
        raise AssertionError("the evaluation callback changed the training module")
    log(f"{tag} train_pose(procedural-refiner, {BUNDLE_STEPS} steps x 2 epochs, val set on, "
        f"test_epoch_interval 1) with make_eval_bundle over {BUNDLE_FRAMES} val frames (built in "
        f"{t_bundle:.2f} s): log.txt holds test/init/ADD_median and {last_key[5:]} at both epochs "
        f"({1e3 * tests[0]['test/init/ADD_median']:.2f} -> {1e3 * tests[-1][last_key]:.2f} mm), "
        f"callbacks in training {', '.join(f'{t:.2f}' for t in t_calls)} s; one more callback "
        f"{1e3 * t_one:.1f} ms (ADD median {1e3 * metrics_e[last_key[5:]]:.2f} mm) leaves the state "
        f"dict bitwise unchanged and train mode on (it was {was_training})")
    del state_e, bundle

    # the evaluation of a few frames on the card and on the CPU, same predictions
    db_cpu = build_mesh_db(make_object_dataset(run_p.object_ds_name).mesh_specs(), device="cpu")
    t0 = time.perf_counter()
    # AR of the CLI's initial poses (gt + noise from a seeded torch.Generator):
    # the same on every run, unlike the trained model's output
    seeded = TensorCollection(final_e.infos, poses=torch.as_tensor(acc["TCO_init"]))
    errs, counts = evaluation_card_vs_cpu(seeded, val_depth, {"cuda": db_p, "cpu": db_cpu},
                                          EVAL_CPU_FRAMES)
    log(f"{tag} evaluation card vs CPU ({EVAL_CPU_FRAMES} frames; BOP19 AR of the CLI's initial "
        f"poses, the ADD(-S) meter of the GT poses with noise {METER_NOISE}; "
        f"{time.perf_counter() - t0:.1f} s):"
        f" |card - CPU| " + ", ".join(f"{k} {v:.3g} (<= {EVAL_CPU_LIMITS.get(k, 0.0)})"
                                      for k, v in errs.items())
        + "; " + ", ".join(f"{k} {n} of {t}" for k, (n, t) in counts.items()))
    bad = {k: v for k, v in errs.items() if not v <= EVAL_CPU_LIMITS.get(k, 0.0)}
    bad.update({k: n for k, (n, _) in counts.items() if k in EVAL_CPU_COUNTS
                and n > EVAL_CPU_COUNTS[k]})
    if bad or counts["render calls"][0] != counts["render calls"][1]:
        raise AssertionError(f"evaluation card vs CPU beyond its limits: {bad}")
    log(f"phase 7 done at {time.perf_counter() - t_main:.0f} s")

    # -- 8. the detection path ------------------------------------------------------
    from cosypose_tpu_torch.data.detection_dataset import DetectionDataset
    from cosypose_tpu_torch.models.detector import (CenterNetDetector, DetectorConfig,
                                                    decode_detections, init_detector_weights)
    from cosypose_tpu_torch.scripts import run_bop_inference, run_detector_training
    from cosypose_tpu_torch.training.detector_training import train_detector

    # the detector at BOP's width, both cls_modes, seeded weights
    x_det = torch.rand(DET_BATCH, 3, *IMAGE, generator=torch.Generator().manual_seed(0)).to(dev)
    x_cpu = torch.rand(2, 3, *DET_CPU_SIZE, generator=torch.Generator().manual_seed(1))
    for cls_mode in ("percls", "softmax"):
        det = CenterNetDetector(DetectorConfig(n_classes=DET_CLASSES, cls_mode=cls_mode))
        init_detector_weights(det, torch.Generator().manual_seed(0))
        det.eval()
        with torch.no_grad():
            heads_cpu = det(x_cpu)
            dec_cpu = decode_detections(heads_cpu, det.cfg.max_detections)
            det.to(dev)
            heads_card = det(x_cpu.to(dev))
            dec_card = decode_detections(heads_card, det.cfg.max_detections)
            torch.cuda.reset_peak_memory_stats()
            ms_fwd = time_cuda_ms(lambda: det(x_det), DET_REPS)
            ms_det = time_cuda_ms(lambda: decode_detections(det(x_det), det.cfg.max_detections),
                                  DET_REPS)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        err = max(float((heads_card[k].cpu() - heads_cpu[k]).abs().max()) for k in heads_cpu)
        differ, n_det = [], 0
        for b in range(x_cpu.shape[0]):
            sets = [{(int(c), tuple(np.round(bx.tolist(), 3)))
                     for c, bx, sc in zip(d["class_ids"][b].cpu(), d["boxes"][b].cpu(),
                                          d["scores"][b].cpu()) if sc > 0}
                    for d in (dec_cpu, dec_card)]
            differ.append(len(sets[0] ^ sets[1]) // 2)
            n_det += len(sets[0])
        log(f"{tag} detector {cls_mode} (WideResNet-18, {DET_CLASSES} classes, "
            f"{det.cfg.max_detections} detections, fp32): {DET_BATCH}x{IMAGE[0]}x{IMAGE[1]} "
            f"forward {ms_fwd:.2f} ms, forward + decode {ms_det:.2f} ms a batch "
            f"({1e3 * DET_BATCH / ms_det:.1f} frames/s), peak {peak:.2f} GiB; card vs CPU at "
            f"{DET_CPU_SIZE[0]}x{DET_CPU_SIZE[1]} on 2 frames: head outputs max |diff| "
            f"{err:.3g} (<= {ATOL_SLICE}), decoded detections that differ {differ} of {n_det} "
            f"(<= {DET_SET_DIFF} an image)")
        if err > ATOL_SLICE or max(differ) > DET_SET_DIFF or n_det == 0:
            raise AssertionError(f"detector {cls_mode} card vs CPU: heads {err}, sets {differ}")
        del det, heads_card, dec_card

    # detector-procedural on the recorded train frames, 8 loader workers
    run_d = run_detector_training.make_cfg("detector-procedural")
    labels_d = run_detector_training.label_to_category_id(make_object_dataset("procedural"))
    tcfg_d = dataclasses.replace(
        run_d.train, n_epochs=1, epoch_size=run_d.train.batch_size * DET_STEPS,
        detector=dataclasses.replace(run_d.train.detector, n_classes=len(labels_d)))
    det_ds = DetectionDataset(make_scene_dataset("synthetic.procedural.train", ds_root=DATA_ROOT),
                              labels_d, resize=tuple(run_d.input_size))
    t0 = time.perf_counter()
    state_d = train_detector(tcfg_d, det_ds, exp_p / run_d.run_id,
                             n_workers=run_d.n_dataloader_workers, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rec = [json.loads(line) for line in
           (exp_p / run_d.run_id / "log.txt").read_text().splitlines()][-1]
    losses = {k[6:]: v for k, v in rec.items() if k.startswith("train/loss")}
    if state_d.step != DET_STEPS or not all(math.isfinite(v) for v in losses.values()) \
            or not list((exp_p / run_d.run_id / "checkpoint").glob("epoch_*.pt")):
        raise AssertionError(f"detector-procedural: step {state_d.step}, losses {losses}")
    step_s, data_s = rec["train/step_s_per_step"], rec["train/data_s_per_step"]
    Bd = tcfg_d.batch_size
    log(f"{tag} train_detector(detector-procedural, {run_d.input_size}, batch {Bd}, "
        f"{run_d.n_dataloader_workers} loader workers): {DET_STEPS} steps in {wall:.1f} s with "
        f"set-up; {1e3 * step_s:.1f} ms/step, {Bd / step_s:.1f} samples/s; data wait "
        f"{1e3 * data_s:.1f} ms/step ({1e3 * rec['train/data_s_first_batch']:.1f} ms before the "
        f"first batch, {1e3 * rec['train/data_s_second_half']:.1f} ms a step over the last "
        f"{DET_STEPS - DET_STEPS // 2}); step without its wait {1e3 * (step_s - data_s):.1f} ms; "
        + ", ".join(f"{k} {v:.4f}" for k, v in losses.items()) + "; checkpoint saved")
    del state_d

    # procedural-refiner-mini on procedural-canon
    run_m = make_cfg("procedural-refiner-mini")
    tcfg_m = run_m.train
    Bm, n_it_m = tcfg_m.batch_size, tcfg_m.n_iterations
    canon = PoseDataset(make_scene_dataset("synthetic.procedural-canon.train", ds_root=DATA_ROOT),
                        resize=tuple(run_m.input_resize),
                        apply_rgb_augmentation=run_m.rgb_augmentation and not tcfg_m.rgb_aug_device)
    repeat = math.ceil(Bm * MINI_STEPS / len(canon))
    cfg_m = dataclasses.replace(run_m, n_dataloader_workers=0, val_ds_names=())
    cfg_m.train = dataclasses.replace(tcfg_m, n_epochs=1, epoch_size=Bm)
    train_pose(cfg_m, {"train": [(canon, repeat)]}, db_p, exp_dir=exp_p, device=dev)  # warm-up
    cfg_m.train = dataclasses.replace(tcfg_m, n_epochs=2, epoch_size=Bm * MINI_STEPS)
    kernel.launches = {k: 0 for k in kernel.launches}
    t0 = time.perf_counter()
    state_m, run_dir_m = train_pose(cfg_m, {"train": [(canon, repeat)]}, db_p, resume=True,
                                    exp_dir=exp_p, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = dict(kernel.launches)
    want = {"raster_setup": MINI_STEPS * n_it_m, "raster_resolve": MINI_STEPS * n_it_m,
            "raster_resolve_attr": 0, "raster_setup_merge": 0,
            "raster_resolve_bin": 0, "raster_resolve_listed": 0}
    rec = [json.loads(line) for line in (run_dir_m / "log.txt").read_text().splitlines()][-1]
    if got != want or state_m.step != 1 + MINI_STEPS or not (run_dir_m / "config.yaml").exists() \
            or not math.isfinite(rec["train/loss_total"]):
        raise AssertionError(f"procedural-refiner-mini: launches {got} (want {want}), step "
                             f"{state_m.step}, log {rec}")
    step_s, data_s = rec["train/step_s_per_step"], rec["train/data_s_per_step"]
    pred_m = tcfg_m.predictor
    log(f"{tag} train_pose(procedural-refiner-mini: {pred_m.backbone}, {pred_m.pooling}, "
        f"{pred_m.compute_dtype}, render {pred_m.render_size}, batch {Bm}, {n_it_m} iteration, "
        f"0 loader workers) over {len(canon)} procedural-canon frames x {repeat}: {MINI_STEPS} "
        f"steps in {wall:.1f} s with set-up; {1e3 * step_s:.1f} ms/step ({1e3 * data_s:.1f} of "
        f"it data wait), {Bm / step_s:.1f} samples/s; loss {rec['train/loss_total']:.4f}; "
        f"launches {got} (want {want}); checkpoint and config.yaml saved")
    del state_m

    # the new backbones and poolings, card vs CPU
    images_b, K_b, TCO_b, labels_b = demo.make_inputs(2, *RENDER)
    db_cpu_demo = build_mesh_db(demo.demo_specs(), render_max_faces=LOD, device="cpu")
    for name in ("procedural-diag-corr-flat-lk", "tless-refiner-ablation-network"):
        pcfg = dataclasses.replace(make_cfg(name).train.predictor, compute_dtype=torch.float32,
                                   n_points_crop=200)
        outs, weights = {}, None
        for d, mdb in (("cpu", db_cpu_demo), (dev, db)):
            pp = PosePredictor(pcfg, device=d)
            if weights is None:
                w = pp.net.pose_fc.weight
                with torch.no_grad():
                    w.copy_(5e-3 * torch.randn(w.shape, generator=torch.Generator().manual_seed(2)))
                weights = pp.net.state_dict()
            pp.net.load_state_dict(weights)
            md = gather_mesh_data(mdb, torch.as_tensor(labels_b, device=d).long(), 200)
            args_b = [torch.as_tensor(a, device=d) for a in (images_b, K_b, TCO_b)]
            outs[str(d)] = pp.forward(md, *args_b, n_iterations=2)["TCO_final"].cpu()
        err = float((outs["cuda"] - outs["cpu"]).abs().max())
        moved = float((outs["cpu"] - torch.as_tensor(TCO_b)).abs().max())
        log(f"{tag} {name} predictor ({pcfg.backbone}, {pcfg.pooling}, {pcfg.input_mode}, "
            f"render {pcfg.render_size}, fp32), B=2, 2 iterations: TCO card vs CPU max |diff| "
            f"{err:.3g} (<= {ATOL_SLICE}); the poses moved {moved:.3g}")
        if not err <= ATOL_SLICE or moved <= ATOL_SLICE:
            raise AssertionError(f"{name}: card vs CPU {err}, moved {moved}")

    # run_bop_inference --dataset procedural: detector -> refiner -> CSV + metrics
    bop_args = ["--dataset", "procedural", "--inference-ds", "synthetic.procedural.val",
                "--ds-root", str(DATA_ROOT), "--exp-dir", str(exp_p), "--detector", run_d.run_id,
                "--refiner", run_m.run_id, "--detection-th", str(BOP_DETECTION_TH),
                "--out-dir", str(OUT_DIR / "chip_smoke_bop")]
    run_bop_inference.main(bop_args + ["--n-frames", "4"])  # warm-up
    kernel.launches = {k: 0 for k in kernel.launches}
    t0 = time.perf_counter()
    bop = run_bop_inference.main(bop_args)
    torch.cuda.synchronize()
    wall_bop = time.perf_counter() - t0
    launches_det = dict(kernel.launches)
    preds_b = bop["predictions"]["pose"]
    per_frame = {}
    for key in zip(preds_b.infos["scene_id"].tolist(), preds_b.infos["view_id"].tolist()):
        per_frame[key] = per_frame.get(key, 0) + 1
    chunks_b = sum(math.ceil(n / EVAL_BSZ) for n in per_frame.values())
    val_b = make_scene_dataset("synthetic.procedural.val", ds_root=DATA_ROOT)
    n_frames_b = len(val_b)
    ar_groups = sum(len({o["label"] for o in val_b[i][2]["objects"]}) for i in range(n_frames_b))
    n_ref = 4
    want = {"raster_setup": chunks_b * n_ref + ar_groups,
            "raster_resolve": chunks_b * n_ref + ar_groups, "raster_resolve_attr": 0,
            "raster_setup_merge": 0, "raster_resolve_bin": 0, "raster_resolve_listed": 0}
    ar_b, meter_b = bop["metrics"]["bop19_ar"], bop["metrics"]["pose"]
    csv_rows = len(bop["csv_paths"]["pose"].read_text().splitlines()) - 1
    if launches_det != want or csv_rows != len(preds_b) or not torch.isfinite(preds_b.poses).all() \
            or not all(0.0 <= ar_b[k] <= 1.0 for k in ("AR", "AR_vsd", "AR_mssd", "AR_mspd")):
        raise AssertionError(f"run_bop_inference: launches {launches_det} (want {want}), CSV rows "
                             f"{csv_rows} for {len(preds_b)} predictions, AR {ar_b}")
    sec = bop["seconds"]
    log(f"{tag} run_bop_inference --dataset procedural ({n_frames_b} val frames, detector "
        f"{run_d.run_id} -> {run_m.run_id}, {n_ref} iterations, detection threshold "
        f"{BOP_DETECTION_TH}): {wall_bop:.2f} s with set-up and metrics, "
        f"{n_frames_b / wall_bop:.2f} frames/s end to end; detection {sec['detection']:.2f} s "
        f"({n_frames_b / sec['detection']:.1f} frames/s), pose {sec['pose']:.2f} s "
        f"({n_frames_b / sec['pose']:.1f} frames/s); {len(preds_b) / n_frames_b:.1f} detections "
        f"a frame ({len(preds_b)} in {chunks_b} refiner chunks of {EVAL_BSZ}); CSV {csv_rows} "
        f"rows; ADD(-S) AUC {meter_b.get('AUC', math.nan):.4f} over {meter_b.get('n_gt', 0):.0f} "
        f"GT; BOP19 AR {ar_b['AR']:.4f} (vsd {ar_b['AR_vsd']:.4f}, mssd {ar_b['AR_mssd']:.4f}, "
        f"mspd {ar_b['AR_mspd']:.4f}) over {ar_groups} (image, label) groups; launches "
        f"{launches_det} (want {want})")

    # both kernels at the mini refiner's render shape: one frame's chunk, padded
    first_key = next(iter(per_frame))
    rows_f = np.flatnonzero((preds_b.infos["scene_id"] == first_key[0])
                            & (preds_b.infos["view_id"] == first_key[1]))
    rows_f = np.concatenate([rows_f, np.full(EVAL_BSZ - len(rows_f), rows_f[-1])])
    chunk = preds_b[rows_f]
    res_m, tile_m, budget_m = pred_m.render_size, pred_m.raster_tile, pred_m.raster_max_tris_per_tile
    args_m = vsd_setup_args(db_p, db_p.ids_for(chunk.infos["label"]).cpu().numpy(),
                            chunk.poses_input, chunk.K_crop, res_m)
    rows_m, key_m, order_m, _, err_m, abs_m = setup_vs_plain(args_m)
    checked["raster_setup"].append(f"mini refiner: {rows_m.shape[0]} x {rows_m.shape[1]} rows")
    out_k = kernel.resolve(rows_m, order_m, res_m, tile_m, budget_m, False)
    torch.cuda.synchronize()
    out_p = rc.resolve_plain_binned(rows_m, order_m, res_m, tile_m, budget_m, False)
    if not all(torch.equal(k, p) for k, p in zip(out_k[:2], out_p[:2])):
        raise AssertionError("raster_resolve at the mini refiner's shape: kernel vs plain differ")
    checked["raster_resolve"].append(f"mini refiner: {rows_m.shape[0]} x {rows_m.shape[1]} rows, "
                                     f"{res_m}, tile {tile_m}, budget {budget_m}")
    ms_m = queued_ms(lambda: kernel.resolve(rows_m, order_m, res_m, tile_m, budget_m, False), 50)
    t_ma = setup_timing(args_m, key_m)
    plain_m = time_cuda_ms(lambda: rc.resolve_plain_binned(rows_m, order_m, res_m, tile_m,
                                                           budget_m, False), 3, warmup=1)
    b_m, by_m, visits_m, bytes_m = resolve_bound(rows_m, order_m, res_m, tile_m, budget_m, False)
    b_ma, by_ma = setup_bound(args_m[0], args_m[1], args_m[5], None, rows_m, key_m)[:2]
    cxy = chunk.K_crop[:, :2, 2].abs().max().item()
    log(f"{tag} mini refiner shape (B={rows_m.shape[0]} x {rows_m.shape[1]} rows, "
        f"largest |cx|, |cy| of the crops {cxy:.1f} px, "
        f"{res_m[0]}x{res_m[1]}, tile {tile_m}, budget {budget_m}; CUDA events behind a spin "
        f"kernel): raster_setup vs plain plane rel err {err_m['plane']:.3g} (<= {rc.SETUP_TOL}), "
        f"max abs err {abs_m:.3g}, order equal to torch.sort's; "
        f"{setup_timing_text(t_ma, b_ma, by_ma)}; raster_resolve equal to the plain version, "
        f"{ms_m:.4f} ms "
        f"(bound {b_m:.4f} ms by {by_m}, {visits_m:.4g} visits, {bytes_m / 1e6:.2f} MB; "
        f"{100 * b_m / ms_m:.1f} % of bound), plain on the card {plain_m:.2f} ms, library_ms: "
        f"none")
    log(f"phase 8 done at {time.perf_counter() - t_main:.0f} s")

    # -- 9. CosyPose stages 2-3 and ICP ---------------------------------------------
    from cosypose_tpu_torch.integrated.icp_refiner import (ICP_BUDGET, ICP_TILE, ICPRefiner,
                                                           _icp_refine_batch)
    from cosypose_tpu_torch.scripts import bench_multiview, run_cosypose_eval, run_custom_scenario

    # ICP on the recorded val frames, each frame a group (run_bop_inference's --nviews 1)
    rng9 = np.random.RandomState(0)
    icp_in = [icp_frame_inputs(val_depth, i, rng9) for i in range(len(val_depth))]
    icp = ICPRefiner(db_p)
    icp.refine_poses(icp_in[0]["preds"], icp_in[0]["masks"], icp_in[0]["depth"],
                     icp_in[0]["K"])  # warm-up
    torch.cuda.synchronize()
    kernel.launches = {k: 0 for k in kernel.launches}
    t_groups, outs = [], []
    for x in icp_in:
        t0 = time.perf_counter()
        outs.append(icp.refine_poses(x["preds"], x["masks"], x["depth"], x["K"]))
        torch.cuda.synchronize()
        t_groups.append(time.perf_counter() - t0)
    launches_icp = dict(kernel.launches)
    want = {"raster_setup": len(icp_in), "raster_resolve": len(icp_in), "raster_resolve_attr": 0,
            "raster_setup_merge": 0, "raster_resolve_bin": 0, "raster_resolve_listed": 0}
    t_host, t_render, t_loop = [], [], []
    for x in icp_in:   # the same groups again, refine_poses' steps timed apart
        t0 = time.perf_counter()
        depth_d = torch.as_tensor(x["depth"], dtype=torch.float32, device=dev)
        im = torch.as_tensor(x["preds"].infos["batch_im_id"], device=dev).long()
        observed = torch.where(torch.as_tensor(x["masks"], device=dev), depth_d[im], 0.0)
        TCO_d = x["preds"].poses.to(dev, torch.float32)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        rendered, K_dets = icp.render_depth(x["preds"], x["K"], depth_d.shape[-2:])
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        _, ok = _icp_refine_batch(TCO_d, rendered, observed, K_dets)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        x["preds"].clone().infos["icp_ok"] = ok.cpu().numpy()
        t_host.append(t1 - t0 + time.perf_counter() - t3)
        t_render.append(t2 - t1)
        t_loop.append(t3 - t2)
    err_before = np.concatenate([np.linalg.norm(x["preds"].poses[:, :3, 3].numpy()
                                                - x["TCO"][:, :3, 3], axis=-1) for x in icp_in])
    err_after = np.concatenate([np.linalg.norm(o.poses[:, :3, 3].cpu().numpy()
                                               - x["TCO"][:, :3, 3], axis=-1)
                                for o, x in zip(outs, icp_in)])
    visib = np.concatenate([x["visib"] for x in icp_in])
    ok_icp = np.concatenate([o.infos["icp_ok"] for o in outs])
    target = visib >= BOP_VISIB_MIN
    med = {k: (float(np.median(err_before[m])), float(np.median(err_after[m])))
           for k, m in (("all", np.ones_like(target)), ("targets", target),
                        ("visib>=0.5", visib >= 0.5), ("visib<0.5", visib < 0.5))}
    ms_g, ms_r, ms_l, ms_h = (1e3 * float(np.mean(t))
                              for t in (t_groups, t_render, t_loop, t_host))
    n_det = len(err_before)
    log(f"{tag} ICPRefiner on {len(icp_in)} recorded val frames ({n_det} GT objects, "
        f"{n_det / len(icp_in):.1f} a group; GT poses moved by {ICP_OFFSET} m + N(0, "
        f"{ICP_NOISE}); observed depth masked by the GT visible masks; 240x320, 10 iterations):"
        f" median translation error before -> after: " + ", ".join(
            f"{k} {1e3 * a:.2f} -> {1e3 * b:.2f} mm" for k, (a, b) in med.items())
        + f" (BOP targets: visib_fract >= {BOP_VISIB_MIN}, {int(target.sum())}); "
        f"{100 * float((err_after < err_before).mean()):.1f} % of objects closer; icp_ok "
        f"{100 * float(ok_icp.mean()):.1f} %; {ms_g:.2f} ms a group (refine_poses); its steps "
        f"timed apart: render {ms_r:.2f}, ICP loop {ms_l:.2f}, host {ms_h:.2f}; launches "
        f"{launches_icp} (want {want})")
    if launches_icp != want or not med["targets"][1] < med["targets"][0] \
            or not np.isfinite(err_after).all():
        raise AssertionError(f"ICP on recorded frames: launches {launches_icp} (want {want}), "
                             f"median error {med}")

    # both kernels at ICP's render shape: the largest group, as render_depth builds it
    big = max(icp_in, key=lambda x: len(x["TCO"]))
    ids_i = db_p.ids_for(big["preds"].infos["label"])
    K_i = torch.as_tensor(big["K"], device=dev)[[0] * len(ids_i)]
    args_i = (db_p.tri_verts[ids_i], db_p.tri_valid[ids_i], big["preds"].poses.to(dev), K_i,
              tuple(big["depth"].shape[-2:]))
    rows_i, key_i, order_i, _, err_i, abs_i = setup_vs_plain(args_i)
    res_i = args_i[4]
    out_k = kernel.resolve(rows_i, order_i, res_i, ICP_TILE, ICP_BUDGET, False)
    torch.cuda.synchronize()
    out_p = rc.resolve_plain_binned(rows_i, order_i, res_i, ICP_TILE, ICP_BUDGET, False)
    if not all(torch.equal(k, p) for k, p in zip(out_k[:2], out_p[:2])):
        raise AssertionError("raster_resolve at ICP's shape: kernel vs plain not equal")
    ms_i = queued_ms(lambda: kernel.resolve(rows_i, order_i, res_i, ICP_TILE, ICP_BUDGET, False),
                     50)
    t_ia = setup_timing(args_i, key_i)
    plain_i = time_cuda_ms(lambda: rc.resolve_plain_binned(rows_i, order_i, res_i, ICP_TILE,
                                                           ICP_BUDGET, False), 3, warmup=1)
    plain_ia = time_cuda_ms(lambda: rc.sort_order(rc.setup_plain(*args_i)[1]), 10)
    b_i, by_i, visits_i, bytes_i = resolve_bound(rows_i, order_i, res_i, ICP_TILE, ICP_BUDGET,
                                                 False)
    b_ia, by_ia = setup_bound(args_i[0], args_i[1], torch.empty(0), None, rows_i, key_i)[:2]
    log(f"{tag} ICP's render shape (B={rows_i.shape[0]} detections x {rows_i.shape[1]} rows, "
        f"{res_i[0]}x{res_i[1]}, tile {ICP_TILE}, budget {ICP_BUDGET}; CUDA events behind a spin "
        f"kernel): raster_setup vs plain plane rel err {err_i['plane']:.3g}, bbox/key "
        f"{err_i['bbox_key']:.3g} (<= {rc.SETUP_TOL}), max abs err {abs_i:.3g}, order equal to "
        f"torch.sort's; {setup_timing_text(t_ia, b_ia, by_ia)}, plain on the card "
        f"{plain_ia:.3f} ms; raster_resolve equal to the plain version, {ms_i:.4f} ms (bound "
        f"{b_i:.4f} ms by {by_i}, {visits_i:.4g} visits, {bytes_i / 1e6:.2f} MB; "
        f"{100 * b_i / ms_i:.1f} % of bound), plain on the card {plain_i:.2f} ms, library_ms: "
        f"none")
    checked["raster_setup"].append(f"ICP: {rows_i.shape[0]} x {rows_i.shape[1]} rows, {res_i}")
    checked["raster_resolve"].append(f"ICP: {rows_i.shape[0]} x {rows_i.shape[1]} rows, {res_i}, "
                                     f"tile {ICP_TILE}, budget {ICP_BUDGET}")

    # ICP card vs CPU on the same rendered and observed depths
    rendered, K_dets = icp.render_depth(big["preds"], big["K"], big["depth"].shape[-2:])
    observed = torch.where(torch.as_tensor(big["masks"], device=dev),
                           torch.as_tensor(big["depth"], device=dev)[[0] * len(ids_i)], 0.0)
    icp_args = (big["preds"].poses.to(dev), rendered, observed, K_dets)
    got_i, ok_i = _icp_refine_batch(*icp_args)
    ref_i, ok_ref = _icp_refine_batch(*[a.cpu() for a in icp_args])
    e_icp = float((got_i.cpu() - ref_i).abs().max())
    log(f"{tag} ICP card vs CPU on the largest group's depths ({len(ids_i)} detections): poses "
        f"max |diff| {e_icp:.3g} (<= {ICP_CPU_ATOL}), icp_ok equal: "
        f"{torch.equal(ok_i.cpu(), ok_ref)}")
    if e_icp > ICP_CPU_ATOL or not torch.equal(ok_i.cpu(), ok_ref):
        raise AssertionError(f"ICP card vs CPU: {e_icp}, flags {ok_i.tolist()} {ok_ref.tolist()}")
    del rows_i, order_i, out_k, out_p, icp_in, outs

    # multiview at the reference's protocol scale, card then CPU
    cands, cams, _ = bench_multiview.make_scenario(**MV_SCALE, noise_t=0.004, noise_deg=2.0)
    specs_mv = bench_multiview.cube_specs(MV_SCALE["n_labels"])
    db_mv = build_mesh_db(specs_mv, aabb=True, keep_geometry=False, device=dev)
    t0 = time.perf_counter()
    bench_multiview.run_once(cands, cams, db_mv, MV_RANSAC_ITER, MV_BA_ITER)  # warm-up, g++
    t_warm = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    mv = bench_multiview.run_once(cands, cams, db_mv, MV_RANSAC_ITER, MV_BA_ITER)
    peak_mv = torch.cuda.max_memory_allocated() / 2 ** 30
    r = mv["row"]
    TWC_gt = cams.TWC.numpy().astype(np.float64)
    rel_rot = rel_t = 0.0
    for ba in mv["bas"]:
        TWC_est = ba["cameras"].TWC.cpu().numpy().astype(np.float64)
        v = ba["cameras"].infos["view_id"]
        for j in range(1, len(v)):
            d = np.linalg.inv(TWC_est[0]) @ TWC_est[j] - np.linalg.inv(TWC_gt[v[0]]) @ TWC_gt[v[j]]
            rel_rot = max(rel_rot, float(np.abs(d[:3, :3]).max()))
            rel_t = max(rel_t, float(np.linalg.norm(d[:3, 3])))
    log(f"{tag} multiview at protocol scale ({r['n_candidates']} candidates over "
        f"{MV_SCALE['n_views']} views, {MV_SCALE['n_objects']} objects, {MV_RANSAC_ITER} RANSAC "
        f"hypotheses a view pair, BA {MV_BA_ITER} iterations; first call {t_warm:.2f} s): RANSAC "
        f"{1e3 * r['ransac_total_s']:.1f} ms (hypotheses {1e3 * r['ransac_models_s']:.1f}, "
        f"scoring with top-k and the greedy pass {1e3 * r['ransac_score_s']:.1f}, bookkeeping "
        f"{1e3 * r['ransac_misc_s']:.1f}), BA {1e3 * r['ba_total_s']:.1f} ms (init "
        f"{1e3 * r['ba_init_s']:.1f}, LM {1e3 * r['ba_opt_s']:.1f}; iterations "
        f"{r['n_lm_iterations']}, final loss {r['final_loss']}) over {r['n_groups']} group(s), "
        f"{r['n_matched']} matched candidates, {r['n_objects_out']} objects out; peak "
        f"{peak_mv:.2f} GiB; relative camera poses to the scene's: rotation entries max |err| "
        f"{rel_rot:.4g} (<= {MV_REL_ROT_ATOL}), translations {1e3 * rel_t:.2f} mm (<= "
        f"{1e3 * MV_REL_T_ATOL:.0f})")
    if rel_rot > MV_REL_ROT_ATOL or rel_t > MV_REL_T_ATOL or r["n_groups"] < 1:
        raise AssertionError(f"multiview at protocol scale: relative poses {rel_rot}, {rel_t}, {r}")
    db_mv_cpu = build_mesh_db(specs_mv, aabb=True, keep_geometry=False, device="cpu")
    t0 = time.perf_counter()
    mv_cpu = bench_multiview.run_once(cands, cams, db_mv_cpu, MV_RANSAC_ITER, MV_BA_ITER)
    t_cpu = time.perf_counter() - t0
    fc, fg = mv["match"]["filtered_candidates"], mv_cpu["match"]["filtered_candidates"]
    pc, pg = mv["match"]["pairs_TC1C2"], mv_cpu["match"]["pairs_TC1C2"]
    same_match = all(np.array_equal(fc.infos[k], fg.infos[k]) for k in ("cand_id", "obj_id")) \
        and all(np.array_equal(pc.infos[k], pg.infos[k]) for k in ("view1", "view2"))
    e_tc = float((pc.TC1C2.cpu() - pg.TC1C2).abs().max())
    def in_cameras(ba):  # every object in every camera: free of BA's gauge
        TCW = np.linalg.inv(ba["cameras"].TWC.cpu().numpy().astype(np.float64))
        return TCW[:, None] @ ba["objects"].TWO.cpu().numpy().astype(np.float64)[None]

    e_two = max(float((a["objects"].TWO.cpu() - b["objects"].TWO).abs().max())
                for a, b in zip(mv["bas"], mv_cpu["bas"]))
    e_tco = max(float(np.abs(in_cameras(a) - in_cameras(b)).max())
                for a, b in zip(mv["bas"], mv_cpu["bas"]))
    e_loss = max(abs(a["final_loss"] - b["final_loss"]) / b["final_loss"]
                 for a, b in zip(mv["bas"], mv_cpu["bas"]))
    its = [(a["n_lm_iterations"], b["n_lm_iterations"]) for a, b in zip(mv["bas"], mv_cpu["bas"])]
    log(f"{tag} multiview card vs CPU ({t_cpu:.1f} s on the CPU): matched cand_id, obj_id and "
        f"best view pairs equal: {same_match}; TC1C2 max |diff| {e_tc:.3g} (<= "
        f"{MV_CPU_TC1C2_ATOL}); BA: objects in the cameras' frames {e_tco:.3g} (<= "
        f"{MV_CPU_POSE_ATOL}; in the world frame {e_two:.3g}), final loss {e_loss:.3g} relative "
        f"(<= {MV_CPU_LOSS_RTOL}), LM iterations card/CPU {its}")
    if not same_match or len(mv["bas"]) != len(mv_cpu["bas"]) or e_tc > MV_CPU_TC1C2_ATOL \
            or e_tco > MV_CPU_POSE_ATOL or e_loss > MV_CPU_LOSS_RTOL:
        raise AssertionError("multiview card vs CPU beyond its limits")

    # the CLIs: run_bop_inference --icp, run_cosypose_eval --nviews, run_custom_scenario
    kernel.launches = {k: 0 for k in kernel.launches}
    t0 = time.perf_counter()
    bop_i = run_bop_inference.main(bop_args + ["--icp"])
    torch.cuda.synchronize()
    wall_bi = time.perf_counter() - t0
    launches_icp_cli = dict(kernel.launches)
    preds_i = bop_i["predictions"]
    frames_i = {(s_, v_) for s_, v_ in zip(preds_i["pose"].infos["scene_id"].tolist(),
                                           preds_i["pose"].infos["view_id"].tolist())}
    per_frame_i = {k: 0 for k in frames_i}
    for k in zip(preds_i["pose"].infos["scene_id"].tolist(),
                 preds_i["pose"].infos["view_id"].tolist()):
        per_frame_i[k] += 1
    chunks_i = sum(math.ceil(n / EVAL_BSZ) for n in per_frame_i.values())
    want = {"raster_setup": chunks_i * n_ref + len(frames_i) + ar_groups,
            "raster_resolve": chunks_i * n_ref + len(frames_i) + ar_groups,
            "raster_resolve_attr": 0, "raster_setup_merge": 0,
            "raster_resolve_bin": 0, "raster_resolve_listed": 0}
    sec_i = bop_i["seconds"]
    log(f"{tag} run_bop_inference --dataset procedural --icp ({n_frames_b} val frames, "
        f"{len(preds_i['icp'])} detections): {wall_bi:.2f} s with set-up and metrics, "
        f"{n_frames_b / wall_bi:.2f} frames/s end to end; detection {sec_i['detection']:.2f} s, "
        f"pose {sec_i['pose']:.2f} s, ICP {sec_i['icp']:.2f} s ({n_frames_b / sec_i['icp']:.1f} "
        f"frames/s, {1e3 * sec_i['icp'] / len(frames_i):.2f} ms a group); icp_ok "
        f"{100 * float(np.mean(preds_i['icp'].infos['icp_ok'])):.1f} %; BOP19 AR of "
        f"{bop_i['metrics']['bop19_ar']['prediction_key']} "
        f"{bop_i['metrics']['bop19_ar']['AR']:.4f};"
        f" launches {launches_icp_cli} (want {want}: refiner chunks x {n_ref} + ICP groups + AR "
        f"groups)")
    if launches_icp_cli != want or bop_i["metrics"]["bop19_ar"]["prediction_key"] != "icp" \
            or not torch.isfinite(preds_i["icp"].poses).all():
        raise AssertionError(f"run_bop_inference --icp: launches {launches_icp_cli} (want {want})")

    csv_mv = OUT_DIR / "chip_smoke_noisy_gt.csv"
    kept = noisy_gt_csv(val_b, csv_mv, np.random.RandomState(1))
    t0 = time.perf_counter()
    ev = run_cosypose_eval.main(["--dataset", "synthetic.procedural.val", "--detections",
                                 str(csv_mv), "--refiner", run_m.run_id, "--use-detections-tco",
                                 "--nviews", str(MV_NVIEWS), "--n-refiner-iterations", "0",
                                 "--object-ds", "procedural", "--ds-root", str(DATA_ROOT),
                                 "--exp-dir", str(exp_p), "--out-dir",
                                 str(OUT_DIR / "chip_smoke_cosypose_eval")])
    wall_ev = time.perf_counter() - t0
    mv_keys = sorted(k for k in ev["predictions"] if k.startswith("multiview/"))
    auc = {k: round(ev["metrics"][k]["ADD(-S)_ntop=1"]["AUC"], 4)
           for k in ("external_coarse", "multiview/ba_output") if k in ev["metrics"]}
    log(f"{tag} run_cosypose_eval --use-detections-tco --nviews {MV_NVIEWS} on noisy GT "
        f"({MV_NOISE_T} m, {MV_NOISE_DEG} deg) of {len(kept)} view groups: {wall_ev:.2f} s; keys "
        f"{mv_keys}; {len(ev['predictions']['multiview/ba_output'])} BA reprojections; ADD(-S) "
        f"AUC {auc}")
    if len(mv_keys) != 7 or not kept:
        raise AssertionError(f"run_cosypose_eval --nviews: keys {sorted(ev['predictions'])}")

    scen = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_scenario_", dir=OUT_DIR))
    write_scenario(scen, cands, cams, MV_SCALE["n_labels"])
    t0 = time.perf_counter()
    sc = run_custom_scenario.main(["--scenario", str(scen), "--ba_n_iter", str(MV_BA_ITER)])
    wall_sc = time.perf_counter() - t0
    n_csv = len((scen / "results" / "scene_reprojected.csv").read_text().splitlines()) - 1
    log(f"{tag} run_custom_scenario on the protocol-scale scene ({len(cands)} candidates, "
        f"{MV_SCALE['n_views']} views): {wall_sc:.2f} s with set-up; "
        f"{len(sc['scene']['objects'])} objects, {len(sc['scene']['cameras'])} cameras, "
        f"{n_csv} reprojections after nms3d")
    if not sc["scene"]["objects"] or n_csv <= 0:
        raise AssertionError("run_custom_scenario wrote no scene")
    log(f"phase 9 done at {time.perf_counter() - t_main:.0f} s")

    # -- 10. data parallelism ---------------------------------------------------------
    launches_dp = data_parallel_phase(tag, checked)
    log(f"phase 10 done at {time.perf_counter() - t_main:.0f} s")

    # -- 11. serving export and inspection ---------------------------------------
    launches_sx = serving_export_phase(tag, checked, models[1], db, acc_args, val_depth, db_p)
    log(f"phase 11 done at {time.perf_counter() - t_main:.0f} s")

    # -- 12. the JPEG data path and the depthwise lowerings ---------------------
    launches_jp = jpeg_phase(tag, checked, dict(
        make_cfg=make_cfg, data_root=DATA_ROOT, db_p=db_p, exp_p=exp_p, run_d=run_d,
        run_m=run_m, detection_th=BOP_DETECTION_TH, eval_bsz=EVAL_BSZ))
    log(f"phase 12 done at {time.perf_counter() - t_main:.0f} s")

    # -- 13. the port's headline bench and entry point ---------------------------
    launches_bn = bench_phase(tag, checked)
    log(f"phase 13 done at {time.perf_counter() - t_main:.0f} s")

    # -- 14. soups of any row count -------------------------------------------------
    large = large_soups_phase(tag, checked)
    rows_json.update(large["rows"])
    log(f"phase 14 done at {time.perf_counter() - t_main:.0f} s")

    # -- 15. the MBConv block's depthwise half ------------------------------------
    dw = dw_kernel_phase(tag)
    log(f"phase 15 done at {time.perf_counter() - t_main:.0f} s")

    # -- 16. Mask R-CNN's NMS ------------------------------------------------------
    nms = nms_kernel_phase(tag)
    log(f"phase 16 done at {time.perf_counter() - t_main:.0f} s")

    # -- results --------------------------------------------------------------
    kernels = [dict(name=name, route="cuda", source=SOURCES[name], replaces=REPLACES[name],
                    launches=launches[name], launches_training=launches_train[name],
                    launches_recording=launches_rec[name], launches_evaluation=launches_eval[name],
                    launches_detection_path=launches_det[name], launches_icp=launches_icp[name],
                    launches_icp_cli=launches_icp_cli[name],
                    launches_data_parallel=dict(
                        nccl_world1=launches_dp["nccl_world1"][name],
                        gloo_ranks=[r[name] for r in launches_dp["gloo_ranks"]]),
                    launches_export_call=launches_sx["export"][name],
                    launches_bench_stages=launches_sx["bench_stages"][name],
                    launches_inspection={k: launches_sx[k][name] for k in (
                        "overlays", "scene_renderings", "test_render_objects")},
                    launches_jpeg_training={f"workers_{w}": n[name] for w, n in
                                            launches_jp["training"].items()},
                    launches_jpeg_bop=launches_jp["bop"][name],
                    launches_dw_lowerings=launches_jp["dw"][name],
                    launches_bench={arm: n.get(name, 0) for arm, n in launches_bn["bench"].items()},
                    launches_entry=launches_bn["entry"][name],
                    launches_large_soups=large["launches"][name],
                    launches_ycbv_recording=large["recording"][name],
                    checked_at=checked[name],
                    **{"library_ms": None, **rows_json[name]})
               for name in SOURCES]
    # the depthwise kernel: its launches on each path that runs an eval B3
    # (held to B3_BLOCKS a call there), then phase 15's numbers
    kernels.append(dict(**dw, launches=dw_launches["serving"],
                        launches_slice=dw_launches["slice"],
                        launches_export_call=launches_sx["dw_export"],
                        launches_export_fresh_process=launches_sx["dw_fresh"],
                        launches_dw_lowerings=launches_jp["dw_bn_silu_squeeze"],
                        launches_bench={arm: n["dw_bn_silu_squeeze"]
                                        for arm, n in launches_bn["bench"].items()},
                        launches_entry=launches_bn["dw_entry"]))
    # Mask R-CNN's NMS: phase 16's numbers at the RPN's call, the box head's beside
    kernels.append(nms)
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
