"""Driver of `detect` mixes: one client in a closed loop sends one frame a
request to Detector.get_detections(..., output_masks=True), the port's
detection entry, with the configuration's Mask R-CNN, and waits for the
boxes, labels, scores and masks on the host (the masks copied into a pinned
buffer that every request reuses).

The frames are the `frames` generator's (harness/generate.py), with the
mix's objects. Set-up: the model, the NMS kernel's build at its first call,
and warm requests with the mask head at every count of detections a frame
can have. The weights, the plain reference's `seeded_weights` calibrated on
seeded frames, are the reference's work and their seconds are left out of
`setup_s`, as the frames driver leaves out the reference's decimation.

Traced runs profile a stretch of requests as they run untraced, then a
shorter one with the harness's wrappers (the model's `features`,
`region_proposals`, `detect` and `segment`, and the NMS calls, whose sizes
give the kernel's bytes) and the host's ops, then run the window with
CUDA-event spans around the layers.

After the window a seeded sample of the finished requests (with the one of
most detections) runs again with the model's record of every stage. Its
served answers must equal the window's (`served_gap`, exact), and each stage
is held against the plain reference run from the program's own input to it:
features and RPN outputs (`feat_rel`), the proposals (`proposals_gap`,
exact), the box head's logits and deltas on the program's proposals
(`box_rel`), the detections from the program's box-head outputs
(`detections_gap`, exact), the mask logits on the program's detections
(`mask_rel`), and the pasted masks at 0.5 (`paste_px_share`, a share of the
pixels inside either mask).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness import counts, detect_counts, generate, scene
from benchmark.harness.cli import Outcome, Run, stage
from benchmark.harness.trace import Spans, profile
from benchmark.reference import efficientnet as ref_net
from benchmark.reference import maskrcnn as ref_mrcnn

WARM_BASE = 10 ** 6
PROFILE_BASE = 2 * 10 ** 6
CALIBRATION_BASE = 3 * 10 ** 6
SETTING_KEYS = ("anchor_sizes", "aspect_ratios", "rpn_pre_nms_top_n", "rpn_post_nms_top_n",
                "rpn_nms_thresh", "rpn_min_size", "box_score_thresh", "box_nms_thresh",
                "box_detections_per_img", "box_min_size", "frozen_bn_eps", "n_classes")


def settings(cfg: dict) -> dict:
    """The reference's settings from the configuration."""
    s = {k: tuple(cfg[k]) if isinstance(cfg[k], list) else cfg[k] for k in SETTING_KEYS}
    return dict(s, min_size=min(cfg["input_resize"]), max_size=max(cfg["input_resize"]))


def make_model(cfg: dict, weights: dict, device):
    from cosypose_tpu_torch.models.mask_rcnn import MaskRCNN, MaskRCNNConfig

    fields = {k: tuple(cfg[k]) if isinstance(cfg[k], list) else cfg[k]
              for k in ("backbone_str", "input_resize") + SETTING_KEYS}
    model = MaskRCNN(MaskRCNNConfig(**fields, compute_dtype=getattr(torch, cfg["compute_dtype"])))
    model = model.to(device).eval()
    missing, unexpected = model.load_state_dict(weights, strict=False)
    if missing or unexpected:
        raise KeyError(f"weights do not fit the model: missing {missing}, "
                       f"unexpected {unexpected}")
    return model


def rel(a, b) -> float:
    return float((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30))


def by_image(t: torch.Tensor, ids: torch.Tensor, n: int) -> list:
    return [t[ids == b] for b in range(n)]


def exact_gap(pairs) -> float:
    """The widest gap of (program, reference) tensor pairs; inf where the
    counts differ."""
    gap = 0.0
    for a, b in pairs:
        if a.shape != b.shape:
            return float("inf")
        if a.numel():
            gap = max(gap, float((a.double() - b.double()).abs().max()))
    return gap


def stage_checks(p: dict, rec: dict, out: dict, s: dict, quant=None) -> dict:
    """Each stage of one recorded call against the plain reference (under
    `quant`, the control) started from the program's input to it."""
    B = rec["x"].shape[0]
    hw, feats = rec["image_hw"], [f.float() for f in rec["features"]]
    ref_feats = ref_mrcnn.features(p, rec["x"], s["frozen_bn_eps"], quant)
    logits, deltas = ref_mrcnn.rpn_head(p, feats, quant)
    feat_rel = max(rel(a, b) for a, b in zip(rec["features"] + rec["logits"] + rec["deltas"],
                                             ref_feats + logits + deltas))
    del ref_feats
    anc = ref_mrcnn.anchors([f.shape[-2:] for f in feats], rec["x"].shape[-2:], s["anchor_sizes"],
                            s["aspect_ratios"], rec["x"].device)
    props = ref_mrcnn.filter_proposals([t.float() for t in rec["logits"]],
                                       [t.float() for t in rec["deltas"]], anc, hw, s)
    mine = by_image(rec["proposals"], rec["proposal_ids"], B)
    proposals_gap = exact_gap(zip(mine, [b for b, _ in props]))
    cls, box = ref_mrcnn.box_head(p, feats, mine, hw, quant)
    box_rel = max(rel(rec["class_logits"], cls), rel(rec["box_deltas"], box))
    d = rec["detections"]
    dets = ref_mrcnn.postprocess(rec["class_logits"], rec["box_deltas"], mine, hw, s)
    got = [[t[d["image_ids"] == b] for t in (d["boxes"], d["scores"], d["labels"])]
           for b in range(B)]
    detections_gap = exact_gap((g[k], r[k]) for g, r in zip(got, dets) for k in range(3))
    out_checks = dict(feat_rel=feat_rel, proposals_gap=proposals_gap, box_rel=box_rel,
                      detections_gap=detections_gap)
    if "mask_logits" in rec and len(d["boxes"]):
        masks = ref_mrcnn.mask_head(p, feats, by_image(d["boxes"], d["image_ids"], B), hw, quant)
        out_checks["mask_rel"] = rel(rec["mask_logits"], masks)
        pasted = ref_mrcnn.paste_masks(out["mask_probs"], out["boxes"], out["masks"].shape[-2:])
        a, b = pasted > 0.5, out["masks"] > 0.5
        out_checks["paste_px_share"] = float((a != b).sum()) / max(int((a | b).sum()), 1)
    return out_checks


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        control=None, faults=None, all_checks: bool = False) -> Outcome:
    """One run. `control` ('fp8'), where given, reads the control's numbers
    too (totals['control']); `faults` (tests and readings) breaks the model
    after set-up; `all_checks` reports every number compared."""
    from cosypose_tpu_torch.integrated.detector import Detector
    from cosypose_tpu_torch.ops import nms_cuda

    cfg, mix, wl = cell.config, cell.traffic, cell.workload
    cuda = torch.device(device).type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = cfg["tf32"]
    torch.backends.cudnn.allow_tf32 = cfg["tf32"]
    s = settings(cfg)

    stage(t_start, "imports")
    frames = generate.FrameRequests(mix, cfg, seed, scene.meshes(mix["objects"]), device)
    t_ref = time.perf_counter()
    calib = torch.cat([frames(CALIBRATION_BASE + k).image for k in range(cfg["calibration_frames"])])
    gen = torch.Generator(device=device).manual_seed(scene.stream(seed, "weights", "maskrcnn"))
    weights = ref_mrcnn.seeded_weights(cfg["n_classes"], gen, calib, s, **cfg["weights"])
    del calib
    if cuda:
        torch.cuda.synchronize()
    # the reference's calibration of the seeded weights: no set-up of the port
    ref_s = time.perf_counter() - t_ref
    stage(t_start, "weights")
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    model = make_model(cfg, weights, device)
    labels = {f"obj_{k:06d}": k for k in range(1, cfg["n_classes"])}
    detector = Detector(model, labels)
    stage(t_start, "model")
    if faults is not None:
        faults(model)

    # the client's host copy of a frame's masks: one pinned buffer for every
    # request, as a serving loop keeps it (a fresh pageable tensor a request
    # faults in its pages each time, which set the pace of the copy)
    masks_host = torch.empty((cfg["box_detections_per_img"], *cfg["image_size"]),
                             dtype=torch.bool, pin_memory=cuda)

    def send(i: int):
        fr = frames(i)
        t0 = time.perf_counter()
        out = detector.get_detections(fr.image, output_masks=True, mask_th=cfg["mask_th"])
        masks = masks_host[:len(out)].copy_(out.masks)
        answer = (out.bboxes.cpu(), out.infos["label"], out.infos["score"], masks)
        return time.perf_counter() - t0, answer

    for k in range(3):
        send(WARM_BASE + k)
    # the mask head at every count of detections a frame can have
    with torch.inference_mode():
        feats = model.features(model.transform(frames(WARM_BASE).image)[0])
        hw = tuple(cfg["image_size"])
        box = torch.tensor([[100.0, 100.0, 300.0, 260.0]], device=device)
        for n in range(1, cfg["box_detections_per_img"] + 1):
            det = dict(boxes=box.expand(n, 4), image_ids=torch.zeros(n, dtype=torch.long,
                                                                      device=device),
                       labels=torch.ones(n, dtype=torch.long, device=device))
            model.segment(feats, det, hw, hw, det["boxes"])
        del feats
    stage(t_start, "warm requests")

    spans = Spans(device) if trace else None
    prof = None
    if trace:
        n_prof = wl["profiled_requests"]
        prof = profile(lambda: [send(PROFILE_BASE + k) for k in range(n_prof)], device)
        spans.wrap(model, "features", "det_backbone", before=lambda x: spans.count("frames"))
        spans.wrap(model, "region_proposals", "rpn")
        spans.wrap(model, "detect", "box_head",
                   before=lambda f, props, *a: spans.count("proposals", len(props)))
        spans.wrap(model, "segment", "mask",
                   before=lambda f, det, *a: spans.count("detections", len(det["labels"])))

        def on_nms(boxes, offsets, *a, **k):
            spans.count("nms_calls")
            spans.count("nms_bytes", detect_counts.nms_bytes(boxes.shape[0],
                                                             offsets.shape[0] - 1))

        spans.wrap(nms_cuda, "nms_sorted", "nms", before=on_nms)
        detail = profile(lambda: [send(PROFILE_BASE + n_prof + k)
                                  for k in range(wl["detailed_requests"])], device, host=True)
        nms_s = sum(t for name, (t, _) in detail["kernels"].items() if "nms_kernel" in name)
        prof.update(gaps=detail["gaps"], nms_kernel_s=nms_s, counters=dict(spans.counters))
        spans.counters.clear()
        spans.open.clear()
        stage(t_start, "profiled stretch")

    setup_s = time.perf_counter() - t_start - ref_s
    lat, n_det, kept, failed = [], [], {}, 0
    t_w0 = time.perf_counter()
    i = 0
    while True:
        try:
            dt, answer = send(i)
            lat.append(dt)
            n_det.append(len(answer[0]))
            boxes, lab, score, masks = answer
            pixels = np.count_nonzero(masks.flatten(1).numpy(), axis=1)
            kept[i] = (boxes, lab, score, torch.as_tensor(pixels))
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
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    # the sample again, with the record of every stage
    done = sorted(kept)
    rng = np.random.RandomState(scene.stream(seed, "check") % 2 ** 32)
    longest = max(done, key=lambda k: len(kept[k][0]))
    pick = sorted({longest, *rng.choice(done, size=min(len(done), wl["check_requests"]) - 1,
                                        replace=False).tolist()})
    checks = {"served_gap": 0.0}
    control_readings = {} if control else None
    quant = ref_net.fp8_quant if control == "fp8" else None
    for k in pick:
        rec = {}
        out = model(frames(k).image, masks=True, record=rec)
        boxes, lab, score, pixels = kept[k]
        again = (out["boxes"].cpu(), out["scores"].cpu(), (out["masks"] > cfg["mask_th"]).flatten(1)
                 .sum(1).cpu())
        gap = exact_gap([(again[0], boxes), (again[1], torch.as_tensor(score)),
                         (again[2], pixels)])
        if [f"obj_{int(c):06d}" for c in out["labels"]] != list(lab):
            gap = float("inf")
        checks["served_gap"] = max(checks["served_gap"], gap)
        for name, v in stage_checks(weights, rec, out, s).items():
            checks[name] = max(checks.get(name, 0.0), v)
        if quant is not None:
            for name, v in stage_checks(weights, rec, out, s, quant).items():
                control_readings[name] = max(control_readings.get(name, 0.0), v)
        del rec, out
    del kept, model, detector
    if cuda:
        torch.cuda.empty_cache()

    totals = dict(requests=len(lat), detections=sum(n_det), control=control_readings,
                  peak_flops=counts.PEAK_FLOPS[cfg["compute_dtype"]],
                  detections_per_frame=[int(np.min(n_det)), float(np.median(n_det)),
                                        int(np.max(n_det))] if n_det else None)
    if trace and counters.get("frames"):
        padded = [-(-x // 32) * 32 for x in cfg["image_size"]]
        totals["useful_flops"] = detect_counts.useful_flops(
            counters["frames"], counters["proposals"], counters["detections"], padded,
            cfg["n_classes"])
    lat_ms = sorted(1e3 * x for x in lat)
    q = np.percentile(lat_ms, [50, 95]) if lat_ms else [float("nan")] * 2
    print(f"{len(lat)} requests, {failed} failed, {sum(n_det)} detections in {window_s:.3f} s "
          f"(a frame: {totals['detections_per_frame']}); latency median {q[0]:.3f} ms, "
          f"p95 {q[1]:.3f} ms; set-up {setup_s:.3f} s", flush=True)
    e2e = {"setup_s": setup_s, "frame_ms_p95": float(q[1])}
    run_rec = Run(config=cfg, window_s=window_s, spans=span_ms, counters=counters,
                  profile=prof, totals=totals)
    return Outcome(end_to_end=e2e, run=run_rec, attempted=len(lat) + failed, failed=failed,
                   checks=[(k, v, wl["limits"].get(k)) for k, v in checks.items()
                           if all_checks or k in wl["limits"]],
                   memory_peak_bytes=int(peak))
