"""Driver of `train_items` mixes: the port's training path as train_pose runs
it, without epochs, checkpoints or evaluation: make_loader over the mix's
seeded items with the configuration's loader workers, the step's random
numbers drawn on the host, then the step of make_train_step, step after step.

Set-up builds the one train state (the harness's weights loaded into it, its
step count at the end of the warm-up, so the update runs at the schedule's
plateau lr), and drives it through the first `check_steps` steps through the
window's own loader and call; their losses, the optimizer's first moments
after step 1 and the parameters after the last are kept. The window goes on
with the same state and loader and ends in a synchronize. After it, the plain
reference runs the same steps from the same weights, items and draws.
"""

from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np
import torch

from benchmark.harness import counts, generate, scene
from benchmark.harness.cli import Outcome, Run, stage
from benchmark.harness.drivers.frames import load_weights
from benchmark.harness.trace import Spans, profile
from benchmark.reference import efficientnet as ref_net
from benchmark.reference import serve as ref_serve
from benchmark.reference import train as ref_train

CALIBRATION_BASE = 10 ** 8  # item indices of the weights' calibration batch


def train_config(cfg: dict):
    """The port's PoseTrainConfig: make_cfg(cfg['run_config']) with the sizes
    the configuration file states."""
    from cosypose_tpu_torch.training.configs import make_cfg

    t = make_cfg(cfg["run_config"]).train
    pred = dataclasses.replace(t.predictor, backbone=cfg["backbone"],
                               render_size=tuple(cfg["render_size"]),
                               n_points_crop=cfg["n_points_crop"], lamb=cfg["lamb"],
                               compute_dtype=getattr(torch, cfg["compute_dtype"]),
                               raster_max_tris_per_tile=cfg["raster_max_tris_per_tile"])
    return dataclasses.replace(t, predictor=pred, batch_size=cfg["batch_size"],
                               n_iterations=cfg["train_iterations"], lr=cfg["lr"],
                               clip_grad_norm=cfg["clip_grad_norm"],
                               n_points_loss=cfg["n_points_loss"],
                               noise_euler_deg=tuple(cfg["noise_euler_deg"]),
                               noise_trans=tuple(cfg["noise_trans"]))


def collate_items(items: list, labels: list) -> dict:
    """The reference's own batch of items (object indices for labels)."""
    return dict(images=torch.as_tensor(np.stack([it["image"] for it in items])),
                K=torch.as_tensor(np.stack([it["K"] for it in items])),
                TCO=torch.as_tensor(np.stack([it["TCO"] for it in items])),
                labels=torch.as_tensor([labels.index(it["label"]) for it in items]))


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        control=None, faults=None, all_checks: bool = False) -> Outcome:
    """One run; `control` ('tf32') compares the reference computed with TF32
    on as well; `faults` (tests only) breaks the state or the step after
    set-up: faults(state, step_fn) -> step_fn."""
    from cosypose_tpu_torch.ops.mesh_db import MeshSpec, build_mesh_db
    from cosypose_tpu_torch.training.pose_training import create_train_state, make_train_step
    from cosypose_tpu_torch.training.train_pose import make_loader

    cfg, mix, wl = cell.config, cell.traffic, cell.workload
    cuda = torch.device(device).type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = cfg["tf32"]
    torch.backends.cudnn.allow_tf32 = cfg["tf32"]
    tcfg = train_config(cfg)
    B = tcfg.batch_size

    stage(t_start, "imports")
    meshes = scene.meshes(cfg)
    labels = [m["label"] for m in meshes]
    sym_objects = set(cfg["z_symmetric_objects"])
    items = generate.TrainItems(mix, cfg, seed)
    t_ref = time.perf_counter()
    objects = ref_serve.Objects(meshes, cfg["render_faces"], cfg["n_points_crop"], device)
    ref_s = time.perf_counter() - t_ref  # the reference's own decimation: no set-up of the port
    cal = collate_items([items[CALIBRATION_BASE + k] for k in range(cfg["calibration_batch"])],
                        labels)
    x_cal = ref_serve.first_inputs(objects, cal["images"].to(device).float() / 255.0,
                                   cal["K"].to(device), cal["labels"].to(device), cfg,
                                   T=cal["TCO"].to(device))
    weights = scene.make_weights(cfg, seed, "refiner", x_cal)
    del x_cal
    stage(t_start, "meshes, reference objects, weights")
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    specs = [MeshSpec(label=m["label"], vertices=m["verts"], faces=m["faces"], colors=m["colors"],
                      symmetries_continuous=[{"axis": [0, 0, 1], "offset": [0, 0, 0]}]
                      if k in sym_objects else None) for k, m in enumerate(meshes)]
    db = build_mesh_db(specs, device=device)
    state = create_train_state(tcfg, device)
    load_weights(state.pp.net, weights)
    # the count at the end of the warm-up epochs: the schedule's plateau lr
    state.step = tcfg.n_epochs_warmup * max(1, tcfg.epoch_size // tcfg.batch_size)
    step_fn = make_train_step(tcfg, db)
    if faults is not None:
        step_fn = faults(state, step_fn)
    order = generate.SeededOrder(len(items), seed)
    loader = make_loader(items, order, B, cfg["loader_workers"], cuda)
    batches = iter(loader)
    stage(t_start, "mesh database, train state, loader")
    draw_gen = torch.Generator().manual_seed(scene.stream(seed, "draws"))
    keep = ref_net.drop_keep_rates(cfg["backbone"])
    n_points = db.points.shape[1]

    def device_batch(batch):
        return dict(images=batch["images"].to(device, non_blocking=True),
                    K=batch["K"].to(device, non_blocking=True),
                    TCO=batch["TCO"].to(device, non_blocking=True),
                    bboxes=batch["bboxes"].to(device, non_blocking=True),
                    label_ids=db.ids_for(batch["labels"]))

    def step(spans=None):
        t0 = time.perf_counter()
        batch = next(batches)
        wait = time.perf_counter() - t0
        draws = generate.train_draws(B, n_points, tcfg.n_points_loss, keep, tcfg.n_iterations,
                                     draw_gen)
        if spans is None:
            metrics = step_fn(state, device_batch(batch), draws)
        else:
            with spans.span("step"):
                metrics = step_fn(state, device_batch(batch), draws)
        return wait, draws, metrics

    # the first steps, kept for the check
    n_check = wl["check_steps"]
    kept_draws, kept_losses, kept_norms = [], [], []
    for k in range(n_check):
        _, draws, metrics = step()
        kept_draws.append(draws)
        kept_losses.append(metrics["loss_total"])
        kept_norms.append(metrics["grad_norm"])
        if k == 0:
            # an optimizer that holds no moment got no gradient
            first_moment = {n: state.optimizer.state[p].get("exp_avg", torch.zeros_like(p)).clone()
                            for n, p in state.net.named_parameters()}
    after = {n: p.detach().clone() for n, p in state.net.named_parameters()}
    losses = [float(x) for x in kept_losses]
    stage(t_start, f"{n_check} steps")

    spans = Spans(device) if trace else None
    prof = None
    if trace:
        # the card's busy time over steady steps, before any wrapper
        prof = profile(lambda: [step() for _ in range(wl["profiled_steps"])], device)
        from cosypose_tpu_torch.models import pose_predictor as pp_mod

        faces = []

        def on_render(tri_verts, tri_valid, TCO, K, image_size=(240, 320), **_):
            spans.count("render_rows", tri_verts.shape[0])
            spans.count("render_pixels", tri_verts.shape[0] * image_size[0] * image_size[1])
            faces.append(tri_valid.sum())

        spans.wrap(pp_mod, "render", "render", before=on_render)
        detail = profile(lambda: [step(spans) for _ in range(wl["detailed_steps"])], device,
                         host=True)
        prof.update(render_kernel_s=detail["render_kernel_s"], gaps=detail["gaps"],
                    counters=dict(spans.counters),
                    render_faces=int(sum(int(f) for f in faces)))
        spans.counters.clear()
        spans.open.clear()
        stage(t_start, "profiled stretch")

    setup_s = time.perf_counter() - t_start - ref_s
    waits, n_steps = [], 0
    t_w0 = time.perf_counter()
    while True:
        wait, _, metrics = step(spans)
        waits.append(wait)
        n_steps += 1
        if time.perf_counter() - t_w0 >= seconds:
            break
    final_loss = float(metrics["loss_total"])  # waits for the last step
    window_s = time.perf_counter() - t_w0
    span_ms = spans.ms() if trace else {}
    if trace:
        spans.unwrap()
        span_ms["data_wait"] = [1e3 * w for w in waits]
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    print(f"{n_steps} steps of {B} in {window_s:.3f} s, data wait {1e3 * np.mean(waits):.3f} "
          f"ms a step, first losses {losses}, last {final_loss:.6f}; set-up {setup_s:.3f} s",
          flush=True)

    end_workers(batches)
    del batches, loader, step_fn, state, db
    if cuda:
        torch.cuda.empty_cache()

    steps = [(collate_items([items[i] for i in ids], labels), d) for ids, d in
             zip(batch_ids(order, B, n_check), kept_draws)]
    syms = [ref_train.symmetries(k in sym_objects, cfg["n_symmetries"], device)
            for k in range(len(meshes))]
    prog = dict(loss=losses, grads={n: m / (1 - cfg["adam_betas"][0])
                                    for n, m in first_moment.items()},
                change={n: after[n] - weights[n] for n in after})

    def reference(tf32: bool):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            r = ref_train.train_steps(weights, cfg["backbone"], objects, syms, steps, cfg)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = cfg["tf32"]
            torch.backends.cudnn.allow_tf32 = cfg["tf32"]
        return dict(loss=r["loss"], grads=r["grads"], grad_norms=r["grad_norms"],
                    change={n: r["params"][n] - weights[n] for n in r["params"]})

    ref = reference(cfg["tf32"])
    checks = compare(prog, ref)
    control_readings = compare(reference(True), ref) if control == "tf32" else None

    flops = counts.network_flops(cfg["backbone"], tuple(cfg["render_size"]), True)
    totals = dict(steps=n_steps, useful_flops=n_steps * B * tcfg.n_iterations * flops,
                  peak_flops=counts.PEAK_FLOPS[cfg["compute_dtype"]], memory_peak_bytes=peak,
                  control=control_readings,
                  detail=dict(loss_program=prog["loss"], loss_reference=ref["loss"],
                              grad_norm_program=[float(x) for x in kept_norms],
                              grad_norm_reference=ref["grad_norms"],
                              worst_leaf=worst_leaf(prog["grads"], ref["grads"])))
    run_rec = Run(config=cfg, window_s=window_s, spans=span_ms, counters={}, profile=prof,
                  totals=totals)
    e2e = {"setup_s": setup_s, "train_samples_per_s": n_steps * B / window_s}
    return Outcome(end_to_end=e2e, run=run_rec, attempted=n_steps, failed=0,
                   checks=[(k, v, wl["limits"].get(k)) for k, v in checks.items()
                           if all_checks or k in wl["limits"]],
                   memory_peak_bytes=int(peak))


def end_workers(batches) -> None:
    """End the loader's worker processes and wait for each. A worker that
    aborts while it exits ("terminate called without an active exception",
    a few runs in a hundred on the card) has ended all the same: the loader
    then raises from its SIGCHLD handler, after it has stopped watching its
    workers and terminated any left."""
    if not hasattr(batches, "_shutdown_workers"):  # no worker processes
        return
    try:
        batches._shutdown_workers()
    except RuntimeError as e:
        print(f"a loader worker ended abnormally at shutdown: {e}", file=sys.stderr)
    for w in batches._workers:
        w.join(timeout=10)


def worst_leaf(prog: dict, ref: dict) -> list:
    """[name, program norm, reference norm] of the leaf of widest gap."""
    gaps = ref_train.leaf_gaps(prog, ref)
    k = list(ref)[int(np.argmax(gaps))]
    return [k, float(prog[k].double().norm()), float(ref[k].double().norm())]


def batch_ids(order, batch: int, n: int) -> list:
    ids = list(order)
    return [ids[k * batch:(k + 1) * batch] for k in range(n)]


def compare(prog: dict, ref: dict) -> dict:
    """The loss's relative gap at the first step (`loss1_gap`) and at the
    worst step; the gaps of the first gradient's leaf norms and of the
    parameters' change after the steps, each leaf's against the reference's
    norm or the median leaf's, whichever is larger, over the median leaf
    (`grad_med_gap`, `update_med_gap`) and the worst (`grad_gap`,
    `update_gap`); the change only over leaves whose reference gradient is at
    least a thousandth of the median leaf's."""
    gaps = [abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"])]
    g = ref_train.leaf_gaps(prog["grads"], ref["grads"])
    u = ref_train.leaf_gaps(prog["change"], ref["change"], ref["grads"])
    return {"loss1_gap": gaps[0], "loss_gap": max(gaps),
            "grad_med_gap": float(np.median(g)), "grad_gap": max(g),
            "update_med_gap": float(np.median(u)), "update_gap": max(u)}
