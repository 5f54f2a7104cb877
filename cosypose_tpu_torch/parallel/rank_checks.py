"""A rank's side of the multi-process checks of data parallelism.

tests/test_torch_port_distributed.py (gloo, on the CPU) and chip_smoke.py
(phase 10, on the card) spawn ranks with `parallel.spawn` and these
functions as targets: a spawned child imports the module of its target, so
they live here, beside the code they check, and import nothing of the tests.
Each takes (rank, world, device, case) and returns host data (numpy arrays,
CPU tensors, floats) for the caller to hold against one process's results.
"""

from __future__ import annotations

import pathlib
import time

import numpy as np
import torch
import torch.distributed as dist

from ..models.efficientnet import BatchNorm2d, global_batch_stats
from ..ops import rasterizer_cuda as rc
from ..ops.mesh_db import MeshSpec, build_mesh_db
from ..training import detector_training as tdt
from ..training import pose_training as tpt
from ..utils.device import synchronize
from ..utils.distributed import reduce_dict
from .ddp import gather_to_host, rank_rows, shard_batch, whole


def _float32() -> None:
    """The checks hold float32 steps against float32 references: TF32 off in
    this rank, as the spawning process sets it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _host(t: torch.Tensor) -> torch.Tensor:
    """The whole of a tensor (a DTensor gathered: every rank calls) on the CPU."""
    return whole(t).detach().cpu().clone()


def adam_updates(net, optimizer) -> dict:
    """By parameter name, the step Adam took in its last update as its
    moments give it, lr·m̂/(√v̂ + eps) (AdamW's decay aside), whole (every
    rank calls under FSDP), float32 on the parameter's device. Two runs'
    parameters differ by at most the sum over the steps of their updates'
    difference."""
    group = optimizer.param_groups[0]
    b1, b2 = group["betas"]
    out = {}
    for n, p in net.named_parameters():
        st = optimizer.state[p]
        t = float(st["step"])
        m, v = whole(st["exp_avg"]).detach(), whole(st["exp_avg_sq"]).detach()
        out[n] = group["lr"] * (m / (1 - b1 ** t)) / ((v / (1 - b2 ** t)).sqrt() + group["eps"])
    return out


def _snapshot(net, optimizer, rank: int, keep: tuple) -> dict:
    """The net's state dict, gradients, Adam moments and Adam's update
    (adam_updates) by parameter name, whole, on rank 0 (the others gather
    alongside and keep a checksum)."""
    out = {}
    if "grads" in keep:
        out["grads"] = {n: _host(p.grad) for n, p in net.named_parameters()}
    if "moments" in keep:
        for k in ("exp_avg", "exp_avg_sq"):
            out[k] = {n: _host(optimizer.state[p][k]) for n, p in net.named_parameters()}
    if "updates" in keep:
        out["updates"] = {n: u.cpu() for n, u in adam_updates(net, optimizer).items()}
    out["state_dict"] = {k: _host(v) for k, v in net.state_dict().items()}
    if rank:
        return {"checksum": {k: float(sum(v.double().sum() for v in d.values()))
                             for k, d in out.items()}}
    return out


def pose_steps(rank: int, world: int, device: torch.device, case: dict) -> dict:
    """Data-parallel pose train steps over `case`: cfg (PoseTrainConfig),
    specs (MeshSpec fields) and render_max_faces, param_mode, init (a net
    state dict, or None for the seeded init), batch (the global batch as
    numpy arrays), draws (the global draws of each step), before (per step,
    None or {"state_dict", "exp_avg", "exp_avg_sq"} loaded before it), keep
    (what each step's snapshot holds besides the state dict: "grads",
    "moments", "updates"), timed_steps (that many more steps after them on
    the draws in turn, timed only), checkpoint_dir (save_checkpoint there
    after the steps, and restore it into a fresh state), profile (one more
    step under torch.profiler after them). Returns each step's metrics,
    snapshot and host seconds (to the device's end), the raster kernels'
    launches in the compared steps, the timed steps' host seconds, with
    checkpoint_dir the saved file and whether the restored state equals the
    saved one, and with profile the profiled step's ms and the host
    milliseconds the profiler records in the collectives."""
    _float32()
    cfg = case["cfg"]
    db = build_mesh_db([MeshSpec(**s) for s in case["specs"]],
                       render_max_faces=case.get("render_max_faces"), device=device)
    state = tpt.create_train_state(cfg, device, param_mode=case["param_mode"])
    if case.get("init") is not None:
        state.dp.load_state_dict(case["init"])
    step = tpt.make_train_step(cfg, db)
    batch = {k: torch.as_tensor(v).to(device) for k, v in shard_batch(case["batch"], rank,
                                                                      world).items()}
    batch["label_ids"] = batch["label_ids"].long()
    launches = dict(rc.RASTER_KERNEL.launches)
    out = []
    for i, draws in enumerate(case["draws"]):
        before = (case.get("before") or [None] * len(case["draws"]))[i]
        if before is not None:
            state.pp.net.load_state_dict(before["state_dict"])
            if i:
                for n, p in state.pp.net.named_parameters():
                    state.optimizer.state[p]["exp_avg"].copy_(before["exp_avg"][n])
                    state.optimizer.state[p]["exp_avg_sq"].copy_(before["exp_avg_sq"][n])
        t0 = time.perf_counter()
        metrics = step(state, batch, tpt.shard_draws(draws, rank, world))
        synchronize(device)
        seconds = time.perf_counter() - t0
        out.append(dict(metrics={k: float(v) for k, v in metrics.items()}, step=state.step,
                        seconds=seconds,
                        **_snapshot(state.pp.net, state.optimizer, rank, case.get("keep", ()))))
    launches = {k: v - launches[k] for k, v in rc.RASTER_KERNEL.launches.items()}
    timed = []
    for i in range(case.get("timed_steps", 0)):
        t0 = time.perf_counter()
        step(state, batch, tpt.shard_draws(case["draws"][i % len(case["draws"])], rank, world))
        synchronize(device)
        timed.append(time.perf_counter() - t0)
    result = dict(steps=out, launches=launches, timed_seconds=timed)
    if case.get("checkpoint_dir") is not None:
        from ..training.checkpoint import load_checkpoint, restore_into_state, save_checkpoint

        path = save_checkpoint(case["checkpoint_dir"], state, 0)
        fresh = tpt.create_train_state(cfg, device, param_mode=case["param_mode"])
        restore_into_state(fresh, load_checkpoint(path))

        def tensors(st):
            return [*st.pp.net.state_dict().values(),
                    *(st.optimizer.state[p][k] for p in st.pp.net.parameters()
                      for k in ("step", "exp_avg", "exp_avg_sq"))]

        same = fresh.step == state.step and all(
            torch.equal(_host(a), _host(b)) for a, b in zip(tensors(state), tensors(fresh)))
        result["checkpoint"] = dict(path=path, restored_equal=same)
    if case.get("profile"):
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU]) as prof:
            t0 = time.perf_counter()
            step(state, batch, tpt.shard_draws(case["draws"][0], rank, world))
            synchronize(device)
            seconds = time.perf_counter() - t0
        result["profile"] = dict(step_ms=1e3 * seconds, collectives_ms={
            e.key: e.cpu_time_total / 1e3 for e in prof.key_averages()
            if "all_reduce" in e.key or "allreduce" in e.key})
    return result


def batchnorm(rank: int, world: int, device: torch.device, case: dict) -> dict:
    """One train-mode forward and backward of a BatchNorm2d over this rank's
    rows of case's x (N,C,H,W), with the global batch's statistics: the loss
    is sum(dy · y) over the global batch. Returns this rank's y and dx, its
    part of the weight and bias gradients, and the running statistics."""
    _float32()
    x = torch.as_tensor(case["x"])[rank_rows(len(case["x"]), rank, world)].to(device)
    dy = torch.as_tensor(case["dy"])[rank_rows(len(case["dy"]), rank, world)].to(device)
    bn = BatchNorm2d(x.shape[1], eps=case["eps"], flax_momentum=case["momentum"]).to(device)
    with torch.no_grad():
        for k in ("weight", "bias", "running_mean", "running_var"):
            getattr(bn, k).copy_(torch.as_tensor(case[k]))
    global_batch_stats(bn, dist.group.WORLD)
    bn.train()
    x.requires_grad_(True)
    y = bn(x)
    (y * dy).sum().backward()
    return dict(y=_host(y), dx=_host(x.grad), dweight=_host(bn.weight.grad),
                dbias=_host(bn.bias.grad), running_mean=_host(bn.running_mean),
                running_var=_host(bn.running_var))


def detector_step(rank: int, world: int, device: torch.device, case: dict) -> dict:
    """One data-parallel detector train step from case's init state dict on
    this rank's rows of case's global batch. Returns the metrics and the
    step's snapshot (state dict and gradients)."""
    _float32()
    cfg = case["cfg"]
    state = tdt.create_detector_train_state(cfg, device, param_mode=case["param_mode"])
    state.dp.load_state_dict(case["init"])
    batch = {k: torch.as_tensor(v).to(device) for k, v in shard_batch(case["batch"], rank,
                                                                      world).items()}
    metrics = tdt.make_detector_train_step(cfg)(state, batch)
    return dict(metrics={k: float(v) for k, v in metrics.items()}, step=state.step,
                **_snapshot(state.net, state.optimizer, rank, ("grads",)))


def gathers(rank: int, world: int, device: torch.device, case: dict) -> dict:
    """reduce_dict of rank-dependent numbers; TensorCollection's
    gather_distributed (padded to case's n_rows) and gather_multihost of this
    rank's rows of case's collection (those with view_id % world == rank);
    the meters' gather_multihost with its default process id and count.
    Returns what each gives on this rank."""
    from ..evaluation import meters as tm
    from ..evaluation import table
    from ..utils.tensor_collection import TensorCollection

    out = dict(reduce=reduce_dict({"a": rank + 1.0, "b": 10.0 * rank, "c": 0.5}),
               reduce_sum=reduce_dict({"a": rank + 1.0}, average=False),
               gather_to_host=gather_to_host(
                   {"x": torch.arange(6.0, device=device).reshape(2, 3) + 6 * rank}))
    infos, poses = case["collection"]
    own = np.flatnonzero(infos["view_id"] % world == rank)
    tc = TensorCollection(table.take(infos, own), poses=torch.as_tensor(poses[own]).to(device))
    padded, n = tc.pad_to(case["n_rows"])
    got = padded.gather_distributed(n)
    out["gather_distributed"] = (got.infos, _host(got.poses))
    got = tc.gather_multihost(case["dir"] / "collection")
    out["gather_multihost"] = (got.infos, _host(got.poses))
    pred, pred_T, gt, gt_T = case["meter_frames"]
    db = build_mesh_db([MeshSpec(**s) for s in case["meter_specs"]], device=device)
    meter = tm.PoseErrorMeter(db, **case["meter_kw"])
    p = np.flatnonzero(pred["view_id"] % world == rank)
    g = np.flatnonzero(gt["view_id"] % world == rank)
    meter.add(TensorCollection(table.take(pred, p), poses=torch.as_tensor(pred_T[p]).to(device)),
              TensorCollection(table.take(gt, g), poses=torch.as_tensor(gt_T[g]).to(device)))
    out["meter"] = tm.gather_multihost(meter, case["dir"] / "meter").summary()[0]
    return out


def kernels_vs_plain(rank: int, world: int, device: torch.device, case: dict) -> dict:
    """Both raster kernels on this rank's card at a train step's first render
    (case: batch, image_size, render_size, tile, budget, lod) against their
    plain versions: setup's error as rasterizer_cuda.setup_error reads it and
    whether its order equals torch.sort's,
    resolve's outputs equal. Launches made here are not the step's."""
    from .. import demo

    if device.type != "cuda":
        raise ValueError(f"the raster kernels run on a CUDA device, not {device}")
    first = demo.first_render_inputs(case["batch"], case["image_size"], case["render_size"],
                                     case["lod"], device)
    args = (first["tri_verts"], first["tri_valid"], first["TCO"], first["K_crop"],
            case["render_size"], first["colors"])
    rows, key, order = rc.setup(*args)
    rows_p, key_p = rc.setup_plain(*args)
    err = rc.setup_error(rows, key, rows_p, key_p, case["render_size"], K=first["K_crop"])
    both = (rows[..., rc.LANE_VALID] != 0) & (rows_p[..., rc.LANE_VALID] != 0)
    out_k = rc.resolve(rows, order, case["render_size"], case["tile"], case["budget"])
    out_p = rc.resolve_plain_binned(rows, order, case["render_size"], case["tile"],
                                    case["budget"], False)
    torch.cuda.synchronize(device)
    return dict(setup_error=err, rows=tuple(rows.shape),
                order_equal=bool(torch.equal(order, torch.sort(key, dim=1, stable=True).indices)),
                setup_max_abs_err=float((rows[both] - rows_p[both]).abs().max()),
                resolve_max_abs_err=max(float((a - b).abs().max())
                                        for a, b in zip(out_k[:2], out_p[:2])))


def train_pose_run(rank: int, world: int, device: torch.device, case: dict) -> dict:
    """train_pose over the demo dataset (case: the RunConfig `cfg`, n_items,
    image_size, render_max_faces, exp_dir, param_mode): case's epochs, then
    one more resumed from the last checkpoint, with an evaluation callback
    that sums the net's parameters. Returns each run's step, the checkpoint
    files written by this rank (torch.save calls), the epochs this rank ran
    the callback at, the log's records and the final net state dict (rank
    0)."""
    _float32()
    import dataclasses
    import json

    from .. import demo
    from ..training import checkpoint
    from ..training.train_pose import train_pose

    cfg = case["cfg"]
    db = build_mesh_db(demo.demo_specs(), render_max_faces=case["render_max_faces"],
                       device=device)
    data = {"train": [(demo.DemoPoseDataset(case["n_items"], case["image_size"], seed=0), 1)]}
    saved, save = [], torch.save

    def counted_save(obj, f, *args, **kwargs):
        saved.append(pathlib.Path(f).name)
        return save(obj, f, *args, **kwargs)

    calls = []

    def param_sum(state, epoch):
        calls.append(epoch)
        return {"param_sum": float(sum(p.detach().double().sum()
                                       for p in state.pp.net.parameters()))}

    kw = dict(exp_dir=case["exp_dir"], device=device, eval_callback=param_sum,
              param_mode=case["param_mode"])
    checkpoint.torch.save = counted_save
    try:
        first, run_dir = train_pose(cfg, data, db, **kw)
        more = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, n_epochs=cfg.train.n_epochs + 1))
        resumed, _ = train_pose(more, data, db, resume=True, **kw)
    finally:
        checkpoint.torch.save = save
    out = dict(steps=(first.step, resumed.step), saved=saved, calls=calls)
    state_dict = {k: _host(v) for k, v in resumed.net.state_dict().items()}  # every rank gathers
    if rank == 0:
        out["log"] = [json.loads(line) for line in (run_dir / "log.txt").read_text().splitlines()]
        out["state_dict"] = state_dict
    return out


def suite(rank: int, world: int, device: torch.device, cases: dict) -> dict:
    """Each of `cases` ({name: (function name in this module, case)}) in
    order, in one process group: {name: its result}."""
    return {name: globals()[fn](rank, world, device, case) for name, (fn, case) in cases.items()}
