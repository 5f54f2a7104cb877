"""Port parity for data parallelism on the CPU: two gloo ranks of the port
against the JAX package's sharded steps on the conftest's virtual 8-device
mesh (make_mesh(2)) and against the port's single process.

One spawn of two ranks (parallel.spawn with parallel.rank_checks.suite, a
module-scoped fixture) runs every rank-side case while this process computes
the JAX package's and the single process's results:
  - the pose train step at the B0/48x64/cubes/B=8 setting of
    tests/test_torch_port_training.py, from the JAX package's initial state,
    with the JAX step key's draws sliced by rank: metrics, gradients, Adam
    moments, parameters and running statistics against JAX's
    make_train_step(mesh=make_mesh(2)) within the port-to-JAX tolerances
    stated there, and against the port's one-process step at B=8 within the
    port-to-float64 ones (two float32 routes of one step: rtol 1e-5 on the
    metrics, 5e-4 of each gradient tensor's max, 1e-5 on the running
    statistics' scale);
  - fsdp against replicated over two steps: FSDP2 reduce-scatters where DDP
    all-reduces (another summation order), so 1e-5 relative on the metrics,
    1e-5 of each gradient tensor's max (the second step's 5e-4), parameters
    within 2·lr, running statistics 1e-5 of their scale;
  - global-batch BatchNorm alone, against the full-batch layer: output, input
    gradient and weight/bias gradients atol 1e-5 (float64 sums against
    oneDNN's float32 two-pass statistics, on inputs of mean 3 and spread 2),
    the flax running update 1e-6;
  - the detector step (softmax cls_mode, every count-normalised loss) against
    the JAX package's sharded step, with tests/test_torch_port_detector_training.py's
    tolerances but 1e-4 on grad_norm (see RTOL_DET_GRAD_NORM), and its
    gradients against the port's one process (5e-4);
  - the gathers (reduce_dict, TensorCollection.gather_distributed /
    gather_multihost, the meters' gather_multihost with its defaults);
  - train_pose for 2 epochs and a resumed third: rank 0 alone writes, the log
    holds one record an epoch, and its losses are those of one process
    training at the global batch (rtol 1e-4 over 6 Adam steps).
The loader's global batches at 2 ranks, DistributedSceneSampler, pad_to and
trimmed are held to the JAX package in this process; the dryrun spawns its
own ranks. The file takes about two minutes in one pytest process.
"""

import dataclasses
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from cosypose_tpu.data.pose_dataset import PoseDataset as JPoseDataset
from cosypose_tpu.data.wrappers import DistributedSceneSampler as JDistributedSceneSampler
from cosypose_tpu.data.wrappers import PartialSampler as JPartialSampler
from cosypose_tpu.evaluation import meters as jm
from cosypose_tpu.models import detector as jdet
from cosypose_tpu.ops.mesh_db import MeshSpec as JMeshSpec
from cosypose_tpu.ops.mesh_db import build_mesh_db as j_build_mesh_db
from cosypose_tpu.parallel import make_mesh
from cosypose_tpu.parallel import shard_batch as j_shard_batch
from cosypose_tpu.training import detector_training as jdt
from cosypose_tpu.training import pose_training as jpt
from cosypose_tpu.training.train_pose import PrefetchLoader
from cosypose_tpu.utils.tensor_collection import PandasTensorCollection
from cosypose_tpu_torch import demo
from cosypose_tpu_torch.data.wrappers import (DistributedSceneSampler, PartialSampler,
                                              RankBatchSampler)
from cosypose_tpu_torch.evaluation import meters as tm
from cosypose_tpu_torch.evaluation import table
from cosypose_tpu_torch.models import detector as tdet
from cosypose_tpu_torch.models.efficientnet import BatchNorm2d
from cosypose_tpu_torch.models.pose_predictor import PosePredictorConfig
from cosypose_tpu_torch.ops.mesh_db import MeshSpec, build_mesh_db
from cosypose_tpu_torch.parallel import rank_checks
from cosypose_tpu_torch.parallel.dryrun import dryrun_multichip
from cosypose_tpu_torch.parallel.spawn import spawn
from cosypose_tpu_torch.training import detector_training as tdt
from cosypose_tpu_torch.training import pose_training as tpt
from cosypose_tpu_torch.training.configs import RunConfig
from cosypose_tpu_torch.training.train_pose import ConcatDataset, make_loader, train_pose
from cosypose_tpu_torch.utils import distributed as tdist
from cosypose_tpu_torch.utils.tensor_collection import TensorCollection
from cosypose_tpu_torch.utils.weights import (jax_detector_variables_to_state_dict,
                                              load_jax_train_state)
from tests.test_pose_predictor import cube_specs, small_cfg
from tests.test_torch_port_backbones import randomize
from tests.test_torch_port_detector_training import make_batch as detector_batch
from tests.test_torch_port_detector_training import stats_scale_error
from tests.test_torch_port_eval import METER_CASES, _compare_summaries, meter_case, meter_specs
from tests.test_torch_port_training import (ATOL_PARAM, REL_GRAD_F64, REL_GRAD_JAX, REL_STATS,
                                            REL_STATS_JAX, REL_ZERO, RTOL_STEP, RTOL_STEP_JAX,
                                            adam_update, as_port_names, jax_step_draws,
                                            port_batch, stats_error, structurally_zero)

WORLD = 2
B = 8                     # the pose step's global batch
DET_SIZE = (48, 80)
REL_GRAD_FSDP = 1e-5
# the detector's grad_norm against the JAX package's sharded step: the JAX
# package's own single-device and sharded steps of one global batch give
# 91.88303 and 91.88772 (5.1e-5 apart), its loss gradient 91.88365
RTOL_DET_GRAD_NORM = 1e-4
ATOL_BN = 1e-5
RTOL_TRAIN_LOG = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def pose_configs():
    jcfg = jpt.PoseTrainConfig(
        predictor=dataclasses.replace(small_cfg(), head_init_scale=0.01, drop_connect_rate=0.0),
        n_iterations=2, n_points_loss=8, batch_size=B, epoch_size=B, n_epochs_warmup=1,
        input_generator="gt+noise")
    cfg = tpt.PoseTrainConfig(
        predictor=PosePredictorConfig(backbone="efficientnet-b0", render_size=(48, 64),
                                      n_points_crop=8, head_init_scale=0.01,
                                      drop_connect_rate=0.0),
        n_iterations=2, n_points_loss=8, batch_size=B, epoch_size=B, n_epochs_warmup=1,
        input_generator="gt+noise")
    return jcfg, cfg


def tiny_run_cfg(batch_size):
    tcfg = tpt.PoseTrainConfig(
        predictor=PosePredictorConfig(backbone="efficientnet-b0", render_size=(48, 64),
                                      n_points_crop=64),
        n_iterations=1, n_points_loss=100, input_generator="gt+noise", batch_size=batch_size,
        epoch_size=8, n_epochs=2, n_epochs_warmup=0)
    return RunConfig(run_id="dp", train=tcfg, n_dataloader_workers=0, val_epoch_interval=100,
                     save_epoch_interval=1)


def collection_case():
    rng = np.random.RandomState(7)
    n = 11
    infos = dict(view_id=rng.randint(0, 5, n), label=np.asarray([f"obj_{i % 3}" for i in range(n)]),
                 score=rng.uniform(size=n))
    return infos, rng.normal(size=(n, 4, 4)).astype(np.float32)


def bn_case():
    rng = np.random.RandomState(11)
    C = 5
    return dict(x=(3.0 + 2.0 * rng.normal(size=(B, C, 6, 7))).astype(np.float32),
                dy=rng.normal(size=(B, C, 6, 7)).astype(np.float32),
                weight=rng.uniform(0.5, 1.5, C).astype(np.float32),
                bias=rng.normal(size=C).astype(np.float32),
                running_mean=rng.normal(size=C).astype(np.float32),
                running_var=rng.uniform(0.5, 1.5, C).astype(np.float32), eps=1e-3,
                momentum=0.9)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Spawn the two ranks with every case, and meanwhile compute the JAX
    package's and the single process's counterparts."""
    tmp = tmp_path_factory.mktemp("dp")
    jcfg, cfg = pose_configs()
    jpp, jstate = jpt.create_train_state(jcfg, jax.random.PRNGKey(0))
    init_state = tpt.create_train_state(cfg, "cpu")
    load_jax_train_state(init_state, jax.tree_util.tree_map(np.asarray, jstate.params),
                         jax.tree_util.tree_map(np.asarray, jstate.batch_stats))
    init = {k: v.clone() for k, v in init_state.pp.net.state_dict().items()}
    backbone = init_state.pp.net.backbone
    draws = [jax_step_draws(jax.random.PRNGKey(i + 1), B, 8, 2, backbone) for i in range(2)]
    batch = port_batch(B, seed=3)
    specs = [dict(vars(s)) for s in cube_specs()]
    pose = dict(cfg=cfg, specs=specs, init=init, batch=batch, draws=draws,
                keep=("grads", "moments", "updates"))

    dcfg = dict(n_classes=5, cls_mode="softmax", n_mask_protos=8)
    kw = dict(batch_size=2, epoch_size=4, n_epochs_warmup=0, lr=1e-3, mask_pos_weight=2.0)
    jdcfg = jdt.DetectorTrainConfig(detector=jdet.DetectorConfig(**dcfg), **kw)
    tdcfg = tdt.DetectorTrainConfig(detector=tdet.DetectorConfig(**dcfg), **kw)
    model, jdstate = jdt.create_detector_train_state(jdcfg, jax.random.PRNGKey(0),
                                                     image_size=DET_SIZE)
    v = jax.tree_util.tree_map(np.array, {"params": jdstate.params,
                                          "batch_stats": jdstate.batch_stats})
    rng = np.random.RandomState(3)
    randomize(v["params"], rng)
    randomize(v["batch_stats"], rng)
    jdstate = jdstate.replace(params=jax.tree_util.tree_map(jnp.asarray, v["params"]),
                              batch_stats=jax.tree_util.tree_map(jnp.asarray, v["batch_stats"]),
                              opt_state=jdstate.tx.init(v["params"]))
    dbatch = detector_batch(seed=4, B=4)
    dinit = jax_detector_variables_to_state_dict(v)

    pred, pred_T, gt, gt_T = meter_case(3)
    meter_kw = dict(METER_CASES["ADD(-S)"], report_AP=True, report_error_AUC=True,
                    report_error_stats=True)
    infos, poses = collection_case()
    n_rows = max(int((infos["view_id"] % WORLD == r).sum()) for r in range(WORLD))
    cases = dict(
        batchnorm=("batchnorm", bn_case()),
        pose_replicated=("pose_steps", dict(pose, param_mode="replicated")),
        pose_fsdp=("pose_steps", dict(pose, param_mode="fsdp", keep=("grads", "updates"),
                                      checkpoint_dir=tmp / "fsdp_ckpt")),
        detector=("detector_step", dict(cfg=tdcfg, init=dinit, batch=dbatch,
                                        param_mode="replicated")),
        gathers=("gathers", dict(collection=(infos, poses), n_rows=n_rows, dir=tmp / "gather",
                                 meter_frames=(pred, pred_T, gt, gt_T), meter_specs=meter_specs(),
                                 meter_kw=meter_kw)),
        train_pose=("train_pose_run", dict(cfg=tiny_run_cfg(2), n_items=12, image_size=(96, 128),
                                           render_max_faces=64, exp_dir=tmp / "exp",
                                           param_mode="replicated")),
        train_pose_fsdp=("train_pose_run", dict(cfg=tiny_run_cfg(2), n_items=12,
                                                image_size=(96, 128), render_max_faces=64,
                                                exp_dir=tmp / "exp_fsdp", param_mode="fsdp")),
    )
    ranks = {}
    thread = threading.Thread(target=lambda: ranks.update(
        out=spawn(rank_checks.suite, WORLD, (cases,), device="cpu", n_threads=1,
                  timeout_s=600)))
    thread.start()

    # the JAX package's sharded steps
    mesh = make_mesh(WORLD)
    jstep = jpt.make_train_step(jpp, jcfg, j_build_mesh_db(cube_specs()), mesh=mesh)
    jnew, jmetrics = jstep(jstate, j_shard_batch(mesh, {k: jnp.asarray(a) for k, a in
                                                        batch.items()}), jax.random.PRNGKey(1))
    stats = jax.tree_util.tree_map(np.asarray, jnew.batch_stats)
    jax_pose = dict(metrics={k: float(a) for k, a in jmetrics.items()},
                    sd=as_port_names(jax.tree_util.tree_map(np.asarray, jnew.params), stats),
                    mu=as_port_names(jax.tree_util.tree_map(np.asarray, jnew.opt_state[1][0].mu),
                                     stats),
                    nu=as_port_names(jax.tree_util.tree_map(np.asarray, jnew.opt_state[1][0].nu),
                                     stats))
    jdstep = jdt.make_detector_train_step(model, jdcfg, mesh=mesh)
    jdnew, jdm = jdstep(jdstate, j_shard_batch(mesh, {k: jnp.asarray(a) for k, a in
                                                      dbatch.items()}), jax.random.PRNGKey(1))
    jax_det = dict(metrics={k: float(a) for k, a in jdm.items()},
                   sd=jax_detector_variables_to_state_dict(jax.tree_util.tree_map(
                       np.asarray, {"params": jdnew.params, "batch_stats": jdnew.batch_stats})),
                   mu=jax_detector_variables_to_state_dict(
                       {"params": jax.tree_util.tree_map(np.asarray, jdnew.opt_state[1][0].mu),
                        "batch_stats": {}}))

    # the port's single process at the global batch
    db = build_mesh_db([MeshSpec(**s) for s in specs], device="cpu")
    one = tpt.create_train_state(cfg, "cpu")
    one.pp.net.load_state_dict(init)
    tb = {k: torch.as_tensor(a) for k, a in batch.items()}
    tb["label_ids"] = tb["label_ids"].long()
    m = tpt.make_train_step(cfg, db)(one, tb, draws[0])
    single_pose = dict(metrics={k: float(a) for k, a in m.items()},
                       grads={n: p.grad.clone() for n, p in one.pp.net.named_parameters()},
                       sd={k: a.clone() for k, a in one.pp.net.state_dict().items()})
    dstate = tdt.create_detector_train_state(tdcfg, "cpu")
    dstate.net.load_state_dict(dinit)
    dm = tdt.make_detector_train_step(tdcfg)(dstate, {k: torch.as_tensor(a)
                                                      for k, a in dbatch.items()})
    single_det = dict(metrics={k: float(a) for k, a in dm.items()},
                      grads={n: p.grad.clone() for n, p in dstate.net.named_parameters()})
    bn = bn_case()
    layer = BatchNorm2d(5, eps=bn["eps"], flax_momentum=bn["momentum"])
    with torch.no_grad():
        for k in ("weight", "bias", "running_mean", "running_var"):
            getattr(layer, k).copy_(torch.as_tensor(bn[k]))
    x = torch.as_tensor(bn["x"]).requires_grad_(True)
    y = layer(x)
    (y * torch.as_tensor(bn["dy"])).sum().backward()
    single_bn = dict(y=y.detach(), dx=x.grad, dweight=layer.weight.grad, dbias=layer.bias.grad,
                     running_mean=layer.running_mean, running_var=layer.running_var)
    single_run, _ = train_pose(tiny_run_cfg(2 * WORLD), {"train": [(demo.DemoPoseDataset(
        12, (96, 128), seed=0), 1)]}, build_mesh_db(demo.demo_specs(), render_max_faces=64,
                                                    device="cpu"),
        exp_dir=tmp / "single", device="cpu")
    single_log = read_log(tmp / "single" / "dp")

    thread.join(timeout=700)
    assert "out" in ranks, "the ranks did not finish"
    return dict(ranks=ranks["out"], jax_pose=jax_pose, jax_det=jax_det, single_pose=single_pose,
                single_det=single_det, single_bn=single_bn, single_log=single_log,
                single_run=single_run, cfg=cfg, tdcfg=tdcfg, init=init, dinit=dinit,
                pose_draws=draws, collection=(infos, poses))


def read_log(run_dir):
    return [json.loads(line) for line in (run_dir / "log.txt").read_text().splitlines()]


def _rel(a, b):
    a, b = torch.as_tensor(a).double(), torch.as_tensor(np.asarray(b)).double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


# -- the pose step ----------------------------------------------------------------------


def test_pose_step_metrics_match_jax_mesh_step(results):
    ref = results["jax_pose"]["metrics"]
    for r in range(WORLD):
        got = results["ranks"][r]["pose_replicated"]["steps"][0]
        assert set(got["metrics"]) == set(ref)
        for k, v in ref.items():
            np.testing.assert_allclose(got["metrics"][k], v, rtol=RTOL_STEP_JAX, err_msg=k)
        assert got["step"] == 1
    assert ref["grad_norm"] > 0.5  # the clip acts


def test_pose_step_gradients_and_moments_match_jax(results):
    """The clipped gradients (read from JAX's first Adam moment, 10 × mu)
    and the moments, rank 0's (replicated on both: rank 1's checksum)."""
    got = results["ranks"][0]["pose_replicated"]["steps"][0]
    ref = results["jax_pose"]
    floor = max(float(g.abs().max()) for g in got["grads"].values())
    for n, g in got["grads"].items():
        jg = np.asarray(ref["mu"][n], np.float64) / 0.1
        if structurally_zero(n):
            assert float(np.abs(jg).max()) <= REL_ZERO * floor, n
            continue
        assert _rel(g, jg) <= REL_GRAD_JAX, n
        assert _rel(got["exp_avg"][n], ref["mu"][n]) <= REL_GRAD_JAX, n
        assert _rel(got["exp_avg_sq"][n], ref["nu"][n]) <= 2 * REL_GRAD_JAX, n
    other = results["ranks"][1]["pose_replicated"]["steps"][0]["checksum"]
    for k, d in (("grads", got["grads"]), ("state_dict", got["state_dict"])):
        assert other[k] == pytest.approx(float(sum(v.double().sum() for v in d.values())),
                                         rel=0, abs=0), k


def test_pose_step_params_and_stats_match_jax(results):
    got = results["ranks"][0]["pose_replicated"]["steps"][0]
    ref, cfg, init = results["jax_pose"], results["cfg"], results["init"]
    zeros = torch.zeros((), dtype=torch.float64)
    for n, g in got["grads"].items():
        own = adam_update(g.double(), zeros, zeros, 1, cfg.lr)
        other = adam_update(torch.as_tensor(np.asarray(ref["mu"][n], np.float64) / 0.1), zeros,
                            zeros, 1, cfg.lr)
        p0 = init[n].double()
        assert float((got["state_dict"][n].double() - (p0 - own)).abs().max()) <= ATOL_PARAM, n
        err = (got["state_dict"][n].double() - torch.as_tensor(ref["sd"][n]).double()).abs()
        assert bool((err <= (own - other).abs() + ATOL_PARAM).all()), n
        assert float(err.max()) <= 2 * cfg.lr + ATOL_PARAM, n
    for n, t in got["state_dict"].items():
        if n.endswith(("running_mean", "running_var")):
            var = ref["sd"][n.replace("running_mean", "running_var")]
            assert stats_error(t, ref["sd"][n], n, var) <= REL_STATS_JAX, n


def test_pose_step_matches_one_process_at_the_global_batch(results):
    got = results["ranks"][0]["pose_replicated"]["steps"][0]
    one = results["single_pose"]
    for k, v in one["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=RTOL_STEP, err_msg=k)
    floor = max(float(g.abs().max()) for g in one["grads"].values())
    for n, g in got["grads"].items():
        if structurally_zero(n):
            assert float(g.abs().max()) <= REL_ZERO * floor, n
        else:
            assert _rel(g, one["grads"][n]) <= REL_GRAD_F64, n
    for n, t in one["sd"].items():
        if n.endswith(("running_mean", "running_var")):
            var = one["sd"][n.replace("running_mean", "running_var")]
            assert stats_error(got["state_dict"][n], t, n, var) <= REL_STATS, n


def test_fsdp_matches_replicated(results):
    """Two steps each: FSDP2's sharded step is DDP's, to summation order. The
    first step's gradients agree within REL_GRAD_FSDP; the second starts from
    parameters that Adam's sign-like first step moved apart by up to lr where
    a gradient is within rounding of 0, so its gradients are held to the
    port-to-float64 tolerance. Parameters differ, element by element, by no
    more than the two runs' Adam updates (as their moments give them) differ
    summed over the steps."""
    rep = results["ranks"][0]["pose_replicated"]["steps"]
    fsdp = results["ranks"][0]["pose_fsdp"]["steps"]
    lr = results["cfg"].lr
    spread = {n: torch.zeros(()) for n in rep[0]["grads"]}
    for i, (a, b) in enumerate(zip(rep, fsdp)):
        for k, v in a["metrics"].items():
            np.testing.assert_allclose(b["metrics"][k], v, rtol=RTOL_STEP, err_msg=f"{i} {k}")
        for n, g in a["grads"].items():
            if not structurally_zero(n):
                assert _rel(b["grads"][n], g) <= (REL_GRAD_FSDP, REL_GRAD_F64)[i], (i, n)
        for n, t in a["state_dict"].items():
            if n in a["grads"]:
                spread[n] = spread[n] + (b["updates"][n].double() - a["updates"][n].double()).abs()
                err = (b["state_dict"][n].double() - t.double()).abs()
                assert bool((err <= spread[n] + ATOL_PARAM).all()), (i, n)
                assert float(err.max()) <= 2 * lr + ATOL_PARAM, (i, n, float(err.max()))
            elif n.endswith(("running_mean", "running_var")):
                var = a["state_dict"][n.replace("running_mean", "running_var")]
                assert stats_error(b["state_dict"][n], t, n, var) <= REL_STATS, (i, n)
        assert a["step"] == b["step"] == i + 1
    assert results["ranks"][1]["pose_fsdp"]["steps"][1]["checksum"]["state_dict"] == \
        pytest.approx(float(sum(v.double().sum() for v in fsdp[1]["state_dict"].values())),
                      rel=0, abs=0)


def test_fsdp_checkpoint_is_the_single_process_format(results):
    """Under fsdp rank 0 writes the whole state dicts in the format one
    process writes (the net's own keys, the optimizer's state by parameter
    index), and every rank restores it into a fresh sharded state exactly."""
    from cosypose_tpu_torch.training.checkpoint import load_checkpoint

    ranks = [results["ranks"][r]["pose_fsdp"]["checkpoint"] for r in range(WORLD)]
    assert all(c["restored_equal"] for c in ranks)
    payload = load_checkpoint(ranks[0]["path"])
    one = tpt.create_train_state(results["cfg"], "cpu")
    sd = one.pp.net.state_dict()
    assert list(payload["net"]) == list(sd) and payload["step"] == 2
    last = results["ranks"][0]["pose_fsdp"]["steps"][-1]["state_dict"]
    for k, v in payload["net"].items():
        assert v.shape == sd[k].shape and torch.equal(v, last[k]), k
    params = list(one.pp.net.parameters())
    assert sorted(payload["optimizer"]["state"]) == list(range(len(params)))
    for i, p in enumerate(params):
        assert payload["optimizer"]["state"][i]["exp_avg"].shape == p.shape
    one.optimizer.load_state_dict(payload["optimizer"])  # the single-process optimizer takes it


def test_step_refuses_a_state_of_another_mode():
    """The step takes its mode from the state; a data-parallel state is
    refused without a process group, and so is a mode there is none of."""
    _, cfg = pose_configs()
    state = tpt.create_train_state(cfg, "cpu")
    assert state.dp is None
    with pytest.raises(RuntimeError, match="process group"):
        tpt.create_train_state(cfg, "cpu", param_mode="replicated")
    with pytest.raises(ValueError, match="param_mode"):
        tpt.create_train_state(cfg, "cpu", param_mode="zero3")


def test_draws_are_the_global_batch_rows():
    _, cfg = pose_configs()
    cfg = dataclasses.replace(cfg, rgb_aug_device=True, predictor=dataclasses.replace(
        cfg.predictor, drop_connect_rate=0.2))
    pp = tpt.create_train_state(cfg, "cpu").pp
    whole = tpt.draw_step(cfg, pp, B, 50, torch.Generator().manual_seed(4))
    for r in range(WORLD):
        part = tpt.draw_step(cfg, pp, B, 50, torch.Generator().manual_seed(4), r, WORLD)
        rows = slice(r * B // WORLD, (r + 1) * B // WORLD)
        assert torch.equal(part["point_ids"], whole["point_ids"])
        for a, b in zip(part["pose_noise"], whole["pose_noise"]):
            assert torch.equal(a, b[rows])
        for ma, mb in zip(part["drop_masks"], whole["drop_masks"]):
            assert all(a is b is None or torch.equal(a, b[rows]) for a, b in zip(ma, mb))
        assert any(m is not None for m in part["drop_masks"][0])
        for op, (f, c) in whole["jitter"].items():
            assert torch.equal(part["jitter"][op][0], f[rows])
            assert torch.equal(part["jitter"][op][1], c[rows])


# -- BatchNorm over the global batch ---------------------------------------------------------


def test_global_batchnorm_equals_the_full_batch_layer(results):
    got = [results["ranks"][r]["batchnorm"] for r in range(WORLD)]
    one = results["single_bn"]
    torch.testing.assert_close(torch.cat([g["y"] for g in got]), one["y"], atol=ATOL_BN, rtol=0)
    torch.testing.assert_close(torch.cat([g["dx"] for g in got]), one["dx"], atol=ATOL_BN,
                               rtol=0)
    for k in ("dweight", "dbias"):
        torch.testing.assert_close(sum(g[k] for g in got), one[k], atol=ATOL_BN, rtol=1e-6)
    for g in got:
        for k in ("running_mean", "running_var"):
            torch.testing.assert_close(g[k], one[k], atol=1e-6, rtol=1e-6)


# -- the detector step -----------------------------------------------------------------------


def test_detector_step_matches_the_jax_sharded_step(results):
    got = results["ranks"][0]["detector"]
    ref, cfg = results["jax_det"], results["tdcfg"]
    assert set(got["metrics"]) == set(ref["metrics"]) and "loss_cls" in ref["metrics"]
    for k, v in ref["metrics"].items():
        rtol = RTOL_DET_GRAD_NORM if k == "grad_norm" else RTOL_STEP_JAX
        np.testing.assert_allclose(got["metrics"][k], v, rtol=rtol, err_msg=k)
        np.testing.assert_allclose(results["ranks"][1]["detector"]["metrics"][k], v, rtol=rtol,
                                   err_msg=k)
    zeros = torch.zeros((), dtype=torch.float64)
    for n, g in got["grads"].items():
        own = adam_update(g.double(), zeros, zeros, 1, cfg.lr)
        other = adam_update(torch.as_tensor(np.asarray(ref["mu"][n], np.float64) / 0.1), zeros,
                            zeros, 1, cfg.lr)
        p0 = results["dinit"][n].double()
        assert float((got["state_dict"][n].double() - (p0 - own)).abs().max()) <= ATOL_PARAM, n
        err = (got["state_dict"][n].double() - torch.as_tensor(np.asarray(ref["sd"][n])).double()
               ).abs()
        assert bool((err <= (own - other).abs() + ATOL_PARAM).all()), n
        assert float(err.max()) <= 2 * cfg.lr + ATOL_PARAM, n
    for n, t in got["state_dict"].items():
        if n.endswith(("running_mean", "running_var")):
            var = ref["sd"][n.replace("running_mean", "running_var")]
            assert stats_scale_error(t, ref["sd"][n], var, n) <= REL_STATS_JAX, n


def test_detector_step_gradients_match_one_process(results):
    got = results["ranks"][0]["detector"]["grads"]
    one = results["single_det"]
    floor = max(float(g.abs().max()) for g in one["grads"].values())
    for n, g in one["grads"].items():
        if n in {f"head.deconv{i}.bias" for i in range(3)}:
            assert float(got[n].abs().max()) <= REL_ZERO * floor, n
        else:
            assert _rel(got[n], g) <= REL_GRAD_F64, n
    for k, v in one["metrics"].items():
        np.testing.assert_allclose(results["ranks"][0]["detector"]["metrics"][k], v,
                                   rtol=RTOL_STEP, err_msg=k)


# -- gathers -----------------------------------------------------------------------------------


def test_reduce_dict_and_gather_to_host(results):
    for r in range(WORLD):
        got = results["ranks"][r]["gathers"]
        assert got["reduce"] == {"a": 1.5, "b": 5.0, "c": 0.5}
        assert got["reduce_sum"] == {"a": 3.0}
        assert np.array_equal(got["gather_to_host"]["x"], np.arange(12.0).reshape(4, 3))
    assert tdist.reduce_dict({"x": 2, "a": 1.5}) == {"x": 2.0, "a": 1.5}


def test_collection_gathers_give_the_rows_of_one_process(results):
    """Both gathers on both ranks: the ranks' rows in rank order, as the JAX
    package's file gather (two threads for two processes) gives them."""
    infos, poses = results["collection"]
    order = np.concatenate([np.flatnonzero(infos["view_id"] % WORLD == r) for r in range(WORLD)])
    for r in range(WORLD):
        for name in ("gather_distributed", "gather_multihost"):
            got_infos, got_poses = results["ranks"][r]["gathers"][name]
            for k, v in infos.items():
                assert np.array_equal(got_infos[k], v[order]), (name, k)
            assert torch.equal(got_poses, torch.as_tensor(poses[order])), name


def test_jax_file_gather_orders_as_the_port(tmp_path):
    infos, poses = collection_case()
    shards = [np.flatnonzero(infos["view_id"] % WORLD == r) for r in range(WORLD)]
    out = {}

    def run(r):
        c = PandasTensorCollection(pd.DataFrame(table.take(infos, shards[r])),
                                   poses=jnp.asarray(poses[shards[r]]))
        out[r] = c.gather_multihost(tmp_path / "jax", process_id=r, n_processes=WORLD)

    threads = [threading.Thread(target=run, args=(r,)) for r in range(WORLD)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    port = {}

    def run_port(r):
        c = TensorCollection(table.take(infos, shards[r]), poses=torch.as_tensor(poses[shards[r]]))
        port[r] = c.gather_multihost(tmp_path / "port", process_id=r, n_processes=WORLD)

    threads = [threading.Thread(target=run_port, args=(r,)) for r in range(WORLD)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    for r in range(WORLD):
        for k in infos:
            assert np.array_equal(port[r].infos[k], out[r].infos[k].values), k
        assert np.array_equal(port[r].poses.numpy(), np.asarray(out[r].poses))


def test_pad_to_and_trimmed_match_jax():
    infos, poses = collection_case()
    port, n = TensorCollection(infos, poses=torch.as_tensor(poses)).pad_to(16, fill=-1.0)
    ref, n_ref = PandasTensorCollection(pd.DataFrame(infos), poses=jnp.asarray(poses)).pad_to(
        16, fill=-1.0)
    assert n == n_ref == len(poses) and len(port) == 16
    assert np.array_equal(port.poses.numpy(), np.asarray(ref.poses))
    back, ref_back = port.trimmed(n), ref.trimmed(n_ref)
    for k in infos:
        assert np.array_equal(back.infos[k], ref_back.infos[k].values), k
        assert np.array_equal(port.infos[k][:n], infos[k]), k
    assert np.array_equal(back.poses.numpy(), np.asarray(ref_back.poses))
    with pytest.raises(ValueError):
        TensorCollection(infos, poses=torch.as_tensor(poses)).pad_to(3)
    one = TensorCollection(infos, poses=torch.as_tensor(poses))
    assert len(one.gather_distributed(4)) == 4 and one.gather_multihost("unused") is one


def test_gather_multihost_refuses_a_stale_shard(tmp_path):
    infos, poses = collection_case()
    (tmp_path / "0.pkl").write_bytes(b"")
    with pytest.raises(FileExistsError):
        TensorCollection(infos, poses=torch.as_tensor(poses)).gather_multihost(
            tmp_path, process_id=0, n_processes=2)
    specs = meter_specs()
    meter = tm.PoseErrorMeter(build_mesh_db([MeshSpec(**s) for s in specs], device="cpu"))
    with pytest.raises(FileExistsError):
        tm.gather_multihost(meter, tmp_path, 0, 2)
    with pytest.raises(TimeoutError):
        TensorCollection(infos, poses=torch.as_tensor(poses)).gather_multihost(
            tmp_path / "alone", process_id=0, n_processes=2, timeout_s=0.2)


def test_meter_default_gather_at_two_ranks(results):
    """The meters' gather with its defaults (the process group's rank and
    world) summarises as the JAX meter fed every frame."""
    specs = meter_specs()
    jdb = j_build_mesh_db([JMeshSpec(**s) for s in specs], keep_geometry=False)
    pred, pred_T, gt, gt_T = meter_case(3)
    meter = jm.PoseErrorMeter(jdb, **dict(METER_CASES["ADD(-S)"], report_AP=True,
                                          report_error_AUC=True, report_error_stats=True))
    meter.add(PandasTensorCollection(pd.DataFrame(pred), poses=jnp.asarray(pred_T)),
              PandasTensorCollection(pd.DataFrame(gt), poses=jnp.asarray(gt_T)))
    ref = meter.summary()[0]
    for r in range(WORLD):
        _compare_summaries(ref, results["ranks"][r]["gathers"]["meter"], 1e-6)


# -- samplers and the loader -------------------------------------------------------------------


@pytest.mark.parametrize("n,replicas,shuffle,seed", [(10, 2, True, 0), (11, 3, True, 5),
                                                     (7, 4, False, 0), (3, 4, True, 1),
                                                     (100, 8, True, 2)])
def test_distributed_scene_sampler_matches_jax(n, replicas, shuffle, seed):
    ds = list(range(n))
    for rank in range(replicas):
        port = DistributedSceneSampler(ds, replicas, rank, shuffle, seed)
        ref = JDistributedSceneSampler(ds, replicas, rank, shuffle, seed)
        assert list(port) == list(ref) and len(port) == len(ref)


def test_loader_at_two_ranks_follows_the_jax_batches():
    """Each rank walks the same sampler order and loads its contiguous half
    of each global batch: together the JAX package's PrefetchLoader's
    batches at the global batch."""
    both = ConcatDataset([(demo.DemoPoseDataset(6, (96, 128), seed=0), 2)])
    ref = [b for b in PrefetchLoader(both, JPartialSampler(both, 10, seed=3), 4,
                                     JPoseDataset.collate_fn, n_workers=1)]
    ranks = [[b for b in make_loader(both, PartialSampler(both, 10, seed=3), 4, 0, False,
                                     rank=r, world=WORLD)] for r in range(WORLD)]
    assert len(ref) == len(ranks[0]) == len(ranks[1]) == 2
    for i, r in enumerate(ref):
        assert r.labels == ranks[0][i]["labels"] + ranks[1][i]["labels"]
        np.testing.assert_array_equal(
            r.images, np.concatenate([ranks[0][i]["images"], ranks[1][i]["images"]]))
    assert len(RankBatchSampler(PartialSampler(both, 10, seed=3), 4, 1, WORLD)) == 2
    with pytest.raises(ValueError):
        RankBatchSampler(PartialSampler(both, 10, seed=3), 3, 0, WORLD)


# -- the training loop -------------------------------------------------------------------------


def test_train_pose_at_two_ranks(results):
    """2 epochs, then one more resumed: rank 0 alone writes the checkpoints
    and one log record an epoch; the losses are those of one process at the
    global batch of 4 (no warm-up: the lr schedule counts epochs in steps of
    the per-rank batch, as the JAX package's counts them in the per-device
    batch, so a warm-up would differ between the two runs)."""
    r0, r1 = (results["ranks"][r]["train_pose"] for r in range(WORLD))
    assert r0["steps"] == r1["steps"] == (4, 6)   # 8 samples an epoch in global batches of 4
    assert r0["calls"] == [0, 1, 2] and not r1["calls"]  # the callback: first and last epochs
    assert sum("test/param_sum" in r for r in r0["log"]) == 3
    # epochs 0 and 1, the run's end (1), then the resumed epoch 2 and its end
    assert [n.split(".")[0] for n in r0["saved"]] == [
        "epoch_00000", "epoch_00001", "epoch_00001", "epoch_00002", "epoch_00002"]
    assert not r1["saved"]
    train = [r for r in r0["log"] if "train/loss_total" in r]
    assert [r["epoch"] for r in train] == [0, 1, 2]
    ref = [r for r in results["single_log"] if "train/loss_total" in r]
    assert results["single_run"].step == 4
    for got, want in zip(train[:2], ref):
        np.testing.assert_allclose(got["train/loss_total"], want["train/loss_total"],
                                   rtol=RTOL_TRAIN_LOG)
        np.testing.assert_allclose(got["train/grad_norm"], want["train/grad_norm"],
                                   rtol=RTOL_TRAIN_LOG)


def test_train_pose_under_fsdp(results):
    """The same run with the parameters sharded: the same steps, checkpoints
    and callbacks, the callback sees the whole parameters (its last sum is
    the final state dict's), and the losses are the replicated run's."""
    f0, f1 = (results["ranks"][r]["train_pose_fsdp"] for r in range(WORLD))
    r0 = results["ranks"][0]["train_pose"]
    assert f0["steps"] == f1["steps"] == (4, 6)
    assert len(f0["saved"]) == 5 and not f1["saved"]
    assert f0["calls"] == [0, 1, 2] and not f1["calls"]
    sums = [r["test/param_sum"] for r in f0["log"] if "test/param_sum" in r]
    params = dict(tpt.create_train_state(tiny_run_cfg(2).train, "cpu").pp.net.named_parameters())
    final = sum(float(v.double().sum()) for k, v in f0["state_dict"].items() if k in params)
    np.testing.assert_allclose(sums[-1], final, rtol=1e-9)
    for got, want in zip(f0["log"], r0["log"]):
        if "train/loss_total" in want:
            np.testing.assert_allclose(got["train/loss_total"], want["train/loss_total"],
                                       rtol=RTOL_TRAIN_LOG)


def test_dryrun_multichip_at_two_ranks(capsys):
    loss = dryrun_multichip(2)
    assert np.isfinite(loss) and "dryrun_multichip(2): ok" in capsys.readouterr().out


def test_init_distributed_mode_is_a_no_op_alone(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert tdist.init_distributed_mode(device="cpu") == torch.device("cpu")
    assert not torch.distributed.is_initialized()
    assert (tdist.get_rank(), tdist.get_world_size()) == (0, 1)
    tdist.barrier()


def test_spawned_rank_failure_raises():
    with pytest.raises(Exception, match="KeyError"):
        spawn(rank_checks.suite, 2, ({"bad": ("batchnorm", {})},), device="cpu", n_threads=1,
              timeout_s=120)


def test_spawn_defaults_to_the_card_and_raises_without_one(monkeypatch):
    """No device= means the card: without one, resolve_device's error comes
    before any rank starts, where a CPU default would have run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="a CUDA device was requested"):
        spawn(rank_checks.suite, 2, ({"bad": ("batchnorm", {})},), n_threads=1, timeout_s=60)
