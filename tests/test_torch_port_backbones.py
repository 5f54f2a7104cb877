"""Port parity: the WideResNet, FlowNetS and CorrNet backbones, every PoseNet
pooling and the 9-channel input, with weights carried from the JAX package
by utils/weights.py.

fp32 on the CPU at 48x80 (the stride-2 stages round up: 48x80 → 2x3 at
stride 32). Backbones alone at WideResNet width 0.25 (CorrNet and FlowNetS
at their only widths); PoseNet at the configs' full widths. BatchNorm
statistics, LayerNorm parameters and the pose kernel are random, so none of
them is an identity. Tolerances: features atol 1e-4 (as in
tests/test_torch_port_backbone.py; conv summation order differs between XLA
and oneDNN), pose outputs atol 1e-4; in train mode, outputs atol 1e-4 and
the BatchNorm running statistics after the step atol 1e-5 (they move by a
tenth of the batch statistics); local_correlation atol 1e-6 against JAX and
exactly the mean square on a known shift. Parameter counts are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosypose_tpu.models import corrnet as jcorrnet
from cosypose_tpu.models import pose_predictor as jpp_mod
from cosypose_tpu.models import wide_resnet as jwrn
from cosypose_tpu_torch.models import corrnet, wide_resnet
from cosypose_tpu_torch.models.pose_predictor import (PosePredictor, PosePredictorConfig,
                                                      lk_pyramid_stats)
from cosypose_tpu_torch.utils.weights import jax_pose_variables_to_state_dict

ATOL = 1e-4
ATOL_STATS = 1e-5
SIZE = (48, 80)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def randomize(tree, rng):
    """Random BatchNorm statistics, LayerNorm/BatchNorm affines and pose kernel."""
    for k, v in tree.items():
        if isinstance(v, dict):
            randomize(v, rng)
        elif k == "mean":
            tree[k] = rng.normal(0.0, 0.2, v.shape).astype(np.float32)
        elif k == "var":
            tree[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k in ("scale", "bias"):
            tree[k] = (np.asarray(v) + rng.normal(0.0, 0.1, v.shape)).astype(np.float32)


def jax_variables(module, x, seed=0):
    v = module.init(jax.random.PRNGKey(seed), jnp.asarray(x), train=False)
    v = jax.tree_util.tree_map(np.asarray, dict(v))
    v = {"params": v["params"], "batch_stats": v.get("batch_stats", {})}
    rng = np.random.RandomState(seed)
    randomize(v["params"], rng)
    randomize(v["batch_stats"], rng)
    return v


def load_backbone(port, tree_name, v):
    """The JAX backbone's variables into the port's backbone, through the
    PoseNet bridge (the backbone's subtree under its flax name)."""
    sd = jax_pose_variables_to_state_dict(
        {"params": {tree_name: v["params"]}, "batch_stats": {tree_name: v["batch_stats"]}})
    port.load_state_dict({k.removeprefix("backbone."): t for k, t in sd.items()})
    return port


def nchw(x):
    return torch.as_tensor(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def stats_of(port):
    return {name: (m.running_mean.numpy(), m.running_var.numpy())
            for name, m in port.named_modules() if hasattr(m, "running_mean")}


def jax_stats(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if "mean" in v:
            out[f"{prefix}{k}"] = (np.asarray(v["mean"]), np.asarray(v["var"]))
        else:
            out.update(jax_stats(v, f"{prefix}{k}."))
    return out


BACKBONES = {
    "wrn18": (lambda: jwrn.WideResNet18(width=0.25), lambda: wide_resnet.WideResNet18(0.25),
              "WideResNet_0", 6),
    "wrn34": (lambda: jwrn.WideResNet34(width=0.25), lambda: wide_resnet.WideResNet34(0.25),
              "WideResNet_0", 6),
    "flownet": (lambda: jwrn.FlowNetSEncoder(), lambda: wide_resnet.FlowNetSEncoder(),
                "FlowNetSEncoder_0", 6),
    "corrnet": (lambda: jcorrnet.CorrNet(), lambda: corrnet.CorrNet(6), "CorrNet_0", 6),
    "corrnet9": (lambda: jcorrnet.CorrNet(), lambda: corrnet.CorrNet(9), "CorrNet_0", 9),
}


@pytest.mark.parametrize("name", list(BACKBONES))
def test_backbone_matches_jax_eval_and_train(name):
    make_j, make_t, tree, n_ch = BACKBONES[name]
    x = np.random.RandomState(1).uniform(size=(2, *SIZE, n_ch)).astype(np.float32)
    jm = make_j()
    v = jax_variables(jm, x)
    port = load_backbone(make_t(), tree, v)
    n_jax = sum(a.size for a in jax.tree_util.tree_leaves(v["params"]))
    assert sum(p.numel() for p in port.parameters()) == n_jax

    ref = np.asarray(jm.apply(v, jnp.asarray(x), train=False)).transpose(0, 3, 1, 2)
    with torch.no_grad():
        got = port.eval()(nchw(x)).numpy()
    assert got.shape == ref.shape and np.abs(ref).max() > 0.1
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)

    if not v["batch_stats"]:
        return  # FlowNetS has no BatchNorm: train mode is eval mode
    ref_t, upd = jm.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    with torch.no_grad():
        got_t = port.train()(nchw(x)).numpy()
    np.testing.assert_allclose(got_t, np.asarray(ref_t).transpose(0, 3, 1, 2), atol=ATOL,
                               rtol=0)
    want, have = jax_stats(upd["batch_stats"]), stats_of(port)
    assert set(want) == set(have)
    for k, (m, var) in want.items():
        np.testing.assert_allclose(have[k][0], m, atol=ATOL_STATS, rtol=0, err_msg=k)
        np.testing.assert_allclose(have[k][1], var, atol=ATOL_STATS, rtol=0, err_msg=k)


def test_corrnet_stem_statistics_move_once_per_application():
    """Three applications of the shared stem in train mode: its running
    statistics are momentum³-weighted, in the order obs, render, diff."""
    x = np.random.RandomState(2).uniform(size=(2, *SIZE, 9)).astype(np.float32)
    v = jax_variables(jcorrnet.CorrNet(), x)
    port = load_backbone(corrnet.CorrNet(9), "CorrNet_0", v)
    m0 = port.stem.bn1.running_mean.clone()
    with torch.no_grad():
        port.train()(nchw(x))
        r = m0.clone()
        for i in (0, 3, 6):  # the batch means of conv1, which no statistic changes
            r = 0.9 * r + 0.1 * port.stem.conv1(nchw(x)[:, i:i + 3]).mean(dim=(0, 2, 3))
    np.testing.assert_allclose(port.stem.bn1.running_mean.numpy(), r.numpy(), atol=1e-6)


def test_local_correlation_known_shift_and_jax():
    rng = np.random.RandomState(3)
    f1 = rng.normal(size=(1, 5, 12, 14)).astype(np.float32)
    dy, dx, r = 2, -1, 3
    f2 = np.roll(f1, (-dy, -dx), axis=(2, 3))  # f2[h, w] = f1[h + dy, w + dx]
    got = corrnet.local_correlation(torch.as_tensor(f1), torch.as_tensor(f2), r).numpy()
    assert got.shape == (1, (2 * r + 1) ** 2, 12, 14) and got.dtype == np.float32
    ch = (dy + r) * (2 * r + 1) + (dx + r)
    inner = (slice(r, 12 - r), slice(r, 14 - r))
    np.testing.assert_allclose(got[0, ch][inner], (f2 ** 2).mean(axis=1)[0][inner], atol=1e-6)
    ref = jcorrnet.local_correlation(jnp.asarray(f1.transpose(0, 2, 3, 1)),
                                     jnp.asarray(f2.transpose(0, 2, 3, 1)), r)
    np.testing.assert_allclose(got, np.asarray(ref).transpose(0, 3, 1, 2), atol=1e-6)


POSENETS = [
    ("wide-resnet18", "gap", "obs+render"),
    ("wide-resnet18", "gap+moments", "obs+render+diff"),
    ("wide-resnet18", "gap+moments+scale", "obs+render+diff"),
    ("wide-resnet18", "gap+moments+flatten", "obs+render+diff"),
    ("wide-resnet18", "gap+lk", "obs+render"),
    ("wide-resnet34", "gap+moments+flatten+scale+lk", "obs+render+diff"),
    ("corrnet", "gap+moments+flatten+lk", "obs+render+diff"),
    ("flownet", "gap", "obs+render"),
]


@pytest.mark.parametrize("backbone,pooling,input_mode", POSENETS)
def test_posenet_pooling_matches_jax(backbone, pooling, input_mode):
    kw = dict(backbone=backbone, render_size=SIZE, pooling=pooling, input_mode=input_mode)
    jpp = jpp_mod.PosePredictor(jpp_mod.PosePredictorConfig(**kw))
    v = jax.tree_util.tree_map(np.asarray, dict(jpp.init(jax.random.PRNGKey(0))))
    v = {"params": v["params"], "batch_stats": v.get("batch_stats", {})}
    rng = np.random.RandomState(4)
    randomize(v["params"], rng)
    randomize(v["batch_stats"], rng)
    k = v["params"]["pose_fc"]["kernel"]
    v["params"]["pose_fc"]["kernel"] = rng.normal(0.0, 0.05, k.shape).astype(np.float32)
    pp = PosePredictor(PosePredictorConfig(**kw), device="cpu")
    pp.net.load_state_dict(jax_pose_variables_to_state_dict(v))
    n_ch = 9 if input_mode == "obs+render+diff" else 6
    x = rng.uniform(size=(2, *SIZE, n_ch)).astype(np.float32)
    ref = np.asarray(jpp.net.apply(v, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = pp.net(nchw(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    assert np.abs(ref - np.array([1, 0, 0, 0, 1, 0, 0, 0, 1])).max() > 1e-3


def test_lk_statistics_match_jax():
    x = np.random.RandomState(5).uniform(size=(2, *SIZE, 6)).astype(np.float32)
    ref = np.asarray(jpp_mod._lk_pyramid_stats(jnp.asarray(x)))
    got = lk_pyramid_stats(nchw(x)).numpy()
    assert got.shape == ref.shape == (2, 54)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("bad", ["efficientnet-b3+dwdens", "resnet50x", "efficientnet-b9"])
def test_config_refuses_unported_backbones(bad):
    with pytest.raises(ValueError):
        PosePredictorConfig(backbone=bad)
