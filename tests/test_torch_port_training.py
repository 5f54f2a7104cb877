"""Port parity for pose training: transforms and pose noise, the five losses,
the colour jitter, EfficientNet in train mode, drop-connect, remat, the lr
schedule, two full train steps, the named configs and the sampler, JAX
package vs port on the CPU.

Random draws differ between jax.random and torch.Generator, so each test
recreates the JAX package's draws with jax.random and hands them to the
port's deterministic half (apply_pose_noise, apply_color_jitter, the step's
`draws`). Tolerances, with their reasons:
  - geometry, pose noise and the losses: atol 1e-6 (fp32 on both sides, the
    same formulas; only small einsum summation orders differ);
  - loss gradients w.r.t. the head outputs: 1e-5 of each tensor's max;
  - EfficientNet train mode: features 1e-4 of their max (~3) after 16 MBConv
    blocks (conv summation order differs between XLA and oneDNN; batch
    statistics renormalise every layer), gradients 2e-4 of each
    tensor's max (random BatchNorm statistics make this net's gradients
    about as ill-conditioned as its features), running statistics 1e-5 of
    each tensor's max;
  - gradients that are zero in exact arithmetic (`structurally_zero`): below
    1e-6 of the net's largest gradient on both sides;
  - the jitter chain: atol 1e-4 on [0,1] images after factors up to 50
    (sharpness, contrast) amplify the blur's last-bit differences;
  - two train steps, each from the JAX package's state before it, against
    the same step with a float64 backbone (the oracle of either float32
    side's rounding): loss, metrics and grad_norm rtol 1e-5, running
    statistics 1e-5 of their scale (see stats_error), gradients 5e-4 of
    each tensor's max (the port's float32 rounding reaches 2.4e-4 here);
  - the same steps against the JAX package: loss and metrics rtol 3e-5,
    running statistics 1e-4, gradients 4e-3 of each tensor's max. The JAX
    package's own float32 step lies up to 1.8e-3 of a tensor's max (grads),
    1.4e-5 (losses) and 3.8e-5 (running variances) from the float64 step,
    about half of the gradients' share from flax's one-pass E[x²]−E[x]²
    batch variance; so 1e-4 of a tensor's max is below what either float32
    implementation reaches against the other at this size;
  - parameters: within 1e-6 of the JAX package's wherever the two steps'
    gradients give the same Adam update, and within 2·lr everywhere (Adam's
    first step moves a parameter by about lr·sign(g)).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosypose_tpu.data.wrappers import PartialSampler as JPartialSampler
from cosypose_tpu.models.efficientnet import EfficientNet as JEfficientNet
from cosypose_tpu.ops import image_aug as jaug
from cosypose_tpu.ops import losses as jl
from cosypose_tpu.ops import transforms as jtr
from cosypose_tpu.ops.mesh_db import build_mesh_db as j_build_mesh_db
from cosypose_tpu.training import configs as jconfigs
from cosypose_tpu.training import pose_training as jpt
from cosypose_tpu_torch.data.wrappers import ListSampler, PartialSampler
from cosypose_tpu_torch.models.efficientnet import EfficientNet, frozen_stats
from cosypose_tpu_torch.models.pose_predictor import PosePredictorConfig
from cosypose_tpu_torch.ops import image_aug as taug
from cosypose_tpu_torch.ops import losses as tl
from cosypose_tpu_torch.ops import transforms as ttr
from cosypose_tpu_torch.ops.mesh_db import build_mesh_db
from cosypose_tpu_torch.training import configs as tconfigs
from cosypose_tpu_torch.training import pose_training as tpt
from cosypose_tpu_torch.utils.weights import (jax_pose_variables_to_state_dict,
                                              load_jax_train_state)
from tests.test_pose_predictor import make_K, small_cfg
from tests.test_torch_port_backbone import _randomize_stats
from tests.test_torch_port_geometry import random_poses
from tests.test_torch_port_slice import port_specs
from tests.test_pose_predictor import cube_specs

ATOL_LOSS = 1e-6
REL_FEAT = 1e-4
REL_GRAD = 1e-4
REL_STATS = 1e-5
RTOL_STEP = 1e-5
ATOL_PARAM = 1e-6
REL_GRAD_BACKBONE = 2e-4
REL_GRAD_JAX = 4e-3
REL_GRAD_F64 = 5e-4
REL_STATS_JAX = 1e-4
RTOL_STEP_JAX = 3e-5
REL_ZERO = 1e-6


def structurally_zero(name: str) -> bool:
    """A block's last BatchNorm bias reaches the loss only through the next
    convolution and its train-mode BatchNorm (or the residual sum, then one),
    which removes any per-channel constant: its gradient is 0 in exact
    arithmetic, and rounding noise in either implementation."""
    return name.endswith("_bn2.bias")



@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The fast tier runs several test processes side by side on the CPU's
    cores; PyTorch's own thread pool in each would oversubscribe them and
    slow every process many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _t(a):
    return torch.as_tensor(np.array(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


def _close(port, ref, atol, what=""):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), atol=atol, rtol=0,
                               err_msg=what)


def _close_rel(port, ref, rel, what=""):
    """|port - ref| <= rel · max|ref| (per tensor)."""
    ref = np.asarray(ref)
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(port - ref).max())
    assert err <= rel * scale, f"{what}: max err {err:.3g} > {rel} x {scale:.3g}"


# -- transforms and pose noise ------------------------------------------------

def test_rotation_parametrisations_match():
    rng = np.random.RandomState(0)
    T = random_poses(rng, 6)
    euler = rng.uniform(-3, 3, (6, 3)).astype(np.float32)
    _close(ttr.euler_to_matrix(_t(euler)), jtr.euler_to_matrix(_j(euler)), ATOL_LOSS)
    _close(ttr.matrix_to_rot6d(_t(T[:, :3, :3])), jtr.matrix_to_rot6d(_j(T[:, :3, :3])),
           ATOL_LOSS)
    p9 = np.asarray(jtr.T_to_pose9d(_j(T)))
    _close(ttr.T_to_pose9d(_t(T)), p9, ATOL_LOSS)
    _close(ttr.pose9d_to_T(_t(p9)), jtr.pose9d_to_T(_j(p9)), ATOL_LOSS)
    _close(ttr.pose9d_to_T(ttr.T_to_pose9d(_t(T))), T, 1e-5)


def jax_pose_noise(key, B):
    """The standard-normal draws jax's add_pose_noise makes from `key`."""
    k1, k2 = jax.random.split(key)
    return (_t(jax.random.normal(k1, (B, 3), jnp.float32)),
            _t(jax.random.normal(k2, (B, 3), jnp.float32)))


@pytest.mark.parametrize("std", [((15.0, 15.0, 15.0), (0.01, 0.01, 0.05)),
                                 ((0.0, 0.0, 0.0), (0.01, 0.01, 0.05)),
                                 ((5.0, 30.0, 90.0), (0.1, 0.0, 0.02))])
def test_add_pose_noise_matches_with_injected_draws(std):
    T = random_poses(np.random.RandomState(1), 5)
    key = jax.random.PRNGKey(3)
    ref = jtr.add_pose_noise(key, _j(T), euler_deg_std=std[0], trans_std=std[1])
    port = ttr.apply_pose_noise(_t(T), *jax_pose_noise(key, 5), euler_deg_std=std[0],
                                trans_std=std[1])
    _close(port, ref, ATOL_LOSS)
    assert np.abs(np.asarray(ref) - T).max() > 1e-3


def test_add_pose_noise_draws_from_its_generator():
    T = _t(random_poses(np.random.RandomState(1), 5))
    a = ttr.add_pose_noise(T, torch.Generator().manual_seed(7))
    b = ttr.add_pose_noise(T, torch.Generator().manual_seed(7))
    c = ttr.add_pose_noise(T, torch.Generator().manual_seed(8))
    assert torch.equal(a, b) and not torch.equal(a, c)
    R = a[:, :3, :3]
    assert torch.allclose(R @ R.transpose(1, 2), torch.eye(3).expand(5, 3, 3), atol=1e-5)


# -- losses -----------------------------------------------------------------------

def loss_inputs(pose_dim, seed=0, B=4, P=50):
    """(TCO_possible_gt (B,3,4,4), TCO_input, head outputs (B, pose_dim),
    K_crop, points, points_valid)."""
    rng = np.random.RandomState(seed)
    syms = np.concatenate([np.eye(4, dtype=np.float32)[None], random_poses(rng, 2)])
    syms[1:, :3, 3] = 0.0  # identity and two rotations about the object's origin
    TCO_gt = random_poses(rng, B)
    gt = np.einsum("bij,sjk->bsik", TCO_gt, syms).astype(np.float32)
    TCO_in = random_poses(rng, B)
    if pose_dim == 9:
        out = np.concatenate([np.tile([1, 0, 0, 0, 1, 0], (B, 1)) + rng.normal(0, 0.2, (B, 6)),
                              rng.normal([0, 0, 1], [5.0, 5.0, 0.1], (B, 3))], 1)
    else:
        out = np.concatenate([rng.normal(0, 1, (B, 4)),
                              rng.normal([0, 0, 1], [5.0, 5.0, 0.1], (B, 3))], 1)
    K = np.array(make_K(B))
    K[:, 0, 0] = rng.uniform(300, 900, B)
    points = rng.uniform(-0.05, 0.05, (B, P, 3)).astype(np.float32)
    valid = rng.uniform(size=(B, P)) > 0.2
    return gt, TCO_in, out.astype(np.float32), K, points, valid


@pytest.mark.parametrize("pose_dim", [9, 7])
@pytest.mark.parametrize("masked", [False, True])
def test_disentangled_loss_matches(pose_dim, masked):
    gt, TCO_in, out, K, pts, valid = loss_inputs(pose_dim)
    v = valid if masked else None
    ref, ref_c = jl.loss_refiner_CO_disentangled(
        _j(gt), _j(TCO_in), _j(out), _j(K), _j(pts), None if v is None else _j(v),
        pose_dim=pose_dim, return_components=True, z_weight=1.7)
    port, port_c = tl.loss_refiner_CO_disentangled(
        _t(gt), _t(TCO_in), _t(out), _t(K), _t(pts), None if v is None else _t(v),
        pose_dim=pose_dim, return_components=True, z_weight=1.7)
    _close(port, ref, ATOL_LOSS)
    for k in ("loss_orn", "loss_xy", "loss_z"):
        _close(port_c[k], ref_c[k], ATOL_LOSS, k)
    _close(tl.loss_refiner_CO_disentangled(_t(gt), _t(TCO_in), _t(out), _t(K), _t(pts),
                                           pose_dim=pose_dim),
           jl.loss_refiner_CO_disentangled(_j(gt), _j(TCO_in), _j(out), _j(K), _j(pts),
                                           pose_dim=pose_dim), ATOL_LOSS)
    assert float(np.asarray(ref).min()) > 1e-3


@pytest.mark.parametrize("pose_dim", [9, 7])
def test_disentangled_loss_gradient_matches(pose_dim):
    """d(sum of the loss)/d(head outputs): what the train step backpropagates."""
    gt, TCO_in, out, K, pts, _ = loss_inputs(pose_dim, seed=1)
    ref = jax.grad(lambda o: jl.loss_refiner_CO_disentangled(
        _j(gt), _j(TCO_in), o, _j(K), _j(pts), pose_dim=pose_dim).sum())(_j(out))
    o = _t(out).requires_grad_()
    tl.loss_refiner_CO_disentangled(_t(gt), _t(TCO_in), o, _t(K), _t(pts),
                                    pose_dim=pose_dim).sum().backward()
    _close_rel(o.grad, ref, 1e-5, "d loss / d outputs")


@pytest.mark.parametrize("pose_dim", [9, 7])
def test_aux_regression_loss_matches(pose_dim):
    gt, TCO_in, out, K, _, _ = loss_inputs(pose_dim, seed=2)
    for lever in (0.05, 0.3):
        ref = jl.loss_refiner_aux_regression(_j(gt[:, 0]), _j(TCO_in), _j(out), _j(K),
                                             pose_dim=pose_dim, rot_lever_m=lever)
        port = tl.loss_refiner_aux_regression(_t(gt[:, 0]), _t(TCO_in), _t(out), _t(K),
                                              pose_dim=pose_dim, rot_lever_m=lever)
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-6, atol=ATOL_LOSS)


@pytest.mark.parametrize("masked", [False, True])
def test_symmetric_add_and_adds_losses_match(masked):
    gt, TCO_in, _, _, pts, valid = loss_inputs(9, seed=3)
    TCO_pred = random_poses(np.random.RandomState(4), 4)
    v = valid if masked else None
    _close(tl.loss_CO_symmetric(_t(gt), _t(TCO_pred), _t(pts), None if v is None else _t(v)),
           jl.loss_CO_symmetric(_j(gt), _j(TCO_pred), _j(pts), None if v is None else _j(v)),
           ATOL_LOSS)
    _close(tl.compute_ADD_L1_loss(_t(gt[:, 0]), _t(TCO_pred), _t(pts)),
           jl.compute_ADD_L1_loss(_j(gt[:, 0]), _j(TCO_pred), _j(pts)), ATOL_LOSS)
    _close(tl.compute_ADDS_loss(_t(gt[:, 0]), _t(TCO_pred), _t(pts)),
           jl.compute_ADDS_loss(_j(gt[:, 0]), _j(TCO_pred), _j(pts)), ATOL_LOSS)


# -- colour jitter ----------------------------------------------------------------

def jax_jitter_draws(key, B):
    """color_jitter's draws, recreated with jax.random (image_aug.py:113-137)."""
    keys = jax.random.split(key, 10)
    draws = {}
    for i, (op, (lo, hi)) in enumerate(taug._RANGES.items()):
        factor = jax.random.uniform(keys[2 * i], (B,), minval=lo, maxval=hi)
        draws[op] = (_t(factor), _t(jax.random.uniform(keys[2 * i + 1], (B,))))
    return draws


@pytest.mark.parametrize("p", [0.4, 1.0])
def test_color_jitter_matches_with_recreated_draws(p):
    """The whole chain is ill-conditioned in float32: factors up to 50
    (sharpness, contrast) times 20 (colour) times 6 (brightness) amplify
    last-bit differences, and the JAX chain itself lies up to 1.5e-2 from
    the same chain in float64 at p=1. So the port is held to the JAX
    package's own accuracy: no farther from the float64 chain (the port's
    arithmetic in float64, same draws) than 1.5 times the JAX chain is, and
    within 3 times that distance of the JAX chain."""
    rng = np.random.RandomState(5)
    B = 6
    images = rng.uniform(size=(B, 3, 40, 56)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    draws = jax_jitter_draws(key, B)
    ref = np.asarray(jaug.color_jitter(key, _j(images), p=p))
    port = taug.apply_color_jitter(_t(images), draws, p=p).numpy()
    exact = taug.apply_color_jitter(_t(images).double(),
                                    {k: (f.double(), c) for k, (f, c) in draws.items()},
                                    p=p).numpy()
    ref_err = float(np.abs(ref - exact).max())
    assert float(np.abs(port - exact).max()) <= 1.5 * ref_err + 1e-6
    assert float(np.abs(port - ref).max()) <= 3 * ref_err + 1e-6
    assert np.abs(ref - images).max() > 0.1


def test_color_jitter_parts_match():
    """Each operator on its own: the filters at atol 1e-6, each blend with
    factors up to 50 at atol 1e-5 (one factor times a few ulps)."""
    rng = np.random.RandomState(6)
    B = 3
    images = rng.uniform(size=(B, 3, 24, 30)).astype(np.float32)
    sigma = np.array([1.0, 2.2, 3.0], np.float32)
    _close(taug._gaussian_blur(_t(images), _t(sigma)), jaug._gaussian_blur(_j(images), _j(sigma)),
           ATOL_LOSS)
    _close(taug._smooth3x3(_t(images)), jaug._smooth3x3(_j(images)), ATOL_LOSS)
    lum = np.asarray(jaug._luminance(_j(images)))
    _close(taug._luminance(_t(images)), lum, ATOL_LOSS)
    f = np.array([0.3, 12.0, 49.0], np.float32)
    mean = np.round(lum.mean(axis=(1, 2)) * 255.0 + 0.5) / 255.0
    for deg_t, deg_j in ((taug._smooth3x3(_t(images)), jaug._smooth3x3(_j(images))),
                         (_t(mean[:, None, None, None]), _j(mean[:, None, None, None])),
                         (torch.zeros(B, 3, 24, 30), 0.0),
                         (_t(lum[:, None]), _j(lum[:, None]))):
        _close(taug._blend(_t(images), deg_t, _t(f)),
               jaug._per_sample_blend(_j(images), deg_j, _j(f)), 1e-5)


def test_color_jitter_draws_from_its_generator():
    images = torch.rand(4, 3, 16, 16, generator=torch.Generator().manual_seed(0))
    a = taug.color_jitter(images, torch.Generator().manual_seed(1), p=1.0)
    b = taug.color_jitter(images, torch.Generator().manual_seed(1), p=1.0)
    assert torch.equal(a, b) and a.min() >= 0 and a.max() <= 1
    assert torch.equal(taug.color_jitter(images, torch.Generator().manual_seed(1), p=0.0),
                       images)


# -- EfficientNet in train mode ---------------------------------------------------

@pytest.fixture(scope="module")
def b0_train():
    """flax EfficientNet-B0 variables with random BN statistics and the port's
    B0 loaded from them (drop-connect 0 on both), and an input."""
    rng = np.random.RandomState(0)
    bb = JEfficientNet(variant="efficientnet-b0", in_channels=6, drop_connect_rate=0.0)
    x = rng.uniform(size=(4, 64, 64, 6)).astype(np.float32)
    v = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k, x: bb.init(k, x, train=False))(jax.random.PRNGKey(0), _j(x[:1])))
    v = {"params": v["params"], "batch_stats": v["batch_stats"]}
    _randomize_stats(v["params"], rng)
    _randomize_stats(v["batch_stats"], rng)
    sd = jax_pose_variables_to_state_dict(
        {"params": {"EfficientNet_0": v["params"], "pose_fc": {"kernel": np.zeros((1280, 9)),
                                                               "bias": np.zeros(9)}},
         "batch_stats": {"EfficientNet_0": v["batch_stats"]}}, "efficientnet-b0")
    net = EfficientNet("efficientnet-b0", in_channels=6, drop_connect_rate=0.0)
    net.load_state_dict({k[len("backbone."):]: t for k, t in sd.items()
                         if k.startswith("backbone.")})
    proj = rng.normal(size=(4, 1280, 2, 2)).astype(np.float32)
    return bb, v, net, x, proj


def test_efficientnet_train_mode_matches_flax(b0_train):
    """Forward with batch statistics, the running statistics' update (flax:
    momentum 0.99, biased variance) and the parameter gradients of a random
    projection of the features."""
    bb, v, net, x, proj = b0_train

    def f(params):
        feats, upd = bb.apply({"params": params, "batch_stats": v["batch_stats"]}, _j(x),
                              train=True, mutable=["batch_stats"])
        return (feats * _j(proj.transpose(0, 2, 3, 1))).sum(), (feats, upd)

    (_, (feats, upd)), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(v["params"])
    net.train()
    port = net(_t(x).permute(0, 3, 1, 2))
    (port * _t(proj)).sum().backward()
    _close_rel(port, np.asarray(feats).transpose(0, 3, 1, 2), REL_FEAT, "features")

    ref_stats = jax_pose_variables_to_state_dict(
        {"params": {"EfficientNet_0": v["params"], "pose_fc": {"kernel": np.zeros((1280, 9)),
                                                               "bias": np.zeros(9)}},
         "batch_stats": {"EfficientNet_0": upd["batch_stats"]}}, "efficientnet-b0")
    ref_grads = jax_pose_variables_to_state_dict(
        {"params": {"EfficientNet_0": grads, "pose_fc": {"kernel": np.zeros((1280, 9)),
                                                         "bias": np.zeros(9)}},
         "batch_stats": {"EfficientNet_0": upd["batch_stats"]}}, "efficientnet-b0")
    buffers = dict(net.named_buffers())
    n_moved = 0
    for name, b in buffers.items():
        if name.endswith(("running_mean", "running_var")):
            _close_rel(b, ref_stats[f"backbone.{name}"], REL_STATS, name)
            n_moved += 1
    assert n_moved == 2 * 49
    floor = max(float(np.abs(np.asarray(ref_grads[f"backbone.{n}"])).max())
                for n, _ in net.named_parameters())
    for name, p in net.named_parameters():
        ref = ref_grads[f"backbone.{name}"]
        if structurally_zero(name):
            assert float(p.grad.abs().max()) <= REL_ZERO * floor, name
            assert float(np.abs(np.asarray(ref)).max()) <= REL_ZERO * floor, name
        else:
            _close_rel(p.grad, ref, REL_GRAD_BACKBONE, name)


def test_batchnorm_update_is_flax_not_torch():
    """The running variance moves by the biased batch variance (torch's own
    BatchNorm2d would use the unbiased one), and frozen_stats holds it."""
    net = EfficientNet("efficientnet-b0", in_channels=6).train()
    bn = net._bn0
    x = torch.randn(2, 6, 16, 16, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        h = net._conv_stem(x)
        var = h.var(dim=(0, 2, 3), unbiased=False)
        mean = h.mean(dim=(0, 2, 3))
        bn(h)
        pre = bn.running_var.clone()
        assert torch.allclose(bn.running_mean, 0.01 * mean, atol=1e-6)
        assert torch.allclose(pre, 0.99 + 0.01 * var, rtol=1e-5)
        with frozen_stats(net):
            bn(h)
        assert torch.equal(bn.running_var, pre)


# -- drop-connect and remat --------------------------------------------------------

def test_drop_connect_masks():
    """Rates grow with the block index as in the JAX package; a mask drops a
    whole sample's residual branch and scales the kept ones by 1/(1-rate)."""
    net = EfficientNet("efficientnet-b0", in_channels=6, drop_connect_rate=0.2)
    rates = [b.drop_rate for b in net._blocks]
    n = len(rates)
    expect = [0.2 * i / n if b.residual else 0.0 for i, b in enumerate(net._blocks)]
    assert rates == expect and max(rates) > 0.15
    masks = net.draw_drop_masks(20000, torch.Generator().manual_seed(0))
    for m, r in zip(masks, rates):
        if r == 0:
            assert m is None
        else:
            assert m.shape == (20000,) and m.dtype == torch.bool
            assert abs(float(m.float().mean()) - (1 - r)) < 0.015

    block = net._blocks[-2]
    assert block.residual and block.drop_rate > 0
    block.train()
    x = torch.randn(6, block._project_conv.out_channels, 8, 8,
                    generator=torch.Generator().manual_seed(1))
    keep = torch.tensor([True, False, True, True, False, True])
    with torch.no_grad(), frozen_stats(block):
        whole = block(x)
        dropped = block(x, keep)
    branch = whole - x
    assert torch.equal(dropped[~keep], x[~keep])
    torch.testing.assert_close(dropped[keep], x[keep] + branch[keep] / (1 - block.drop_rate),
                               rtol=1e-6, atol=1e-6)


def tiny_train_cfg(**predictor_kw):
    pred = PosePredictorConfig(backbone="efficientnet-b0", render_size=(48, 64), n_points_crop=8,
                               **predictor_kw)
    return tpt.PoseTrainConfig(predictor=pred, n_iterations=2, n_points_loss=8, batch_size=3,
                               epoch_size=3, n_epochs_warmup=1, input_generator="gt+noise")


def port_batch(B=3, seed=0):
    rng = np.random.RandomState(seed)
    TCO = random_poses(rng, B, z=(0.45, 0.6))
    TCO[:, :2, 3] = rng.uniform(-0.03, 0.03, (B, 2))
    return dict(images=rng.uniform(size=(B, 3, 120, 160)).astype(np.float32),
                K=np.array(make_K(B)), TCO=TCO,
                bboxes=np.tile(np.array([60.0, 40.0, 100.0, 80.0], np.float32), (B, 1)),
                label_ids=(np.arange(B) % 2).astype(np.int32))


def test_remat_on_and_off_agree():
    """Activation checkpointing recomputes the forward in backward: the same
    masks, and the running statistics moved once per iteration, not twice."""
    runs = {}
    for remat in (True, False):
        cfg = tiny_train_cfg(head_init_scale=0.01, drop_connect_rate=0.5, remat=remat)
        state = tpt.create_train_state(cfg, "cpu")
        db = build_mesh_db(port_specs(), device="cpu")
        batch = {k: torch.as_tensor(v) for k, v in port_batch().items()}
        draws = tpt.draw_step(cfg, state.pp, 3, 8, torch.Generator().manual_seed(0))
        loss, _ = tpt.pose_loss(state.pp, cfg, db, batch, draws)
        loss.backward()
        net = state.pp.net
        runs[remat] = (loss.detach(), {n: p.grad.clone() for n, p in net.named_parameters()},
                       {n: b.clone() for n, b in net.named_buffers()})
    assert any(m is not None and not m.all() for m in draws["drop_masks"][0])
    (l1, g1, b1), (l0, g0, b0) = runs[True], runs[False]
    torch.testing.assert_close(l1, l0, rtol=1e-6, atol=0)
    for n in g0:
        torch.testing.assert_close(g1[n], g0[n], rtol=1e-5, atol=1e-7, msg=n)
    for n in b0:
        torch.testing.assert_close(b1[n], b0[n], rtol=1e-6, atol=1e-7, msg=n)
    assert float((b0["backbone._bn0.running_var"] - 1).abs().max()) > 1e-3


# -- lr schedule -------------------------------------------------------------------

def test_lr_schedule_matches():
    """At the boundaries of tests/test_training.py:128-140 and around them."""
    cfg = tpt.PoseTrainConfig(batch_size=8, epoch_size=64)
    jcfg = jpt.PoseTrainConfig(batch_size=8, epoch_size=64)
    port, ref = tpt.lr_schedule(cfg), jpt.lr_schedule(jcfg)
    spe, warm = 8, 50 * 8
    for step in (0, 1, warm // 2 - 1, warm - 1, warm, warm + 10, 500 * spe - 1, 500 * spe,
                 500 * spe + 1, 1000 * spe, 1000 * spe + 3):
        np.testing.assert_allclose(port(step), float(ref(step)), rtol=1e-6, err_msg=str(step))
    assert abs(port(warm // 2 - 1) - 0.5 * cfg.lr) < 1e-6
    assert abs(port(warm + 10) - cfg.lr) < 1e-7
    assert abs(port(500 * spe + 1) - 0.1 * cfg.lr) < 1e-7


# -- two full train steps against make_train_step --------------------------------------

def jax_step_draws(key, B, n_points, n_iterations, backbone):
    """The port's draws for a JAX step key: pose_loss splits it into (points,
    init, forward, augmentation) keys; drop-connect is 0 in the parity run."""
    k_pts, k_init, _, _ = jax.random.split(key, 4)
    pt_ids = jax.random.choice(k_pts, n_points, (n_points,), replace=False)
    return dict(point_ids=_t(pt_ids).long(), pose_noise=jax_pose_noise(k_init, B),
                drop_masks=[backbone.draw_drop_masks(B, torch.Generator())
                            for _ in range(n_iterations)], jitter=None)


STEP_B = 8


def run_train_steps(n_steps=2, B=STEP_B):
    """The JAX package's make_train_step and the port's train step on the
    same batch and draws: EfficientNet-B0, 48x64 renders of the cube meshes
    (12 triangles, under every binning budget), 2 iterations, gt+noise,
    head_init_scale 0.01, drop-connect 0, batch B. Before each step the
    port's state is set to the JAX package's (params and batch_stats through
    utils.weights, the Adam moments and count copied), so each step is held
    on its own: Adam's sign-like first step moves a parameter whose gradient
    is within rounding of 0 by up to lr either way, and the states would
    drift apart by that much. Returns [(port, JAX, state before) per step]
    and the port's config."""
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
    jpp, jstate = jpt.create_train_state(jcfg, jax.random.PRNGKey(0))
    jstep = jpt.make_train_step(jpp, jcfg, j_build_mesh_db(cube_specs()))
    state = tpt.create_train_state(cfg, "cpu")
    step = tpt.make_train_step(cfg, build_mesh_db(port_specs(), device="cpu"))
    b = port_batch(B, seed=3)
    jbatch = {k: _j(v) for k, v in b.items()}
    batch = {k: _t(v) for k, v in b.items()}
    batch["label_ids"] = batch["label_ids"].long()

    def snapshot_jax(jstate):
        return dict(variables=jax.tree_util.tree_map(
                        np.asarray, {"params": jstate.params, "batch_stats": jstate.batch_stats}),
                    mu=jax.tree_util.tree_map(np.asarray, jstate.opt_state[1][0].mu),
                    nu=jax.tree_util.tree_map(np.asarray, jstate.opt_state[1][0].nu),
                    step=int(jstate.step))

    out = []
    for i in range(n_steps):
        before = snapshot_jax(jstate)
        load_jax_train_state(state, before["variables"]["params"],
                             before["variables"]["batch_stats"])
        if i:
            stats = before["variables"]["batch_stats"]
            mu, nu = as_port_names(before["mu"], stats), as_port_names(before["nu"], stats)
            for n, p in state.pp.net.named_parameters():
                state.optimizer.state[p]["exp_avg"].copy_(mu[n])
                state.optimizer.state[p]["exp_avg_sq"].copy_(nu[n])
        before["state_dict"] = {k: v.clone() for k, v in state.pp.net.state_dict().items()}
        key = jax.random.PRNGKey(i + 1)
        jstate, jm = jstep(jstate, jbatch, key)
        ref = dict(snapshot_jax(jstate), metrics={k: float(v) for k, v in jm.items()})
        draws = jax_step_draws(key, B, 8, 2, state.pp.net.backbone)
        before["inputs"] = (batch, draws)
        m = step(state, batch, draws)
        net = state.pp.net
        port = dict(metrics={k: float(v) for k, v in m.items()},
                    state_dict={k: v.clone() for k, v in net.state_dict().items()},
                    grads={n: p.grad.clone() for n, p in net.named_parameters()},
                    exp_avg={n: state.optimizer.state[p]["exp_avg"].clone()
                             for n, p in net.named_parameters()},
                    exp_avg_sq={n: state.optimizer.state[p]["exp_avg_sq"].clone()
                                for n, p in net.named_parameters()},
                    step=state.step)
        out.append((port, ref, before))
    return out, cfg


def float64_step(cfg, before):
    """One step's unclipped gradients and moved running statistics with the
    backbone in float64 (the rest of the step as it is), from the state
    before it: the oracle that measures either float32 side's rounding."""
    state = tpt.create_train_state(cfg, "cpu")
    state.pp.net.load_state_dict(before["state_dict"])
    backbone = state.pp.net.backbone.double()
    forward = backbone.forward
    backbone.forward = lambda x, masks=None: forward(x.double(), masks).float()
    loss, metrics = tpt.pose_loss(state.pp, cfg, build_mesh_db(port_specs(), device="cpu"),
                                  *before["inputs"])
    loss.backward()
    grads = {n: p.grad.double() for n, p in state.pp.net.named_parameters()}
    stats = {n: b.double() for n, b in state.pp.net.named_buffers()
             if n.endswith(("running_mean", "running_var"))}
    return grads, stats, {k: float(v) for k, v in metrics.items()}


def stats_error(a, ref, name, var_ref):
    """|a - ref| over the tensor's scale: its max for a running variance; for
    a running mean the larger of its max and the weight of two batch means
    (1 - 0.99²) times the channels' spread, sqrt(running var), since a batch
    mean's rounding follows the spread of the activations, not their mean
    (which is ~0 in many channels)."""
    a, ref = torch.as_tensor(np.asarray(a)).double(), torch.as_tensor(np.asarray(ref)).double()
    scale = float(ref.abs().max())
    if name.endswith("running_mean"):
        spread = float(torch.as_tensor(np.asarray(var_ref)).double().sqrt().max())
        scale = max(scale, (1 - 0.99 ** 2) * spread)
    return float((a - ref).abs().max()) / scale


def as_port_names(tree, stats):
    """A JAX params-shaped tree (params, Adam moments) under the port's names."""
    return jax_pose_variables_to_state_dict({"params": tree, "batch_stats": stats},
                                            "efficientnet-b0")


@pytest.fixture(scope="module")
def train_steps():
    return run_train_steps()


def test_train_step_loss_and_metrics_match(train_steps):
    steps = train_steps[0]
    for i, (port, ref, _) in enumerate(steps):
        assert set(port["metrics"]) == set(ref["metrics"]) == {
            "loss_total", "loss_TCO-iter=1", "loss_TCO-iter=2", "loss_orn", "loss_xy", "loss_z",
            "grad_norm"}
        for k, v in ref["metrics"].items():
            np.testing.assert_allclose(port["metrics"][k], v, rtol=RTOL_STEP_JAX,
                                       err_msg=f"step {i + 1} {k}")
        assert port["step"] == ref["step"] == i + 1
    assert steps[0][1]["metrics"]["grad_norm"] > 0.5  # the clip acts


def unclipped(port, clip):
    norm = port["metrics"]["grad_norm"]
    return {n: g.double() * (norm / clip if norm >= clip else 1.0)
            for n, g in port["grads"].items()}


def jax_clipped_grads(ref, before):
    """The clipped gradients of a JAX step, from its Adam moments:
    g = (mu - 0.9·mu_before) / (1 - 0.9)."""
    stats = ref["variables"]["batch_stats"]
    mu = as_port_names(ref["mu"], stats)
    mu0 = as_port_names(before["mu"], stats)
    return {n: (np.asarray(mu[n], np.float64) - 0.9 * np.asarray(mu0[n], np.float64)) / (1 - 0.9)
            for n in mu}


def test_train_step_matches_float64(train_steps):
    """Each step's loss, metrics, gradients and running statistics against
    the same step with a float64 backbone."""
    steps, cfg = train_steps
    for i, (port, _, before) in enumerate(steps):
        exact, exact_stats, exact_metrics = float64_step(cfg, before)
        for k, v in exact_metrics.items():
            np.testing.assert_allclose(port["metrics"][k], v, rtol=RTOL_STEP,
                                       err_msg=f"step {i + 1} {k}")
        norm = float(torch.sqrt(sum((g ** 2).sum() for g in exact.values())))
        np.testing.assert_allclose(port["metrics"]["grad_norm"], norm, rtol=RTOL_STEP)
        grads = unclipped(port, cfg.clip_grad_norm)
        floor = max(float(g.abs().max()) for g in exact.values())
        for n, g in grads.items():
            if structurally_zero(n):
                assert float(g.abs().max()) <= REL_ZERO * floor, n
            else:
                _close_rel(g, exact[n].numpy(), REL_GRAD_F64, f"step {i + 1} grad {n}")
        for n, t in exact_stats.items():
            var = exact_stats[n.replace("running_mean", "running_var")]
            assert stats_error(port["state_dict"][n], t, n, var) <= REL_STATS, \
                f"step {i + 1} {n}"


def test_train_step_gradients_match(train_steps):
    """Each step's clipped gradients against the JAX step's, read from its
    first Adam moment, and the moments themselves."""
    steps = train_steps[0]
    for i, (port, ref, before) in enumerate(steps):
        ref_grads = jax_clipped_grads(ref, before)
        floor = max(float(g.abs().max()) for g in port["grads"].values())
        stats = ref["variables"]["batch_stats"]
        mu, nu = as_port_names(ref["mu"], stats), as_port_names(ref["nu"], stats)
        for n, g in port["grads"].items():
            if structurally_zero(n):
                assert float(np.abs(ref_grads[n]).max()) <= REL_ZERO * floor, n
                continue
            _close_rel(g, ref_grads[n], REL_GRAD_JAX, f"step {i + 1} grad {n}")
            _close_rel(port["exp_avg"][n], mu[n], REL_GRAD_JAX, f"step {i + 1} mu {n}")
            _close_rel(port["exp_avg_sq"][n], nu[n], 2 * REL_GRAD_JAX, f"step {i + 1} nu {n}")


def test_train_step_running_stats_match(train_steps):
    for i, (port, ref, _) in enumerate(train_steps[0]):
        sd = as_port_names(ref["variables"]["params"], ref["variables"]["batch_stats"])
        for n, t in port["state_dict"].items():
            if n.endswith(("running_mean", "running_var")):
                var = sd[n.replace("running_mean", "running_var")]
                assert stats_error(t, sd[n], n, var) <= REL_STATS_JAX, f"step {i + 1} {n}"


def adam_update(g, m0, v0, t, lr):
    """The optax/torch Adam step (b1 0.9, b2 0.999, eps 1e-8) at count t."""
    m = 0.9 * m0 + 0.1 * g
    v = 0.999 * v0 + 0.001 * g * g
    return lr * (m / (1 - 0.9 ** t)) / ((v / (1 - 0.999 ** t)).sqrt() + 1e-8)


def test_train_step_params_match(train_steps):
    """Each parameter within 1e-6 of the JAX step's, beyond what the two
    steps' gradient difference moves Adam's update (float64, from the same
    moments), and within 2·lr everywhere: Adam's first step moves each
    parameter by about lr·sign(g), so a gradient within rounding of 0 may
    send the two one way and the other."""
    steps, cfg = train_steps
    for i, (port, ref, before) in enumerate(steps):
        sd = as_port_names(ref["variables"]["params"], ref["variables"]["batch_stats"])
        stats = before["variables"]["batch_stats"]
        m0, v0 = as_port_names(before["mu"], stats), as_port_names(before["nu"], stats)
        ref_grads = jax_clipped_grads(ref, before)
        for n, g in port["grads"].items():
            own = adam_update(g.double(), m0[n].double(), v0[n].double(), i + 1, cfg.lr)
            other = adam_update(torch.as_tensor(ref_grads[n]), m0[n].double(), v0[n].double(),
                                i + 1, cfg.lr)
            p0 = before["state_dict"][n].double()
            # the port's optimizer is the optax formula on its own gradients
            _close(port["state_dict"][n].double() - (p0 - own), 0.0, ATOL_PARAM, n)
            err = (port["state_dict"][n].double() - sd[n].double()).abs()
            assert bool((err <= (own - other).abs() + ATOL_PARAM).all()), f"step {i + 1} {n}"
            assert float(err.max()) <= 2 * cfg.lr + ATOL_PARAM, f"step {i + 1} {n}"
    moved = max(float((steps[-1][0]["state_dict"][n] - steps[0][2]["state_dict"][n]).abs().max())
                for n in steps[-1][0]["grads"])
    assert moved > 1e-4


def test_bridged_jax_state_gives_the_same_loss(train_steps):
    """load_jax_train_state puts a JAX TrainState (head_init_scale 0.01) into the
    port's: step 1's loss is the JAX package's from the same state."""
    port, ref, _ = train_steps[0][0]
    np.testing.assert_allclose(port["metrics"]["loss_total"], ref["metrics"]["loss_total"],
                               rtol=RTOL_STEP)


# -- configs and samplers ------------------------------------------------------------

COVERED = ["tless-coarse", "tless-refiner", "tless-coarse-ablation-loss",
           "tless-refiner-ablation-loss", "tless-coarse-ablation-rot",
           "tless-refiner-ablation-rot", "tless-coarse-ablation-augm",
           "tless-refiner-ablation-augm", "ycbv-refiner-syntonly", "ycbv-refiner-finetune",
           "bop-ycbv-pbr-refiner", "bop-tless-synt+real-coarse", "bop-lm-pbr-coarse",
           "bop-hb-synt+real-refiner", "procedural-coarse", "procedural-refiner",
           "tless-refiner-ablation-network", "tless-coarse-ablation-network",
           "procedural-refiner-mini", "procedural-refiner-mini-moments", "procedural-diag",
           "procedural-diag-rot", "procedural-diag-corr", "procedural-diag-corr-flat-lk",
           "procedural-diag-gap-nodiff", "procedural-diag-sc-lk", "procedural-diag-b3-fp32-dc0",
           "procedural-diag-coarse-lr0.0003-vs20-ep5-it2-lev0.2-rot10-hi0.01-zw2-devaug",
           "procedural-diag-texsolo-aux0.5", "procedural-diag-solo"]
PREDICTOR_FIELDS = ("backbone", "render_size", "pose_dim", "pooling", "input_mode", "vxvy_scale",
                    "n_points_crop", "lamb", "head_init_scale", "drop_connect_rate")


@pytest.mark.parametrize("debug", [False, True])
@pytest.mark.parametrize("name", COVERED)
def test_make_cfg_matches(name, debug):
    port, ref = tconfigs.make_cfg(name, debug), jconfigs.make_cfg(name, debug)
    for f in dataclasses.fields(ref):
        if f.name != "train":
            assert getattr(port, f.name) == getattr(ref, f.name), f.name
    for f in dataclasses.fields(ref.train):
        if f.name != "predictor":
            assert getattr(port.train, f.name) == getattr(ref.train, f.name), f.name
    for f in PREDICTOR_FIELDS:
        assert getattr(port.train.predictor, f) == getattr(ref.train.predictor, f), f
    assert str(port.train.predictor.compute_dtype).split(".")[-1] == \
        str(np.dtype(ref.train.predictor.compute_dtype))
    # remat is the port's own default: off (see PosePredictorConfig.remat)
    assert ref.train.predictor.remat and not port.train.predictor.remat


@pytest.mark.parametrize("name", ["tless-refiner-ablation-network", "procedural-diag-rot",
                                  "procedural-diag-corr", "procedural-refiner-mini",
                                  "procedural-refiner-mini-moments"])
def test_make_cfg_refuses_unported_models(name):
    """These configs' models are ported (test_make_cfg_matches holds them to
    the JAX package's). The JAX package's depthwise lowerings are ported too:
    an EfficientNet predictor takes +dwdense / +dwshift; a mistyped suffix
    is refused with the JAX package's message."""
    pred = tconfigs.make_cfg(name).train.predictor
    assert pred.backbone == jconfigs.make_cfg(name).train.predictor.backbone
    if pred.backbone.startswith("efficientnet"):
        for impl in ("dense", "shift"):
            dataclasses.replace(pred, backbone=f"{pred.backbone}+dw{impl}")
        with pytest.raises(ValueError, match="unknown depthwise lowering 'dens'"):
            dataclasses.replace(pred, backbone=f"{pred.backbone}+dwdens")


def test_make_cfg_refuses_unknown_names():
    for name in ("tless-refiner-ablation-foo", "bop-xyz-pbr-coarse", "nope"):
        with pytest.raises(ValueError):
            tconfigs.make_cfg(name)


@pytest.mark.parametrize("n,epoch_size", [(10, 4), (37, 37), (5, 100)])
def test_partial_sampler_orders_match(n, epoch_size):
    ds = list(range(n))
    for seed in (0, 1, 7):
        assert list(PartialSampler(ds, epoch_size, seed)) == \
            list(JPartialSampler(ds, epoch_size, seed))
        assert len(PartialSampler(ds, epoch_size, seed)) == min(n, epoch_size)
    assert list(ListSampler([3, 1, 2])) == [3, 1, 2] and len(ListSampler([3, 1])) == 2
