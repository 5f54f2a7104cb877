"""Port parity: EfficientNet-B0 features and the pose head with weights carried
from the JAX package, plus the weight bridge both ways.

fp32 on the CPU at 64×64 (stride-2 convs there need TF "SAME"'s asymmetric
padding). BatchNorm statistics and the pose kernel are random, so neither
BN nor the head is an identity. Tolerance: atol 1e-4 on features of
magnitude ~1 after 16 MBConv blocks (conv summation order differs between
XLA and oneDNN); the converters are exact.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from cosypose_tpu.models import PosePredictor as JPosePredictor
from cosypose_tpu.models import PosePredictorConfig as JConfig
from cosypose_tpu.models.efficientnet import EfficientNet as JEfficientNet
from cosypose_tpu.utils.torch_compat import convert_pose_checkpoint
from cosypose_tpu_torch.models.efficientnet import EfficientNet
from cosypose_tpu_torch.models.pose_predictor import PosePredictor, PosePredictorConfig
from cosypose_tpu_torch.utils.weights import jax_pose_variables_to_state_dict

ATOL = 1e-4


def _randomize_stats(tree, rng):
    for k, v in tree.items():
        if isinstance(v, dict):
            _randomize_stats(v, rng)
        elif k == "mean":
            tree[k] = rng.normal(0.0, 0.2, v.shape).astype(np.float32)
        elif k == "var":
            tree[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k in ("scale", "bias"):
            tree[k] = (np.asarray(v) + rng.normal(0.0, 0.1, v.shape)).astype(np.float32)


@pytest.fixture(scope="module")
def b0_pair():
    """JAX PoseNet-B0 variables with random BN stats and head, and the port's
    PosePredictor loaded from them."""
    rng = np.random.RandomState(0)
    jpp = JPosePredictor(JConfig(backbone="efficientnet-b0", render_size=(64, 64)))
    v = jax.tree_util.tree_map(np.asarray, jpp.init(jax.random.PRNGKey(0)))
    v = {"params": v["params"], "batch_stats": v["batch_stats"]}
    _randomize_stats(v["params"], rng)
    _randomize_stats(v["batch_stats"], rng)
    k = v["params"]["pose_fc"]["kernel"]
    v["params"]["pose_fc"]["kernel"] = rng.normal(0.0, 0.05, k.shape).astype(np.float32)
    pp = PosePredictor(PosePredictorConfig(backbone="efficientnet-b0", render_size=(64, 64)),
                       device="cpu")
    pp.net.load_state_dict(jax_pose_variables_to_state_dict(v, "efficientnet-b0"))
    x = rng.uniform(size=(2, 64, 64, 6)).astype(np.float32)
    return jpp, v, pp, x


def test_backbone_features_match(b0_pair):
    jpp, v, pp, x = b0_pair
    bb = JEfficientNet(variant="efficientnet-b0", in_channels=6)
    ref = bb.apply({"params": v["params"]["EfficientNet_0"],
                    "batch_stats": v["batch_stats"]["EfficientNet_0"]},
                   jnp.asarray(x), train=False)
    with torch.no_grad():
        port = pp.net.backbone(torch.as_tensor(x).permute(0, 3, 1, 2))
    ref = np.asarray(ref).transpose(0, 3, 1, 2)
    assert port.shape == ref.shape == (2, 1280, 2, 2)
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(port.numpy(), ref, atol=ATOL, rtol=0)


def test_pose_head_matches(b0_pair):
    jpp, v, pp, x = b0_pair
    ref = np.asarray(jpp.net.apply(v, jnp.asarray(x), train=False))
    with torch.no_grad():
        port = pp.net(torch.as_tensor(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(port.numpy(), ref, atol=ATOL, rtol=0)
    assert np.abs(ref - np.array([1, 0, 0, 0, 1, 0, 0, 0, 1])).max() > 1e-3


def test_weight_bridge_round_trip(b0_pair):
    """The reference-torch converter reads the port's state_dict back to the
    same JAX variables: an independent check of names and layouts."""
    _, v, pp, _ = b0_pair
    back = convert_pose_checkpoint(pp.net.state_dict(), variant="efficientnet-b0")
    flat_v = jax.tree_util.tree_leaves_with_path(v)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_v) == len(flat_b)
    for path, leaf in flat_v:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), leaf, err_msg=str(path))


@pytest.mark.parametrize("variant", [f"efficientnet-b{i}" for i in range(8)])
def test_variant_widths_and_parameter_count(variant):
    """Every B0–B7 table entry builds the JAX package's parameter shapes."""
    jax_shapes = jax.eval_shape(
        lambda: JEfficientNet(variant=variant, in_channels=6).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 6)), train=False))
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(jax_shapes["params"]))
    net = EfficientNet(variant, in_channels=6)
    n_port = sum(p.numel() for p in net.parameters())
    assert n_port == n_jax
    assert net.n_features == JEfficientNet(variant=variant).n_features


@pytest.fixture(scope="module")
def lowered(b0_pair):
    """The port's PosePredictor in each depthwise lowering, loaded from the
    same JAX variables."""
    _, v, pp, _ = b0_pair
    out = {"conv": pp}
    for impl in ("shift", "dense"):
        name = f"efficientnet-b0+dw{impl}"
        p = PosePredictor(PosePredictorConfig(backbone=name, render_size=(64, 64)), device="cpu")
        p.net.load_state_dict(jax_pose_variables_to_state_dict(v, name))
        out[impl] = p
    return out


@pytest.mark.parametrize("impl", ["shift", "dense"])
def test_depthwise_lowerings_match_jax(b0_pair, lowered, impl):
    """Features and pose outputs of `+dw<impl>` against the JAX package's same
    lowering and against the port's grouped conv, from the same weights."""
    _, v, _, x = b0_pair
    bb = JEfficientNet(variant="efficientnet-b0", in_channels=6, dw_impl=impl)
    ref = np.asarray(bb.apply({"params": v["params"]["EfficientNet_0"],
                               "batch_stats": v["batch_stats"]["EfficientNet_0"]},
                              jnp.asarray(x), train=False)).transpose(0, 3, 1, 2)
    jpp = JPosePredictor(JConfig(backbone=f"efficientnet-b0+dw{impl}", render_size=(64, 64)))
    ref_head = np.asarray(jpp.net.apply(v, jnp.asarray(x), train=False))
    xt = torch.as_tensor(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        feats = lowered[impl].net.backbone(xt)
        head = lowered[impl].net(xt)
        feats_conv = lowered["conv"].net.backbone(xt)
    assert lowered[impl].net.backbone._blocks[3]._depthwise_conv.impl == impl
    np.testing.assert_allclose(feats.numpy(), ref, atol=ATOL, rtol=0)
    np.testing.assert_allclose(head.numpy(), ref_head, atol=ATOL, rtol=0)
    np.testing.assert_allclose(feats.numpy(), feats_conv.numpy(), atol=ATOL, rtol=0)


# bf16 under autocast: the lowerings round differently (the shift lowering
# accumulates its k² products in bf16, as the JAX module does in its compute
# dtype; cuDNN and oneDNN accumulate in fp32), so features are compared to
# the grouped conv's relative to their largest magnitude
BF16_RTOL_OF_MAX = 0.05


@pytest.mark.parametrize("impl", ["shift", "dense"])
def test_depthwise_lowerings_in_bf16_agree_with_the_grouped_conv(b0_pair, lowered, impl):
    x = torch.as_tensor(b0_pair[3]).permute(0, 3, 1, 2)
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
        ref = lowered["conv"].net.backbone(x).float()
        got = lowered[impl].net.backbone(x).float()
    assert got.dtype == ref.dtype and torch.isfinite(got).all()
    err = float((got - ref).abs().max() / ref.abs().max())
    assert err <= BF16_RTOL_OF_MAX, err


def test_config_takes_the_lowerings_and_refuses_a_mistyped_one():
    from cosypose_tpu.models.pose_predictor import make_backbone as j_make_backbone

    for name in ("efficientnet-b3+dwshift", "efficientnet-b3+dwdense", "efficientnet-b3"):
        PosePredictorConfig(backbone=name)
    for bad in ("efficientnet-b3+dwdens", "efficientnet-b3+dwconvx"):
        with pytest.raises(AssertionError) as j:
            j_make_backbone(JConfig(backbone=bad))
        with pytest.raises(ValueError) as t:
            PosePredictorConfig(backbone=bad)
        assert str(t.value) == str(j.value)
