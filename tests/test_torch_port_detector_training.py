"""Port parity: the detector's losses, one train step, its dataset and the
scene-dataset concatenation, against the JAX package on the CPU.

The step: WideResNet-18 CenterNet at 48x80 frames (a 12x20 head grid),
batch 2, 5 classes, random BatchNorm statistics, both cls_modes, instance
masks with mask_pos_weight 2.0, from the same weights and batch. Tolerances
are the pose train step's against JAX (tests/test_torch_port_training.py):
loss terms and grad_norm rtol 3e-5; each clipped gradient within 4e-3 of its
tensor's max from the JAX loss's gradient clipped alike (the JAX step's own
first Adam moment carries its compiled step's rounding: up to 6.1e-3 of a
tensor's max from that gradient, while the port lies within 5e-5 of it and
within 6e-6 of a float64 port step), the deconv biases'
structurally-zero gradients (a train-mode BatchNorm follows them) within
1e-6 of the largest gradient; running statistics within 1e-4
of their scale; parameters within what the two gradients' difference moves
Adam's first step, plus 1e-6, and within 2·lr. focal_loss within rtol 1e-6;
the antialiased shrink of the segmentation within 1e-6 of jax.image.resize
(and off by > 0.1 without antialiasing); gaussian_radius, draw_gaussian and
the dataset's items (0 workers, the BOP fixture of tests/test_data.py)
exactly equal; ConcatSceneDataset's items and frame index equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cosypose_tpu.data import detection_dataset as jdd
from cosypose_tpu.data.bop import BOPDataset as JBOPDataset
from cosypose_tpu.data.wrappers import ConcatSceneDataset as JConcat
from cosypose_tpu.models import detector as jdet
from cosypose_tpu.training import detector_training as jdt
from cosypose_tpu_torch.data import detection_dataset as tdd
from cosypose_tpu_torch.data.bop import BOPDataset
from cosypose_tpu_torch.data.wrappers import ConcatSceneDataset
from cosypose_tpu_torch.models import detector as tdet
from cosypose_tpu_torch.training import detector_training as tdt
from cosypose_tpu_torch.utils.weights import jax_detector_variables_to_state_dict
from tests.test_data import build_bop_fixture
from tests.test_torch_port_backbones import randomize
from tests.test_torch_port_training import ATOL_PARAM, REL_GRAD_JAX, REL_STATS_JAX, \
    REL_ZERO, RTOL_STEP_JAX, adam_update

SIZE = (48, 80)
N_CLASSES = 5
N_OBJ = 4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_batch(seed=0, B=2):
    rng = np.random.RandomState(seed)
    Hm, Wm = SIZE[0] // 4, SIZE[1] // 4
    heat = rng.uniform(0, 0.9, (B, Hm, Wm, N_CLASSES)).astype(np.float32)
    inds = rng.randint(0, Hm * Wm, (B, N_OBJ))
    classes = rng.randint(0, N_CLASSES, (B, N_OBJ))
    obj_mask = rng.uniform(size=(B, N_OBJ)) > 0.3
    obj_mask[:, 0] = True
    for b in range(B):
        for n in range(N_OBJ):
            if obj_mask[b, n]:
                heat[b, inds[b, n] // Wm, inds[b, n] % Wm, classes[b, n]] = 1.0
    return dict(images=rng.randint(0, 256, (B, 3, *SIZE), np.uint8), heatmap=heat,
                wh=rng.uniform(1, 6, (B, N_OBJ, 2)).astype(np.float32),
                offset=rng.uniform(0, 1, (B, N_OBJ, 2)).astype(np.float32),
                inds=inds, classes=classes, obj_mask=obj_mask,
                seg_mask=rng.uniform(size=(B, *SIZE)) > 0.7,
                inst_masks=(rng.uniform(size=(B, N_OBJ, Hm, Wm)) > 0.8).astype(np.uint8))


def test_focal_loss_matches_jax():
    rng = np.random.RandomState(1)
    logits = rng.normal(0, 3, (2, 6, 7, 3)).astype(np.float32)
    targets = rng.uniform(0, 1, logits.shape).astype(np.float32)
    targets[0, 1, 2, 0] = targets[1, 3, 3, 2] = 1.0
    ref = float(jdt.focal_loss(jnp.asarray(logits), jnp.asarray(targets)))
    got = float(tdt.focal_loss(torch.as_tensor(logits), torch.as_tensor(targets)))
    np.testing.assert_allclose(got, ref, rtol=1e-6)


def test_segmentation_shrink_is_antialiased_as_jax():
    seg = (np.random.RandomState(2).uniform(size=(2, 48, 80)) > 0.6).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(seg), (2, 12, 20), method="bilinear"))
    t = torch.as_tensor(seg)[:, None]
    got = F.interpolate(t, size=(12, 20), mode="bilinear", align_corners=False,
                        antialias=True)[:, 0].numpy()
    plain = F.interpolate(t, size=(12, 20), mode="bilinear", align_corners=False)[:, 0].numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)
    assert np.abs(plain - ref).max() > 0.1


def stats_scale_error(a, ref, var_ref, name):
    """|a - ref| over the larger of the tensor's max and, for a running mean,
    (1 - 0.9²) times the channels' spread (a batch mean rounds with the
    spread of the activations)."""
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    scale = np.abs(ref).max()
    if name.endswith("running_mean"):
        scale = max(scale, (1 - 0.9 ** 2) * np.sqrt(np.asarray(var_ref, np.float64)).max())
    return np.abs(a - ref).max() / scale


@pytest.fixture(scope="module", params=["percls", "softmax"])
def steps(request):
    return run_steps(request.param)


def run_steps(cls_mode):
    """One train step of each package from the same weights and batch:
    (cls_mode, the port's config, the port's step, the JAX package's)."""
    dcfg = dict(n_classes=N_CLASSES, cls_mode=cls_mode, n_mask_protos=8)
    kw = dict(batch_size=2, epoch_size=4, n_epochs_warmup=0, lr=1e-3, mask_pos_weight=2.0)
    jcfg = jdt.DetectorTrainConfig(detector=jdet.DetectorConfig(**dcfg), **kw)
    tcfg = tdt.DetectorTrainConfig(detector=tdet.DetectorConfig(**dcfg), **kw)
    model, jstate = jdt.create_detector_train_state(jcfg, jax.random.PRNGKey(0), image_size=SIZE)
    v = jax.tree_util.tree_map(np.asarray, {"params": jstate.params,
                                            "batch_stats": jstate.batch_stats})
    v = jax.tree_util.tree_map(np.array, v)
    rng = np.random.RandomState(3)
    randomize(v["params"], rng)
    randomize(v["batch_stats"], rng)
    jstate = jstate.replace(params=jax.tree_util.tree_map(jnp.asarray, v["params"]),
                            batch_stats=jax.tree_util.tree_map(jnp.asarray, v["batch_stats"]),
                            opt_state=jstate.tx.init(v["params"]))
    batch = make_batch()
    jbatch = {k: jnp.asarray(a) for k, a in batch.items()}
    _, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jdt.detector_loss(model, jcfg, p, jstate.batch_stats, jbatch,
                                    jax.random.PRNGKey(1)), has_aux=True))(jstate.params)
    jnew, jmetrics = jdt.make_detector_train_step(model, jcfg)(
        jstate, {k: jnp.asarray(a) for k, a in batch.items()}, jax.random.PRNGKey(1))
    ref = dict(metrics={k: float(a) for k, a in jmetrics.items()},
               sd=jax_detector_variables_to_state_dict(
                   jax.tree_util.tree_map(np.asarray, {"params": jnew.params,
                                                       "batch_stats": jnew.batch_stats})),
               mu=jax_detector_variables_to_state_dict(
                   {"params": jax.tree_util.tree_map(np.asarray, jnew.opt_state[1][0].mu),
                    "batch_stats": {}}),
               grads=jax_detector_variables_to_state_dict(
                   {"params": jax.tree_util.tree_map(np.asarray, jgrads), "batch_stats": {}}))

    state = tdt.create_detector_train_state(tcfg, "cpu")
    state.net.load_state_dict(jax_detector_variables_to_state_dict(v))
    before = {k: t.clone() for k, t in state.net.state_dict().items()}
    metrics = tdt.make_detector_train_step(tcfg)(
        state, {k: torch.as_tensor(a) for k, a in batch.items()})
    grads = {n: p.grad.clone() for n, p in state.net.named_parameters()}
    port = dict(metrics={k: float(t) for k, t in metrics.items()}, grads=grads,
                sd=state.net.state_dict(), before=before, step=state.step)
    return cls_mode, tcfg, port, ref


def test_train_step_loss_terms_match(steps):
    cls_mode, _, port, ref = steps
    want = {"loss_total", "loss_heatmap", "loss_wh", "loss_offset", "loss_mask", "grad_norm"}
    assert set(ref["metrics"]) == set(port["metrics"]) == \
        (want | {"loss_cls"} if cls_mode == "softmax" else want)
    for k, val in ref["metrics"].items():
        np.testing.assert_allclose(port["metrics"][k], val, rtol=RTOL_STEP_JAX, err_msg=k)
    assert port["step"] == 1


def structurally_zero(name):
    return name in {f"head.deconv{i}.bias" for i in range(3)}


def test_train_step_gradients_match(steps):
    """The port's clipped gradients against the JAX loss's gradients, clipped
    by the step's factor."""
    _, tcfg, port, ref = steps
    factor = min(1.0, tcfg.clip_grad_norm / ref["metrics"]["grad_norm"])
    floor = max(float(g.abs().max()) for g in port["grads"].values())
    for n, g in port["grads"].items():
        jg = ref["grads"][n].double().numpy() * factor
        if structurally_zero(n):
            assert float(g.abs().max()) <= REL_ZERO * floor and np.abs(jg).max() <= \
                REL_ZERO * floor, n
            continue
        err = np.abs(g.double().numpy() - jg).max() / np.abs(jg).max()
        assert err <= REL_GRAD_JAX, (n, err)


def test_train_step_params_and_stats_match(steps):
    _, tcfg, port, ref = steps
    for n, t in port["sd"].items():
        if n.endswith(("running_mean", "running_var")):
            var = ref["sd"][n.replace("running_mean", "running_var")]
            assert stats_scale_error(t, ref["sd"][n], var, n) <= REL_STATS_JAX, n
    zeros = torch.zeros(())
    for n, g in port["grads"].items():
        own = adam_update(g.double(), zeros, zeros, 1, tcfg.lr)
        other = adam_update(torch.as_tensor(np.asarray(ref["mu"][n], np.float64) / 0.1), zeros,
                            zeros, 1, tcfg.lr)
        p0 = port["before"][n].double()
        assert float((port["sd"][n].double() - (p0 - own)).abs().max()) <= ATOL_PARAM, n
        err = (port["sd"][n].double() - ref["sd"][n].double()).abs()
        assert bool((err <= (own - other).abs() + ATOL_PARAM).all()), n
        assert float(err.max()) <= 2 * tcfg.lr + ATOL_PARAM, n


@pytest.mark.parametrize("h,w", [(3.0, 4.0), (10.5, 2.25), (40.0, 60.0), (0.5, 0.5)])
def test_gaussian_radius_and_draw_match(h, w):
    r = tdd.gaussian_radius(h, w)
    assert r == jdd.gaussian_radius(h, w)
    for cx, cy in ((0.2, 0.7), (5.5, 3.1), (11.9, 7.9)):
        a = np.random.RandomState(0).uniform(0, 0.5, (8, 12)).astype(np.float32)
        b = a.copy()
        tdd.draw_gaussian(a, cx, cy, r)
        jdd.draw_gaussian(b, cx, cy, r)
        assert np.array_equal(a, b)


@pytest.fixture(scope="module")
def bop(tmp_path_factory):
    root = build_bop_fixture(tmp_path_factory.mktemp("bop"))
    return JBOPDataset(root, split="test"), BOPDataset(root, split="test")


@pytest.mark.parametrize("augment", [False, True])
def test_detection_dataset_items_match_jax(bop, augment):
    jds, tds = bop
    labels = {"obj_000001": 0, "obj_000002": 1}
    kw = dict(resize=(48, 64), apply_rgb_augmentation=augment, min_area=4.0)
    ref = jdd.DetectionDataset(jds, labels, **kw)
    got = tdd.DetectionDataset(tds, labels, **kw)
    items = [got[i] for i in range(len(got))]
    for i, it in enumerate(items):
        r = ref[i]
        assert set(it) == set(r)
        for k in r:
            assert it[k].dtype == r[k].dtype and np.array_equal(it[k], r[k]), (i, k)
    assert sum(it["obj_mask"].sum() for it in items) >= 4
    batch = tdd.DetectionDataset.collate_fn(items)
    assert batch["image"].shape == (3, 3, 48, 64) and batch["image"].dtype == torch.uint8
    assert batch["inst_masks"].shape == (3, 32, 12, 16)


def test_concat_scene_dataset_matches_jax(bop):
    jds, tds = bop
    ref, got = JConcat([jds, jds]), ConcatSceneDataset([tds, tds])
    assert len(got) == len(ref) == 2 * len(tds)
    for k in ref.frame_index.columns:
        assert got.frame_index[k].tolist() == ref.frame_index[k].tolist(), k
    for i in (0, len(tds) - 1, len(tds), len(got) - 1):
        (a, ma, oa), (b, mb, ob) = got[i], ref[i]
        assert np.array_equal(a, b) and np.array_equal(ma, mb)
        assert oa["frame_info"] == ob["frame_info"]
    with pytest.raises(IndexError):
        got[len(got)]


def test_detector_train_config_fields_match_jax():
    names = [f.name for f in dataclasses.fields(jdt.DetectorTrainConfig)]
    assert names == [f.name for f in dataclasses.fields(tdt.DetectorTrainConfig)]
    for n in names:
        if n != "detector":
            assert getattr(jdt.DetectorTrainConfig(), n) == getattr(tdt.DetectorTrainConfig(), n)
