"""Port parity: the CenterNet detector, its decoder and the inference API,
with weights carried from the JAX package by utils/weights.py.

fp32 on the CPU at 48x80 frames (padded to 64x96 for the backbone, cropped
back to a 12x20 head grid), WideResNet-18 at full width, random BatchNorm
statistics. Tolerances: head outputs atol 1e-4 (conv summation order);
decode_detections fed the JAX package's head outputs gives EQUAL classes
and boxes in both cls_modes with NMS on and off, and equal scores in
cls_mode 'percls' (the same float32 elementwise arithmetic; ties broken by
index as lax.top_k does); in 'softmax' the scores are objectness ×
exp(log_softmax), whose XLA and PyTorch implementations differ in the last
bits: within rtol 1e-6. Mask logits within 1e-5 (an einsum's summation
order); the NMS keep masks are
equal; the inference API's detections are equal as sets (label, box within
1e-4 px, score within 1e-6) and its masks differ in at most 0.1 % of
pixels (threshold crossings of the upsampled logits).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from cosypose_tpu.integrated.detector import Detector as JDetector
from cosypose_tpu.models import detector as jdet
from cosypose_tpu_torch.integrated.detector import Detector, load_saved_detections
from cosypose_tpu_torch.models import detector as tdet
from cosypose_tpu_torch.utils.weights import jax_detector_variables_to_state_dict
from tests.test_torch_port_backbones import randomize

SIZE = (48, 80)
N_CLASSES = 5
ATOL = 1e-4
SOFTMAX_RTOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_pair(cls_mode, seed=0):
    """(JAX model, its variables with random statistics and a lively heatmap,
    the port's model with the same weights)."""
    cfg = dict(n_classes=N_CLASSES, max_detections=16, cls_mode=cls_mode)
    jm = jdet.CenterNetDetector(jdet.DetectorConfig(**cfg))
    v = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, *SIZE, 3)), train=False)
    v = jax.tree_util.tree_map(np.asarray, dict(v))
    v = {"params": v["params"], "batch_stats": v["batch_stats"]}
    rng = np.random.RandomState(seed)
    randomize(v["params"], rng)
    randomize(v["batch_stats"], rng)
    # a heatmap bias near 0 puts most sigmoid values mid-range: many peaks
    v["params"]["head"]["heatmap_out"]["bias"][:] = rng.normal(0.0, 0.3, N_CLASSES if
                                                               cls_mode == "percls" else 1)
    port = tdet.CenterNetDetector(tdet.DetectorConfig(**cfg))
    port.load_state_dict(jax_detector_variables_to_state_dict(v))
    return jm, v, port.eval()


def images(seed=1, n=2):
    return np.random.RandomState(seed).uniform(size=(n, 3, *SIZE)).astype(np.float32)


@pytest.fixture(scope="module", params=["percls", "softmax"])
def pair(request):
    return (request.param, *make_pair(request.param))


def test_head_outputs_match_jax(pair):
    _, jm, v, port = pair
    x = images()
    ref = jm.apply(v, jnp.asarray(x.transpose(0, 2, 3, 1)), train=False)
    with torch.no_grad():
        got = port(torch.as_tensor(x))
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape == (2, SIZE[0] // 4, SIZE[1] // 4, ref[k].shape[-1])
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=ATOL, rtol=0,
                                   err_msg=k)


def test_conv_transpose_needs_the_flip():
    """flax's ConvTranspose(4, stride 2, 'SAME') applies its kernel unflipped:
    torch's ConvTranspose2d(padding=1) matches it with the kernel flipped in
    both spatial axes, and not without the flip."""
    rng = np.random.RandomState(0)
    x = rng.normal(size=(1, 5, 7, 3)).astype(np.float32)
    layer = fnn.ConvTranspose(4, (4, 4), strides=(2, 2), padding="SAME")
    v = layer.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ref = np.asarray(layer.apply(v, jnp.asarray(x))).transpose(0, 3, 1, 2)
    k = np.asarray(v["params"]["kernel"])
    conv = torch.nn.ConvTranspose2d(3, 4, 4, stride=2, padding=1)
    sd = jax_detector_variables_to_state_dict({"params": {"head": {"deconv0": v["params"]}}})
    with torch.no_grad():
        conv.weight.copy_(sd["head.deconv0.weight"])
        conv.bias.copy_(sd["head.deconv0.bias"])
        got = conv(torch.as_tensor(x.transpose(0, 3, 1, 2))).numpy()
        conv.weight.copy_(torch.as_tensor(k.transpose(2, 3, 0, 1).copy()))
        unflipped = conv(torch.as_tensor(x.transpose(0, 3, 1, 2))).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)
    assert np.abs(unflipped - ref).max() > 0.1


def jax_heads(pair, seed=1, n=2):
    _, jm, v, _ = pair
    x = images(seed, n)
    return jm.apply(v, jnp.asarray(x.transpose(0, 2, 3, 1)), train=False)


@pytest.mark.parametrize("nms_iou", [0.5, None])
def test_decode_is_equal_from_equal_heads(pair, nms_iou):
    heads = jax_heads(pair)
    ref = jdet.decode_detections(heads, 16, nms_iou=nms_iou)
    got = tdet.decode_detections({k: torch.as_tensor(np.array(a)) for k, a in heads.items()},
                                 16, nms_iou=nms_iou)
    for k in ("class_ids", "boxes"):
        assert np.array_equal(got[k].numpy(), np.asarray(ref[k])), k
    if pair[0] == "percls":
        assert np.array_equal(got["scores"].numpy(), np.asarray(ref["scores"]))
    else:  # exp(log_softmax) of XLA and of PyTorch differ in the last bits
        np.testing.assert_allclose(got["scores"].numpy(), np.asarray(ref["scores"]),
                                   rtol=SOFTMAX_RTOL, atol=0)
    np.testing.assert_allclose(got["mask_logits"].numpy(), np.asarray(ref["mask_logits"]),
                               atol=1e-5, rtol=0)
    assert (np.asarray(ref["scores"]) > 0).sum() >= 8


def test_decode_breaks_ties_by_index():
    """An all-zero heatmap after suppression: lax.top_k's first indices."""
    heads = dict(heatmap=np.full((1, 6, 8, 3), -30.0, np.float32),
                 wh=np.ones((1, 6, 8, 2), np.float32), offset=np.zeros((1, 6, 8, 2), np.float32),
                 mask_coeffs=np.zeros((1, 6, 8, 4), np.float32),
                 protos=np.zeros((1, 6, 8, 4), np.float32))
    heads["heatmap"][0, 2, 3, 1] = 5.0
    ref = jdet.decode_detections({k: jnp.asarray(a) for k, a in heads.items()}, 10, nms_iou=None)
    got = tdet.decode_detections({k: torch.as_tensor(a) for k, a in heads.items()}, 10,
                                 nms_iou=None)
    for k in ("scores", "class_ids", "boxes"):
        assert np.array_equal(got[k].numpy(), np.asarray(ref[k])), k


@pytest.mark.parametrize("cross", [None, 0.9])
def test_nms_keep_matches_jax(cross):
    rng = np.random.RandomState(2)
    K = 24
    xy = rng.uniform(0, 40, (3, K, 2)).astype(np.float32)
    wh = rng.uniform(4, 20, (3, K, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + wh], -1)
    boxes[:, 5] = boxes[:, 4] + 0.5  # near-duplicates
    cls = rng.randint(0, 3, (3, K))
    valid = rng.uniform(size=(3, K)) > 0.2
    ref = jax.vmap(jdet._nms_keep, in_axes=(0, 0, 0, None, None))(
        jnp.asarray(boxes), jnp.asarray(cls), jnp.asarray(valid), 0.3, cross)
    got = tdet.nms_keep(torch.as_tensor(boxes), torch.as_tensor(cls), torch.as_tensor(valid),
                        0.3, cross)
    assert np.array_equal(got.numpy(), np.asarray(ref))
    assert 0 < got.sum() < valid.sum()


def as_set(labels, boxes, scores):
    return sorted(zip(labels, [tuple(np.round(b, 3)) for b in boxes], scores))


@pytest.mark.parametrize("one_instance", [False, True])
def test_detector_api_matches_jax(pair, one_instance):
    cls_mode, jm, v, port = pair
    labels = {f"obj_{i:06d}": i for i in range(N_CLASSES - 1)}  # the last class has no label
    x = (images(3, 3) * 255).astype(np.uint8)
    jd = JDetector(jm, v, labels)
    td = Detector(port, labels)
    kw = dict(detection_th=0.05, output_masks=True, one_instance_per_class=one_instance)
    ref = jd.get_detections(jnp.asarray(x), **kw)
    got = td.get_detections(torch.as_tensor(x), **kw)
    assert len(got) == len(ref) > 0
    assert got.infos["batch_im_id"].tolist() == ref.infos["batch_im_id"].tolist()
    assert got.infos["label"].tolist() == ref.infos["label"].tolist()
    np.testing.assert_allclose(got.infos["score"], ref.infos["score"].values, atol=1e-6)
    np.testing.assert_allclose(got.bboxes.numpy(), np.asarray(ref.bboxes), atol=ATOL)
    m_ref, m_got = np.asarray(ref.masks), got.masks.numpy()
    assert m_got.shape == m_ref.shape == (len(ref), *SIZE)
    assert (m_got != m_ref).mean() <= 1e-3
    assert m_ref.any() or one_instance or cls_mode == "softmax"
    if one_instance:
        assert len(set(got.infos["label"].tolist())) == len(got)


def test_detector_api_nhwc_float_input_and_nothing_above_threshold():
    _, _, port = make_pair("percls")
    td = Detector(port, {"a": 0})
    x = images(4, 1)
    a = td.get_detections(torch.as_tensor(x))
    b = td.get_detections(torch.as_tensor(x.transpose(0, 2, 3, 1).copy()))
    assert a.infos["label"].tolist() == b.infos["label"].tolist()
    torch.testing.assert_close(a.bboxes, b.bboxes, atol=1e-5, rtol=0)
    none = td.get_detections(torch.as_tensor(x), detection_th=1.0, output_masks=True)
    assert len(none) == 0 and none.masks.shape == (0, *SIZE) and none.bboxes.shape == (0, 4)


def test_load_saved_detections():
    dets = load_saved_detections(dict(scene_id=[1, 1], view_id=[2, 3], label=["a", "b"],
                                      score=[0.5, 0.25]), [[0, 0, 4, 4], [1, 1, 2, 3]])
    assert len(dets) == 2 and dets.bboxes.dtype == torch.float32
    assert dets[[1]].infos["label"].tolist() == ["b"]
