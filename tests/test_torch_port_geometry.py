"""Port parity: geometry, camera, pose update, DeepIM crops and roi_align.

The same numpy inputs (from a seed) go through the JAX function and its
counterpart in cosypose_tpu_torch, both on the CPU. Tolerances: atol 1e-5
on fp32 geometry (both sides round the same formulas; only the summation
order of the small einsums may differ, a few ulps at these magnitudes) and
atol 1e-4 plus rtol 1e-6 on pixel-scale quantities (boxes, intrinsics, uv):
one fp32 ulp of a cropped focal length near 2000 px is already 1.2e-4.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from cosypose_tpu.ops import camera as jcam
from cosypose_tpu.ops import cropping as jcrop
from cosypose_tpu.ops import pose_ops as jpose
from cosypose_tpu.ops.roi_align import roi_align as j_roi_align, roi_align_gather
from cosypose_tpu.ops import transforms as jtr
from cosypose_tpu_torch.ops import camera as tcam
from cosypose_tpu_torch.ops import cropping as tcrop
from cosypose_tpu_torch.ops import pose_ops as tpose
from cosypose_tpu_torch.ops.roi_align import roi_align as t_roi_align
from cosypose_tpu_torch.ops.roi_align import roi_align_gather as t_roi_align_gather
from cosypose_tpu_torch.ops import transforms as ttr

ATOL_GEOM = 1e-5
ATOL_PIX = 1e-4


def _t(a):
    return torch.as_tensor(np.array(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


def _close(port, ref, atol):
    rtol = 1e-6 if atol >= ATOL_PIX else 0.0
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=atol, rtol=rtol)


def random_rotations(rng, n):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return np.asarray(jtr.quat_to_matrix(_j(q.astype(np.float32))))


def random_poses(rng, n, z=(0.4, 1.2)):
    T = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    T[:, :3, :3] = random_rotations(rng, n)
    T[:, :2, 3] = rng.uniform(-0.1, 0.1, (n, 2))
    T[:, 2, 3] = rng.uniform(*z, n)
    return T


def make_K(n, f=500.0, cx=320.0, cy=240.0):
    K = np.zeros((n, 3, 3), np.float32)
    K[:, 0, 0] = K[:, 1, 1] = f
    K[:, 0, 2], K[:, 1, 2], K[:, 2, 2] = cx, cy, 1.0
    return K


def test_transform_pts():
    rng = np.random.RandomState(0)
    pts = rng.normal(size=(3, 17, 3)).astype(np.float32)
    T = random_poses(rng, 3)
    _close(ttr.transform_pts(_t(T), _t(pts)), jtr.transform_pts(_j(T), _j(pts)), ATOL_GEOM)


def test_invert_and_make_T():
    rng = np.random.RandomState(1)
    T = random_poses(rng, 6)
    _close(ttr.invert_T(_t(T)), jtr.invert_T(_j(T)), ATOL_GEOM)
    _close(ttr.make_T(_t(T[:, :3, :3]), _t(T[:, :3, 3])),
           jtr.make_T(_j(T[:, :3, :3]), _j(T[:, :3, 3])), 0.0)


@pytest.mark.parametrize("scale", [1.0, 1e-9])
def test_rot6d_to_matrix(scale):
    """Includes raw outputs of ~1e-9, where the eps-1e-20 guard must not bite."""
    rng = np.random.RandomState(2)
    x = (rng.normal(size=(8, 6)) * scale).astype(np.float32)
    _close(ttr.rot6d_to_matrix(_t(x)), jtr.rot6d_to_matrix(_j(x)), ATOL_GEOM)


def test_quat_to_matrix():
    rng = np.random.RandomState(3)
    q = rng.normal(size=(8, 4)).astype(np.float32)
    _close(ttr.quat_to_matrix(_t(q)), jtr.quat_to_matrix(_j(q)), ATOL_GEOM)


@pytest.mark.parametrize("robust", [False, True])
def test_project_points(robust):
    rng = np.random.RandomState(4)
    pts = rng.normal(scale=0.05, size=(4, 30, 3)).astype(np.float32)
    T = random_poses(rng, 4)
    if robust:
        T[0, 2, 3] = -0.2  # object behind the camera: depth clamps to z_min
        fn_t, fn_j = tcam.project_points_robust, jcam.project_points_robust
    else:
        fn_t, fn_j = tcam.project_points, jcam.project_points
    K = make_K(4)
    uv_t = fn_t(_t(pts), _t(K), _t(T))
    uv_j = fn_j(_j(pts), _j(K), _j(T))
    _close(uv_t, uv_j, ATOL_PIX)
    _close(tcam.boxes_from_uv(uv_t), jcam.boxes_from_uv(uv_j), ATOL_PIX)


def test_get_K_crop_resize():
    rng = np.random.RandomState(5)
    K = make_K(5)
    x1 = rng.uniform(0, 300, 5)
    y1 = rng.uniform(0, 200, 5)
    boxes = np.stack([x1, y1, x1 + rng.uniform(40, 200, 5), y1 + rng.uniform(30, 150, 5)],
                     -1).astype(np.float32)
    _close(tcam.get_K_crop_resize(_t(K), _t(boxes), (480, 640), (240, 320)),
           jcam.get_K_crop_resize(_j(K), _j(boxes), (480, 640), (240, 320)), ATOL_PIX)


def test_apply_imagespace_predictions():
    rng = np.random.RandomState(6)
    T = random_poses(rng, 5)
    K = make_K(5)
    v = np.concatenate([rng.normal(scale=5.0, size=(5, 2)), rng.uniform(0.8, 1.2, (5, 1))],
                       -1).astype(np.float32)
    dR = random_rotations(rng, 5)
    _close(tpose.apply_imagespace_predictions(_t(T), _t(K), _t(v), _t(dR)),
           jpose.apply_imagespace_predictions(_j(T), _j(K), _j(v), _j(dR)), ATOL_GEOM)


@pytest.mark.parametrize("method", ["v0", "z-up+auto-depth"])
def test_TCO_init_from_boxes(method):
    rng = np.random.RandomState(7)
    K = make_K(4)
    boxes = np.array([[100, 80, 180, 170], [300, 200, 420, 330], [10, 5, 60, 50],
                      [500, 400, 630, 470]], np.float32)
    if method == "v0":
        port = tpose.TCO_init_from_boxes(_t(boxes), _t(K), (1.0, 1.0))
        ref = jpose.TCO_init_from_boxes(_j(boxes), _j(K), (1.0, 1.0))
    else:
        pts = rng.normal(scale=0.05, size=(4, 50, 3)).astype(np.float32)
        port = tpose.TCO_init_from_boxes_zup_autodepth(_t(boxes), _t(pts), _t(K))
        ref = jpose.TCO_init_from_boxes_zup_autodepth(_j(boxes), _j(pts), _j(K))
    _close(port, ref, ATOL_GEOM)


def test_deepim_crops():
    rng = np.random.RandomState(8)
    B = 3
    images = rng.uniform(size=(B, 3, 48, 64)).astype(np.float32)
    K = make_K(B, f=80.0, cx=32.0, cy=24.0)
    T = random_poses(rng, B, z=(0.5, 0.9))
    pts = rng.normal(scale=0.05, size=(B, 40, 3)).astype(np.float32)
    obs = np.asarray(jcam.boxes_from_uv(jcam.project_points_robust(_j(pts), _j(K), _j(T))))
    obs = obs + rng.uniform(-3, 3, obs.shape).astype(np.float32)
    boxes_t, crops_t = tcrop.deepim_crops(_t(images), _t(obs), _t(K), _t(T), _t(pts), (24, 32))
    boxes_j, crops_j = jcrop.deepim_crops(_j(images), _j(obs), _j(K), _j(T), _j(pts), (24, 32))
    _close(boxes_t, boxes_j, ATOL_PIX)
    _close(crops_t, crops_j, ATOL_GEOM)


@pytest.mark.parametrize("oracle", ["matmul", "gather"])
@pytest.mark.parametrize("sampling_ratio", [2, 4])
def test_roi_align_both_jax_forms(oracle, sampling_ratio):
    """Boxes inside, across and beyond the border: out-of-bounds samples give 0."""
    rng = np.random.RandomState(9)
    img = rng.uniform(size=(4, 3, 30, 40)).astype(np.float32)
    boxes = np.array([[5.0, 4.0, 25.5, 20.0], [-8.0, -5.0, 20.0, 12.0],
                      [30.0, 20.0, 55.0, 41.0], [-3.0, 2.5, 43.0, 33.0]], np.float32)
    fn = j_roi_align if oracle == "matmul" else roi_align_gather
    ref = fn(_j(img), _j(boxes), output_size=(12, 16), sampling_ratio=sampling_ratio)
    out = t_roi_align(_t(img), _t(boxes), (12, 16), sampling_ratio)
    _close(out, ref, ATOL_GEOM)


@pytest.mark.parametrize("sampling_ratio", [1, 2, 4])
def test_roi_align_gather_matches_jax_and_the_matmul_form(sampling_ratio):
    """The port's gather form against the JAX package's and against the
    port's roi_align, on boxes inside, across and beyond the border."""
    rng = np.random.RandomState(10)
    img = rng.uniform(size=(4, 3, 30, 40)).astype(np.float32)
    boxes = np.array([[5.0, 4.0, 25.5, 20.0], [-8.0, -5.0, 20.0, 12.0],
                      [30.0, 20.0, 55.0, 41.0], [-3.0, 2.5, 43.0, 33.0]], np.float32)
    out = t_roi_align_gather(_t(img), _t(boxes), (12, 16), sampling_ratio)
    ref = roi_align_gather(_j(img), _j(boxes), output_size=(12, 16),
                           sampling_ratio=sampling_ratio)
    assert out.shape == (4, 3, 12, 16)
    _close(out, ref, ATOL_PIX)
    _close(out, t_roi_align(_t(img), _t(boxes), (12, 16), sampling_ratio), ATOL_PIX)
    assert float(out[2].abs().max()) < 1.0 and float(out[0].abs().min()) > 0.0
