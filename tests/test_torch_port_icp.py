"""Port parity for depth ICP (cosypose_tpu_torch/integrated/icp_refiner.py)
against the JAX package's on the CPU.

Inputs: the two test cubes (12 triangles each) at 120x160, depth rendered by
the JAX package's rasterizer, so both ICPs see identical depth arrays; the
poses perturbed by 1 cm in x and 2 cm in z as in tests/test_icp.py.
Tolerances: sample ids and icp_ok flags exactly equal; refined poses within
ATOL_POSE = 5e-4 (m and rotation entries). Measured up to 2.4e-4: the
weighted Kabsch solve of a cube face seen nearly head-on is ill-conditioned
about the face normal, and the float32 centroid and cross-covariance sums,
which XLA and PyTorch add in other orders (the first iteration's points
differ by 2.5e-6), move it by that much; against a float64 run of the port
the JAX package lies up to 7.0e-5 away and the port up to 2.4e-4, with the
same inlier sets at every iteration.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from cosypose_tpu.integrated import icp_refiner as jicp
from cosypose_tpu.ops.mesh_db import build_mesh_db as j_build_mesh_db
from cosypose_tpu.ops.rasterizer import rasterize
from cosypose_tpu.utils.tensor_collection import PandasTensorCollection
from cosypose_tpu_torch.integrated import icp_refiner as ticp
from cosypose_tpu_torch.ops.mesh_db import build_mesh_db
from cosypose_tpu_torch.utils.tensor_collection import TensorCollection
from tests.test_pose_predictor import cube_specs
from tests.test_torch_port_slice import port_specs

ATOL_POSE = 5e-4
H, W = 120, 160
LABELS = ["obj_000001", "obj_000002", "obj_000001", "obj_000002", "obj_000001", "obj_000002"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One PyTorch thread a test process: the suite runs several processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    return make_scene()


def make_scene():
    """Six detections on cubes, their GT and perturbed poses, the GT depth
    and the depth rendered at the perturbed poses; the last detection sees
    no observed depth (every iteration without an inlier)."""
    jdb = j_build_mesh_db(cube_specs())
    rng = np.random.RandomState(0)
    B = len(LABELS)
    K = np.tile(np.array([[300, 0, 80], [0, 300, 60], [0, 0, 1]], np.float32), (B, 1, 1))
    TCO_gt = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    TCO_gt[:, :3, 3] = rng.uniform(-0.05, 0.05, (B, 3)) + [0, 0, 0.5]
    TCO_bad = TCO_gt.copy()
    TCO_bad[:, 0, 3] += 0.01
    TCO_bad[:, 2, 3] += 0.02
    ids = np.asarray([jdb.label_to_id[lab] for lab in LABELS])

    def depth(TCO):
        return np.array(rasterize(jdb.tri_verts[ids], jdb.tri_valid[ids], jnp.asarray(TCO),
                                  jnp.asarray(K), image_size=(H, W)).depth)

    observed = depth(TCO_gt)
    observed[-1] = 0.0
    return dict(jdb=jdb, K=K, TCO_gt=TCO_gt, TCO_bad=TCO_bad, observed=observed,
                rendered=depth(TCO_bad))


@pytest.mark.parametrize("size", [(120, 160), (240, 320), (480, 640)])
def test_sample_ids_match_jax(size):
    """The stratified pixel ids are jnp.linspace's as the JAX package's run
    computes them, eager and under jit; torch.linspace gives other ids at
    240x320 and 480x640."""
    n = size[0] * size[1]
    eager = np.asarray(jnp.linspace(0, n - 1, 1024).astype(jnp.int32))
    jitted = np.asarray(jax.jit(lambda: jnp.linspace(0, n - 1, 1024).astype(jnp.int32))())
    np.testing.assert_array_equal(ticp.sample_ids(n, 1024), eager)
    np.testing.assert_array_equal(ticp.sample_ids(n, 1024), jitted)
    differ = int((torch.linspace(0, n - 1, 1024).to(torch.int32).numpy() != eager).sum())
    assert differ == {(120, 160): 0, (240, 320): 1, (480, 640): 6}[size]


@pytest.mark.parametrize("n_iterations", [1, 3, 10])
def test_icp_refine_batch_matches_jax(scene, n_iterations):
    args = (scene["TCO_bad"], scene["rendered"], scene["observed"], scene["K"])
    ref, ok_ref = jicp._icp_refine_batch(*map(jnp.asarray, args), n_iterations=n_iterations)
    got, ok = ticp._icp_refine_batch(*map(torch.as_tensor, args), n_iterations=n_iterations)
    assert ok.tolist() == np.asarray(ok_ref).tolist() == [True] * 5 + [False]
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL_POSE, rtol=0)
    # the detection without observed depth keeps its pose exactly
    np.testing.assert_array_equal(got[-1].numpy(), scene["TCO_bad"][-1])


def test_zero_inlier_iteration_gives_identity():
    """Kabsch with no weight: LAPACK's SVD of the zero matrix gives the
    JAX package R = I, t = 0; the port returns that whatever its solver."""
    rng = np.random.RandomState(1)
    P = rng.normal(size=(2, 50, 3)).astype(np.float32)
    Q = P + np.float32(0.01)
    w = np.zeros((2, 50), np.float32)
    w[1, :10] = 1.0
    R, t = ticp._kabsch(torch.as_tensor(P), torch.as_tensor(Q), torch.as_tensor(w))
    for b in range(2):
        R_ref, t_ref = jicp._kabsch(jnp.asarray(P[b]), jnp.asarray(Q[b]), jnp.asarray(w[b]))
        np.testing.assert_allclose(R[b].numpy(), np.asarray(R_ref), atol=1e-5)
        np.testing.assert_allclose(t[b].numpy(), np.asarray(t_ref), atol=1e-5)
    np.testing.assert_array_equal(R[0].numpy(), np.eye(3, dtype=np.float32))
    np.testing.assert_array_equal(t[0].numpy(), np.zeros(3, np.float32))


@pytest.mark.parametrize("with_masks", [False, True])
def test_icp_refiner_end_to_end_matches_jax(scene, with_masks):
    """ICPRefiner.refine_poses: the port renders through ops/render at tile
    (24, 320) and budget 768, the JAX package's CPU path through rasterize
    at (24, 64) and 128; on 12-triangle cubes no budget binds."""
    B = len(LABELS)
    infos = dict(batch_im_id=np.arange(B), label=np.asarray(LABELS), score=np.ones(B))
    masks = scene["observed"] > 0 if with_masks else None
    ref = jicp.ICPRefiner(scene["jdb"]).refine_poses(
        PandasTensorCollection(pd.DataFrame(infos), poses=jnp.asarray(scene["TCO_bad"])),
        None if masks is None else jnp.asarray(masks), jnp.asarray(scene["observed"]),
        jnp.asarray(scene["K"]), n_iterations=15)
    got = ticp.ICPRefiner(build_mesh_db(port_specs(), device="cpu")).refine_poses(
        TensorCollection(infos, poses=torch.as_tensor(scene["TCO_bad"])), masks,
        scene["observed"], scene["K"], n_iterations=15)
    assert got.infos["icp_ok"].tolist() == ref.infos["icp_ok"].tolist()
    assert list(got.infos) == list(ref.infos.columns)
    np.testing.assert_allclose(got.poses.numpy(), np.asarray(ref.poses), atol=ATOL_POSE, rtol=0)


def test_icp_recovers_translation_offset(scene):
    """tests/test_icp.py's first property, on the port."""
    B = len(LABELS)
    infos = dict(batch_im_id=np.arange(B), label=np.asarray(LABELS), score=np.ones(B))
    out = ticp.ICPRefiner(build_mesh_db(port_specs(), device="cpu")).refine_poses(
        TensorCollection(infos, poses=torch.as_tensor(scene["TCO_bad"])), None,
        scene["observed"], scene["K"], n_iterations=15)
    t_gt = scene["TCO_gt"][:5, :3, 3]
    before = np.linalg.norm(scene["TCO_bad"][:5, :3, 3] - t_gt, axis=-1)
    after = np.linalg.norm(out.poses[:5, :3, 3].numpy() - t_gt, axis=-1)
    assert (after < 0.5 * before).all(), (before, after)
    assert out.infos["icp_ok"][:5].all()


def test_icp_no_depth_keeps_pose():
    """tests/test_icp.py's second property, on the port."""
    TCO = np.eye(4, dtype=np.float32)[None]
    TCO[:, 2, 3] = 0.5
    K = np.array([[[300, 0, 80], [0, 300, 60], [0, 0, 1]]], np.float32)
    out = ticp.ICPRefiner(build_mesh_db(port_specs(), device="cpu")).refine_poses(
        TensorCollection(dict(batch_im_id=[0], label=["obj_000001"], score=[1.0]),
                         poses=torch.as_tensor(TCO)), None, np.zeros((1, H, W)), K)
    np.testing.assert_allclose(out.poses[0].numpy(), TCO[0], atol=1e-5)
    assert not out.infos["icp_ok"][0]
