"""Port parity for the whole slice: PosePredictor.forward (n=2) and
CoarseRefinePosePredictor.get_predictions, JAX package vs port, on the CPU.

The JAX side is tests/test_pose_predictor.py's `small_cfg` (EfficientNet-B0,
48×64 renders) on `cube_specs`, whose 12 triangles stay under every binning
budget, so the JAX CPU path (XLA `rasterize`) and the port (binned prologue +
the kernel's plain version) render the same image. Weights: the port's
seeded init with a random pose kernel (so the update path moves the pose),
carried to JAX. Tolerance: atol 1e-4 plus rtol 1e-6 on every per-iteration
output. The rtol is for K_crop: its entries reach ~320 px, and the crop
boxes' last-bit differences (summation order of the projection einsums),
scaled by the crop zoom, put a few fp32 ulps (3e-5 each there) on it.
"""

import numpy as np
import pandas as pd
import pytest
import torch
import jax
import jax.numpy as jnp

from cosypose_tpu.integrated import CoarseRefinePosePredictor as JCoarseRefine
from cosypose_tpu.integrated import LoadedPoseModel as JLoadedPoseModel
from cosypose_tpu.models import PosePredictor as JPosePredictor
from cosypose_tpu.models.pose_predictor import gather_mesh_data as j_gather
from cosypose_tpu.ops.mesh_db import build_mesh_db as j_build_mesh_db
from cosypose_tpu.utils.tensor_collection import PandasTensorCollection
from cosypose_tpu.utils.torch_compat import convert_pose_checkpoint
from cosypose_tpu_torch.demo import demo_weights
from cosypose_tpu_torch.integrated.pose_predictor import CoarseRefinePosePredictor, LoadedPoseModel
from cosypose_tpu_torch.models.pose_predictor import (PosePredictor, PosePredictorConfig,
                                                      gather_mesh_data)
from cosypose_tpu_torch.ops.mesh_db import MeshSpec, build_mesh_db
from cosypose_tpu_torch.utils.tensor_collection import TensorCollection
from tests.test_pose_predictor import cube_specs, make_K, small_cfg

ATOL, RTOL = 1e-4, 1e-6
KEYS = ("TCO_input", "TCO_output", "K_crop", "pose_outputs", "boxes_rend", "boxes_crop")


def port_cfg():
    c = small_cfg()
    return PosePredictorConfig(backbone=c.backbone, render_size=c.render_size,
                               n_points_crop=c.n_points_crop)


def port_specs():
    return [MeshSpec(**vars(s)) for s in cube_specs()]


def make_weights():
    """(JAX PosePredictor, its variables, the port's PosePredictor with the
    same weights): the port's seeded init with a random pose kernel scaled to
    its first-iteration features (demo.demo_weights), carried to JAX by the
    package's own torch converter."""
    pp = PosePredictor(port_cfg(), device="cpu")
    images, K, TCO, label_ids = (torch.as_tensor(a) for a in inputs())
    mesh_data = gather_mesh_data(build_mesh_db(port_specs(), device="cpu"), label_ids, 8)
    demo_weights(pp, mesh_data, images, K, TCO, torch.Generator().manual_seed(1))
    v = convert_pose_checkpoint(pp.net.state_dict(), variant=small_cfg().backbone)
    return JPosePredictor(small_cfg()), v, pp


@pytest.fixture(scope="module")
def weights():
    return make_weights()


def inputs(B=3):
    rng = np.random.RandomState(2)
    images = rng.uniform(size=(B, 3, 120, 160)).astype(np.float32)
    K = np.array(make_K(B))
    TCO = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    TCO[:, :2, 3] = rng.uniform(-0.03, 0.03, (B, 2))
    TCO[:, 2, 3] = rng.uniform(0.45, 0.6, B)
    return images, K, TCO, (np.arange(B) % 2).astype(np.int32)


def _close(port, ref, what):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL, err_msg=what)


def run_forward(weights):
    """(port outputs, JAX outputs, TCO init) of PosePredictor.forward, n=2."""
    jpp, v, pp = weights
    images, K, TCO, label_ids = inputs()
    ref = jpp.forward(v, j_gather(j_build_mesh_db(cube_specs()), jnp.asarray(label_ids), 8),
                      jnp.asarray(images), jnp.asarray(K), jnp.asarray(TCO), n_iterations=2)
    db = build_mesh_db(port_specs(), device="cpu")
    port = pp.forward(gather_mesh_data(db, torch.as_tensor(label_ids), 8),
                      torch.as_tensor(images), torch.as_tensor(K), torch.as_tensor(TCO.copy()),
                      n_iterations=2)
    return port, ref, TCO


def test_pose_predictor_forward_matches(weights):
    port, ref, TCO = run_forward(weights)
    for k in KEYS:
        assert port[k].shape == ref[k].shape, k
        _close(port[k], ref[k], k)
    _close(port["TCO_final"], ref["TCO_final"], "TCO_final")
    # the random head moved every pose, by more than the tolerance
    assert np.abs(port["TCO_final"].numpy() - TCO).max() > 1e-3
    np.testing.assert_array_equal(port["TCO_input"][1].numpy(), port["TCO_output"][0].numpy())


def run_coarse_refine(weights, init_method):
    """(port final, port stages, JAX final, JAX stages) of get_predictions on
    5 detections in chunks of 2, 1 coarse + 2 refiner iterations."""
    jpp, v, pp = weights
    rng = np.random.RandomState(3)
    images = rng.uniform(size=(2, 3, 120, 160)).astype(np.float32)
    K = np.array(make_K(2))
    infos = dict(batch_im_id=np.array([0, 0, 1, 1, 0]),
                 label=np.array(["obj_000001", "obj_000002", "obj_000001", "obj_000002",
                                 "obj_000002"]),
                 score=np.array([0.9, 0.8, 0.7, 0.6, 0.5]))
    bboxes = np.array([[60, 40, 100, 80], [30, 30, 80, 70], [70, 50, 110, 90],
                       [20, 60, 70, 100], [90, 20, 140, 75]], np.float32)

    jmodel = JLoadedPoseModel(jpp, v, j_build_mesh_db(cube_specs()), init_method=init_method)
    jpred = JCoarseRefine(jmodel, jmodel, bsz_objects=2)
    ref_final, ref = jpred.get_predictions(
        jnp.asarray(images), jnp.asarray(K),
        detections=PandasTensorCollection(pd.DataFrame(infos), bboxes=jnp.asarray(bboxes)),
        n_coarse_iterations=1, n_refiner_iterations=2)

    model = LoadedPoseModel(pp, build_mesh_db(port_specs(), device="cpu"),
                            init_method=init_method, device="cpu")
    pred = CoarseRefinePosePredictor(model, model, bsz_objects=2, device="cpu")
    port_final, port = pred.get_predictions(
        images, K, detections=TensorCollection(infos, bboxes=torch.as_tensor(bboxes)),
        n_coarse_iterations=1, n_refiner_iterations=2)
    return port_final, port, ref_final, ref


@pytest.mark.parametrize("init_method", ["v0", "z-up+auto-depth"])
def test_coarse_refine_get_predictions_matches(weights, init_method):
    port_final, port, ref_final, ref = run_coarse_refine(weights, init_method)
    assert set(port) == set(ref) == {"coarse/iteration=1", "refiner/iteration=1",
                                     "refiner/iteration=2"}
    for key in ref:
        assert len(port[key]) == len(ref[key]) == 5
        assert list(port[key].infos["label"]) == list(ref[key].infos["label"])
        for t in ("poses", "poses_input", "K_crop", "boxes_rend", "boxes_crop"):
            _close(port[key].tensors[t], ref[key].tensors[t], f"{key}/{t}")
    _close(port_final.poses, ref_final.poses, "final")
    np.testing.assert_array_equal(port["refiner/iteration=1"].poses_input.numpy(),
                                  port["coarse/iteration=1"].poses.numpy())
