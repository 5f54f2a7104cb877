"""Port parity for the BOP19 metrics, JAX package vs port on the CPU.

The per-pair errors (MSSD, MSPD, VSD), the toolkit's greedy matching and the
Average Recall on the cases of tests/test_bop_metrics.py and on random ones;
VSD's depth renders through the port's BatchRenderer (the plain versions of
the raster kernels, tile (24, 320), budget 768) against the JAX package's
(its XLA rasterizer on the CPU, tile (24, 64), 128 triangles) on the cubes at
48x64, where no tile reaches either budget; and compute_bop19_ar over the BOP
fixture of tests/test_data.py with scene depth added.

Tolerances: the host arithmetic is the same float64 numpy, so errors, match
counts, recalls and AR are held equal; rendered depth within 1e-4 m (two
float32 rasterizers; the VSD matrices built from it come out equal).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from cosypose_tpu.data.bop import BOPDataset as JBOPDataset
from cosypose_tpu.data.bop import BOPObjectDataset as JBOPObjectDataset
from cosypose_tpu.evaluation import bop_metrics as jb
from cosypose_tpu.ops.mesh_db import build_mesh_db as j_build_mesh_db
from cosypose_tpu.rendering.scene_renderer import BatchRenderer as JBatchRenderer
from cosypose_tpu.utils.tensor_collection import PandasTensorCollection
from cosypose_tpu_torch.data.bop import BOPDataset, BOPObjectDataset
from cosypose_tpu_torch.evaluation import bop_metrics as tb
from cosypose_tpu_torch.ops import rasterizer_cuda as rc
from cosypose_tpu_torch.ops.mesh_db import build_mesh_db
from cosypose_tpu_torch.rendering.scene_renderer import BatchRenderer
from cosypose_tpu_torch.utils import png
from cosypose_tpu_torch.utils.tensor_collection import TensorCollection
from tests.test_data import build_bop_fixture
from tests.test_pose_predictor import cube_specs


def _pose(R=None, t=(0, 0, 0)):
    T = np.eye(4)
    if R is not None:
        T[:3, :3] = R
    T[:3, 3] = t
    return T


def _rotz(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], float)


def random_pose(rng, z=0.5, t_scale=0.05):
    Q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    return _pose(Q * np.sign(np.linalg.det(Q)), rng.uniform(-t_scale, t_scale, 3) + (0, 0, z))


def test_pose_errors_match_jax():
    rng = np.random.RandomState(0)
    K = np.array([[100.0, 0, 160], [0, 100.0, 120], [0, 0, 1]])
    ident = (np.eye(4)[None], np.array([True]))
    syms = (np.stack([np.eye(4), _pose(_rotz(np.pi)), _pose(_rotz(np.pi / 2))]),
            np.array([True, True, False]))
    for _ in range(6):
        pts = rng.randn(50, 3) * 0.05
        valid = rng.rand(50) < 0.8
        Te, Tg = random_pose(rng), random_pose(rng)
        for s in (ident, syms):
            assert tb.mssd(Te, Tg, pts, valid, *s) == jb.mssd(Te, Tg, pts, valid, *s)
            for w in (640, 320):
                assert tb.mspd(Te, Tg, K, pts, valid, *s, w) == jb.mspd(Te, Tg, K, pts, valid, *s, w)
    for _ in range(4):   # depth maps with occluders, invalid scene pixels and near-δ offsets
        d_gt = np.where(rng.rand(16, 16) < 0.6, rng.uniform(0.5, 0.6, (16, 16)), 0).astype(np.float32)
        d_est = np.where(rng.rand(16, 16) < 0.6, d_gt + rng.normal(0, 0.01, (16, 16)), 0)
        d_scene = np.where(rng.rand(16, 16) < 0.2, 0, np.minimum(d_gt + 0.01, 0.58))
        for d in (0.05, 0.2):
            assert np.array_equal(tb.vsd(d_est, d_gt, d_scene, d), jb.vsd(d_est, d_gt, d_scene, d))


def test_matching_and_recall_match_jax():
    rng = np.random.RandomState(1)
    cases = [(np.array([[0.4], [0.01]]), [0.9, 0.5], None),
             (np.array([[0.01, 0.02], [0.01, 0.5]]), [0.5, 0.9], None),
             (np.array([[0.01, 0.3], [0.3, 0.01]]), [0.9, 0.5], np.array([False, True]))]
    cases += [(rng.uniform(0, 0.4, (rng.randint(1, 6), rng.randint(1, 5))), None, None)
              for _ in range(20)]
    jacc, tacc = jb.BopAverageRecall(("vsd", "mssd", "mspd")), tb.BopAverageRecall(
        ("vsd", "mssd", "mspd"))
    for err, scores, gt_valid in cases:
        scores = np.round(rng.rand(len(err)), 1) if scores is None else scores
        gt_valid = (rng.rand(err.shape[1]) < 0.8) if gt_valid is None else gt_valid
        for theta in (0.05, 0.1, 0.25):
            assert tb._greedy_match_count(err, scores, theta, gt_valid) == \
                jb._greedy_match_count(err, scores, theta, gt_valid)
        errors = dict(vsd=rng.uniform(0, 1, (*err.shape, 10)), mssd=err, mspd=err * 100)
        jacc.add_group(errors, scores, gt_valid)
        tacc.add_group(errors, scores, gt_valid)
    assert tacc.summary() == jacc.summary()
    assert 0 < tacc.summary()["AR"] < 1
    with pytest.raises(ValueError, match="GT columns"):
        tacc.add_group(dict(vsd=np.zeros((1, 2)), mssd=np.zeros((1, 2)), mspd=np.zeros((1, 2))),
                       [1.0], 3)


@pytest.fixture(scope="module")
def cube_dbs():
    from cosypose_tpu_torch.ops.mesh_db import MeshSpec

    port = [MeshSpec(**dataclasses.asdict(s)) for s in cube_specs()]
    return j_build_mesh_db(cube_specs()), build_mesh_db(port, device="cpu")


def test_vsd_matrix_through_the_batch_renderer_matches_jax(cube_dbs):
    """Estimates and GTs of one label rendered in one call on either side:
    depth within 1e-4, VSD matrices equal, and one plain render a group (no
    kernel launch: CPU tensors)."""
    jdb, tdb = cube_dbs
    res = (48, 64)
    K = np.array([[60.0, 0, 32], [0, 60.0, 24], [0, 0, 1]], np.float32)
    rng = np.random.RandomState(2)
    gts = [random_pose(rng, z=1.0, t_scale=0.1).astype(np.float32) for _ in range(2)]
    ests = [g.copy() for g in gts] + [gts[0] @ _pose(_rotz(0.3)).astype(np.float32)]
    ests[1][2, 3] += 0.05
    jr, tr = JBatchRenderer(jdb, resolution=res), BatchRenderer(tdb, resolution=res)
    lids, poses, Ks = tb.vsd_render_inputs(1, ests, gts, K)
    ref = np.asarray(jr.render(jnp.asarray(lids), jnp.asarray(poses), jnp.asarray(Ks),
                               resolution=res, render_depth=True).depth)
    before = dict(rc.RASTER_KERNEL.launches)
    port = tr.render(lids, poses, Ks, resolution=res, render_depth=True).depth.numpy()
    assert rc.RASTER_KERNEL.launches == before
    assert np.abs(port - ref).max() <= 1e-4 and np.array_equal(port > 0, ref > 0)
    assert (port > 0).sum(axis=(1, 2)).min() > 50
    d_scene = np.where(ref[3] > 0, ref[3], np.where(ref[4] > 0, ref[4], 0)).astype(np.float32)
    M_j = jb._vsd_matrix(jr, 1, ests, gts, K, d_scene, 0.26)
    M_t = tb._vsd_matrix(tr, 1, ests, gts, K, d_scene, 0.26)
    assert M_t.shape == (3, 2, 10) and np.array_equal(M_t, M_j)
    assert M_t[0, 0].max() == 0 and M_t[1, 1].min() > 0


def write_fixture_depth(root, db):
    """The fixture's scene depth: both cubes' GT poses rendered per frame
    (the nearest surface), whole millimetres in 16-bit PNGs."""
    ds = BOPDataset(root, split="test")
    renderer = BatchRenderer(db, resolution=(96, 128))
    for i in range(len(ds)):
        _, _, obs = ds[i]
        TCW = np.linalg.inv(obs["camera"]["TWC"])
        poses = np.stack([TCW @ o["TWO"] for o in obs["objects"]]).astype(np.float32)
        lids = [db.label_to_id[o["label"]] for o in obs["objects"]]
        Ks = np.tile(obs["camera"]["K"][None], (len(lids), 1, 1))
        depth = renderer.render(lids, poses, Ks, render_depth=True).depth.numpy()
        depth = np.where(depth > 0, depth, np.inf).min(0)
        mm = np.where(np.isfinite(depth), depth * 1000.0, 0).astype(np.uint16)
        d = root / "test" / f"{obs['frame_info']['scene_id']:06d}" / "depth"
        d.mkdir(exist_ok=True)
        png.imwrite(d / f"{obs['frame_info']['view_id']:06d}.png", mm)


def fixture_predictions():
    """Per view: obj1 at its GT pose (score 0.9), a jittered obj1 (0.4, 0.9: a
    tie, 0.95: ranked first), obj2 off by 4 cm (its GT has visib 0.05, an
    ignored column)."""
    rows, poses = [], []
    for view in range(3):
        T = np.eye(4, dtype=np.float32)
        T[2, 3] = 0.5
        J = T.copy()
        J[:3, 3] += (0.004, 0.004, 0.01)
        O = np.eye(4, dtype=np.float32)
        O[:3, 3] = (0.14, 0.0, 0.6)
        for label, score, P in (("obj_000001", 0.9, T), ("obj_000001", (0.4, 0.9, 0.95)[view], J),
                                ("obj_000002", 0.7, O)):
            rows.append(dict(scene_id=1, view_id=view, label=label, score=score))
            poses.append(P)
    return pd.DataFrame(rows), np.stack(poses)


def test_compute_bop19_ar_on_the_bop_fixture_matches_jax(tmp_path):
    root = build_bop_fixture(tmp_path)
    tdb = build_mesh_db(BOPObjectDataset(root / "models").mesh_specs(), device="cpu")
    jdb = j_build_mesh_db(JBOPObjectDataset(root / "models").mesh_specs())
    write_fixture_depth(root, tdb)
    df, poses = fixture_predictions()
    jpreds = PandasTensorCollection(df, poses=jnp.asarray(poses))
    tpreds = TensorCollection({k: df[k].values for k in df.columns}, poses=torch.as_tensor(poses))
    jds, tds = JBOPDataset(root, split="test", load_depth=True), BOPDataset(root, split="test",
                                                                          load_depth=True)
    ref = jb.compute_bop19_ar(jpreds, jds, jdb, renderer=JBatchRenderer(jdb))
    port = tb.compute_bop19_ar(tpreds, tds, tdb, renderer=BatchRenderer(tdb))
    assert port == ref
    assert ref["n_gt"] == 3 and 0 < ref["AR_vsd"] < 1 and 0 < ref["AR"] < 1
    without = tb.compute_bop19_ar(tpreds, BOPDataset(root, split="test"), tdb,
                                  renderer=BatchRenderer(tdb), n_frames=2)
    assert without["AR_vsd"] == 0.0 and without["n_gt"] == 2   # no depth: VSD errors of 1


def test_run_bop_eval_native_path_matches_jax(tmp_path):
    """The CLI's native path on a CSV of the fixture predictions: its ADD(-S)
    summary and AR equal to the JAX package's PoseEvaluation and
    compute_bop19_ar on the same CSV (the JAX CLI prints them only)."""
    from cosypose_tpu.evaluation import bop_export as jexport
    from cosypose_tpu.evaluation.eval_runners import PoseEvaluation as JPoseEvaluation
    from cosypose_tpu.evaluation.meters import PoseErrorMeter as JPoseErrorMeter
    from cosypose_tpu_torch.evaluation import bop_export as texport
    from cosypose_tpu_torch.scripts import run_bop_eval
    from tests.test_torch_port_eval import _compare_summaries

    root = build_bop_fixture(tmp_path)
    write_fixture_depth(root, build_mesh_db(BOPObjectDataset(root / "models").mesh_specs(),
                                            device="cpu"))
    df, poses = fixture_predictions()
    csv = tmp_path / "preds.csv"
    texport.predictions_to_bop_csv(TensorCollection({k: df[k].values for k in df.columns},
                                                    poses=torch.as_tensor(poses)), csv)
    metrics, ar = run_bop_eval.main(["--csv", str(csv), "--dataset", "cubes", "--ds-root",
                                     str(tmp_path), "--device", "cpu"])

    j_df, j_poses = jexport.csv_to_candidates(csv)
    jpreds = PandasTensorCollection(j_df, poses=jnp.asarray(j_poses))
    obj_ds = JBOPObjectDataset(root / "models")
    jdb = j_build_mesh_db(obj_ds.mesh_specs())
    for o in obj_ds.objects:
        jdb.infos[o["label"]]["diameter_m"] = o["diameter_m"]
    jds = JBOPDataset(root, split="test", load_depth=True)
    ref, _ = JPoseEvaluation(jds, {"ADD(-S)": JPoseErrorMeter(
        jdb, error_type="ADD(-S)", report_error_AUC=True, report_AP=True,
        sample_n_points=2000)}).evaluate(jpreds)
    _compare_summaries(ref["ADD(-S)"], metrics["ADD(-S)"], 1e-6)
    assert ref["ADD(-S)"]["n_matched"] >= 3
    assert ar == jb.compute_bop19_ar(jpreds, jds, jdb, renderer=JBatchRenderer(jdb))
    assert 0 < ar["AR_vsd"] < 1
