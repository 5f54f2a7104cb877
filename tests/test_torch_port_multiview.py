"""Port parity for CosyPose stages 2-3 against the JAX package on the CPU:
the host matching library, RANSAC camera hypotheses, both scoring routes and
candidate matching, view groups, the LM loop, the multiview predictor, and
the helpers they bring (AABB mesh database, mesh_ops, TensorCollection's
merge_df / clone / concatenate, Transform, saved detections, nms3d).

Inputs: tests/test_multiview.py's scenes (three cubes of 6, 12 and 18 cm,
the AABB database, make_scene_rich seeds 0-2: duplicate labels, noise and
outliers). The JAX package's matching library is loaded from a copy of its
shipped build in a temporary directory, so that its loader, which rebuilds
the library when the source looks newer, never writes into the repository.

Tolerances: ids, row orders, columns, view pairs, matched candidates, view
groups and LM iteration counts of capped runs exactly equal; camera
hypotheses, TC1C2 and scores within 1e-6; the multiview predictor's poses
within 1e-4. LM from the same initialization: losses within 2e-5 (measured
up to 1.12e-5: the float32 pseudo-inverse of the damped normal matrix keeps
its weakest directions to ~1e-3 relative in either implementation), poses
of capped runs within 1e-5 (measured 1.6e-6). Runs to convergence stop
within one iteration of the JAX package's, poses within 5e-4: the stop
rule |Δloss| < 1e-5 lies at that float32 noise (ROADMAP §3; measured on
make_scene: 4 iterations against 5, poses 9.5e-5 apart; make_scene_rich
seeds 0-2: equal counts).
"""

import pathlib
import pickle
import shutil

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from cosypose_tpu.evaluation import saved_detections as jsaved
from cosypose_tpu.integrated.multiview_predictor import MultiviewScenePredictor as JPredictor
from cosypose_tpu.multiview import bundle_adjustment as jba
from cosypose_tpu.multiview import matching_cext as jm
from cosypose_tpu.multiview import ransac as jr
from cosypose_tpu.ops import mesh_ops as jmesh_ops
from cosypose_tpu.ops.mesh_db import MeshSpec as JMeshSpec
from cosypose_tpu.ops.mesh_db import build_mesh_db as j_build_mesh_db
from cosypose_tpu.ops.transform import Transform as JTransform
from cosypose_tpu.utils.tensor_collection import PandasTensorCollection
from cosypose_tpu.utils.tensor_collection import concatenate as j_concatenate
from cosypose_tpu.visualization.multiview import nms3d as j_nms3d
from cosypose_tpu_torch.evaluation import saved_detections as tsaved
from cosypose_tpu_torch.integrated.multiview_predictor import MultiviewScenePredictor
from cosypose_tpu_torch.multiview import bundle_adjustment as tba
from cosypose_tpu_torch.multiview import matching_cext as tm
from cosypose_tpu_torch.multiview import ransac as tr
from cosypose_tpu_torch.ops import mesh_ops
from cosypose_tpu_torch.ops.mesh_db import MeshSpec, build_mesh_db
from cosypose_tpu_torch.ops.transform import Transform
from cosypose_tpu_torch.utils.tensor_collection import TensorCollection, concatenate
from cosypose_tpu_torch.visualization.multiview import nms3d
from tests.test_multiview import cube_faces, cube_verts, make_db, make_scene, make_scene_rich

SEEDS = [0, 1, 2]
ATOL_T = 1e-6
ATOL_BA = 1e-4
ATOL_LOSS = 2e-5
ATOL_LM_CAPPED, ATOL_LM_CONVERGED = 1e-5, 5e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One PyTorch thread a test process: the suite runs several processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def jax_matching_lib(tmp_path_factory):
    """The JAX package's shipped matching library, loaded from a copy."""
    copy = tmp_path_factory.mktemp("jax_matching") / jm._LIB.name
    shutil.copy(jm._LIB, copy)
    mp = pytest.MonkeyPatch()
    mp.setattr(jm, "_LIB", copy)
    mp.setattr(jm, "_lib", None)
    yield
    mp.undo()


def port_db():
    specs = [MeshSpec(label=f"obj_{i}", vertices=cube_verts(0.03 * (i + 1)) * 1000,
                      faces=cube_faces()) for i in range(3)]
    return build_mesh_db(specs, aabb=True, keep_geometry=False, device="cpu")


def port_candidates(c: PandasTensorCollection) -> TensorCollection:
    return TensorCollection({k: c.infos[k].to_numpy() for k in c.infos},
                            poses=torch.as_tensor(np.array(c.poses)))


def cameras_for(n_views, scene_id=None):
    K = np.zeros((n_views, 3, 3), np.float32)
    K[:, 0, 0] = K[:, 1, 1] = 600
    K[:, 0, 2], K[:, 1, 2], K[:, 2, 2] = 320, 240, 1
    infos = dict(view_id=np.arange(n_views))
    if scene_id is not None:
        infos.update(scene_id=np.full(n_views, scene_id), batch_im_id=np.arange(n_views),
                     group_id=np.zeros(n_views, np.int64))
    TWC = np.tile(np.eye(4, dtype=np.float32), (n_views, 1, 1))
    return (PandasTensorCollection(pd.DataFrame(infos), K=jnp.asarray(K), TWC=jnp.asarray(TWC)),
            TensorCollection(infos, K=torch.as_tensor(K), TWC=torch.as_tensor(TWC)))


def same_table(port: dict, ref: pd.DataFrame, atol=1e-9):
    """Columns in the same order and every row equal (floats within atol)."""
    assert list(port) == list(ref.columns)
    for k in ref.columns:
        a, b = np.asarray(port[k]), ref[k].to_numpy()
        if b.dtype.kind == "f" or a.dtype.kind == "f":
            np.testing.assert_allclose(a.astype(float), b.astype(float), atol=atol, err_msg=k)
        else:
            assert [str(x) for x in a] == [str(x) for x in b], k


def test_matching_library_matches_jax():
    """The port's build of its csrc/matching.cpp against the JAX package's
    library, array for array; the greedy pass also against the numpy
    version. The port builds into build/, not next to the JAX package's."""
    assert tm.build_library().parent == tm.BUILD_DIR
    rng = np.random.RandomState(0)
    view_ids = rng.randint(0, 4, 40).astype(np.int32)
    label_ids = rng.randint(0, 3, 40).astype(np.int32)
    for n_iter, seed in ((5, 0), (20, 3)):
        s_t, t_t = tm.make_ransac_infos(view_ids, label_ids, n_iter, seed)
        s_j, t_j = jm.make_ransac_infos(view_ids, label_ids, n_iter, seed)
        for got, ref in ((s_t, s_j), (t_t, t_j)):
            assert list(got) == list(ref)
            for k in ref:
                np.testing.assert_array_equal(got[k], ref[k])
    dists = rng.uniform(0, 0.04, len(t_t["cand1"])).astype(np.float32)
    args = (s_t["view1"], s_t["view2"], t_t["hypothesis_id"], t_t["cand1"], t_t["cand2"], dists,
            0.02, 3)
    got = tm.find_ransac_inliers(*args)
    for ref in (jm.find_ransac_inliers(*args), tm.find_ransac_inliers_np(*args)):
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k])
    assert len(got["best_hypotheses"]) > 0
    seg = rng.randint(0, 5, 30)
    vals = rng.uniform(size=30).astype(np.float32)
    np.testing.assert_array_equal(tm.scatter_argmin(vals, seg), jm.scatter_argmin(vals, seg))
    for got, ref in zip(tm.expand_ids_for_symmetry(label_ids[:10], [1, 3, 2]),
                        jm.expand_ids_for_symmetry(label_ids[:10], [1, 3, 2])):
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("seed", SEEDS)
def test_matching_matches_jax(seed):
    """Camera hypotheses, both scoring routes (every row's distance, each
    pair's top-k) and multiview_candidate_matching on make_scene_rich."""
    c = make_scene_rich(seed=seed)
    jdb, tdb = make_db(), port_db()
    codes = np.asarray(jdb.ids_for(c.infos["label"].values), np.int32)
    seeds, tmatches = jm.make_ransac_infos(c.infos["view_id"].to_numpy(np.int32), codes, 20, seed)
    tc = port_candidates(c)
    hyp_ref = jr.estimate_camera_poses_batch(c, seeds, jdb)
    hyp = tr.estimate_camera_poses_batch(tc, seeds, tdb)
    np.testing.assert_allclose(hyp, hyp_ref, atol=ATOL_T)
    np.testing.assert_allclose(tr.score_tmatches_batch(tc, tmatches, hyp_ref, tdb),
                               jr.score_tmatches_batch(c, tmatches, hyp_ref, jdb), atol=ATOL_T)
    got = tr.score_and_select_topk(tc, seeds, tmatches, hyp_ref, tdb, 0.02)
    ref = jr.score_and_select_topk(c, seeds, tmatches, hyp_ref, jdb, 0.02)
    for a, b in zip(got[:3], ref[:3]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got[3], ref[3], atol=ATOL_T)

    kw = dict(dist_threshold=0.02, n_ransac_iter=20, n_min_inliers=3, seed=seed)
    for scoring in ("full", "topk"):
        out_j = jr.multiview_candidate_matching(c.clone(), mesh_db=jdb, scoring=scoring, **kw)
        out_t = tr.multiview_candidate_matching(port_candidates(c), mesh_db=tdb, scoring=scoring,
                                                **kw)
        fj, ft = out_j["filtered_candidates"], out_t["filtered_candidates"]
        assert len(ft) > 0
        same_table(ft.infos, fj.infos)
        np.testing.assert_array_equal(ft.poses.numpy(), np.asarray(fj.poses))
        pj, pt = out_j["pairs_TC1C2"], out_t["pairs_TC1C2"]
        same_table(pt.infos, pj.infos)
        np.testing.assert_allclose(pt.TC1C2.numpy(), np.asarray(pj.TC1C2), atol=ATOL_T)
        same_table(out_t["scene_infos"], out_j["scene_infos"])


def test_known_camera_poses_match_jax():
    c, _, TWC = make_scene(noise=0.001)
    cam_j = PandasTensorCollection(pd.DataFrame(dict(view_id=[0, 1, 2])),
                                   TWC=jnp.asarray(TWC, jnp.float32))
    cam_t = TensorCollection(dict(view_id=np.arange(3)), TWC=torch.as_tensor(TWC).float())
    kw = dict(dist_threshold=0.02, n_min_inliers=2)
    out_j = jr.multiview_candidate_matching(c.clone(), make_db(), cameras=cam_j, **kw)
    out_t = tr.multiview_candidate_matching(port_candidates(c), port_db(), cameras=cam_t, **kw)
    assert len(out_t["filtered_candidates"]) == 9
    same_table(out_t["filtered_candidates"].infos, out_j["filtered_candidates"].infos)
    np.testing.assert_allclose(out_t["pairs_TC1C2"].TC1C2.numpy(),
                               np.asarray(out_j["pairs_TC1C2"].TC1C2), atol=ATOL_T)


def test_no_tentative_matches_raises():
    """Every candidate in one view: no tentative match across views."""
    c = make_scene_rich(seed=0)
    c.infos["view_id"] = 0
    with pytest.raises(ValueError, match="No tentative matches across views"):
        jr.multiview_candidate_matching(c.clone(), make_db())
    with pytest.raises(ValueError, match="No tentative matches across views"):
        tr.multiview_candidate_matching(port_candidates(c), port_db())


def test_make_view_groups_matches_jax():
    for v1, v2 in (([0, 1, 5], [1, 0, 6]), ([3, 1, 2, 1, 7, 2], [1, 3, 1, 2, 3, 9])):
        ref = jba.make_view_groups(PandasTensorCollection(
            pd.DataFrame(dict(view1=v1, view2=v2)), TC1C2=jnp.zeros((len(v1), 4, 4))))
        got = tba.make_view_groups(TensorCollection(
            dict(view1=np.asarray(v1), view2=np.asarray(v2)), TC1C2=torch.zeros(len(v1), 4, 4)))
        same_table(got, ref)


def _refinements(scene):
    """The JAX package's and the port's MultiviewRefinement on the matched
    candidates of a scene."""
    if scene == "make_scene":
        c, _, _ = make_scene(noise=0.004, seed=3)
        kw = dict(n_ransac_iter=20, dist_threshold=0.05, n_min_inliers=2)
        n_views = 3
    else:
        c = make_scene_rich(seed=scene)
        kw = dict(n_ransac_iter=20, dist_threshold=0.02, n_min_inliers=3, seed=scene)
        n_views = 4
    mj = jr.multiview_candidate_matching(c.clone(), make_db(), **kw)
    mt = tr.multiview_candidate_matching(port_candidates(c), port_db(), **kw)
    cam_j, cam_t = cameras_for(n_views)
    return (jba.MultiviewRefinement(mj["filtered_candidates"], cam_j, mj["pairs_TC1C2"],
                                    make_db()),
            tba.MultiviewRefinement(mt["filtered_candidates"], cam_t, mt["pairs_TC1C2"],
                                    port_db()))


@pytest.mark.parametrize("scene", ["make_scene", 0, 1, 2])
def test_optimize_lm_matches_jax(scene):
    """From the same initialization (the JAX package's; the port's own lies
    within 1e-6, the last bits of invert_T): capped runs of 1 and 2
    iterations equal in count, runs to convergence within one iteration
    (module docstring)."""
    rj, rt = _refinements(scene)
    TWO0, TCW0 = rj.robust_initialization(1)
    for got, ref in zip(rt.robust_initialization(1), (TWO0, TCW0)):  # last bits of invert_T
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL_T)
    T9, C9 = torch.as_tensor(np.array(TWO0)), torch.as_tensor(np.array(TCW0))
    args_j = (rj.cand_TCO, jnp.asarray(rj.cand_view_ids), jnp.asarray(rj.cand_obj_ids), rj.K,
              rj.obj_points, rj.cand_syms, rj.cand_sym_valid)
    views, objs = rt._ids()
    args_t = (rt.cand_TCO, views, objs, rt.K, rt.obj_points, rt.cand_syms, rt.cand_sym_valid)
    for n in (1, 2, 100):
        ref = jba._optimize_lm(TWO0, TCW0, *args_j, n_iterations=n)
        got = tba._optimize_lm(T9, C9, *args_t, n_iterations=n)
        if n < 100:
            assert got[3] == int(ref[3]) == n
        else:
            assert abs(got[3] - int(ref[3])) <= 1
        atol = ATOL_LM_CAPPED if n < 100 else ATOL_LM_CONVERGED
        assert abs(float(got[2]) - float(ref[2])) <= ATOL_LOSS
        np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=atol)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), atol=atol)


def test_pinv_cuts_singular_values_as_jax():
    """A rank-deficient A whose singular values straddle the two cut-offs:
    the port drops what jnp.linalg.pinv drops (10·D·eps of the largest), which
    torch.linalg.pinv's default (D·eps) keeps."""
    D = 18
    rng = np.random.RandomState(0)
    U, _ = np.linalg.qr(rng.normal(size=(D, D)))
    eps = np.finfo(np.float32).eps
    s = np.array([1e6] * 10 + [3 * D * eps * 1e6] * 4 + [0.0] * 4)
    A = ((U * s) @ U.T).astype(np.float32)
    ref = np.asarray(jnp.linalg.pinv(jnp.asarray(A)))
    got = tba.pinv(torch.as_tensor(A)).numpy()
    default = torch.linalg.pinv(torch.as_tensor(A)).numpy()
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= 1e-3 * scale
    assert np.abs(default - ref).max() > 10 * scale


@pytest.mark.parametrize("seed", SEEDS)
def test_predict_scene_state_matches_jax(seed):
    """Every prediction key: columns, row orders and ids equal, poses within
    ATOL_BA. Scores spread over [0.25, 0.95], so score_th drops some."""
    c = make_scene_rich(seed=seed)
    c.infos["scene_id"] = 3
    c.infos["group_id"] = 7
    c.infos["score"] = np.linspace(0.25, 0.95, len(c))
    cam_j, cam_t = cameras_for(4, scene_id=3)
    kw = dict(ransac_n_iter=20, ba_n_iter=10)
    ref = JPredictor(make_db()).predict_scene_state(c, cam_j, **kw)
    got = MultiviewScenePredictor(port_db()).predict_scene_state(port_candidates(c), cam_t, **kw)
    assert list(got) == list(ref)
    for k in ref:
        same_table(got[k].infos, ref[k].infos)
        assert list(got[k].tensors) == list(ref[k].tensors)
        for name in ref[k].tensors:
            np.testing.assert_allclose(got[k].tensors[name].numpy(),
                                       np.asarray(ref[k].tensors[name]), atol=ATOL_BA,
                                       err_msg=f"{k}/{name}")


def test_aabb_mesh_db_and_mesh_ops_match_jax():
    specs = [dict(label=f"obj_{i}", vertices=np.random.RandomState(i).normal(size=(30, 3)) * 40,
                  faces=np.random.RandomState(i).randint(0, 30, (20, 3)))
             for i in range(3)]
    for kw in (dict(aabb=True, keep_geometry=False), dict(resample_n_points=50)):
        ref = j_build_mesh_db([JMeshSpec(**s) for s in specs], **kw)
        got = build_mesh_db([MeshSpec(**s) for s in specs], device="cpu", **kw)
        for k in ("points", "valid", "symmetries", "sym_valid"):
            np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(ref, k)),
                                       atol=1e-7)
        assert (got.tri_verts is None) == (ref.tri_verts is None)
        assert got.infos == ref.infos
    pts = np.random.RandomState(5).normal(size=(2, 40, 3)).astype(np.float32)
    for name in ("get_meshes_bounding_boxes", "get_meshes_center"):
        np.testing.assert_allclose(getattr(mesh_ops, name)(torch.as_tensor(pts)).numpy(),
                                   np.asarray(getattr(jmesh_ops, name)(jnp.asarray(pts))),
                                   atol=1e-7)
    np.testing.assert_array_equal(
        mesh_ops.sample_points(torch.as_tensor(pts), 7, deterministic=True).numpy(),
        np.asarray(jmesh_ops.sample_points(jnp.asarray(pts), 7, deterministic=True)))


def test_tensor_collection_merge_clone_concat_match_pandas():
    left = dict(view_id=np.array([3, 1, 3, 2]), score=np.array([0.5, 0.2, 0.9, 0.1]))
    right = dict(view_id=np.array([1, 2, 3]), view_group=np.array([0, 1, 1]))
    poses = torch.arange(4 * 16, dtype=torch.float32).reshape(4, 4, 4)
    ref = PandasTensorCollection(pd.DataFrame(left), poses=jnp.asarray(poses.numpy())).merge_df(
        pd.DataFrame(right), on="view_id")
    got = TensorCollection(left, poses=poses).merge_df(right, on="view_id")
    same_table(got.infos, ref.infos)
    np.testing.assert_array_equal(got.poses.numpy(), np.asarray(ref.poses))
    clone = got.clone()
    clone.infos["score"][0] = -1.0
    assert got.infos["score"][0] == 0.5
    a = dict(view_id=np.array([1, 2]), from_ba=np.array([True, True]), obj_id=np.array([0, 1]))
    b = dict(view_id=np.array([5]), label=np.array(["obj_1"]), from_ba=np.array([False]))
    ref = j_concatenate([PandasTensorCollection(pd.DataFrame(t), poses=jnp.zeros((len(t["view_id"]),
                                                                                   4, 4)))
                         for t in (a, b)])
    got = concatenate([TensorCollection(t, poses=torch.zeros(len(t["view_id"]), 4, 4))
                       for t in (a, b)])
    assert list(got.infos) == list(ref.infos.columns)
    for k in ref.infos.columns:
        assert [str(x) for x in got.infos[k]] == [str(x) for x in ref.infos[k]], k
        assert got.infos[k].dtype == ref.infos[k].to_numpy().dtype, k


def test_transform_matches_jax():
    q = np.array([0.1, -0.3, 0.2, 0.9])
    for args in ((q, [0.1, 0.2, 0.3]), (np.eye(3), [1.0, 0, 0]),
                 (np.diag([1.0, -1, -1]), [0, 0, 1])):
        a, b = Transform(*args), JTransform(*args)
        c, d = Transform(np.roll(q, 1), [0.0, 1, 0]), JTransform(np.roll(q, 1), [0.0, 1, 0])
        np.testing.assert_array_equal((a * c).inverse().toHomogeneousMatrix(),
                                      (b * d).inverse().toHomogeneousMatrix())
        np.testing.assert_array_equal(a.quaternion, b.quaternion)


def _write_saved_detections(root: pathlib.Path):
    """Files of the published formats (tests/test_saved_detections.py's)."""
    (root / "saved_detections").mkdir()
    (root / "bop_datasets" / "ycbv").mkdir(parents=True)
    (root / "bop_datasets" / "ycbv" / "offsets.txt").write_text(
        "01 [10.0, 0.0, 0.0]\n05 [0.0, -20.0, 5.0]\n")
    posecnn = {"48/1": dict(rois=np.array([[0, 1, 10.0, 20.0, 100.0, 120.0],
                                           [0, 5, 30.0, 40.0, 200.0, 220.0]]),
                            poses=np.array([[1, 0, 0, 0, 0.1, 0.2, 0.9],
                                            [0.5, 0.5, 0.5, 0.5, -0.1, 0.0, 1.1]]))}
    (root / "saved_detections" / "ycbv_posecnn.pkl").write_bytes(pickle.dumps(posecnn))
    T_bad, T_ok = np.eye(4), np.eye(4)
    T_bad[:3, 3] = 0.0
    T_ok[:3, 3] = [0.1, 0.0, 0.5]
    pix2pose = {"3/7": dict(rois=np.array([[5.0, 10.0, 50.0, 90.0], [1.0, 2.0, 3.0, 4.0]]),
                            scores=np.array([0.9, 0.4]), poses=np.stack([T_ok, T_bad]),
                            labels_txt=["obj_000002", "obj_000009"])}
    for name in ("tless_pix2pose_retinanet_vivo_all.pkl",
                 "tless_pix2pose_retinanet_siso_top1.pkl"):
        (root / "saved_detections" / name).write_bytes(pickle.dumps(pix2pose))


def test_saved_detections_match_jax(tmp_path):
    _write_saved_detections(tmp_path)
    loads = [(tsaved.load_posecnn_results, jsaved.load_posecnn_results, {})]
    loads += [(tsaved.load_pix2pose_results, jsaved.load_pix2pose_results,
               dict(all_detections=a, remove_incorrect_poses=r))
              for a in (True, False) for r in (True, False)]
    for port_fn, jax_fn, kw in loads:
        got, ref = port_fn(local_data_dir=tmp_path, **kw), jax_fn(local_data_dir=tmp_path, **kw)
        same_table(got.infos, ref.infos)
        for k in ("poses", "bboxes"):
            np.testing.assert_array_equal(got.tensors[k].numpy(), np.asarray(ref.tensors[k]))


def test_nms3d_matches_jax():
    rng = np.random.RandomState(0)
    T = np.tile(np.eye(4, dtype=np.float32), (30, 1, 1))
    T[:, :3, 3] = rng.uniform(-0.1, 0.1, (30, 3))
    infos = dict(score=rng.uniform(size=30), label=np.asarray([f"obj_{i % 3}" for i in range(30)]))
    ref = j_nms3d(PandasTensorCollection(pd.DataFrame(infos), poses=jnp.asarray(T)), th=0.04)
    got = nms3d(TensorCollection(infos, poses=torch.as_tensor(T)), th=0.04)
    assert 0 < len(got) < 30
    same_table(got.infos, ref.infos)
    np.testing.assert_array_equal(got.poses.numpy(), np.asarray(ref.poses))

