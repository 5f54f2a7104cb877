"""The multiview and ICP CLIs of the port against the JAX package's on the
CPU, at a debug size:

  * run_custom_scenario: both CLIs on one scenario directory this file
    writes (bench_multiview's scene at 4 views, BOP models and cameras);
  * bench_multiview: the port's make_scenario is the JAX package's, and its
    counts are the JAX package's stages' on it;
  * run_bop_inference --icp --nviews 2 and run_cosypose_eval
    --use-detections-tco --nviews 2 on cubes the port records at 96x128
    (5-6 objects a scene, view groups of two frames). The pose stage takes its
    poses from the detections: run_bop_inference's detector and pose models
    are stand-ins that return each frame's ground truth with seeded noise,
    and run_cosypose_eval reads a CSV of noisy ground truth and runs 0
    refiner iterations, so that the multiview stage has candidates that
    match across views (a model with random weights gives none, and then
    the JAX package stops too).

Tolerances: ids, labels, row orders, counts and icp_ok flags exactly equal;
bundle-adjusted poses within 5e-4 (tests/test_torch_port_multiview.py: the
LM runs may stop an iteration apart), ICP poses within 5e-4
(tests/test_torch_port_icp.py), the CSVs' translations (mm) within 0.5.
"""

import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from cosypose_tpu.data import datasets_cfg as j_datasets_cfg
from cosypose_tpu.data.datasets_cfg import make_scene_dataset as j_make_scene_dataset
from cosypose_tpu.data.wrappers import MultiViewWrapper as JMultiViewWrapper
from cosypose_tpu.evaluation.pred_runners import MultiviewPredictionRunner as JRunner
from cosypose_tpu.integrated import CoarseRefinePosePredictor as JCoarseRefine
from cosypose_tpu.integrated import LoadedPoseModel as JLoadedPoseModel
from cosypose_tpu.integrated.multiview_predictor import MultiviewScenePredictor as JPredictor
from cosypose_tpu.multiview import bundle_adjustment as jba
from cosypose_tpu.multiview import ransac as jr
from cosypose_tpu.ops.mesh_db import MeshSpec as JMeshSpec
from cosypose_tpu.ops.mesh_db import build_mesh_db as j_build_mesh_db
from cosypose_tpu.scripts import bench_multiview as j_bench
from cosypose_tpu.scripts import run_bop_inference as j_bop_cli
from cosypose_tpu.scripts import run_custom_scenario as j_scenario_cli
from cosypose_tpu.utils.tensor_collection import PandasTensorCollection
from cosypose_tpu_torch.evaluation.bop_export import predictions_to_bop_csv
from cosypose_tpu_torch.integrated.pose_predictor import LoadedPoseModel
from cosypose_tpu_torch.ops.mesh_db import MeshSpec, build_mesh_db
from cosypose_tpu_torch.recording.record_dataset import record_dataset
from cosypose_tpu_torch.recording.scene_sampler import RecordingSceneSampler
from cosypose_tpu_torch.scripts import bench_multiview as bench
from cosypose_tpu_torch.scripts import run_bop_inference as bop_cli
from cosypose_tpu_torch.scripts import run_cosypose_eval as eval_cli
from cosypose_tpu_torch.scripts import run_custom_scenario as scenario_cli
from cosypose_tpu_torch.utils.tensor_collection import TensorCollection
from tests.test_data import write_cube_ply
from tests.test_pose_predictor import cube_specs
from tests.test_torch_port_multiview import jax_matching_lib  # noqa: F401 (fixture)
from tests.test_torch_port_slice import make_weights, port_specs

ATOL_POSE = 5e-4
ATOL_MM = 0.5
SMALL = dict(n_views=4, n_objects=6, n_labels=3, dup=2, outliers=2, noise_t=0.004,
             noise_deg=2.0)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def read_csv(path):
    rows = [line.split(",") for line in pathlib.Path(path).read_text().splitlines()[1:]]
    ids = [tuple(r[:4]) + (r[6],) for r in rows]
    R = np.asarray([[float(x) for x in r[4].split()] for r in rows])
    t = np.asarray([[float(x) for x in r[5].split()] for r in rows])
    return ids, R, t


def same_csv(port, ref):
    (ids_p, R_p, t_p), (ids_r, R_r, t_r) = read_csv(port), read_csv(ref)
    assert ids_p == ids_r and len(ids_p) > 0
    np.testing.assert_allclose(R_p, R_r, atol=ATOL_POSE)
    np.testing.assert_allclose(t_p, t_r, atol=ATOL_MM)


def write_scenario(root: pathlib.Path):
    """candidates.csv, scene_camera.json and models/ of bench_multiview's
    scene at 4 views."""
    candidates, cameras, _ = bench.make_scenario(**SMALL)
    root.mkdir(parents=True)
    predictions_to_bop_csv(candidates, root / "candidates.csv")
    cams = {}
    for v, (K, TWC) in enumerate(zip(cameras.K.numpy(), cameras.TWC.numpy())):
        TCW = np.linalg.inv(TWC.astype(np.float64))
        cams[str(v)] = dict(cam_K=K.reshape(-1).tolist(),
                            cam_R_w2c=TCW[:3, :3].reshape(-1).tolist(),
                            cam_t_w2c=(TCW[:3, 3] * 1000).tolist())
    (root / "scene_camera.json").write_text(json.dumps(cams))
    (root / "models").mkdir()
    infos = {}
    for i in range(SMALL["n_labels"]):
        write_cube_ply(root / "models" / f"obj_{i:06d}.ply", 40.0 + 16.0 * i)
        infos[str(i)] = dict(diameter=(40.0 + 16.0 * i) * 3 ** 0.5)
    (root / "models" / "models_info.json").write_text(json.dumps(infos))


def test_run_custom_scenario_matches_jax(tmp_path):
    for name in ("port", "jax"):
        write_scenario(tmp_path / name)
    args = ["--ransac_n_iter", "2000", "--ba_n_iter", "20"]
    got = scenario_cli.main(["--scenario", str(tmp_path / "port"), *args, "--device", "cpu"])
    ref = j_scenario_cli.main(["--scenario", str(tmp_path / "jax"), *args])
    assert got["scene"].keys() == ref.keys()
    objs_p, objs_r = got["scene"]["objects"], ref["objects"]
    assert [(o["label"], o["n_cand"]) for o in objs_p] == [(o["label"], o["n_cand"])
                                                           for o in objs_r]
    assert len(objs_p) >= SMALL["n_objects"] - 1
    np.testing.assert_allclose([o["score"] for o in objs_p], [o["score"] for o in objs_r],
                               atol=1e-9)
    np.testing.assert_allclose([o["TWO"] for o in objs_p], [o["TWO"] for o in objs_r],
                               atol=ATOL_POSE)
    assert [c["view_id"] for c in got["scene"]["cameras"]] == [c["view_id"]
                                                               for c in ref["cameras"]]
    np.testing.assert_allclose([c["TWC"] for c in got["scene"]["cameras"]],
                               [c["TWC"] for c in ref["cameras"]], atol=ATOL_POSE)
    same_csv(tmp_path / "port" / "results" / "scene_reprojected.csv",
             tmp_path / "jax" / "results" / "scene_reprojected.csv")


def test_bench_multiview_matches_jax():
    """The scene equals the JAX package's; the bench's counts equal the JAX
    package's stages on it."""
    got_c, got_cam, _ = bench.make_scenario(**SMALL)
    ref_c, ref_cam = j_bench.make_scenario(**SMALL)
    for k in ref_c.infos.columns:
        assert got_c.infos[k].tolist() == ref_c.infos[k].tolist(), k
    np.testing.assert_array_equal(got_c.poses.numpy(), np.asarray(ref_c.poses))
    np.testing.assert_array_equal(got_cam.TWC.numpy(), np.asarray(ref_cam.TWC))
    rows = bench.main(["--n-views", "4", "--n-objects", "6", "--n-labels", "3", "--dup", "2",
                       "--outliers", "2", "--ransac-iter", "2000", "--ba-iter", "20", "--reps", "1",
                       "--device", "cpu"])
    jdb = j_build_mesh_db(j_bench._cube_specs(3), aabb=True, keep_geometry=False)
    match = jr.multiview_candidate_matching(ref_c, jdb, n_ransac_iter=2000)
    merged = match["filtered_candidates"].merge_df(jba.make_view_groups(match["pairs_TC1C2"]),
                                                   on="view_id")
    bas = [jba.MultiviewRefinement(merged[np.asarray(ids)], ref_cam, match["pairs_TC1C2"],
                                   jdb).solve(n_iterations=20)
           for _, ids in merged.infos.groupby("view_group").groups.items()]
    row = rows[0]
    assert (row["n_candidates"], row["n_matched"], row["n_groups"], row["n_objects_out"]) == (
        len(ref_c), len(merged), len(bas), sum(len(b["objects"]) for b in bas))
    assert all(abs(a - b["n_lm_iterations"]) <= 1 for a, b in zip(row["n_lm_iterations"], bas))
    assert row["ransac_models_s"] > 0 and row["ba_opt_s"] > 0


# -- the CLIs over recorded cubes -----------------------------------------------------------

class CubeObjects:
    def __init__(self, spec_cls):
        self.spec_cls = spec_cls
        self.labels = ["obj_000001", "obj_000002"]

    def mesh_specs(self):
        return [self.spec_cls(**vars(s)) for s in cube_specs()]


@pytest.fixture(scope="module")
def cubes4(tmp_path_factory):
    """<root>/synt_datasets/cubes4: one scene of 5-6 cubes seen from 4
    cameras at 1.5-1.7 m, all in the val split; each view group of two
    frames shares 4-5 visible cubes."""
    root = tmp_path_factory.mktemp("cubes4")
    sampler = RecordingSceneSampler(
        build_mesh_db(port_specs(), device="cpu"), resolution=(96, 128),
        n_objects_interval=(5, 6), min_visible_pixels=10, border_check=False,
        camera_distance_interval=(1.5, 1.7), n_views_per_scene=4)
    record_dataset(sampler, root / "synt_datasets" / "cubes4", n_chunks=1, n_frames_per_chunk=4,
                   train_fraction=0.0)
    return root


def ground_truth(root):
    """{rgb bytes (3,H,W): (labels, boxes, masks, noisy TCO)} of every frame."""
    ds = j_make_scene_dataset("synthetic.cubes4.val", ds_root=root)
    rng = np.random.RandomState(0)
    out = {}
    for i in range(len(ds)):
        rgb, mask, obs = ds[i]
        TCW = np.linalg.inv(obs["camera"]["TWC"])
        objs = obs["objects"]
        TCO = np.stack([TCW @ o["TWO"] for o in objs]).astype(np.float32)
        TCO[:, :3, 3] += rng.normal(scale=0.002, size=(len(objs), 3))
        out[np.transpose(rgb, (2, 0, 1)).tobytes()] = (
            [o["label"] for o in objs], np.stack([o["bbox"] for o in objs]),
            np.stack([mask == o["id_in_segm"] for o in objs]), TCO)
    return out


class GTDetector:
    """Each frame's ground truth as its detections (found by the frame's
    bytes), with noisy poses in `gt_poses`; in either package's types."""

    def __init__(self, gt, port: bool):
        self.gt, self.port = gt, port

    def get_detections(self, images, detection_th=None, output_masks=False, **kw):
        rows = []
        for b, im in enumerate(np.asarray(images)):
            labels, boxes, masks, TCO = self.gt[im.tobytes()]
            rows += [(b, lab, boxes[n], masks[n], TCO[n]) for n, lab in enumerate(labels)]
        infos = dict(batch_im_id=np.asarray([r[0] for r in rows]),
                     label=np.asarray([r[1] for r in rows]), score=np.ones(len(rows)))
        tensors = {k: np.stack([r[i] for r in rows]) for k, i in
                   (("bboxes", 2), ("gt_poses", 4)) + ((("masks", 3),) if output_masks else ())}
        if self.port:
            return TensorCollection(infos, **{k: torch.as_tensor(v) for k, v in tensors.items()})
        return PandasTensorCollection(pd.DataFrame(infos),
                                      **{k: jnp.asarray(v) for k, v in tensors.items()})


class GTPoses:
    """The pose stage: each detection's noisy ground-truth pose."""

    device = torch.device("cpu")

    def __init__(self, port: bool):
        self.port = port

    def get_predictions(self, images, K, detections=None, **kw):
        if self.port:
            return TensorCollection(dict(detections.infos), poses=detections.gt_poses), {}
        return PandasTensorCollection(detections.infos.copy(), poses=detections.gt_poses), {}


def test_run_bop_inference_icp_nviews_matches_jax(cubes4, tmp_path):
    gt = ground_truth(cubes4)
    mp = pytest.MonkeyPatch()
    try:
        for cli, port in ((bop_cli, True), (j_bop_cli, False)):
            mp.setattr(cli, "load_detector", lambda *a, _p=port, **k: GTDetector(gt, _p))
            mp.setattr(cli, "load_pose_model", lambda *a, **k: None)
            mp.setattr(cli, "CoarseRefinePosePredictor", lambda *a, _p=port, **k: GTPoses(_p))
        mp.setattr(bop_cli, "make_object_dataset",
                   lambda name, ds_root=None: CubeObjects(MeshSpec))
        # the JAX CLI's procedural branch imports make_object_dataset in main
        mp.setattr(j_datasets_cfg, "make_object_dataset",
                   lambda name, ds_root=None: CubeObjects(JMeshSpec))
        args = ["--dataset", "procedural", "--inference-ds", "synthetic.cubes4.val", "--icp",
                "--nviews", "2", "--detection-th", "0.0", "--ds-root", str(cubes4)]
        got = bop_cli.main(args + ["--out-dir", str(tmp_path / "port"), "--device", "cpu"])
        ref = j_bop_cli.main(args + ["--out-dir", str(tmp_path / "jax")])
    finally:
        mp.undo()
    preds = got["predictions"]
    assert set(preds) == {"pose", "multiview", "icp"} == set(got["csv_paths"])
    assert set(got["metrics"]) == set(ref) == {"pose", "multiview", "icp", "bop19_ar"}
    assert got["metrics"]["bop19_ar"]["prediction_key"] == "icp"
    for key in ("pose", "multiview", "icp"):
        same_csv(got["csv_paths"][key], tmp_path / "jax" / f"cosyposetpu_{key}-procedural-test.csv")
    assert preds["icp"].infos["icp_ok"].any()
    assert preds["multiview"].infos["from_ba"].any()


def test_run_cosypose_eval_multiview_matches_jax(cubes4, tmp_path):
    """--use-detections-tco --nviews 2 from a CSV of noisy ground truth,
    against the JAX package's MultiviewPredictionRunner with its
    multiview predictor on the same candidates."""
    gt = ground_truth(cubes4)
    ds = j_make_scene_dataset("synthetic.cubes4.val", ds_root=cubes4)
    rows, poses = [], []
    for i in range(len(ds)):
        rgb, _, obs = ds[i]
        labels, _, _, TCO = gt[np.transpose(rgb, (2, 0, 1)).tobytes()]
        f = obs["frame_info"]
        rows += [(f["scene_id"], f["view_id"], lab) for lab in labels]
        poses.append(TCO)
    n = len(rows)
    csv = tmp_path / "candidates.csv"
    predictions_to_bop_csv(TensorCollection(
        dict(scene_id=np.asarray([r[0] for r in rows]), view_id=np.asarray([r[1] for r in rows]),
             label=np.asarray([r[2] for r in rows]), score=np.ones(n)),
        poses=torch.as_tensor(np.concatenate(poses))), csv)
    jpp, v, pp = make_weights()
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(eval_cli, "make_object_dataset",
                   lambda name, ds_root=None: CubeObjects(MeshSpec))
        mp.setattr(eval_cli, "load_pose_model", lambda run, db, **k: LoadedPoseModel(
            pp, db, device="cpu"))
        got = eval_cli.main(["--dataset", "synthetic.cubes4.val", "--detections", str(csv),
                             "--refiner", "tiny", "--use-detections-tco", "--nviews", "2",
                             "--n-refiner-iterations", "0", "--ds-root", str(cubes4),
                             "--out-dir", str(tmp_path / "out"), "--device", "cpu"])
    finally:
        mp.undo()
    from cosypose_tpu.evaluation.bop_export import csv_to_candidates as j_csv

    df, jposes = j_csv(csv)
    jdb = j_build_mesh_db(cube_specs())
    jref = JCoarseRefine(None, JLoadedPoseModel(jpp, v, jdb))
    ref = JRunner(JMultiViewWrapper(ds, 2), n_coarse_iterations=0, n_refiner_iterations=0) \
        .get_predictions(jref, mv_predictor=JPredictor(j_build_mesh_db(
            cube_specs(), aabb=True, keep_geometry=False)),
            detections=PandasTensorCollection(df, poses=jnp.asarray(jposes)),
            use_detections_TCO=True)
    preds = got["predictions"]
    assert set(preds) == set(ref)
    assert {k for k in preds if k.startswith("multiview/")} == {
        f"multiview/{k}" for k in ("cand_inputs", "cand_matched", "ba_input", "ba_output",
                                   "ba_output+all_cand", "scene_objects", "scene_cameras")}
    for key in preds:
        a, b = preds[key], ref[key]
        for col in ("scene_id", "view_id", "label", "obj_id"):
            if col in b.infos:
                assert [str(x) for x in a.infos[col]] == [str(x) for x in b.infos[col]], (key, col)
        for name in b.tensors:
            np.testing.assert_allclose(a.tensors[name].numpy(), np.asarray(b.tensors[name]),
                                       atol=ATOL_POSE, err_msg=f"{key}/{name}")
    assert "multiview/ba_output" in got["metrics"]
    assert (tmp_path / "out" / "results.pkl").exists()
