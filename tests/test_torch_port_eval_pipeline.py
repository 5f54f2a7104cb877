"""Port parity for the evaluation pipeline, JAX package vs port on the CPU.

collect_gt and per_pair_errors on the BOP fixture of tests/test_data.py;
MultiviewPredictionRunner behind run_pred_eval with PoseEvaluation and
DetectionEvaluation (saved detections from GT boxes, and the refiner from
the detections' own poses); the in-training evaluation callback; and the two
CLIs that use them, run_pose_training with its bundle and
run_procedural_accuracy, on a cube set the port records at 96x128.

Weights: tests/test_torch_port_slice.make_weights (EfficientNet-B0, 48x64
renders, the port's seeded init with a random pose kernel, carried to JAX by
the package's own converter); the callback's train state takes them through
utils/weights.py. The cubes stay under every binning budget, so both
packages render the same images.

Tolerances: collect_gt exactly equal (the resize is Pillow's arithmetic);
per_pair_errors within 1e-12 relative (the same float64 numpy on the same
float32 points); predicted poses within the slice tests' atol 1e-4 + rtol
1e-6; the meters' summaries of the same predictions as in
tests/test_torch_port_eval.py (counts equal, error-derived values within
1e-6 relative, the rest within 1e-9); the callback's metrics equal at init
(the same TCO_init) and, after the iterations, within 1e-4 m on ADD and
translations and 1e-2 degrees on rotations (the pose tolerance carried
through); its train state's state dict bitwise unchanged.
"""

import dataclasses
import json
import types

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from cosypose_tpu.data.bop import BOPDataset as JBOPDataset
from cosypose_tpu.data.bop import BOPObjectDataset as JBOPObjectDataset
from cosypose_tpu.data.wrappers import MultiViewWrapper as JMultiViewWrapper
from cosypose_tpu.evaluation import eval_bundle as jbundle
from cosypose_tpu.evaluation import meters as jm
from cosypose_tpu.evaluation.eval_runners import DetectionEvaluation as JDetectionEvaluation
from cosypose_tpu.evaluation.eval_runners import PoseEvaluation as JPoseEvaluation
from cosypose_tpu.evaluation.pred_runners import MultiviewPredictionRunner as JRunner
from cosypose_tpu.evaluation.runner_utils import run_pred_eval as j_run_pred_eval
from cosypose_tpu.integrated import CoarseRefinePosePredictor as JCoarseRefine
from cosypose_tpu.integrated import LoadedPoseModel as JLoadedPoseModel
from cosypose_tpu.ops import transforms as jtransforms
from cosypose_tpu.ops.mesh_db import build_mesh_db as j_build_mesh_db
from cosypose_tpu.utils.tensor_collection import PandasTensorCollection
from cosypose_tpu_torch.data.bop import BOPDataset, BOPObjectDataset
from cosypose_tpu_torch.data.wrappers import MultiViewWrapper
from cosypose_tpu_torch.evaluation import eval_bundle as tbundle
from cosypose_tpu_torch.evaluation import meters as tm
from cosypose_tpu_torch.evaluation.eval_runners import DetectionEvaluation, PoseEvaluation
from cosypose_tpu_torch.evaluation.pred_runners import MultiviewPredictionRunner
from cosypose_tpu_torch.evaluation.runner_utils import run_pred_eval
from cosypose_tpu_torch.integrated.pose_predictor import CoarseRefinePosePredictor, LoadedPoseModel
from cosypose_tpu_torch.ops.mesh_db import build_mesh_db
from cosypose_tpu_torch.ops.transforms import add_pose_noise
from cosypose_tpu_torch.recording import RecordingSceneSampler, record_dataset
from cosypose_tpu_torch.scripts import run_pose_training as train_cli
from cosypose_tpu_torch.scripts import run_procedural_accuracy as acc_cli
from cosypose_tpu_torch.training import pose_training as tpt
from cosypose_tpu_torch.training.configs import RunConfig
from cosypose_tpu_torch.utils import png
from cosypose_tpu_torch.utils.tensor_collection import TensorCollection
from cosypose_tpu_torch.utils.weights import load_jax_train_state
from tests.test_data import build_bop_fixture
from tests.test_torch_port_eval import _compare_summaries
from tests.test_torch_port_slice import ATOL, RTOL, make_weights, port_cfg, port_specs

BSZ = 64   # the eval bundle's chunk: one JAX compile serves every test here


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The fast tier runs several test processes side by side on the CPU's
    cores; PyTorch's own thread pool in each would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    return make_weights()


@pytest.fixture(scope="module")
def bop(tmp_path_factory):
    """(root, JAX and port scene datasets, JAX and port mesh databases) of the
    BOP fixture, with the models' diameters in both databases' infos."""
    root = build_bop_fixture(tmp_path_factory.mktemp("bop"))
    obj_ds = BOPObjectDataset(root / "models")
    jdb = j_build_mesh_db(JBOPObjectDataset(root / "models").mesh_specs())
    tdb = build_mesh_db(obj_ds.mesh_specs(), device="cpu")
    for o in obj_ds.objects:
        jdb.infos[o["label"]]["diameter_m"] = tdb.infos[o["label"]]["diameter_m"] = o["diameter_m"]
    return root, JBOPDataset(root, split="test"), BOPDataset(root, split="test"), jdb, tdb


def _close(port, ref, what):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), atol=ATOL, rtol=RTOL,
                               err_msg=what)


@pytest.mark.parametrize("resize", [None, (48, 64)])
def test_collect_gt_and_per_pair_errors_match_jax(bop, resize):
    _, jds, tds, jdb, tdb = bop
    ref = jbundle.collect_gt(jds, 3, resize=resize)
    port = tbundle.collect_gt(tds, 3, resize=resize)
    for a, b in ((port[0], ref[0]), (port[1], ref[1]), (port[3], ref[3]), (port[4], ref[4])):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert list(port[2]) == list(ref[2].columns)
    for k in port[2]:
        assert port[2][k].tolist() == ref[2][k].tolist(), k
    TCO_gt = port[3]
    rng = np.random.RandomState(0)
    TCO_pred = add_pose_noise(torch.as_tensor(TCO_gt), torch.Generator().manual_seed(0)).numpy()
    TCO_pred[:, :3, 3] += rng.normal(0, 0.01, (len(TCO_gt), 3)).astype(np.float32)
    labels = port[2]["label"]
    e_ref = jbundle.per_pair_errors(jdb, labels, TCO_pred, TCO_gt)
    e_port = tbundle.per_pair_errors(tdb, labels, TCO_pred, TCO_gt)
    assert list(e_port) == list(e_ref)
    for k, v in e_ref.items():
        assert abs(e_port[k] - v) <= 1e-12 * max(abs(v), 1e-30), k


def saved_detections(tds, seed=0):
    """Every GT object of the fixture as a saved detection: its box, its pose
    moved by a few millimetres and degrees, scores of one decimal."""
    rng = np.random.RandomState(seed)
    rows, boxes, poses = [], [], []
    for i in range(len(tds)):
        obs = tds[i][2]
        f = obs["frame_info"]
        TCW = np.linalg.inv(obs["camera"]["TWC"])
        for o in obs["objects"]:
            rows.append(dict(scene_id=f["scene_id"], view_id=f["view_id"], label=o["label"],
                             score=float(np.round(rng.rand(), 1))))
            boxes.append(o["bbox"])
            poses.append(TCW @ o["TWO"])
    poses = add_pose_noise(torch.as_tensor(np.stack(poses), dtype=torch.float32),
                           torch.Generator().manual_seed(seed), euler_deg_std=(2, 2, 2),
                           trans_std=(0.002, 0.002, 0.005)).numpy()
    return pd.DataFrame(rows), np.stack(boxes).astype(np.float32), poses


def test_multiview_runner_and_evaluation_match_jax(bop, weights):
    _, jds, tds, jdb, tdb = bop
    jpp, v, pp = weights
    df, boxes, poses = saved_detections(tds)
    kinds = {"pose": {}, "tco": dict(use_detections_TCO=True)}

    jmodel = JLoadedPoseModel(jpp, v, jdb, init_method="v0")
    jpred = JCoarseRefine(jmodel, jmodel, bsz_objects=BSZ)
    jdets = PandasTensorCollection(df, bboxes=jnp.asarray(boxes), poses=jnp.asarray(poses))
    jmeters = {"ADD": jm.PoseErrorMeter(jdb, error_type="ADD", report_error_AUC=True,
                                        report_AP=True, report_error_stats=True)}
    ref = j_run_pred_eval(JRunner(JMultiViewWrapper(jds, n_views=3), 1, 1),
                          {k: dict(pose_predictor=jpred, detections=jdets, **kw)
                           for k, kw in kinds.items()},
                          JPoseEvaluation(jds, jmeters))

    model = LoadedPoseModel(pp, tdb, device="cpu")
    pred = CoarseRefinePosePredictor(model, model, bsz_objects=BSZ, device="cpu")
    dets = TensorCollection({k: df[k].values for k in df.columns}, bboxes=torch.as_tensor(boxes),
                            poses=torch.as_tensor(poses))
    meters = {"ADD": tm.PoseErrorMeter(tdb, error_type="ADD", report_error_AUC=True,
                                       report_AP=True, report_error_stats=True)}
    runner = MultiviewPredictionRunner(MultiViewWrapper(tds, n_views=3), 1, 1)
    port = run_pred_eval(runner, {k: dict(pose_predictor=pred, detections=dets, **kw)
                                  for k, kw in kinds.items()}, PoseEvaluation(tds, meters))

    assert list(port["predictions"]) == list(ref["predictions"]) == [
        "pose/coarse/iteration=1", "pose/refiner/iteration=1", "tco/external_coarse",
        "tco/refiner/iteration=1"]
    for key, r in ref["predictions"].items():
        p = port["predictions"][key]
        for col in ("scene_id", "view_id", "label", "score", "batch_im_id", "group_id"):
            assert p.infos[col].tolist() == r.infos[col].tolist(), (key, col)
        _close(p.poses, r.poses, key)

    # the JAX package's predictions through both evaluations: the same summaries
    for key in ("tco/refiner/iteration=1", "pose/refiner/iteration=1"):
        r = ref["predictions"][key]
        same = TensorCollection({k: r.infos[k].values for k in r.infos.columns},
                                poses=torch.as_tensor(np.array(r.poses)))
        got, _ = PoseEvaluation(tds, meters).evaluate(same)
        _compare_summaries(ref["metrics"][key]["ADD"], got["ADD"], 1e-6)
    near = ref["metrics"]["tco/refiner/iteration=1"]["ADD"]
    assert near["n_matched"] >= 3 and near["n_gt"] == 6
    # and the port's own: the same counts
    for key, r in ref["metrics"].items():
        for k in ("n_gt", "n_gt_valid", "n_pred", "n_matched"):
            assert port["metrics"][key]["ADD"][k] == r["ADD"][k], (key, k)
    assert port["summary_txt"].count("\n") == ref["summary_txt"].count("\n")
    # the runner with a multiview predictor: tests/test_torch_port_multiview_cli.py


def test_detection_evaluation_matches_jax(bop):
    _, jds, tds, _, _ = bop
    df, boxes, _ = saved_detections(tds, seed=1)
    boxes = boxes + np.random.RandomState(1).randint(-3, 4, boxes.shape).astype(np.float32)
    ref, _ = JDetectionEvaluation(jds, {"det": jm.DetectionMeter()}).evaluate(
        PandasTensorCollection(df, bboxes=jnp.asarray(boxes)))
    port, _ = DetectionEvaluation(tds, {"det": tm.DetectionMeter()}).evaluate(
        TensorCollection({k: df[k].values for k in df.columns}, bboxes=torch.as_tensor(boxes)))
    assert list(port["det"]) == list(ref["det"]) and ref["det"]["recall"] > 0
    for k, val in ref["det"].items():
        assert abs(port["det"][k] - val) <= 1e-9, k


def bundle_cfg(n_iterations=1, resize=(96, 128)):
    """The port's RunConfig of the slice's small predictor, refiner-style."""
    tcfg = tpt.PoseTrainConfig(predictor=port_cfg(), n_iterations=n_iterations,
                               n_points_loss=100, input_generator="gt+noise", batch_size=2,
                               epoch_size=4, n_epochs=1, n_epochs_warmup=1)
    return RunConfig(run_id="tiny-bundle", train=tcfg, n_dataloader_workers=0,
                     test_epoch_interval=1, input_resize=resize)


def test_eval_callback_matches_jax_and_leaves_the_state(bop, weights, monkeypatch):
    """Both packages' callbacks from the same TCO_init (the noise is each
    package's own: the port draws from a torch.Generator) and weights."""
    _, jds, tds, jdb, tdb = bop
    jpp, v, pp = weights
    cfg = bundle_cfg()
    TCO_gt = tbundle.collect_gt(tds, 3, with_images=False)[3]
    TCO_init = add_pose_noise(torch.as_tensor(TCO_gt), torch.Generator().manual_seed(7),
                              euler_deg_std=(5, 5, 5), trans_std=(0.005, 0.005, 0.01)).numpy()
    monkeypatch.setattr(jtransforms, "add_pose_noise", lambda key, T, **kw: jnp.asarray(TCO_init))
    monkeypatch.setattr(tbundle, "add_pose_noise", lambda T, gen, **kw: torch.as_tensor(TCO_init))
    jcfg = types.SimpleNamespace(train=cfg.train, input_resize=cfg.input_resize)
    ref = jbundle.make_eval_bundle(jcfg, jpp, jdb, jds, n_frames=3)(
        types.SimpleNamespace(params=v["params"], batch_stats=v["batch_stats"]), 0)

    state = tpt.create_train_state(cfg.train, "cpu")
    load_jax_train_state(state, v["params"], v["batch_stats"])
    state.pp.net.train()
    before = {k: t.clone() for k, t in state.pp.net.state_dict().items()}
    port = tbundle.make_eval_bundle(cfg, tdb, tds, n_frames=3, device="cpu")(state, 0)
    assert state.pp.net.training
    after = state.pp.net.state_dict()
    assert before.keys() == after.keys()
    assert all(torch.equal(before[k], after[k]) for k in before)

    assert list(port) == list(ref) and "iter=1/ADD_median" in port
    for k, val in ref.items():
        if k.startswith("init/"):
            tol = 1e-12 * abs(val)
        elif "frac" in k:
            tol = 0.0
        else:
            tol = 1e-2 if "deg" in k else ATOL
        assert abs(port[k] - val) <= tol, (k, port[k], val)
    assert port["iter=1/ADD_median"] != port["init/ADD_median"]


@pytest.fixture(scope="module")
def cube_root(tmp_path_factory):
    """<root>/synt_datasets/cubes: 3 chunks of 3 frames the port records on
    the CPU (2 train chunks, 1 val chunk)."""
    root = tmp_path_factory.mktemp("cubes")
    sampler = RecordingSceneSampler(
        build_mesh_db(port_specs(), device="cpu"), resolution=(96, 128),
        n_objects_interval=(2, 5), min_visible_pixels=10, border_check=False,
        camera_distance_interval=(0.5, 0.9), n_views_per_scene=3)
    record_dataset(sampler, root / "synt_datasets" / "cubes", n_chunks=3, n_frames_per_chunk=3,
                   train_fraction=0.7)
    return root


class CubeObjects:
    """The object set the cubes were recorded from, by the registry's interface."""

    def mesh_specs(self):
        return port_specs()


def tiny_run_cfg(name, debug=False):
    cfg = bundle_cfg(n_iterations=2)
    return dataclasses.replace(cfg, run_id="tiny-procedural", object_ds_name="procedural",
                               train_ds_names=(("synthetic.cubes.train", 1),),
                               val_ds_names=(("synthetic.cubes.val", 1),))


def test_training_and_accuracy_clis_on_recorded_cubes(cube_root, tmp_path, monkeypatch):
    for cli in (train_cli, acc_cli):
        monkeypatch.setattr(cli, "make_cfg", tiny_run_cfg)
        monkeypatch.setattr(cli, "make_object_dataset", lambda name, ds_root=None: CubeObjects())
    state, run_dir = train_cli.main(["--config", "tiny", "--ds-root", str(cube_root),
                                     "--exp-dir", str(tmp_path), "--n-epochs", "2",
                                     "--device", "cpu"])
    assert state.step == 4 and state.pp.net.training
    log = [json.loads(line) for line in (run_dir / "log.txt").read_text().splitlines()]
    tests = [r for r in log if "test/init/ADD_median" in r]
    assert len(tests) == 2 and all(np.isfinite(r["test/iter=2/ADD_median"]) for r in tests)
    assert tests[0]["test/init/ADD_median"] == tests[1]["test/init/ADD_median"]

    common = ["--run-id", "tiny-procedural", "--config", "tiny", "--ds-root", str(cube_root),
              "--exp-dir", str(tmp_path), "--n-frames", "3", "--n-iterations", "2",
              "--device", "cpu"]
    for init in ("gt+noise", "box"):
        out = tmp_path / f"accuracy-{init}.json"
        res = acc_cli.main(common + ["--init", init, "--out", str(out)])
        saved = json.loads(out.read_text())
        assert saved["n_frames"] == 3 and saved["n_objects"] == len(res["TCO_init"]) >= 6
        assert list(saved["per_pair"]) == ["init", "iteration=1", "iteration=2"]
        assert all(np.isfinite(e["ADD_median"]) for e in saved["per_pair"].values())
        assert set(saved["matched_auc"]) == {"init", "refined"}
        assert saved["matched_auc"]["init"]["n_gt"] == saved["n_objects"]
    # the overlays: input | init | refined panels of the first pairs, as PNGs
    res = acc_cli.main(common + ["--save-overlays", str(tmp_path / "overlays"),
                                 "--n-overlays", "2", "--out", str(tmp_path / "overlays.json")])
    assert [p.name for p in res["overlays"]] == ["refinement_00.png", "refinement_01.png"]
    for path in res["overlays"]:
        panel = png.imread(path)
        assert panel.dtype == np.uint8 and panel.ndim == 3 and panel.shape[2] == 3
        assert panel.shape[1] == 3 * (panel.shape[1] // 3) and panel.std() > 0
