"""Port parity for the detection path end to end, JAX package vs port on the
CPU: DetectionRunner and BopPredictionRunner (detector → refiner from the
detections' z-up auto-depth boxes) on cubes the port records at 96x128, and
the CLIs run_detector_training, run_detection_eval and run_bop_inference
--dataset procedural on the same frames, with make_cfg and the object set
monkeypatched to small ones.

Weights: the detector is the JAX package's WideResNet-18 CenterNet init with
random BatchNorm statistics and a heatmap bias near 0 (so that random
weights detect), carried to the port by utils/weights.py; the refiner is
tests/test_torch_port_slice.make_weights (EfficientNet-B0, 48x64 renders).
Tolerances: detections equal as lists (labels, ids, order) with boxes within
atol 1e-4 px and scores within 1e-6 (head outputs within 1e-4, see
tests/test_torch_port_detector.py); poses within the slice tests' atol
1e-4 + rtol 1e-6, except at most one of the 48, within 1e-3: measured, one
pose lies 4.0e-4 m from the JAX package's, and lies as far when the JAX
package's own boxes are fed to the port's pose stage (a discontinuity there,
such as ROADMAP §3's edges through pixel centres; the port gives the same
pose with 1 and 8 CPU threads). The width/height head's bias gives boxes of
the cubes' size: with the random head's near-zero widths, the 1-px boxes put the
auto-depth init ~31 m away, where a 1-px object's render and crop are so ill
conditioned that the same boxes give poses 5e-4 apart in either package's
float32 (measured). The CSV's header and row count exact.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosypose_tpu.data.datasets_cfg import make_scene_dataset as j_make_scene_dataset
from cosypose_tpu.data.wrappers import MultiViewWrapper as JMultiViewWrapper
from cosypose_tpu.evaluation.pred_runners import BopPredictionRunner as JBopRunner
from cosypose_tpu.evaluation.pred_runners import DetectionRunner as JDetectionRunner
from cosypose_tpu.integrated import CoarseRefinePosePredictor as JCoarseRefine
from cosypose_tpu.integrated import LoadedPoseModel as JLoadedPoseModel
from cosypose_tpu.integrated.detector import Detector as JDetector
from cosypose_tpu.models import detector as jdet
from cosypose_tpu.ops.mesh_db import build_mesh_db as j_build_mesh_db
from cosypose_tpu_torch.data.datasets_cfg import make_scene_dataset
from cosypose_tpu_torch.data.wrappers import MultiViewWrapper
from cosypose_tpu_torch.evaluation.pred_runners import BopPredictionRunner, DetectionRunner
from cosypose_tpu_torch.integrated.detector import Detector
from cosypose_tpu_torch.integrated.pose_predictor import CoarseRefinePosePredictor, LoadedPoseModel
from cosypose_tpu_torch.models import detector as tdet
from cosypose_tpu_torch.ops.mesh_db import build_mesh_db
from cosypose_tpu_torch.scripts import run_bop_inference as bop_cli
from cosypose_tpu_torch.scripts import run_detection_eval as det_eval_cli
from cosypose_tpu_torch.scripts import run_detector_training as det_train_cli
from cosypose_tpu_torch.training import detector_training as tdt
from cosypose_tpu_torch.training import pose_training as tpt
from cosypose_tpu_torch.training.checkpoint import save_checkpoint, save_config
from cosypose_tpu_torch.utils.weights import jax_detector_variables_to_state_dict
from tests.test_pose_predictor import cube_specs
from tests.test_torch_port_backbones import randomize
from tests.test_torch_port_eval_pipeline import bundle_cfg, cube_root  # noqa: F401 (fixture)
from tests.test_torch_port_slice import ATOL, RTOL, make_weights, port_specs

LABELS = {"obj_000001": 0, "obj_000002": 1}
BSZ = 8
MAX_POSES_BEYOND = 1   # of 48: a pose at a discontinuity of the pose stage (docstring)
ATOL_EDGE = 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def detectors():
    cfg = dict(n_classes=len(LABELS), max_detections=8)
    jm = jdet.CenterNetDetector(jdet.DetectorConfig(**cfg))
    v = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 96, 128, 3)), train=False)
    v = jax.tree_util.tree_map(np.array, dict(v))
    v = {"params": v["params"], "batch_stats": v["batch_stats"]}
    rng = np.random.RandomState(0)
    randomize(v["params"], rng)
    randomize(v["batch_stats"], rng)
    v["params"]["head"]["heatmap_out"]["bias"][:] = 0.5
    v["params"]["head"]["wh_out"]["bias"][:] = 6.0  # boxes of ~24 px: the cubes' size
    port = tdet.CenterNetDetector(tdet.DetectorConfig(**cfg))
    port.load_state_dict(jax_detector_variables_to_state_dict(v))
    return JDetector(jm, v, LABELS), Detector(port, LABELS), port


def same_detections(port, ref, cols):
    assert len(port) == len(ref) > 0
    for c in cols:
        assert port.infos[c].tolist() == ref.infos[c].tolist(), c
    np.testing.assert_allclose(port.infos["score"], ref.infos["score"].values, atol=1e-6)
    if "bboxes" in port.tensors:
        np.testing.assert_allclose(port.bboxes.numpy(), np.asarray(ref.bboxes), atol=ATOL)


def test_detection_runner_matches_jax(cube_root, detectors):
    jd, td, _ = detectors
    jds = j_make_scene_dataset("synthetic.cubes.train", ds_root=cube_root)
    tds = make_scene_dataset("synthetic.cubes.train", ds_root=cube_root)
    ref = JDetectionRunner(jds, batch_size=4).get_predictions(jd, detection_th=0.1)
    got = DetectionRunner(tds, batch_size=4).get_predictions(td, detection_th=0.1)
    same_detections(got["detections"], ref["detections"],
                    ("scene_id", "view_id", "label", "batch_im_id"))


def test_bop_prediction_runner_matches_jax(cube_root, detectors):
    jd, td, _ = detectors
    jpp, v, pp = make_weights()
    jdb = j_build_mesh_db(cube_specs())
    tdb = build_mesh_db(port_specs(), device="cpu")
    jref = JCoarseRefine(None, JLoadedPoseModel(jpp, v, jdb, init_method="z-up+auto-depth"),
                         bsz_objects=BSZ)
    tref = CoarseRefinePosePredictor(
        None, LoadedPoseModel(pp, tdb, init_method="z-up+auto-depth", device="cpu"),
        bsz_objects=BSZ, device="cpu")
    jds = JMultiViewWrapper(j_make_scene_dataset("synthetic.cubes.train", ds_root=cube_root), 2)
    tds = MultiViewWrapper(make_scene_dataset("synthetic.cubes.train", ds_root=cube_root), 2)
    kw = dict(detection_th=0.1, window_groups=2)
    cols = ("scene_id", "view_id", "group_id", "label", "batch_im_id")
    ref = JBopRunner(jds, 0, 2, det_batch_size=4).get_predictions(jd, jref, **kw)["pose"]
    got = BopPredictionRunner(tds, 0, 2, det_batch_size=4).get_predictions(td, tref,
                                                                           **kw)["pose"]
    same_detections(got, ref, cols)
    assert np.median(np.asarray(ref.poses)[:, 2, 3]) < 3.0
    a, b = got.poses.numpy(), np.asarray(ref.poses)
    beyond = ~np.isclose(a, b, atol=ATOL, rtol=RTOL).reshape(len(a), -1).all(axis=1)
    assert beyond.sum() <= MAX_POSES_BEYOND and np.abs(a - b).max() <= ATOL_EDGE
    t = got.infos["time"]
    assert np.isnan(t).any() and np.isfinite(t).any() and (t[np.isfinite(t)] > 0).all()


class CubeObjects:
    """The recorded cubes' object set, by the registry's interface."""

    labels = list(LABELS)

    def mesh_specs(self):
        return port_specs()


def tiny_detector_cfg(name, debug=False):
    train = tdt.DetectorTrainConfig(detector=tdet.DetectorConfig(max_detections=8), batch_size=2,
                                    epoch_size=4, n_epochs=2, n_epochs_warmup=1,
                                    mask_pos_weight=2.0)
    return det_train_cli.DetectorRunConfig(f"{name}-debug" if debug else name, train,
                                           ("synthetic.cubes.train",), "procedural", (96, 128),
                                           n_dataloader_workers=0)


@pytest.fixture(scope="module")
def trained_runs(cube_root, tmp_path_factory):
    """A detector run trained by the CLI (--debug) and a refiner run written
    from a fresh train state, in one experiments directory."""
    exp = tmp_path_factory.mktemp("exp")
    mp = pytest.MonkeyPatch()
    mp.setattr(det_train_cli, "make_cfg", tiny_detector_cfg)
    for cli in (det_train_cli, det_eval_cli, bop_cli):
        mp.setattr(cli, "make_object_dataset", lambda name, ds_root=None: CubeObjects())
    state, run_dir = det_train_cli.main(["--config", "detector-tiny", "--debug", "--ds-root",
                                         str(cube_root), "--exp-dir", str(exp),
                                         "--device", "cpu"])
    cfg = dataclasses.replace(bundle_cfg(n_iterations=2), run_id="tiny-refiner")
    ref_state = tpt.create_train_state(cfg.train, "cpu")
    save_config(exp / cfg.run_id, cfg)
    save_checkpoint(exp / cfg.run_id, ref_state, 0)
    yield exp, state, run_dir
    mp.undo()


def test_detector_training_cli_debug(trained_runs):
    _, state, run_dir = trained_runs
    assert run_dir.name == "detector-tiny-debug" and state.step == 4
    log = [json.loads(line) for line in (run_dir / "log.txt").read_text().splitlines()]
    assert len(log) == 2 and all(np.isfinite(r["train/loss_total"]) for r in log)
    assert {"train/loss_heatmap", "train/loss_mask", "train/grad_norm",
            "train/data_s_per_step"} <= set(log[-1])
    saved = json.loads((run_dir / "config.yaml").read_text())
    assert saved["detector"]["n_classes"] == 2 and saved["mask_pos_weight"] == 2.0
    assert sorted(p.name for p in (run_dir / "checkpoint").iterdir()) == [
        "epoch_00000.pt", "epoch_00001.pt"]


def test_detector_training_resume_and_pretrain(trained_runs, cube_root):
    exp, _, run_dir = trained_runs
    args = ["--config", "detector-tiny", "--ds-root", str(cube_root), "--exp-dir", str(exp),
            "--device", "cpu"]
    mp = pytest.MonkeyPatch()
    mp.setattr(det_train_cli, "make_cfg", lambda name, debug=False: dataclasses.replace(
        tiny_detector_cfg(name), train=dataclasses.replace(tiny_detector_cfg(name).train,
                                                           n_epochs=3)))
    try:
        state, _ = det_train_cli.main(args + ["--pretrain-run-id", run_dir.name])
        assert state.step == 6
        resumed, _ = det_train_cli.main(args + ["--resume"])
        assert resumed.step == 6  # all three epochs were done: nothing left
    finally:
        mp.undo()


def test_detection_eval_cli(trained_runs, cube_root, tmp_path):
    exp, _, run_dir = trained_runs
    out = tmp_path / "det.json"
    res = det_eval_cli.main(["--dataset", "synthetic.cubes.val", "--detector", run_dir.name,
                             "--object-ds", "procedural", "--masks", "--ds-root", str(cube_root),
                             "--exp-dir", str(exp), "--out", str(out), "--device", "cpu"])
    saved = json.loads(out.read_text())
    assert set(saved["metrics"]) == {"bbox@0.5", "mask@0.5"} and saved["n_frames"] == 3
    assert res["predictions"].masks.shape[1:] == (96, 128)


def test_bop_inference_cli_procedural(trained_runs, cube_root, tmp_path):
    exp, _, run_dir = trained_runs
    common = ["--dataset", "procedural", "--inference-ds", "synthetic.cubes.val",
              "--detector", run_dir.name, "--refiner", "tiny-refiner", "--detection-th", "0.0",
              "--ds-root", str(cube_root), "--exp-dir", str(exp), "--out-dir", str(tmp_path),
              "--device", "cpu"]
    res = bop_cli.main(common + ["--n-refiner", "2"])
    preds = res["predictions"]["pose"]
    csv = res["csv_paths"]["pose"].read_text().splitlines()
    assert csv[0] == "scene_id,im_id,obj_id,score,R,t,time" and len(csv) == len(preds) + 1 > 1
    assert torch.isfinite(preds.poses).all()
    m = json.loads((tmp_path / "metrics-synthetic_cubes_val-c1r2.json").read_text())
    assert m["refiner"] == "tiny-refiner" and m["n_frames"] == 3
    assert set(m["metrics"]) == {"pose", "bop19_ar"}
    assert 0.0 <= m["metrics"]["bop19_ar"]["AR"] <= 1.0 and m["metrics"]["pose"]["n_gt"] > 0
    # --icp (tests/test_torch_port_multiview_cli.py runs it with --nviews 2 against the JAX CLI)
    res = bop_cli.main(common + ["--n-refiner", "2", "--icp"])
    assert set(res["predictions"]) == {"pose", "icp"} == set(res["csv_paths"])
    assert len(res["predictions"]["icp"]) == len(res["predictions"]["pose"])
    m = json.loads((tmp_path / "metrics-synthetic_cubes_val-icp-c1r2.json").read_text())
    assert m["metrics"]["bop19_ar"]["prediction_key"] == "icp" and res["seconds"]["icp"] > 0


def test_reference_checkpoint_loads_into_the_port(tmp_path):
    """A reference-format checkpoint (DDP prefixes, a key the PoseNet lacks)
    gives the port's PoseNet its tensors; one that lacks a tensor raises."""
    from cosypose_tpu_torch.models.pose_predictor import PosePredictor, PosePredictorConfig

    src = PosePredictor(PosePredictorConfig(), device="cpu",
                        generator=torch.Generator().manual_seed(5)).net.state_dict()
    sd = {f"module.{k}": v for k, v in src.items()}
    sd["module.views_logits_head.weight"] = torch.zeros(3)
    torch.save({"state_dict": sd, "epoch": 7}, tmp_path / "checkpoint.pth.tar")
    db = build_mesh_db(port_specs(), device="cpu")
    model = bop_cli.load_reference_torch_checkpoint(tmp_path / "checkpoint.pth.tar", db,
                                                    device="cpu")
    got = model.predictor.net.state_dict()
    assert all(torch.equal(got[k], src[k]) for k in src)
    assert model.init_method == "v0"
    del sd["module.pose_fc.bias"]
    torch.save({"state_dict": sd}, tmp_path / "bad.pth.tar")
    with pytest.raises(KeyError, match="pose_fc.bias"):
        bop_cli.load_reference_torch_checkpoint(tmp_path / "bad.pth.tar", db, device="cpu")
