"""The port's Mask R-CNN R50-FPN (models/mask_rcnn.py, ops/boxes.py,
ops/nms_cuda.py, the multi-level RoIAlign of ops/roi_align.py) against its
plain reference, tests/torch_reference/maskrcnn.py, in float32 on the CPU.

The JAX package has no Mask R-CNN (it replaced it by a CenterNet), so the
plain reference is the oracle. Size: the published widths (ResNet-50, FPN
256, MLP 1,024, mask head 256) on two 96x128 frames, top 200 anchors a
level, 100 proposals an image, 5 classes; seeded weights set up by the
reference's `seeded_weights` on the frames.

Each stage starts from the program's own input to it, as the benchmark's
check does. Tolerances: features, RPN outputs, box-head and mask logits
within 1e-4 of the largest value (float32 sums in another order); proposals
and detections EQUAL (both sides run the same float32 elementwise
operations, and NMS breaks ties by index on both); pasted masks equal at
0.5 (the resize's weights summed in another order move a probability by
~1e-6). End to end (each side from its own previous stage), the
Detector's detections equal the reference's as sets, boxes within 1e-2 px,
scores within 1e-4, masks at 0.5 in all but 0.1 % of the pixels.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from cosypose_tpu_torch.evaluation.pred_runners import DetectionRunner
from cosypose_tpu_torch.integrated.detector import Detector
from cosypose_tpu_torch.models.mask_rcnn import MaskRCNN, MaskRCNNConfig, maskrcnn_category_ids
from cosypose_tpu_torch.ops import boxes as box_ops
from cosypose_tpu_torch.ops import nms_cuda, nvcc_build
from cosypose_tpu_torch.utils import profiling


def _reference():
    """tests/torch_reference/maskrcnn.py, loaded by its path (a `tests`
    package installed elsewhere may shadow this directory's)."""
    path = pathlib.Path(__file__).with_name("torch_reference") / "maskrcnn.py"
    spec = importlib.util.spec_from_file_location("torch_reference_maskrcnn", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


ref = _reference()
N_CLASSES = 5
HW = (96, 128)
S = dict(ref.SETTINGS, min_size=96, max_size=128, rpn_pre_nms_top_n=200,
         rpn_post_nms_top_n=100, n_classes=N_CLASSES)
CFG = MaskRCNNConfig(n_classes=N_CLASSES, input_resize=HW, rpn_pre_nms_top_n=200,
                     rpn_post_nms_top_n=100)
REL = 1e-4
REPO = pathlib.Path(__file__).resolve().parents[1]


def rel(a, b) -> float:
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


@pytest.fixture(scope="module")
def run():
    torch.set_num_threads(4)
    g = torch.Generator().manual_seed(21)
    images = torch.rand(2, 3, *HW, generator=g)
    p = ref.seeded_weights(N_CLASSES, g, images, S, detections_target=10)
    model = MaskRCNN(CFG).eval()
    model.load_state_dict(p)
    record = {}
    out = model(images, record=record)
    return dict(p=p, images=images, model=model, record=record, out=out,
                ref=ref.forward(p, images, S))


def by_image(t, ids, n=2):
    return [t[ids == b] for b in range(n)]


def stage_gap(run, stage):
    """(gap, limit) of one stage of the program against the reference run
    from the program's input to it."""
    p, rec, out = run["p"], run["record"], run["out"]
    hw, feats = rec["image_hw"], [f.float() for f in rec["features"]]
    eps = S["frozen_bn_eps"]
    if stage == "features":
        return max(rel(a, b) for a, b in zip(rec["features"], ref.features(p, rec["x"], eps))), REL
    if stage == "rpn_outputs":
        logits, deltas = ref.rpn_head(p, feats)
        return max(rel(a, b) for a, b in zip(rec["logits"] + rec["deltas"], logits + deltas)), REL
    if stage == "proposals":
        anc = ref.anchors([f.shape[-2:] for f in feats], rec["x"].shape[-2:], S["anchor_sizes"],
                          S["aspect_ratios"], "cpu")
        props = ref.filter_proposals([t.float() for t in rec["logits"]],
                                     [t.float() for t in rec["deltas"]], anc, hw, S)
        mine = by_image(rec["proposals"], rec["proposal_ids"])
        assert [len(b) for b, _ in props] == [len(b) for b in mine]
        return max(float((a - b).abs().max()) for (a, _), b in zip(props, mine)), 0.0
    proposals = by_image(rec["proposals"], rec["proposal_ids"])
    det = rec["detections"]
    if stage == "box_head":
        cls, box = ref.box_head(p, feats, proposals, hw)
        return max(rel(rec["class_logits"], cls), rel(rec["box_deltas"], box)), REL
    if stage == "detections":
        dets = ref.postprocess(rec["class_logits"], rec["box_deltas"], proposals, hw, S)
        mine = [[t[det["image_ids"] == b] for t in (det["boxes"], det["scores"], det["labels"])]
                for b in range(2)]
        assert [len(d[0]) for d in dets] == [len(m[0]) for m in mine]
        assert all(torch.equal(d[2], m[2]) for d, m in zip(dets, mine))
        return max(float((d[k] - m[k]).abs().max()) for d, m in zip(dets, mine)
                   for k in (0, 1)), 0.0
    if stage == "mask_logits":
        logits = ref.mask_head(p, feats, by_image(det["boxes"], det["image_ids"]), hw)
        return rel(rec["mask_logits"], logits), REL
    assert stage == "pasted_masks"
    pasted = ref.paste_masks(out["mask_probs"], out["boxes"], HW)
    return float(((pasted > 0.5) != (out["masks"] > 0.5)).float().mean()), 0.0


@pytest.mark.parametrize("stage", ["features", "rpn_outputs", "proposals", "box_head",
                                   "detections", "mask_logits", "pasted_masks"])
def test_stage_matches_the_reference_from_the_programs_input(run, stage):
    gap, limit = stage_gap(run, stage)
    assert gap <= limit, (stage, gap)


def test_the_frames_have_proposals_and_detections(run):
    rec = run["record"]
    assert len(rec["proposals"]) == 2 * S["rpn_post_nms_top_n"]
    n = np.bincount(rec["detections"]["image_ids"].numpy(), minlength=2)
    assert (n > 0).all() and (n <= S["box_detections_per_img"]).all()


def test_detector_api_matches_the_reference_end_to_end(run):
    labels = {f"obj_{k:06d}": k - 1 for k in range(1, N_CLASSES)}
    det = Detector(run["model"], maskrcnn_category_ids(labels))
    out = det.get_detections(run["images"] * 255.0, output_masks=True, mask_th=0.5)
    refd = run["ref"]["detections"]
    assert len(out) == sum(len(d[0]) for d in refd)
    ref_boxes = torch.cat([d[0] for d in refd])
    assert np.array_equal(out.infos["batch_im_id"],
                          np.repeat(np.arange(2), [len(d[0]) for d in refd]))
    assert list(out.infos["label"]) == [f"obj_{int(k):06d}" for k in torch.cat([d[2] for d in refd])]
    assert np.allclose(out.infos["score"], torch.cat([d[1] for d in refd]).numpy(), atol=1e-4)
    assert float((out.bboxes - ref_boxes).abs().max()) <= 1e-2
    ref_masks = torch.cat(run["ref"]["masks"]) > 0.5
    assert float((out.masks != ref_masks).float().mean()) <= 1e-3
    best = det.get_detections(run["images"], one_instance_per_class=True)
    assert len(set(best.infos["label"])) == len(best)
    none = det.get_detections(run["images"], detection_th=1.0)
    assert len(none) == 0 and none.bboxes.shape == (0, 4)


def seeded_boxes(rng, n, ties=True):
    xy = rng.uniform(0, 40, (n, 2))
    wh = rng.uniform(4, 20, (n, 2))
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    if ties:
        boxes[n // 2:n // 2 + 5] = boxes[0]                  # duplicates: IoU 1
        scores[n // 2:n // 2 + 5] = scores[0]                # and equal scores
        boxes[1] = [0, 0, 2, 1]                              # IoU exactly 0.5 with row 2
        boxes[2] = [0, 0, 1, 1]
        scores[3:9] = np.round(scores[3:9], 1)               # ties among distinct boxes
    return torch.as_tensor(boxes), torch.as_tensor(scores)


@pytest.mark.parametrize("n,n_groups,iou", [(300, 1, 0.5), (400, 5, 0.7), (257, 22, 0.5)])
def test_nms_plain_path_equals_the_textbook_greedy_loop(n, n_groups, iou):
    rng = np.random.RandomState(n)
    boxes, scores = seeded_boxes(rng, n)
    groups = torch.as_tensor(rng.randint(0, n_groups, n))
    valid = torch.as_tensor(rng.uniform(size=n) > 0.1)
    keep = nms_cuda.batched_nms(boxes, scores, groups, n_groups, iou, valid)
    idx = torch.nonzero(valid)[:, 0]
    want = idx[ref.batched_nms(boxes[idx], scores[idx], groups[idx], iou)]
    assert torch.equal(torch.nonzero(keep)[:, 0], torch.sort(want).values)
    # the operator's CPU kernel is the plain path
    order = torch.sort(groups, stable=True).indices
    offsets = torch.searchsorted(groups[order], torch.arange(n_groups + 1))
    assert torch.equal(torch.ops.cosypose.nms(boxes[order], offsets, None, iou),
                       nms_cuda.nms_plain(boxes[order], offsets, iou))


def test_iou_at_the_threshold_does_not_suppress():
    boxes = torch.tensor([[0, 0, 2, 1], [0, 0, 1, 1], [0, 0, 1.01, 1]], dtype=torch.float32)
    keep = nms_cuda.batched_nms(boxes, torch.tensor([3.0, 2.0, 1.0]), torch.zeros(3, dtype=torch.long),
                                1, 0.5)
    assert keep.tolist() == [True, True, False]


def test_paste_masks_equals_the_reference_at_edges():
    """Boxes across the image's edges, below a pixel and inverted."""
    rng = np.random.RandomState(4)
    probs = torch.as_tensor(rng.uniform(size=(6, 28, 28)).astype(np.float32))
    boxes = torch.tensor([[-10, -5, 40, 30], [100, 70, 140, 110], [5, 5, 5.4, 5.3],
                          [20, 30, 19, 29], [0, 0, 128, 96], [60.5, 10.2, 61.7, 90.9]])
    got = box_ops.paste_masks(probs, boxes, HW)
    want = ref.paste_masks(probs, boxes, HW)
    assert float((got - want).abs().max()) <= 1e-5


def test_spans_and_counters_of_a_traced_call(run):
    with profiling.tracing():
        run["model"](run["images"][:1])
    rec = profiling.collect()
    names = [s["name"] for s in rec["spans"]]
    for stage in ("backbone", "rpn", "box", "mask"):
        assert names.count(f"cosypose.detector.{stage}") == 1
    assert names.count("cosypose.detector.nms") == 2
    assert names[0] == "cosypose.detector.request"
    (counters,) = rec["counters"].values()
    assert counters["anchors"] == 3 * sum(
        (-(-96 // st)) * (-(-128 // st)) for st in (4, 8, 16, 32)) + 3 * 2 * 2
    assert counters["proposals"] == S["rpn_post_nms_top_n"]
    assert counters["detections"] == int((run["record"]["detections"]["image_ids"] == 0).sum())
    assert counters["nms_in"] > counters["proposals"] and "nms" not in counters  # no kernel here


def test_nms_library_is_built_at_its_own_first_call():
    assert "nms" in nvcc_build.SOURCES and "nms" not in nvcc_build.SERVING


def test_load_detector_builds_resnet50_fpn_and_detection_runner_runs_it(run, tmp_path):
    import json

    from cosypose_tpu_torch.scripts.run_bop_inference import load_detector

    run_dir = tmp_path / "detector-maskrcnn"
    (run_dir / "checkpoint").mkdir(parents=True)
    torch.save({"net": run["model"].state_dict()}, run_dir / "checkpoint" / "epoch_00001.pt")
    (run_dir / "config.yaml").write_text(json.dumps(dict(
        backbone_str="resnet50-fpn", input_resize=list(HW), rpn_pre_nms_top_n=200,
        rpn_post_nms_top_n=100)))
    labels = {f"obj_{k:06d}": k - 1 for k in range(1, N_CLASSES)}
    det = load_detector("detector-maskrcnn", labels, exp_dir=tmp_path, device="cpu")
    assert isinstance(det.model, MaskRCNN) and det.model.cfg.n_classes == N_CLASSES
    frames = [(run["images"][b].permute(1, 2, 0).mul(255).round().to(torch.uint8).numpy(), None,
               {"frame_info": {"scene_id": 1, "view_id": b}}) for b in range(2)]
    preds = DetectionRunner(frames, batch_size=2).get_predictions(det)["detections"]
    assert len(preds) > 0 and set(preds.infos["view_id"]) <= {0, 1}


def test_references_are_one_file_that_imports_nothing_of_the_program():
    text = (REPO / "tests" / "torch_reference" / "maskrcnn.py").read_text()
    assert text == (REPO / "benchmark" / "reference" / "maskrcnn.py").read_text()
    import ast

    imported = set()
    for node in ast.walk(ast.parse(text)):
        if isinstance(node, ast.Import):
            imported |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            imported.add((node.module or "").split(".")[0])
    assert imported <= {"__future__", "math", "torch"}, imported
    assert "allow_tf32 = False" in text


def test_bop_prediction_runner_takes_maskrcnn(run):
    """detector -> refiner through BopPredictionRunner, the Mask R-CNN's
    detections of class 1 (obj_000001, the demo sphere) posed by a B0
    refiner at 48x64 with random weights: the runner's rows are the
    detector's, with its frames' ids."""
    from cosypose_tpu_torch import demo
    from cosypose_tpu_torch.evaluation.pred_runners import BopPredictionRunner
    from cosypose_tpu_torch.integrated.pose_predictor import (CoarseRefinePosePredictor,
                                                              LoadedPoseModel)
    from cosypose_tpu_torch.models.pose_predictor import PosePredictor, PosePredictorConfig
    from cosypose_tpu_torch.ops.mesh_db import build_mesh_db

    det = Detector(run["model"], {"obj_000001": 1})
    db = build_mesh_db(demo.demo_specs()[:1], render_max_faces=64, device="cpu")
    pp = PosePredictor(PosePredictorConfig(backbone="efficientnet-b0", render_size=(48, 64),
                                           n_points_crop=200), device="cpu")
    server = CoarseRefinePosePredictor(
        None, LoadedPoseModel(pp, db, init_method="z-up+auto-depth", device="cpu"),
        bsz_objects=8, device="cpu")
    K = np.array([[150.0, 0, 64], [0, 150.0, 48], [0, 0, 1]], np.float32)
    rgb = run["images"].permute(0, 2, 3, 1).mul(255).round().to(torch.uint8).numpy()
    ds = [[(rgb[k], None, {"frame_info": {"scene_id": 1, "view_id": k, "group_id": k},
                           "camera": {"K": K}})] for k in range(2)]
    got = BopPredictionRunner(ds, 0, 1, det_batch_size=2).get_predictions(
        det, server, detection_th=0.0)["pose"]
    want = det.get_detections(run["images"], detection_th=0.0)
    assert len(got) == len(want) > 0
    assert list(got.infos["view_id"]) == list(want.infos["batch_im_id"])
    assert got.poses.shape == (len(want), 4, 4) and torch.isfinite(got.poses).all()
