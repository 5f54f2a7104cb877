"""Mask R-CNN's NMS kernel (csrc/nms.cu) against its plain version, and the
detector on the card against the plain reference and the benchmark
harness's wrappers.

Marked `gpu`; each test asks the `cuda` fixture for the card and skips where
there is none. Run them on a machine with a card:
`python -m pytest tests/test_torch_port_maskrcnn_gpu.py -m gpu`.

Tolerances: the kernel computes the plain version's IoU op for op in float32
(no FMA, IEEE division), so the kept rows are EQUAL. On the card the
program's stages, each from the program's input to it, equal the reference
run there where both run the same float32 elementwise operations
(proposals, detections), within 1e-4 of the largest value where sums run in
another order (float32 at 96x128); the port's spans and the harness's CUDA
events around the same calls agree within 5 %.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from cosypose_tpu_torch.models.mask_rcnn import MaskRCNN, MaskRCNNConfig
from cosypose_tpu_torch.ops import boxes as box_ops
from cosypose_tpu_torch.ops import nms_cuda
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
pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def rpn_like(sizes, seed):
    """Boxes as the RPN makes them: anchors of a level's size on its grid,
    moved by small deltas, clipped to 480x640; a few below the small-box
    limit (invalid); scores with ties."""
    g = torch.Generator().manual_seed(seed)
    out, scores, groups = [], [], []
    for k, n in enumerate(sizes):
        size = 32.0 * 2 ** (k % 5)
        ctr = torch.rand(n, 2, generator=g) * torch.tensor([640.0, 480.0])
        wh = size * torch.exp(0.3 * torch.randn(n, 2, generator=g))
        b = torch.cat([ctr - wh / 2, ctr + wh / 2], 1)
        out.append(box_ops.clip(b, (480, 640)))
        scores.append(torch.round(torch.rand(n, generator=g) * 64) / 64)  # ties
        groups.append(torch.full((n,), k))
    boxes = torch.cat(out)
    boxes[::97, 2] = boxes[::97, 0]  # zero width: invalid
    return boxes, torch.cat(scores), torch.cat(groups)


@pytest.mark.parametrize("sizes,iou", [((1000, 1000, 1000, 900, 240), 0.7),
                                       (tuple([46] * 21 + [34]), 0.5),
                                       ((4140,), 0.7), ((3000, 7, 0, 5000), 0.5)])
def test_nms_kernel_keeps_the_plain_versions_rows(cuda, sizes, iou):
    boxes, scores, groups = rpn_like(sizes, sum(sizes))
    valid = box_ops.not_small(boxes, 1e-3)
    G = len(sizes)
    before = nms_cuda.NMS_KERNEL.launches
    got = nms_cuda.batched_nms(boxes.to(cuda), scores.to(cuda), groups.to(cuda), G, iou,
                               valid.to(cuda))
    assert nms_cuda.NMS_KERNEL.launches == before + 1
    want = nms_cuda.batched_nms(boxes, scores, groups, G, iou, valid)
    assert torch.equal(got.cpu(), want)
    assert 0 < int(want.sum()) < int(valid.sum())


def test_nms_kernel_refuses_bad_inputs(cuda):
    b = torch.rand(8, 4, device=cuda)
    off = torch.tensor([0, 8], device=cuda)
    with pytest.raises(ValueError):
        nms_cuda.NMS_KERNEL(b.double(), off, 0.5)
    with pytest.raises(ValueError):
        nms_cuda.NMS_KERNEL(b, off.int(), 0.5)
    with pytest.raises(ValueError):
        nms_cuda.NMS_KERNEL(b, off, 0.5, torch.ones(7, dtype=torch.bool, device=cuda))


def test_nms_operator_opcheck_on_the_card(cuda):
    boxes, scores, groups = rpn_like((300, 200), 5)
    order = torch.sort(groups, stable=True).indices
    offsets = torch.tensor([0, 300, 500], device=cuda)
    torch.library.opcheck(torch.ops.cosypose.nms.default,
                          (boxes[order].to(cuda), offsets, None, 0.7))


def test_stages_on_the_card_equal_the_reference_from_the_programs_input(cuda):
    n_classes, hw = 5, (96, 128)
    s = dict(ref.SETTINGS, min_size=96, max_size=128, rpn_pre_nms_top_n=200,
             rpn_post_nms_top_n=100, n_classes=n_classes)
    g = torch.Generator(device=cuda).manual_seed(3)
    images = torch.rand(2, 3, *hw, generator=g, device=cuda)
    p = ref.seeded_weights(n_classes, g, images, s, detections_target=10)
    model = MaskRCNN(MaskRCNNConfig(n_classes=n_classes, input_resize=hw, rpn_pre_nms_top_n=200,
                                    rpn_post_nms_top_n=100)).to(cuda).eval()
    model.load_state_dict(p)
    rec = {}
    before = nms_cuda.NMS_KERNEL.launches
    out = model(images, record=rec)
    assert nms_cuda.NMS_KERNEL.launches == before + 2
    feats = [f.float() for f in rec["features"]]
    anc = ref.anchors([f.shape[-2:] for f in feats], rec["x"].shape[-2:], s["anchor_sizes"],
                      s["aspect_ratios"], cuda)
    props = ref.filter_proposals([t.float() for t in rec["logits"]],
                                 [t.float() for t in rec["deltas"]], anc, rec["image_hw"], s)
    assert torch.equal(torch.cat([b for b, _ in props]), rec["proposals"])
    ids = rec["proposal_ids"]
    plist = [rec["proposals"][ids == b] for b in range(2)]
    cls, box = ref.box_head(p, feats, plist, rec["image_hw"])
    for a, b in ((rec["class_logits"], cls), (rec["box_deltas"], box)):
        assert float((a - b).abs().max() / b.abs().max()) <= 1e-4
    dets = ref.postprocess(rec["class_logits"], rec["box_deltas"], plist, rec["image_hw"], s)
    d = rec["detections"]
    assert len(d["boxes"]) > 0
    assert torch.equal(torch.cat([x[0] for x in dets]), d["boxes"])
    assert torch.equal(torch.cat([x[1] for x in dets]), d["scores"])
    assert torch.equal(torch.cat([x[2] for x in dets]), d["labels"])
    pasted = ref.paste_masks(out["mask_probs"], out["boxes"], hw)
    assert float(((pasted > 0.5) != (out["masks"] > 0.5)).float().mean()) <= 1e-4


def test_detector_spans_agree_with_the_harness_wrappers(cuda):
    """At 480x640 in bf16 with 22 classes: the program's detector.backbone,
    rpn, box and mask spans against the benchmark harness's CUDA events
    around the same calls, mean device ms within 5 %."""
    from benchmark.harness.trace import Spans

    g = torch.Generator(device=cuda).manual_seed(7)
    images = torch.rand(1, 3, 480, 640, generator=g, device=cuda)
    p = ref.seeded_weights(22, g, images)
    model = MaskRCNN(MaskRCNNConfig(compute_dtype=torch.bfloat16)).to(cuda).eval()
    model.load_state_dict(p)
    for _ in range(3):
        model(images)
    outside = Spans("cuda")
    names = {"features": "backbone", "region_proposals": "rpn", "detect": "box",
             "segment": "mask"}
    for attr, name in names.items():
        outside.wrap(model, attr, name)
    profiling.collect()
    try:
        with profiling.tracing():
            for _ in range(5):
                model(images)
        rec = profiling.collect()
        harness = outside.ms()
    finally:
        outside.unwrap()
    for name in names.values():
        program = [(s["device_end_ns"] - s["device_start_ns"]) / 1e6 for s in rec["spans"]
                   if s["name"] == f"cosypose.detector.{name}"]
        assert len(program) == len(harness[name]) == 5
        assert abs(np.mean(program) - np.mean(harness[name])) <= 0.05 * np.mean(harness[name]), \
            (name, program, harness[name])


def test_bop_prediction_runner_runs_maskrcnn_at_full_size_on_the_card(cuda):
    """BopPredictionRunner with the published Mask R-CNN (22 classes, 480x640,
    1,000 proposals, up to 100 detections, bf16) on two frames: its
    detections of the two classes it finds most often, labelled as the two
    demo objects, posed by a B0 refiner."""
    from cosypose_tpu_torch import demo
    from cosypose_tpu_torch.evaluation.pred_runners import BopPredictionRunner
    from cosypose_tpu_torch.integrated.detector import Detector
    from cosypose_tpu_torch.integrated.pose_predictor import (CoarseRefinePosePredictor,
                                                              LoadedPoseModel)
    from cosypose_tpu_torch.models.pose_predictor import PosePredictor, PosePredictorConfig
    from cosypose_tpu_torch.ops.mesh_db import build_mesh_db

    g = torch.Generator(device=cuda).manual_seed(11)
    frames = torch.rand(2, 3, 480, 640, generator=g, device=cuda)
    p = ref.seeded_weights(22, g, frames)
    model = MaskRCNN(MaskRCNNConfig(compute_dtype=torch.bfloat16)).to(cuda).eval()
    model.load_state_dict(p)
    found = torch.bincount(model(frames, masks=False)["labels"], minlength=22)
    first, second = torch.argsort(found, descending=True, stable=True)[:2].tolist()
    det = Detector(model, {"obj_000001": first, "obj_000002": second})
    db = build_mesh_db(demo.demo_specs(), render_max_faces=512, device=cuda)
    pp = PosePredictor(PosePredictorConfig(backbone="efficientnet-b0", render_size=(120, 160)),
                       device=cuda)
    server = CoarseRefinePosePredictor(
        None, LoadedPoseModel(pp, db, init_method="z-up+auto-depth", device=cuda), device=cuda)
    K = np.array([[1066.778, 0, 312.9869], [0, 1067.487, 241.3109], [0, 0, 1]], np.float32)
    rgb = frames.permute(0, 2, 3, 1).mul(255).round().to(torch.uint8).cpu().numpy()
    ds = [[(rgb[k], None, {"frame_info": {"scene_id": 1, "view_id": k, "group_id": k},
                           "camera": {"K": K}})] for k in range(2)]
    before = nms_cuda.NMS_KERNEL.launches
    got = BopPredictionRunner(ds, 0, 2, det_batch_size=2).get_predictions(
        det, server, detection_th=0.0)["pose"]
    assert nms_cuda.NMS_KERNEL.launches == before + 2  # one batch of 2 frames
    want = det.get_detections(torch.as_tensor(rgb, device=cuda).permute(0, 3, 1, 2),
                              detection_th=0.0)
    assert len(got) == len(want) > 0
    assert list(got.infos["view_id"]) == list(want.infos["batch_im_id"])
    assert torch.isfinite(got.poses).all()
