"""The program's spans and counters (utils/profiling.py) on the serving path:
off, they record nothing and enter nothing; on, two small requests through
CoarseRefinePosePredictor.get_predictions (EfficientNet-B0, 48x64 renders,
the demo spheres, chunks of 2 rows, on the CPU) give one tree of spans a
request with the counters of its rows; a torch.profiler trace holds the
program's ranges; the serving export traces the same graph with tracing on.

The tests marked `gpu` hold the sync counter and the device times on a card:
`python -m pytest tests/test_torch_port_tracing.py -m gpu`.
"""

import json
import warnings

import numpy as np
import pytest
import torch

from cosypose_tpu_torch import demo
from cosypose_tpu_torch.integrated.pose_predictor import CoarseRefinePosePredictor, LoadedPoseModel
from cosypose_tpu_torch.models.efficientnet import STAGE_SPANS
from cosypose_tpu_torch.models.pose_predictor import PosePredictor, PosePredictorConfig
from cosypose_tpu_torch.ops.mesh_db import build_mesh_db
from cosypose_tpu_torch.serving.export import ServedPoseModel
from cosypose_tpu_torch.utils import profiling
from cosypose_tpu_torch.utils.tensor_collection import TensorCollection

CFG = PosePredictorConfig(backbone="efficientnet-b0", render_size=(48, 64), n_points_crop=64)
BSZ, COARSE, REFINER = 2, 1, 2
LABELS = ["obj_000001", "obj_000002", "obj_000001"]
BOXES = [[40.0, 30, 80, 70], [50, 20, 90, 60], [30, 30, 60, 60]]
ITERATION_PARTS = ["cosypose.model.crop", "cosypose.model.render", "cosypose.model.backbone",
                   "cosypose.model.update"]
BACKBONE_PARTS = ["cosypose.backbone.stem", *STAGE_SPANS, "cosypose.backbone.head"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_server(device):
    db = build_mesh_db(demo.demo_specs(), render_max_faces=64, device=device)
    models = [LoadedPoseModel(PosePredictor(CFG, device=device,
                                            generator=torch.Generator().manual_seed(seed)),
                              db, device=device) for seed in (0, 1)]
    return CoarseRefinePosePredictor(*models, bsz_objects=BSZ, device=device)


def send(server, n_dets=3):
    dev = server.device
    dets = TensorCollection(dict(batch_im_id=np.zeros(n_dets, np.int64), label=LABELS[:n_dets]),
                            bboxes=torch.as_tensor(BOXES[:n_dets], device=dev))
    K = torch.tensor([[[150.0, 0, 64], [0, 150.0, 48], [0, 0, 1]]], device=dev)
    return server.get_predictions(torch.rand(1, 3, 96, 128, generator=torch.Generator()
                                             .manual_seed(n_dets)).to(dev), K, detections=dets,
                                  n_coarse_iterations=COARSE, n_refiner_iterations=REFINER)


@pytest.fixture(scope="module")
def server():
    return make_server("cpu")


@pytest.fixture(scope="module")
def traced(server):
    """Two requests (3 and 1 detections) under tracing(), and their records."""
    profiling.collect()
    with profiling.tracing():
        send(server, 3)
        send(server, 1)
    return profiling.collect()


def children(spans, parent):
    return [s for s in spans if s["parent"] == parent["id"]]


def test_tracing_off_records_nothing_and_returns_the_shared_no_op():
    assert profiling.annotate("cosypose.model.iteration", rows=3) is profiling._OFF
    with profiling.annotate("cosypose.model.iteration"):
        profiling.count("rows", 4)
    assert profiling.collect() == {"spans": [], "counters": {}}


def test_tracing_off_enters_no_range_and_makes_no_event(server, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("tracing off made a range or an event")

    monkeypatch.setattr(profiling, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    send(server, 2)
    assert profiling.collect() == {"spans": [], "counters": {}}


def test_one_request_span_a_call_each_with_its_own_id(traced):
    spans = traced["spans"]
    requests = [s for s in spans if s["name"] == "cosypose.serve.request"]
    assert [r["attrs"] for r in requests] == [{"detections": 3, "chunks": 2},
                                              {"detections": 1, "chunks": 1}]
    assert [r["parent"] for r in requests] == [None, None]
    assert [r["request"] for r in requests] == [r["id"] for r in requests]
    assert len({r["id"] for r in requests}) == 2
    by_id = {s["id"]: s for s in spans}
    for s in spans:  # every other span lies inside its request's, under its parent
        if s["parent"] is not None:
            parent = by_id[s["parent"]]
            assert s["request"] == parent["request"]
            assert parent["host_start_ns"] <= s["host_start_ns"]
            assert s["host_end_ns"] <= parent["host_end_ns"]
    assert sorted(traced["counters"]) == sorted(r["id"] for r in requests)


def test_request_holds_init_then_chunks_of_each_model(traced):
    spans = traced["spans"]
    for req in (s for s in spans if s["name"] == "cosypose.serve.request"):
        kids = children(spans, req)
        chunks = req["attrs"]["chunks"]
        assert [k["name"] for k in kids] == ["cosypose.serve.init"] + \
            ["cosypose.serve.chunk"] * (2 * chunks)
        assert [k["attrs"] for k in kids[1:]] == [{"model": "coarse"}] * chunks + \
            [{"model": "refiner"}] * chunks
        for chunk, n_it in zip(kids[1:], [COARSE] * chunks + [REFINER] * chunks):
            assert [k["name"] for k in children(spans, chunk)] == \
                ["cosypose.serve.gather"] + ["cosypose.model.iteration"] * n_it + \
                ["cosypose.serve.collect"]


def test_iterations_hold_crop_render_backbone_update(traced):
    spans = traced["spans"]
    iterations = [s for s in spans if s["name"] == "cosypose.model.iteration"]
    requests = [s for s in spans if s["name"] == "cosypose.serve.request"]
    assert len(iterations) == sum(r["attrs"]["chunks"] for r in requests) * (COARSE + REFINER)
    for it in iterations:
        parts = children(spans, it)
        assert [p["name"] for p in parts] == ITERATION_PARTS
        assert parts[1]["attrs"] == {"rows": BSZ, "pixels": BSZ * 48 * 64}
        assert [b["name"] for b in children(spans, parts[2])] == BACKBONE_PARTS
        assert all(children(spans, p) == [] for p in (parts[0], parts[1], parts[3]))


def test_counters_count_rows_computed_and_useful(traced):
    n_it = COARSE + REFINER
    for req in (s for s in traced["spans"] if s["name"] == "cosypose.serve.request"):
        dets, chunks = req["attrs"]["detections"], req["attrs"]["chunks"]
        assert traced["counters"][req["id"]] == {
            "rows": BSZ * chunks * n_it, "useful_rows": dets * n_it,
            "iterations": chunks * n_it}


def test_host_times_ordered_and_no_device_times_on_the_cpu(traced):
    spans = traced["spans"]
    assert [s["host_start_ns"] for s in spans] == sorted(s["host_start_ns"] for s in spans)
    for s in spans:
        assert s["host_start_ns"] <= s["host_end_ns"]
        assert s["device_start_ns"] is None and s["device_end_ns"] is None
        assert s["syncs"] == 0


def test_a_sync_counts_on_the_innermost_span_and_its_request():
    """The sync debug mode's warning, raised here by hand, counts once on the
    innermost open span; outside any span it is swallowed uncounted."""
    with warnings.catch_warnings(record=True) as shown:
        warnings.simplefilter("always")
        with profiling.tracing():
            warnings.warn(profiling.SYNC_WARNING)
            with profiling.annotate("outer"):
                with profiling.annotate("inner"):
                    warnings.warn(profiling.SYNC_WARNING)
                    warnings.warn(profiling.SYNC_WARNING)
                warnings.warn(profiling.SYNC_WARNING)
                warnings.warn("another warning")
    rec = profiling.collect()
    outer, inner = rec["spans"]
    assert (outer["syncs"], inner["syncs"]) == (1, 2)
    assert rec["counters"] == {outer["id"]: {"syncs": 3}}
    assert [str(w.message) for w in shown] == ["another warning"]


def test_trace_holds_the_programs_ranges_inside_the_callers(server, tmp_path):
    with profiling.trace(tmp_path / "trace") as prof:
        with profiling.annotate("served_request"):
            send(server, 1)
    events = [e for e in json.loads(prof.trace_path.read_text())["traceEvents"]
              if e.get("ph") == "X"]

    def extent(name):
        return [(e["ts"], e["ts"] + e["dur"]) for e in events if e["name"] == name]

    (outer,) = extent("served_request")
    (request,) = extent("cosypose.serve.request")
    backbones = extent("cosypose.model.backbone")
    assert len(backbones) == COARSE + REFINER
    for a, b in [request, *backbones]:
        assert outer[0] <= a <= b <= outer[1]
    assert len(extent("cosypose.backbone.stage4")) == COARSE + REFINER
    assert profiling.collect() == {"spans": [], "counters": {}}


def test_serving_export_traces_the_same_graph_with_tracing_on(server):
    module = ServedPoseModel(server.refiner_model, n_iterations=1).eval()
    args = (torch.rand(2, 3, 96, 128), torch.tensor([[[150.0, 0, 64], [0, 150.0, 48],
                                                      [0, 0, 1]]]).expand(2, 3, 3),
            torch.eye(4).expand(2, 4, 4).clone(), torch.zeros(2, dtype=torch.int64))
    args[2][:, 2, 3] = 0.6

    def graph():
        with torch.no_grad():
            return torch.export.export(module, args).graph_module.code

    off = graph()
    with profiling.tracing():
        on = graph()
    assert on == off
    assert "record_function" not in on and "profiler" not in on
    assert profiling.collect() == {"spans": [], "counters": {}}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_a_planted_item_is_one_sync_on_its_span(cuda):
    x = torch.ones(4, device=cuda)
    profiling.collect()
    with profiling.tracing():
        with profiling.annotate("outer"):
            y = x * 2
            with profiling.annotate("planted"):
                value = y.sum().item()
            z = y + 1
    rec = profiling.collect()
    outer, planted = rec["spans"]
    assert value == 8.0 and z.shape == (4,)
    assert (outer["syncs"], planted["syncs"]) == (0, 1)
    assert rec["counters"] == {outer["id"]: {"syncs": 1}}
    assert torch.cuda.get_sync_debug_mode() == 0
    for s in (outer, planted):
        assert s["device_start_ns"] <= s["device_end_ns"]
        assert s["host_start_ns"] <= s["device_end_ns"]


@pytest.mark.gpu
def test_backbone_device_ms_agree_with_the_harness_span(cuda):
    """The program's model.backbone spans against the benchmark harness's own
    wrapper around the same PoseNet calls (CUDA events on both): the mean
    device ms within 5 %."""
    from benchmark.harness.trace import Spans

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    server = make_server("cuda")
    for _ in range(2):
        send(server, 3)
    outside = Spans("cuda")
    for m in (server.coarse_model, server.refiner_model):
        outside.wrap(m.predictor.net, "forward", "backbone")
    profiling.collect()
    try:
        with profiling.tracing():
            for _ in range(5):
                send(server, 3)
        rec = profiling.collect()
        harness = outside.ms()["backbone"]
    finally:
        outside.unwrap()
    program = [(s["device_end_ns"] - s["device_start_ns"]) / 1e6 for s in rec["spans"]
               if s["name"] == "cosypose.model.backbone"]
    assert len(program) == len(harness) == 5 * 2 * (COARSE + REFINER)
    assert abs(np.mean(program) - np.mean(harness)) <= 0.05 * np.mean(harness)
    requests = [s for s in rec["spans"] if s["name"] == "cosypose.serve.request"]
    assert all(rec["counters"][r["id"]]["syncs"] > 0 for r in requests)
