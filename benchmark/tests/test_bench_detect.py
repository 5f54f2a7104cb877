"""CPU tests of the detect and groups cells: tiny copies of both through
their drivers, the detect cell's planted faults and its fp8 control, the
listing and the detect cell's FLOP count.

    python -m pytest benchmark/tests -q

The tiny copies start from tiny.make (the benchmark's cells at CPU size)
and shrink the two new cells' files the same way: Mask R-CNN at its
published widths on 96x128 frames with 200 anchors a level, 100 proposals
an image, up to 10 detections and 5 classes; the groups cell with tiny.py's
B0 serving configuration, 2 views of 4 objects (8 detections, one chunk of
8 rows).
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import pytest
import torch

from benchmark.checks import detect_faults, faults, readings  # noqa: F401 (registers)
from benchmark.harness import cli, detect_counts, spec
from benchmark.tests import tiny

CELLS = ("ycbv-maskrcnn.frames", "ycbv-b3.groups")
DETECT = {"image_size": [96, 128], "input_resize": [96, 128], "rpn_pre_nms_top_n": 200,
          "rpn_post_nms_top_n": 100, "box_detections_per_img": 10, "n_classes": 5,
          "weights": {"detections_target": 6}}
DETECT_MIX = {"intrinsics": [150.0, 150.0, 64.0, 48.0], "sizes": [1, 2, 3],
              "objects": {"n_objects": 4, "mesh_grid": [9, 8], "mesh_seed": 0}}
GROUPS_MIX = {"intrinsics": [150.0, 150.0, 64.0, 48.0], "views": 2, "objects": 4}
WL = {"profiled_requests": 2, "detailed_requests": 1, "check_requests": 2}


@pytest.fixture(scope="module")
def tiny_spec(tmp_path_factory):
    root = tmp_path_factory.mktemp("tiny_detect")
    path = tiny.make(root)
    bench = json.loads(path.read_text())
    cfg_file = next(c["file"] for c in bench["configs"] if c["name"] == "ycbv-maskrcnn-r50fpn")
    cfg = spec.load(spec.ROOT / cfg_file)
    cfg.update({**DETECT, "weights": {**cfg["weights"], **DETECT["weights"]}})
    (root / cfg_file).write_text(json.dumps(cfg))
    for name, mix_name, mix in (("ycbv-maskrcnn.frames", "detect-frames", DETECT_MIX),
                                ("ycbv-b3.groups", "groups", GROUPS_MIX)):
        m = spec.load(spec.BENCH_DIR / "traffic" / f"{mix_name}.json")
        (root / "benchmark" / "traffic" / f"{mix_name}.json").write_text(json.dumps({**m, **mix}))
        wl = spec.load(spec.BENCH_DIR / "workloads" / f"{name}.json")
        (root / "benchmark" / "workloads" / f"{name}.json").write_text(json.dumps({**wl, **WL}))
    return path


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_tiny_new_cell_runs_and_is_correct(tiny_spec, name, trace):
    torch.set_num_threads(4)
    cell = spec.cell(name, tiny_spec)
    res = cli.execute(cell, 2 ** 33 + 29, 1.0, trace, "cpu", time.perf_counter())
    assert res["correct"], res["check"]
    want = [m["name"] for m in (cell.per_layer if trace else cell.end_to_end)]
    if trace:  # a CPU run has no card trace: the readers of card time find nothing
        want = [m for m in want if not m.startswith(("render_roofline", "nms_roofline"))]
    assert sorted(res["metrics"]) == sorted(want)
    assert all(math.isfinite(m["value"]) for m in res["metrics"].values())
    assert res["attempted"] > 0 and res["failed"] == 0
    if trace and name == "ycbv-b3.groups":  # one full chunk: no padding row
        assert res["metrics"]["pad_row_share.frames"]["value"] == 0.0


@pytest.mark.parametrize("fault", ["proposals_cut", "class_nms_skipped", "paste_unpadded",
                                   "paste_shifted"])
def test_planted_detect_fault_makes_the_run_incorrect(tiny_spec, fault):
    torch.set_num_threads(4)
    cell = spec.cell("ycbv-maskrcnn.frames", tiny_spec)
    out = spec.driver("detect").run(cell=cell, seed=5, seconds=0.5, trace=False, device="cpu",
                                    t_start=time.perf_counter(),
                                    faults=faults.get("detect", fault))
    assert not all(v <= lim for _, v, lim in out.checks), out.checks
    if fault.startswith("paste"):  # what the model pastes, and nothing before it
        assert [k for k, v, lim in out.checks if v > lim] == ["paste_px_share"], out.checks
    assert faults.FAULTS["detect"] == ("proposals_cut", "class_nms_skipped", "paste_unpadded",
                                       "paste_shifted")


def test_fp8_control_fails_the_detect_check(tiny_spec):
    torch.set_num_threads(4)
    cell = spec.cell("ycbv-maskrcnn.frames", tiny_spec)
    row = next(readings.readings(cell, [7], 0.5, "cpu", "fp8"))
    limits = cell.workload["limits"]
    assert any(row["control"].get(k, 0.0) > lim for k, lim in limits.items()), row
    assert all(row["program"][k] <= lim for k, lim in limits.items()), row


def test_listing_finds_every_reader_and_driver():
    out = subprocess.run([sys.executable, str(spec.BENCH_DIR / "run.py"), "--list"],
                         capture_output=True, text=True, timeout=300, check=True).stdout
    rows = {k: json.loads(v) for k, v in (line.split(" ", 1) for line in out.strip().split("\n"))}
    for name in CELLS:
        assert not rows[name]["readers_missing"] and not rows[name]["driver_missing"]
    assert rows["ycbv-b3.groups"]["end_to_end"] == ["setup_s", "frame_ms_p95", "poses_per_s"]
    assert rows["ycbv-maskrcnn.frames"]["end_to_end"] == ["setup_s", "frame_ms_p95"]


def test_detect_flops_count_the_heads_layer_by_layer():
    assert detect_counts.proposal_flops(22) == 2 * (256 * 49 * 1024 + 1024 * 1024
                                                    + 1024 * 22 + 1024 * 88)
    convs = 4 * 256 * 256 * 9 * 14 * 14 + 256 * 256 * 4 * 14 * 14 + 22 * 256 * 28 * 28
    assert detect_counts.detection_flops(22) == 2 * convs
    assert 1.1e11 < detect_counts.frame_flops((480, 640), 22) < 1.2e11
    assert detect_counts.nms_bytes(4140, 5) == 4140 * 18 + 6 * 8
