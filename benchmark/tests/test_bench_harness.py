"""CPU tests of the benchmark's harness: runs of the tiny cells through the
same drivers, the modules a run loads, a cell and a metric added as files,
the yardstick's counts, and the planted faults the check must catch.

    python -m pytest benchmark/tests -q            # here, on the CPU
    python -m pytest benchmark/tests -q -m gpu     # on a machine with a card
"""

from __future__ import annotations

import json
import math
import shutil
import subprocess
import sys
import time

import pytest
import torch

from benchmark.checks import faults, readings
from benchmark.harness import cli, counts, spec
from benchmark.reference import efficientnet as ref_net
from benchmark.tests import tiny

CELLS = {"ycbv-b3.frames": "frames", "tless-refiner.train": "train_items"}  # cell: mix kind


@pytest.fixture(scope="module")
def tiny_spec(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("tiny"))


def run_tiny(spec_path, name, trace=False, fault=None):
    torch.set_num_threads(4)
    cell = spec.cell(name, spec_path)
    drv = spec.driver(cell.traffic["kind"])
    f = faults.get(cell.traffic["kind"], fault) if fault else None
    if f is None:
        return cli.execute(cell, 2 ** 33 + 17, 1.0, trace, "cpu", time.perf_counter())
    out = drv.run(cell=cell, seed=2 ** 33 + 17, seconds=1.0, trace=False, device="cpu",
                  t_start=time.perf_counter(), faults=f)
    return {"correct": out.failed == 0 and all(v <= lim for _, v, lim in out.checks),
            "check": {k: (v, lim) for k, v, lim in out.checks}}


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_tiny_cell_runs_and_is_correct(tiny_spec, name, trace):
    res = run_tiny(tiny_spec, name, trace)
    cell = spec.cell(name, tiny_spec)
    assert res["correct"], res["check"]
    assert list(res)[-1] == "check"
    want = [m["name"] for m in (cell.per_layer if trace else cell.end_to_end)]
    if trace:  # a CPU run has no card trace: the readers of card time find nothing
        want = [m for m in want if not m.startswith(("render_roofline", "peak_mem"))]
    assert sorted(res["metrics"]) == sorted(want)
    assert all(math.isfinite(m["value"]) for m in res["metrics"].values())
    assert res["attempted"] > 0 and res["failed"] == 0


@pytest.mark.parametrize("name,fault", [(name, fault) for name, kind in CELLS.items()
                                        for fault in faults.FAULTS[kind]])
def test_planted_fault_makes_the_run_incorrect(tiny_spec, name, fault):
    res = run_tiny(tiny_spec, name, fault=fault)
    assert not res["correct"], res["check"]


def test_fp8_control_fails_the_serving_check(tiny_spec):
    cell = spec.cell("ycbv-b3.frames", tiny_spec)
    row = next(readings.readings(cell, [5], 1.0, "cpu", "fp8"))
    limits = cell.workload["limits"]
    assert any(row["control"][k] > lim for k, lim in limits.items()), row
    assert all(row["program"][k] <= lim for k, lim in limits.items()), row


@pytest.mark.gpu
def test_fp8_control_fails_the_serving_check_on_the_card(tiny_spec):
    """The serving cell's control fails one of its numbers on the card too,
    at the tiny size, on three seeds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = spec.cell("ycbv-b3.frames", tiny_spec)
    for row in readings.readings(cell, [5, 6, 7], 1.0, "cuda", cell.workload["control"]):
        limits = cell.workload["limits"]
        assert any(row["control"][k] > lim for k, lim in limits.items()), row


def test_run_loads_no_jax(tiny_spec):
    """A whole run in a fresh process leaves no module of jax, jaxlib, flax
    or the JAX package loaded (top-level names compared whole)."""
    code = (f"import sys, time; sys.path.insert(0, {str(spec.ROOT)!r})\n"
            "import torch; torch.set_num_threads(2)\n"
            "from benchmark.harness import cli, spec\n"
            f"c = spec.cell('ycbv-b3.frames', __import__('pathlib').Path({str(tiny_spec)!r}))\n"
            "cli.execute(c, 3, 0.5, False, 'cpu', time.perf_counter())\n"
            "print(cli.loaded_forbidden()); print('cosypose_tpu_torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, check=True).stdout.split("\n")
    assert out[-3:-1] == ["[]", "True"]


def test_reference_imports_nothing_of_the_program():
    code = (f"import sys; sys.path.insert(0, {str(spec.ROOT)!r})\n"
            "import benchmark.reference.efficientnet, benchmark.reference.geometry\n"
            "import benchmark.reference.raster, benchmark.reference.serve\n"
            "import benchmark.reference.train\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'cosypose_tpu', 'cosypose_tpu_torch'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True).stdout.split("\n")
    assert out[-2] == "[]"
    for path in (spec.BENCH_DIR / "reference").glob("*.py"):
        assert "cosypose" not in path.read_text().replace("CosyPose", ""), path


def test_a_cell_and_a_metric_added_as_files_are_listed(tmp_path):
    """A later change adds a cell, its mix, its configuration and a
    per-layer metric by adding files and entries; the harness lists them
    with no edit of a file that was there."""
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(spec.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = tmp_path / "benchmark"
    cfg = json.loads((bench / "configs" / "ycbv-bop20-b3.json").read_text())
    (bench / "configs" / "dummy-config.json").write_text(json.dumps(dict(cfg, n_objects=8)))
    mix = json.loads((bench / "traffic" / "frames.json").read_text())
    (bench / "traffic" / "dummy-mix.json").write_text(json.dumps(dict(mix, sizes=[8])))
    wl = json.loads((bench / "workloads" / "ycbv-b3.frames.json").read_text())
    (bench / "workloads" / "dummy.cell.json").write_text(json.dumps(
        dict(wl, config="dummy-config", traffic="dummy-mix")))
    (bench / "metrics" / "dummy_rows.frames.py").write_text(
        "def read(run):\n    return run.counters.get('rows')\n")
    b = json.loads((tmp_path / "BENCHMARK.json").read_text())
    b["configs"].append(dict(b["configs"][0], name="dummy-config",
                             file="benchmark/configs/dummy-config.json"))
    b["workloads"].append(dict(b["workloads"][0], name="dummy.cell", config="dummy-config",
                               traffic="dummy-mix"))
    b["per_layer"].append(dict(b["per_layer"][0], name="dummy_rows.frames",
                               workloads=["dummy.cell"]))
    b["end_to_end"] = [dict(m, workloads=m["workloads"] + ["dummy.cell"])
                       if "ycbv-b3.frames" in m.get("workloads", []) else m
                       for m in b["end_to_end"]]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    out = subprocess.run([sys.executable, str(bench / "run.py"), "--list"], capture_output=True,
                         text=True, timeout=300, check=True, cwd=tmp_path).stdout
    rows = dict(line.split(" ", 1) for line in out.strip().split("\n"))
    row = json.loads(rows["dummy.cell"])
    assert row["config"] == "dummy-config" and row["traffic"] == "dummy-mix"
    assert row["per_layer"] == ["dummy_rows.frames"] and not row["readers_missing"]
    assert not row["driver_missing"] and "frame_ms_p95" in row["end_to_end"]
    assert spec.cell("dummy.cell", tmp_path / "BENCHMARK.json").config["n_objects"] == 8
    read = spec.reader("dummy_rows.frames", bench)
    assert read(cli.Run({}, 1.0, {}, {"rows": 64}, None, {})) == 64


def conv_flops(variant: str, hw: tuple) -> float:
    """Forward FLOPs of the network at one row, walked layer by layer: 2 x
    multiply-adds of every convolution and of the head."""
    wm = ref_net.SCALING[variant][0]
    h, w = hw
    total = 0.0

    def conv(cin, cout, k, s=1, groups=1):
        nonlocal h, w, total
        h, w = math.ceil(h / s), math.ceil(w / s)
        total += 2 * cout * (cin // groups) * k * k * h * w

    conv(6, ref_net.width(32, wm), 3, 2)
    for b in ref_net.blocks(variant):
        mid = b["cin"] * b["expand"]
        if b["expand"] != 1:
            conv(b["cin"], mid, 1)
        conv(mid, mid, b["kernel"], b["stride"], groups=mid)
        total += 2 * (mid * b["se"] + b["se"] * mid)  # squeeze-excite on the pooled row
        conv(mid, b["cout"], 1)
    conv(ref_net.width(320, wm), ref_net.n_features(variant), 1)
    return total + 2 * ref_net.n_features(variant) * 9


@pytest.mark.parametrize("variant,hw", [("efficientnet-b0", (48, 64)),
                                        ("efficientnet-b3", (32, 40))])
def test_network_flops_at_a_small_size(variant, hw):
    fwd = counts.network_flops(variant, hw, False)
    assert fwd == conv_flops(variant, hw)
    stem = 2 * ref_net.width(32, ref_net.SCALING[variant][0]) * 6 * 9 * \
        math.ceil(hw[0] / 2) * math.ceil(hw[1] / 2)
    assert counts.network_flops(variant, hw, True) == 3 * fwd - stem


def test_render_bytes_count_inputs_once_and_outputs_once():
    # 2 rows of 10 and 12 valid faces at 4 x 5 pixels
    assert counts.render_bytes(2, 22, 2 * 4 * 5) == 22 * 72 + 2 * 100 + 40 * 17
