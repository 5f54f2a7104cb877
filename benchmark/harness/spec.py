"""Finds a cell's files by the names in BENCHMARK.json: its configuration
(the entry's `file`), its traffic mix (benchmark/traffic/<traffic>.json), its
workload file (benchmark/workloads/<cell>.json: the checks' limits and the
cell's own settings), its metrics, and each per-layer metric's reader
(benchmark/metrics/<metric>.py, a function `read(run)`).

Adding a cell, a mix, a configuration or a per-layer metric is adding files
and entries: nothing here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib

BENCH_DIR = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    workload: dict
    end_to_end: list
    per_layer: list


def in_cell(metric: dict, name: str) -> bool:
    return "workloads" not in metric or name in metric["workloads"]


def cell(name: str, spec_path: pathlib.Path | None = None) -> Cell:
    spec = load(spec_path or ROOT / "BENCHMARK.json")
    root = (spec_path or ROOT / "BENCHMARK.json").parent
    entries = [w for w in spec["workloads"] if w["name"] == name]
    if not entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: "
                       f"{[w['name'] for w in spec['workloads']]}")
    w = entries[0]
    cfg_entry = next(c for c in spec["configs"] if c["name"] == w["config"])
    bench = root / "benchmark"
    return Cell(name=name, chips=w["chips"], config=load(root / cfg_entry["file"]),
                traffic=load(bench / "traffic" / f"{w['traffic']}.json"),
                workload=load(bench / "workloads" / f"{name}.json"),
                end_to_end=[m for m in spec["end_to_end"] if in_cell(m, name)],
                per_layer=[m for m in spec["per_layer"] if in_cell(m, name)])


def listing(root: pathlib.Path = ROOT) -> dict:
    """Every cell with its configuration, mix, chips, metrics, and whether
    each file it needs is there."""
    bench = root / "benchmark"
    out = {}
    for w in load(root / "BENCHMARK.json")["workloads"]:
        c = cell(w["name"], root / "BENCHMARK.json")
        out[w["name"]] = dict(
            config=w["config"], traffic=w["traffic"], kind=c.traffic["kind"], chips=c.chips,
            end_to_end=[m["name"] for m in c.end_to_end],
            per_layer=[m["name"] for m in c.per_layer],
            readers_missing=[m["name"] for m in c.per_layer
                             if not (bench / "metrics" / f"{m['name']}.py").exists()],
            driver_missing=not (bench / "harness" / "drivers" / f"{c.traffic['kind']}.py").exists())
    return out


def reader(metric: str, bench: pathlib.Path = BENCH_DIR):
    """The per-layer metric's `read(run) -> float | None`."""
    path = bench / "metrics" / f"{metric}.py"
    mod_spec = importlib.util.spec_from_file_location(f"bench_metric_{metric}", path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module.read


def driver(kind: str):
    """The module that runs a mix of this kind: benchmark/harness/drivers/<kind>.py."""
    return importlib.import_module(f"benchmark.harness.drivers.{kind}")
