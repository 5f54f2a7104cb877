"""A tiny copy of the benchmark's cells for CPU tests: B0 at 48x64 renders,
four small meshes, chunks of 8 rows, a short B0 training step. `make(root)`
writes BENCHMARK.json and the cells' files under `root`, with the training
cell (`TRAIN_CELL`: built and measured, not yet in BENCHMARK.json, whose
check is not proven on the card; PERF.md) added to the benchmark's own."""

from __future__ import annotations

import copy
import json
import pathlib

from benchmark.harness import spec

SERVE = {"backbone": "efficientnet-b0", "image_size": [96, 128], "render_size": [48, 64],
         "n_points_crop": 200, "bsz_objects": 8, "n_objects": 4, "mesh_grid": [9, 8],
         "render_faces": 64, "calibration_batch": 24,
         "head_out_std": 0.02}
FRAMES = {"sizes": [1, 2, 3], "intrinsics": [150.0, 150.0, 64.0, 48.0]}
FRAMES_WL = {"profiled_requests": 2, "detailed_requests": 1, "check_requests": 3}
TRAIN = {"backbone": "efficientnet-b0", "image_size": [96, 128], "render_size": [48, 64],
         "batch_size": 4, "train_iterations": 2, "n_points_crop": 200, "n_points_loss": 50,
         "n_objects": 4, "mesh_grid": [9, 8], "render_faces": 128, "calibration_batch": 24,
         "head_out_std": 0.02, "loader_workers": 0, "z_symmetric_objects": [1]}
TRAIN_MIX = {"intrinsics": [150.0, 150.0, 64.0, 48.0], "n_items": 1000}
TRAIN_WL = {"profiled_steps": 1, "detailed_steps": 1}


TRAIN_CELL = {
    "configs": [
        {
            "name": "tless-refiner",
            "source": "https://github.com/ylabbe/cosypose",
            "file": "benchmark/configs/tless-refiner.json",
            "reduced": [
                "rgb_augmentation"
            ],
            "why": "T-LESS refiner training: B3 fp32, batch 32, 3 iterations, full-detail renders, symmetric loss, Adam behind the 0.5 clip, 8 loader workers"
        }
    ],
    "workloads": [
        {
            "name": "tless-refiner.train",
            "config": "tless-refiner",
            "traffic": "train",
            "chips": 1,
            "why": "the train step at batch 32 from 8 loader workers: crop, 8,192-face render and B3 forward + backward over 3 iterations, clip, Adam; bypasses serving's padding"
        }
    ],
    "end_to_end": [
        {
            "name": "train_samples_per_s",
            "unit": "samples/s",
            "better": "higher",
            "bound": 0.25,
            "source": "host_clock",
            "workloads": [
                "tless-refiner.train"
            ]
        }
    ],
    "per_layer": [
        {
            "name": "render_roofline_pct.train",
            "unit": "%",
            "better": "higher",
            "source": "device_trace",
            "layer": "render",
            "moves": "train_samples_per_s",
            "workloads": [
                "tless-refiner.train"
            ]
        },
        {
            "name": "data_wait_ms.train",
            "unit": "ms",
            "better": "lower",
            "source": "host_clock",
            "layer": "train loop",
            "moves": "train_samples_per_s",
            "workloads": [
                "tless-refiner.train"
            ]
        },
        {
            "name": "step_ms.train",
            "unit": "ms",
            "better": "lower",
            "source": "program_span",
            "layer": "train step",
            "moves": "train_samples_per_s",
            "workloads": [
                "tless-refiner.train"
            ]
        },
        {
            "name": "mfu_pct.train",
            "unit": "%",
            "better": "higher",
            "source": "host_clock",
            "layer": "whole step",
            "moves": "train_samples_per_s",
            "workloads": [
                "tless-refiner.train"
            ]
        },
        {
            "name": "idle_pct.train",
            "unit": "%",
            "better": "lower",
            "source": "device_trace",
            "layer": "device",
            "moves": "train_samples_per_s",
            "workloads": [
                "tless-refiner.train"
            ]
        },
        {
            "name": "peak_mem_gib.train",
            "unit": "GiB",
            "better": "lower",
            "source": "program_counter",
            "layer": "device",
            "moves": "train_samples_per_s",
            "workloads": [
                "tless-refiner.train"
            ]
        }
    ]
}


def make(root: pathlib.Path) -> pathlib.Path:
    """The tiny cells under root; returns root / 'BENCHMARK.json'."""
    bench = spec.load(spec.ROOT / "BENCHMARK.json")
    for key, entries in TRAIN_CELL.items():
        bench[key] = bench[key] + entries
    for sub in ("configs", "traffic", "workloads"):
        (root / "benchmark" / sub).mkdir(parents=True, exist_ok=True)
    for c in bench["configs"]:
        cfg = spec.load(spec.ROOT / c["file"])
        cfg.update(SERVE if c["name"] == "ycbv-bop20-b3" else TRAIN)
        (root / c["file"]).write_text(json.dumps(cfg))
    for w in bench["workloads"]:
        mix = spec.load(spec.BENCH_DIR / "traffic" / f"{w['traffic']}.json")
        wl = spec.load(spec.BENCH_DIR / "workloads" / f"{w['name']}.json")
        mix.update(FRAMES if w["traffic"] == "frames" else TRAIN_MIX)
        wl.update(FRAMES_WL if w["traffic"] == "frames" else TRAIN_WL)
        (root / "benchmark" / "traffic" / f"{w['traffic']}.json").write_text(json.dumps(mix))
        (root / "benchmark" / "workloads" / f"{w['name']}.json").write_text(json.dumps(wl))
    (root / "BENCHMARK.json").write_text(json.dumps(copy.deepcopy(bench)))
    return root / "BENCHMARK.json"
