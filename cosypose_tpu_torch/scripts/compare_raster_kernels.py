"""Device time of both raster kernels at the main path's render and at two
large soups, for several checkouts of the repo on one card, each in a fresh
process, in turns.

    python -m cosypose_tpu_torch.scripts.compare_raster_kernels PARENT . . PARENT

Each argument is the root of a checkout (for instance the parent commit
unpacked with `git archive` into a directory that .gitignore lists); its own
`cosypose_tpu_torch` builds its own kernels into its own build/. The inputs
are the main path's first render (demo spheres at LOD 512, B=128, 240x320,
tile (16, 32), budget 1024): kernel A (setup with its sort) and kernel B
(resolve) are each timed by CUDA events over 200 launches queued behind a
spin kernel, three times. Then, each over 20 calls three times, the same at
two items of 262,144 rows (chip_smoke.large_soup, 240x320) and at the
ycbv-1M-sized scene (8 seeded 8,192-face meshes and the cage, 65,896 rows,
480x640), both at the scene renderer's tile (8, 320) and budget 6,144 with
the attribute: every launch of each kernel a call makes (kernel A's merge,
kernel B's binning) counted in its time. Prints one JSON line a checkout,
then the card's name and power limit. Exits 2 without a card.
"""

from __future__ import annotations

import pathlib
import subprocess
import sys

CHILD = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
from cosypose_tpu_torch import demo
from cosypose_tpu_torch.ops import rasterizer_cuda as rc
assert rc.__file__.startswith(sys.argv[1]), rc.__file__

def queued_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps

rc.RASTER_KERNEL.load()
f = demo.first_render_inputs(128, (480, 640), (240, 320), 512, "cuda")
args = (f["tri_verts"], f["tri_valid"], f["TCO"], f["K_crop"], (240, 320), f["colors"])
rows, key, order = rc.setup(*args)
resolve = lambda: rc.RASTER_KERNEL.resolve(rows, order, (240, 320), (16, 32), 1024)
out = dict(tree=sys.argv[1], setup_ms=[], resolve_ms=[])
for _ in range(3):
    out["setup_ms"].append(queued_ms(lambda: rc.setup(*args), 200))
    out["resolve_ms"].append(queued_ms(resolve, 200))
depth = resolve()[1]
out["depth_sum"] = float(depth.double().sum())

import numpy as np
import chip_smoke
from cosypose_tpu_torch import demo
from cosypose_tpu_torch.ops.mesh_db import build_mesh_db
from cosypose_tpu_torch.ops.transforms import invert_T
from cosypose_tpu_torch.recording import RecordingSceneSampler
from cosypose_tpu_torch.recording.textures import TextureSampler
from cosypose_tpu_torch.rendering.scene_renderer import SCENE_BUDGET, SCENE_TILE
from cosypose_tpu_torch.scripts.run_dataset_recording import CONFIGS

cfg = CONFIGS["ycbv-1M"]
db = build_mesh_db(demo.dense_specs(8), device="cuda")
full = RecordingSceneSampler(db, resolution=cfg["resolution"], focal_interval=cfg["focal"],
                             texture_sampler=TextureSampler(p_textured=0.8),
                             n_objects_interval=(8, 9), p_cage=1.0)
rng = np.random.RandomState(0)
scene = full._sample_objects(rng) + full._cage_geometry(rng)
cam = full._sample_camera(rng)
tv, valid, colors, ids = full.renderer.soup(scene)
on = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt, device="cuda")[None]
soup, attr = chip_smoke.large_soup(2, 262_144, (240, 320), seed=262_144)
cases = {"large": ((*soup[:4], (240, 320), soup[4]), attr),
         "ycbv_scene": ((on(tv), on(valid, torch.bool), invert_T(on(cam["TWC"])), on(cam["K"]),
                         tuple(cfg["resolution"]), on(colors)), on(ids))}
for name, (sargs, a) in cases.items():
    rows, key, order = rc.setup(*sargs, tri_attr=a)
    budget = min(rows.shape[1], SCENE_BUDGET)
    res = lambda: rc.RASTER_KERNEL.resolve(rows, order, sargs[4], SCENE_TILE, budget, True)
    out[name] = dict(rows=list(rows.shape[:2]), setup_ms=[], resolve_ms=[])
    for _ in range(3):
        out[name]["setup_ms"].append(queued_ms(lambda: rc.setup(*sargs, tri_attr=a), 20))
        out[name]["resolve_ms"].append(queued_ms(res, 20))
    out[name]["depth_sum"] = float(res()[1].double().sum())
    del rows, key, order
print(json.dumps(out))
"""


def main(argv=None) -> int:
    import torch

    trees = [str(pathlib.Path(t).resolve()) for t in (argv or sys.argv[1:])]
    if not torch.cuda.is_available():
        print("compare_raster_kernels: no CUDA card", file=sys.stderr)
        return 2
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    for tree in trees:
        run = subprocess.run([sys.executable, "-c", CHILD, tree], capture_output=True, text=True,
                             timeout=600)
        if run.returncode:
            raise RuntimeError(f"{tree}: exit {run.returncode}\n{run.stderr[-3000:]}")
        print(run.stdout.strip().splitlines()[-1], flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
