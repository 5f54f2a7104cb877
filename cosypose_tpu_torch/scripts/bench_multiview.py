"""Multi-view RANSAC + bundle adjustment at the reference's protocol scale
(port of cosypose_tpu/scripts/bench_multiview.py).

The published multi-view protocol runs ~2000-hypothesis RANSAC over groups of
4-8 views with tens of candidates a view. make_scenario synthesizes such a
scene (n_views cameras around a pile of n_objects, several noisy candidates
a visible object and outliers, the JAX package's draws) and main times each
stage of the port on it:

  * RANSAC camera-pose hypotheses, scoring with the top-k selection and the
    C++ greedy pass, matching bookkeeping (the matcher's own timers, which
    wait for the card);
  * bundle adjustment of each view group: initialization and LM.

  python -m cosypose_tpu_torch.scripts.bench_multiview [--n-views 8] [--n-objects 12] \\
      [--n-labels 6] [--dup 4] [--outliers 5] [--ransac-iter 2000] [--ba-iter 50] \\
      [--reps 3] [--json OUT] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..evaluation import table
from ..multiview.bundle_adjustment import MultiviewRefinement, make_view_groups
from ..multiview.ransac import multiview_candidate_matching
from ..ops.mesh_db import MeshSpec, build_mesh_db
from ..utils.tensor_collection import TensorCollection


def cube_specs(n_labels: int) -> list:
    """Cubes of 4 cm + 1.6 cm a label, the JAX package's benchmark objects."""
    def verts(s):
        return np.array([[x, y, z] for x in (-s, s) for y in (-s, s) for z in (-s, s)],
                        dtype=np.float64)

    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3)]
    faces = np.asarray([t for a, b, c, d in quads for t in ((a, b, c), (a, c, d))])
    return [MeshSpec(label=f"obj_{i:06d}", vertices=verts(0.02 + 0.008 * i) * 1000, faces=faces)
            for i in range(n_labels)]


def _look_at(eye, target=(0.0, 0.0, 0.0)):
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target) - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, [0.0, 0.0, 1.0])
    if np.linalg.norm(right) < 1e-6:
        right = np.array([1.0, 0.0, 0.0])
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    TWC = np.eye(4)
    TWC[:3, 0], TWC[:3, 1], TWC[:3, 2], TWC[:3, 3] = right, down, fwd, eye
    return TWC


def make_scenario(n_views, n_objects, n_labels, dup, outliers, noise_t, noise_deg, seed=0):
    """Objects in a 0.4 m pile, cameras on a 1 m sphere, noisy candidates
    for ~85 % of the objects in each view and score-decayed outliers.
    Returns (candidates, cameras, TWO): TensorCollections on the CPU and the
    objects' world poses."""
    from scipy.spatial.transform import Rotation

    rng = np.random.RandomState(seed)
    labels = [f"obj_{rng.randint(n_labels):06d}" for _ in range(n_objects)]
    TWO = np.tile(np.eye(4), (n_objects, 1, 1))
    TWO[:, :3, :3] = Rotation.random(n_objects, random_state=rng).as_matrix()
    TWO[:, :3, 3] = rng.uniform(-0.2, 0.2, (n_objects, 3)) * [1, 1, 0.3]

    TWC = []
    for v in range(n_views):
        theta = 2 * np.pi * v / n_views + rng.uniform(-0.2, 0.2)
        phi = rng.uniform(0.6, 1.2)
        TWC.append(_look_at(np.array([np.cos(theta) * np.sin(phi),
                                      np.sin(theta) * np.sin(phi), np.cos(phi)])))
    TWC = np.stack(TWC)

    rows, poses = [], []
    for v in range(n_views):
        TCW = np.linalg.inv(TWC[v])
        for o in range(n_objects):
            if rng.uniform() > 0.85:
                continue
            for _ in range(dup):
                d = np.eye(4)
                d[:3, :3] = Rotation.from_euler("xyz", rng.normal(0, noise_deg, 3),
                                                degrees=True).as_matrix()
                d[:3, 3] = rng.normal(0, noise_t, 3)
                poses.append(TCW @ TWO[o] @ d)
                rows.append((v, labels[o], float(rng.uniform(0.5, 1.0))))
        for _ in range(outliers):
            T = np.eye(4)
            T[:3, :3] = Rotation.random(random_state=rng).as_matrix()
            T[:3, 3] = [rng.uniform(-0.3, 0.3), rng.uniform(-0.3, 0.3), rng.uniform(0.6, 1.4)]
            poses.append(T)
            rows.append((v, labels[rng.randint(n_objects)], float(rng.uniform(0.3, 0.6))))

    K = np.zeros((n_views, 3, 3), np.float32)
    K[:, 0, 0] = K[:, 1, 1] = 600.0
    K[:, 0, 2], K[:, 1, 2], K[:, 2, 2] = 320, 240, 1
    n = len(rows)
    candidates = TensorCollection(
        dict(scene_id=np.zeros(n, np.int64), group_id=np.zeros(n, np.int64),
             view_id=np.asarray([r[0] for r in rows], np.int64),
             label=np.asarray([r[1] for r in rows]), score=np.asarray([r[2] for r in rows])),
        poses=torch.as_tensor(np.stack(poses), dtype=torch.float32))
    cameras = TensorCollection(
        dict(scene_id=np.zeros(n_views, np.int64), view_id=np.arange(n_views),
             batch_im_id=np.arange(n_views), group_id=np.zeros(n_views, np.int64)),
        TWC=torch.as_tensor(TWC, dtype=torch.float32), K=torch.as_tensor(K))
    return candidates, cameras, TWO


def run_once(candidates, cameras, mesh_db, ransac_iter: int, ba_iter: int) -> dict:
    """Matching and the bundle adjustment of every view group, timed."""
    t0 = time.perf_counter()
    match = multiview_candidate_matching(candidates=candidates.clone(), mesh_db=mesh_db,
                                         n_ransac_iter=ransac_iter)
    t_match = time.perf_counter() - t0
    filtered = match["filtered_candidates"].merge_df(make_view_groups(match["pairs_TC1C2"]),
                                                     on="view_id")
    t0 = time.perf_counter()
    bas = [MultiviewRefinement(filtered[rows], cameras, match["pairs_TC1C2"],
                               mesh_db).solve(n_iterations=ba_iter)
           for rows in table.groups(filtered.infos, ["view_group"]).values()]
    t_ba = time.perf_counter() - t0
    return dict(match=match, bas=bas, row=dict(
        n_candidates=len(candidates), n_matched=len(filtered), n_groups=len(bas),
        n_objects_out=sum(len(b["objects"]) for b in bas),
        ransac_models_s=match["time_models"].total_seconds(),
        ransac_score_s=match["time_score"].total_seconds(),
        ransac_misc_s=match["time_misc"].total_seconds(), ransac_total_s=t_match,
        ba_init_s=sum(b["time_init"].total_seconds() for b in bas),
        ba_opt_s=sum(b["time_opt"].total_seconds() for b in bas), ba_total_s=t_ba,
        n_lm_iterations=[b["n_lm_iterations"] for b in bas],
        final_loss=[b["final_loss"] for b in bas]))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--n-views", type=int, default=8)
    parser.add_argument("--n-objects", type=int, default=12)
    parser.add_argument("--n-labels", type=int, default=6)
    parser.add_argument("--dup", type=int, default=4)
    parser.add_argument("--outliers", type=int, default=5)
    parser.add_argument("--ransac-iter", type=int, default=2000)
    parser.add_argument("--ba-iter", type=int, default=50)
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--json", default=None)
    parser.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    args = parser.parse_args(argv)

    mesh_db = build_mesh_db(cube_specs(args.n_labels), aabb=True, keep_geometry=False,
                            device=args.device)
    candidates, cameras, _ = make_scenario(args.n_views, args.n_objects, args.n_labels, args.dup,
                                           args.outliers, noise_t=0.004, noise_deg=2.0)
    print(f"scenario: {len(candidates)} candidates over {args.n_views} views "
          f"({args.n_objects} objects, {args.ransac_iter} RANSAC hypotheses), on "
          f"{mesh_db.device}")
    rows = []
    for rep in range(args.reps):
        r = dict(rep=rep, **run_once(candidates, cameras, mesh_db, args.ransac_iter,
                                     args.ba_iter)["row"])
        rows.append(r)
        print(f"rep {rep}: ransac {r['ransac_total_s']:.3f} s (models "
              f"{r['ransac_models_s']:.3f}, score {r['ransac_score_s']:.3f}, misc "
              f"{r['ransac_misc_s']:.3f}), ba {r['ba_total_s']:.3f} s (init "
              f"{r['ba_init_s']:.3f}, LM {r['ba_opt_s']:.3f}, iterations "
              f"{r['n_lm_iterations']}) over {r['n_groups']} group(s), "
              f"{r['n_objects_out']} objects out")
    steady = rows[-1]  # the first rep pays the library build and the allocator's growth
    print(f"\nsteady state: RANSAC {steady['ransac_total_s'] * 1e3:.1f} ms, BA "
          f"{steady['ba_total_s'] * 1e3:.1f} ms ({len(candidates)} candidates, "
          f"{args.n_views} views, {mesh_db.device})")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(dict(config=vars(args), device=str(mesh_db.device), rows=rows), f,
                      indent=2)
    return rows


if __name__ == "__main__":
    main()
