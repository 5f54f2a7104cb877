"""Entry points of the port (the counterpart of the repo's __graft_entry__.py).

entry()           — one refiner forward on the flagship model, on the card:
                    EfficientNet-B3 (fp32), B=4, one iteration, the demo
                    spheres at the mesh database's default LOD and
                    `demo.make_inputs(4)`:

                        fn, args = entry()          # entry(device="cpu") on the host
                        TCO_final = fn(*args)       # (4, 4, 4)

                    args = (predictor, images, K, TCO, label_ids), all on the
                    device; the predictor holds the weights (the port's seeded
                    init: a zero pose kernel, as the JAX init's).
dryrun_multichip  — one data-parallel train step on N gloo ranks of the CPU
                    (parallel/dryrun.py).
"""

from __future__ import annotations

import torch

from . import demo
from .models.pose_predictor import PosePredictor, PosePredictorConfig, gather_mesh_data
from .ops.mesh_db import build_mesh_db
from .parallel.dryrun import dryrun_multichip
from .utils.device import resolve_device

__all__ = ["dryrun_multichip", "entry", "refiner_fn"]


def refiner_fn(mesh_db, cfg: PosePredictorConfig, n_iterations: int):
    """fn(predictor, images, K, TCO, label_ids) -> TCO_final (B,4,4): the mesh
    data of the labels gathered from `mesh_db`, then n_iterations of the
    predictor's eval forward (the path serving runs)."""

    def fn(pp: PosePredictor, images, K, TCO, label_ids):
        mesh_data = gather_mesh_data(mesh_db, label_ids.long(), cfg.n_points_crop)
        return pp.forward(mesh_data, images, K, TCO, n_iterations=n_iterations)["TCO_final"]

    return fn


def entry(device: str | torch.device = "cuda"):
    """(fn, args): one refiner forward on the flagship model, args on `device`."""
    dev = resolve_device(device)
    cfg = PosePredictorConfig(backbone="efficientnet-b3")
    pp = PosePredictor(cfg, device=dev)
    mesh_db = build_mesh_db(demo.demo_specs(), device=dev)
    images, K, TCO, label_ids = (torch.as_tensor(a, device=dev) for a in demo.make_inputs(4))
    return refiner_fn(mesh_db, cfg, 1), (pp, images, K, TCO, label_ids)
