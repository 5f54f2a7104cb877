"""One data-parallel train step on N gloo ranks of the CPU at tiny shapes
(the port's `dryrun_multichip`, after the repo's __graft_entry__.py).

    python -m cosypose_tpu_torch.parallel.dryrun [N]

Two small UV-spheres (the second with a continuous symmetry), WideResNet-18
at 32x32 renders, remat off, one iteration, a global batch of 2 per rank
(each rank its rows), gt+noise input poses: the sharded step of the JAX
package's dryrun, with the gradients averaged by DDP and BatchNorm over the
global batch. Prints `dryrun_multichip(N): ok, loss=...` from rank 0.
"""

from __future__ import annotations

import math
import sys

import numpy as np
import torch

from ..demo import make_inputs, sphere_mesh
from ..models.pose_predictor import PosePredictorConfig
from ..ops.mesh_db import MeshSpec, build_mesh_db
from ..training.pose_training import PoseTrainConfig, create_train_state, draw_step, make_train_step
from .ddp import shard_batch
from .spawn import spawn


def dryrun_config(batch_size: int, epoch_size: int) -> PoseTrainConfig:
    """The dryrun's and the scaling bench's step: WideResNet-18, 32x32
    renders, tile (8, 32), budget 32, remat off, one iteration."""
    return PoseTrainConfig(
        predictor=PosePredictorConfig(backbone="wide-resnet18", render_size=(32, 32),
                                      n_points_crop=32, raster_tile=(8, 32),
                                      raster_max_tris_per_tile=32, remat=False),
        n_iterations=1, n_points_loss=32, batch_size=batch_size, epoch_size=epoch_size,
        input_generator="gt+noise")


def dryrun_specs() -> list[MeshSpec]:
    verts, faces = sphere_mesh(n_theta=8, n_phi=12)
    return [MeshSpec(label="obj_000001", vertices=verts * 1000.0, faces=faces),
            MeshSpec(label="obj_000002", vertices=verts * 1500.0, faces=faces,
                     symmetries_continuous=[{"axis": [0, 0, 1], "offset": [0, 0, 0]}])]


def dryrun_batch(B: int) -> dict:
    """A global batch of B 64x64 frames (demo.make_inputs, principal point
    at the centre, a fixed box)."""
    images, K, TCO, label_ids = make_inputs(B, 64, 64)
    K[:, 0, 2] = K[:, 1, 2] = 32.0
    return dict(images=images, K=K, TCO=TCO, label_ids=label_ids,
                bboxes=np.tile(np.asarray([20.0, 15.0, 45.0, 40.0], np.float32), (B, 1)))


def dryrun_rank(rank: int, world: int, device: torch.device) -> float:
    """One replicated data-parallel step on this rank; returns the global loss."""
    cfg = dryrun_config(world, 8 * world)
    state = create_train_state(cfg, device, param_mode="replicated")
    db = build_mesh_db(dryrun_specs(), device=device)
    B = 2 * world
    batch = {k: torch.as_tensor(v).to(device) for k, v in
             shard_batch(dryrun_batch(B), rank, world).items()}
    batch["label_ids"] = batch["label_ids"].long()
    draws = draw_step(cfg, state.pp, B, db.points.shape[1], torch.Generator().manual_seed(1),
                      rank, world)
    loss = float(make_train_step(cfg, db)(state, batch, draws)["loss_total"])
    if not math.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")
    return loss


def dryrun_multichip(n_ranks: int = 2) -> float:
    """The step on n_ranks spawned gloo ranks of the CPU; returns the loss."""
    losses = spawn(dryrun_rank, n_ranks, device="cpu", n_threads=1)
    if len(set(losses)) != 1:
        raise AssertionError(f"the ranks disagree on the global loss: {losses}")
    print(f"dryrun_multichip({n_ranks}): ok, loss={losses[0]:.4f}")
    return losses[0]


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
