"""Export of trained pose models as torch.export artifacts (port of
cosypose_tpu/serving/export.py).

A trained refiner (or coarse model) exports with its weights, its mesh
geometry and the whole render-and-compare loop baked in, as ONE
`torch.export` program saved with `torch.export.save`. It is specialised to
one candidate batch B, one image size and one number of iterations, as the
JAX artifact is, and is called as

    refined = fn(images, K, TCO_init, label_ids)   # (B,4,4) poses

with images (B,3,H,W) float32, K (B,3,3) float32, TCO_init (B,4,4) float32
and label_ids (B,) integer. The program runs the same ATen ops as the eager
`PosePredictor.forward` and calls the port's kernels as registered operators:
`cosypose::raster_setup` and `cosypose::raster_resolve`, one each an
iteration, and on the card `cosypose::dw_bn_silu_squeeze`, once an MBConv
block. So where the JAX artifact needs only jax, a process that loads this
one imports the operators' modules, `cosypose_tpu_torch.ops.rasterizer_cuda`
and `cosypose_tpu_torch.ops.depthwise_cuda` (which register them), and
nothing else of the port: no checkpoint, no mesh files.

Exported on the model's device; `load_exported(..., device=)` moves the
program to another device (`torch.export.passes.move_to_device_pass`).
"""

from __future__ import annotations

import io
import logging
import pathlib

import torch
from torch import nn

from ..ops import depthwise_cuda, rasterizer_cuda  # noqa: F401  (register the operators)
from ..utils.device import resolve_device

logger = logging.getLogger(__name__)

__all__ = ["export_pose_model", "load_exported"]

MESH_KEYS = ("tri_verts", "tri_colors", "tri_valid", "crop_points")


class ServedPoseModel(nn.Module):
    """The exported module: a LoadedPoseModel's PoseNet, and its mesh
    database gathered for every object as buffers (the crop points chosen
    once, as gather_mesh_data chooses them), looked up by label id."""

    def __init__(self, model, n_iterations: int):
        super().__init__()
        from ..models.pose_predictor import gather_mesh_data

        self.predictor = model.predictor
        self.net = model.predictor.net
        self.n_iterations = n_iterations
        every = torch.arange(len(model.mesh_db.labels), device=model.device)
        for k, v in gather_mesh_data(model.mesh_db, every,
                                     model.predictor.cfg.n_points_crop).items():
            self.register_buffer(k, v.contiguous())

    def forward(self, images, K, TCO_init, label_ids):
        ids = label_ids.long()
        mesh_data = {k: getattr(self, k)[ids] for k in MESH_KEYS}
        return self.predictor._loop(mesh_data, images, K, TCO_init, self.n_iterations, False,
                                    None)["TCO_final"]


def export_pose_model(model, batch_size: int, image_hw, n_iterations: int = 1, out_path=None):
    """Export a LoadedPoseModel's n-iteration eval forward on its device.

    model: integrated.pose_predictor.LoadedPoseModel (weights + mesh_db).
    batch_size: the fixed candidate batch B (callers pad, as
        CoarseRefinePosePredictor.batched_model_predictions does).
    image_hw: (H, W) of the full input frames.

    Returns the saved program's bytes; writes them to out_path when given.
    """
    h, w = image_hw
    dev = model.device
    module = ServedPoseModel(model, n_iterations).eval()
    args = (torch.zeros(batch_size, 3, h, w, device=dev),
            torch.eye(3, device=dev).expand(batch_size, 3, 3).contiguous(),
            torch.eye(4, device=dev).expand(batch_size, 4, 4).contiguous(),
            torch.zeros(batch_size, dtype=torch.int64, device=dev))
    with torch.no_grad():
        program = torch.export.export(module, args)
    program.example_inputs = None  # else saved with it: 0.47 GB of frames at B=128, 480x640
    buf = io.BytesIO()
    torch.export.save(program, buf)
    blob = buf.getvalue()
    logger.info(f"exported pose model: B={batch_size} {h}x{w} iters={n_iterations} on {dev} "
                f"({len(blob) / 1e6:.1f} MB)")
    if out_path is not None:
        out_path = pathlib.Path(out_path)
        out_path.parent.mkdir(parents=True, exist_ok=True)
        out_path.write_bytes(blob)
        logger.info(f"wrote {out_path}")
    return blob


def program_device(program) -> torch.device:
    """The device of an exported program's weights and buffers."""
    for t in (*program.state_dict.values(), *program.constants.values()):
        if isinstance(t, torch.Tensor):
            return t.device
    raise ValueError("the exported program holds no tensor")


def load_exported(path_or_bytes, device: str | torch.device = "cuda"):
    """Load an exported artifact onto `device` (moved there if it was
    exported elsewhere); returns fn(images, K, TCO_init, label_ids) ->
    TCO_refined (B,4,4), taking arrays or tensors on any device."""
    from torch.export.passes import move_to_device_pass

    device = resolve_device(device)
    blob = (path_or_bytes if isinstance(path_or_bytes, (bytes, bytearray))
            else pathlib.Path(path_or_bytes).read_bytes())
    program = torch.export.load(io.BytesIO(blob))
    if program_device(program) != device:
        program = move_to_device_pass(program, device)
    module = program.module()

    def fn(images, K, TCO_init, label_ids):
        def f32(x):
            return torch.as_tensor(x, dtype=torch.float32, device=device)

        with torch.no_grad():
            return module(f32(images), f32(K), f32(TCO_init),
                          torch.as_tensor(label_ids, dtype=torch.int64, device=device))

    return fn
