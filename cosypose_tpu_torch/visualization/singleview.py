"""Single-view prediction overlay (port of
cosypose_tpu/visualization/singleview.py): render a predicted pose through
the raster kernels (their plain versions for a mesh database on the CPU) and
blend it over the input image."""

from __future__ import annotations

import numpy as np
import torch

from ..ops.render import render


def render_prediction_overlay(mesh_db, rgb_input, TCO, K, label, alpha: float = 0.6):
    """rgb_input (H, W, 3) uint8; TCO (4,4); K (3,3); the object `label` of
    mesh_db, rendered on mesh_db's device → (H, W, 3) uint8."""
    H, W = rgb_input.shape[:2]
    oid = mesh_db.label_to_id[label]
    dev = mesh_db.device

    def one(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)[None]

    out = render(mesh_db.tri_verts[oid][None], mesh_db.tri_valid[oid][None], one(TCO), one(K),
                 image_size=(H, W), colors=mesh_db.tri_colors[oid][None])
    ren = out.rgb[0].permute(1, 2, 0).cpu().numpy()
    mask = out.mask[0].cpu().numpy()[..., None]
    inp = rgb_input.astype(np.float32) / 255.0
    overlay = np.where(mask, alpha * ren + (1 - alpha) * inp, inp)
    return (np.clip(overlay, 0, 1) * 255).astype(np.uint8)
