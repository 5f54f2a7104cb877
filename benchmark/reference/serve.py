"""The plain reference of CosyPose's single-frame inference: box-seeded z-up
init, then for each model its iterations of crop → render → network → pose
update, row by row in blocks.

It reads the benchmark's inputs (meshes, weights, frames, boxes) and nothing
the program made: it decimates the render meshes, picks the crop points and
gathers the rows itself.
"""

from __future__ import annotations

import numpy as np
import torch

from . import geometry as g
from .efficientnet import Net
from .raster import render


class Objects:
    """The configuration's objects as the reference uses them: full-detail
    points (metres) and the decimated render triangles, padded to one count."""

    def __init__(self, meshes: list, render_faces: int, n_points: int, device):
        self.points, tris, cols = [], [], []
        for m in meshes:
            v = m["verts"] * 1e-3
            self.points.append(torch.as_tensor(v.astype(np.float32), device=device))
            rv, rf, rc = g.decimate(v, m["faces"], m["colors"], render_faces)
            tris.append(rv.astype(np.float32)[rf])
            cols.append(rc.astype(np.float32)[rf])
        F = max(t.shape[0] for t in tris)
        self.tri = torch.zeros(len(meshes), F, 3, 3, device=device)
        self.col = torch.zeros(len(meshes), F, 3, 3, device=device)
        self.valid = torch.zeros(len(meshes), F, dtype=torch.bool, device=device)
        for k, (t, c) in enumerate(zip(tris, cols)):
            self.tri[k, :len(t)] = torch.as_tensor(t, device=device)
            self.col[k, :len(c)] = torch.as_tensor(c, device=device)
            self.valid[k, :len(t)] = True
        self.faces = [len(t) for t in tris]
        ids = g.sample_ids(self.points[0].shape[0], n_points)
        self.ids = torch.as_tensor(ids, device=device)

    def subset(self, labels: torch.Tensor) -> torch.Tensor:
        """The fixed crop/init point subset of each row's object (B,P,3)."""
        return torch.stack([self.points[int(k)][self.ids] for k in labels])


@torch.no_grad()
def first_inputs(objects: Objects, images, K, labels, cfg: dict, boxes=None, T=None):
    """The network inputs (B,6,h,w) of rows at the poses T, or at the
    box-seeded init where boxes are given: the crop there and the render."""
    pts = objects.subset(labels)
    if T is None:
        T = g.init_zup_autodepth(boxes, pts, K)
    crops, Kc, _, _ = g.crop(images, None, K, T, pts, cfg["render_size"], cfg["lamb"])
    rgb, _ = render(objects.tri[labels], objects.valid[labels], T, Kc, cfg["render_size"],
                    objects.col[labels])
    return torch.cat([crops, rgb], 1)


@torch.no_grad()
def serve(objects: Objects, nets: list, stages: list, images, K, boxes, labels, cfg: dict,
          dtype, inputs: list | None = None, block: int = 64) -> dict:
    """Rows (each its own image (B,3,H,W), K, box and object index) through
    the models: `nets` one Net per model, `stages` the number of iterations
    of each. Returns {init (B,4,4), poses, K_crop, boxes_crop: lists over the
    iterations of all models, in order}. With `inputs` (a list over the
    iterations of (B,4,4) or None), each iteration with a pose given there
    starts from it in place of the previous iteration's output."""
    keys = ("inputs", "poses", "K_crop", "boxes_crop")
    out = {"init": [], **{k: [] for k in keys}}
    for s in range(0, len(labels), block):
        sl = slice(s, s + block)
        lab, img, Kb = labels[sl], images[sl], K[sl]
        pts = objects.subset(lab)
        T = g.init_zup_autodepth(boxes[sl], pts, Kb)
        rows = {"init": T, **{k: [] for k in keys}}
        it = 0
        for net, n_it in zip(nets, stages):
            for _ in range(n_it):
                if inputs is not None and inputs[it] is not None:
                    T = inputs[it][sl].to(Kb.device)
                it += 1
                rows["inputs"].append(T)
                crops, Kc, _, bc = g.crop(img, None, Kb, T, pts, cfg["render_size"], cfg["lamb"])
                rgb, _ = render(objects.tri[lab], objects.valid[lab], T, Kc, cfg["render_size"],
                                objects.col[lab])
                T = g.update_pose(T, Kc, net(torch.cat([crops, rgb], 1), dtype))
                for k, v in (("poses", T), ("K_crop", Kc), ("boxes_crop", bc)):
                    rows[k].append(v)
        out["init"].append(rows["init"])
        for k in keys:
            out[k].append(torch.stack(rows[k]))
    return {"init": torch.cat(out["init"]),
            **{k: list(torch.cat(out[k], dim=1).unbind(0)) for k in keys}}


def nets_for(weights: list, variant: str, quant=None) -> list:
    return [Net(w, variant, quant=quant) for w in weights]
