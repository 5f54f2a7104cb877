"""Scene-level and batch rendering on the raster kernels (port of
cosypose_tpu/rendering/scene_renderer.py).

  * BatchRenderer: one object per batch item at TCO under K, through render()
    with the tile and budget the JAX package's accelerator path uses for it
    (ops/render.py: (24, 320), 768 triangles).
  * SceneRenderer: several posed objects per camera. Objects are composed on
    the host into ONE world-frame triangle soup (each object's corners moved
    by its TWO in float32 numpy, as the JAX package does), and all cameras
    render it in one render(..., tri_attr=instance ids) call: the attribute
    variant of the resolve kernel, with depth-buffered occlusion and exact
    instance-id masks in the same pass. Tile (8, 320) and budget
    min(F, 6144), as on the JAX package's accelerator. rgb, ids and depth are
    quantized on the device (uint8 rgb, uint8 ids, whole-millimetre depth).

The soup is padded to whole chunks of 8 rows only: the JAX package's
power-of-two buckets exist to spare XLA recompiles, which PyTorch does not
have. A soup may hold any number of rows (a ycbv-1M scene of 8 objects of
8,192 faces and the cage: 65,896): kernel A sorts it with a cluster of
blocks or in runs, kernel B streams it through shared memory in windows
(ops/rasterizer_cuda.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.rasterizer_cuda import padded_rows
from ..ops.render import render
from ..ops.transforms import invert_T

SCENE_TILE = (8, 320)
SCENE_BUDGET = 6144
OBJECT_TILE = (24, 320)
OBJECT_BUDGET = 768


def render_scene_batch(tri_verts, tri_valid, colors, inst_ids, TWCs, Ks, image_size):
    """One world-frame soup (F, ...) seen by n cameras (TWCs (n,4,4), Ks
    (n,3,3)), in one render call; outputs quantized on the device: rgb
    (n,3,H,W) uint8, instance ids (n,H,W) uint8, depth (n,H,W) int32 in
    whole millimetres (0..65535). Each float is clipped to its range before
    the cast, which truncates as the JAX package's astype does."""
    n = TWCs.shape[0]

    def bc(x):
        return x[None].expand(n, *x.shape)

    budget = min(int(tri_verts.shape[0]), SCENE_BUDGET)
    out = render(bc(tri_verts), bc(tri_valid), invert_T(TWCs), Ks, image_size=image_size,
                 colors=bc(colors), tile=SCENE_TILE, max_tris_per_tile=budget,
                 tri_attr=bc(inst_ids))
    rgb8 = (out.rgb * 255.0).clamp(0, 255).to(torch.uint8)
    inst8 = (out.attr + 0.5).clamp(0, 255).to(torch.uint8)
    depth16 = (out.depth * 1000.0).clamp(0, 65535).to(torch.int32)
    return rgb8, inst8, depth16


class BatchRenderer:
    """render(obj label ids, TCO, K) → RGB/depth/mask, one object per item."""

    def __init__(self, mesh_db, resolution=(240, 320)):
        self.mesh_db = mesh_db
        self.resolution = resolution

    def render(self, label_ids, TCO, K, resolution=None, render_depth=False):
        db = self.mesh_db
        res = tuple(resolution or self.resolution)
        ids = torch.as_tensor(np.asarray(label_ids), dtype=torch.long, device=db.device)
        out = render(db.tri_verts[ids], db.tri_valid[ids],
                     torch.as_tensor(TCO, dtype=torch.float32, device=db.device),
                     torch.as_tensor(K, dtype=torch.float32, device=db.device),
                     image_size=res, colors=db.tri_colors[ids], tile=OBJECT_TILE,
                     max_tris_per_tile=OBJECT_BUDGET)
        return out if render_depth else out.rgb


class SceneRenderer:
    """Render full scenes: lists of posed objects seen by posed cameras."""

    def __init__(self, mesh_db):
        self.mesh_db = mesh_db
        # host copies of the render geometry: the soup is composed on the host
        self.tri_verts = mesh_db.tri_verts.cpu().numpy()
        self.tri_valid = mesh_db.tri_valid.cpu().numpy()
        self.tri_colors = mesh_db.tri_colors.cpu().numpy()

    def soup(self, obj_infos):
        """(tri_verts (F,3,3), tri_valid (F,), colors (F,3,3), instance ids
        (F,) int32) of the scene in the world frame, padded to whole chunks."""
        tri_verts_l, tri_valid_l, colors_l, inst_l = [], [], [], []
        n_fg = 0
        for obj in obj_infos:
            if "geometry" in obj:
                g = obj["geometry"]
                tv_w = np.asarray(g["tri_verts"], np.float32)
                tri_verts_l.append(tv_w)
                tri_valid_l.append(np.ones(tv_w.shape[0], bool))
                colors_l.append(np.asarray(g["colors"], np.float32))
                inst_l.append(np.full(tv_w.shape[0], obj.get("instance_id", 0), np.int32))
                continue
            n_fg += 1
            oid = self.mesh_db.label_to_id[obj["label"]]
            TWO = np.asarray(obj["TWO"], np.float32)
            tv = self.tri_verts[oid]
            tri_verts_l.append(tv @ TWO[:3, :3].T + TWO[:3, 3])
            tri_valid_l.append(self.tri_valid[oid])
            colors_l.append(np.asarray(obj.get("colors", self.tri_colors[oid]), np.float32))
            inst_l.append(np.full(tv.shape[0], n_fg, np.int32))
        F = sum(len(v) for v in tri_valid_l)
        pad = padded_rows(F) - F
        tri_verts = np.pad(np.concatenate(tri_verts_l), ((0, pad), (0, 0), (0, 0)))
        tri_valid = np.pad(np.concatenate(tri_valid_l), (0, pad))
        colors = np.pad(np.concatenate(colors_l), ((0, pad), (0, 0), (0, 0)))
        inst_ids = np.pad(np.concatenate(inst_l), (0, pad))
        return tri_verts, tri_valid, colors, inst_ids

    def render_scene(self, obj_infos, cam_infos, render_depth=False, resolution=(240, 320)):
        """obj_infos: [{label, TWO (4,4)[, colors (F,3,3)]}] or [{geometry:
        {tri_verts, colors} (world frame)[, instance_id]}] (the cage, id 0 by
        default); cam_infos: [{K (3,3), TWC (4,4), resolution}]. Returns a
        list of per-camera dicts {rgb (H,W,3) float32, mask, instance_ids
        (H,W) int32 (0 = background)[, depth (H,W) float32]}.

        Cameras of one resolution render in one call and come back quantized
        (rgb in 1/255 steps, depth in whole millimetres), as in the JAX
        package; cameras of different resolutions render one call each.
        """
        dev = self.mesh_db.device
        tri_verts, tri_valid, colors, inst_ids = self.soup(obj_infos)

        def on_dev(a, dtype=torch.float32):
            return torch.as_tensor(a, dtype=dtype, device=dev)

        resolutions = [tuple(c.get("resolution", resolution)) for c in cam_infos]
        if len(set(resolutions)) == 1:
            Ks = np.stack([np.asarray(c["K"], np.float32) for c in cam_infos])
            TWCs = np.stack([np.asarray(c.get("TWC", np.eye(4)), np.float32) for c in cam_infos])
            rgb8, inst8, depth16 = render_scene_batch(
                on_dev(tri_verts), on_dev(tri_valid, torch.bool), on_dev(colors),
                on_dev(inst_ids), on_dev(TWCs), on_dev(Ks), resolutions[0])
            rgb_all = rgb8.cpu().numpy()
            attr_all = inst8.cpu().numpy().astype(np.int32)
            depth_all = depth16.cpu().numpy().astype(np.uint16) if render_depth else None
            outputs = []
            for i in range(len(cam_infos)):
                result = dict(rgb=rgb_all[i].transpose(1, 2, 0).astype(np.float32) / 255.0,
                              mask=attr_all[i] > 0, instance_ids=attr_all[i])
                if render_depth:
                    result["depth"] = depth_all[i].astype(np.float32) / 1000.0
                outputs.append(result)
            return outputs

        budget = min(int(tri_verts.shape[0]), SCENE_BUDGET)
        outputs = []
        for cam, res in zip(cam_infos, resolutions):
            TWC = on_dev(np.asarray(cam.get("TWC", np.eye(4)), np.float32)[None])
            out = render(on_dev(tri_verts[None]), on_dev(tri_valid[None], torch.bool),
                         invert_T(TWC), on_dev(np.asarray(cam["K"], np.float32)[None]),
                         image_size=res, colors=on_dev(colors[None]), tile=SCENE_TILE,
                         max_tris_per_tile=budget, tri_attr=on_dev(inst_ids[None]))
            result = dict(rgb=out.rgb[0].permute(1, 2, 0).cpu().numpy(),
                          mask=out.mask[0].cpu().numpy(),
                          instance_ids=np.rint(out.attr[0].cpu().numpy()).astype(np.int32))
            if render_depth:
                result["depth"] = out.depth[0].cpu().numpy()
            outputs.append(result)
        return outputs
