"""Render-and-compare pose predictor, eval and train forward (port of
cosypose_tpu/models/pose_predictor.py).

One iteration: project the mesh points → DeepIM crop box → roi_align crop and
cropped intrinsics → render the object at the current pose in the crop frame
(the CUDA kernel on the card, its plain version on the CPU) → EfficientNet on
the 6-channel observed ⊕ rendered stack → global average pool → linear pose
head → image-space pose update. `forward` loops it n times; outputs are
stacked per iteration, (n_iter, B, ...), with the JAX package's keys.
`forward_train` is the same loop with the net in train mode (batch-statistics
BatchNorm, drop-connect, optional activation checkpointing), the pose and
the crop intrinsics detached between iterations, as the JAX package's
stop_gradient does; the crop and the render carry no gradient.

Out of this port so far: the other backbones, the moments/scale/flatten/lk
poolings and input_mode 'obs+render+diff'.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.camera import boxes_from_uv, get_K_crop_resize, project_points_robust
from ..ops.cropping import deepim_crops
from ..ops.pose_ops import apply_imagespace_predictions
from ..ops.render import render
from ..ops.transforms import quat_to_matrix, rot6d_to_matrix
from ..utils.device import resolve_device
from .efficientnet import EfficientNet, frozen_stats


@dataclasses.dataclass(frozen=True)
class PosePredictorConfig:
    backbone: str = "efficientnet-b3"
    render_size: tuple[int, int] = (240, 320)
    pose_dim: int = 9                # 9: rot6d + vxvyvz; 7: quat xyzw + vxvyvz
    vxvy_scale: float = 1.0          # output gain on the vx/vy head
    n_points_crop: int = 2000        # points projected for the crop box
    lamb: float = 1.4                # DeepIM crop margin
    compute_dtype: torch.dtype = torch.float32  # torch.bfloat16: backbone under autocast
    raster_tile: tuple[int, int] = (16, 32)     # kernel tile (rows, cols), swept on an H100
    raster_max_tris_per_tile: int = 1024        # binning budget per tile
    head_init_scale: float = 0.0     # 0: zero pose kernel; >0: variance_scaling(fan_in)
    drop_connect_rate: float = 0.2   # EfficientNet stochastic depth, train mode only
    # recompute the net's activations in backward (torch.utils.checkpoint).
    # Off by default, unlike the JAX package (which fits a 16 GB TPU with
    # it): on an H100 80GB the full-width tless-refiner step (B3 fp32, batch
    # 32, 3 iterations) peaks at 25.5 GiB without it and 8.8 GiB with it,
    # and takes 1.9x as long with it (chip_smoke.py phase 5, PERF.md)
    remat: bool = False

    def __post_init__(self):
        if not self.backbone.startswith("efficientnet-b") or "+" in self.backbone:
            raise ValueError(f"backbone {self.backbone!r} is not ported")
        if self.pose_dim not in (7, 9):
            raise ValueError(self.pose_dim)


def identity_pose_bias(pose_dim: int) -> torch.Tensor:
    """Head bias under which an untrained net outputs the identity update."""
    if pose_dim == 9:
        return torch.tensor([1, 0, 0, 0, 1, 0, 0, 0, 1], dtype=torch.float32)
    return torch.tensor([0, 0, 0, 1, 0, 0, 1], dtype=torch.float32)  # quat xyzw + v


class PoseNet(nn.Module):
    """Backbone + global average pool + linear pose head (the head in fp32)."""

    def __init__(self, cfg: PosePredictorConfig):
        super().__init__()
        self.cfg = cfg
        self.backbone = EfficientNet(cfg.backbone, in_channels=6,
                                     drop_connect_rate=cfg.drop_connect_rate)
        self.pose_fc = nn.Linear(self.backbone.n_features, cfg.pose_dim)
        gain = torch.ones(cfg.pose_dim)
        vx0 = 6 if cfg.pose_dim == 9 else 4
        gain[vx0:vx0 + 2] = cfg.vxvy_scale
        self.register_buffer("head_gain", gain, persistent=False)

    def pooled_features(self, x: torch.Tensor, drop_masks: list | None = None) -> torch.Tensor:
        """x (B, 6, H, W) → globally average-pooled features (B, n_features) fp32."""
        dtype = self.cfg.compute_dtype
        with torch.autocast(x.device.type, dtype=dtype, enabled=dtype != torch.float32):
            feats = self.backbone(x, drop_masks)
        return feats.float().mean(dim=(2, 3))

    def forward(self, x: torch.Tensor, drop_masks: list | None = None) -> torch.Tensor:
        """x (B, 6, H, W) → pose outputs (B, pose_dim) fp32; drop_masks: the
        backbone's drop-connect masks (train mode), see EfficientNet.forward."""
        out = self.pose_fc(self.pooled_features(x, drop_masks))
        return out * self.head_gain if self.cfg.vxvy_scale != 1.0 else out


@torch.no_grad()
def init_weights(net: PoseNet, generator: torch.Generator) -> None:
    """Seeded init: lecun-normal convs, zero conv biases, identity BatchNorm,
    identity pose bias, and a pose kernel that is zero (the untrained head
    leaves TCO unchanged) or, with head_init_scale > 0, flax's
    variance_scaling(head_init_scale, "fan_in", "truncated_normal")."""
    for m in net.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.weight[0].numel()
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator) / fan_in ** 0.5)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
    fc, scale = net.pose_fc, net.cfg.head_init_scale
    if scale > 0:
        # the std of a unit normal truncated to [-2, 2] is 0.8796...
        std = (scale / fc.in_features) ** 0.5 / 0.87962566103423978
        w = torch.empty(fc.weight.shape)
        nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)
        fc.weight.copy_(w)
    else:
        fc.weight.zero_()
    fc.bias.copy_(identity_pose_bias(net.cfg.pose_dim))


class PosePredictor:
    """Config + PoseNet on one device, and the n-iteration eval forward.

    Usage:
        pp = PosePredictor(cfg, device="cuda", generator=torch.Generator().manual_seed(0))
        outputs = pp.forward(mesh_data, images, K, TCO_init, n_iterations)
    """

    def __init__(self, cfg: PosePredictorConfig, device: str | torch.device = "cuda",
                 generator: torch.Generator | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.net = PoseNet(cfg)
        init_weights(self.net, generator or torch.Generator().manual_seed(0))
        self.net.to(self.device).eval()

    def network_input(self, mesh_data: dict, images, K, TCO_input):
        """Crop and render for one iteration: (x (B,6,h,w) observed ⊕ rendered,
        K_crop, boxes_rend, boxes_crop)."""
        cfg = self.cfg
        crop_points = mesh_data["crop_points"]
        boxes_rend = boxes_from_uv(project_points_robust(crop_points, K, TCO_input))
        boxes_crop, images_crop = deepim_crops(images, boxes_rend, K, TCO_input, crop_points,
                                               output_size=cfg.render_size, lamb=cfg.lamb)
        K_crop = get_K_crop_resize(K, boxes_crop, images.shape[-2:], cfg.render_size)
        rendered = render(mesh_data["tri_verts"], mesh_data["tri_valid"], TCO_input, K_crop,
                          image_size=cfg.render_size, colors=mesh_data.get("tri_colors"),
                          tile=cfg.raster_tile,
                          max_tris_per_tile=cfg.raster_max_tris_per_tile).rgb
        return torch.cat([images_crop, rendered], dim=1), K_crop, boxes_rend, boxes_crop

    def _net_train(self, x: torch.Tensor, drop_masks: list | None) -> torch.Tensor:
        """The net in train mode on x, its activations recomputed in backward
        when cfg.remat (torch.utils.checkpoint). The replay keeps the masks it
        was given and leaves the BatchNorm running statistics alone, so they
        move once a forward, as in the JAX package's jax.checkpoint."""
        if not self.cfg.remat:
            return self.net(x, drop_masks)
        calls = []

        def run(x):
            if calls:  # the replay in backward
                with frozen_stats(self.net):
                    return self.net(x, drop_masks)
            calls.append(1)
            return self.net(x, drop_masks)

        return checkpoint(run, x, use_reentrant=False, preserve_rng_state=False)

    def _iteration(self, mesh_data: dict, images, K, TCO_input, train: bool = False,
                   drop_masks: list | None = None):
        cfg = self.cfg
        with torch.no_grad():  # crop and render: no gradient (K_crop detached)
            x, K_crop, boxes_rend, boxes_crop = self.network_input(mesh_data, images, K,
                                                                   TCO_input)
        pose_outputs = self._net_train(x, drop_masks) if train else self.net(x)
        if cfg.pose_dim == 9:
            dR, v = rot6d_to_matrix(pose_outputs[:, 0:6]), pose_outputs[:, 6:9]
        else:
            dR, v = quat_to_matrix(pose_outputs[:, 0:4]), pose_outputs[:, 4:7]
        TCO_output = apply_imagespace_predictions(TCO_input, K_crop, v, dR)
        return TCO_output, dict(TCO_input=TCO_input, TCO_output=TCO_output, K_crop=K_crop,
                                pose_outputs=pose_outputs, boxes_rend=boxes_rend,
                                boxes_crop=boxes_crop)

    @torch.inference_mode()
    def forward(self, mesh_data: dict, images: torch.Tensor, K: torch.Tensor,
                TCO_init: torch.Tensor, n_iterations: int = 1) -> dict:
        """n_iterations of render-and-compare.

        mesh_data: {tri_verts (B,F,3,3), tri_colors (B,F,3,3), tri_valid (B,F),
        crop_points (B,P,3)}; images (B,3,H,W) in [0,1]; K (B,3,3);
        TCO_init (B,4,4); all on the predictor's device. Returns
        {TCO_input, TCO_output, K_crop, pose_outputs, boxes_rend, boxes_crop}
        each stacked (n_iter, B, ...), plus TCO_final (B,4,4).
        """
        self.net.eval()
        return self._loop(mesh_data, images, K, TCO_init, n_iterations, False, None)

    def forward_train(self, mesh_data: dict, images: torch.Tensor, K: torch.Tensor,
                      TCO_init: torch.Tensor, n_iterations: int = 1,
                      drop_masks: list | None = None) -> dict:
        """n_iterations of render-and-compare with the net in train mode, the
        pose detached between iterations. Inputs as for `forward`; drop_masks
        is one list of EfficientNet.draw_drop_masks per iteration, or None
        for no drop-connect. Returns forward's outputs; pose_outputs and
        TCO_output carry the gradient to the net's parameters, and the
        BatchNorm running statistics have moved once per iteration."""
        self.net.train()
        return self._loop(mesh_data, images, K, TCO_init, n_iterations, True, drop_masks)

    def _loop(self, mesh_data, images, K, TCO_init, n_iterations, train, drop_masks):
        for name, t in [("images", images), ("K", K), ("TCO_init", TCO_init),
                        *mesh_data.items()]:
            if t.device != self.device:
                raise ValueError(f"{name} is on {t.device}, the predictor on {self.device}")
        TCO = TCO_init
        steps = []
        for n in range(n_iterations):
            TCO, out = self._iteration(mesh_data, images, K, TCO.detach(), train,
                                       None if drop_masks is None else drop_masks[n])
            steps.append(out)
        outs = {k: torch.stack([s[k] for s in steps]) for k in steps[0]}
        outs["TCO_final"] = TCO
        return outs


def gather_mesh_data(mesh_db, label_ids: torch.Tensor, n_points_crop: int = 2000) -> dict:
    """Per-candidate mesh tensors from a BatchedMeshes, keyed by integer ids.

    The crop-point ids are the JAX package's: RandomState(0).choice(P, n,
    replace=False).
    """
    P = mesh_db.points.shape[1]
    rng = np.random.RandomState(0)
    ids = torch.as_tensor(rng.choice(P, size=min(n_points_crop, P), replace=False),
                          device=mesh_db.device)
    return dict(
        tri_verts=mesh_db.tri_verts[label_ids],
        tri_colors=mesh_db.tri_colors[label_ids],
        tri_valid=mesh_db.tri_valid[label_ids],
        crop_points=mesh_db.points[:, ids][label_ids],
    )
