"""Render-and-compare pose predictor, eval forward (port of
cosypose_tpu/models/pose_predictor.py).

One iteration: project the mesh points → DeepIM crop box → roi_align crop and
cropped intrinsics → render the object at the current pose in the crop frame
(the CUDA kernel on the card, its plain version on the CPU) → EfficientNet on
the 6-channel observed ⊕ rendered stack → global average pool → linear pose
head → image-space pose update. `forward` loops it n times; outputs are
stacked per iteration, (n_iter, B, ...), with the JAX package's keys.

Out of this port so far: the other backbones, the moments/scale/flatten/lk
poolings, input_mode 'obs+render+diff', head_init_scale and training.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from ..ops.camera import boxes_from_uv, get_K_crop_resize, project_points_robust
from ..ops.cropping import deepim_crops
from ..ops.pose_ops import apply_imagespace_predictions
from ..ops.render import render
from ..ops.transforms import quat_to_matrix, rot6d_to_matrix
from ..utils.device import resolve_device
from .efficientnet import EfficientNet


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
        self.backbone = EfficientNet(cfg.backbone, in_channels=6)
        self.pose_fc = nn.Linear(self.backbone.n_features, cfg.pose_dim)
        gain = torch.ones(cfg.pose_dim)
        vx0 = 6 if cfg.pose_dim == 9 else 4
        gain[vx0:vx0 + 2] = cfg.vxvy_scale
        self.register_buffer("head_gain", gain, persistent=False)

    def pooled_features(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, 6, H, W) → globally average-pooled features (B, n_features) fp32."""
        dtype = self.cfg.compute_dtype
        with torch.autocast(x.device.type, dtype=dtype, enabled=dtype != torch.float32):
            feats = self.backbone(x)
        return feats.float().mean(dim=(2, 3))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, 6, H, W) → pose outputs (B, pose_dim) fp32."""
        out = self.pose_fc(self.pooled_features(x))
        return out * self.head_gain if self.cfg.vxvy_scale != 1.0 else out


@torch.no_grad()
def init_weights(net: PoseNet, generator: torch.Generator) -> None:
    """Seeded init: lecun-normal convs, zero conv biases, identity BatchNorm,
    zero pose kernel + identity bias (the untrained head leaves TCO unchanged)."""
    for m in net.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.weight[0].numel()
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator) / fan_in ** 0.5)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
    net.pose_fc.weight.zero_()
    net.pose_fc.bias.copy_(identity_pose_bias(net.cfg.pose_dim))


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

    def _iteration(self, mesh_data: dict, images, K, TCO_input):
        cfg = self.cfg
        x, K_crop, boxes_rend, boxes_crop = self.network_input(mesh_data, images, K, TCO_input)
        pose_outputs = self.net(x)
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
        for name, t in [("images", images), ("K", K), ("TCO_init", TCO_init),
                        *mesh_data.items()]:
            if t.device != self.device:
                raise ValueError(f"{name} is on {t.device}, the predictor on {self.device}")
        TCO = TCO_init
        steps = []
        for _ in range(n_iterations):
            TCO, out = self._iteration(mesh_data, images, K, TCO)
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
