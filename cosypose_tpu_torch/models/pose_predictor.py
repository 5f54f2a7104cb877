"""Render-and-compare pose predictor, eval and train forward (port of
cosypose_tpu/models/pose_predictor.py).

One iteration: project the mesh points → DeepIM crop box → roi_align crop and
cropped intrinsics → render the object at the current pose in the crop frame
(the CUDA kernel on the card, its plain version on the CPU) → the backbone
(EfficientNet B0–B7, WideResNet-18/34, FlowNetS or CorrNet) on the observed ⊕
rendered stack (6 channels, or 9 with their difference) → pooling (global
average, plus spatial moments, second moments, a flattened 1×1-reduced grid
or Lucas-Kanade pyramid statistics) → linear pose head → image-space pose
update. `forward` loops it n times; outputs are stacked per iteration,
(n_iter, B, ...), with the JAX package's keys. `forward_train` is the same
loop with the net in train mode (batch-statistics BatchNorm, drop-connect,
optional activation checkpointing), the pose and the crop intrinsics
detached between iterations, as the JAX package's stop_gradient does; the
crop and the render carry no gradient.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.camera import boxes_from_uv, get_K_crop_resize, project_points_robust
from ..ops.cropping import deepim_crops
from ..ops.pose_ops import apply_imagespace_predictions
from ..ops.render import render
from ..ops.transforms import quat_to_matrix, rot6d_to_matrix
from ..utils.device import resolve_device
from ..utils.profiling import annotate, count
from .corrnet import CorrNet
from .efficientnet import DW_IMPLS, EfficientNet, frozen_stats, split_dw_impl
from .wide_resnet import FlowNetSEncoder, WideResNet18, WideResNet34

POOLINGS = ("gap", "moments", "scale", "flatten", "lk")
INPUT_MODES = ("obs+render", "obs+render+diff")
LK_LEVELS = (2, 4, 8)
FLATTEN_CHANNELS = 16
LN_EPS = 1e-6  # flax LayerNorm's
EFFICIENTNETS = tuple(f"efficientnet-b{i}" for i in range(8))


@dataclasses.dataclass(frozen=True)
class PosePredictorConfig:
    backbone: str = "efficientnet-b3"
    render_size: tuple[int, int] = (240, 320)
    pose_dim: int = 9                # 9: rot6d + vxvyvz; 7: quat xyzw + vxvyvz
    # '+'-joined from POOLINGS; global average pooling is always in
    pooling: str = "gap"
    input_mode: str = "obs+render"   # | 'obs+render+diff': 9 channels, + obs - render
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
        if self.backbone.startswith("efficientnet"):
            variant, dw_impl = split_dw_impl(self.backbone)
            # a mistyped suffix (e.g. '+dwdens') would otherwise run the default
            # grouped conv and time the wrong lowering
            if dw_impl not in DW_IMPLS:
                raise ValueError(f"unknown depthwise lowering {dw_impl!r} in {self.backbone!r}")
            if variant not in EFFICIENTNETS:
                raise ValueError(f"Unknown backbone {self.backbone}")
        elif self.backbone not in EFFICIENTNETS and not any(
                k in self.backbone for k in ("resnet18", "resnet34")) \
                and self.backbone not in ("flownet", "corrnet"):
            raise ValueError(f"Unknown backbone {self.backbone}")
        if not set(self.pooling.split("+")) <= set(POOLINGS):
            raise ValueError(f"Unknown pooling {self.pooling}")
        if self.input_mode not in INPUT_MODES:
            raise ValueError(f"Unknown input mode {self.input_mode}")
        if self.pose_dim not in (7, 9):
            raise ValueError(self.pose_dim)

    @property
    def in_channels(self) -> int:
        return 9 if self.input_mode == "obs+render+diff" else 6


def make_backbone(cfg: PosePredictorConfig) -> nn.Module:
    """The backbone a config names, for its input channels; it has
    n_features and n_halvings (its feature grid is the render size halved,
    rounding up, that many times)."""
    n_ch = cfg.in_channels
    if cfg.backbone.startswith("efficientnet"):
        variant, dw_impl = split_dw_impl(cfg.backbone)
        return EfficientNet(variant, in_channels=n_ch, dw_impl=dw_impl,
                            drop_connect_rate=cfg.drop_connect_rate)
    if "resnet34" in cfg.backbone:
        return WideResNet34(in_channels=n_ch)
    if "resnet18" in cfg.backbone:
        return WideResNet18(in_channels=n_ch)
    if cfg.backbone == "flownet":
        return FlowNetSEncoder(in_channels=n_ch)
    return CorrNet(in_channels=n_ch)


def feature_grid(cfg: PosePredictorConfig, backbone: nn.Module) -> tuple[int, int]:
    h, w = cfg.render_size
    for _ in range(backbone.n_halvings):
        h, w = math.ceil(h / 2), math.ceil(w / 2)
    return h, w


def lk_pyramid_stats(x: torch.Tensor) -> torch.Tensor:
    """Pooled Lucas-Kanade statistics of the observed/rendered pair (x NCHW,
    channels 0:3 observed, 3:6 rendered), fp32: per level (average pools of
    lvl×lvl), per gradient (gx, gy of the render, central differences on the
    interior) and per basis (1, X, Y on a [-1, 1] grid), mean(diff·g·basis)
    over rsqrt(mean((g·basis)²) + 1e-8), each (B, 3). Returns (B, 18 ·
    len(LK_LEVELS)) in the JAX package's order."""
    obs, rend = x[:, 0:3].float(), x[:, 3:6].float()
    diff = obs - rend
    stats = []
    for lvl in LK_LEVELS:
        d, r = F.avg_pool2d(diff, lvl, lvl), F.avg_pool2d(rend, lvl, lvl)
        gy = 0.5 * (r[:, :, 2:, 1:-1] - r[:, :, :-2, 1:-1])
        gx = 0.5 * (r[:, :, 1:-1, 2:] - r[:, :, 1:-1, :-2])
        d = d[:, :, 1:-1, 1:-1]
        h, w = d.shape[-2:]
        Y = torch.linspace(-1.0, 1.0, h, device=x.device)[:, None]
        X = torch.linspace(-1.0, 1.0, w, device=x.device)[None, :]
        for g in (gx, gy):
            for basis in (torch.ones_like(X), X, Y):
                b = (d * g * basis).mean(dim=(2, 3))
                e = ((g * basis) ** 2).mean(dim=(2, 3))
                stats.append(b * torch.rsqrt(e + 1e-8))
    return torch.cat(stats, dim=-1)


def identity_pose_bias(pose_dim: int) -> torch.Tensor:
    """Head bias under which an untrained net outputs the identity update."""
    if pose_dim == 9:
        return torch.tensor([1, 0, 0, 0, 1, 0, 0, 0, 1], dtype=torch.float32)
    return torch.tensor([0, 0, 0, 1, 0, 0, 1], dtype=torch.float32)  # quat xyzw + v


class PoseNet(nn.Module):
    """Backbone + pooling + linear pose head (the pooling's reductions and the
    head in fp32)."""

    def __init__(self, cfg: PosePredictorConfig):
        super().__init__()
        self.cfg = cfg
        self.parts = cfg.pooling.split("+")
        self.backbone = make_backbone(cfg)
        n = self.backbone.n_features
        n_in = n * (1 + 2 * ("moments" in self.parts) + 2 * ("scale" in self.parts))
        if "flatten" in self.parts:
            h, w = feature_grid(cfg, self.backbone)
            self.flatten_reduce = nn.Conv2d(n, FLATTEN_CHANNELS, 1)
            self.flatten_ln = nn.LayerNorm(FLATTEN_CHANNELS * h * w, eps=LN_EPS)
            n_in += FLATTEN_CHANNELS * h * w
        if "lk" in self.parts:
            self.lk_ln = nn.LayerNorm(18 * len(LK_LEVELS), eps=LN_EPS)
            n_in += 18 * len(LK_LEVELS)
        self.pose_fc = nn.Linear(n_in, cfg.pose_dim)
        gain = torch.ones(cfg.pose_dim)
        vx0 = 6 if cfg.pose_dim == 9 else 4
        gain[vx0:vx0 + 2] = cfg.vxvy_scale
        self.register_buffer("head_gain", gain, persistent=False)

    def pooled_features(self, x: torch.Tensor, drop_masks: list | None = None) -> torch.Tensor:
        """x (B, 6|9, H, W) → the pooled features the head reads (B, n_in),
        fp32. The moments' grids are in the features' dtype (bf16 under a
        bf16 config), as in the JAX package; the flatten grid is permuted to
        the JAX package's NHWC order before its LayerNorm."""
        dtype = self.cfg.compute_dtype
        with torch.autocast(x.device.type, dtype=dtype, enabled=dtype != torch.float32):
            feats = self.backbone(x) if drop_masks is None else self.backbone(x, drop_masks)
        pooled = [feats.float().mean(dim=(2, 3))]
        if "moments" in self.parts or "scale" in self.parts:
            h, w = feats.shape[-2:]
            fy = torch.linspace(-1.0, 1.0, h, device=x.device).to(feats.dtype)[:, None]
            fx = torch.linspace(-1.0, 1.0, w, device=x.device).to(feats.dtype)[None, :]
        if "moments" in self.parts:
            pooled += [(feats * fx).float().mean(dim=(2, 3)),
                       (feats * fy).float().mean(dim=(2, 3))]
        if "scale" in self.parts:
            pooled += [(feats * fx * fx).float().mean(dim=(2, 3)),
                       (feats * fy * fy).float().mean(dim=(2, 3))]
        if "flatten" in self.parts:
            red = self.flatten_reduce(feats.float()).permute(0, 2, 3, 1)
            pooled.append(self.flatten_ln(red.reshape(red.shape[0], -1)))
        if "lk" in self.parts:
            pooled.append(self.lk_ln(lk_pyramid_stats(x)))
        return torch.cat(pooled, dim=-1)

    def forward(self, x: torch.Tensor, drop_masks: list | None = None) -> torch.Tensor:
        """x (B, 6|9, H, W) → pose outputs (B, pose_dim) fp32; drop_masks: the
        backbone's drop-connect masks (EfficientNet in train mode), see
        EfficientNet.forward."""
        with annotate("cosypose.model.backbone"):
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

    def crop(self, mesh_data: dict, images, K, TCO_input):
        """The DeepIM crop of one iteration: (images_crop (B,3,h,w), K_crop,
        boxes_rend, boxes_crop)."""
        cfg = self.cfg
        with annotate("cosypose.model.crop"):
            crop_points = mesh_data["crop_points"]
            boxes_rend = boxes_from_uv(project_points_robust(crop_points, K, TCO_input))
            boxes_crop, images_crop = deepim_crops(images, boxes_rend, K, TCO_input,
                                                   crop_points, output_size=cfg.render_size,
                                                   lamb=cfg.lamb)
            K_crop = get_K_crop_resize(K, boxes_crop, images.shape[-2:], cfg.render_size)
            return images_crop, K_crop, boxes_rend, boxes_crop

    def network_input(self, mesh_data: dict, images, K, TCO_input):
        """Crop and render for one iteration: (x (B,6|9,h,w) observed ⊕
        rendered (⊕ their difference), K_crop, boxes_rend, boxes_crop)."""
        cfg = self.cfg
        images_crop, K_crop, boxes_rend, boxes_crop = self.crop(mesh_data, images, K, TCO_input)
        rows = TCO_input.shape[0]
        with annotate("cosypose.model.render", rows=rows,
                      pixels=rows * cfg.render_size[0] * cfg.render_size[1]):
            rendered = render(mesh_data["tri_verts"], mesh_data["tri_valid"], TCO_input, K_crop,
                              image_size=cfg.render_size, colors=mesh_data.get("tri_colors"),
                              tile=cfg.raster_tile,
                              max_tris_per_tile=cfg.raster_max_tris_per_tile).rgb
        parts = [images_crop, rendered]
        if cfg.input_mode == "obs+render+diff":
            parts.append(images_crop - rendered)
        return torch.cat(parts, dim=1), K_crop, boxes_rend, boxes_crop

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

    def update_pose(self, TCO_input, K_crop, pose_outputs):
        """The image-space pose update of one iteration's head outputs."""
        with annotate("cosypose.model.update"):
            if self.cfg.pose_dim == 9:
                dR, v = rot6d_to_matrix(pose_outputs[:, 0:6]), pose_outputs[:, 6:9]
            else:
                dR, v = quat_to_matrix(pose_outputs[:, 0:4]), pose_outputs[:, 4:7]
            return apply_imagespace_predictions(TCO_input, K_crop, v, dR)

    def _iteration(self, mesh_data: dict, images, K, TCO_input, train: bool = False,
                   drop_masks: list | None = None):
        count("iterations")
        with annotate("cosypose.model.iteration"):
            with torch.no_grad():  # crop and render: no gradient (K_crop detached)
                x, K_crop, boxes_rend, boxes_crop = self.network_input(mesh_data, images, K,
                                                                       TCO_input)
            pose_outputs = self._net_train(x, drop_masks) if train else self.net(x)
            TCO_output = self.update_pose(TCO_input, K_crop, pose_outputs)
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
        is one list of the backbone's draw_drop_masks per iteration, or None
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
