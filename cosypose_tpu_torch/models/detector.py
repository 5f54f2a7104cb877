"""CenterNet-style 2D detector (port of cosypose_tpu/models/detector.py).

A WideResNet-18/34 backbone (input zero-padded at the bottom and right to
the stride-32 grid) → three transposed-conv stages to stride 4 → heads: a
per-class centre heatmap (or, in cls_mode 'softmax', one objectness heatmap
and a dense softmax class head), box width/height, centre offset, and
YOLACT-style mask coefficients with their prototypes. The outputs are cropped
back to the input's stride-4 grid and returned channels-last, (B, Hm, Wm, D),
as in the JAX package, so the decoder flattens in its order.

`decode_detections` keeps 3x3 heatmap peaks and takes a fixed number of
detections an image by a stable descending sort (ties go to the lower flat
index, as lax.top_k does; torch.topk promises no order), then optionally
runs greedy same-class box NMS, vectorised over the batch.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from .efficientnet import BatchNorm2d
from .wide_resnet import WideResNet18, WideResNet34

NECK = (256, 128, 64)
HEAD_CH = 64
HEATMAP_BIAS = -2.19  # ≈ logit(0.1)


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    n_classes: int = 21
    backbone: str = "resnet18"       # | 'resnet34'
    max_detections: int = 64
    n_mask_protos: int = 16
    compute_dtype: torch.dtype = torch.float32  # torch.bfloat16: neck and backbone under autocast
    # 'percls': per-class sigmoid heatmaps; 'softmax': a class-agnostic
    # objectness heatmap and a softmax class head, two classes a peak
    cls_mode: str = "percls"

    def __post_init__(self):
        if self.backbone not in ("resnet18", "resnet34"):
            raise ValueError(self.backbone)
        if self.cls_mode not in ("percls", "softmax"):
            raise ValueError(self.cls_mode)


class DetectorHead(nn.Module):
    """Upsampling neck + CenterNet heads; module names are the JAX package's."""

    def __init__(self, cfg: DetectorConfig, in_ch: int):
        super().__init__()
        self.cfg = cfg
        for i, ch in enumerate(NECK):
            self.add_module(f"deconv{i}", nn.ConvTranspose2d(in_ch, ch, 4, stride=2, padding=1))
            self.add_module(f"deconv_bn{i}", BatchNorm2d(ch, eps=1e-5, flax_momentum=0.9))
            in_ch = ch
        self.heads = {"heatmap": 1 if cfg.cls_mode == "softmax" else cfg.n_classes, "wh": 2,
                      "offset": 2, "mask_coeffs": cfg.n_mask_protos,
                      "protos": cfg.n_mask_protos}
        if cfg.cls_mode == "softmax":
            self.heads["cls_logits"] = cfg.n_classes
        for name, n_out in self.heads.items():
            prefix = "cls" if name == "cls_logits" else name
            self.add_module(f"{prefix}_conv", nn.Conv2d(in_ch, HEAD_CH, 3, padding=1))
            self.add_module(f"{prefix}_out", nn.Conv2d(HEAD_CH, n_out, 1))

    def forward(self, feats: torch.Tensor) -> dict:
        """feats (B, C, h, w) → {name: (B, n_out, 8h, 8w)} fp32; the 1x1 output
        convs run in fp32 (the JAX package's dtype=float32)."""
        x = feats
        for i in range(len(NECK)):
            x = F.relu(getattr(self, f"deconv_bn{i}")(getattr(self, f"deconv{i}")(x)))
        out = {}
        for name in self.heads:
            prefix = "cls" if name == "cls_logits" else name
            h = F.relu(getattr(self, f"{prefix}_conv")(x))
            with torch.autocast(h.device.type, enabled=False):
                out[name] = getattr(self, f"{prefix}_out")(h.float())
        out["protos"] = F.relu(out["protos"])
        return out


class CenterNetDetector(nn.Module):
    def __init__(self, cfg: DetectorConfig):
        super().__init__()
        self.cfg = cfg
        make = WideResNet18 if cfg.backbone == "resnet18" else WideResNet34
        self.backbone = make(in_channels=3)
        self.head = DetectorHead(cfg, self.backbone.n_features)

    def forward(self, images: torch.Tensor) -> dict:
        """images (B, 3, H, W) float in [0, 1] → head outputs channels-last,
        {heatmap, wh, offset, mask_coeffs, protos[, cls_logits]}: (B, H//4,
        W//4, D) fp32."""
        H, W = images.shape[-2:]
        Hp, Wp = -(-H // 32) * 32, -(-W // 32) * 32
        x = F.pad(images, (0, Wp - W, 0, Hp - H)) if (Hp, Wp) != (H, W) else images
        dtype = self.cfg.compute_dtype
        with torch.autocast(x.device.type, dtype=dtype, enabled=dtype != torch.float32):
            outputs = self.head(self.backbone(x))
        Hm, Wm = H // 4, W // 4
        return {k: v[:, :, :Hm, :Wm].permute(0, 2, 3, 1).float() for k, v in outputs.items()}


@torch.no_grad()
def init_detector_weights(model: CenterNetDetector, generator: torch.Generator) -> None:
    """Seeded init as flax's defaults: lecun-normal conv and deconv kernels
    (fan-in over the input channels and the window), zero biases, identity
    BatchNorm; the heatmap's output bias at logit(0.1)."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            fan_in = (m.weight.shape[0] if isinstance(m, nn.ConvTranspose2d)
                      else m.weight.shape[1]) * m.weight.shape[2] * m.weight.shape[3]
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator) / fan_in ** 0.5)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
    model.head.heatmap_out.bias.fill_(HEATMAP_BIAS)


def sorted_topk(x: torch.Tensor, k: int):
    """The k largest along the last axis, in descending order, ties in index
    order (lax.top_k's): (values, indices)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def nms_keep(boxes: torch.Tensor, cls: torch.Tensor, valid: torch.Tensor, iou_th: float,
             cross_iou_th: float | None = None) -> torch.Tensor:
    """Greedy same-class NMS over score-descending boxes, for a batch.

    boxes (B, K, 4) xyxy, cls (B, K), valid (B, K) bool → keep (B, K) bool:
    box i is kept unless a kept, higher-ranked box of its class overlaps it
    beyond iou_th (any class beyond cross_iou_th, when given); a loop over K,
    vectorised over the batch."""
    K = boxes.shape[1]
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1).clamp(min=0.0) * (y2 - y1).clamp(min=0.0)
    inter = ((torch.minimum(x2[:, :, None], x2[:, None, :])
              - torch.maximum(x1[:, :, None], x1[:, None, :])).clamp(min=0.0)
             * (torch.minimum(y2[:, :, None], y2[:, None, :])
                - torch.maximum(y1[:, :, None], y1[:, None, :])).clamp(min=0.0))
    iou = inter / (area[:, :, None] + area[:, None, :] - inter).clamp(min=1e-9)
    suppresses = (iou > iou_th) & (cls[:, :, None] == cls[:, None, :])
    if cross_iou_th is not None:
        suppresses = suppresses | (iou > cross_iou_th)
    higher = torch.arange(K, device=boxes.device)
    keep = valid.clone()
    for i in range(K):
        hit = (keep & suppresses[:, :, i] & (higher < i)).any(dim=-1)
        keep[:, i] &= ~hit
    return keep


def decode_detections(outputs: dict, max_detections: int, stride: int = 4,
                      nms_iou: float | None = 0.5, nms_cross_iou: float | None = None) -> dict:
    """Head outputs (channels-last) → max_detections detections an image:
    {scores (B, K), class_ids (B, K), boxes (B, K, 4) x1 y1 x2 y2 in input
    pixels, mask_logits (B, K, Hm, Wm)}. NMS (nms_iou > 0) zeroes the
    scores of suppressed detections."""
    heat = torch.sigmoid(outputs["heatmap"])
    B, H, W, C = heat.shape
    pooled = F.max_pool2d(heat.permute(0, 3, 1, 2), 3, stride=1, padding=1).permute(0, 2, 3, 1)
    heat = torch.where((pooled - heat).abs() < 1e-6, heat, torch.zeros_like(heat))
    K = max_detections
    if "cls_logits" in outputs:
        obj, pix = sorted_topk(heat.reshape(B, -1), K)
        logp = torch.log_softmax(outputs["cls_logits"], dim=-1)
        nC = logp.shape[-1]
        logp_pk = logp.reshape(B, H * W, nC).gather(1, pix[..., None].expand(-1, -1, nC))
        p2, c2 = sorted_topk(logp_pk.exp(), 2)
        scores, sel = sorted_topk((obj[..., None] * p2).reshape(B, -1), K)
        cls = c2.reshape(B, -1).gather(1, sel)
        pix = pix.repeat_interleave(2, dim=1).gather(1, sel)
    else:
        scores, idx = sorted_topk(heat.reshape(B, -1), K)
        cls, pix = idx % C, idx // C
    ys, xs = (pix // W).float(), (pix % W).float()

    def gather_pix(field):  # (B, H, W, D) → (B, K, D)
        D = field.shape[-1]
        return field.reshape(B, H * W, D).gather(1, pix[..., None].expand(-1, -1, D))

    off, wh = gather_pix(outputs["offset"]), gather_pix(outputs["wh"])
    cx, cy = (xs + off[..., 0]) * stride, (ys + off[..., 1]) * stride
    w, h = wh[..., 0].clamp(min=0.0) * stride, wh[..., 1].clamp(min=0.0) * stride
    boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)
    mask_logits = torch.einsum("bkp,bhwp->bkhw", gather_pix(outputs["mask_coeffs"]),
                               outputs["protos"])
    if nms_iou:
        keep = nms_keep(boxes, cls, scores > 0.0, nms_iou, nms_cross_iou)
        scores = torch.where(keep, scores, torch.zeros_like(scores))
    return dict(scores=scores, class_ids=cls, boxes=boxes, mask_logits=mask_logits)
