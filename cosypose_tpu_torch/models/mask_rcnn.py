"""Mask R-CNN with a ResNet-50-FPN backbone, in eval mode: CosyPose's own
detector (its DetectorMaskRCNN, torchvision's `maskrcnn_resnet50_fpn` with
anchor sizes 32-512 and min/max size from `input_resize`; He et al. 2017,
arXiv:1703.06870; FPN: Lin et al. 2017, arXiv:1612.03144).

The JAX package replaced this detector by a CenterNet (models/detector.py),
since Mask R-CNN's ragged proposals and NMS fight XLA's static shapes; on
the card nothing forbids them, so the port runs the published model too.
Module and parameter names are torchvision's, as the released checkpoints
name them (`backbone.body.layer1.0.conv1.weight`,
`backbone.fpn.inner_blocks.0.weight`, `rpn.head.conv.weight`,
`roi_heads.box_head.fc6.weight`, `roi_heads.mask_head.mask_fcn1.weight`,
...), so a converted state dict loads as it is.

    model = MaskRCNN(MaskRCNNConfig(n_classes=22, compute_dtype=torch.bfloat16))
    out = model(images)   # (B, 3, H, W) float in [0, 1]

returns {boxes (N, 4) in the input's pixels, scores (N,), labels (N,)
class ids (1 .. n_classes - 1), image_ids (N,), mask_probs (N, 28, 28) and
masks (N, H, W) float32, the probabilities pasted into the image}, the
detections image by image, each image's by descending score. The stages, in
torchvision's eval semantics:

- transform: ImageNet mean and std, a resize so that the short side is
  min(input_resize) unless the long side would pass max(input_resize)
  (identity at 480 x 640), zeros to multiples of 32;
- backbone: ResNet-50 (bottleneck blocks, stride in the 3x3 conv) with
  frozen BatchNorm, folded into its convolution's weight and bias; the FPN
  (lateral 1x1, nearest top-down, 3x3 outputs; P6 the max pool of P5);
- RPN: a shared 3x3 conv and 1x1 heads, 3 anchors a location (sizes
  32-512, ratios 0.5 / 1 / 2, rounded); the top 1,000 anchors of each level
  by a stable sort of the objectness logits, decoded (weights 1, 1, 1, 1;
  log sizes clipped at log(1000/16)), clipped, boxes below 1e-3 invalid,
  greedy NMS at 0.7 within each (image, level), the top 1,000 kept of each
  image;
- box head: multi-level RoIAlign 7x7 at sampling 2 (ops/roi_align.py), two
  linear layers of 1,024 and the predictor; per-class decoding (10, 10, 5,
  5), clipping, softmax, scores above 0.05, boxes below 1e-2 dropped, greedy
  NMS at 0.5 within each (image, class), the top 100 of each image;
- mask head: RoIAlign 14x14 on the detections, four 3x3 convs of 256, a 2x
  deconv, 1x1 logits, the label's channel through a sigmoid, pasted
  (ops/boxes.paste_masks).

Ties: NMS orders by a stable sort, so equal scores go to the lower index
(torchvision leaves them in no stated order). Convolutions and linear layers
run in `compute_dtype` (bf16 on the serving path, channels-last on the
card); anchors, decoding, RoIAlign's coordinates and values, NMS and pasting
are float32. Both NMS run through ops/nms_cuda.py, one launch each for every
image. Host syncs: reading the kept proposals (one), the candidates above the
score threshold (one) and the kept detections (one).

Spans (utils/profiling.py), inside `cosypose.detector.request` (a call):
`cosypose.detector.backbone` (`features`: ResNet-50 and FPN),
`cosypose.detector.rpn` (`region_proposals`: head, top-k, decoding, NMS, the
cut), `cosypose.detector.box` (`detect`: RoIAlign, MLP, postprocess),
`cosypose.detector.mask` (`segment`: RoIAlign, head, pasting),
`cosypose.detector.nms` (inside the RPN's and the box head's). Counters:
`anchors`, `nms_in` (rows into NMS), `proposals`, `detections`, and the
kernel's `nms` (launches).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import boxes as box_ops
from ..ops.nms_cuda import batched_nms
from ..ops.roi_align import multiscale_roi_align
from ..utils.profiling import annotate, count

IMAGE_MEAN = (0.485, 0.456, 0.406)
IMAGE_STD = (0.229, 0.224, 0.225)
LAYERS = (3, 4, 6, 3)
WIDTHS = (64, 128, 256, 512)
FPN_CH = 256
REPRESENTATION = 1024
RPN_WEIGHTS = (1.0, 1.0, 1.0, 1.0)
BOX_WEIGHTS = (10.0, 10.0, 5.0, 5.0)


@dataclasses.dataclass(frozen=True)
class MaskRCNNConfig:
    n_classes: int = 22                      # with the background, class 0
    backbone_str: str = "resnet50-fpn"
    input_resize: tuple = (480, 640)         # min_size, max_size = min, max of it
    anchor_sizes: tuple = (32, 64, 128, 256, 512)
    aspect_ratios: tuple = (0.5, 1.0, 2.0)
    rpn_pre_nms_top_n: int = 1000            # a level
    rpn_post_nms_top_n: int = 1000           # an image
    rpn_nms_thresh: float = 0.7
    rpn_min_size: float = 1e-3
    box_score_thresh: float = 0.05
    box_nms_thresh: float = 0.5
    box_detections_per_img: int = 100
    box_min_size: float = 1e-2
    frozen_bn_eps: float = 1e-5
    compute_dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if self.backbone_str != "resnet50-fpn":
            raise ValueError(f"Mask R-CNN takes backbone_str 'resnet50-fpn'; got "
                             f"{self.backbone_str!r}")


class FrozenBatchNorm2d(nn.Module):
    """BatchNorm with fixed statistics and affine parameters (buffers, as
    torchvision's)."""

    def __init__(self, n: int, eps: float):
        super().__init__()
        self.eps = eps
        for name, fill in (("weight", 1.0), ("bias", 0.0), ("running_mean", 0.0),
                           ("running_var", 1.0)):
            self.register_buffer(name, torch.full((n,), fill))

    def scale_shift(self):
        scale = self.weight * (self.running_var + self.eps).rsqrt()
        return scale, self.bias - self.running_mean * scale


class Bottleneck(nn.Module):
    def __init__(self, cin: int, width: int, stride: int, eps: float):
        super().__init__()
        self.stride = stride
        self.conv1 = nn.Conv2d(cin, width, 1, bias=False)
        self.bn1 = FrozenBatchNorm2d(width, eps)
        self.conv2 = nn.Conv2d(width, width, 3, stride, 1, bias=False)
        self.bn2 = FrozenBatchNorm2d(width, eps)
        self.conv3 = nn.Conv2d(width, 4 * width, 1, bias=False)
        self.bn3 = FrozenBatchNorm2d(4 * width, eps)
        self.downsample = None
        if stride != 1 or cin != 4 * width:
            self.downsample = nn.Sequential(nn.Conv2d(cin, 4 * width, 1, stride, bias=False),
                                            FrozenBatchNorm2d(4 * width, eps))


class ResNet50Body(nn.Module):
    def __init__(self, eps: float):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = FrozenBatchNorm2d(64, eps)
        cin = 64
        for i, (n, w) in enumerate(zip(LAYERS, WIDTHS)):
            blocks = []
            for j in range(n):
                blocks.append(Bottleneck(cin, w, 2 if (j == 0 and i > 0) else 1, eps))
                cin = 4 * w
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))


class FPN(nn.Module):
    def __init__(self):
        super().__init__()
        self.inner_blocks = nn.ModuleList(nn.Conv2d(4 * w, FPN_CH, 1) for w in WIDTHS)
        self.layer_blocks = nn.ModuleList(nn.Conv2d(FPN_CH, FPN_CH, 3, padding=1)
                                          for _ in WIDTHS)


class RPNHead(nn.Module):
    def __init__(self, n_anchors: int):
        super().__init__()
        self.conv = nn.Conv2d(FPN_CH, FPN_CH, 3, padding=1)
        self.cls_logits = nn.Conv2d(FPN_CH, n_anchors, 1)
        self.bbox_pred = nn.Conv2d(FPN_CH, 4 * n_anchors, 1)


class MaskRCNN(nn.Module):
    def __init__(self, cfg: MaskRCNNConfig = MaskRCNNConfig()):
        super().__init__()
        self.cfg = cfg
        self.backbone = nn.Module()
        self.backbone.body = ResNet50Body(cfg.frozen_bn_eps)
        self.backbone.fpn = FPN()
        self.rpn = nn.Module()
        self.rpn.head = RPNHead(len(cfg.aspect_ratios))
        rh = self.roi_heads = nn.Module()
        rh.box_head = nn.Module()
        rh.box_head.fc6 = nn.Linear(FPN_CH * 7 * 7, REPRESENTATION)
        rh.box_head.fc7 = nn.Linear(REPRESENTATION, REPRESENTATION)
        rh.box_predictor = nn.Module()
        rh.box_predictor.cls_score = nn.Linear(REPRESENTATION, cfg.n_classes)
        rh.box_predictor.bbox_pred = nn.Linear(REPRESENTATION, 4 * cfg.n_classes)
        rh.mask_head = nn.Module()
        for k in range(1, 5):
            setattr(rh.mask_head, f"mask_fcn{k}", nn.Conv2d(FPN_CH, FPN_CH, 3, padding=1))
        rh.mask_predictor = nn.Module()
        rh.mask_predictor.conv5_mask = nn.ConvTranspose2d(FPN_CH, FPN_CH, 2, 2)
        rh.mask_predictor.mask_fcn_logits = nn.Conv2d(FPN_CH, cfg.n_classes, 1)
        self._prepared: dict = {}
        self._constants: dict = {}

    # -- eval weights ------------------------------------------------------

    def _weights(self, conv: nn.Module, bn: FrozenBatchNorm2d | None, like: torch.Tensor):
        """conv's (weight, bias) in like's dtype and memory format, the frozen
        BatchNorm folded in; kept while the source tensors are unchanged (by
        their storage and version counters)."""
        sources = [conv.weight] + ([conv.bias] if conv.bias is not None else []) + (
            [bn.weight, bn.bias, bn.running_mean, bn.running_var] if bn is not None else [])
        cl = like.dim() == 4 and like.is_cuda
        tag = (id(conv), like.dtype, cl)
        try:
            key = tuple((t.data_ptr(), t._version) for t in sources)
        except RuntimeError:  # inference tensors keep no version counter
            key = None
        hit = self._prepared.get(tag)
        if key is not None and hit is not None and hit[0] == key:
            return hit[1]
        w, b = conv.weight.float(), conv.bias.float() if conv.bias is not None else None
        if bn is not None:
            scale, shift = bn.scale_shift()
            w = w * scale.reshape(-1, *([1] * (w.dim() - 1)))
            b = shift
        w = w.to(like.dtype)
        if cl and w.dim() == 4:
            w = w.contiguous(memory_format=torch.channels_last)
        out = (w, None if b is None else b.to(like.dtype))
        if key is not None:
            self._prepared[tag] = (key, out)
        return out

    def _conv(self, conv, x, bn=None, relu=False):
        w, b = self._weights(conv, bn, x)
        y = F.conv2d(x, w, b, conv.stride, conv.padding)
        return F.relu(y) if relu else y

    def _linear(self, lin, x, relu=False):
        w, b = self._weights(lin, None, x)
        y = F.linear(x, w, b)
        return F.relu(y) if relu else y

    # -- stages ----------------------------------------------------------

    def transform(self, images: torch.Tensor):
        """(x (B, 3, Hp, Wp) normalised, resized and zero-padded to multiples
        of 32, float32; (h, w) resized and unpadded)."""
        mean, std = self._constant(("mean_std", images.dtype, images.device), lambda: (
            torch.tensor(IMAGE_MEAN, dtype=images.dtype, device=images.device)[:, None, None],
            torch.tensor(IMAGE_STD, dtype=images.dtype, device=images.device)[:, None, None]))
        x = (images - mean) / std
        h, w = x.shape[-2:]
        lo, hi = min(self.cfg.input_resize), max(self.cfg.input_resize)
        scale = min(float(lo) / min(h, w), float(hi) / max(h, w))
        if scale != 1.0:
            x = F.interpolate(x, scale_factor=scale, mode="bilinear",
                              recompute_scale_factor=True, align_corners=False)
        h, w = x.shape[-2:]
        hp, wp = -(-h // 32) * 32, -(-w // 32) * 32
        return F.pad(x, (0, wp - w, 0, hp - h)), (h, w)

    def features(self, x: torch.Tensor) -> list:
        """[P2, P3, P4, P5, P6] of the transformed batch, in compute_dtype."""
        x = x.to(self.cfg.compute_dtype)
        if x.is_cuda:
            x = x.contiguous(memory_format=torch.channels_last)
        body = self.backbone.body
        x = F.max_pool2d(self._conv(body.conv1, x, body.bn1, relu=True), 3, 2, 1)
        stages = []
        for i in range(len(LAYERS)):
            for blk in getattr(body, f"layer{i + 1}"):
                y = self._conv(blk.conv1, x, blk.bn1, relu=True)
                y = self._conv(blk.conv2, y, blk.bn2, relu=True)
                y = self._conv(blk.conv3, y, blk.bn3)
                if blk.downsample is not None:
                    x = self._conv(blk.downsample[0], x, blk.downsample[1])
                x = F.relu(y + x)
            stages.append(x)
        fpn = self.backbone.fpn
        last = self._conv(fpn.inner_blocks[3], stages[3])
        out = [self._conv(fpn.layer_blocks[3], last)]
        for i in (2, 1, 0):
            lateral = self._conv(fpn.inner_blocks[i], stages[i])
            last = lateral + F.interpolate(last, size=lateral.shape[-2:], mode="nearest")
            out.insert(0, self._conv(fpn.layer_blocks[i], last))
        out.append(F.max_pool2d(out[-1], 1, 2, 0))
        return out

    def rpn_head(self, feats: list):
        """[(B, A, H, W) objectness logits], [(B, 4A, H, W) deltas] a level."""
        head = self.rpn.head
        logits, deltas = [], []
        for f in feats:
            t = self._conv(head.conv, f, relu=True)
            logits.append(self._conv(head.cls_logits, t))
            deltas.append(self._conv(head.bbox_pred, t))
        return logits, deltas

    def _constant(self, key, make):
        """make() once a key: tensors of the call's shapes made on the device
        once, so that a call copies nothing from the host (a copy from the
        host waits for the device)."""
        if key not in self._constants:
            self._constants[key] = make()
        return self._constants[key]

    def anchors(self, grids: list, padded_hw: tuple, device) -> list:
        """Each level's anchors (ops/boxes.grid_anchors), made once a shape."""
        return self._constant(("anchors", tuple(grids), tuple(padded_hw), device), lambda: [
            box_ops.grid_anchors(g, padded_hw, size, self.cfg.aspect_ratios, device)
            for g, size in zip(grids, self.cfg.anchor_sizes)])

    def proposals(self, logits: list, deltas: list, image_hw: tuple, padded_hw: tuple):
        """(boxes (R, 4) float32, image ids (R,)): each image's proposals
        by descending objectness, after the top-k a level, decoding,
        clipping, the small-box test, NMS by (image, level) and the cut."""
        cfg = self.cfg
        B = logits[0].shape[0]
        level_anchors = self.anchors([tuple(o.shape[-2:]) for o in logits], padded_hw,
                                     logits[0].device)
        obj, rel, anc, lvl = [], [], [], []
        for k, (o, d, a) in enumerate(zip(logits, deltas, level_anchors)):
            fh, fw = o.shape[-2:]
            o = o.float().permute(0, 2, 3, 1).reshape(B, -1)
            d = d.float().reshape(B, -1, 4, fh, fw).permute(0, 3, 4, 1, 2).reshape(B, -1, 4)
            top = torch.sort(o, dim=1, descending=True, stable=True).indices
            top = top[:, :min(cfg.rpn_pre_nms_top_n, o.shape[1])]
            obj.append(o.gather(1, top))
            rel.append(d.gather(1, top[..., None].expand(-1, -1, 4)))
            anc.append(a[top])
            lvl.append(torch.full_like(top, k))
        count("anchors", B * sum(len(a) for a in level_anchors))
        obj, rel, anc, lvl = (torch.cat(t, 1) for t in (obj, rel, anc, lvl))
        boxes = box_ops.clip(box_ops.decode(rel, anc, RPN_WEIGHTS)[..., 0, :], image_hw)
        scores = torch.sigmoid(obj)
        L = len(logits)
        groups = torch.arange(B, device=lvl.device)[:, None] * L + lvl
        n = scores.numel()
        count("nms_in", n)
        with annotate("cosypose.detector.nms", boxes=n):
            keep = batched_nms(boxes.reshape(-1, 4), scores.reshape(-1), groups.reshape(-1),
                               B * L, cfg.rpn_nms_thresh,
                               box_ops.not_small(boxes, cfg.rpn_min_size).reshape(-1))
        order = torch.sort(scores, dim=1, descending=True, stable=True).indices
        kept = keep.view(B, -1).gather(1, order)
        kept &= kept.cumsum(1) <= cfg.rpn_post_nms_top_n
        image, pos = torch.nonzero(kept, as_tuple=True)
        out = boxes[image, order[image, pos]]
        count("proposals", out.shape[0])
        return out, image

    def box_head(self, feats: list, proposals: torch.Tensor, image_ids: torch.Tensor,
                 image_hw: tuple):
        """(class logits (R, n_classes), deltas (R, 4 n_classes)), float32."""
        x = multiscale_roi_align(feats[:4], proposals, image_ids, image_hw, 7)
        x = x.flatten(1).to(self.cfg.compute_dtype)
        rh = self.roi_heads
        x = self._linear(rh.box_head.fc6, x, relu=True)
        x = self._linear(rh.box_head.fc7, x, relu=True)
        return (self._linear(rh.box_predictor.cls_score, x).float(),
                self._linear(rh.box_predictor.bbox_pred, x).float())

    def postprocess(self, class_logits, box_deltas, proposals, image_ids, image_hw: tuple,
                    n_images: int) -> dict:
        """{boxes, scores, labels, image_ids}: per class decoding, clipping,
        softmax, the score threshold and the small-box test, NMS by (image,
        class), the top detections_per_img of each image by score."""
        cfg = self.cfg
        C = class_logits.shape[1]
        boxes = box_ops.clip(box_ops.decode(box_deltas, proposals, BOX_WEIGHTS), image_hw)
        scores = F.softmax(class_logits, -1)
        boxes, scores = boxes[:, 1:].reshape(-1, 4), scores[:, 1:].reshape(-1)
        labels = torch.arange(1, C, device=boxes.device).repeat(len(proposals))
        images = image_ids.repeat_interleave(C - 1)
        cand = torch.nonzero((scores > cfg.box_score_thresh)
                             & box_ops.not_small(boxes, cfg.box_min_size))[:, 0]
        boxes, scores, labels, images = boxes[cand], scores[cand], labels[cand], images[cand]
        count("nms_in", len(cand))
        with annotate("cosypose.detector.nms", boxes=len(cand)):
            keep = batched_nms(boxes, scores, images * C + labels, n_images * C,
                               cfg.box_nms_thresh)
        order = torch.sort(scores, descending=True, stable=True).indices
        order = order[torch.sort(images[order], stable=True).indices]
        kept, im = keep[order], images[order]
        # rank of each kept detection within its image, 1-based
        total = kept.cumsum(0)
        first = torch.searchsorted(im, im)
        rank = total - total[first] + kept[first].to(total.dtype)
        sel = order[kept & (rank <= cfg.box_detections_per_img)]
        count("detections", len(sel))
        return dict(boxes=boxes[sel], scores=scores[sel], labels=labels[sel],
                    image_ids=images[sel])

    def mask_head(self, feats: list, boxes: torch.Tensor, image_ids: torch.Tensor,
                  image_hw: tuple) -> torch.Tensor:
        """Mask logits (D, n_classes, 28, 28), float32."""
        x = multiscale_roi_align(feats[:4], boxes, image_ids, image_hw, 14)
        x = x.to(self.cfg.compute_dtype)
        if x.is_cuda:
            x = x.contiguous(memory_format=torch.channels_last)
        rh = self.roi_heads
        for k in range(1, 5):
            x = self._conv(getattr(rh.mask_head, f"mask_fcn{k}"), x, relu=True)
        deconv = rh.mask_predictor.conv5_mask
        w, b = self._weights(deconv, None, x)
        x = F.relu(F.conv_transpose2d(x, w, b, stride=2))
        return self._conv(rh.mask_predictor.mask_fcn_logits, x).float()

    def region_proposals(self, feats: list, image_hw: tuple, padded_hw: tuple):
        """The RPN: (logits, deltas, proposals, proposal image ids)."""
        logits, deltas = self.rpn_head(feats)
        return (logits, deltas) + self.proposals(logits, deltas, image_hw, padded_hw)

    def detect(self, feats: list, proposals, proposal_ids, image_hw: tuple, n_images: int):
        """The box head and its postprocess: (class logits, deltas, detections)."""
        cls, box = self.box_head(feats, proposals, proposal_ids, image_hw)
        return cls, box, self.postprocess(cls, box, proposals, proposal_ids, image_hw, n_images)

    def segment(self, feats: list, det: dict, image_hw: tuple, out_hw: tuple,
                boxes: torch.Tensor):
        """The mask head on the detections (boxes in the resized image's
        pixels in det, in the input's in `boxes`): (mask logits, the label's
        probabilities (D, 28, 28), pasted into the input (D, H, W))."""
        logits = self.mask_head(feats, det["boxes"], det["image_ids"], image_hw)
        idx = torch.arange(len(det["labels"]), device=logits.device)
        probs = logits[idx, det["labels"]].sigmoid()
        return logits, probs, box_ops.paste_masks(probs, boxes, out_hw)

    @torch.inference_mode()
    def forward(self, images: torch.Tensor, masks: bool = True, record: dict | None = None):
        """images (B, 3, H, W) float in [0, 1] -> the module docstring's
        dict (masks and mask_probs only with `masks`). `record`, where given,
        gets every stage's output: x, image_hw, features, logits, deltas,
        proposals, proposal_ids, class_logits, box_deltas, detections (in
        the resized image's pixels), mask_logits."""
        H, W = images.shape[-2:]
        with annotate("cosypose.detector.request", images=images.shape[0]):
            x, hw = self.transform(images.float())
            with annotate("cosypose.detector.backbone"):
                feats = self.features(x)
            with annotate("cosypose.detector.rpn"):
                logits, deltas, proposals, prop_ids = self.region_proposals(
                    feats, hw, tuple(x.shape[-2:]))
            with annotate("cosypose.detector.box"):
                cls, box, det = self.detect(feats, proposals, prop_ids, hw, images.shape[0])
            ratio = self._constant(("ratio", H, W, hw, images.device), lambda: torch.tensor(
                [W / hw[1], H / hw[0], W / hw[1], H / hw[0]], device=images.device))
            out = dict(det, boxes=det["boxes"] * ratio)
            if record is not None:
                record.update(x=x, image_hw=hw, features=feats, logits=logits, deltas=deltas,
                              proposals=proposals, proposal_ids=prop_ids, class_logits=cls,
                              box_deltas=box, detections=det)
            if masks:
                with annotate("cosypose.detector.mask"):
                    mask_logits, out["mask_probs"], out["masks"] = self.segment(
                        feats, det, hw, (H, W), out["boxes"])
                if record is not None:
                    record["mask_logits"] = mask_logits
        return out


def maskrcnn_category_ids(label_to_category_id: dict) -> dict:
    """Labels -> Mask R-CNN class ids: class 0 is the background, so a map
    without 'background' shifts by one (CenterNet's ids start at 0)."""
    if "background" in label_to_category_id:
        return {k: v for k, v in label_to_category_id.items() if k != "background"}
    return {k: v + 1 for k, v in label_to_category_id.items()}
