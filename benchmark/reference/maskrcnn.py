"""Mask R-CNN with a ResNet-50-FPN backbone (He et al. 2017, arXiv:1703.06870;
FPN: Lin et al. 2017, arXiv:1612.03144) in eval mode, as plain functions over
a dict of tensors, in float32: the plain reference of CosyPose's detector
(its DetectorMaskRCNN is torchvision's `maskrcnn_resnet50_fpn` with the
anchor sizes 32-512 and the input size of its config).

It imports nothing but torch and sets TF32 off for matrix products and
convolutions when imported. Parameter names are torchvision's
(`backbone.body.layer1.0.conv1.weight`, `backbone.fpn.inner_blocks.0.weight`,
`rpn.head.conv.weight`, `roi_heads.box_head.fc6.weight`,
`roi_heads.mask_head.mask_fcn1.weight`, ...), as the released checkpoints
of that era name them.

Each stage is a function of its own, so that a caller can start any stage
from another program's input to it: `transform`, `features` (ResNet-50 with
frozen BatchNorm, the FPN and its last-level max pool), `rpn_head`,
`anchors`, `filter_proposals` (top-k a level, decoding, clipping, small
boxes dropped, NMS by level, the post-NMS cut), `box_head` (multi-level
RoIAlign 7x7 and the two-layer MLP, `box_features`, with its predictor,
`box_predictor`), `postprocess` (per class decoding, score threshold, class
NMS, the cap), `mask_head` (RoIAlign 14x14, four convs, the deconv, the
logits), `paste_masks`. `forward` runs them all.

Departures from torchvision, each for a comparison that must be exact:
- top-k a level is a stable sort, descending, so that equal scores keep the
  anchors' order (torch.topk leaves ties in no stated order); NMS orders
  boxes by a stable sort of the scores, so ties go to the lower index
  (torchvision's sort leaves them in no stated order);
- NMS compares groups (levels, classes) by id, on the boxes as given;
  torchvision's `batched_nms` offsets each group's coordinates, which
  rounds the IoU of the shifted boxes;
- anchors, decoding and RoIAlign's coordinates are float32 whatever the
  features' dtype (torchvision takes the anchors' dtype from the features).
NMS is the textbook greedy loop over each group's IoU matrix
(`batched_nms`); RoIAlign is the gather form (torchvision's `roi_align`
with aligned=False, sample by sample); masks are pasted one at a time with
`F.interpolate`, as `paste_masks_in_image` does.

`quant`, where given, is applied to the input and the weight of every
convolution and linear layer: the benchmark's lower-precision control.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

IMAGE_MEAN = (0.485, 0.456, 0.406)
IMAGE_STD = (0.229, 0.224, 0.225)
LAYERS = (3, 4, 6, 3)          # ResNet-50's bottleneck blocks a stage
WIDTHS = (64, 128, 256, 512)   # their middle widths; out = 4x
FPN_CH = 256
REPRESENTATION = 1024          # the box head's MLP width
BOX_WEIGHTS = (10.0, 10.0, 5.0, 5.0)
RPN_WEIGHTS = (1.0, 1.0, 1.0, 1.0)
XFORM_CLIP = math.log(1000.0 / 16)

# torchvision's MaskRCNN eval defaults, with the anchors and sizes of
# CosyPose's DetectorMaskRCNN (min_size / max_size from its input_resize)
SETTINGS = dict(min_size=480, max_size=640, anchor_sizes=(32, 64, 128, 256, 512),
                aspect_ratios=(0.5, 1.0, 2.0), rpn_pre_nms_top_n=1000, rpn_post_nms_top_n=1000,
                rpn_nms_thresh=0.7, rpn_min_size=1e-3, box_score_thresh=0.05,
                box_nms_thresh=0.5, box_detections_per_img=100, box_min_size=1e-2,
                frozen_bn_eps=1e-5, n_classes=22)


def param_shapes(n_classes: int) -> dict:
    """{name: shape} of every parameter and frozen BatchNorm buffer."""
    shapes = {}

    def conv(name, cout, cin, k, bias=False):
        shapes[f"{name}.weight"] = (cout, cin, k, k)
        if bias:
            shapes[f"{name}.bias"] = (cout,)

    def bn(name, ch):
        for s in ("weight", "bias", "running_mean", "running_var"):
            shapes[f"{name}.{s}"] = (ch,)

    body = "backbone.body"
    conv(f"{body}.conv1", 64, 3, 7)
    bn(f"{body}.bn1", 64)
    cin = 64
    for i, (n, w) in enumerate(zip(LAYERS, WIDTHS)):
        for j in range(n):
            blk = f"{body}.layer{i + 1}.{j}"
            conv(f"{blk}.conv1", w, cin, 1)
            bn(f"{blk}.bn1", w)
            conv(f"{blk}.conv2", w, w, 3)
            bn(f"{blk}.bn2", w)
            conv(f"{blk}.conv3", 4 * w, w, 1)
            bn(f"{blk}.bn3", 4 * w)
            if j == 0:
                conv(f"{blk}.downsample.0", 4 * w, cin, 1)
                bn(f"{blk}.downsample.1", 4 * w)
            cin = 4 * w
    for i, w in enumerate(WIDTHS):
        conv(f"backbone.fpn.inner_blocks.{i}", FPN_CH, 4 * w, 1, bias=True)
        conv(f"backbone.fpn.layer_blocks.{i}", FPN_CH, FPN_CH, 3, bias=True)
    n_anchors = 3
    conv("rpn.head.conv", FPN_CH, FPN_CH, 3, bias=True)
    conv("rpn.head.cls_logits", n_anchors, FPN_CH, 1, bias=True)
    conv("rpn.head.bbox_pred", 4 * n_anchors, FPN_CH, 1, bias=True)
    rh = "roi_heads"
    shapes[f"{rh}.box_head.fc6.weight"] = (REPRESENTATION, FPN_CH * 7 * 7)
    shapes[f"{rh}.box_head.fc6.bias"] = (REPRESENTATION,)
    shapes[f"{rh}.box_head.fc7.weight"] = (REPRESENTATION, REPRESENTATION)
    shapes[f"{rh}.box_head.fc7.bias"] = (REPRESENTATION,)
    shapes[f"{rh}.box_predictor.cls_score.weight"] = (n_classes, REPRESENTATION)
    shapes[f"{rh}.box_predictor.cls_score.bias"] = (n_classes,)
    shapes[f"{rh}.box_predictor.bbox_pred.weight"] = (4 * n_classes, REPRESENTATION)
    shapes[f"{rh}.box_predictor.bbox_pred.bias"] = (4 * n_classes,)
    for k in range(1, 5):
        conv(f"{rh}.mask_head.mask_fcn{k}", FPN_CH, FPN_CH, 3, bias=True)
    shapes[f"{rh}.mask_predictor.conv5_mask.weight"] = (FPN_CH, FPN_CH, 2, 2)  # (in, out, k, k)
    shapes[f"{rh}.mask_predictor.conv5_mask.bias"] = (FPN_CH,)
    conv(f"{rh}.mask_predictor.mask_fcn_logits", n_classes, FPN_CH, 1, bias=True)
    return shapes


def _q(quant, t):
    return t if quant is None else quant(t)


def conv(p, name, x, stride=1, padding=0, quant=None):
    return F.conv2d(_q(quant, x), _q(quant, p[f"{name}.weight"]), p.get(f"{name}.bias"),
                    stride, padding)


def linear(p, name, x, quant=None):
    return F.linear(_q(quant, x), _q(quant, p[f"{name}.weight"]), p[f"{name}.bias"])


def frozen_bn(p, name, x, eps, calibrate=False):
    """torchvision's FrozenBatchNorm2d; with `calibrate`, its statistics are
    first set to x's batch statistics (biased variance)."""
    if calibrate:
        p[f"{name}.running_mean"] = x.mean((0, 2, 3))
        p[f"{name}.running_var"] = x.var((0, 2, 3), unbiased=False)
    scale = p[f"{name}.weight"] * (p[f"{name}.running_var"] + eps).rsqrt()
    bias = p[f"{name}.bias"] - p[f"{name}.running_mean"] * scale
    return x * scale.reshape(1, -1, 1, 1) + bias.reshape(1, -1, 1, 1)


def transform(images: torch.Tensor, min_size: int, max_size: int):
    """images (B, 3, H, W) in [0, 1] -> (x (B, 3, Hp, Wp): normalised,
    resized so the short side is min_size unless the long side would pass
    max_size, zero-padded to multiples of 32; (h, w) resized, unpadded)."""
    mean = torch.tensor(IMAGE_MEAN, dtype=images.dtype, device=images.device)
    std = torch.tensor(IMAGE_STD, dtype=images.dtype, device=images.device)
    x = (images - mean[:, None, None]) / std[:, None, None]
    h, w = x.shape[-2:]
    scale = min(float(min_size) / min(h, w), float(max_size) / max(h, w))
    if scale != 1.0:
        x = F.interpolate(x, scale_factor=scale, mode="bilinear", recompute_scale_factor=True,
                          align_corners=False)
    h, w = x.shape[-2:]
    hp, wp = -(-h // 32) * 32, -(-w // 32) * 32
    return F.pad(x, (0, wp - w, 0, hp - h)), (h, w)


def features(p: dict, x: torch.Tensor, eps: float, quant=None, calibrate=False) -> list:
    """ResNet-50 (torchvision's: stride in the 3x3 conv) with frozen
    BatchNorm, then the FPN over its four stages, then the max pool of the
    last level: [P2, P3, P4, P5, P6], each (B, 256, ., .). `calibrate` sets
    every BatchNorm's statistics from this batch on the way (`frozen_bn`)."""
    def conv_bn(name, bn, y, stride=1, padding=0):
        return frozen_bn(p, bn, conv(p, name, y, stride, padding, quant), eps, calibrate)

    body = "backbone.body"
    x = F.max_pool2d(F.relu(conv_bn(f"{body}.conv1", f"{body}.bn1", x, 2, 3)), 3, 2, 1)
    stages = []
    for i, n in enumerate(LAYERS):
        for j in range(n):
            blk = f"{body}.layer{i + 1}.{j}"
            stride = 2 if (j == 0 and i > 0) else 1
            y = F.relu(conv_bn(f"{blk}.conv1", f"{blk}.bn1", x))
            y = F.relu(conv_bn(f"{blk}.conv2", f"{blk}.bn2", y, stride, 1))
            y = conv_bn(f"{blk}.conv3", f"{blk}.bn3", y)
            if j == 0:
                x = conv_bn(f"{blk}.downsample.0", f"{blk}.downsample.1", x, stride)
            x = F.relu(y + x)
        stages.append(x)
    fpn = "backbone.fpn"
    last = conv(p, f"{fpn}.inner_blocks.3", stages[3], quant=quant)
    out = [conv(p, f"{fpn}.layer_blocks.3", last, padding=1, quant=quant)]
    for i in (2, 1, 0):
        lateral = conv(p, f"{fpn}.inner_blocks.{i}", stages[i], quant=quant)
        last = lateral + F.interpolate(last, size=lateral.shape[-2:], mode="nearest")
        out.insert(0, conv(p, f"{fpn}.layer_blocks.{i}", last, padding=1, quant=quant))
    out.append(F.max_pool2d(out[-1], 1, 2, 0))
    return out


def rpn_head(p: dict, feats: list, quant=None):
    """[(B, A, H, W) objectness logits], [(B, 4A, H, W) box deltas] a level."""
    logits, deltas = [], []
    for f in feats:
        t = F.relu(conv(p, "rpn.head.conv", f, padding=1, quant=quant))
        logits.append(conv(p, "rpn.head.cls_logits", t, quant=quant))
        deltas.append(conv(p, "rpn.head.bbox_pred", t, quant=quant))
    return logits, deltas


def anchors(sizes_hw: list, padded_hw: tuple, anchor_sizes, aspect_ratios, device) -> list:
    """torchvision's AnchorGenerator: a level's (H * W * A, 4) anchors in
    (y, x, anchor) order, strides padded size // grid size, base anchors
    rounded."""
    out = []
    ratios = torch.tensor(aspect_ratios, dtype=torch.float32, device=device)
    for (fh, fw), size in zip(sizes_hw, anchor_sizes):
        scales = torch.tensor([size], dtype=torch.float32, device=device)
        h_ratios = torch.sqrt(ratios)
        w_ratios = 1 / h_ratios
        ws = (w_ratios[:, None] * scales[None, :]).view(-1)
        hs = (h_ratios[:, None] * scales[None, :]).view(-1)
        base = (torch.stack([-ws, -hs, ws, hs], dim=1) / 2).round()
        sy, sx = padded_hw[0] // fh, padded_hw[1] // fw
        shifts_x = torch.arange(0, fw, dtype=torch.int32, device=device) * sx
        shifts_y = torch.arange(0, fh, dtype=torch.int32, device=device) * sy
        shift_y, shift_x = torch.meshgrid(shifts_y, shifts_x, indexing="ij")
        shift_x, shift_y = shift_x.reshape(-1), shift_y.reshape(-1)
        shifts = torch.stack((shift_x, shift_y, shift_x, shift_y), dim=1)
        out.append((shifts.view(-1, 1, 4) + base.view(1, -1, 4)).reshape(-1, 4))
    return out


def decode(rel_codes: torch.Tensor, boxes: torch.Tensor, weights) -> torch.Tensor:
    """torchvision's BoxCoder.decode_single: rel_codes (R, 4K), boxes (R, 4)
    -> (R, K, 4)."""
    boxes = boxes.to(rel_codes.dtype)
    widths = boxes[:, 2] - boxes[:, 0]
    heights = boxes[:, 3] - boxes[:, 1]
    ctr_x = boxes[:, 0] + 0.5 * widths
    ctr_y = boxes[:, 1] + 0.5 * heights
    wx, wy, ww, wh = weights
    dx = rel_codes[:, 0::4] / wx
    dy = rel_codes[:, 1::4] / wy
    dw = rel_codes[:, 2::4] / ww
    dh = rel_codes[:, 3::4] / wh
    dw = torch.clamp(dw, max=XFORM_CLIP)
    dh = torch.clamp(dh, max=XFORM_CLIP)
    pred_ctr_x = dx * widths[:, None] + ctr_x[:, None]
    pred_ctr_y = dy * heights[:, None] + ctr_y[:, None]
    pred_w = torch.exp(dw) * widths[:, None]
    pred_h = torch.exp(dh) * heights[:, None]
    c_to_c_h = torch.tensor(0.5, dtype=pred_ctr_y.dtype, device=pred_h.device) * pred_h
    c_to_c_w = torch.tensor(0.5, dtype=pred_ctr_x.dtype, device=pred_w.device) * pred_w
    return torch.stack((pred_ctr_x - c_to_c_w, pred_ctr_y - c_to_c_h, pred_ctr_x + c_to_c_w,
                        pred_ctr_y + c_to_c_h), dim=2)


def clip(boxes: torch.Tensor, hw: tuple) -> torch.Tensor:
    h, w = hw
    x = boxes[..., 0::2].clamp(min=0, max=w)
    y = boxes[..., 1::2].clamp(min=0, max=h)
    return torch.stack((x, y), dim=boxes.dim()).reshape(boxes.shape)


def not_small(boxes: torch.Tensor, min_size: float) -> torch.Tensor:
    ws, hs = boxes[:, 2] - boxes[:, 0], boxes[:, 3] - boxes[:, 1]
    return (ws >= min_size) & (hs >= min_size)


def iou_exceeds(a: torch.Tensor, b: torch.Tensor, threshold: float) -> torch.Tensor:
    """(len(a), len(b)) bool: IoU of each pair above the threshold, as
    torchvision's CUDA nms kernel computes it in float32."""
    left = torch.maximum(a[:, None, 0], b[None, :, 0])
    right = torch.minimum(a[:, None, 2], b[None, :, 2])
    top = torch.maximum(a[:, None, 1], b[None, :, 1])
    bottom = torch.minimum(a[:, None, 3], b[None, :, 3])
    inter = (right - left).clamp(min=0.0) * (bottom - top).clamp(min=0.0)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / (area_a[:, None] + area_b[None, :] - inter) > threshold


def batched_nms(boxes, scores, groups, threshold) -> torch.Tensor:
    """Textbook greedy NMS within each group: the group's boxes by
    descending score (ties: lower index first), each kept unless a kept box
    before it overlaps it, scanned over the group's IoU matrix. Indices
    kept, by descending score (ties: lower index first)."""
    keep = []
    for g in torch.unique(groups):
        idx = torch.nonzero(groups == g)[:, 0]
        idx = idx[torch.sort(scores[idx], descending=True, stable=True).indices]
        hits = iou_exceeds(boxes[idx], boxes[idx], threshold).cpu()
        gone = torch.zeros(len(idx), dtype=torch.bool)
        for i, row in enumerate(idx.tolist()):
            if not gone[i]:
                keep.append(row)
                gone |= hits[i]
    if not keep:
        return groups.new_zeros(0)
    keep = torch.sort(torch.tensor(keep, device=groups.device)).values
    return keep[torch.sort(scores[keep], descending=True, stable=True).indices]


def filter_proposals(logits: list, deltas: list, level_anchors: list, image_hw: tuple,
                     s: dict) -> list:
    """[(boxes (n, 4), scores (n,)) an image]: the RPN's proposals."""
    B = logits[0].shape[0]
    obj = torch.cat([o.permute(0, 2, 3, 1).reshape(B, -1) for o in logits], 1)
    rel = torch.cat([d.view(B, -1, 4, *d.shape[-2:]).permute(0, 3, 4, 1, 2).reshape(B, -1, 4)
                     for d in deltas], 1)
    all_anchors = torch.cat(level_anchors)
    sizes = [len(a) for a in level_anchors]
    out = []
    for b in range(B):
        proposals = decode(rel[b], all_anchors, RPN_WEIGHTS)[:, 0]
        idx, lvl, offset = [], [], 0
        for k, n in enumerate(sizes):
            top = torch.sort(obj[b, offset:offset + n], descending=True, stable=True).indices
            top = top[:min(s["rpn_pre_nms_top_n"], n)] + offset
            idx.append(top)
            lvl.append(torch.full_like(top, k))
            offset += n
        idx, lvl = torch.cat(idx), torch.cat(lvl)
        boxes = clip(proposals[idx], image_hw)
        scores = torch.sigmoid(obj[b, idx])
        keep = not_small(boxes, s["rpn_min_size"])
        boxes, scores, lvl = boxes[keep], scores[keep], lvl[keep]
        keep = batched_nms(boxes, scores, lvl, s["rpn_nms_thresh"])[:s["rpn_post_nms_top_n"]]
        out.append((boxes[keep], scores[keep]))
    return out


def bilinear(feature: torch.Tensor, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """torchvision's roi_align bilinear_interpolate of (C, H, W) at points
    (n,) -> (C, n)."""
    C, H, W = feature.shape
    out_of = (y < -1.0) | (y > H) | (x < -1.0) | (x > W)
    y, x = y.clamp(min=0), x.clamp(min=0)
    y_low, x_low = y.to(torch.int64), x.to(torch.int64)
    y_top, x_top = y_low >= H - 1, x_low >= W - 1
    y_low = torch.where(y_top, H - 1, y_low)
    x_low = torch.where(x_top, W - 1, x_low)
    y_high = torch.where(y_top, H - 1, y_low + 1)
    x_high = torch.where(x_top, W - 1, x_low + 1)
    y = torch.where(y_top, y_low.to(y.dtype), y)
    x = torch.where(x_top, x_low.to(x.dtype), x)
    ly, lx = y - y_low, x - x_low
    hy, hx = 1.0 - ly, 1.0 - lx
    v = (hy * hx * feature[:, y_low, x_low] + hy * lx * feature[:, y_low, x_high]
         + ly * hx * feature[:, y_high, x_low] + ly * lx * feature[:, y_high, x_high])
    return torch.where(out_of[None], 0.0, v)


def roi_align(feature: torch.Tensor, box: torch.Tensor, out: int, scale: float,
              sampling: int) -> torch.Tensor:
    """torchvision's roi_align, aligned=False, of one box on one (C, H, W)
    map -> (C, out, out): the gather form, sample by sample."""
    x1, y1, x2, y2 = (box * scale).unbind()
    rw, rh = torch.clamp(x2 - x1, min=1.0), torch.clamp(y2 - y1, min=1.0)
    bw, bh = rw / out, rh / out
    i = torch.arange(out, dtype=torch.float32, device=feature.device)
    g = (torch.arange(sampling, dtype=torch.float32, device=feature.device) + 0.5)
    ys = (y1 + i[:, None] * bh + g[None, :] * bh / sampling).reshape(-1)
    xs = (x1 + i[:, None] * bw + g[None, :] * bw / sampling).reshape(-1)
    n = out * sampling
    v = bilinear(feature, ys.repeat_interleave(n), xs.repeat(n))
    return v.reshape(-1, out, sampling, out, sampling).sum((2, 4)) / (sampling * sampling)


def multiscale_roi_align(feats: list, boxes: list, image_hw: tuple, out: int,
                         sampling: int = 2) -> torch.Tensor:
    """MultiScaleRoIAlign over [P2..P5] of each image's boxes -> (R, C, out,
    out), level by torchvision's LevelMapper (k 2-5, canonical 224 at 4)."""
    scales = [2.0 ** round(math.log2(f.shape[-2] / image_hw[0])) for f in feats]
    k_min, k_max = -math.log2(scales[0]), -math.log2(scales[-1])
    rows = []
    for b, bx in enumerate(boxes):
        s = torch.sqrt((bx[:, 2] - bx[:, 0]) * (bx[:, 3] - bx[:, 1]))
        lvl = torch.floor(4 + torch.log2(s / 224) + torch.tensor(1e-6, dtype=s.dtype))
        lvl = (torch.clamp(lvl, min=k_min, max=k_max).to(torch.int64) - int(k_min)).tolist()
        for box, k in zip(bx, lvl):
            rows.append(roi_align(feats[k][b].float(), box, out, scales[k], sampling))
    if not rows:
        return feats[0].new_zeros((0, feats[0].shape[1], out, out), dtype=torch.float32)
    return torch.stack(rows)


def box_features(p: dict, feats: list, proposals: list, image_hw: tuple, quant=None):
    """The box head's MLP (R, 1024) over every image's proposals, in order."""
    x = multiscale_roi_align(feats[:4], proposals, image_hw, 7).flatten(1)
    x = F.relu(linear(p, "roi_heads.box_head.fc6", x, quant))
    return F.relu(linear(p, "roi_heads.box_head.fc7", x, quant))


def box_predictor(p: dict, x: torch.Tensor, quant=None):
    """(class logits (R, n_classes), box deltas (R, 4 n_classes))."""
    return (linear(p, "roi_heads.box_predictor.cls_score", x, quant),
            linear(p, "roi_heads.box_predictor.bbox_pred", x, quant))


def box_head(p: dict, feats: list, proposals: list, image_hw: tuple, quant=None):
    """(class logits (R, n_classes), box deltas (R, 4 n_classes)) of every
    image's proposals, in order."""
    return box_predictor(p, box_features(p, feats, proposals, image_hw, quant), quant)


def postprocess(logits, deltas, proposals: list, image_hw: tuple, s: dict) -> list:
    """[(boxes (d, 4), scores (d,), labels (d,)) an image], as torchvision's
    RoIHeads.postprocess_detections."""
    boxes = decode(deltas, torch.cat(proposals), BOX_WEIGHTS)
    scores = F.softmax(logits, -1)
    out, start = [], 0
    for props in proposals:
        n = len(props)
        bx, sc = clip(boxes[start:start + n], image_hw), scores[start:start + n]
        start += n
        labels = torch.arange(sc.shape[1], device=sc.device).view(1, -1).expand_as(sc)
        bx, sc, labels = bx[:, 1:].reshape(-1, 4), sc[:, 1:].reshape(-1), labels[:, 1:].reshape(-1)
        inds = torch.where(sc > s["box_score_thresh"])[0]
        bx, sc, labels = bx[inds], sc[inds], labels[inds]
        keep = not_small(bx, s["box_min_size"])
        bx, sc, labels = bx[keep], sc[keep], labels[keep]
        keep = batched_nms(bx, sc, labels, s["box_nms_thresh"])[:s["box_detections_per_img"]]
        out.append((bx[keep], sc[keep], labels[keep]))
    return out


def mask_head(p: dict, feats: list, boxes: list, image_hw: tuple, quant=None) -> torch.Tensor:
    """Mask logits (D, n_classes, 28, 28) of every image's detections."""
    x = multiscale_roi_align(feats[:4], boxes, image_hw, 14)
    rh = "roi_heads"
    for k in range(1, 5):
        x = F.relu(conv(p, f"{rh}.mask_head.mask_fcn{k}", x, padding=1, quant=quant))
    name = f"{rh}.mask_predictor.conv5_mask"
    x = F.relu(F.conv_transpose2d(_q(quant, x), _q(quant, p[f"{name}.weight"]), p[f"{name}.bias"],
                                  stride=2))
    return conv(p, f"{rh}.mask_predictor.mask_fcn_logits", x, quant=quant)


def paste_masks(probs: torch.Tensor, boxes: torch.Tensor, image_hw: tuple,
                padding: int = 1) -> torch.Tensor:
    """torchvision's paste_masks_in_image: each (M, M) mask padded by one
    cell, resized bilinearly into its box expanded by (M + 2) / M and cut to
    the image -> (D, H, W) float32."""
    M = probs.shape[-1]
    scale = float(M + 2 * padding) / M
    padded = F.pad(probs, (padding,) * 4)
    w_half = (boxes[:, 2] - boxes[:, 0]) * 0.5
    h_half = (boxes[:, 3] - boxes[:, 1]) * 0.5
    x_c = (boxes[:, 2] + boxes[:, 0]) * 0.5
    y_c = (boxes[:, 3] + boxes[:, 1]) * 0.5
    w_half = w_half * scale
    h_half = h_half * scale
    ib = torch.stack([x_c - w_half, y_c - h_half, x_c + w_half, y_c + h_half], 1).to(torch.int64)
    H, W = image_hw
    out = probs.new_zeros((len(probs), H, W))
    for k, (m, b) in enumerate(zip(padded, ib.tolist())):
        w, h = max(b[2] - b[0] + 1, 1), max(b[3] - b[1] + 1, 1)
        m = F.interpolate(m[None, None], size=(h, w), mode="bilinear", align_corners=False)[0, 0]
        x0, x1 = max(b[0], 0), min(b[2] + 1, W)
        y0, y1 = max(b[1], 0), min(b[3] + 1, H)
        if x1 > x0 and y1 > y0:
            out[k, y0:y1, x0:x1] = m[y0 - b[1]:y1 - b[1], x0 - b[0]:x1 - b[0]]
    return out


def forward(p: dict, images: torch.Tensor, s: dict = SETTINGS, quant=None) -> dict:
    """The whole eval forward on images (B, 3, H, W) in [0, 1], every stage
    from its own predecessor: {x, image_hw, features, logits, deltas,
    anchors, proposals, class_logits, box_deltas, detections, mask_logits,
    masks ([(D, H, W)] pasted probabilities an image)}."""
    x, hw = transform(images, s["min_size"], s["max_size"])
    feats = features(p, x, s["frozen_bn_eps"], quant)
    logits, deltas = rpn_head(p, feats, quant)
    anc = anchors([f.shape[-2:] for f in feats], x.shape[-2:], s["anchor_sizes"],
                  s["aspect_ratios"], x.device)
    props = filter_proposals(logits, deltas, anc, hw, s)
    proposals = [b for b, _ in props]
    cls, box = box_head(p, feats, proposals, hw, quant)
    dets = postprocess(cls, box, proposals, hw, s)
    mask_logits = mask_head(p, feats, [d[0] for d in dets], hw, quant)
    labels = torch.cat([d[2] for d in dets])
    probs = mask_logits[torch.arange(len(labels), device=labels.device), labels].sigmoid()
    ratio = (images.shape[-2] / hw[0], images.shape[-1] / hw[1])
    masks, start = [], 0
    for bx, _, _ in dets:
        resized = bx * torch.tensor([ratio[1], ratio[0], ratio[1], ratio[0]], device=bx.device)
        masks.append(paste_masks(probs[start:start + len(bx)], resized, images.shape[-2:]))
        start += len(bx)
    return dict(x=x, image_hw=hw, features=feats, logits=logits, deltas=deltas, anchors=anc,
                proposals=proposals, class_logits=cls, box_deltas=box, detections=dets,
                mask_logits=mask_logits, masks=masks)


@torch.no_grad()
def seeded_weights(n_classes: int, generator: torch.Generator, images: torch.Tensor,
                   s: dict = SETTINGS, bn3_gamma: float = 0.1, rpn_logit_std: float = 1.0,
                   rpn_delta_std: float = 0.1, cls_logit_std: float = 1.0,
                   box_delta_std: float = 0.5, mask_logit_std: float = 2.0,
                   detections_target: int = 50) -> dict:
    """{name: tensor} of a Mask R-CNN from a seed, on images' device, set up
    on a calibration batch `images` (B, 3, H, W) in [0, 1] so that every
    stage has a trained detector's kind of output:

    - convolutions and linear layers He-normal, biases 0, the weights drawn
      by `generator` in param_shapes' order;
    - frozen BatchNorm: scale 1 (the last of each block: bn3_gamma, so the
      residual stream keeps its scale), shift 0, statistics from the batch
      (`features(calibrate=True)`);
    - the RPN's logits and deltas, the box predictor's class logits and
      deltas and the mask logits scaled to the given spreads on the batch;
    - the background's class bias raised until the median count of
      detections an image of the batch (after the score threshold, the
      class NMS and the cap) is at most detections_target: a trained
      detector's few confident detections, where a random head's softmax
      leaves every class near 1 / n_classes. The more images, the less the
      count a frame varies from seed to seed."""
    dev = images.device
    p = {}
    for name, shape in param_shapes(n_classes).items():
        if len(shape) in (2, 4) and name.endswith(".weight"):
            fan_in = shape[0] if "conv5_mask" in name else math.prod(shape[1:])
            p[name] = torch.randn(shape, generator=generator, device=dev) * (2.0 / fan_in) ** 0.5
        else:
            fill = 1.0 if name.endswith(("running_var", "bn1.weight", "bn2.weight",
                                         "downsample.1.weight")) else 0.0
            p[name] = torch.full(shape, bn3_gamma if name.endswith("bn3.weight") else fill,
                                 device=dev)

    def spread(name, out, std):
        p[f"{name}.weight"] *= std / out.float().std().clamp_min(1e-12)

    x, hw = transform(images, s["min_size"], s["max_size"])
    feats = features(p, x, s["frozen_bn_eps"], calibrate=True)
    logits, deltas = rpn_head(p, feats)
    spread("rpn.head.cls_logits", torch.cat([t.flatten() for t in logits]), rpn_logit_std)
    spread("rpn.head.bbox_pred", torch.cat([t.flatten() for t in deltas]), rpn_delta_std)
    logits, deltas = rpn_head(p, feats)
    anc = anchors([f.shape[-2:] for f in feats], x.shape[-2:], s["anchor_sizes"],
                  s["aspect_ratios"], dev)
    proposals = [b for b, _ in filter_proposals(logits, deltas, anc, hw, s)]
    rh = "roi_heads"
    x = box_features(p, feats, proposals, hw)
    cls, box = box_predictor(p, x)
    spread(f"{rh}.box_predictor.cls_score", cls, cls_logit_std)
    spread(f"{rh}.box_predictor.bbox_pred", box, box_delta_std)
    cls, box = box_predictor(p, x)
    del x

    def median_count(bias):
        c = cls.clone()
        c[:, 0] += bias
        counts = sorted(len(d[0]) for d in postprocess(c, box, proposals, hw, s))
        return counts[len(counts) // 2]

    lo, hi = 0.0, 1.0
    while median_count(hi) > detections_target:
        lo, hi = hi, 2 * hi
    for _ in range(10):
        mid = (lo + hi) / 2
        lo, hi = (mid, hi) if median_count(mid) > detections_target else (lo, mid)
    p[f"{rh}.box_predictor.cls_score.bias"][0] = hi
    cls[:, 0] += hi
    dets = postprocess(cls, box, proposals, hw, s)
    masks = mask_head(p, feats, [d[0] for d in dets], hw)
    if len(masks):
        spread(f"{rh}.mask_predictor.mask_fcn_logits", masks, mask_logit_std)
    return p
