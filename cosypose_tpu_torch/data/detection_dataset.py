"""Train-time detection dataset: fixed-shape CenterNet targets (port of
cosypose_tpu/data/detection_dataset.py).

Each item: crop-resize to the target aspect, the host colour jitter, then
gaussian centre splats on a per-class heatmap at the head's stride, and per
object (up to max_objects, after the visibility, box and area filters) its
width/height and centre offset in head pixels, flat centre index, class,
box and visible mask at head resolution. `reseed` gives a DataLoader
worker's copy its own jitter stream; with 0 workers the items are the JAX
package's.
"""

from __future__ import annotations

import random

import numpy as np
import torch

from .augmentations import ColorJitterAugmentation, CropResizeToAspect, SceneObservation


def gaussian_radius(h, w, min_overlap=0.7):
    """CenterNet's gaussian radius: the least of its three corner cases."""
    b1 = h + w
    c1 = w * h * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 + np.sqrt(max(b1 ** 2 - 4 * c1, 0))) / 2
    b2 = 2 * (h + w)
    c2 = (1 - min_overlap) * w * h
    r2 = (b2 + np.sqrt(max(b2 ** 2 - 16 * c2, 0))) / 2
    a3 = 4 * min_overlap
    b3 = -2 * min_overlap * (h + w)
    c3 = (min_overlap - 1) * w * h
    r3 = (b3 + np.sqrt(max(b3 ** 2 - 4 * a3 * c3, 0))) / 2
    return max(1, int(min(r1, r2, r3)))


def draw_gaussian(heatmap, cx, cy, radius):
    """Max-splat a (2r+1)² gaussian (sigma (2r+1)/6) at (int(cx), int(cy))
    into heatmap (H, W), in place, clipped at the borders."""
    sigma = (2 * radius + 1) / 6.0
    xs = np.arange(-radius, radius + 1)
    g = np.exp(-(xs[None, :] ** 2 + xs[:, None] ** 2) / (2 * sigma ** 2))
    H, W = heatmap.shape
    x0, y0 = int(cx), int(cy)
    left, right = min(x0, radius), min(W - x0, radius + 1)
    top, bottom = min(y0, radius), min(H - y0, radius + 1)
    if right + left <= 0 or bottom + top <= 0:
        return
    region = heatmap[y0 - top:y0 + bottom, x0 - left:x0 + right]
    np.maximum(region, g[radius - top:radius + bottom, radius - left:radius + right], out=region)


class DetectionDataset:
    def __init__(self, scene_ds, label_to_category_id, resize=(480, 640), stride=4,
                 max_objects=32, min_area=64.0, apply_rgb_augmentation=True,
                 visib_fract_th=0.05, seed=0):
        self.scene_ds = scene_ds
        self.label_to_category_id = label_to_category_id
        self.n_classes = len(label_to_category_id)
        self.crop_resize = CropResizeToAspect(resize)
        self.rgb_aug = ColorJitterAugmentation(p=0.4) if apply_rgb_augmentation else None
        self.resize = (min(resize), max(resize))
        self.stride = stride
        self.max_objects = max_objects
        self.min_area = min_area
        self.visib_fract_th = visib_fract_th
        self.reseed(seed)

    def reseed(self, seed: int) -> None:
        if self.rgb_aug is not None:
            self.rgb_aug.rng = random.Random(seed)

    def __len__(self):
        return len(self.scene_ds)

    def __getitem__(self, idx):
        rgb, mask, obs = self.scene_ds[idx]
        s = self.crop_resize(SceneObservation(np.asarray(rgb), np.asarray(mask), obs))
        if self.rgb_aug is not None:
            s = self.rgb_aug(s)

        H, W = self.resize
        Hm, Wm = H // self.stride, W // self.stride
        N = self.max_objects
        heatmap = np.zeros((Hm, Wm, self.n_classes), np.float32)
        wh, offset = np.zeros((N, 2), np.float32), np.zeros((N, 2), np.float32)
        inds, classes = np.zeros((N,), np.int64), np.zeros((N,), np.int64)
        obj_mask = np.zeros((N,), bool)
        boxes = np.zeros((N, 4), np.float32)
        inst_masks = np.zeros((N, Hm, Wm), np.uint8)
        n = 0
        for o in s.obs["objects"]:
            if n >= N:
                break
            bbox = o.get("bbox")
            if o.get("visib_fract", 1.0) < self.visib_fract_th or bbox is None:
                continue
            x1, y1, x2, y2 = bbox
            cat = self.label_to_category_id.get(o["label"])
            if (x2 - x1) * (y2 - y1) < self.min_area or cat is None:
                continue
            cxm, cym = (x1 + x2) / 2 / self.stride, (y1 + y2) / 2 / self.stride
            if not (0 <= cxm < Wm and 0 <= cym < Hm):
                continue
            r = gaussian_radius((y2 - y1) / self.stride, (x2 - x1) / self.stride)
            draw_gaussian(heatmap[..., cat], cxm, cym, r)
            wh[n] = [(x2 - x1) / self.stride, (y2 - y1) / self.stride]
            offset[n] = [cxm - int(cxm), cym - int(cym)]
            inds[n] = int(cym) * Wm + int(cxm)
            obj_mask[n] = True
            boxes[n] = bbox
            classes[n] = cat
            seg_id = o.get("id_in_segm")
            if seg_id is not None:
                m = (s.mask == seg_id)[::self.stride, ::self.stride]
                inst_masks[n, :m.shape[0], :m.shape[1]] = m
            n += 1
        return dict(image=np.transpose(s.rgb, (2, 0, 1)), heatmap=heatmap, wh=wh, offset=offset,
                    inds=inds, obj_mask=obj_mask, boxes=boxes, classes=classes,
                    seg_mask=s.mask > 0, inst_masks=inst_masks)

    @staticmethod
    def collate_fn(items) -> dict:
        return {k: torch.as_tensor(np.stack([it[k] for it in items])) for k in items[0]}
