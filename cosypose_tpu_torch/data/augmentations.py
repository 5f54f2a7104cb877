"""Train-time image augmentations on the host (port of
cosypose_tpu/data/augmentations.py).

Crop-resize to the target aspect ratio with the intrinsics update and bboxes
regenerated from the segmentation, random-background pasting (any image
list, or a VOC devkit's JPEGImages), and the
photometric jitter chain (blur / sharpness / contrast / brightness / colour),
grayscale and centre crop. The Pillow operations are data/pillow_ops.py's
numpy versions, equal to Pillow's bit for bit; the `random.Random` streams
are drawn in the JAX package's order.
"""

from __future__ import annotations

import dataclasses
import pathlib
import random

import numpy as np

from . import pillow_ops
from .texture_dataset import as_rgb
from ..utils.png import imread


@dataclasses.dataclass
class SceneObservation:
    rgb: np.ndarray        # (H, W, 3) uint8
    mask: np.ndarray       # (H, W) int32 instance ids
    obs: dict              # objects / camera / frame_info


def _bbox_from_mask(mask, instance_id):
    ys, xs = np.where(mask == instance_id)
    if len(ys) == 0:
        return np.zeros(4, np.float32)
    return np.asarray([xs.min(), ys.min(), xs.max() + 1, ys.max() + 1], np.float32)


class CropResizeToAspect:
    """Crop to the target aspect ratio then resize, updating K and recomputing
    bboxes from the segmentation mask."""

    def __init__(self, resize=(480, 640)):
        self.resize = (min(resize), max(resize))
        self.aspect = max(resize) / min(resize)

    def __call__(self, s: SceneObservation) -> SceneObservation:
        rgb, mask, obs = s.rgb, s.mask, s.obs
        h, w = rgb.shape[:2]
        if (h, w) == self.resize:
            return s
        # largest centred crop with the target aspect
        crop_w = min(w, int(h * self.aspect))
        crop_h = min(h, int(w / self.aspect))
        x0 = (w - crop_w) // 2
        y0 = (h - crop_h) // 2

        rgb_c = rgb[y0:y0 + crop_h, x0:x0 + crop_w]
        mask_c = mask[y0:y0 + crop_h, x0:x0 + crop_w]
        out_h, out_w = self.resize
        rgb_r = pillow_ops.resize_bilinear(np.ascontiguousarray(rgb_c), (out_h, out_w))
        mask_r = pillow_ops.resize_nearest(mask_c.astype(np.int32), (out_h, out_w))

        K = np.asarray(obs["camera"]["K"], np.float64)
        sx = out_w / crop_w
        sy = out_h / crop_h
        new_K = K.copy()
        new_K[0, 0] *= sx
        new_K[1, 1] *= sy
        # resize about the centre with the reference's (W-1)/2 pixel convention
        new_K[0, 2] = (out_w - 1) / 2.0 + sx * (K[0, 2] - (x0 + crop_w / 2.0))
        new_K[1, 2] = (out_h - 1) / 2.0 + sy * (K[1, 2] - (y0 + crop_h / 2.0))
        new_K = new_K.astype(np.float32)
        obs = dict(obs)
        obs["camera"] = dict(obs["camera"], K=new_K, resolution=self.resize)
        obs["objects"] = [dict(o, bbox=_bbox_from_mask(mask_r, o["id_in_segm"]))
                          for o in obs["objects"]]
        return SceneObservation(rgb_r, mask_r, obs)


class BackgroundAugmentation:
    """Paste the foreground (mask > 0) over a random background image, PNG or
    JPEG, converted to RGB and resized bilinearly to the frame as Pillow does."""

    def __init__(self, image_paths, p=0.3, rng=None):
        self.image_paths = list(image_paths)
        self.p = p
        self.rng = rng or random.Random(0)

    def __call__(self, s: SceneObservation) -> SceneObservation:
        if not self.image_paths or self.rng.random() > self.p:
            return s
        h, w = s.rgb.shape[:2]
        path = self.rng.choice(self.image_paths)
        bg = pillow_ops.resize_bilinear(as_rgb(*imread(path, with_mode=True)), (h, w))
        fg = s.mask > 0
        rgb = np.where(fg[..., None], s.rgb, bg)
        return SceneObservation(rgb, s.mask, s.obs)


class VOCBackgroundAugmentation(BackgroundAugmentation):
    """Background paste from a VOC devkit tree (voc_root is e.g.
    VOCdevkit/VOC2012): the sorted JPEGImages/*.jpg, none where the
    directory is absent, as in the JAX package."""

    def __init__(self, voc_root, p=0.3, rng=None):
        jpeg_dir = pathlib.Path(voc_root) / "JPEGImages"
        paths = sorted(jpeg_dir.glob("*.jpg")) if jpeg_dir.exists() else []
        super().__init__(paths, p=p, rng=rng)


class _PillowJitter:
    def __init__(self, p, factor_interval, op):
        self.p = p
        self.factor_interval = factor_interval
        self.op = op

    def __call__(self, s: SceneObservation, rng) -> SceneObservation:
        if rng.random() > self.p:
            return s
        factor = rng.uniform(*self.factor_interval)
        return SceneObservation(self.op(s.rgb, factor), s.mask, s.obs)


class ColorJitterAugmentation:
    """The reference's jitter chain: blur, sharpness, contrast, brightness,
    colour, each applied with probability p."""

    def __init__(self, p=0.3, seed=0):
        self.rng = random.Random(seed)
        self.ops = [
            _PillowJitter(p, (1, 3), pillow_ops.gaussian_blur),
            _PillowJitter(p, (0.0, 50.0), pillow_ops.sharpness),
            _PillowJitter(p, (0.2, 50.0), pillow_ops.contrast),
            _PillowJitter(p, (0.1, 6.0), pillow_ops.brightness),
            _PillowJitter(p, (0.0, 20.0), pillow_ops.colour),
        ]

    def __call__(self, s: SceneObservation) -> SceneObservation:
        for op in self.ops:
            s = op(s, self.rng)
        return s


class GrayScale:
    def __init__(self, p=0.5, seed=0):
        self.p = p
        self.rng = random.Random(seed)

    def __call__(self, s: SceneObservation) -> SceneObservation:
        if self.rng.random() > self.p:
            return s
        gray = pillow_ops.luminance(s.rgb)
        return SceneObservation(np.repeat(gray[..., None], 3, axis=-1), s.mask, s.obs)


class CenterCrop:
    def __init__(self, crop=(480, 640)):
        self.crop = crop

    def __call__(self, s: SceneObservation) -> SceneObservation:
        h, w = s.rgb.shape[:2]
        ch, cw = self.crop
        y0, x0 = (h - ch) // 2, (w - cw) // 2
        rgb = s.rgb[y0:y0 + ch, x0:x0 + cw]
        mask = s.mask[y0:y0 + ch, x0:x0 + cw]
        K = s.obs["camera"]["K"].copy()
        K[0, 2] -= x0
        K[1, 2] -= y0
        obs = dict(s.obs)
        obs["camera"] = dict(obs["camera"], K=K, resolution=self.crop)
        return SceneObservation(rgb, mask, obs)
