"""Train-time pose dataset: augment, pick one visible object, emit arrays (port
of cosypose_tpu/data/pose_dataset.py).

Crop/resize to the aspect ratio → background paste → photometric jitter →
pick ONE random visible object a frame → (image uint8 CHW, K, TCO, bbox,
label), with a retry loop over random indices when a frame has no valid
object. `collate` makes the training loop's batches of the items. Backgrounds
come from a VOC devkit (`voc_root`, e.g. VOCdevkit/VOC2012: its
JPEGImages/*.jpg), which takes precedence, or from a list of image files;
either is pasted with probability 0.3.

Random streams: the dataset and its augmentations hold `random.Random`
objects seeded as in the JAX package, so with the data loaded in the main
process (`n_dataloader_workers=0`) the items equal the JAX package's item for
item. A DataLoader worker process gets its own copy of the dataset; `reseed`
gives each copy its own streams (train_pose calls it from each worker with
the epoch and the worker's id), where the JAX package's loader threads share
one stream.
"""

from __future__ import annotations

import dataclasses
import random

import numpy as np
import torch

from .augmentations import (BackgroundAugmentation, ColorJitterAugmentation,
                            CropResizeToAspect, SceneObservation, VOCBackgroundAugmentation)


def collate(items) -> dict:
    """PoseDataset items (image uint8 CHW, K, TCO, bbox, label) → a batch of
    tensors (images uint8, K, TCO, bboxes float32) and the labels."""
    return dict(images=torch.as_tensor(np.stack([it["image"] for it in items])),
                K=torch.as_tensor(np.stack([it["K"] for it in items]), dtype=torch.float32),
                TCO=torch.as_tensor(np.stack([it["TCO"] for it in items]), dtype=torch.float32),
                bboxes=torch.as_tensor(np.stack([it["bbox"] for it in items]),
                                       dtype=torch.float32),
                labels=[it["label"] for it in items])


@dataclasses.dataclass
class PoseData:
    """The fields of a batch (the dict `make_batch` and `collate_fn` return)."""
    images: torch.Tensor    # (B, 3, H, W) uint8
    K: torch.Tensor         # (B, 3, 3) float32
    TCO: torch.Tensor       # (B, 4, 4) float32
    bboxes: torch.Tensor    # (B, 4) float32
    labels: list            # length B


PoseBatch = PoseData


class PoseDataset:
    def __init__(self, scene_ds, resize=(480, 640), apply_rgb_augmentation=True,
                 background_image_paths=(), voc_root=None, min_area: float = 0.0,
                 visib_fract_th: float = 0.1, seed: int = 0):
        self.scene_ds = scene_ds
        self.crop_resize = CropResizeToAspect(resize)
        if voc_root is not None:
            self.background_aug = VOCBackgroundAugmentation(voc_root, p=0.3)
        elif background_image_paths:
            self.background_aug = BackgroundAugmentation(background_image_paths, p=0.3)
        else:
            self.background_aug = None
        self.rgb_aug = ColorJitterAugmentation(p=0.4) if apply_rgb_augmentation else None
        self.min_area = min_area
        self.visib_fract_th = visib_fract_th
        self.rng = random.Random(seed)
        self._resized_cache = {}

    def reseed(self, seed: int) -> None:
        """Fresh streams for the object pick, the retries and each augmentation."""
        self.rng = random.Random(seed)
        if self.background_aug is not None:
            self.background_aug.rng = random.Random(seed + 1)
        if self.rgb_aug is not None:
            self.rgb_aug.rng = random.Random(seed + 2)

    def __len__(self):
        return len(self.scene_ds)

    def get_data(self, idx):
        # the deterministic prefix (load + crop-resize) is cached when the scene
        # dataset keeps its frames in RAM; the augmentations and the object
        # pick run on every access
        cached = getattr(self.scene_ds, "cache_in_memory", False)
        s = self._resized_cache.get(idx) if cached else None
        if s is None:
            rgb, mask, obs = self.scene_ds[idx]
            s = self.crop_resize(SceneObservation(np.asarray(rgb), np.asarray(mask), obs))
            if cached:
                self._resized_cache[idx] = s
        if self.background_aug is not None:
            s = self.background_aug(s)
        if self.rgb_aug is not None:
            s = self.rgb_aug(s)

        valid = []
        for o in s.obs["objects"]:
            if o.get("visib_fract", 1.0) < self.visib_fract_th:
                continue
            bbox = o.get("bbox")
            if bbox is None:
                continue
            area = max(0.0, bbox[2] - bbox[0]) * max(0.0, bbox[3] - bbox[1])
            if area <= self.min_area:
                continue
            valid.append(o)
        if not valid:
            return None

        obj = self.rng.choice(valid)
        cam = s.obs["camera"]
        TWC = cam.get("TWC", np.eye(4, dtype=np.float32))
        TCO = np.linalg.inv(TWC) @ obj["TWO"]
        return dict(image=np.transpose(s.rgb, (2, 0, 1)),  # CHW uint8
                    K=np.asarray(cam["K"], np.float32), TCO=TCO.astype(np.float32),
                    bbox=np.asarray(obj["bbox"], np.float32), label=obj["label"])

    def __getitem__(self, idx):
        item = self.get_data(idx)
        tries = 0
        while item is None and tries < 10:
            idx = self.rng.randint(0, len(self) - 1)
            item = self.get_data(idx)
            tries += 1
        if item is None:
            raise ValueError("No valid object found after 10 retries")
        return item

    collate_fn = staticmethod(collate)

    def make_batch(self, ids) -> dict:
        """The items `ids` collated as the training loop collates them."""
        return self.collate_fn([self[i] for i in ids])
