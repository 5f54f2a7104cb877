"""Texture image dataset for recording-time domain randomization (port of
cosypose_tpu/data/texture_dataset.py).

An indexable collection of the {png,jpg,jpeg} images below a directory, each
returned as float32 HxWx3 in [0, 1] for the corner-baking projector
(recording/textures.py). Images decode through utils/png.imread, PNG or JPEG
(ShapeNet's textures are JPEG), and `as_rgb` gives Pillow's convert("RGB").
"""

from __future__ import annotations

import pathlib

import numpy as np

from ..utils.png import imread


def as_rgb(image: np.ndarray) -> np.ndarray:
    """PIL's convert("RGB") of a decoded 8-bit L, LA, RGB or RGBA array."""
    if image.dtype != np.uint8:
        raise ValueError(f"want an 8-bit image, got {image.dtype}")
    if image.ndim == 2:
        return np.repeat(image[..., None], 3, axis=-1)
    if image.shape[2] == 2:
        return np.repeat(image[..., :1], 3, axis=-1)
    return np.ascontiguousarray(image[..., :3])


class TextureDataset:
    def __init__(self, ds_dir):
        self.ds_dir = pathlib.Path(ds_dir)
        exts = (".png", ".jpg", ".jpeg")
        self.index = sorted(p for p in self.ds_dir.rglob("*") if p.suffix.lower() in exts)

    def __len__(self):
        return len(self.index)

    def __getitem__(self, idx: int) -> np.ndarray:
        return as_rgb(imread(self.index[idx])).astype(np.float32) / 255.0

    def sample(self, rng: np.random.RandomState) -> np.ndarray:
        return self[rng.randint(len(self.index))]
