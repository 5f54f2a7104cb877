"""Texture image dataset for recording-time domain randomization (port of
cosypose_tpu/data/texture_dataset.py).

An indexable collection of the {png,jpg,jpeg} images below a directory, each
returned as float32 HxWx3 in [0, 1] for the corner-baking projector
(recording/textures.py). Images decode through utils/png.imread, PNG or JPEG
(ShapeNet's textures are JPEG), and `as_rgb` gives Pillow's convert("RGB")
from the mode the decoder names (a JPEG's four channels are CMYK, a PNG's RGBA).
"""

from __future__ import annotations

import pathlib

import numpy as np

from ..utils.png import imread
from .pillow_ops import cmyk_to_rgb


def as_rgb(image: np.ndarray, mode: str) -> np.ndarray:
    """PIL's convert("RGB") of a decoded 8-bit image of mode L, LA, RGB, RGBA
    or CMYK (utils/png.imread(..., with_mode=True) names it)."""
    if image.dtype != np.uint8:
        raise ValueError(f"want an 8-bit image, got {image.dtype} ({mode})")
    if mode == "L":
        return np.repeat(image[..., None], 3, axis=-1)
    if mode == "LA":
        return np.repeat(image[..., :1], 3, axis=-1)
    if mode == "CMYK":
        return cmyk_to_rgb(image)
    if mode in ("RGB", "RGBA"):
        return np.ascontiguousarray(image[..., :3])
    raise ValueError(f"no conversion to RGB from mode {mode}")


class TextureDataset:
    def __init__(self, ds_dir):
        self.ds_dir = pathlib.Path(ds_dir)
        exts = (".png", ".jpg", ".jpeg")
        self.index = sorted(p for p in self.ds_dir.rglob("*") if p.suffix.lower() in exts)

    def __len__(self):
        return len(self.index)

    def __getitem__(self, idx: int) -> np.ndarray:
        return as_rgb(*imread(self.index[idx], with_mode=True)).astype(np.float32) / 255.0

    def sample(self, rng: np.random.RandomState) -> np.ndarray:
        return self[rng.randint(len(self.index))]
