"""Dataset name registries (port of cosypose_tpu/data/datasets_cfg.py).

A name → a scene dataset (BOP splits with '.bop19' target filtering and
ycbv keyframes; 'synthetic.<recorded-name>.<train|val>' for sets written by
the recording pipeline, split by their split_keys.json) or an object dataset
(models / models_cad / models_eval, and the built-in procedural sets). The
root is config.LOCAL_DATA_DIR unless a call names another.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np

from ..config import LOCAL_DATA_DIR
from ..utils.png import image_size
from .bop import BOPDataset, BOPObjectDataset

# BOP dataset splits used by the reference
_BOP_SPLITS = {
    "lm": ("lm", "test"),
    "lmo": ("lmo", "test"),
    "tless": ("tless", "test_primesense"),
    "tudl": ("tudl", "test"),
    "icbin": ("icbin", "test"),
    "itodd": ("itodd", "test"),
    "hb": ("hb", "test_primesense"),
    "ycbv": ("ycbv", "test"),
}
CACHE_BUDGET_BYTES = 8 * 1024 ** 3   # decoded frames a recorded set may keep in RAM


def _frame_size(ds: BOPDataset) -> tuple[int, int]:
    """(h, w) of the first frame from its PNG or JPEG header, as the JAX
    package reads it from Pillow; 480x640 where neither file reads."""
    row = ds.frame_index.row(0)
    scene_dir = ds._scene_dir(row["scene_id"])
    try:
        for ext in ("png", "jpg"):
            p = scene_dir / "rgb" / f"{row['view_id']:06d}.{ext}"
            if p.exists():
                return image_size(p)
    except (OSError, ValueError):   # PNGError and JPEGError are ValueErrors
        pass
    return 480, 640


def _keep_frames(ds: BOPDataset, keep: set) -> None:
    fi = ds.frame_index
    sel = [(s, v) in keep for s, v in zip(fi["scene_id"].tolist(), fi["view_id"].tolist())]
    ds.frame_index = fi.select(np.asarray(sel, bool))


def make_scene_dataset(ds_name: str, ds_root=None, load_depth: bool = False):
    """e.g. 'ycbv.test', 'tless.primesense.test', 'ycbv.train.pbr',
    'ycbv.test.bop19' (keeps only BOP19 target images when the file exists),
    'synthetic.<recorded-name>.<train|val>'."""
    parts = ds_name.split(".")
    name = parts[0]

    if name == "synthetic":
        sub, which = parts[1], (parts[2] if len(parts) > 2 else "train")
        ds_dir = pathlib.Path(ds_root or LOCAL_DATA_DIR) / "synt_datasets" / sub
        ds = BOPDataset(ds_dir, split="train_synt", load_depth=load_depth)
        # small recorded sets keep their decoded frames in RAM; the gate is an
        # estimate of the bytes, from the first frame's size
        est_bytes = 0
        if len(ds):
            h, w = _frame_size(ds)
            est_bytes = len(ds) * h * w * 3
        ds.cache_in_memory = 0 < est_bytes <= CACHE_BUDGET_BYTES
        split_file = ds_dir / "split_keys.json"
        if split_file.exists():
            keys = set(json.loads(split_file.read_text())[which])
            sel = [f"{s:06d}" in keys for s in ds.frame_index["scene_id"].tolist()]
            ds.frame_index = ds.frame_index.select(np.asarray(sel, bool))
        return ds

    root = pathlib.Path(ds_root or LOCAL_DATA_DIR) / "bop_datasets"
    if "train" in parts and "pbr" in parts:
        split = "train_pbr"
    elif "train" in parts and "synt" in parts:
        split = "train_synt"
    elif "train" in parts and "real" in parts:
        split = "train_real"
    elif "train" in parts:
        split = "train"
    elif name == "tless" and "primesense" in parts:
        split = "test_primesense" if "test" in parts else "train_primesense"
    else:
        split = _BOP_SPLITS.get(name, (name, "test"))[1]

    ds = BOPDataset(root / name, split=split, load_depth=load_depth)

    if "keyframes" in parts:
        # the YCB-Video keyframe subset of the paper's protocol
        keyframes_path = root / name / "keyframe.txt"
        if keyframes_path.exists():
            keep = set()
            for line in keyframes_path.read_text().strip().split("\n"):
                s, v = line.split("/")
                keep.add((int(s), int(v)))
            _keep_frames(ds, keep)

    if "bop19" in parts:
        targets = root / name / "test_targets_bop19.json"
        if targets.exists():
            tgt = json.loads(targets.read_text())
            _keep_frames(ds, {(t["scene_id"], t["im_id"]) for t in tgt})
    return ds


def make_object_dataset(ds_name: str, ds_root=None):
    """e.g. 'ycbv.models', 'tless.cad', 'tless.eval', 'ycbv.bop-compat',
    'procedural' and 'procedural-tex' (the built-in data-free object sets)."""
    parts = ds_name.split(".")
    name = parts[0]
    if name in ("procedural", "procedural-tex"):
        from .procedural_objects import ProceduralObjectDataset

        return ProceduralObjectDataset(texture="sine" if name == "procedural-tex" else "twotone")
    root = pathlib.Path(ds_root or LOCAL_DATA_DIR) / "bop_datasets"
    if "cad" in parts:
        subdir = "models_cad"
    elif "eval" in parts:
        subdir = "models_eval"
    else:
        subdir = "models"
    return BOPObjectDataset(root / name / subdir)


def make_texture_dataset(name_or_path: str, ds_root=None):
    """Texture image sets for recording-time randomization: 'shapenet'
    resolves to <data>/textures/shapenet; any other relative name likewise
    under <data>/textures, an absolute path as it is."""
    from .texture_dataset import TextureDataset

    p = pathlib.Path(name_or_path)
    if not p.is_absolute():
        p = pathlib.Path(ds_root or LOCAL_DATA_DIR) / "textures" / name_or_path
    return TextureDataset(p)


def make_urdf_dataset(ds_name: str, ds_root=None):
    """The JAX package's name for `make_object_dataset`: the rasterizer renders
    the PLY meshes, so the reference's URDF assets map to the object dataset."""
    return make_object_dataset(ds_name, ds_root)
