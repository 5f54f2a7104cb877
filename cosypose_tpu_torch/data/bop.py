"""BOP-format dataset ingestion, host side (port of cosypose_tpu/data/bop.py).

Reads the BOP directory layout (scene_camera.json / scene_gt.json /
scene_gt_info.json per scene; rgb/, depth/, mask_visib/), indexes the frames,
and yields per-frame observations:

    rgb (H, W, 3) uint8, mask (H, W) int32 (instance ids), obs dict with
    objects [{label, TWO, bbox, visib_fract, id_in_segm}], camera {K, TWC,
    resolution [, depth]}, frame_info {scene_id, view_id}.

mm→m on all translations and depths, as in the JAX package. The frame index
is a FrameIndex (int columns) in place of the JAX package's pandas frame, and
is cached in the same `cosypose_tpu_index.json` ({column: [values]}), so a
cache written by either package is read by both. Images decode through
utils/png.imread: PNG, and JPEG (BOP's PBR splits) through the host decoder
csrc/jpeg_decode.cpp, equal to Pillow's; a grayscale frame is repeated to
three channels, as in the JAX package.
"""

from __future__ import annotations

import copy
import json
import pathlib

import numpy as np

from ..utils.png import imread

INDEX_FILE = "cosypose_tpu_index.json"
COLUMNS = ("scene_id", "view_id")


def _load_json(path):
    with open(path) as f:
        return json.load(f)


class FrameIndex:
    """A small column store of int64 columns: len, row access and selection."""

    def __init__(self, columns: dict):
        columns = columns or {c: [] for c in COLUMNS}
        self.columns = {k: np.asarray(v, np.int64).reshape(-1) for k, v in columns.items()}
        if len({len(v) for v in self.columns.values()}) > 1:
            raise ValueError("FrameIndex columns differ in length")

    def __len__(self):
        return len(next(iter(self.columns.values()))) if self.columns else 0

    def __getitem__(self, column: str) -> np.ndarray:
        return self.columns[column]

    def row(self, i: int) -> dict:
        return {k: int(v[i]) for k, v in self.columns.items()}

    def select(self, keep) -> "FrameIndex":
        """The rows where `keep` (a boolean mask, or row numbers) holds, in order."""
        return FrameIndex({k: v[np.asarray(keep)] for k, v in self.columns.items()})

    def to_dict(self) -> dict:
        return {k: v.tolist() for k, v in self.columns.items()}


class BOPObjectDataset:
    """Parses models_info.json → object specs (label, mesh path, units,
    symmetries, diameter)."""

    def __init__(self, ds_dir):
        ds_dir = pathlib.Path(ds_dir)
        infos = _load_json(ds_dir / "models_info.json")
        objects = []
        for obj_id_str, info in sorted(infos.items(), key=lambda kv: int(kv[0])):
            label = f"obj_{int(obj_id_str):06d}"
            objects.append(dict(
                label=label,
                category=None,
                mesh_path=str(ds_dir / f"{label}.ply"),
                mesh_units="mm",
                symmetries_discrete=info.get("symmetries_discrete", []),
                symmetries_continuous=info.get("symmetries_continuous", []),
                diameter=info.get("diameter"),
                diameter_m=(info["diameter"] / 1000.0 if "diameter" in info else None),
            ))
        self.objects = objects
        self.ds_dir = ds_dir

    def __getitem__(self, idx):
        return self.objects[idx]

    def __len__(self):
        return len(self.objects)

    def mesh_specs(self):
        """→ list[MeshSpec] consumable by ops.mesh_db.build_mesh_db."""
        from ..ops.mesh_db import MeshSpec

        return [MeshSpec(label=o["label"], mesh_path=o["mesh_path"], mesh_units=o["mesh_units"],
                         symmetries_discrete=o["symmetries_discrete"],
                         symmetries_continuous=o["symmetries_continuous"],
                         diameter_m=o["diameter_m"])
                for o in self.objects]


class BOPDataset:
    """Scene dataset over a BOP split directory."""

    def __init__(self, ds_dir, split: str = "train", load_depth: bool = False,
                 cache_in_memory: bool = False):
        self.ds_dir = pathlib.Path(ds_dir)
        self.split_dir = self.ds_dir / split
        self.split = split
        # in-RAM frame cache: each frame decodes once a process
        self.cache_in_memory = cache_in_memory
        self._cache = {}
        self.load_depth = load_depth
        if not self.split_dir.exists():
            raise FileNotFoundError(f"missing split dir {self.split_dir}")
        self.frame_index = self._build_index()

    def _build_index(self) -> FrameIndex:
        cache = self.split_dir / INDEX_FILE
        if cache.exists():
            return FrameIndex(_load_json(cache))
        rows = {c: [] for c in COLUMNS}
        for scene_dir in sorted(self.split_dir.iterdir()):
            cam_json = scene_dir / "scene_camera.json"
            if not scene_dir.is_dir() or not cam_json.exists():
                continue
            scene_id = int(scene_dir.name)
            for view_id_str in sorted(_load_json(cam_json).keys(), key=int):
                rows["scene_id"].append(scene_id)
                rows["view_id"].append(int(view_id_str))
        index = FrameIndex(rows if rows["scene_id"] else {})
        try:
            cache.write_text(json.dumps(index.to_dict() if len(index) else {}))
        except OSError:
            pass  # a read-only dataset directory: the index is rebuilt each run
        return index

    def __len__(self):
        return len(self.frame_index)

    def _scene_dir(self, scene_id):
        return self.split_dir / f"{scene_id:06d}"

    def __getitem__(self, idx):
        if self.cache_in_memory:
            hit = self._cache.get(idx)
            if hit is None:
                hit = self._cache[idx] = self._load_item(idx)
            rgb, mask, obs = hit
            return rgb.copy(), mask.copy(), copy.deepcopy(obs)
        return self._load_item(idx)

    def _load_item(self, idx):
        row = self.frame_index.row(idx)
        scene_id, view_id = row["scene_id"], row["view_id"]
        scene_dir = self._scene_dir(scene_id)

        cam = _load_json(scene_dir / "scene_camera.json")[str(view_id)]
        K = np.asarray(cam["cam_K"], np.float32).reshape(3, 3)
        TWC = np.eye(4, dtype=np.float32)
        if "cam_R_w2c" in cam:
            T_w2c = np.eye(4, dtype=np.float32)
            T_w2c[:3, :3] = np.asarray(cam["cam_R_w2c"], np.float32).reshape(3, 3)
            T_w2c[:3, 3] = np.asarray(cam["cam_t_w2c"], np.float32) / 1000.0
            TWC = np.linalg.inv(T_w2c)

        rgb_path = scene_dir / "rgb" / f"{view_id:06d}.png"
        if not rgb_path.exists():
            rgb_path = scene_dir / "rgb" / f"{view_id:06d}.jpg"
        rgb = imread(rgb_path)
        if rgb.ndim == 2:
            rgb = np.repeat(rgb[..., None], 3, axis=-1)
        # the JAX package slices Pillow's array as it comes: an RGBA frame keeps
        # R, G, B and a CMYK (JPEG) frame its C, M, Y as Pillow presents them
        rgb = rgb[..., :3]
        h, w = rgb.shape[:2]

        camera = dict(K=K, TWC=TWC, resolution=(h, w))
        if self.load_depth:
            depth_path = scene_dir / "depth" / f"{view_id:06d}.png"
            if depth_path.exists():
                depth = imread(depth_path).astype(np.float32)
                depth *= cam.get("depth_scale", 1.0) / 1000.0  # mm → m
                camera["depth"] = depth

        # a precomputed aggregate id mask (<view>_all.png) replaces the
        # per-object files where it exists
        all_mask_path = scene_dir / "mask_visib" / f"{view_id:06d}_all.png"
        if all_mask_path.exists():
            mask = imread(all_mask_path).astype(np.int32)
        else:
            mask = np.zeros((h, w), dtype=np.int32)
        objects = []
        gt_path = scene_dir / "scene_gt.json"
        if gt_path.exists():
            gts = _load_json(gt_path)[str(view_id)]
            infos_path = scene_dir / "scene_gt_info.json"
            gt_infos = (_load_json(infos_path)[str(view_id)] if infos_path.exists()
                        else [{} for _ in gts])
            for n, (gt, info) in enumerate(zip(gts, gt_infos)):
                TCO = np.eye(4, dtype=np.float32)  # the object in the camera frame
                TCO[:3, :3] = np.asarray(gt["cam_R_m2c"], np.float32).reshape(3, 3)
                TCO[:3, 3] = np.asarray(gt["cam_t_m2c"], np.float32) / 1000.0
                obj = dict(label=f"obj_{int(gt['obj_id']):06d}", TWO=TWC @ TCO,
                           visib_fract=info.get("visib_fract", 1.0), id_in_segm=n + 1)
                bbox = info.get("bbox_visib")
                if bbox is not None:
                    x, y, bw, bh = bbox
                    obj["bbox"] = np.asarray([x, y, x + bw, y + bh], np.float32)
                objects.append(obj)

                if not all_mask_path.exists():
                    mask_path = scene_dir / "mask_visib" / f"{view_id:06d}_{n:06d}.png"
                    if mask_path.exists():
                        mask[imread(mask_path) > 0] = n + 1

        obs = dict(objects=objects, camera=camera,
                   frame_info=dict(scene_id=scene_id, view_id=view_id))
        return rgb, mask, obs
