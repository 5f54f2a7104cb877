"""The one traffic generator: it reads a mix's parameters (a file under
benchmark/traffic/) and makes that mix's inputs from the run's seed.

Every seed gets the same multiset of sizes: the mix's per-request sizes are
dealt in blocks, each block a seeded permutation of the mix's `sizes` list,
so two seeds differ in order and content, not in the amount of work.

Kinds of mix:
- `frames`: requests of one frame each, with `sizes[k]` detections of distinct
  objects at seeded poses; each box is the projection of its object's mesh at
  its pose. The frame itself is seeded noise made on the device.
- `train_items`: an indexable set of training items (image uint8 CHW, K, TCO,
  bbox, label), each made from (seed, index) when it is read, so that loader
  workers hold no images and any number of items costs no set-up.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark.harness.scene import meshes, stream


class DealtSizes:
    """Size k of a list dealt in blocks, each a seeded permutation of
    `sizes`: every seed sends the same multiset, in its own order."""

    def __init__(self, sizes: list, seed: int):
        self.sizes, self.seed, self.blocks = list(sizes), seed, {}

    def __getitem__(self, k: int):
        b, r = divmod(k, len(self.sizes))
        if b not in self.blocks:
            rng = np.random.RandomState(stream(self.seed, "sizes", b) % 2 ** 32)
            self.blocks[b] = rng.permutation(len(self.sizes))
        return self.sizes[self.blocks[b][r]]


def camera(mix: dict) -> np.ndarray:
    fx, fy, cx, cy = mix["intrinsics"]
    return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)


def random_rotations(rng: np.random.RandomState, n: int) -> np.ndarray:
    """Uniform rotations from unit quaternions."""
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    x, y, z, w = q.T
    return np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
                     2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
                     2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
                    -1).reshape(n, 3, 3)


def poses_and_boxes(mix: dict, rng, points_m: list, labels: np.ndarray, K: np.ndarray):
    """Seeded object poses (rotation uniform, translation in the mix's box)
    and the boxes of the objects' points projected at them."""
    n = len(labels)
    T = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    T[:, :3, :3] = random_rotations(rng, n)
    lo, hi = np.array(mix["translation_min"]), np.array(mix["translation_max"])
    T[:, :3, 3] = lo + rng.uniform(size=(n, 3)) * (hi - lo)
    boxes = np.zeros((n, 4), np.float32)
    for k, obj in enumerate(labels):
        cam = points_m[obj] @ T[k, :3, :3].T.astype(np.float64) + T[k, :3, 3]
        uv = cam @ K.T.astype(np.float64)
        uv = uv[:, :2] / uv[:, 2:3]
        boxes[k] = np.concatenate([uv.min(0), uv.max(0)])
    return T, boxes


@dataclasses.dataclass
class Frame:
    index: int
    image: torch.Tensor    # (1, 3, H, W) float32 in [0, 1], on the device
    K: torch.Tensor        # (1, 3, 3)
    labels: np.ndarray     # (n,) object indices, distinct
    boxes: np.ndarray      # (n, 4) float32
    TCO: np.ndarray        # (n, 4, 4) the poses the boxes were made from


class FrameRequests:
    """Request i of a `frames` mix, the same for the same (seed, i)."""

    def __init__(self, mix: dict, cfg: dict, seed: int, objects: list, device):
        self.mix, self.seed, self.device = mix, seed, device
        self.size = tuple(cfg["image_size"])
        self.K = camera(mix)
        self.points_m = [m["verts"] * 1e-3 for m in objects]
        self.n_det = DealtSizes(mix["sizes"], seed)

    def __call__(self, i: int) -> Frame:
        n = self.n_det[i]
        rng = np.random.RandomState(stream(self.seed, "frame", i) % 2 ** 32)
        labels = rng.choice(len(self.points_m), size=n, replace=False)
        T, boxes = poses_and_boxes(self.mix, rng, self.points_m, labels, self.K)
        gen = torch.Generator(device=self.device).manual_seed(stream(self.seed, "image", i))
        image = torch.rand(1, 3, *self.size, generator=gen, device=self.device)
        K = torch.as_tensor(self.K, device=self.device)[None]
        return Frame(i, image, K, labels, boxes, T)


class TrainItems:
    """Item i of a `train_items` mix: {image, K, TCO, bbox, label}; item i
    shows object i mod n_objects. It pickles small (the meshes are made again
    where it is first read), so that starting a loader worker never waits
    for the worker to read a large pickle."""

    def __init__(self, mix: dict, cfg: dict, seed: int):
        self.mix, self.cfg, self.seed = mix, cfg, seed
        self.size = tuple(cfg["image_size"])
        self.K = camera(mix)
        self.labels = [f"obj_{i + 1:06d}" for i in range(cfg["n_objects"])]
        self.points_m = None

    def __getstate__(self):
        return {**self.__dict__, "points_m": None}

    def __len__(self):
        return self.mix["n_items"]

    def __getitem__(self, i: int) -> dict:
        if self.points_m is None:
            self.points_m = [m["verts"] * 1e-3 for m in meshes(self.cfg)]
        rng = np.random.RandomState(stream(self.seed, "item", int(i)) % 2 ** 32)
        obj = int(i) % len(self.labels)
        T, boxes = poses_and_boxes(self.mix, rng, self.points_m, np.array([obj]), self.K)
        image = np.random.default_rng(stream(self.seed, "pixels", int(i))).integers(
            0, 256, (3, *self.size), dtype=np.uint8)
        return dict(image=image, K=self.K, TCO=T[0], bbox=boxes[0], label=self.labels[obj])


class SeededOrder:
    """A sampler: the mix's item indices in a seeded order, each once."""

    def __init__(self, n: int, seed: int):
        self.n, self.seed = n, seed

    def __iter__(self):
        rng = np.random.RandomState(stream(self.seed, "order") % 2 ** 32)
        return iter(rng.permutation(self.n).tolist())

    def __len__(self):
        return self.n


def train_draws(batch: int, n_points: int, n_loss_points: int, keep_rates: list,
                n_iterations: int, generator: torch.Generator) -> dict:
    """One step's random numbers, on the CPU: point_ids (the loss's point
    subset), pose_noise (two (B,3) standard normals: rotation, translation),
    drop_masks (per iteration, per block: (B,) keep flags, None where the
    block drops nothing) and jitter (None: no photometric jitter)."""
    point_ids = torch.randperm(n_points, generator=generator)[:min(n_loss_points, n_points)]
    noise = (torch.randn(batch, 3, generator=generator), torch.randn(batch, 3, generator=generator))
    masks = [[torch.rand(batch, generator=generator) < k if k < 1.0 else None for k in keep_rates]
             for _ in range(n_iterations)]
    return dict(point_ids=point_ids, pose_noise=noise, drop_masks=masks, jitter=None)
