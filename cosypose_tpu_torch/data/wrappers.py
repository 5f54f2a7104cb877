"""Samplers of the training loop, dataset concatenation, the visibility
filter and the multiview grouping (port of VisibilityWrapper, PartialSampler,
ListSampler, DistributedSceneSampler, ConcatSceneDataset and MultiViewWrapper
in cosypose_tpu/data/wrappers.py,
and of the training loop's dataset concat). PartialSampler and
DistributedSceneSampler draw with numpy's RandomState exactly as the JAX
package does, so epoch orders and rank splits are equal. RankBatchSampler
cuts a data-parallel rank's rows out of each global batch."""

from __future__ import annotations

import numpy as np


class VisibilityWrapper:
    """A scene dataset whose frames keep only the objects with visib_fract
    at or above the threshold (1.0 where an object has no visib_fract)."""

    def __init__(self, scene_ds, visib_fract_th: float = 0.1):
        self.scene_ds = scene_ds
        self.visib_fract_th = visib_fract_th

    def __len__(self):
        return len(self.scene_ds)

    @property
    def frame_index(self):
        return self.scene_ds.frame_index

    def __getitem__(self, idx):
        rgb, mask, obs = self.scene_ds[idx]
        objects = [o for o in obs["objects"] if o.get("visib_fract", 1.0) >= self.visib_fract_th]
        return rgb, mask, dict(obs, objects=objects)


class PartialSampler:
    """Random epoch_size subset of dataset indices (ref: samplers.py:7-17)."""

    def __init__(self, ds, epoch_size: int, seed: int = 0):
        self.n = len(ds)
        self.epoch_size = min(epoch_size, self.n)
        self.rng = np.random.RandomState(seed)

    def __iter__(self):
        return iter(self.rng.permutation(self.n)[: self.epoch_size].tolist())

    def __len__(self):
        return self.epoch_size


class RankBatchSampler:
    """Full global batches of `batch_size` in the sampler's order (the rest
    dropped), of which rank r of `world` yields its contiguous rows
    [r·b/w, (r+1)·b/w): every rank walks the same order, and the ranks
    together take each global batch as one process would."""

    def __init__(self, sampler, batch_size: int, rank: int = 0, world: int = 1):
        if batch_size % world:
            raise ValueError(f"global batch {batch_size} does not split over {world} ranks")
        self.sampler, self.batch_size, self.rank, self.world = sampler, batch_size, rank, world

    def __iter__(self):
        per = self.batch_size // self.world
        ids = list(self.sampler)
        for start in range(0, len(ids) - self.batch_size + 1, self.batch_size):
            yield ids[start + self.rank * per:start + (self.rank + 1) * per]

    def __len__(self):
        return len(self.sampler) // self.batch_size


class DistributedSceneSampler:
    """A rank's part of a dataset's indices: a RandomState(seed) permutation
    (when shuffling), split by numpy's array_split (ref: samplers.py:20-34)."""

    def __init__(self, ds, num_replicas: int, rank: int, shuffle: bool = True, seed: int = 0):
        indices = np.arange(len(ds))
        if shuffle:
            indices = np.random.RandomState(seed).permutation(indices)
        self.indices = np.array_split(indices, num_replicas)[rank].tolist()

    def __iter__(self):
        return iter(self.indices)

    def __len__(self):
        return len(self.indices)


class ListSampler:
    def __init__(self, ids):
        self.ids = list(ids)

    def __iter__(self):
        return iter(self.ids)

    def __len__(self):
        return len(self.ids)


class ConcatDataset:
    """Dataset concat with integer repeat factors (ref: train_pose.py:216-227)."""

    def __init__(self, datasets_with_repeats):
        self.datasets = []
        for ds, repeat in datasets_with_repeats:
            self.datasets.extend([ds] * int(repeat))
        self.lengths = [len(d) for d in self.datasets]
        self.cum = np.cumsum([0] + self.lengths)

    def __len__(self):
        return int(self.cum[-1])

    def __getitem__(self, idx):
        if not 0 <= idx < len(self):
            raise IndexError(idx)
        d = int(np.searchsorted(self.cum[1:], idx, side="right"))
        return self.datasets[d][idx - int(self.cum[d])]


class ConcatSceneDataset(ConcatDataset):
    """Several scene datasets as one: items in order, and their frame
    indexes concatenated (a FrameIndex of the columns all of them have)."""

    def __init__(self, datasets):
        from .bop import FrameIndex

        super().__init__([(ds, 1) for ds in datasets])
        columns = set.intersection(*(set(ds.frame_index.columns) for ds in self.datasets))
        self.frame_index = FrameIndex({
            k: np.concatenate([ds.frame_index[k] for ds in self.datasets])
            for k in self.datasets[0].frame_index.columns if k in columns})


class MultiViewWrapper:
    """A scene dataset's frames in view groups of at most n_views a scene,
    in the JAX package's seeded order; item idx is the list of the group's
    (rgb, mask, obs), each obs's frame_info carrying its group_id."""

    def __init__(self, scene_ds, n_views: int = 4, seed: int = 0):
        from .bop import FrameIndex

        self.scene_ds = scene_ds
        self.n_views = n_views
        scene_ids = np.asarray(scene_ds.frame_index["scene_id"])
        rng = np.random.RandomState(seed)
        self.groups = []
        for scene_id in np.unique(scene_ids):
            ids = np.flatnonzero(scene_ids == scene_id)
            ids = ids[rng.permutation(len(ids))]
            for start in range(0, len(ids), n_views):
                self.groups.append(dict(group_id=len(self.groups), scene_id=int(scene_id),
                                        ds_ids=ids[start:start + n_views]))
        self.frame_index = FrameIndex(dict(
            group_id=[g["group_id"] for g in self.groups],
            scene_id=[g["scene_id"] for g in self.groups],
            n_views=[len(g["ds_ids"]) for g in self.groups]))

    def __len__(self):
        return len(self.groups)

    def __getitem__(self, idx):
        g = self.groups[idx]
        out = []
        for ds_idx in g["ds_ids"]:
            rgb, mask, obs = self.scene_ds[int(ds_idx)]
            obs = dict(obs, frame_info=dict(obs["frame_info"], group_id=g["group_id"]))
            out.append((rgb, mask, obs))
        return out
