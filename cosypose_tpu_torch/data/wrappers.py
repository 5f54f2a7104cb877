"""Samplers of the training loop (port of PartialSampler and ListSampler in
cosypose_tpu/data/wrappers.py). PartialSampler draws with numpy's
RandomState exactly as the JAX package does, so epoch orders are equal."""

from __future__ import annotations

import numpy as np


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


class ListSampler:
    def __init__(self, ids):
        self.ids = list(ids)

    def __iter__(self):
        return iter(self.ids)

    def __len__(self):
        return len(self.ids)
