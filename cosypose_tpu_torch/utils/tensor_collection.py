"""Row-aligned host metadata + named tensors, without pandas (the port's
counterpart of cosypose_tpu/utils/tensor_collection.py).

`infos` is a dict of equal-length numpy columns (e.g. 'label', 'batch_im_id',
'score'); tensors are named fields with the same leading row count. Indexing
by ids, `len` and `concatenate` are what the inference API needs.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch


class TensorCollection:
    def __init__(self, infos: dict, **tensors: torch.Tensor):
        infos = {k: np.asarray(v) for k, v in infos.items()}
        lengths = {len(v) for v in infos.values()} | {len(t) for t in tensors.values()}
        if len(lengths) > 1:
            raise ValueError(f"columns and tensors disagree on the row count: {sorted(lengths)}")
        object.__setattr__(self, "infos", infos)
        object.__setattr__(self, "tensors", dict(tensors))

    def __getattr__(self, name):
        tensors = self.__dict__.get("tensors", {})
        if name in tensors:
            return tensors[name]
        raise AttributeError(name)

    def __len__(self) -> int:
        for v in (*self.infos.values(), *self.tensors.values()):
            return len(v)
        return 0

    def __getitem__(self, ids) -> "TensorCollection":
        """Rows by an id array/list or a slice."""
        idx = np.arange(len(self))[ids] if isinstance(ids, slice) else np.asarray(ids)
        infos = {k: v[idx] for k, v in self.infos.items()}
        tensors = {k: t[torch.as_tensor(idx, device=t.device)] for k, t in self.tensors.items()}
        return TensorCollection(infos, **tensors)


def concatenate(collections: Iterable[TensorCollection]) -> TensorCollection:
    """Row-concatenate collections with the same columns and tensors."""
    collections = list(collections)
    if not collections:
        raise ValueError("nothing to concatenate")
    first = collections[0]
    infos = {k: np.concatenate([c.infos[k] for c in collections]) for k in first.infos}
    tensors = {k: torch.cat([c.tensors[k] for c in collections]) for k in first.tensors}
    return TensorCollection(infos, **tensors)
