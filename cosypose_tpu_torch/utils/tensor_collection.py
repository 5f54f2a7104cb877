"""Row-aligned host metadata + named tensors, without pandas (the port's
counterpart of cosypose_tpu/utils/tensor_collection.py).

`infos` is a dict of equal-length numpy columns (e.g. 'label', 'batch_im_id',
'score'); tensors are named fields with the same leading row count. Indexing
by ids, `len`, `clone`, `merge_df` and `concatenate` are what the inference
and multiview APIs need.
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

    def clone(self) -> "TensorCollection":
        """Own copies of the columns; the tensors are shared, as the JAX
        package's clone shares its arrays."""
        return TensorCollection({k: v.copy() for k, v in self.infos.items()}, **self.tensors)

    def merge_df(self, right: dict, on) -> "TensorCollection":
        """Inner join of the columns with the table `right` (a dict of
        columns) on `on`, in pandas' row order: each row in order, with its
        matching right rows in theirs. Right columns other than the keys are
        added; a name both sides hold besides the keys raises."""
        from ..evaluation import table

        on = [on] if isinstance(on, str) else list(on)
        clash = (set(self.infos) & set(right)) - set(on)
        if clash:
            raise ValueError(f"columns on both sides besides the keys: {sorted(clash)}")
        li, ri = table.merge(self.infos, right, on)
        out = self[li]
        for k, v in right.items():
            if k not in on:
                out.infos[k] = np.asarray(v)[ri]
        return out


def _filled(column: np.ndarray, n: int) -> np.ndarray:
    """n missing values for a column of this dtype, as pandas' concat fills
    them: NaN, making a numeric column float64 and any other object."""
    return np.full(n, np.nan) if column.dtype.kind in "iuf" else np.full(n, np.nan, object)


def concatenate(collections: Iterable[TensorCollection]) -> TensorCollection:
    """Row-concatenate collections with the same tensors. Columns are the
    union, in order of first appearance; a collection without a column gets
    NaN there, as in pandas' concat."""
    collections = list(collections)
    if not collections:
        raise ValueError("nothing to concatenate")
    first = collections[0]
    names = list(dict.fromkeys(k for c in collections for k in c.infos))
    infos = {}
    for k in names:
        like = next(c.infos[k] for c in collections if k in c.infos)
        parts = [c.infos[k] if k in c.infos else _filled(like, len(c)) for c in collections]
        if any(k not in c.infos for c in collections) and like.dtype.kind not in "iuf":
            parts = [np.asarray(p, object) for p in parts]
        infos[k] = np.concatenate(parts)
    tensors = {k: torch.cat([c.tensors[k] for c in collections]) for k in first.tensors}
    return TensorCollection(infos, **tensors)
