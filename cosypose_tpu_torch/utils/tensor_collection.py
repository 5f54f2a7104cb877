"""Row-aligned host metadata + named tensors, without pandas (the port's
counterpart of cosypose_tpu/utils/tensor_collection.py).

`infos` is a dict of equal-length numpy columns (e.g. 'label', 'batch_im_id',
'score'); tensors are named fields with the same leading row count, read and
written as attributes (`preds.poses = ...` replaces the tensor), added with
`register_tensor` and dropped with `delete_tensor`. Indexing by ids, `len`,
`clone`, `merge_df` and `concatenate` are what the inference and multiview
APIs need; `pad_to`, `trimmed`, `gather_distributed` and `gather_multihost`
bring the collections of a data-parallel run together; `to_numpy` hands the
tensors to the host as numpy arrays.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch
import torch.distributed as dist

from .distributed import collective_device, file_all_gather, get_world_size


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

    def __setattr__(self, name, value):
        """A tensor's name writes through to the tensor; other names set
        plain attributes."""
        if name in self.__dict__.get("tensors", {}):
            self.tensors[name] = value
        else:
            object.__setattr__(self, name, value)

    def register_tensor(self, name: str, tensor) -> None:
        """Add (or replace) the tensor `name`; its rows must match."""
        if (self.infos or self.tensors) and len(tensor) != len(self):
            raise ValueError(f"{name} has {len(tensor)} rows, the collection {len(self)}")
        self.tensors[name] = tensor

    def delete_tensor(self, name: str) -> None:
        self.tensors.pop(name)

    def to_numpy(self) -> "TensorCollection":
        """The same rows with each tensor as a numpy array on the host (the
        columns are numpy already)."""
        return TensorCollection(self.infos, **{k: t.detach().cpu().numpy()
                                               for k, t in self.tensors.items()})

    def __repr__(self) -> str:
        lines = [f"{type(self).__name__}("]
        for k, v in self.tensors.items():
            lines.append(f"    {k}: {tuple(v.shape)} {str(v.dtype).removeprefix('torch.')},")
        lines.append(")")
        if self.infos:
            lines.append("-" * 40)
            lines += [f"{k}: {v.dtype} {v[:3].tolist()}{' ...' if len(v) > 3 else ''}"
                      for k, v in self.infos.items()]
        return "\n".join(lines)

    def __len__(self) -> int:
        for v in (*self.infos.values(), *self.tensors.values()):
            return len(v)
        return 0

    def __getitem__(self, ids) -> "TensorCollection":
        """Rows by an id array/list or a slice."""
        idx = np.arange(len(self))[ids] if isinstance(ids, slice) else np.asarray(ids)
        infos = {k: v[idx] for k, v in self.infos.items()}
        tensors = {k: t[idx] if isinstance(t, np.ndarray)
                   else t[torch.as_tensor(idx, device=t.device)] for k, t in self.tensors.items()}
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

    def pad_to(self, n_rows: int, fill=0.0) -> tuple["TensorCollection", int]:
        """(this collection padded to `n_rows` rows, its row count): the
        tensors padded with `fill`, the columns with missing values as
        `concatenate` fills them."""
        n = len(self)
        if n > n_rows:
            raise ValueError(f"{n} rows do not fit in {n_rows}")
        pad = n_rows - n
        infos = {k: np.concatenate([v, _filled(v, pad)]) if pad else v
                 for k, v in self.infos.items()}
        tensors = {k: torch.cat([t, t.new_full((pad, *t.shape[1:]), fill)]) if pad else t
                   for k, t in self.tensors.items()}
        return TensorCollection(infos, **tensors), n

    def trimmed(self, n_valid: int) -> "TensorCollection":
        """The first n_valid rows: a padded collection's real ones."""
        return self[np.arange(n_valid)]

    def gather_distributed(self, n_valid: int | None = None) -> "TensorCollection":
        """Every rank's real rows, in rank order, on every rank. Each rank
        passes its collection padded to one row count (pad_to) and its number
        of real rows (default: all); each tensor travels in one fixed-shape
        all_gather_into_tensor of the padded rows, the columns by
        all_gather_object. One process gets its real
        rows."""
        n_valid = len(self) if n_valid is None else n_valid
        world = get_world_size()
        if world == 1:
            return self.trimmed(n_valid)
        device = collective_device()
        counts = torch.empty(world, dtype=torch.int64, device=device)
        dist.all_gather_into_tensor(counts, torch.tensor([n_valid], device=device))
        n_rows = len(self)
        keep = np.concatenate([r * n_rows + np.arange(int(c)) for r, c in enumerate(counts)])
        tensors = {}
        for k, t in self.tensors.items():
            out = t.new_empty((world * n_rows, *t.shape[1:]))
            dist.all_gather_into_tensor(out, t.detach().contiguous())
            tensors[k] = out[torch.as_tensor(keep, device=t.device)]
        infos = [None] * world
        dist.all_gather_object(infos, self.infos)
        infos = {k: np.concatenate([np.asarray(i[k])[:int(c)] for i, c in zip(infos, counts)])
                 for k in self.infos}
        return TensorCollection(infos, **tensors)

    def gather_multihost(self, gather_dir, process_id: int | None = None,
                         n_processes: int | None = None,
                         timeout_s: float = 600.0) -> "TensorCollection":
        """Every process's rows (of any count), in process order, through a
        shared directory (utils.distributed.file_all_gather: no process group
        needed; id and count default to the rank and world size). The
        tensors come back on this collection's devices."""
        devices = {k: t.device for k, t in self.tensors.items()}
        shards = file_all_gather(
            dict(infos=self.infos, tensors={k: t.detach().cpu() for k, t in self.tensors.items()}),
            gather_dir, process_id, n_processes, timeout_s)
        if shards is None:
            return self
        merged = concatenate(TensorCollection(s["infos"], **s["tensors"]) for s in shards)
        return TensorCollection(merged.infos,
                                **{k: t.to(devices[k]) for k, t in merged.tensors.items()})


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
