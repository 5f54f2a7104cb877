"""The few pandas operations the evaluation needs, over a table that is a
dict of equal-length numpy columns (TensorCollection.infos).

Each reproduces the row order of the pandas call it replaces, because the
meters' greedy matching breaks ties by that order:

  * group_codes(t, keys)       groupby(keys, sort=False).ngroup()
  * groups(t, keys)            groupby(keys).groups: sorted keys → row ids
  * drop_duplicates(t, keys)   the row ids drop_duplicates() keeps
  * merge(l, r, on, how)       merge(on=..., how='inner'|'left'): each left
                               row in order, with its matching right rows in
                               their order (unmatched left rows: -1 in 'left')
  * argsort_desc(x)            sort_values(ascending=False): numpy's
                               quicksort of the reversed values, reversed
                               (ties mostly, not always, in row order)
  * take, concat, n_rows
"""

from __future__ import annotations

import numpy as np


def n_rows(t: dict) -> int:
    return len(next(iter(t.values()))) if t else 0


def row_keys(t: dict, keys) -> list:
    """One tuple of Python scalars a row."""
    cols = [np.asarray(t[k]).tolist() for k in keys]
    return list(zip(*cols)) if cols else []


def group_codes(t: dict, keys) -> np.ndarray:
    """Group number of each row, groups numbered by first appearance."""
    codes = {}
    return np.asarray([codes.setdefault(k, len(codes)) for k in row_keys(t, keys)], np.int64)


def groups(t: dict, keys) -> dict:
    """{key tuple: row ids in order}, the keys sorted."""
    out = {}
    for i, k in enumerate(row_keys(t, keys)):
        out.setdefault(k, []).append(i)
    return {k: np.asarray(out[k], np.int64) for k in sorted(out)}


def drop_duplicates(t: dict, keys) -> np.ndarray:
    """Row ids of each key's first row, in row order."""
    seen, keep = set(), []
    for i, k in enumerate(row_keys(t, keys)):
        if k not in seen:
            seen.add(k)
            keep.append(i)
    return np.asarray(keep, np.int64)


def merge(left: dict, right: dict, on, how: str = "inner"):
    """(left row ids, right row ids) of the joined rows; in a left join an
    unmatched left row has right id -1."""
    if how not in ("inner", "left"):
        raise ValueError(how)
    by_key = {}
    for j, k in enumerate(row_keys(right, on)):
        by_key.setdefault(k, []).append(j)
    li, ri = [], []
    for i, k in enumerate(row_keys(left, on)):
        match = by_key.get(k)
        if match:
            li.extend([i] * len(match))
            ri.extend(match)
        elif how == "left":
            li.append(i)
            ri.append(-1)
    return np.asarray(li, np.int64), np.asarray(ri, np.int64)


def argsort_desc(x) -> np.ndarray:
    """The descending order pandas' sort_values(ascending=False) gives."""
    x = np.asarray(x)
    return np.arange(len(x))[::-1][x[::-1].argsort(kind="quicksort")][::-1]


def take(t: dict, ids) -> dict:
    ids = np.asarray(ids, np.int64)
    return {k: np.asarray(v)[ids] for k, v in t.items()}


def concat(tables: list) -> dict:
    """Row-concatenate tables with the same columns ({} for none)."""
    tables = [t for t in tables if t]
    if not tables:
        return {}
    return {k: np.concatenate([np.asarray(t[k]) for t in tables]) for k in tables[0]}
