"""ctypes bindings for the host matching library (port of
cosypose_tpu/multiview/matching_cext.py).

cosypose_tpu_torch/csrc/matching.cpp is built with `g++ -O3 -shared -fPIC`
into build/ at first use (the file name carries a hash of the source and the
flags, as the raster kernels' builds do); a failed build raises, and the main
path never falls back to the numpy versions at the end of this file, which
the tests hold the library against. The four entry points are the
reference's (cosypose/csrc/cosypose_cext.cpp:264-269), with int label codes
and numpy in/out.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess

import numpy as np

_SRC = pathlib.Path(__file__).resolve().parents[1] / "csrc" / "matching.cpp"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lib = None


def build_library() -> pathlib.Path:
    """The shared library in build/, compiled where it is missing."""
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"libcosypose_matching_{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"libcosypose_matching_{digest}.{os.getpid()}.so"
    proc = subprocess.run(["g++", *GXX_FLAGS, str(_SRC), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {_SRC.name} ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build_library()))
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)

    lib.make_ransac_infos.restype = ctypes.c_void_p
    lib.make_ransac_infos.argtypes = [i32p, i32p, ctypes.c_int64,
                                      ctypes.c_int32, ctypes.c_int32]
    lib.ransac_infos_n_seeds.restype = ctypes.c_int64
    lib.ransac_infos_n_seeds.argtypes = [ctypes.c_void_p]
    lib.ransac_infos_n_tmatches.restype = ctypes.c_int64
    lib.ransac_infos_n_tmatches.argtypes = [ctypes.c_void_p]
    lib.ransac_infos_fill.argtypes = [ctypes.c_void_p, i32p, i32p]
    lib.ransac_infos_free.argtypes = [ctypes.c_void_p]

    lib.find_ransac_inliers.restype = ctypes.c_void_p
    lib.find_ransac_inliers.argtypes = [
        i32p, i32p, ctypes.c_int64, i32p, i32p, i32p, f32p,
        ctypes.c_int64, ctypes.c_float, ctypes.c_int32,
    ]
    lib.inliers_n_matches.restype = ctypes.c_int64
    lib.inliers_n_matches.argtypes = [ctypes.c_void_p]
    lib.inliers_n_best.restype = ctypes.c_int64
    lib.inliers_n_best.argtypes = [ctypes.c_void_p]
    lib.inliers_fill.argtypes = [ctypes.c_void_p, i32p, i32p]
    lib.inliers_free.argtypes = [ctypes.c_void_p]

    lib.scatter_argmin.argtypes = [f32p, i32p, ctypes.c_int64, i32p,
                                   ctypes.c_int64]
    lib.expand_ids_for_symmetry_size.restype = ctypes.c_int64
    lib.expand_ids_for_symmetry_size.argtypes = [i32p, i32p, ctypes.c_int64]
    lib.expand_ids_for_symmetry.argtypes = [i32p, i32p, ctypes.c_int64,
                                            i32p, i32p]
    _lib = lib
    return lib


def _i32(a):
    return np.ascontiguousarray(a, dtype=np.int32)


def _ptr(a, typ=ctypes.c_int32):
    return a.ctypes.data_as(ctypes.POINTER(typ))


def make_ransac_infos(view_ids, label_ids, n_ransac_iter: int, seed: int = 0):
    """→ (seeds dict, tmatches dict), flat int32 arrays.

    seeds: {view1, view2, match1_cand1, match1_cand2, match2_cand1, match2_cand2}
    tmatches: {hypothesis_id, cand1, cand2}
    (ref: cosypose_cext.cpp:36-105)
    """
    view_ids = _i32(view_ids)
    label_ids = _i32(label_ids)
    lib = _load()
    h = lib.make_ransac_infos(
        _ptr(view_ids), _ptr(label_ids), len(view_ids), n_ransac_iter, seed
    )
    try:
        ns = lib.ransac_infos_n_seeds(h)
        nt = lib.ransac_infos_n_tmatches(h)
        seeds_buf = np.empty((ns, 6), np.int32)
        mtc_buf = np.empty((nt, 3), np.int32)
        lib.ransac_infos_fill(h, _ptr(seeds_buf), _ptr(mtc_buf))
    finally:
        lib.ransac_infos_free(h)
    seeds = dict(
        view1=seeds_buf[:, 0], view2=seeds_buf[:, 1],
        match1_cand1=seeds_buf[:, 2], match1_cand2=seeds_buf[:, 3],
        match2_cand1=seeds_buf[:, 4], match2_cand2=seeds_buf[:, 5],
    )
    tmatches = dict(
        hypothesis_id=mtc_buf[:, 0], cand1=mtc_buf[:, 1], cand2=mtc_buf[:, 2]
    )
    return seeds, tmatches


def find_ransac_inliers(seeds_view1, seeds_view2, mtc_hypothesis_id, mtc_cand1,
                        mtc_cand2, dists, dist_threshold: float,
                        n_min_inliers: int):
    """→ {inlier_matches_cand1, inlier_matches_cand2, best_hypotheses}.
    (ref: cosypose_cext.cpp:107-216)
    """
    v1, v2 = _i32(seeds_view1), _i32(seeds_view2)
    hyp, c1, c2 = _i32(mtc_hypothesis_id), _i32(mtc_cand1), _i32(mtc_cand2)
    d = np.ascontiguousarray(dists, dtype=np.float32)
    lib = _load()
    h = lib.find_ransac_inliers(
        _ptr(v1), _ptr(v2), len(v1), _ptr(hyp), _ptr(c1), _ptr(c2),
        _ptr(d, ctypes.c_float), len(hyp),
        ctypes.c_float(dist_threshold), n_min_inliers,
    )
    try:
        nm = lib.inliers_n_matches(h)
        nb = lib.inliers_n_best(h)
        matches = np.empty((nm, 2), np.int32)
        best = np.empty((nb,), np.int32)
        lib.inliers_fill(h, _ptr(matches), _ptr(best))
    finally:
        lib.inliers_free(h)
    return dict(
        inlier_matches_cand1=matches[:, 0],
        inlier_matches_cand2=matches[:, 1],
        best_hypotheses=best,
    )


def scatter_argmin(values, segment_ids):
    """argmin within each segment id → int32 (n_segments,).
    (ref: cosypose_cext.cpp:218-245)"""
    values = np.ascontiguousarray(values, dtype=np.float32)
    segment_ids = _i32(segment_ids)
    n_segments = int(segment_ids.max()) + 1 if len(segment_ids) else 0
    out = np.empty((n_segments,), np.int32)
    _load().scatter_argmin(
        _ptr(values, ctypes.c_float), _ptr(segment_ids), len(values),
        _ptr(out), n_segments,
    )
    return out


def expand_ids_for_symmetry(label_ids, n_sym_per_label):
    """→ (ids_expand, sym_ids): row n repeated n_sym[label] times.
    (ref: cosypose_cext.cpp:247-259)"""
    label_ids = _i32(label_ids)
    n_sym = _i32(n_sym_per_label)
    lib = _load()
    total = lib.expand_ids_for_symmetry_size(_ptr(label_ids), _ptr(n_sym),
                                             len(label_ids))
    ids_expand = np.empty((total,), np.int32)
    sym_ids = np.empty((total,), np.int32)
    lib.expand_ids_for_symmetry(_ptr(label_ids), _ptr(n_sym), len(label_ids),
                                _ptr(ids_expand), _ptr(sym_ids))
    return ids_expand, sym_ids


# ---------------------------------------------------------------------------
# plain numpy versions: the tests hold the library against them
# ---------------------------------------------------------------------------


def make_ransac_infos_np(view_ids, label_ids, n_ransac_iter, seed=0):
    import random

    view_ids = np.asarray(view_ids)
    label_ids = np.asarray(label_ids)
    n = len(view_ids)
    tentative = {}
    for i in range(n):
        for j in range(n):
            if view_ids[i] != view_ids[j] and label_ids[i] == label_ids[j]:
                tentative.setdefault((int(view_ids[i]), int(view_ids[j])), []).append(
                    (i, j)
                )
    seeds = {k: [] for k in ("view1", "view2", "match1_cand1", "match1_cand2",
                             "match2_cand1", "match2_cand2")}
    mtc = {k: [] for k in ("hypothesis_id", "cand1", "cand2")}
    n_seeds = 0
    for (v1, v2), matches in sorted(tentative.items()):
        nm = len(matches)
        perm1 = list(range(nm))
        perm2 = list(range(nm))
        random.Random(seed).shuffle(perm1)
        random.Random(seed + 1).shuffle(perm2)
        n_pairs = 0
        for m1 in perm1:
            if n_pairs >= n_ransac_iter:
                break
            for m2 in perm2:
                if n_pairs >= n_ransac_iter:
                    break
                if m1 == m2:
                    continue
                seeds["view1"].append(v1)
                seeds["view2"].append(v2)
                seeds["match1_cand1"].append(matches[m1][0])
                seeds["match1_cand2"].append(matches[m1][1])
                seeds["match2_cand1"].append(matches[m2][0])
                seeds["match2_cand2"].append(matches[m2][1])
                for (c1, c2) in matches:
                    mtc["hypothesis_id"].append(n_seeds)
                    mtc["cand1"].append(c1)
                    mtc["cand2"].append(c2)
                n_pairs += 1
                n_seeds += 1
    return (
        {k: np.asarray(v, np.int32) for k, v in seeds.items()},
        {k: np.asarray(v, np.int32) for k, v in mtc.items()},
    )


def find_ransac_inliers_np(seeds_view1, seeds_view2, mtc_hypothesis_id,
                           mtc_cand1, mtc_cand2, dists, dist_threshold,
                           n_min_inliers):
    n_hyp = len(seeds_view1)
    inliers = [[] for _ in range(n_hyp)]
    for h, c1, c2, d in zip(mtc_hypothesis_id, mtc_cand1, mtc_cand2, dists):
        if d <= dist_threshold:
            inliers[h].append((float(d), int(c1), int(c2)))
    uniq, sums, counts = [], [], []
    for h in range(n_hyp):
        used1, used2, u, s = set(), set(), [], 0.0
        for d, c1, c2 in sorted(inliers[h], key=lambda t: t[0]):
            if c1 not in used1 and c2 not in used2:
                used1.add(c1)
                used2.add(c2)
                u.append((c1, c2))
                s += d
        uniq.append(u)
        sums.append(s)
        counts.append(len(u))
    by_pair = {}
    for h in range(n_hyp):
        by_pair.setdefault((int(seeds_view1[h]), int(seeds_view2[h])), []).append(h)
    out_c1, out_c2, best_list = [], [], []
    for pair in sorted(by_pair):
        best, bn, bs = -1, 0, float("inf")
        for h in by_pair[pair]:
            if counts[h] >= n_min_inliers and (
                counts[h] > bn or (counts[h] == bn and sums[h] < bs)
            ):
                best, bn, bs = h, counts[h], sums[h]
        if best >= 0:
            best_list.append(best)
            for c1, c2 in uniq[best]:
                out_c1.append(c1)
                out_c2.append(c2)
    return dict(
        inlier_matches_cand1=np.asarray(out_c1, np.int32),
        inlier_matches_cand2=np.asarray(out_c2, np.int32),
        best_hypotheses=np.asarray(best_list, np.int32),
    )
