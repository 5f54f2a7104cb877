"""Stage 2: multi-view object-candidate matching by RANSAC over relative
camera poses (port of cosypose_tpu/multiview/ransac.py).

  * host (C++, matching_cext): tentative matches and RANSAC seeds, and the
    greedy unique inlier pass;
  * device (torch ops on the mesh database's device): the distance math,
    the symmetry-resolved camera-pose hypotheses of every seed and the
    scoring of every (hypothesis, tentative match) row, in chunks that keep
    the working set near WORK_ELEMS·12 bytes a tensor;
  * host (numpy, scipy): strongly connected components and bookkeeping, in
    the JAX package's row orders.

Every product is written as a sum of elementwise products, full float32
whatever the TF32 settings (the JAX package pins Precision.HIGHEST). Rows
are not padded to power-of-two buckets: those bounded XLA recompiles; the
rows that are there give the same answers.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import connected_components

from ..ops.symmetric import _matmul
from ..ops.transforms import invert_T
from ..utils.device import synchronize
from ..utils.tensor_collection import TensorCollection
from ..utils.timer import Timer
from . import matching_cext

# elements of the largest (rows, symmetries, points) block a chunk builds:
# each (.., 3) float32 tensor over it is 192 MiB
WORK_ELEMS = 2 ** 24


def transform_pts(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """T (..., 4, 4) on pts (..., P, 3) → (..., P, 3); T (..., S, 4, 4) →
    (..., S, P, 3). Full float32 (sums of three products)."""
    if T.ndim == pts.ndim + 1:
        pts = pts.unsqueeze(-3)
    return (T[..., None, :3, :3] * pts[..., None, :]).sum(-1) + T[..., None, :3, 3]


def _sym_dist(T1, T2, points, syms, sym_valid):
    """min over T1's symmetries of the mean point distance between the posed
    point sets: the symmetry is chosen by mean squared distance, the value is
    the mean distance under it. T1 (..., 4, 4), T2 (..., 4, 4), points
    (..., P, 3), syms (..., S, 4, 4), sym_valid (..., S), all with the same
    leading shape → ((...,) distances, (...,) symmetry ids)."""
    p1 = transform_pts(_matmul(T1[..., None, :, :], syms), points)    # (..., S, P, 3)
    return _sym_dist_from(p1, T2, points, sym_valid)


def _sym_dist_from(p1, T2, points, sym_valid):
    """_sym_dist with T1's symmetric point sets p1 (..., S, P, 3) given."""
    p2 = transform_pts(T2, points)[..., None, :, :]                      # (..., 1, P, 3)
    d2 = ((p1 - p2) ** 2).sum(-1)                                        # (..., S, P)
    mean_d2 = torch.where(sym_valid, d2.mean(-1), torch.inf)
    best = torch.argmin(mean_d2, dim=-1)
    d = torch.gather(d2, -2, best[..., None, None].expand(*best.shape, 1, d2.shape[-1]))
    return torch.sqrt(d[..., 0, :]).mean(-1), best


def _tables(candidates, mesh_db):
    """The base tables on the mesh database's device: candidate poses and
    label ids, each label's points, symmetries and their validity."""
    dev = mesh_db.device
    return (candidates.poses.to(dev, torch.float32), mesh_db.ids_for(candidates.infos["label"]),
            mesh_db.points, mesh_db.symmetries, mesh_db.sym_valid)


def _estimate_camera_poses(TC1Oa, TC2Ob, TC1Og, TC2Od, syms_ab, sym_valid_ab, points_gd,
                           syms_gd, sym_valid_gd):
    """Symmetry-resolved TC1C2 per seed (N, 4, 4).

    For every symmetry S of the first match's object, TC1C2(S) = TC1Oa @ S @
    TObC2 re-poses the second match (g, d); the distance, minimal over g's
    own symmetries, picks the best S.
    """
    TC1C2_s = _matmul(_matmul(TC1Oa[:, None], syms_ab), invert_T(TC2Ob)[:, None])  # (N,Sa,4,4)
    T2_s = _matmul(TC1C2_s, TC2Od[:, None])
    Sa = syms_ab.shape[1]

    def per_sym(x):
        return x[:, None].expand(x.shape[0], Sa, *x.shape[1:])

    dists, _ = _sym_dist(per_sym(TC1Og), T2_s, per_sym(points_gd), per_sym(syms_gd),
                         per_sym(sym_valid_gd))
    dists = torch.where(sym_valid_ab, dists, torch.inf)
    best = torch.argmin(dists, dim=1)
    return TC1C2_s[torch.arange(len(best), device=best.device), best]


def estimate_camera_poses_batch(candidates, seeds, mesh_db) -> np.ndarray:
    """TC1C2 (n_seeds, 4, 4) of every RANSAC seed, on the device in chunks."""
    poses, label_ids, points, syms, sym_valid = _tables(candidates, mesh_db)
    dev = poses.device
    cols = [torch.as_tensor(np.asarray(seeds[k], np.int64), device=dev)
            for k in ("match1_cand1", "match1_cand2", "match2_cand1", "match2_cand2")]
    n = len(cols[0])
    S, P = syms.shape[1], points.shape[1]
    chunk = max(1, WORK_ELEMS // (S * S * P))
    out = []
    for s in range(0, n, chunk):
        m1c1, m1c2, m2c1, m2c2 = (c[s:s + chunk] for c in cols)
        lab_ab, lab_gd = label_ids[m1c1], label_ids[m2c1]
        out.append(_estimate_camera_poses(
            poses[m1c1], poses[m1c2], poses[m2c1], poses[m2c2], syms[lab_ab],
            sym_valid[lab_ab], points[lab_gd], syms[lab_gd], sym_valid[lab_gd]))
    return torch.cat(out).cpu().numpy() if out else np.zeros((0, 4, 4), np.float32)


def score_tmatches_batch(candidates, tmatches, TC1C2, mesh_db) -> np.ndarray:
    """The distance of every (hypothesis, tentative match) row, (n_rows,):
    the symmetric distance between TC1Oa and TC1C2 @ TC2Ob."""
    poses, label_ids, points, syms, sym_valid = _tables(candidates, mesh_db)
    dev = poses.device
    TC1C2 = torch.as_tensor(np.array(TC1C2, np.float32), device=dev)
    c1, c2, hyp = (torch.as_tensor(np.asarray(tmatches[k], np.int64), device=dev)
                   for k in ("cand1", "cand2", "hypothesis_id"))
    chunk = max(1, WORK_ELEMS // (syms.shape[1] * points.shape[1]))
    out = []
    for s in range(0, len(c1), chunk):
        a, b, h = c1[s:s + chunk], c2[s:s + chunk], hyp[s:s + chunk]
        lab = label_ids[a]
        d, _ = _sym_dist(poses[a], _matmul(TC1C2[h], poses[b]), points[lab], syms[lab],
                         sym_valid[lab])
        out.append(d)
    return torch.cat(out).cpu().numpy() if out else np.zeros(0, np.float32)


def _compact_pair_tables(seeds, tmatches) -> dict:
    """Regroup the flat hypothesis-expanded arrays into per-pair tables:
    each pair's hypothesis ids (Np, Hmax) and its tentative matches (Np,
    Tmax), which the expansion repeats verbatim for each of the pair's
    hypotheses and which are taken under its first."""
    v1 = np.asarray(seeds["view1"], np.int64)
    v2 = np.asarray(seeds["view2"], np.int64)
    uniq, pair_of_hyp = np.unique((v1 << 32) | (v2 & 0xFFFFFFFF), return_inverse=True)
    n_pairs = len(uniq)

    order = np.argsort(pair_of_hyp, kind="stable")
    counts_h = np.bincount(pair_of_hyp, minlength=n_pairs)
    Hmax = int(counts_h.max())
    pair_hyp = np.zeros((n_pairs, Hmax), np.int64)
    pair_hyp_valid = np.zeros((n_pairs, Hmax), bool)
    col_h = np.concatenate([np.arange(c) for c in counts_h])
    pair_hyp[pair_of_hyp[order], col_h] = order
    pair_hyp_valid[pair_of_hyp[order], col_h] = True

    hyp_ids = np.asarray(tmatches["hypothesis_id"], np.int64)
    first_hyp = np.full(n_pairs, np.iinfo(np.int64).max)
    np.minimum.at(first_hyp, pair_of_hyp, np.arange(len(pair_of_hyp)))
    sel = hyp_ids == first_hyp[pair_of_hyp[hyp_ids]]
    c1_sel = np.asarray(tmatches["cand1"], np.int64)[sel]
    c2_sel = np.asarray(tmatches["cand2"], np.int64)[sel]
    pair_of_row = pair_of_hyp[hyp_ids[sel]]
    counts_t = np.bincount(pair_of_row, minlength=n_pairs)
    Tmax = int(counts_t.max())
    pair_c1 = np.zeros((n_pairs, Tmax), np.int64)
    pair_c2 = np.zeros((n_pairs, Tmax), np.int64)
    pair_t_valid = np.zeros((n_pairs, Tmax), bool)
    ord_t = np.argsort(pair_of_row, kind="stable")
    col_t = np.concatenate([np.arange(c) for c in counts_t])
    pair_c1[pair_of_row[ord_t], col_t] = c1_sel[ord_t]
    pair_c2[pair_of_row[ord_t], col_t] = c2_sel[ord_t]
    pair_t_valid[pair_of_row[ord_t], col_t] = True
    return dict(pair_hyp=pair_hyp, pair_hyp_valid=pair_hyp_valid, pair_c1=pair_c1,
                pair_c2=pair_c2, pair_t_valid=pair_t_valid)


def _score_select(poses, label_ids, points, syms, sym_valid, TC1C2, pair_hyp, pair_hyp_valid,
                  pair_c1, pair_c2, pair_t_valid, dist_threshold, k):
    """Every pair's hypothesis × tentative-match distances, and its k best
    hypotheses by n_inliers·1e6 − Σ(inlier distances) (float32, as the JAX
    package ranks them: the non-unique upper bound of the greedy pass's
    (n_inliers, Σ) criterion, which the exact pass re-ranks on the host).
    A stable descending sort breaks ties to the lower slot, as lax.top_k.

    Returns (top_hyp (Np,k) global ids, top_d (Np,k,Tmax), top_valid (Np,k)).
    """
    Np, Hmax = pair_hyp.shape
    Tmax = pair_c1.shape[1]
    S, P = syms.shape[1], points.shape[1]
    per_pair = Tmax * S * P
    n_pairs = max(1, min(Np, WORK_ELEMS // (Hmax * per_pair)))
    n_hyps = Hmax if n_pairs > 1 else max(1, min(Hmax, WORK_ELEMS // per_pair))
    top_hyp, top_d, top_valid = [], [], []
    for p0 in range(0, Np, n_pairs):
        c1, c2 = pair_c1[p0:p0 + n_pairs], pair_c2[p0:p0 + n_pairs]     # (np, Tmax)
        lab = label_ids[c1]
        pts, sv = points[lab], sym_valid[lab]
        p1 = transform_pts(_matmul(poses[c1][..., None, :, :], syms[lab]), pts)  # (np,T,S,P,3)
        Tb = poses[c2]
        hyp = pair_hyp[p0:p0 + n_pairs]
        d = []
        for h0 in range(0, Hmax, n_hyps):
            T12 = TC1C2[hyp[:, h0:h0 + n_hyps]]                            # (np, hc, 4, 4)
            TWOb = _matmul(T12[:, :, None], Tb[:, None])                    # (np, hc, T, 4, 4)
            hc = TWOb.shape[1]

            def per_hyp(x):
                return x[:, None].expand(x.shape[0], hc, *x.shape[1:])

            d.append(_sym_dist_from(per_hyp(p1), TWOb, per_hyp(pts), per_hyp(sv))[0])
        d = torch.where(pair_t_valid[p0:p0 + n_pairs, None, :], torch.cat(d, 1), torch.inf)
        inl = d <= dist_threshold  # the greedy pass's <= (matching.cpp)
        score = inl.sum(-1).float() * 1e6 - torch.where(inl, d, 0.0).sum(-1)
        score = torch.where(pair_hyp_valid[p0:p0 + n_pairs], score, -torch.inf)
        values, idx = torch.sort(score, dim=-1, descending=True, stable=True)
        idx = idx[:, :k]
        top_hyp.append(torch.gather(hyp, 1, idx))
        top_d.append(torch.gather(d, 1, idx[..., None].expand(-1, -1, Tmax)))
        top_valid.append(values[:, :k] > -torch.inf)
    return torch.cat(top_hyp), torch.cat(top_d), torch.cat(top_valid)


def score_and_select_topk(candidates, seeds, tmatches, TC1C2, mesh_db, dist_threshold, k=16):
    """Device scoring and each view pair's top-k hypotheses. Returns flat
    (hyp, cand1, cand2, dists) arrays of the k best hypotheses of each pair,
    for the exact greedy inlier pass."""
    tables = _compact_pair_tables(seeds, tmatches)
    poses, label_ids, points, syms, sym_valid = _tables(candidates, mesh_db)
    dev = poses.device
    t = {name: torch.as_tensor(v, device=dev) for name, v in tables.items()}
    k_eff = min(k, tables["pair_hyp"].shape[1])
    top_hyp, top_d, top_valid = (x.cpu().numpy() for x in _score_select(
        poses, label_ids, points, syms, sym_valid,
        torch.as_tensor(np.array(TC1C2, np.float32), device=dev), t["pair_hyp"],
        t["pair_hyp_valid"], t["pair_c1"], t["pair_c2"], t["pair_t_valid"], dist_threshold,
        k_eff))
    Np, K, Tmax = top_d.shape
    row_valid = top_valid[:, :, None] & tables["pair_t_valid"][:, None, :]
    hyp_flat = np.broadcast_to(top_hyp[:, :, None], (Np, K, Tmax))[row_valid]
    c1_flat = np.broadcast_to(tables["pair_c1"][:, None, :], (Np, K, Tmax))[row_valid]
    c2_flat = np.broadcast_to(tables["pair_c2"][:, None, :], (Np, K, Tmax))[row_valid]
    return (hyp_flat.astype(np.int32), c1_flat.astype(np.int32), c2_flat.astype(np.int32),
            top_d[row_valid].astype(np.float32))


def scene_level_matching(candidates, inliers) -> TensorCollection:
    """Strongly connected components of the inlier-match graph become the
    physical objects (obj_id, numbered by sorted component id); components of
    one candidate are dropped."""
    cand1, cand2 = inliers["inlier_matches_cand1"], inliers["inlier_matches_cand2"]
    n_cand = len(candidates)
    graph = csr_matrix((np.ones(len(cand1), dtype=np.int64), (cand1, cand2)),
                       shape=(n_cand, n_cand))
    _, ids = connected_components(graph, directed=True, connection="strong")
    keep = np.flatnonzero(np.bincount(ids)[ids] >= 2)
    comp = ids[keep]
    infos = {k: np.asarray(v)[keep] for k, v in candidates.infos.items()}
    infos["obj_id"] = np.searchsorted(np.unique(comp), comp).astype(np.int64)
    rows = torch.as_tensor(infos["cand_id"], device=candidates.poses.device)
    return TensorCollection(infos, poses=candidates.poses[rows])


def make_obj_infos(matched_candidates) -> dict:
    """One row an object, by ascending obj_id: obj_id, score (the sum of its
    candidates' scores), label (its first candidate's), n_cand."""
    infos = matched_candidates.infos
    obj_ids = np.asarray(infos["obj_id"])
    objs, first, n_cand = np.unique(obj_ids, return_index=True, return_counts=True)
    scores = np.asarray(infos["score"], np.float64)
    return dict(obj_id=objs, score=np.asarray([math.fsum(scores[obj_ids == o]) for o in objs]),
                label=np.asarray(infos["label"])[first], n_cand=n_cand.astype(np.int64))


def get_best_viewpair_pose_est(TC1C2, seeds, inliers) -> TensorCollection:
    best = inliers["best_hypotheses"]
    return TensorCollection(dict(view1=np.asarray(seeds["view1"])[best],
                                 view2=np.asarray(seeds["view2"])[best]),
                            TC1C2=torch.as_tensor(np.asarray(TC1C2)[best]))


def multiview_candidate_matching(candidates: TensorCollection, mesh_db,
                                 dist_threshold: float = 0.02,
                                 cameras: TensorCollection | None = None,
                                 n_ransac_iter: int = 20, n_min_inliers: int = 3, seed: int = 0,
                                 scoring: str = "topk") -> dict:
    """candidates: infos view_id, label, score and poses (N,4,4); cameras
    (known camera poses, optional): infos view_id and TWC. Adds a cand_id
    column to candidates.infos. Returns dict(filtered_candidates,
    scene_infos, pairs_TC1C2, time_models, time_score, time_misc); the
    times are the host's, each stage waiting for the card before it ends."""
    if scoring not in ("topk", "full"):
        raise ValueError(f"scoring is 'topk' or 'full', not {scoring!r}")
    dev = mesh_db.device
    timer_models, timer_score, timer_misc = Timer(), Timer(), Timer()
    if cameras is not None:
        n_ransac_iter = 1

    timer_misc.start()
    candidates.infos["cand_id"] = np.arange(len(candidates))
    label_codes = mesh_db.ids_for(candidates.infos["label"]).cpu().numpy()
    timer_misc.pause()

    timer_models.start()
    seeds, tmatches = matching_cext.make_ransac_infos(
        np.asarray(candidates.infos["view_id"], np.int32), label_codes.astype(np.int32),
        n_ransac_iter, seed)
    if len(seeds["view1"]) == 0:
        raise ValueError("No tentative matches across views")
    if cameras is not None:
        idx = {int(v): i for i, v in enumerate(cameras.infos["view_id"])}
        TWC = cameras.TWC.to(dev, torch.float32)
        rows1 = torch.as_tensor([idx[int(v)] for v in seeds["view1"]], device=dev)
        rows2 = torch.as_tensor([idx[int(v)] for v in seeds["view2"]], device=dev)
        TC1C2 = _matmul(invert_T(TWC[rows1]), TWC[rows2]).cpu().numpy()
    else:
        TC1C2 = estimate_camera_poses_batch(candidates, seeds, mesh_db)
    synchronize(dev)
    timer_models.pause()

    timer_score.start()
    if scoring == "topk":
        hyp_f, c1_f, c2_f, d_f = score_and_select_topk(candidates, seeds, tmatches, TC1C2,
                                                       mesh_db, dist_threshold)
    else:
        hyp_f, c1_f, c2_f = tmatches["hypothesis_id"], tmatches["cand1"], tmatches["cand2"]
        d_f = score_tmatches_batch(candidates, tmatches, TC1C2, mesh_db)
    inliers = matching_cext.find_ransac_inliers(seeds["view1"], seeds["view2"], hyp_f, c1_f,
                                                c2_f, d_f, dist_threshold, n_min_inliers)
    timer_score.pause()

    timer_misc.resume()
    pairs_TC1C2 = get_best_viewpair_pose_est(TC1C2, seeds, inliers)
    filtered_candidates = scene_level_matching(candidates, inliers)
    scene_infos = make_obj_infos(filtered_candidates)
    timer_misc.pause()
    return dict(filtered_candidates=filtered_candidates, scene_infos=scene_infos,
                pairs_TC1C2=pairs_TC1C2, time_models=timer_models.stop(),
                time_score=timer_score.stop(), time_misc=timer_misc.stop())
