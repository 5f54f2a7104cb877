"""Evaluation meters: 6D pose errors (ADD / ADD-S / ADD(-S)) and detection
AP (port of cosypose_tpu/evaluation/meters.py).

BOP-style top-n filtering by targets, valid-GT marking, the sphere-overlap
prefilter, exact-mesh errors, diameter-relative threshold matching, greedy
score-ordered 1-1 matching, PoseCNN AUC and AP/mAP, without pandas or
scikit-learn: the bookkeeping runs on dicts of numpy columns through
evaluation/table.py, in pandas' row order, and AP is computed from its
definition. The errors of all tentative matches are computed at once on the
mesh database's device (float32, as the JAX package's jitted kernels);
ADD-S in chunks of candidates under a byte cap.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from ..ops.symmetric import transform_pts
from ..utils.distributed import file_all_gather
from . import table

GROUP_KEYS = ("scene_id", "view_id", "label")
# ADD-S holds a (candidates, P, P, 3) float32 difference tensor: its chunks of
# candidates stay under this many bytes (2000 points: 48 MB a candidate)
ADDS_CHUNK_BYTES = 1 << 29


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# matching helpers
# ---------------------------------------------------------------------------


def add_inst_num(infos: dict, group_keys=GROUP_KEYS) -> np.ndarray:
    """Each row's rank among the rows of its group, in row order."""
    inst = np.zeros(table.n_rows(infos), np.int64)
    for ids in table.groups(infos, group_keys).values():
        inst[ids] = np.arange(len(ids))
    return inst


def get_top_n_ids(infos: dict, group_keys=GROUP_KEYS, top_key="score", n_top=-1,
                  targets=None) -> np.ndarray:
    """Row ids of the top-n rows of each group by `top_key` (groups in sorted
    key order, descending within, ties in row order); n from the targets'
    inst_count where given (BOP protocol), else n_top, else all."""
    targets_count = {}
    if targets is not None:
        for k, ids in table.groups(targets, group_keys).items():
            targets_count[k] = int(targets["inst_count"][ids[0]])
    values = np.asarray(infos[top_key]) if table.n_rows(infos) else np.zeros(0)
    keep = []
    for k, ids in table.groups(infos, group_keys).items():
        ranked = ids[table.argsort_desc(values[ids])]
        if n_top > 0:
            top = n_top
        elif targets is not None:
            top = targets_count.get(k, 0)
        else:
            top = len(ranked)
        keep.append(ranked[:top])
    return np.concatenate(keep) if keep else np.asarray([], np.int64)


def add_valid_gt(gt_infos: dict, group_keys=GROUP_KEYS, visib_gt_min=-1,
                 targets=None) -> np.ndarray:
    """The 'valid' column of the GT rows."""
    n = table.n_rows(gt_infos)
    if visib_gt_min > 0:
        valid = np.asarray(gt_infos["visib_fract"]) >= visib_gt_min
        if targets is not None:
            valid &= np.isin(gt_infos["label"], targets["label"])
        return valid
    if targets is not None:
        ids = get_top_n_ids(gt_infos, group_keys=group_keys, top_key="visib_fract",
                            targets=targets)
        valid = np.zeros(n, bool)
        valid[ids] = True
        return valid
    return np.ones(n, bool)


def match_poses(cand: dict, group_keys=GROUP_KEYS) -> np.ndarray:
    """Greedy 1-1 matching: predictions in descending score order, ties by
    their first appearance in the group, each take their lowest-error
    unmatched GT. cand: columns group_keys, pred_id, gt_id, score, error.
    Returns the kept rows' ids, ascending."""
    n = table.n_rows(cand)
    if n == 0:
        return np.zeros(0, np.int64)
    gcodes = table.group_codes(cand, group_keys)
    pred = np.asarray(cand["pred_id"])
    first = {}
    for i, key in enumerate(zip(gcodes.tolist(), pred.tolist())):
        first.setdefault(key, i)
    first = np.asarray([first[k] for k in zip(gcodes.tolist(), pred.tolist())])
    order = np.lexsort((np.asarray(cand["error"]), first, -np.asarray(cand["score"]), gcodes))
    gt = np.asarray(cand["gt_id"])
    taken_gt, done_pred, keep = set(), set(), []
    for i in order:
        pkey, gkey = (gcodes[i], pred[i]), (gcodes[i], gt[i])
        if pkey in done_pred or gkey in taken_gt:
            continue
        taken_gt.add(gkey)
        done_pred.add(pkey)
        keep.append(i)
    return np.asarray(sorted(keep), np.int64)


def compute_auc_posecnn(errors) -> float:
    """PoseCNN-style area under the accuracy-threshold curve up to 0.1 m."""
    errors = np.asarray(errors, dtype=np.float64).copy()
    d = np.sort(errors)
    d[d > 0.1] = np.inf
    acc = np.cumsum(np.ones(len(d))) / len(d)
    finite = np.isfinite(d)
    if len(d) == 0 or finite.sum() == 0:
        return float("nan")
    rec = d[finite]
    prec = acc[finite]
    mrec = np.concatenate(([0], rec, [0.1]))
    mpre = np.concatenate(([0], prec, [prec[-1]]))
    for i in range(1, len(mpre)):
        mpre[i] = max(mpre[i], mpre[i - 1])
    ids = np.where(mrec[1:] != mrec[:-1])[0] + 1
    return float(((mrec[ids] - mrec[ids - 1]) * mpre[ids]).sum() * 10)


def average_precision(y_true, scores) -> float:
    """scikit-learn's average_precision_score from its definition: over the
    distinct score thresholds in descending order, Σ (R_n − R_{n−1})·P_n,
    tied scores forming one threshold, R_0 = 0."""
    y_true = np.asarray(y_true, bool)
    scores = np.asarray(scores, np.float64)
    order = np.argsort(scores, kind="mergesort")[::-1]
    s, t = scores[order], y_true[order].astype(np.float64)
    last = np.r_[np.where(np.diff(s))[0], len(s) - 1]   # each threshold's last row
    tps = np.cumsum(t)[last]
    precision = tps / (last + 1)
    recall = tps / tps[-1]
    return float(np.sum(np.diff(np.r_[0.0, recall]) * precision))


def compute_ap(df: dict, n_gt, valid_key="0.1d") -> float:
    """AP under the reference's protocol: average_precision over prediction
    scores, rescaled from its recall denominator (true positives among the
    predictions) to the number of ground-truth instances."""
    y_true = np.asarray(df[valid_key], bool) if df else np.zeros(0, bool)
    if len(y_true) == 0 or y_true.sum() == 0 or n_gt <= 0:
        return 0.0
    return float(average_precision(y_true, df["score"]) * y_true.sum() / n_gt)


def gather_multihost(meter, gather_dir, process_id: int | None = None,
                     n_processes: int | None = None, timeout_s: float = 600.0):
    """Merge a meter's accumulated frames (its `*_frames` lists) across
    processes through a shared filesystem (utils.distributed.file_all_gather;
    process id and count default to the rank and world size); returns the
    meter."""
    names = [k for k in vars(meter) if k.endswith("_frames")]
    shards = file_all_gather({k: getattr(meter, k) for k in names}, gather_dir, process_id,
                             n_processes, timeout_s)
    if shards is not None:
        for k in names:
            setattr(meter, k, [frame for shard in shards for frame in shard[k]])
    return meter


# ---------------------------------------------------------------------------
# error functions (float32, on the mesh database's device)
# ---------------------------------------------------------------------------


def _stats(d: torch.Tensor, valid: torch.Tensor, TXO_pred, TXO_gt) -> dict:
    w = valid.to(d.dtype)
    n = w.sum(-1).clamp_min(1.0)
    t_d = TXO_pred[:, :3, 3] - TXO_gt[:, :3, 3]
    return dict(norm_avg=(torch.linalg.norm(d, dim=-1) * w).sum(-1) / n,
                xyz_avg=(d.abs() * w[..., None]).sum(-2) / n[..., None],
                TCO_xyz=t_d.abs(), TCO_norm=torch.linalg.norm(t_d, dim=-1))


def add_errors(TXO_pred, TXO_gt, points, valid) -> dict:
    """ADD displacement statistics over the valid points → dict of (B, ...)."""
    d = transform_pts(TXO_gt, points) - transform_pts(TXO_pred, points)
    return _stats(d, valid, TXO_pred, TXO_gt)


def adds_errors(TXO_pred, TXO_gt, points, valid, chunk_bytes: int = ADDS_CHUNK_BYTES) -> dict:
    """ADD-S: for each valid GT point, the displacement to the nearest valid
    predicted point, by the difference, its squared sum, the argmin and the
    gather, as the JAX package computes it; in chunks of candidates whose
    (c, P, P, 3) difference tensor stays within chunk_bytes."""
    B, P = points.shape[:2]
    c = max(1, chunk_bytes // (P * P * 3 * points.element_size()))
    parts = []
    for s in range(0, B, c):
        sl = slice(s, s + c)
        gt_pts = transform_pts(TXO_gt[sl], points[sl])
        pred_pts = transform_pts(TXO_pred[sl], points[sl])
        diff = gt_pts[:, :, None] - pred_pts[:, None, :]          # (c, Pgt, Ppred, 3)
        d2 = torch.where(valid[sl, None, :], (diff ** 2).sum(-1), torch.inf)
        assign = torch.argmin(d2, dim=2)
        d = torch.take_along_dim(diff, assign[..., None, None], dim=2)[:, :, 0]
        del diff, d2
        parts.append(_stats(d, valid[sl], TXO_pred[sl], TXO_gt[sl]))
    if not parts:
        return add_errors(TXO_pred, TXO_gt, points, valid)
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


# ---------------------------------------------------------------------------
# PoseErrorMeter
# ---------------------------------------------------------------------------


class PoseErrorMeter:
    def __init__(self, mesh_db, error_type="ADD", report_AP=False, report_error_AUC=False,
                 report_error_stats=False, sample_n_points=None, match_threshold=0.1,
                 spheres_overlap_check=True, consider_all_predictions=False, targets=None,
                 visib_gt_min=-1, n_top=-1):
        """targets: None or a table {scene_id, view_id, label, inst_count}."""
        self.mesh_db = mesh_db
        self.error_type = error_type.upper()
        self.n_top = n_top
        self.visib_gt_min = visib_gt_min
        self.targets = targets
        self.match_threshold = match_threshold
        self.spheres_overlap_check = spheres_overlap_check
        self.consider_all_predictions = consider_all_predictions
        self.report_AP = report_AP
        self.report_error_stats = report_error_stats
        self.report_error_AUC = report_error_AUC
        self.sample_n_points = sample_n_points
        self.reset()

    def reset(self):
        self.gt_frames = []
        self.pred_frames = []
        self.match_frames = []

    def is_symmetric(self, label) -> bool:
        return self.mesh_db.infos[label].get("n_sym", 1) > 1

    def compute_errors_batch(self, TXO_pred, TXO_gt, labels) -> dict:
        """Errors of all candidates at once on the mesh database's device →
        dict of float32 numpy arrays."""
        if len(labels) == 0:
            return dict(norm_avg=np.zeros(0, np.float32), xyz_avg=np.zeros((0, 3), np.float32),
                        TCO_xyz=np.zeros((0, 3), np.float32), TCO_norm=np.zeros(0, np.float32))
        db = self.mesh_db
        label_ids = db.ids_for(labels)
        points, valid = db.points[label_ids], db.valid[label_ids]
        if self.sample_n_points is not None:
            n = min(self.sample_n_points, points.shape[1])
            ids = torch.as_tensor(np.random.RandomState(0).choice(points.shape[1], n,
                                                                  replace=False),
                                  device=db.device)
            points, valid = points[:, ids], valid[:, ids]
        TXO_pred = torch.as_tensor(np.asarray(TXO_pred), dtype=torch.float32, device=db.device)
        TXO_gt = torch.as_tensor(np.asarray(TXO_gt), dtype=torch.float32, device=db.device)
        if self.error_type == "ADD":
            errors = add_errors(TXO_pred, TXO_gt, points, valid)
        elif self.error_type == "ADD-S":
            errors = adds_errors(TXO_pred, TXO_gt, points, valid)
        elif self.error_type == "ADD(-S)":
            sym = torch.as_tensor([self.is_symmetric(l) for l in labels], device=db.device)
            e_add = add_errors(TXO_pred, TXO_gt, points, valid)
            if bool(sym.any()):
                e_adds = adds_errors(TXO_pred[sym], TXO_gt[sym], points[sym], valid[sym])
                for k, v in e_add.items():
                    v[sym] = e_adds[k]
            errors = e_add
        else:
            raise ValueError(self.error_type)
        return {k: _numpy(v) for k, v in errors.items()}

    def add(self, pred_data, gt_data):
        """pred_data / gt_data: TensorCollections with infos scene_id,
        view_id, label (and score / visib_fract) and poses (N,4,4)."""
        keys = list(GROUP_KEYS)
        pred_infos = dict(pred_data.infos)
        gt_infos = dict(gt_data.infos)
        pred_poses = _numpy(pred_data.poses).astype(np.float64)
        gt_poses = _numpy(gt_data.poses).astype(np.float64)

        # restrict the predictions to the GT's frames
        frames = table.take({k: gt_infos[k] for k in ("scene_id", "view_id")},
                            table.drop_duplicates(gt_infos, ("scene_id", "view_id")))
        targets = self.targets
        if targets is not None:
            on = [k for k in frames if k in targets]
            li, ri = table.merge(frames, targets, on)
            targets = {**table.take(frames, li),
                       **{k: np.asarray(v)[ri] for k, v in targets.items() if k not in on}}
        _, keep = table.merge(frames, pred_infos, ["scene_id", "view_id"])
        pred_infos = table.take(pred_infos, keep)
        pred_poses = pred_poses[keep]
        pred_infos["pred_inst_id"] = add_inst_num(pred_infos)
        gt_infos["gt_inst_id"] = add_inst_num(gt_infos)

        if not self.consider_all_predictions:
            top = get_top_n_ids(pred_infos, top_key="score", targets=targets, n_top=self.n_top)
            pred_f_infos, pred_f_poses = table.take(pred_infos, top), pred_poses[top]
        else:
            pred_f_infos, pred_f_poses = dict(pred_infos), pred_poses
        gt_infos["valid"] = add_valid_gt(gt_infos, visib_gt_min=self.visib_gt_min,
                                         targets=targets)

        # tentative candidates: same (scene, view, label), valid GT only
        pred_f_infos["pred_id"] = np.arange(table.n_rows(pred_f_infos))
        gt_infos["gt_id"] = np.arange(table.n_rows(gt_infos))
        li, ri = table.merge(pred_f_infos, gt_infos, keys)
        cand = {k: np.asarray(pred_f_infos[k])[li] for k in (*keys, "score", "pred_inst_id",
                                                              "pred_id")}
        cand.update({k: np.asarray(gt_infos[k])[ri] for k in ("gt_inst_id", "valid", "gt_id")})
        cand = table.take(cand, np.flatnonzero(cand["valid"]))

        infos = self.mesh_db.infos
        if self.spheres_overlap_check and table.n_rows(cand):
            diam = np.asarray([infos[l]["diameter_m"] for l in cand["label"]])
            d = np.linalg.norm(pred_f_poses[cand["pred_id"]][:, :3, 3]
                               - gt_poses[cand["gt_id"]][:, :3, 3], axis=-1)
            cand = table.take(cand, np.flatnonzero(d < diam))

        errors = self.compute_errors_batch(pred_f_poses[cand["pred_id"]],
                                           gt_poses[cand["gt_id"]], cand["label"])
        cand["error"] = errors["norm_avg"]
        cand["obj_diameter"] = np.asarray([infos[l]["diameter_m"] for l in cand["label"]],
                                          np.float64)
        cand = table.take(cand, np.flatnonzero(
            cand["error"] <= self.match_threshold * cand["obj_diameter"]))
        matches = table.take(cand, match_poses(cand))

        gt_rec = {k: gt_infos[k] for k in (*keys, "gt_inst_id", "valid")}
        if "visib_fract" in gt_infos:
            gt_rec["visib_fract"] = np.asarray(gt_infos["visib_fract"])
        pred_rec = {k: pred_infos[k] for k in (*keys, "pred_inst_id", "score")}
        m = {k: matches[k] for k in (*keys, "pred_inst_id", "gt_inst_id")}
        m.update(norm=matches["error"], obj_diameter=matches["obj_diameter"],
                 score=matches["score"])
        m["0.1d"] = m["norm"] < 0.1 * m["obj_diameter"]

        # the GT rows with their match's error (inf unmatched), the predictions
        # with whether theirs is within 0.1 d
        _, ri = table.merge(gt_rec, m, (*keys, "gt_inst_id"), how="left")
        hit = ri >= 0
        gt_rec["norm"] = np.where(hit, m["norm"][ri].astype(np.float64) if len(m["norm"])
                                  else np.inf, np.inf)
        gt_rec["0.1d"] = hit & (m["0.1d"][ri] if len(m["0.1d"]) else False)
        _, ri = table.merge(pred_rec, m, (*keys, "pred_inst_id"), how="left")
        pred_rec["0.1d"] = (ri >= 0) & (m["0.1d"][ri] if len(m["0.1d"]) else False)

        self.gt_frames.append(gt_rec)
        self.pred_frames.append(pred_rec)
        self.match_frames.append(m)

    def summary(self):
        gt_df, pred_df = table.concat(self.gt_frames), table.concat(self.pred_frames)
        matches_df = table.concat(self.match_frames)
        n_gt_rows, n_pred, n_matched = (table.n_rows(gt_df), table.n_rows(pred_df),
                                        table.n_rows(matches_df))
        valid_df = table.take(gt_df, np.flatnonzero(gt_df["valid"])) if n_gt_rows else gt_df
        AUC = OrderedDict()
        for label, ids in table.groups(valid_df, ("label",)).items():
            AUC[label[0]] = compute_auc_posecnn(valid_df["norm"][ids])

        # n_gt per label under the top-n protocol
        n_gts = {}
        if self.n_top > 0:
            for (label,), ids in table.groups(gt_df, ("label",)).items():
                sub = table.take(gt_df, ids)
                n_gts[label] = int(sum(min(self.n_top, int(sub["valid"][g].sum()))
                                       for g in table.groups(sub, GROUP_KEYS).values()))
        else:
            for (label,), ids in table.groups(gt_df, ("label",)).items():
                n_gts[label] = int(gt_df["valid"][ids].sum())

        ap_per_label = {}
        for label, n_gt in n_gts.items():
            ldf = table.take(pred_df, np.flatnonzero(pred_df["label"] == label))
            if table.n_rows(ldf) and ldf["0.1d"].sum() > 0 and n_gt > 0:
                ap_per_label[label] = compute_ap(ldf, n_gt)
        mAP = float(np.mean(list(ap_per_label.values()))) if ap_per_label else 0.0
        AP = (compute_ap(pred_df, sum(n_gts.values()))
              if n_pred and sum(n_gts.values()) > 0 else 0.0)

        n_gt_valid = int(sum(n_gts.values()))
        summary = {
            "n_gt": n_gt_rows,
            "n_gt_valid": n_gt_valid,
            "n_pred": n_pred,
            "n_matched": n_matched,
            "matched_gt_ratio": n_matched / max(n_gt_valid, 1),
            "0.1d": float(valid_df["0.1d"].sum() if valid_df else 0) / max(n_gt_valid, 1),
        }
        if self.report_error_stats and n_matched:
            # pandas' mean of a float32 column: a float32 sum over the count
            norm = np.asarray(matches_df["norm"])
            summary["norm"] = float(norm.sum(dtype=norm.dtype) / norm.dtype.type(n_matched))
        if self.report_AP:
            summary.update(AP=AP, mAP=mAP)
        if self.report_error_AUC:
            vals = [v for v in AUC.values() if not np.isnan(v)]
            summary["AUC/objects/mean"] = float(np.mean(vals)) if vals else float("nan")
            summary["AUC"] = compute_auc_posecnn(valid_df["norm"] if valid_df else [])
        dfs = dict(gt=gt_df, matches=matches_df, preds=pred_df, auc_per_object=AUC)
        return summary, dfs


# ---------------------------------------------------------------------------
# DetectionMeter (IoU@threshold AP/mAP)
# ---------------------------------------------------------------------------


def box_iou(a, b):
    """a (N,4), b (M,4) → IoU (N,M)."""
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / np.maximum(union, 1e-9)


def mask_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU of binary masks a (P, H, W) × b (G, H, W) → (P, G)."""
    P, G = a.shape[0], b.shape[0]
    af = a.reshape(P, -1).astype(np.float32)
    bf = b.reshape(G, -1).astype(np.float32)
    inter = af @ bf.T
    union = af.sum(1)[:, None] + bf.sum(1)[None, :] - inter
    return inter / np.maximum(union, 1e-9)


class DetectionMeter:
    def __init__(self, iou_threshold=0.5, targets=None, visib_gt_min=-1, n_top=-1,
                 consider_all_predictions=False, match_by: str = "bbox"):
        """match_by: 'bbox' (the reference's protocol) or 'mask' (IoU of the
        `masks` tensors of both collections)."""
        if match_by not in ("bbox", "mask"):
            raise ValueError(match_by)
        self.iou_threshold = iou_threshold
        self.targets = targets
        self.visib_gt_min = visib_gt_min
        self.n_top = n_top
        self.consider_all_predictions = consider_all_predictions
        self.match_by = match_by
        self.reset()

    def reset(self):
        self.pred_frames = []
        self.gt_frames = []

    def add(self, pred_data, gt_data):
        pred_infos, gt_infos = dict(pred_data.infos), dict(gt_data.infos)
        pred_boxes = _numpy(pred_data.bboxes).astype(np.float64)
        gt_boxes = _numpy(gt_data.bboxes).astype(np.float64)
        if self.match_by == "mask":
            if "masks" not in pred_data.tensors or "masks" not in gt_data.tensors:
                raise ValueError("match_by='mask' needs `masks` on both collections")
            pred_masks = _numpy(pred_data.masks).astype(bool)
            gt_masks = _numpy(gt_data.masks).astype(bool)

        gt_infos["valid"] = add_valid_gt(gt_infos, visib_gt_min=self.visib_gt_min,
                                         targets=self.targets)
        n_pred = table.n_rows(pred_infos)
        pred_matched = np.zeros(n_pred, bool)
        gt_matched = np.zeros(table.n_rows(gt_infos), bool)
        pred_iou = np.zeros(n_pred)
        all_scores = np.asarray(pred_infos["score"]) if n_pred else np.zeros(0)
        all_valid = gt_infos["valid"]
        pred_groups = table.groups(pred_infos, GROUP_KEYS)
        for key, gids in table.groups(gt_infos, GROUP_KEYS).items():
            pids = pred_groups.get(key)
            if pids is None:
                continue
            valid_g = all_valid[gids]
            if self.match_by == "mask":
                iou = mask_iou(pred_masks[pids], gt_masks[gids])
            else:
                iou = box_iou(pred_boxes[pids], gt_boxes[gids])
            iou[:, ~valid_g] = -1.0
            order = np.argsort(-all_scores[pids])
            taken = np.zeros(len(gids), bool)
            for oi in order:
                row = np.where(taken, -1.0, iou[oi])
                gj = int(np.argmax(row))
                if row[gj] >= self.iou_threshold:
                    taken[gj] = True
                    pred_matched[pids[oi]] = True
                    gt_matched[gids[gj]] = True
                    pred_iou[pids[oi]] = row[gj]

        pred_infos["matched"] = pred_matched
        pred_infos["match_iou"] = pred_iou
        gt_infos["matched"] = gt_matched
        self.pred_frames.append(pred_infos)
        self.gt_frames.append(gt_infos)

    def summary(self):
        pred_df, gt_df = table.concat(self.pred_frames), table.concat(self.gt_frames)
        n_pred = table.n_rows(pred_df)
        n_gt = {l: int(gt_df["valid"][ids].sum())
                for (l,), ids in table.groups(gt_df, ("label",)).items()}
        aps = {}
        for l, n in n_gt.items():
            sel = np.flatnonzero(pred_df["label"] == l) if n_pred else []
            if n > 0 and len(sel):
                aps[l] = compute_ap(table.take(pred_df, sel), n, valid_key="matched")
        valid = np.asarray(gt_df["valid"], bool) if gt_df else np.zeros(0, bool)
        summary = dict(
            n_gt=int(valid.sum()),
            n_pred=n_pred,
            recall=float(gt_df["matched"][valid].mean()) if valid.any() else 0.0,
            AP=compute_ap(pred_df, sum(n_gt.values()), valid_key="matched") if n_pred else 0.0,
            mAP=float(np.mean(list(aps.values()))) if aps else 0.0,
        )
        if n_pred and pred_df["matched"].any():
            summary["matched_iou_mean"] = float(pred_df["match_iou"][pred_df["matched"]].mean())
        return summary, dict(preds=pred_df, gt=gt_df, ap_per_label=aps)
