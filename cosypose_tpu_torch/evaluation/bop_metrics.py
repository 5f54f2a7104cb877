"""Native BOP19 pose errors (MSSD, MSPD, VSD) and the challenge's Average
Recall (port of cosypose_tpu/evaluation/bop_metrics.py).

Definitions (Hodan et al., "BOP Challenge 2020"; S = the object's symmetry
set, x = its model points):
  e_MSSD = min_S max_x || T̂ x − T_gt S x ||            (meters)
  e_MSPD = min_S max_x || proj(T̂ x) − proj(T_gt S x) || (pixels, scaled by
           r = 640/w)
  e_VSD  = 1 − |matched visible px| / |union visible px|, from depth renders
           of the estimate and the GT against the scene depth (δ = 15 mm),
           with τ ∈ {5%..50%} of the object diameter.
Recall thresholds: MSSD θ ∈ {0.05..0.50}·diameter, MSPD θ ∈ {5r..50r} px,
VSD θ ∈ {0.05..0.50} × the 10 τ. AR = mean(AR_VSD, AR_MSSD, AR_MSPD).

The host arithmetic is the JAX package's, in float64 numpy. VSD renders the
depth of a frame's estimates and GT instances of one label in one call of
the port's BatchRenderer: on the card the raster kernels, with
BatchRenderer's tile and triangle budget, on the CPU their plain versions.
"""

from __future__ import annotations

import logging

import numpy as np

logger = logging.getLogger(__name__)

VSD_DELTA = 0.015           # visibility tolerance δ, meters
VSD_TAUS_REL = np.arange(0.05, 0.51, 0.05)        # τ / diameter
RECALL_THRESHOLDS = np.arange(0.05, 0.51, 0.05)   # θ (VSD, MSSD·diam)
MSPD_THRESHOLDS = np.arange(5.0, 51.0, 5.0)       # θ·r pixels
VISIB_GT_MIN = 0.1


# ---------------------------------------------------------------------------
# per-pair errors
# ---------------------------------------------------------------------------

def mssd(T_est, T_gt, pts, valid, syms, sym_valid):
    """e_MSSD of one (estimate, GT) pair, meters. pts (P,3) with validity
    (P,); syms (S,4,4) with validity (S,)."""
    pts = np.asarray(pts, np.float64)[np.asarray(valid, bool)]
    est_pts = pts @ T_est[:3, :3].T + T_est[:3, 3]
    out = np.inf
    for S, ok in zip(np.asarray(syms, np.float64), np.asarray(sym_valid)):
        if not ok:
            continue
        gt_pts = pts @ (T_gt[:3, :3] @ S[:3, :3]).T + (T_gt[:3, :3] @ S[:3, 3] + T_gt[:3, 3])
        out = min(out, float(np.linalg.norm(est_pts - gt_pts, axis=-1).max()))
    return out


def _project(T, S, pts, K):
    p = pts @ (T[:3, :3] @ S[:3, :3]).T + (T[:3, :3] @ S[:3, 3] + T[:3, 3])
    z = np.maximum(p[:, 2], 1e-9)
    return np.stack([K[0, 0] * p[:, 0] / z + K[0, 2], K[1, 1] * p[:, 1] / z + K[1, 2]], axis=-1)


def mspd(T_est, T_gt, K, pts, valid, syms, sym_valid, im_w):
    """e_MSPD of one pair, in r-normalized pixels (r = 640/w)."""
    pts = np.asarray(pts, np.float64)[np.asarray(valid, bool)]
    K = np.asarray(K, np.float64)
    est_uv = _project(np.asarray(T_est, np.float64), np.eye(4), pts, K)
    out = np.inf
    for S, ok in zip(np.asarray(syms, np.float64), np.asarray(sym_valid)):
        if not ok:
            continue
        gt_uv = _project(np.asarray(T_gt, np.float64), S, pts, K)
        out = min(out, float(np.linalg.norm(est_uv - gt_uv, axis=-1).max()))
    return out * (640.0 / float(im_w))


def _visib_mask(d_scene, d_render, delta):
    """Rendered pixels in front of (or within δ of) the scene surface, or
    where the scene depth is invalid."""
    rendered = d_render > 0
    return rendered & ((d_render - d_scene <= delta) | (d_scene <= 0))


def vsd(d_est, d_gt, d_scene, diameter, taus_rel=VSD_TAUS_REL, delta=VSD_DELTA):
    """e_VSD of one pair, one value a τ. Depth maps in meters, 0 = invalid.
    The estimate's visible pixels include its pixels inside the GT's visible
    region."""
    d_est = np.asarray(d_est, np.float32)
    d_gt = np.asarray(d_gt, np.float32)
    d_scene = np.asarray(d_scene, np.float32)
    visib_gt = _visib_mask(d_scene, d_gt, delta)
    visib_est = _visib_mask(d_scene, d_est, delta) | ((d_est > 0) & visib_gt)
    union = visib_gt | visib_est
    n_union = int(union.sum())
    if n_union == 0:
        return np.ones(len(taus_rel))
    inter = visib_gt & visib_est
    diff = np.abs(d_gt - d_est)[inter]
    errs = np.empty(len(taus_rel))
    for i, tr in enumerate(taus_rel):
        errs[i] = 1.0 - int((diff <= tr * diameter).sum()) / n_union
    return errs


# ---------------------------------------------------------------------------
# matching + Average Recall
# ---------------------------------------------------------------------------

def _greedy_match_count(err_matrix, scores, theta, gt_valid=None):
    """The toolkit's matching: the top-n estimates by score (n = every
    annotated GT instance of the label, low-visibility ones included) each
    take the lowest-error unmatched GT with error < θ. A match to an ignored
    GT consumes the estimate and does not count."""
    n_est, n_gt = err_matrix.shape
    if gt_valid is None:
        gt_valid = np.ones(n_gt, bool)
    order = np.argsort(-np.asarray(scores))[:n_gt]
    taken = np.zeros(n_gt, bool)
    n = 0
    for ei in order:
        cand = np.where(~taken & (err_matrix[ei] < theta))[0]
        if len(cand):
            gi = cand[np.argmin(err_matrix[ei, cand])]
            taken[gi] = True
            n += int(gt_valid[gi])
    return n


class BopAverageRecall:
    """Accumulates per-(image, label) error matrices; summary() gives
    {AR, AR_vsd, AR_mssd, AR_mspd, recalls per metric, n_gt}."""

    def __init__(self, error_types=("vsd", "mssd", "mspd")):
        self.error_types = tuple(error_types)
        self.groups = {t: [] for t in self.error_types}
        self.n_gt = 0

    def add_group(self, errors: dict, scores, gt_valid):
        """errors[type]: (n_est, n_gt[, n_tau]) errors of one image's
        estimates of one label against all its annotated GTs. gt_valid: a
        bool mask over the GT columns (False: ignored, absorbs an estimate and
        scores nothing), or an int n for n valid columns."""
        if np.isscalar(gt_valid):
            gt_valid = np.ones(int(gt_valid), bool)
        gt_valid = np.asarray(gt_valid, bool)
        self.n_gt += int(gt_valid.sum())
        for t in self.error_types:
            e = np.asarray(errors[t], np.float64)
            if e.ndim == 2:
                e = e[..., None]
            if e.shape[1] != gt_valid.shape[0]:
                raise ValueError(f"{t}: error matrix has {e.shape[1]} GT columns but gt_valid "
                                 f"has {gt_valid.shape[0]}")
            self.groups[t].append((e, np.asarray(scores, np.float64), gt_valid))

    def summary(self):
        out, ars = {}, []
        for t in self.error_types:
            if t == "vsd":
                thresholds, n_var = RECALL_THRESHOLDS, len(VSD_TAUS_REL)
            elif t == "mssd":
                thresholds, n_var = RECALL_THRESHOLDS, 1   # ·diameter, already divided
            else:
                thresholds, n_var = MSPD_THRESHOLDS, 1
            recalls = np.zeros((n_var, len(thresholds)))
            for vi in range(n_var):
                for ti, th in enumerate(thresholds):
                    matched = sum(_greedy_match_count(e[:, :, min(vi, e.shape[2] - 1)], s, th, gv)
                                  for e, s, gv in self.groups[t])
                    recalls[vi, ti] = matched / max(self.n_gt, 1)
            ar = float(recalls.mean())
            out[f"AR_{t}"] = ar
            out[f"recalls_{t}"] = recalls.squeeze().tolist()
            ars.append(ar)
        out["AR"] = float(np.mean(ars))
        out["n_gt"] = self.n_gt
        return out


def _diameter_from_points(pts, valid):
    pts = np.asarray(pts, np.float64)[np.asarray(valid, bool)]
    if len(pts) > 1500:
        pts = pts[np.linspace(0, len(pts) - 1, 1500).astype(int)]
    d2 = ((pts[:, None] - pts[None]) ** 2).sum(-1)
    return float(np.sqrt(d2.max()))


def compute_bop19_ar(preds, scene_ds, mesh_db, renderer=None,
                     error_types=("vsd", "mssd", "mspd"), n_frames=None,
                     visib_gt_min=VISIB_GT_MIN):
    """BOP19 Average Recall of predictions against a scene dataset's GT.

    preds: TensorCollection with infos scene_id, view_id, label, score and
    poses (N,4,4). VSD needs `renderer` (a BatchRenderer over the same mesh
    database) and each frame's scene depth (`camera.depth`: load_depth=True);
    without a renderer VSD is dropped from the mean, and a frame without
    depth scores VSD errors of 1, each with a warning.
    """
    error_types = list(error_types)
    if "vsd" in error_types and renderer is None:
        logger.warning("VSD skipped: no renderer provided")
        error_types.remove("vsd")

    geom = {}

    def obj_geom(label):
        if label not in geom:
            lid = mesh_db.label_to_id[label]
            pts = mesh_db.points[lid].cpu().numpy()
            valid = mesh_db.valid[lid].cpu().numpy()
            diam = mesh_db.infos.get(label, {}).get("diameter_m") or \
                _diameter_from_points(pts, valid)
            geom[label] = (lid, pts, valid, mesh_db.symmetries[lid].cpu().numpy(),
                           mesh_db.sym_valid[lid].cpu().numpy(), diam)
        return geom[label]

    acc = BopAverageRecall(error_types)
    infos = preds.infos
    pred_poses = preds.poses.detach().cpu().numpy() if hasattr(preds.poses, "detach") \
        else np.asarray(preds.poses)
    scene_ids, view_ids = np.asarray(infos["scene_id"]), np.asarray(infos["view_id"])
    labels, all_scores = np.asarray(infos["label"]), np.asarray(infos["score"], np.float64)

    n = len(scene_ds.frame_index) if n_frames is None else min(n_frames,
                                                               len(scene_ds.frame_index))
    vsd_on = "vsd" in error_types
    missing_depth = 0
    for i in range(n):
        rgb, _, obs = scene_ds[i]
        frame = obs["frame_info"]
        K = np.asarray(obs["camera"]["K"], np.float64)
        im_w = rgb.shape[1]
        d_scene = obs["camera"].get("depth")
        TCW = np.linalg.inv(np.asarray(obs["camera"]["TWC"], np.float64))

        # every annotated GT by label; low-visibility ones stay as ignored
        # columns (the toolkit's n_top=-1 semantics)
        gt_by_label, gt_valid_by_label = {}, {}
        for o in obs["objects"]:
            gt_by_label.setdefault(o["label"], []).append(TCW @ np.asarray(o["TWO"], np.float64))
            gt_valid_by_label.setdefault(o["label"], []).append(
                float(o.get("visib_fract", 1.0)) >= visib_gt_min)

        sel = np.flatnonzero((scene_ids == frame["scene_id"]) & (view_ids == frame["view_id"]))
        for label, gts in gt_by_label.items():
            gt_valid = np.asarray(gt_valid_by_label[label], bool)
            rows = sel[labels[sel] == label]
            scores = all_scores[rows]
            if len(rows) > len(gts):  # top-n by score, n = annotated instances
                keep = np.argsort(-scores)[:len(gts)]
                rows, scores = rows[keep], scores[keep]
            ests = pred_poses[rows] if len(rows) else np.zeros((0, 4, 4))
            lid, pts, valid, syms, sym_valid, diam = obj_geom(label)

            errors = {}
            if "mssd" in error_types:
                errors["mssd"] = np.array(
                    [[mssd(Te, Tg, pts, valid, syms, sym_valid) / diam for Tg in gts]
                     for Te in ests]).reshape(len(ests), len(gts))
            if "mspd" in error_types:
                errors["mspd"] = np.array(
                    [[mspd(Te, Tg, K, pts, valid, syms, sym_valid, im_w) for Tg in gts]
                     for Te in ests]).reshape(len(ests), len(gts))
            if vsd_on:
                if d_scene is None:
                    missing_depth += 1
                    errors["vsd"] = np.ones((len(ests), len(gts), len(VSD_TAUS_REL)))
                else:
                    errors["vsd"] = _vsd_matrix(renderer, lid, ests, gts, K, d_scene, diam)
            acc.add_group(errors, scores, gt_valid)

    if missing_depth:
        logger.warning(f"VSD: {missing_depth} groups had no scene depth (scored as errors=1)")
    return acc.summary()


def vsd_render_inputs(label_id, ests, gts, K):
    """(label ids (n,), poses (n,4,4) float32, K (n,3,3) float32) of one
    group's depth render: the estimates, then the GTs."""
    poses = np.concatenate([np.asarray(ests, np.float32).reshape(-1, 4, 4),
                            np.asarray(gts, np.float32).reshape(-1, 4, 4)])
    return (np.full(len(poses), label_id, np.int64), poses,
            np.tile(np.asarray(K, np.float32)[None], (len(poses), 1, 1)))


def _vsd_matrix(renderer, label_id, ests, gts, K, d_scene, diam):
    """Render the estimates' and GTs' depth in one call, then pairwise e_VSD.
    The batch is not padded: the JAX package pads it to a power of two with
    poses behind the camera to spare XLA recompiles, which renders the same
    depths for the real items."""
    h, w = d_scene.shape[:2]
    lids, poses, Ks = vsd_render_inputs(label_id, ests, gts, K)
    if len(poses) == 0:
        return np.ones((0, 0, len(VSD_TAUS_REL)))
    depths = renderer.render(lids, poses, Ks, resolution=(h, w),
                             render_depth=True).depth.cpu().numpy()
    d_ests, d_gts = depths[:len(ests)], depths[len(ests):]
    M = np.empty((len(ests), len(gts), len(VSD_TAUS_REL)))
    for a in range(len(ests)):
        for b in range(len(gts)):
            M[a, b] = vsd(d_ests[a], d_gts[b], d_scene, diam)
    return M
