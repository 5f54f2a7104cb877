"""Port parity for the evaluation meters, JAX package vs port on the CPU.

evaluation/table.py against pandas (the row orders the meters depend on),
ops/symmetric.py, the matching helpers, AP, PoseErrorMeter (ADD, ADD-S,
ADD(-S); targets, top-n, visib_gt_min, the sphere check; the file gather
across processes), chunked ADD-S, DetectionMeter by box and by mask, and the
BOP CSV round trip.

Tolerances: the table operations, match sets, counts, validity flags and
CSV text exactly equal; AP (the port's from its definition, JAX's through
scikit-learn) within 1e-12; the float32 distances and meter errors within
1e-6 relative (two float32 implementations of the same formulas); summary
values derived from the errors (norm, AUC) within 1e-6 relative, the other
summary values within 1e-9. Given the JAX package's errors, the port's
bookkeeping reproduces every summary value within 1e-9. Chunked ADD-S equals
unchunked exactly.
"""

import threading

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from cosypose_tpu.evaluation import bop_export as jexport
from cosypose_tpu.evaluation import meters as jm
from cosypose_tpu.ops import symmetric as jsym
from cosypose_tpu.ops.mesh_db import MeshSpec as JMeshSpec
from cosypose_tpu.ops.mesh_db import build_mesh_db as j_build_mesh_db
from cosypose_tpu.utils.tensor_collection import PandasTensorCollection
from cosypose_tpu_torch.evaluation import bop_export as texport
from cosypose_tpu_torch.evaluation import meters as tm
from cosypose_tpu_torch.evaluation import table
from cosypose_tpu_torch.ops import symmetric as tsym
from cosypose_tpu_torch.ops.mesh_db import MeshSpec, build_mesh_db
from cosypose_tpu_torch.utils.tensor_collection import TensorCollection

KEYS = ["scene_id", "view_id", "label"]


# ---------------------------------------------------------------------------
# table.py against pandas
# ---------------------------------------------------------------------------


def _frames(seed, n=40):
    rng = np.random.RandomState(seed)
    return dict(scene_id=rng.randint(0, 2, n), view_id=rng.randint(0, 3, n),
                label=np.asarray([f"obj_{i}" for i in rng.randint(0, 3, n)]),
                score=np.round(rng.rand(n), 1))


@pytest.mark.parametrize("seed", [0, 1])
def test_table_matches_pandas(seed):
    t = _frames(seed)
    df = pd.DataFrame(t)
    assert np.array_equal(table.group_codes(t, KEYS), df.groupby(KEYS, sort=False).ngroup().values)
    ref = df.groupby(KEYS).groups
    got = table.groups(t, KEYS)
    assert list(got) == list(ref)
    for k in ref:
        assert np.array_equal(got[k], np.asarray(ref[k]))
    assert np.array_equal(table.drop_duplicates(t, ["scene_id", "view_id"]),
                          df[["scene_id", "view_id"]].drop_duplicates().index.values)
    # joins with duplicate keys on both sides, and keys only on one side
    r = _frames(seed + 10, 25)
    dl = df.assign(_l=np.arange(len(df)))
    dr = pd.DataFrame(r).drop(columns="score").assign(_r=np.arange(25))
    for how in ("inner", "left"):
        li, ri = table.merge(t, r, KEYS, how=how)
        m = dl.merge(dr, on=KEYS, how=how)
        assert np.array_equal(li, m["_l"].values)
        assert np.array_equal(ri, m["_r"].fillna(-1).astype(int).values)
    # descending sorts of tied groups, in pandas' order
    for ids in [*ref.values(), np.arange(len(df))]:
        ids = np.asarray(ids)
        order = ids[table.argsort_desc(t["score"][ids])]
        assert np.array_equal(order, df.loc[ids].sort_values("score", ascending=False).index)
    assert table.n_rows(table.concat([t, table.take(t, [3, 1])])) == 42


def test_table_empty_frames():
    empty = dict(scene_id=np.zeros(0, int), view_id=np.zeros(0, int), label=np.zeros(0, str))
    t = _frames(2, 5)
    li, ri = table.merge(empty, t, KEYS)
    assert len(li) == len(ri) == 0
    li, ri = table.merge(t, empty, KEYS, how="left")
    assert np.array_equal(li, np.arange(5)) and (ri == -1).all()
    assert table.groups(empty, KEYS) == {} and len(table.group_codes(empty, KEYS)) == 0
    assert table.concat([]) == {} and table.n_rows({}) == 0


# ---------------------------------------------------------------------------
# symmetric distances
# ---------------------------------------------------------------------------


def random_poses(rng, n, t_scale=0.1, z=0.0):
    T = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    for i in range(n):
        Q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        if np.linalg.det(Q) < 0:
            Q[:, 0] *= -1
        T[i, :3, :3] = Q
        T[i, :3, 3] = rng.uniform(-t_scale, t_scale, 3) + (0, 0, z)
    return T


def _rel(port, ref):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-30))


def test_symmetric_distances_match_jax():
    rng = np.random.RandomState(0)
    B, P, S = 5, 60, 4
    T1, T2 = random_poses(rng, B, z=0.6), random_poses(rng, B, z=0.6)
    pts = rng.uniform(-0.05, 0.05, (B, P, 3)).astype(np.float32)
    syms = np.concatenate([np.eye(4, dtype=np.float32)[None], random_poses(rng, S - 1, 0.0)])
    syms = np.tile(syms[None], (B, 1, 1, 1))
    sym_valid = np.ones((B, S), bool)
    sym_valid[1:, 2:] = False
    K = np.tile(np.array([[500, 0, 160], [0, 500, 120], [0, 0, 1]], np.float32), (B, 1, 1))
    j, t = (lambda *a: [jnp.asarray(x) for x in a]), (lambda *a: [torch.as_tensor(x) for x in a])
    assert _rel(tsym.mesh_points_dist(*t(T1, T2, pts)), jsym.mesh_points_dist(*j(T1, T2, pts))) < 1e-6
    assert _rel(tsym.reprojected_dist(*t(T1, T2, K, pts)),
                jsym.reprojected_dist(*j(T1, T2, K, pts))) < 1e-6
    assert _rel(tsym.chamfer_dist(*t(T1, T2, pts)), jsym.chamfer_dist(*j(T1, T2, pts))) < 1e-6
    for name in ("symmetric_distance_batched_fast", "symmetric_distance_reprojected"):
        args = (T1, T2, K, pts, syms, sym_valid) if "reprojected" in name else \
            (T1, T2, pts, syms, sym_valid)
        d_t, s_t = getattr(tsym, name)(*t(*args))
        d_j, s_j = getattr(jsym, name)(*j(*args))
        assert _rel(d_t, d_j) < 1e-6, name
        assert np.array_equal(s_t.numpy(), np.asarray(s_j)), name


# ---------------------------------------------------------------------------
# matching helpers and AP
# ---------------------------------------------------------------------------


def test_compute_ap_matches_sklearn():
    rng = np.random.RandomState(2)
    n_cases = 0
    for _ in range(30):
        n = rng.randint(5, 60)
        y = rng.rand(n) < 0.5
        score = np.round(rng.rand(n), 1)   # quantised: ties across labels
        n_gt = int(y.sum()) + rng.randint(0, 10)
        ref = jm.compute_ap(pd.DataFrame({"0.1d": y, "score": score}), n_gt)
        assert abs(tm.compute_ap({"0.1d": y, "score": score}, n_gt) - ref) < 1e-12
        n_cases += int(ref > 0)
    assert n_cases > 20
    assert tm.compute_ap({"0.1d": np.zeros(3, bool), "score": np.ones(3)}, 4) == 0.0


def test_auc_and_matching_helpers_match_jax():
    rng = np.random.RandomState(0)
    for errors in (rng.uniform(0, 0.2, 500), rng.uniform(0, 0.05, 64),
                   np.r_[rng.uniform(0, 0.1, 10), np.full(5, np.inf)], rng.uniform(0.15, 0.5, 32)):
        ref, port = jm.compute_auc_posecnn(errors), tm.compute_auc_posecnn(errors)
        assert (np.isnan(ref) and np.isnan(port)) or abs(ref - port) < 1e-12
    t = _frames(3, 60)
    t["visib_fract"] = np.round(rng.rand(60), 1)
    df = pd.DataFrame(t)
    targets = dict(scene_id=np.array([0, 0, 1, 1]), view_id=np.array([0, 1, 2, 0]),
                   label=np.array(["obj_0", "obj_1", "obj_2", "obj_0"]),
                   inst_count=np.array([2, 1, 3, 1]))
    for kw in (dict(), dict(n_top=2), dict(targets=targets)):
        jkw = dict(kw, targets=pd.DataFrame(kw["targets"])) if "targets" in kw else kw
        assert np.array_equal(tm.get_top_n_ids(t, **kw), jm.get_top_n_ids(df, **jkw))
    for kw in (dict(), dict(visib_gt_min=0.3), dict(targets=targets),
               dict(visib_gt_min=0.3, targets=targets)):
        jkw = dict(kw, targets=pd.DataFrame(kw["targets"])) if "targets" in kw else kw
        assert np.array_equal(tm.add_valid_gt(t, **kw), jm.add_valid_gt(df.copy(), **jkw)["valid"])
    assert np.array_equal(tm.add_inst_num(t), jm.add_inst_num(df.copy(), key="i")["i"].values)


def test_match_poses_matches_jax():
    rng = np.random.RandomState(1)
    for _ in range(5):
        rows = []
        for f in range(4):
            for lab in range(3):
                preds = rng.choice(20, size=rng.randint(0, 5), replace=False)
                gts = rng.choice(20, size=rng.randint(0, 5), replace=False)
                scores = {p: np.round(rng.uniform(0, 1), 1) for p in preds}   # tied scores
                for p in preds:
                    for g in gts:
                        rows.append(dict(scene_id=0, view_id=f, label=f"obj_{lab}",
                                         pred_id=int(p) + 100 * f + 1000 * lab,
                                         gt_id=int(g) + 100 * f + 1000 * lab, score=scores[p],
                                         error=np.float32(rng.choice([0.01, 0.02, 0.05]))))
        df = pd.DataFrame(rows)
        ref = jm.match_poses(df.copy())
        cand = {k: df[k].values for k in df.columns}
        got = table.take(cand, tm.match_poses(cand))
        assert list(zip(got["pred_id"], got["gt_id"])) == list(zip(ref["pred_id"], ref["gt_id"]))


# ---------------------------------------------------------------------------
# PoseErrorMeter
# ---------------------------------------------------------------------------


def _blob(rng, n_verts, scale):
    v = rng.randn(n_verts, 3)
    v = v / np.linalg.norm(v, axis=1, keepdims=True) * scale * (1 + 0.3 * rng.rand(n_verts, 1))
    return v, rng.randint(0, n_verts, (2 * n_verts, 3))


def meter_specs():
    """Three objects of 60-100 points: no symmetry, a discrete one (180° about
    z) and a continuous one about z."""
    rng = np.random.RandomState(0)
    z180 = [[-1, 0, 0, 0, 0, -1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1]]
    out = []
    for i, (n, scale, kw) in enumerate([(60, 40.0, {}), (80, 50.0, dict(symmetries_discrete=z180)),
                                        (100, 30.0, dict(symmetries_continuous=[
                                            {"axis": [0, 0, 1], "offset": [0, 0, 0]}]))]):
        v, f = _blob(rng, n, scale)
        out.append(dict(label=f"obj_{i + 1:06d}", vertices=v, faces=f, **kw))
    return out


@pytest.fixture(scope="module")
def dbs():
    specs = meter_specs()
    jdb = j_build_mesh_db([JMeshSpec(**s) for s in specs], keep_geometry=False)
    tdb = build_mesh_db([MeshSpec(**s) for s in specs], device="cpu")
    assert jdb.infos == tdb.infos
    return jdb, tdb


def meter_case(seed):
    """(pred infos, pred poses, GT infos, GT poses): 4 frames of up to 3
    instances a label (two of one label in a frame included), predictions
    near most GTs, duplicates, far-off ones, tied scores, and predictions in
    a frame without GT."""
    rng = np.random.RandomState(seed)
    gt, gt_T, pred, pred_T = [], [], [], []
    for view in range(4):
        for li in range(3):
            label = f"obj_{li + 1:06d}"
            for _ in range(rng.randint(0, 3) + (view == 0)):
                T = random_poses(rng, 1, 0.1, z=0.7)[0]
                gt.append((1, view, label, float(np.round(rng.rand(), 2))))
                gt_T.append(T)
                for k in range(rng.randint(0, 3)):
                    P = T.copy()
                    P[:3, 3] += rng.normal(0, [0.002, 0.006, 0.03][k], 3)
                    if rng.rand() < 0.3:   # rotated by the discrete symmetry
                        P[:3, :3] = P[:3, :3] @ np.diag([-1.0, -1.0, 1.0]).astype(np.float32)
                    pred.append((1, view, label, float(np.round(rng.rand(), 1))))
                    pred_T.append(P)
    for _ in range(3):
        pred.append((2, 0, "obj_000001", 0.5))
        pred_T.append(random_poses(rng, 1, 0.1, z=0.7)[0])

    def cols(rows, names):
        return {n: np.asarray(v) for n, v in zip(names, zip(*rows))}

    return (cols(pred, KEYS + ["score"]), np.stack(pred_T), cols(gt, KEYS + ["visib_fract"]),
            np.stack(gt_T))


def _targets(gt):
    k = table.groups(gt, KEYS)
    return dict(scene_id=np.asarray([key[0] for key in k]), view_id=np.asarray([key[1] for key in k]),
                label=np.asarray([key[2] for key in k]),
                inst_count=np.asarray([max(1, len(ids) - 1) for ids in k.values()]))


METER_CASES = {
    "ADD": dict(error_type="ADD"),
    "ADD-S": dict(error_type="ADD-S"),
    "ADD(-S)": dict(error_type="ADD(-S)"),
    "ADD(-S)/targets": dict(error_type="ADD(-S)", targets=True),
    "ADD(-S)/n_top": dict(error_type="ADD(-S)", n_top=1),
    "ADD/visib_gt_min": dict(error_type="ADD", visib_gt_min=0.3),
    "ADD/no_sphere_check": dict(error_type="ADD", spheres_overlap_check=False,
                                consider_all_predictions=True),
}


def run_meters(dbs, case, seed, port_errors_from_jax=False, monkeypatch=None):
    jdb, tdb = dbs
    pred, pred_T, gt, gt_T = meter_case(seed)
    kw = dict(METER_CASES[case], report_AP=True, report_error_AUC=True, report_error_stats=True)
    if kw.pop("targets", False):
        kw["targets"] = _targets(gt)
    jkw = dict(kw, targets=pd.DataFrame(kw["targets"])) if "targets" in kw else kw
    jmeter, tmeter = jm.PoseErrorMeter(jdb, **jkw), tm.PoseErrorMeter(tdb, **kw)
    if port_errors_from_jax:
        monkeypatch.setattr(tmeter, "compute_errors_batch", jmeter.compute_errors_batch)
    for sl in (slice(0, 2), slice(2, 4)):   # two add() calls: frames 0-1, then 2-3 and the rest
        p = np.flatnonzero(np.isin(pred["view_id"], np.arange(4)[sl]) | (pred["scene_id"] == 2))
        g = np.flatnonzero(np.isin(gt["view_id"], np.arange(4)[sl]))
        jmeter.add(PandasTensorCollection(pd.DataFrame(table.take(pred, p)),
                                          poses=jnp.asarray(pred_T[p])),
                   PandasTensorCollection(pd.DataFrame(table.take(gt, g)),
                                          poses=jnp.asarray(gt_T[g])))
        tmeter.add(TensorCollection(table.take(pred, p), poses=torch.as_tensor(pred_T[p])),
                   TensorCollection(table.take(gt, g), poses=torch.as_tensor(gt_T[g])))
    return jmeter.summary(), tmeter.summary()


def _compare_summaries(ref, port, rtol_from_errors):
    assert list(ref) == list(port)
    for k, v in ref.items():
        if isinstance(v, (int, np.integer)):
            assert port[k] == v, k
        elif np.isnan(v):   # an AUC over no match
            assert np.isnan(port[k]), k
        elif k in ("norm", "AUC", "AUC/objects/mean"):
            assert abs(port[k] - v) <= rtol_from_errors * abs(v) + 1e-12, (k, port[k], v)
        else:
            assert abs(port[k] - v) <= 1e-9, (k, port[k], v)


@pytest.mark.parametrize("case", list(METER_CASES))
def test_pose_error_meter_matches_jax(dbs, case):
    (ref, rdfs), (port, pdfs) = run_meters(dbs, case, seed=3)
    assert ref["n_matched"] > 2 and ref["n_pred"] > ref["n_matched"], ref
    _compare_summaries(ref, port, 1e-6)
    rm, pm = rdfs["matches"], pdfs["matches"]
    key = KEYS + ["pred_inst_id", "gt_inst_id"]
    assert list(zip(*[rm[k].tolist() for k in key])) == list(zip(*[pm[k].tolist() for k in key]))
    assert _rel(pm["norm"], rm["norm"].values) < 1e-6
    assert np.array_equal(pm["0.1d"], rm["0.1d"].values.astype(bool))
    for name in ("gt", "preds"):
        assert np.array_equal(pdfs[name]["0.1d"], rdfs[name]["0.1d"].values.astype(bool))
    assert np.array_equal(pdfs["gt"]["valid"], rdfs["gt"]["valid"].values)


@pytest.mark.parametrize("case", ["ADD(-S)/targets", "ADD(-S)/n_top"])
def test_pose_error_meter_bookkeeping_given_jax_errors(dbs, case, monkeypatch):
    (ref, _), (port, pdfs) = run_meters(dbs, case, seed=5, port_errors_from_jax=True,
                                        monkeypatch=monkeypatch)
    _compare_summaries(ref, port, 1e-12)


def test_meter_gather_across_processes_matches_jax(dbs, tmp_path):
    """Two meters, each fed half the frames, gathered through a shared
    directory (a thread standing for each process), summarise as the JAX
    meter fed all of them; one process leaves a meter as it is."""
    _, tdb = dbs
    (ref, _), _ = run_meters(dbs, "ADD(-S)", seed=3)
    pred, pred_T, gt, gt_T = meter_case(3)
    kw = dict(METER_CASES["ADD(-S)"], report_AP=True, report_error_AUC=True,
              report_error_stats=True)
    meters = [tm.PoseErrorMeter(tdb, **kw) for _ in range(2)]
    for meter, sl in zip(meters, (slice(0, 2), slice(2, 4))):
        p = np.flatnonzero(np.isin(pred["view_id"], np.arange(4)[sl]) | (pred["scene_id"] == 2))
        g = np.flatnonzero(np.isin(gt["view_id"], np.arange(4)[sl]))
        meter.add(TensorCollection(table.take(pred, p), poses=torch.as_tensor(pred_T[p])),
                  TensorCollection(table.take(gt, g), poses=torch.as_tensor(gt_T[g])))
    alone = tm.gather_multihost(meters[0], tmp_path / "alone")
    assert alone is meters[0] and len(alone.gt_frames) == 1
    threads = [threading.Thread(target=tm.gather_multihost, args=(m, tmp_path / "two", pid, 2, 60.0))
               for pid, m in enumerate(meters)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for meter in meters:
        _compare_summaries(ref, meter.summary()[0], 1e-6)


@pytest.mark.parametrize("error_type", ["ADD", "ADD-S", "ADD(-S)"])
def test_meter_errors_match_jax(dbs, error_type):
    jdb, tdb = dbs
    rng = np.random.RandomState(4)
    n = 9
    T1, T2 = random_poses(rng, n, z=0.7), random_poses(rng, n, z=0.7)
    labels = np.asarray([f"obj_{i % 3 + 1:06d}" for i in range(n)])
    ref = jm.PoseErrorMeter(jdb, error_type=error_type).compute_errors_batch(T1, T2, labels)
    port = tm.PoseErrorMeter(tdb, error_type=error_type).compute_errors_batch(T1, T2, labels)
    for k in ref:
        assert port[k].dtype == np.float32 and _rel(port[k], ref[k]) < 1e-6, k
    sampled = tm.PoseErrorMeter(tdb, error_type="ADD-S", sample_n_points=50)
    jsampled = jm.PoseErrorMeter(jdb, error_type="ADD-S", sample_n_points=50)
    assert _rel(sampled.compute_errors_batch(T1, T2, labels)["norm_avg"],
                jsampled.compute_errors_batch(T1, T2, labels)["norm_avg"]) < 1e-6


def test_adds_chunked_equals_unchunked():
    rng = np.random.RandomState(6)
    B, P = 7, 300
    T1, T2 = (torch.as_tensor(random_poses(rng, B, z=0.7)) for _ in range(2))
    pts = torch.as_tensor(rng.uniform(-0.05, 0.05, (B, P, 3)).astype(np.float32))
    valid = torch.as_tensor(rng.rand(B, P) < 0.9)
    whole = tm.adds_errors(T1, T2, pts, valid)
    for chunk in (1, 3):
        parts = tm.adds_errors(T1, T2, pts, valid, chunk_bytes=chunk * P * P * 3 * 4)
        for k in whole:
            assert torch.equal(parts[k], whole[k]), (chunk, k)
    ref = jm._adds_errors_kernel(*(jnp.asarray(x.numpy()) for x in (T1, T2, pts, valid)))
    assert _rel(whole["norm_avg"], ref["norm_avg"]) < 1e-6


# ---------------------------------------------------------------------------
# DetectionMeter, CSV
# ---------------------------------------------------------------------------


def detection_case(seed, H=24, W=32):
    rng = np.random.RandomState(seed)
    gt, gt_b, pred, pred_b = [], [], [], []
    for view in range(3):
        for li in range(2):
            for _ in range(rng.randint(1, 3)):
                x, y = rng.randint(0, W - 10), rng.randint(0, H - 10)
                box = np.array([x, y, x + rng.randint(4, 10), y + rng.randint(4, 10)], np.float32)
                gt.append((1, view, f"l{li}", float(np.round(rng.rand(), 1))))
                gt_b.append(box)
                for _ in range(rng.randint(0, 3)):
                    pred.append((1, view, f"l{li}", float(np.round(rng.rand(), 1))))
                    pred_b.append(box + rng.randint(-2, 3, 4))
    masks = lambda boxes: np.stack([(np.arange(H)[:, None] >= b[1]) & (np.arange(H)[:, None] < b[3])  # noqa: E731
                                    & (np.arange(W) >= b[0]) & (np.arange(W) < b[2]) for b in boxes])
    cols = lambda rows, names: {n: np.asarray(v) for n, v in zip(names, zip(*rows))}  # noqa: E731
    return (cols(pred, KEYS + ["score"]), np.stack(pred_b), masks(pred_b),
            cols(gt, KEYS + ["visib_fract"]), np.stack(gt_b), masks(gt_b))


@pytest.mark.parametrize("match_by", ["bbox", "mask"])
def test_detection_meter_matches_jax(match_by):
    pred, pb, pmask, gt, gb, gmask = detection_case(0)
    jp = PandasTensorCollection(pd.DataFrame(pred), bboxes=jnp.asarray(pb))
    jg = PandasTensorCollection(pd.DataFrame(gt), bboxes=jnp.asarray(gb))
    jp.register_tensor("masks", jnp.asarray(pmask))
    jg.register_tensor("masks", jnp.asarray(gmask))
    tp = TensorCollection(pred, bboxes=torch.as_tensor(pb), masks=torch.as_tensor(pmask))
    tg = TensorCollection(gt, bboxes=torch.as_tensor(gb), masks=torch.as_tensor(gmask))
    for visib in (-1, 0.5):
        jmeter = jm.DetectionMeter(match_by=match_by, visib_gt_min=visib)
        tmeter = tm.DetectionMeter(match_by=match_by, visib_gt_min=visib)
        jmeter.add(jp, jg)
        tmeter.add(tp, tg)
        (ref, rdfs), (port, pdfs) = jmeter.summary(), tmeter.summary()
        assert list(ref) == list(port) and ref["recall"] > 0
        for k, v in ref.items():
            assert abs(port[k] - v) <= 1e-9, (k, port[k], v)
        assert np.array_equal(pdfs["preds"]["matched"], rdfs["preds"]["matched"].values)
        assert np.array_equal(pdfs["preds"]["match_iou"], rdfs["preds"]["match_iou"].values)
        assert pdfs["ap_per_label"].keys() == rdfs["ap_per_label"].keys()


def test_bop_csv_round_trip_is_byte_equal(tmp_path):
    rng = np.random.RandomState(0)
    poses = random_poses(rng, 5, z=0.8)
    rows = dict(scene_id=np.array([3, 3, 4, 4, 4]), view_id=np.array([7, 8, 1, 1, 2]),
                label=np.array(["obj_000002", "obj_000001", "obj_000013", "obj_000002",
                                "obj_000005"]),
                score=np.array([0.5, 0.25, 0.1, 1 / 3, 0.9], np.float32))
    for extra in ({}, dict(time=np.array([0.5, 1.0, 0.25, 2.0, 3.0]))):
        infos = dict(rows, **extra)
        jexport.predictions_to_bop_csv(PandasTensorCollection(pd.DataFrame(infos),
                                                              poses=jnp.asarray(poses)),
                                       tmp_path / "jax.csv")
        texport.predictions_to_bop_csv(TensorCollection(infos, poses=torch.as_tensor(poses)),
                                       tmp_path / "port.csv")
        text = (tmp_path / "port.csv").read_bytes()
        assert text == (tmp_path / "jax.csv").read_bytes()
    j_df, j_poses = jexport.csv_to_candidates(tmp_path / "jax.csv")
    infos, t_poses = texport.csv_to_candidates(tmp_path / "port.csv")
    for k in ("scene_id", "view_id", "label", "score"):
        assert infos[k].tolist() == j_df[k].tolist()
    assert t_poses.dtype == np.float32 and np.array_equal(t_poses, j_poses)
    np.testing.assert_allclose(t_poses, poses, atol=1e-6)
