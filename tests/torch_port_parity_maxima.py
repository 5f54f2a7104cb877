"""Largest differences between the port and the JAX package on the CPU parity
cases of tests/test_torch_port_rasterizer.py, tests/test_torch_port_slice.py,
tests/test_torch_port_training.py, tests/test_torch_port_recording.py,
tests/test_torch_port_data.py and the evaluation tests
(tests/test_torch_port_eval.py, test_torch_port_bop_metrics.py,
test_torch_port_eval_pipeline.py), and the detection path
(tests/test_torch_port_backbones.py, test_torch_port_detector.py,
test_torch_port_detector_training.py).

    python -m tests.torch_port_parity_maxima     # from the repo root

Prints one JSON object: for each case and output, the max abs difference, and
for masks and attributes the count of pixels that differ; for the train steps
the differences relative to each tensor's max (or rtol), port vs JAX, port vs
the float64 step and JAX vs the float64 step; for recording, the scene
renders, sampled frames and recorded GT; for the data layer, the PNG codec
and the Pillow operations against PIL and the decode time of a 240x320 RGB
frame on this host (the port's file and Pillow's); for evaluation, the
symmetric distances and the meters' errors relative to their largest value,
the meters' summaries, VSD's rendered depth and matrices, the BOP19 AR and the
poses and metrics of the evaluation pipeline; for the detection path, the
backbones' features and every pooling's pose outputs, the detector's head
outputs and decoded scores and boxes, one detector train step (loss terms
relative, gradients relative to each tensor's max), and the two documented
rasterizer divergences (ROADMAP §3); for ICP (tests/test_torch_port_icp.py)
the refined poses and the sample ids that differ; for multiview
(tests/test_torch_port_multiview.py) the camera hypotheses, scores and TC1C2,
the LM's losses, poses and iteration counts (JAX's, the port's) from one
initialization, and the multiview predictor's poses. The tests hold these to
their tolerances; this script reports how far inside them the port lies.
"""

import json

import jax
import numpy as np

jax.config.update("jax_platforms", "cpu")

from tests import test_torch_port_rasterizer as R  # noqa: E402
from tests import test_torch_port_slice as S  # noqa: E402
from tests import test_torch_port_training as T  # noqa: E402


def _err(port, ref) -> float:
    return float(np.abs(port.numpy() - np.asarray(ref)).max())


def _raster(port, ref) -> dict:
    out = {"rgb": _err(port.rgb, ref.rgb), "depth": _err(port.depth, ref.depth),
           "mask_px_differ": int((port.mask.numpy() != np.asarray(ref.mask)).sum())}
    if ref.attr is not None:
        out["attr_px_differ"] = int((port.attr.numpy() != np.asarray(ref.attr)).sum())
    return out


def main():
    res = {}
    for name, make in R.CASES.items():
        c = make()
        for tile in [(16, 16), (8, 32)]:
            res[f"raster/binned/{name}/tile{tile[0]}x{tile[1]}"] = _raster(*R.run_binned(c, tile))
        res[f"raster/plain/{name}"] = _raster(*R.run_plain(c))

    weights = S.make_weights()
    port, ref, _ = S.run_forward(weights)
    res["slice/forward"] = {k: _err(port[k], ref[k]) for k in (*S.KEYS, "TCO_final")}
    for init in ("v0", "z-up+auto-depth"):
        port_final, port, ref_final, ref = S.run_coarse_refine(weights, init)
        res[f"slice/coarse_refine/{init}"] = {
            t: max(_err(port[k].tensors[t], ref[k].tensors[t]) for k in ref)
            for t in ("poses", "poses_input", "K_crop", "boxes_rend", "boxes_crop")}
    res.update(training())
    res.update(recording_and_data())
    res.update(evaluation())
    res.update(detection())
    res.update(icp_and_multiview())
    print(json.dumps(res, indent=1))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def training() -> dict:
    import torch

    res = {}
    for pose_dim in (9, 7):
        gt, TCO_in, out, K, pts, valid = T.loss_inputs(pose_dim)
        ref = T.jl.loss_refiner_CO_disentangled(T._j(gt), T._j(TCO_in), T._j(out), T._j(K),
                                                T._j(pts), pose_dim=pose_dim)
        port = T.tl.loss_refiner_CO_disentangled(T._t(gt), T._t(TCO_in), T._t(out), T._t(K),
                                                 T._t(pts), pose_dim=pose_dim)
        aux_r = T.jl.loss_refiner_aux_regression(T._j(gt[:, 0]), T._j(TCO_in), T._j(out),
                                                 T._j(K), pose_dim=pose_dim)
        aux_p = T.tl.loss_refiner_aux_regression(T._t(gt[:, 0]), T._t(TCO_in), T._t(out),
                                                 T._t(K), pose_dim=pose_dim)
        res[f"train/losses/pose_dim{pose_dim}"] = {"disentangled": _err(port, ref),
                                                    "aux_regression": _err(aux_p, aux_r)}
    gt, _, _, _, pts, _ = T.loss_inputs(9, seed=3)
    pred = T.random_poses(np.random.RandomState(4), 4)
    res["train/losses/ADD_ADDS"] = {
        "symmetric": _err(T.tl.loss_CO_symmetric(T._t(gt), T._t(pred), T._t(pts)),
                          T.jl.loss_CO_symmetric(T._j(gt), T._j(pred), T._j(pts))),
        "ADD_L1": _err(T.tl.compute_ADD_L1_loss(T._t(gt[:, 0]), T._t(pred), T._t(pts)),
                       T.jl.compute_ADD_L1_loss(T._j(gt[:, 0]), T._j(pred), T._j(pts))),
        "ADDS": _err(T.tl.compute_ADDS_loss(T._t(gt[:, 0]), T._t(pred), T._t(pts)),
                     T.jl.compute_ADDS_loss(T._j(gt[:, 0]), T._j(pred), T._j(pts)))}
    T_np = T.random_poses(np.random.RandomState(1), 5)
    key = jax.random.PRNGKey(3)
    res["train/pose_noise"] = _err(T.ttr.apply_pose_noise(T._t(T_np), *T.jax_pose_noise(key, 5)),
                                   T.jtr.add_pose_noise(key, T._j(T_np)))
    images = np.random.RandomState(5).uniform(size=(6, 3, 40, 56)).astype(np.float32)
    for p in (0.4, 1.0):
        draws = T.jax_jitter_draws(jax.random.PRNGKey(11), 6)
        ref = np.asarray(T.jaug.color_jitter(jax.random.PRNGKey(11), T._j(images), p=p))
        port = T.taug.apply_color_jitter(T._t(images), draws, p=p).numpy()
        exact = T.taug.apply_color_jitter(
            T._t(images).double(), {k: (f.double(), c) for k, (f, c) in draws.items()},
            p=p).numpy()
        res[f"train/color_jitter/p{p}"] = {"port_vs_jax": float(np.abs(port - ref).max()),
                                           "port_vs_float64": float(np.abs(port - exact).max()),
                                           "jax_vs_float64": float(np.abs(ref - exact).max())}

    steps, cfg = T.run_train_steps()
    for i, (port, ref, before) in enumerate(steps):
        exact, exact_stats, exact_metrics = T.float64_step(cfg, before)
        g_port = T.unclipped(port, cfg.clip_grad_norm)
        clip = ref["metrics"]["grad_norm"] / cfg.clip_grad_norm
        g_jax = {n: g * max(clip, 1.0) for n, g in T.jax_clipped_grads(ref, before).items()}
        live = [n for n in g_port if not T.structurally_zero(n)]
        sd = T.as_port_names(ref["variables"]["params"], ref["variables"]["batch_stats"])
        stats = [n for n in exact_stats]

        def stats_max(a, b, var):
            return max(T.stats_error(a[n], b[n], n, var[n.replace("running_mean", "running_var")])
                       for n in stats)

        port_stats = {n: port["state_dict"][n] for n in stats}
        jax_stats = {n: sd[n] for n in stats}
        res[f"train/step{i + 1}"] = {
            "metrics_rtol": {"port_vs_jax": max(abs(port["metrics"][k] / v - 1)
                                                for k, v in ref["metrics"].items()),
                             "port_vs_float64": max(abs(port["metrics"][k] / v - 1)
                                                    for k, v in exact_metrics.items()),
                             "jax_vs_float64": max(abs(ref["metrics"][k] / v - 1)
                                                   for k, v in exact_metrics.items())},
            "grads_of_max": {"port_vs_jax": max(_rel(g_port[n], g_jax[n]) for n in live),
                             "port_vs_float64": max(_rel(g_port[n], exact[n]) for n in live),
                             "jax_vs_float64": max(_rel(g_jax[n], exact[n]) for n in live)},
            "running_stats_of_scale": {"port_vs_jax": stats_max(port_stats, jax_stats, jax_stats),
                                       "port_vs_float64": stats_max(port_stats, exact_stats,
                                                                    exact_stats),
                                       "jax_vs_float64": stats_max(jax_stats, exact_stats,
                                                                   exact_stats)},
            "params_max_abs": max(float((port["state_dict"][n] - torch.as_tensor(
                np.asarray(sd[n]))).abs().max()) for n in g_port),
            "params_over_1e-6": int(sum(int(((port["state_dict"][n] - torch.as_tensor(
                np.asarray(sd[n]))).abs() > 1e-6).sum()) for n in g_port)),
            "n_params": int(sum(g.numel() for g in g_port.values()))}
    return res


def recording_and_data() -> dict:
    import io
    import tempfile
    import time
    import zlib

    from PIL import Image, ImageFilter

    from cosypose_tpu.recording import record_dataset as j_record
    from cosypose_tpu.rendering import SceneRenderer as JSceneRenderer
    from cosypose_tpu_torch.data import pillow_ops
    from cosypose_tpu_torch.recording import record_dataset as t_record
    from cosypose_tpu_torch.rendering import SceneRenderer
    from cosypose_tpu_torch.utils import png
    from tests import test_torch_port_data as D
    from tests import test_torch_port_recording as REC

    res = {}
    dbs = (REC.j_build_mesh_db(REC.cube_specs()),
           REC.build_mesh_db(REC.port_specs(REC.cube_specs()), device="cpu"))
    js, ts = REC.samplers(dbs, n_objects_interval=(4, 5))
    scene, cams = REC._scene(ts)
    ref = JSceneRenderer(dbs[0]).render_scene(scene, cams, render_depth=True)
    out = SceneRenderer(dbs[1]).render_scene(scene, cams, render_depth=True)
    res["recording/scene_render"] = {
        "rgb_in_255ths": max(float(np.abs(r["rgb"] - o["rgb"]).max() * 255) for r, o in zip(ref, out)),
        "rgb_px_differ": sum(int((r["rgb"] != o["rgb"]).any(-1).sum()) for r, o in zip(ref, out)),
        "depth_m": max(float(np.abs(r["depth"] - o["depth"]).max()) for r, o in zip(ref, out)),
        "ids_px_differ": sum(int((r["instance_ids"] != o["instance_ids"]).sum())
                             for r, o in zip(ref, out))}
    js, ts = REC.samplers(dbs)
    jf, tf = js.sample_scene_frames(7, 3), ts.sample_scene_frames(7, 3)
    res["recording/sample_scene_frames"] = {
        "rgb_max": max(int(np.abs(a[0].astype(int) - b[0]).max()) for a, b in zip(jf, tf)),
        "ids_px_differ": sum(int((a[1] != b[1]).sum()) for a, b in zip(jf, tf)),
        "depth_m": max(float(np.abs(a[2]["camera"]["depth"] - b[2]["camera"]["depth"]).max())
                       for a, b in zip(jf, tf)),
        "visib_fract": max(abs(x["visib_fract"] - y["visib_fract"])
                           for a, b in zip(jf, tf) for x, y in zip(a[2]["objects"], b[2]["objects"]))}
    with tempfile.TemporaryDirectory() as tmp:
        js, ts = REC.samplers(dbs)
        jdir = j_record(js, f"{tmp}/jax", n_chunks=2, n_frames_per_chunk=4)
        tdir = t_record(ts, f"{tmp}/port", n_chunks=2, n_frames_per_chunk=4)
        gt = 0.0
        for chunk in ("000000", "000001"):
            for name in ("scene_camera.json", "scene_gt.json", "scene_gt_info.json"):
                a = json.loads((jdir / "train_synt" / chunk / name).read_text())
                b = json.loads((tdir / "train_synt" / chunk / name).read_text())
                flat = [np.ravel(np.asarray(x[k], np.float64)) - np.ravel(np.asarray(y[k]))
                        for va, vb in zip(a.values(), b.values())
                        for x, y in zip(va if isinstance(va, list) else [va],
                                        vb if isinstance(vb, list) else [vb]) for k in x]
                gt = max(gt, max(float(np.abs(f).max()) for f in flat))
        res["recording/record_dataset"] = {"gt_json_max_abs_mm": gt}

    def decode_ms(data, reps=5):
        t0 = time.perf_counter()
        for _ in range(reps):
            png.decode(data)
        return 1e3 * (time.perf_counter() - t0) / reps

    # a 240x320 RGB frame: noise over a gradient, and uniform noise (on which
    # Pillow's adaptive filtering picks more Average and Paeth rows)
    images = {"gradient": D._image(240, 320, 3, seed=0),
              "noise": np.random.RandomState(0).randint(0, 256, (240, 320, 3)).astype(np.uint8)}
    for name, im in images.items():
        buf = io.BytesIO()
        Image.fromarray(im).save(buf, format="PNG")
        pil_bytes, port_bytes = buf.getvalue(), png.encode(im)
        filters = np.frombuffer(zlib.decompress(b"".join(
            d for k, d in png._chunks(pil_bytes) if k == b"IDAT")), np.uint8).reshape(240, -1)[:, 0]
        res[f"data/png/{name}"] = {
            "pillow_file_px_differ": int((png.decode(pil_bytes) != im).sum()),
            "port_file_px_differ_in_pil": int(
                (np.asarray(Image.open(io.BytesIO(port_bytes))) != im).sum()),
            "pillow_rows_by_filter": np.bincount(filters, minlength=5).tolist(),
            "decode_ms_port_file_this_host": decode_ms(port_bytes),
            "decode_ms_pillow_file_this_host": decode_ms(pil_bytes),
            "bytes_port_file": len(port_bytes), "bytes_pillow_file": len(pil_bytes)}
    rgb = images["gradient"]
    differ = {}
    for src, dst in D.RESIZES:
        im = D._image(*src, 3, seed=src[0])
        ref = np.asarray(Image.fromarray(im).resize(dst[::-1], Image.BILINEAR))
        differ["resize_bilinear"] = differ.get("resize_bilinear", 0) + int(
            (pillow_ops.resize_bilinear(im, dst) != ref).sum())
    for r in (0.5, 1.0, 1.37, 2.0, 2.99):
        ref = np.asarray(Image.fromarray(rgb).filter(ImageFilter.GaussianBlur(radius=r)))
        differ["gaussian_blur"] = differ.get("gaussian_blur", 0) + int(
            (pillow_ops.gaussian_blur(rgb, r) != ref).sum())
    for name, (ours, theirs) in D.ENHANCERS.items():
        differ[name] = sum(int((ours(rgb, f) != np.asarray(theirs(Image.fromarray(rgb)).enhance(f)))
                               .sum()) for f in (0.0, 0.37, 1.0, 2.5, 19.9, 49.9))
    res["data/pillow_ops_values_differ"] = differ
    return res


def evaluation() -> dict:
    import dataclasses
    import tempfile
    import types
    from pathlib import Path

    import jax.numpy as jnp
    import torch

    from cosypose_tpu.evaluation import bop_metrics as jb
    from cosypose_tpu.evaluation import eval_bundle as jbundle
    from cosypose_tpu.evaluation import meters as jm
    from cosypose_tpu.ops import symmetric as jsym
    from cosypose_tpu.ops import transforms as jtransforms
    from cosypose_tpu.rendering.scene_renderer import BatchRenderer as JBatchRenderer
    from cosypose_tpu.utils.tensor_collection import PandasTensorCollection
    from cosypose_tpu_torch.data.bop import BOPDataset
    from cosypose_tpu_torch.evaluation import bop_metrics as tb
    from cosypose_tpu_torch.evaluation import eval_bundle as tbundle
    from cosypose_tpu_torch.evaluation import meters as tm
    from cosypose_tpu_torch.ops import symmetric as tsym
    from cosypose_tpu_torch.ops.mesh_db import MeshSpec, build_mesh_db
    from cosypose_tpu_torch.rendering.scene_renderer import BatchRenderer
    from cosypose_tpu_torch.training import pose_training as tpt
    from cosypose_tpu_torch.utils.tensor_collection import TensorCollection
    from cosypose_tpu_torch.utils.weights import load_jax_train_state
    from tests import test_torch_port_bop_metrics as BM
    from tests import test_torch_port_eval as E
    from tests import test_torch_port_eval_pipeline as P

    res = {}
    rng = np.random.RandomState(0)
    B, Pn, S = 5, 60, 4
    T1, T2 = E.random_poses(rng, B, z=0.6), E.random_poses(rng, B, z=0.6)
    pts = rng.uniform(-0.05, 0.05, (B, Pn, 3)).astype(np.float32)
    syms = np.tile(np.concatenate([np.eye(4, dtype=np.float32)[None],
                                   E.random_poses(rng, S - 1, 0.0)])[None], (B, 1, 1, 1))
    sym_valid = np.ones((B, S), bool)
    j, t = (lambda *a: [jnp.asarray(x) for x in a]), (lambda *a: [torch.as_tensor(x) for x in a])
    res["eval/symmetric_rel"] = {
        "mesh_points_dist": E._rel(tsym.mesh_points_dist(*t(T1, T2, pts)),
                                   jsym.mesh_points_dist(*j(T1, T2, pts))),
        "chamfer_dist": E._rel(tsym.chamfer_dist(*t(T1, T2, pts)), jsym.chamfer_dist(*j(T1, T2, pts))),
        "symmetric_distance_batched_fast": E._rel(
            tsym.symmetric_distance_batched_fast(*t(T1, T2, pts, syms, sym_valid))[0],
            jsym.symmetric_distance_batched_fast(*j(T1, T2, pts, syms, sym_valid))[0])}

    specs = E.meter_specs()
    dbs = (E.j_build_mesh_db([E.JMeshSpec(**s) for s in specs], keep_geometry=False),
           build_mesh_db([MeshSpec(**s) for s in specs], device="cpu"))
    rng = np.random.RandomState(4)
    T1, T2 = E.random_poses(rng, 9, z=0.7), E.random_poses(rng, 9, z=0.7)
    labels = np.asarray([f"obj_{i % 3 + 1:06d}" for i in range(9)])
    errs = {}
    for et in ("ADD", "ADD-S", "ADD(-S)"):
        ref = jm.PoseErrorMeter(dbs[0], error_type=et).compute_errors_batch(T1, T2, labels)
        port = tm.PoseErrorMeter(dbs[1], error_type=et).compute_errors_batch(T1, T2, labels)
        errs[et] = max(E._rel(port[k], ref[k]) for k in ref)
    res["eval/meter_errors_rel"] = errs
    summ = {}
    for case in E.METER_CASES:
        (ref, _), (port, _) = E.run_meters(dbs, case, seed=3)
        summ[case] = max(0.0 if (np.isnan(v) and np.isnan(port[k])) else abs(port[k] - v)
                         for k, v in ref.items())
    res["eval/meter_summaries_max_abs"] = summ

    jdb, tdb = (BM.j_build_mesh_db(BM.cube_specs()),
                build_mesh_db([MeshSpec(**dataclasses.asdict(s)) for s in BM.cube_specs()],
                              device="cpu"))
    res_ = (48, 64)
    K = np.array([[60.0, 0, 32], [0, 60.0, 24], [0, 0, 1]], np.float32)
    rng = np.random.RandomState(2)
    gts = [BM.random_pose(rng, z=1.0, t_scale=0.1).astype(np.float32) for _ in range(2)]
    ests = [g.copy() for g in gts] + [gts[0] @ BM._pose(BM._rotz(0.3)).astype(np.float32)]
    ests[1][2, 3] += 0.05
    jr, tr = JBatchRenderer(jdb, resolution=res_), BatchRenderer(tdb, resolution=res_)
    lids, poses, Ks = tb.vsd_render_inputs(1, ests, gts, K)
    ref = np.asarray(jr.render(jnp.asarray(lids), jnp.asarray(poses), jnp.asarray(Ks),
                               resolution=res_, render_depth=True).depth)
    port = tr.render(lids, poses, Ks, resolution=res_, render_depth=True).depth.numpy()
    d_scene = np.where(ref[3] > 0, ref[3], np.where(ref[4] > 0, ref[4], 0)).astype(np.float32)
    res["eval/vsd"] = {
        "depth_max_abs_m": float(np.abs(port - ref).max()),
        "mask_px_differ": int(((port > 0) != (ref > 0)).sum()),
        "matrix_max_abs": float(np.abs(tb._vsd_matrix(tr, 1, ests, gts, K, d_scene, 0.26)
                                       - jb._vsd_matrix(jr, 1, ests, gts, K, d_scene, 0.26)).max())}

    with tempfile.TemporaryDirectory() as tmp:
        root = BM.build_bop_fixture(Path(tmp))
        tdb_f = build_mesh_db(BM.BOPObjectDataset(root / "models").mesh_specs(), device="cpu")
        jdb_f = BM.j_build_mesh_db(BM.JBOPObjectDataset(root / "models").mesh_specs())
        BM.write_fixture_depth(root, tdb_f)
        df, poses = BM.fixture_predictions()
        ref = jb.compute_bop19_ar(PandasTensorCollection(df, poses=jnp.asarray(poses)),
                                  BM.JBOPDataset(root, split="test", load_depth=True), jdb_f,
                                  renderer=JBatchRenderer(jdb_f))
        port = tb.compute_bop19_ar(TensorCollection({k: df[k].values for k in df.columns},
                                                    poses=torch.as_tensor(poses)),
                                   BOPDataset(root, split="test", load_depth=True), tdb_f,
                                   renderer=BatchRenderer(tdb_f))
        res["eval/bop19_ar_abs"] = {k: abs(port[k] - ref[k])
                                    for k in ("AR", "AR_vsd", "AR_mssd", "AR_mspd")}

        # the in-training callback from the same TCO_init and weights
        jpp, v, _ = P.make_weights()
        cfg = P.bundle_cfg()
        jds, tds = P.JBOPDataset(root, split="test"), BOPDataset(root, split="test")
        for o in P.BOPObjectDataset(root / "models").objects:
            jdb_f.infos[o["label"]]["diameter_m"] = tdb_f.infos[o["label"]]["diameter_m"] = \
                o["diameter_m"]
        TCO_gt = tbundle.collect_gt(tds, 3, with_images=False)[3]
        TCO_init = P.add_pose_noise(torch.as_tensor(TCO_gt), torch.Generator().manual_seed(7),
                                    euler_deg_std=(5, 5, 5), trans_std=(0.005, 0.005, 0.01)).numpy()
        j_noise, t_noise = jtransforms.add_pose_noise, tbundle.add_pose_noise
        jtransforms.add_pose_noise = lambda key, T, **kw: jnp.asarray(TCO_init)
        tbundle.add_pose_noise = lambda T, gen, **kw: torch.as_tensor(TCO_init)
        try:
            ref = jbundle.make_eval_bundle(
                types.SimpleNamespace(train=cfg.train, input_resize=cfg.input_resize), jpp,
                jdb_f, jds, n_frames=3)(
                types.SimpleNamespace(params=v["params"], batch_stats=v["batch_stats"]), 0)
            state = tpt.create_train_state(cfg.train, "cpu")
            load_jax_train_state(state, v["params"], v["batch_stats"])
            port = tbundle.make_eval_bundle(cfg, tdb_f, tds, n_frames=3, device="cpu")(state, 0)
        finally:
            jtransforms.add_pose_noise, tbundle.add_pose_noise = j_noise, t_noise
        res["eval/bundle_metrics_abs"] = {k: abs(port[k] - ref[k]) for k in ref
                                          if k.startswith("iter=1/")}
    return res


def detection() -> dict:
    import jax.numpy as jnp
    import torch

    from cosypose_tpu.models import detector as jdet
    from cosypose_tpu.models import pose_predictor as jpp_mod
    from cosypose_tpu_torch.models import detector as tdet
    from cosypose_tpu_torch.models.pose_predictor import PosePredictor, PosePredictorConfig
    from cosypose_tpu_torch.utils.weights import jax_pose_variables_to_state_dict
    from tests import test_torch_port_backbones as BB
    from tests import test_torch_port_detector as D
    from tests import test_torch_port_detector_training as DT

    res = {}
    for name, (make_j, make_t, tree, n_ch) in BB.BACKBONES.items():
        x = np.random.RandomState(1).uniform(size=(2, *BB.SIZE, n_ch)).astype(np.float32)
        jm = make_j()
        v = BB.jax_variables(jm, x)
        port = BB.load_backbone(make_t(), tree, v).eval()
        with torch.no_grad():
            got = port(BB.nchw(x))
        ref = np.asarray(jm.apply(v, jnp.asarray(x), train=False)).transpose(0, 3, 1, 2)
        res[f"detection/backbone/{name}"] = _err(got, ref)
    for backbone, pooling, mode in BB.POSENETS:
        kw = dict(backbone=backbone, render_size=BB.SIZE, pooling=pooling, input_mode=mode)
        jpp = jpp_mod.PosePredictor(jpp_mod.PosePredictorConfig(**kw))
        v = jax.tree_util.tree_map(np.asarray, dict(jpp.init(jax.random.PRNGKey(0))))
        v = {"params": v["params"], "batch_stats": v.get("batch_stats", {})}
        rng = np.random.RandomState(4)
        BB.randomize(v["params"], rng)
        BB.randomize(v["batch_stats"], rng)
        k = v["params"]["pose_fc"]["kernel"]
        v["params"]["pose_fc"]["kernel"] = rng.normal(0.0, 0.05, k.shape).astype(np.float32)
        pp = PosePredictor(PosePredictorConfig(**kw), device="cpu")
        pp.net.load_state_dict(jax_pose_variables_to_state_dict(v))
        x = rng.uniform(size=(2, *BB.SIZE, 9 if mode.endswith("diff") else 6))
        x = x.astype(np.float32)
        with torch.no_grad():
            got = pp.net(BB.nchw(x))
        res[f"detection/posenet/{backbone}/{pooling}/{mode}"] = _err(
            got, jpp.net.apply(v, jnp.asarray(x), train=False))
    for cls_mode in ("percls", "softmax"):
        jm, v, port = D.make_pair(cls_mode)
        x = D.images()
        heads = jm.apply(v, jnp.asarray(x.transpose(0, 2, 3, 1)), train=False)
        with torch.no_grad():
            got = port(torch.as_tensor(x))
        res[f"detection/detector/{cls_mode}/heads"] = max(_err(got[k], heads[k]) for k in heads)
        ref = jdet.decode_detections(heads, 16)
        dec = tdet.decode_detections({k: torch.as_tensor(np.array(a)) for k, a in heads.items()},
                                     16)
        res[f"detection/detector/{cls_mode}/decode"] = {
            k: _err(dec[k], ref[k]) for k in ("scores", "boxes", "mask_logits")}
        _, tcfg, port_s, ref_s = DT.run_steps(cls_mode)
        factor = min(1.0, tcfg.clip_grad_norm / ref_s["metrics"]["grad_norm"])
        res[f"detection/train_step/{cls_mode}"] = {
            "metrics_rel": max(abs(port_s["metrics"][k] - val) / abs(val)
                               for k, val in ref_s["metrics"].items()),
            "grads_rel_to_max": max(
                float((g.double() - ref_s["grads"][n].double() * factor).abs().max()
                      / (ref_s["grads"][n].double() * factor).abs().max())
                for n, g in port_s["grads"].items() if not DT.structurally_zero(n))}
    return res


def icp_and_multiview() -> dict:
    import pathlib
    import shutil
    import tempfile

    import jax.numpy as jnp
    import torch

    from cosypose_tpu.integrated import icp_refiner as jicp
    from cosypose_tpu.multiview import bundle_adjustment as jba
    from cosypose_tpu.multiview import matching_cext as jm
    from cosypose_tpu.multiview import ransac as jr
    from cosypose_tpu_torch.integrated import icp_refiner as ticp
    from cosypose_tpu_torch.multiview import bundle_adjustment as tba
    from cosypose_tpu_torch.multiview import ransac as tr
    from tests import test_torch_port_icp as I
    from tests import test_torch_port_multiview as M

    res = {}
    for size in ((120, 160), (240, 320), (480, 640)):
        n = size[0] * size[1]
        ref = np.asarray(jnp.linspace(0, n - 1, 1024).astype(jnp.int32))
        res[f"icp/sample_ids_differ/{size[0]}x{size[1]}"] = int(
            (ticp.sample_ids(n, 1024) != ref).sum())
    scene = I.make_scene()
    args = (scene["TCO_bad"], scene["rendered"], scene["observed"], scene["K"])
    for n_it in (1, 3, 10):
        ref, _ = jicp._icp_refine_batch(*map(jnp.asarray, args), n_iterations=n_it)
        got, _ = ticp._icp_refine_batch(*map(torch.as_tensor, args), n_iterations=n_it)
        res[f"icp/refine_batch/it{n_it}"] = _err(got, ref)

    copy = pathlib.Path(tempfile.mkdtemp()) / jm._LIB.name  # never rebuild the shipped library
    shutil.copy(jm._LIB, copy)
    jm._LIB, jm._lib = copy, None
    for seed in M.SEEDS:
        c = M.make_scene_rich(seed=seed)
        jdb, tdb = M.make_db(), M.port_db()
        codes = np.asarray(jdb.ids_for(c.infos["label"].values), np.int32)
        seeds, tm = jm.make_ransac_infos(c.infos["view_id"].to_numpy(np.int32), codes, 20, seed)
        tc = M.port_candidates(c)
        hyp = jr.estimate_camera_poses_batch(c, seeds, jdb)
        out_j = jr.multiview_candidate_matching(c.clone(), jdb, n_ransac_iter=20, seed=seed)
        out_t = tr.multiview_candidate_matching(M.port_candidates(c), tdb, n_ransac_iter=20,
                                                seed=seed)
        res[f"multiview/ransac/seed{seed}"] = {
            "hypotheses": float(np.abs(tr.estimate_camera_poses_batch(tc, seeds, tdb)
                                       - hyp).max()),
            "scores": float(np.abs(tr.score_tmatches_batch(tc, tm, hyp, tdb)
                                   - jr.score_tmatches_batch(c, tm, hyp, jdb)).max()),
            "TC1C2": _err(out_t["pairs_TC1C2"].TC1C2, out_j["pairs_TC1C2"].TC1C2)}
    for scene_name in ("make_scene", 0, 1, 2):
        rj, rt = M._refinements(scene_name)
        TWO0, TCW0 = rj.robust_initialization(1)
        views, objs = rt._ids()
        for n in (2, 100):
            ref = jba._optimize_lm(TWO0, TCW0, rj.cand_TCO, jnp.asarray(rj.cand_view_ids),
                                   jnp.asarray(rj.cand_obj_ids), rj.K, rj.obj_points,
                                   rj.cand_syms, rj.cand_sym_valid, n_iterations=n)
            got = tba._optimize_lm(torch.as_tensor(np.array(TWO0)), torch.as_tensor(
                np.array(TCW0)), rt.cand_TCO, views, objs, rt.K, rt.obj_points, rt.cand_syms,
                rt.cand_sym_valid, n_iterations=n)
            res[f"multiview/lm/{scene_name}/max{n}"] = {
                "iterations_jax_port": [int(ref[3]), int(got[3])],
                "loss": abs(float(got[2]) - float(ref[2])),
                "poses": max(_err(got[0], ref[0]), _err(got[1], ref[1]))}
    return res


if __name__ == "__main__":
    main()
