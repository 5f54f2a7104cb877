"""Largest differences between the port and the JAX package on the CPU parity
cases of tests/test_torch_port_rasterizer.py, tests/test_torch_port_slice.py
and tests/test_torch_port_training.py.

    python -m tests.torch_port_parity_maxima     # from the repo root

Prints one JSON object: for each case and output, the max abs difference, and
for masks and attributes the count of pixels that differ; for the train steps
the differences relative to each tensor's max (or rtol), port vs JAX, port vs
the float64 step and JAX vs the float64 step. The tests hold these to their
tolerances; this script reports how far inside them the port lies.
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


if __name__ == "__main__":
    main()
