"""End-to-end accuracy of a trained refiner on recorded procedural frames
(port of cosypose_tpu/scripts/run_procedural_accuracy.py).

  python -m cosypose_tpu_torch.scripts.run_procedural_accuracy \\
      --run-id procedural-refiner [--config NAME] [--dataset NAME] [--n-frames 150] \\
      [--n-iterations 4] [--init gt+noise|box] [--render-lod N] [--out PATH] \\
      [--save-overlays DIR] [--n-overlays 4] [--exp-dir DIR] [--ds-root DIR] [--device cpu]

Loads the run's latest checkpoint, refines the held-out frames' objects from
the config's input distribution (noisy GT, or the GT-box z-up auto-depth
init), and reports the known-correspondence per-pair errors (ADD mean /
median / p90, rotation and xy / z translation) at init and after each
iteration, with the reference protocol's matched-AUC ADD(-S) summary beside
them. Writes a JSON to --out (default <results>/procedural-accuracy-<run>.json)
and, with --save-overlays, one PNG a pair for the first --n-overlays pairs:
input | init | refined, each pose rendered over the frame (two render calls a
pair) and zoomed around the object's GT projection.
The gt+noise draws come from a torch.Generator seeded by --noise-seed, so
they differ from the JAX package's for the same seed.
"""

from __future__ import annotations

import argparse
import json
import logging
import pathlib

import numpy as np
import torch

from .. import config
from ..data.datasets_cfg import make_object_dataset, make_scene_dataset
from ..evaluation.eval_bundle import collect_gt, initial_poses, per_pair_errors
from ..evaluation.meters import PoseErrorMeter
from ..integrated.pose_predictor import CoarseRefinePosePredictor, LoadedPoseModel
from ..models.pose_predictor import PosePredictor
from ..ops.camera import project_points
from ..ops.mesh_db import build_mesh_db
from ..training.checkpoint import latest_checkpoint, load_checkpoint
from ..training.configs import make_cfg
from ..utils import png
from ..utils.tensor_collection import TensorCollection
from ..visualization.singleview import render_prediction_overlay

logger = logging.getLogger(__name__)


def evaluate(mesh_db, infos, poses, gt_infos, gt_poses, error_type="ADD(-S)") -> dict:
    """The matched-AUC summary of one prediction set against the GT."""
    meter = PoseErrorMeter(mesh_db, error_type=error_type, report_error_AUC=True,
                           report_error_stats=True)
    meter.add(TensorCollection(dict(infos), poses=torch.as_tensor(poses)),
              TensorCollection(dict(gt_infos), poses=torch.as_tensor(gt_poses)))
    return meter.summary()[0]


def save_overlays(out_dir: pathlib.Path, n_overlays: int, mesh_db, images, K, gt_infos,
                  TCO_init, refined, TCO_gt) -> list[pathlib.Path]:
    """refinement_NN.png for the first n_overlays pairs: the frame, the init
    pose and the refined pose over it, cropped to a square around the GT
    projection (2x its extent, at least 16 px) and enlarged to ~160 px, so
    the pose change is legible; the paths written."""
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = []
    for n in range(min(n_overlays, len(gt_infos["label"]))):
        im_id, label = int(gt_infos["batch_im_id"][n]), str(gt_infos["label"][n])
        rgb = (np.moveaxis(images[im_id], 0, -1) * 255).astype(np.uint8)
        panels = [rgb] + [render_prediction_overlay(mesh_db, rgb, poses[n], K[im_id], label)
                          for poses in (TCO_init, refined)]
        pts = mesh_db.points[mesh_db.label_to_id[label]].cpu()[None]
        uv = project_points(pts, torch.as_tensor(np.asarray(K[im_id], np.float32))[None],
                            torch.as_tensor(np.asarray(TCO_gt[n], np.float32))[None])[0].numpy()
        H, W = rgb.shape[:2]
        cx, cy = float(uv[:, 0].mean()), float(uv[:, 1].mean())
        half = 2.0 * max(np.ptp(uv[:, 0]), np.ptp(uv[:, 1]), 16.0) / 2
        x0 = int(np.clip(cx - half, 0, W - 1))
        x1 = int(np.clip(cx + half, x0 + 8, W))
        y0 = int(np.clip(cy - half, 0, H - 1))
        y1 = int(np.clip(cy + half, y0 + 8, H))
        up = max(1, int(round(160 / max(y1 - y0, 1))))
        zoom = [np.kron(p[y0:y1, x0:x1], np.ones((up, up, 1), np.uint8)) for p in panels]
        paths.append(out_dir / f"refinement_{n:02d}.png")
        png.imwrite(paths[-1], np.concatenate(zoom, axis=1).astype(np.uint8))
    logger.info(f"wrote {len(paths)} overlay panels (input|init|refined) to {out_dir}")
    return paths


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--run-id", default="procedural-refiner")
    parser.add_argument("--config", default=None, help="training config name (default: --run-id)")
    parser.add_argument("--dataset", default=None)
    parser.add_argument("--n-frames", type=int, default=150)
    parser.add_argument("--n-iterations", type=int, default=4)
    parser.add_argument("--noise-seed", type=int, default=0)
    parser.add_argument("--init", default=None, choices=("gt+noise", "box"),
                        help="initial poses: noisy GT (refiner protocol) or the GT-box z-up "
                             "auto-depth init; default: the config's input generator")
    parser.add_argument("--render-lod", type=int, default=None,
                        help="decimate the render geometry to <= this many faces "
                             "(the ADD points keep full fidelity)")
    parser.add_argument("--out", default=None)
    parser.add_argument("--save-overlays", default=None, metavar="DIR",
                        help="write input|init|refined overlay panels for the first "
                             "--n-overlays pairs")
    parser.add_argument("--n-overlays", type=int, default=4)
    parser.add_argument("--exp-dir", default=None, help="runs directory (default config.EXP_DIR)")
    parser.add_argument("--ds-root", default=None, help="data root (default config.LOCAL_DATA_DIR)")
    parser.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    args = parser.parse_args(argv)

    cfg = make_cfg(args.config or args.run_id)
    mesh_db = build_mesh_db(make_object_dataset(cfg.object_ds_name).mesh_specs(),
                            render_max_faces=args.render_lod, device=args.device)
    exp_dir = pathlib.Path(args.exp_dir or config.EXP_DIR)
    ckpt = latest_checkpoint(exp_dir / args.run_id)
    if ckpt is None:
        raise FileNotFoundError(f"no checkpoint under {exp_dir / args.run_id}")
    pp = PosePredictor(cfg.train.predictor, device=args.device)
    pp.net.load_state_dict(load_checkpoint(ckpt)["net"])
    model = LoadedPoseModel(pp, mesh_db, device=args.device)
    predictor = CoarseRefinePosePredictor(refiner_model=model, device=args.device)

    dataset = args.dataset or (cfg.val_ds_names[0][0] if cfg.val_ds_names
                               else "synthetic.procedural-4k.val")
    ds = make_scene_dataset(dataset, ds_root=args.ds_root)
    images, K, gt_infos, TCO_gt, gt_boxes = collect_gt(ds, args.n_frames,
                                                       resize=tuple(cfg.input_resize) or None)
    labels = gt_infos["label"]
    logger.info(f"{len(labels)} GT objects over {images.shape[0]} frames")

    init = args.init or ("box" if cfg.train.input_generator.startswith("fixed") else "gt+noise")
    TCO_init = initial_poses(init, mesh_db, labels, TCO_gt, gt_boxes, K[gt_infos["batch_im_id"]],
                             args.noise_seed, cfg.train.noise_euler_deg, cfg.train.noise_trans,
                             n_points=2000)
    obj_data = TensorCollection(gt_infos, poses=torch.as_tensor(TCO_init, device=args.device))
    preds = predictor.batched_model_predictions(model, images, K, obj_data,
                                                n_iterations=args.n_iterations)

    # primary: the known-correspondence errors at init and after each iteration
    per_pair = {"init": per_pair_errors(mesh_db, labels, TCO_init, TCO_gt)}
    for n in range(1, args.n_iterations + 1):
        per_pair[f"iteration={n}"] = per_pair_errors(
            mesh_db, labels, preds[f"iteration={n}"].poses.cpu().numpy(), TCO_gt)
    for name, e in per_pair.items():
        logger.info(f"{name:12s}: ADD mean={e['ADD_mean'] * 1000:7.2f}mm "
                    f"median={e['ADD_median'] * 1000:7.2f}mm p90={e['ADD_p90'] * 1000:7.2f}mm "
                    f"rot={e['rot_deg_median']:5.2f}deg dxy={e['dxy_mean'] * 1000:6.2f}mm "
                    f"dz={e['dz_mean'] * 1000:6.2f}mm <0.1d={e['frac_ADD_lt_0p1d']:.3f}")

    # secondary: the reference protocol's matched-AUC summary
    refined = preds[f"iteration={args.n_iterations}"].poses.cpu().numpy()
    overlays = (save_overlays(pathlib.Path(args.save_overlays), args.n_overlays, mesh_db, images,
                              K, gt_infos, TCO_init, refined, TCO_gt)
                if args.save_overlays else [])
    results = {}
    for name, poses in (("init", TCO_init), ("refined", refined)):
        s = evaluate(mesh_db, gt_infos, poses, gt_infos, TCO_gt)
        results[name] = {k: float(v) for k, v in s.items()
                         if isinstance(v, (int, float, np.floating))}

    out = pathlib.Path(args.out or config.RESULTS_DIR / f"procedural-accuracy-{args.run_id}.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(dict(run_id=args.run_id, dataset=dataset,
                                   n_frames=int(images.shape[0]), n_objects=len(labels),
                                   n_iterations=args.n_iterations, per_pair=per_pair,
                                   matched_auc=results), indent=2))
    logger.info(f"wrote {out}")
    return dict(per_pair=per_pair, matched_auc=results, predictions=preds, TCO_init=TCO_init,
                overlays=overlays)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
