"""BOP end-to-end inference CLI (port of cosypose_tpu/scripts/run_bop_inference.py).

  python -m cosypose_tpu_torch.scripts.run_bop_inference --dataset ycbv|procedural \\
      [--detector RUN --coarse RUN --refiner RUN] [--inference-ds NAME] [--object-ds NAME] \\
      [--n-frames N] [--nviews N] [--icp] [--detection-th 0.3] [--n-coarse 1] \\
      [--n-refiner 4] [--debug] [--ds-root DIR] [--exp-dir DIR] [--out-dir DIR] [--device cpu]

Detector → coarse (1 iteration) → refiner (4) per view group of --nviews
frames → with --nviews > 1 the multiview predictor (RANSAC + bundle
adjustment on the AABB mesh database) → with --icp depth ICP on the frames'
depth, masked by the detections' masks; the predictions written as a BOP
CSV per stage (pose, multiview, icp). With --dataset procedural the
recorded GT is on disk, so the CLI also reports the ADD(-S) meter of every
stage and the BOP19 Average Recall (VSD on the recorded depth, MSSD, MSPD)
of the final stage (icp, else multiview, else pose), into
metrics-<dataset>[-icp].json. main returns the CSV paths, the predictions,
the metrics and the runner's wall seconds of each stage. Without --coarse
the refiner starts from the detections' z-up auto-depth boxes.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import pathlib

import numpy as np
import torch

from .. import config
from ..bop_config import BOP_CONFIG, PBR_COARSE, PBR_DETECTORS, PBR_REFINER
from ..data.datasets_cfg import make_object_dataset, make_scene_dataset
from ..data.wrappers import MultiViewWrapper
from ..evaluation.bop_export import predictions_to_bop_csv
from ..evaluation.pred_runners import BopPredictionRunner
from ..integrated.detector import Detector
from ..integrated.icp_refiner import ICPRefiner
from ..integrated.multiview_predictor import MultiviewScenePredictor
from ..integrated.pose_predictor import CoarseRefinePosePredictor, LoadedPoseModel
from ..models.detector import CenterNetDetector, DetectorConfig
from ..models.mask_rcnn import MaskRCNN, MaskRCNNConfig, maskrcnn_category_ids
from ..models.pose_predictor import PosePredictor, PosePredictorConfig
from ..ops.mesh_db import build_mesh_db
from ..training.checkpoint import latest_checkpoint, load_checkpoint
from .run_detector_training import label_to_category_id

logger = logging.getLogger(__name__)

DTYPES = {str(t): t for t in (torch.float32, torch.bfloat16, torch.float16)}


def _run(run_id, exp_dir):
    run_dir = pathlib.Path(exp_dir or config.EXP_DIR) / run_id
    ckpt = latest_checkpoint(run_dir)
    if ckpt is None:
        raise FileNotFoundError(f"no checkpoint for run {run_id} under {run_dir}")
    saved = run_dir / "config.yaml"
    return load_checkpoint(ckpt)["net"], json.loads(saved.read_text()) if saved.exists() else {}


def _fields(cls, saved: dict) -> dict:
    """The dataclass fields `saved` holds, as the dataclass takes them (dtypes
    by name, lists as tuples)."""
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name in saved:
            v = saved[f.name]
            kw[f.name] = DTYPES[v] if f.name == "compute_dtype" else \
                tuple(v) if isinstance(v, list) else v
    return kw


def load_pose_model(run_id, mesh_db, init_method="z-up+auto-depth", exp_dir=None,
                    device="cuda") -> LoadedPoseModel:
    """A training run's latest checkpoint as a LoadedPoseModel, its predictor
    rebuilt from every field the run's config.yaml saved."""
    sd, saved = _run(run_id, exp_dir)
    pred = saved.get("train", {}).get("predictor", saved.get("predictor", {}))
    pp = PosePredictor(PosePredictorConfig(**_fields(PosePredictorConfig, pred)), device=device)
    pp.net.load_state_dict(sd)
    return LoadedPoseModel(pp, mesh_db, init_method=init_method, device=device)


def load_reference_torch_checkpoint(path, mesh_db, init_method="v0",
                                    device="cuda") -> LoadedPoseModel:
    """A reference-format checkpoint (checkpoint.pth.tar, a 'state_dict' of
    the reference's EfficientNet-B3 PosePredictor, 'module.' prefixes
    allowed) into the port's PoseNet, whose names are the reference's; keys
    the PoseNet does not have are left out, as the JAX package's converter
    leaves them."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = {k.removeprefix("module."): v for k, v in ckpt.get("state_dict", ckpt).items()}
    pp = PosePredictor(PosePredictorConfig(), device=device)
    own = pp.net.state_dict()
    missing = sorted(set(own) - set(sd))
    if missing:
        raise KeyError(f"reference checkpoint lacks {missing[:5]} ({len(missing)} keys)")
    pp.net.load_state_dict({k: sd[k] for k in own})
    return LoadedPoseModel(pp, mesh_db, init_method=init_method, device=device)


def load_detector(run_id, label_to_category_id: dict, exp_dir=None, nms_iou=0.5,
                  nms_cross_iou=None, device="cuda") -> Detector:
    """A detector run's latest checkpoint as a Detector, its architecture from
    the run's config.yaml: `backbone_str` 'resnet50-fpn' (the reference's
    detector config's name) is Mask R-CNN, with its MaskRCNNConfig fields
    and the classes after the background; otherwise the CenterNet
    (cls_mode, mask prototypes and backbone change the tensors)."""
    sd, saved = _run(run_id, exp_dir)
    det = saved.get("detector", {})
    if saved.get("backbone_str", det.get("backbone_str")) == "resnet50-fpn":
        ids = maskrcnn_category_ids(label_to_category_id)
        fields = _fields(MaskRCNNConfig, {**saved, **det})
        model = MaskRCNN(MaskRCNNConfig(**{**fields, "n_classes": max(ids.values()) + 1}))
        model.load_state_dict(sd)
        return Detector(model.to(device), ids)
    cfg = DetectorConfig(n_classes=len(label_to_category_id),
                         **{k: v for k, v in _fields(DetectorConfig, det).items()
                            if k != "n_classes"})
    model = CenterNetDetector(cfg)
    model.load_state_dict(sd)
    return Detector(model.to(device), label_to_category_id, nms_iou=nms_iou,
                    nms_cross_iou=nms_cross_iou)


def procedural_metrics(preds: dict, scene_ds, mesh_db) -> dict:
    """The ADD(-S) meter of each stage and the BOP19 AR of the final stage's
    poses (icp, else multiview, else pose)."""
    from ..evaluation.bop_metrics import compute_bop19_ar
    from ..evaluation.eval_bundle import collect_gt
    from ..evaluation.meters import PoseErrorMeter
    from ..rendering.scene_renderer import BatchRenderer
    from ..utils.tensor_collection import TensorCollection

    _, _, gt_infos, TCO_gt, _ = collect_gt(scene_ds, len(scene_ds), with_images=False)
    gt = TensorCollection(gt_infos, poses=torch.as_tensor(TCO_gt))
    metrics = {}
    for key, tc in preds.items():
        meter = PoseErrorMeter(mesh_db, error_type="ADD(-S)", report_error_AUC=True,
                               report_error_stats=True)
        meter.add(tc, gt)
        metrics[key] = {k: float(v) for k, v in meter.summary()[0].items()
                        if isinstance(v, (int, float, np.floating))}
        logger.info(f"{key}: AUC={metrics[key].get('AUC', float('nan')):.4f} "
                    f"0.1d={metrics[key].get('0.1d', float('nan')):.4f} "
                    f"n_gt={metrics[key].get('n_gt', 0):.0f}")
    final_key = next((k for k in ("icp", "multiview", "pose") if k in preds), None)
    if final_key is None:
        logger.warning("no predictions produced; skipping BOP19 AR")
        return metrics
    ar = compute_bop19_ar(preds[final_key], scene_ds, mesh_db, renderer=BatchRenderer(mesh_db))
    metrics["bop19_ar"] = {k: v for k, v in ar.items() if isinstance(v, (int, float))}
    metrics["bop19_ar"]["prediction_key"] = final_key
    logger.info(f"BOP19 AR ({final_key}): AR={ar['AR']:.4f} vsd={ar['AR_vsd']:.4f} "
                f"mssd={ar['AR_mssd']:.4f} mspd={ar['AR_mspd']:.4f}")
    return metrics


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", required=True, choices=list(BOP_CONFIG) + ["procedural"],
                        help="a BOP dataset, or 'procedural' for the recorded procedural scenes")
    parser.add_argument("--inference-ds", default=None, help="scene dataset name override")
    parser.add_argument("--object-ds", default=None,
                        help="object set for --dataset procedural (default 'procedural', "
                             "'procedural-tex' for a texsolo dataset)")
    parser.add_argument("--n-frames", type=int, default=None)
    parser.add_argument("--detector", default=None)
    parser.add_argument("--coarse", default=None)
    parser.add_argument("--refiner", default=None)
    parser.add_argument("--nviews", type=int, default=1)
    parser.add_argument("--icp", action="store_true")
    parser.add_argument("--detection-th", type=float, default=0.3)
    parser.add_argument("--n-coarse", type=int, default=1, help="coarse iterations")
    parser.add_argument("--n-refiner", type=int, default=4, help="refiner iterations")
    parser.add_argument("--debug", action="store_true", help="the first 4 frames")
    parser.add_argument("--ds-root", default=None, help="data root (default config.LOCAL_DATA_DIR)")
    parser.add_argument("--exp-dir", default=None, help="runs directory (default config.EXP_DIR)")
    parser.add_argument("--out-dir", default=None,
                        help="results directory (default <results>/bop-<dataset>)")
    parser.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    args = parser.parse_args(argv)

    ds = args.dataset
    if ds == "procedural":
        inference_ds = args.inference_ds or "synthetic.procedural-4k.val"
        obj_name = args.object_ds or ("procedural-tex" if "texsolo" in inference_ds
                                      else "procedural")
        defaults = ("detector-procedural", None, "procedural-refiner-mini")
    else:
        inference_ds = args.inference_ds or BOP_CONFIG[ds]["inference_ds_name"][0]
        obj_name = BOP_CONFIG[ds]["obj_ds_name"]
        defaults = (PBR_DETECTORS[ds], PBR_COARSE[ds], PBR_REFINER[ds])
    # depth feeds ICP and the procedural AR's VSD term
    scene_ds = make_scene_dataset(inference_ds, ds_root=args.ds_root,
                                  load_depth=ds == "procedural" or args.icp)
    n_keep = 4 if args.debug else args.n_frames
    if n_keep:
        scene_ds.frame_index = scene_ds.frame_index.select(np.arange(min(n_keep,
                                                                         len(scene_ds))))
    obj_ds = make_object_dataset(obj_name, ds_root=args.ds_root)
    mesh_db = build_mesh_db(obj_ds.mesh_specs(), device=args.device)
    mv_predictor = MultiviewScenePredictor(build_mesh_db(
        obj_ds.mesh_specs(), aabb=True, keep_geometry=False, device=args.device)) \
        if args.nviews > 1 else None
    labels = label_to_category_id(obj_ds)

    detector_run = args.detector or defaults[0]
    coarse_run = args.coarse or defaults[1]
    refiner_run = args.refiner or defaults[2]
    detector = load_detector(detector_run, labels, exp_dir=args.exp_dir, device=args.device)
    coarse = (load_pose_model(coarse_run, mesh_db, exp_dir=args.exp_dir, device=args.device)
              if coarse_run else None)
    refiner = load_pose_model(refiner_run, mesh_db, exp_dir=args.exp_dir, device=args.device)
    pose_predictor = CoarseRefinePosePredictor(coarse, refiner, device=args.device)
    runner = BopPredictionRunner(MultiViewWrapper(scene_ds, n_views=args.nviews),
                                 n_coarse_iterations=args.n_coarse if coarse else 0,
                                 n_refiner_iterations=args.n_refiner)
    preds = runner.get_predictions(detector, pose_predictor, mv_predictor=mv_predictor,
                                   icp_refiner=ICPRefiner(mesh_db) if args.icp else None,
                                   detection_th=args.detection_th)

    out_dir = pathlib.Path(args.out_dir or config.RESULTS_DIR / f"bop-{ds}")
    out_dir.mkdir(parents=True, exist_ok=True)
    csv_paths = {}
    for key, tc in preds.items():
        csv_paths[key] = out_dir / f"cosyposetpu_{key}-{ds}-test.csv"
        predictions_to_bop_csv(tc, csv_paths[key])
        logger.info(f"Wrote {csv_paths[key]} ({len(tc)} predictions)")
    if ds != "procedural":
        # BOP datasets are scored by the toolkit on the CSVs (run_bop_eval)
        return dict(csv_paths=csv_paths, predictions=preds, seconds=runner.seconds)

    metrics = procedural_metrics(preds, scene_ds, mesh_db)
    suffix = ("-icp" if args.icp else "") + ("" if (args.n_coarse, args.n_refiner) == (1, 4)
                                             else f"-c{args.n_coarse}r{args.n_refiner}")
    mpath = out_dir / f"metrics-{inference_ds.replace('.', '_')}{suffix}.json"
    mpath.write_text(json.dumps(dict(dataset=inference_ds, detector=detector_run,
                                     coarse=coarse_run, refiner=refiner_run,
                                     detection_th=args.detection_th,
                                     n_frames=int(len(scene_ds)), metrics=metrics), indent=2))
    logger.info(f"wrote {mpath}")
    return dict(csv_paths=csv_paths, predictions=preds, metrics=metrics, seconds=runner.seconds)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
