"""Detector evaluation CLI (port of cosypose_tpu/scripts/run_detection_eval.py).

  python -m cosypose_tpu_torch.scripts.run_detection_eval --dataset ycbv|<scene dataset> \\
      --detector RUN [--object-ds NAME] [--detection-th 0.0] [--masks] [--mask-th 0.05] \\
      [--n-frames N] [--nms-iou 0.5] [--nms-cross-iou 0] [--debug] [--ds-root DIR] \\
      [--exp-dir DIR] [--out PATH] [--device cpu]

Runs the detector over the frames (DetectionRunner) and reports box AP, mAP
and recall at IoU 0.5 (DetectionMeter), and with --masks the same by mask
IoU; writes them with the per-label AP to a JSON (default
<results>/detection-<run>-<dataset>.json).
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
from ..evaluation.eval_runners import DetectionEvaluation
from ..evaluation.meters import DetectionMeter
from ..evaluation.pred_runners import DetectionRunner
from ..utils.tensor_collection import TensorCollection, concatenate
from .run_bop_inference import load_detector
from .run_detector_training import label_to_category_id

logger = logging.getLogger(__name__)


class DetectionGTEvaluation(DetectionEvaluation):
    """Detection evaluation whose GT are the frames' boxes (and, with_masks,
    their instance masks from the segmentation)."""

    def __init__(self, scene_ds, meters, with_masks: bool = False, **kw):
        super().__init__(scene_ds, meters, **kw)
        self.with_masks = with_masks

    def collect_gt(self):
        gts = []
        for idx in range(len(self.scene_ds)):
            _, segm, obs = self.scene_ds[idx]
            frame = obs["frame_info"]
            objects = [o for o in obs["objects"] if o.get("bbox") is not None]
            if not objects:
                continue
            infos = dict(scene_id=np.full(len(objects), frame["scene_id"], np.int64),
                         view_id=np.full(len(objects), frame["view_id"], np.int64),
                         label=np.asarray([o["label"] for o in objects], dtype=str),
                         visib_fract=np.asarray([o.get("visib_fract", 1.0) for o in objects]))
            tensors = dict(bboxes=torch.as_tensor(np.stack([o["bbox"] for o in objects]),
                                                  dtype=torch.float32))
            if self.with_masks:
                if segm is None or any("id_in_segm" not in o for o in objects):
                    raise ValueError("mask evaluation needs the segmentation and every "
                                     "object's id_in_segm")
                tensors["masks"] = torch.as_tensor(
                    np.stack([segm == int(o["id_in_segm"]) for o in objects]))
            gts.append(TensorCollection(infos, **tensors))
        return concatenate(gts)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", required=True,
                        help="a BOP name (evaluates <ds>.test) or a scene dataset name such as "
                             "synthetic.procedural-4k.val")
    parser.add_argument("--detector", required=True)
    parser.add_argument("--object-ds", default=None,
                        help="object set (default <ds>.models; 'procedural' for the built-in set)")
    parser.add_argument("--detection-th", type=float, default=0.0)
    parser.add_argument("--masks", action="store_true", help="also mask AP (mask IoU matching)")
    parser.add_argument("--mask-th", type=float, default=0.05)
    parser.add_argument("--n-frames", type=int, default=None)
    parser.add_argument("--nms-iou", type=float, default=0.5,
                        help="same-class greedy box NMS on the decoded top-k (0 disables)")
    parser.add_argument("--nms-cross-iou", type=float, default=0.0,
                        help="class-agnostic duplicate suppression (0 disables)")
    parser.add_argument("--debug", action="store_true", help="the first 8 frames")
    parser.add_argument("--ds-root", default=None, help="data root (default config.LOCAL_DATA_DIR)")
    parser.add_argument("--exp-dir", default=None, help="runs directory (default config.EXP_DIR)")
    parser.add_argument("--out", default=None, help="the JSON's path")
    parser.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    args = parser.parse_args(argv)

    scene_name = args.dataset if "." in args.dataset else f"{args.dataset}.test"
    scene_ds = make_scene_dataset(scene_name, ds_root=args.ds_root)
    n_keep = 8 if args.debug else args.n_frames
    if n_keep:
        scene_ds.frame_index = scene_ds.frame_index.select(np.arange(min(n_keep, len(scene_ds))))
    labels = label_to_category_id(make_object_dataset(args.object_ds or f"{args.dataset}.models",
                                                      ds_root=args.ds_root))
    detector = load_detector(args.detector, labels, exp_dir=args.exp_dir, nms_iou=args.nms_iou,
                             nms_cross_iou=args.nms_cross_iou or None, device=args.device)
    preds = DetectionRunner(scene_ds).get_predictions(
        detector, detection_th=args.detection_th, output_masks=args.masks, mask_th=args.mask_th)

    meters = {"bbox@0.5": DetectionMeter(iou_threshold=0.5)}
    if args.masks:
        meters["mask@0.5"] = DetectionMeter(iou_threshold=0.5, match_by="mask")
    metrics, dfs = DetectionGTEvaluation(scene_ds, meters, with_masks=args.masks).evaluate(
        preds["detections"])
    for name, summary in metrics.items():
        logger.info(f"{name}: {summary}")
    out = pathlib.Path(args.out or config.RESULTS_DIR
                       / f"detection-{args.detector}-{scene_name.replace('.', '_')}.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    payload = dict(
        detector=args.detector, dataset=scene_name, detection_th=args.detection_th,
        nms_iou=args.nms_iou, n_frames=int(len(scene_ds)),
        metrics={name: {k: float(v) for k, v in s.items()
                        if isinstance(v, (int, float, np.floating))}
                 for name, s in metrics.items()},
        ap_per_label={name: {k: float(v) for k, v in d.get("ap_per_label", {}).items()}
                      for name, d in dfs.items()})
    out.write_text(json.dumps(payload, indent=2))
    logger.info(f"wrote {out}")
    return dict(payload, predictions=preds["detections"])


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
