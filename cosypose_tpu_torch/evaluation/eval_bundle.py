"""In-training evaluation bundle (port of cosypose_tpu/evaluation/eval_bundle.py).

make_eval_bundle collects a fixed set of held-out frames and their GT once,
seeds the model from the config's input generator (noisy GT for refiners, the
GT-box init for coarse models), and returns a callback that the trainer runs
every test_epoch_interval epochs: the training module's forward in eval mode
(running statistics, no gradient), scored by the known-correspondence
per-pair ADD, rotation and translation errors at init and after each
refinement iteration.

The gt+noise draws come from torch.Generator().manual_seed(noise_seed)
through ops/transforms.add_pose_noise, not from the JAX package's PRNG: the
same seed gives other noise than in the JAX package (ROADMAP §3).
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..data.pillow_ops import resize_bilinear
from ..integrated.pose_predictor import CoarseRefinePosePredictor, LoadedPoseModel
from ..ops.pose_ops import TCO_init_from_boxes_zup_autodepth
from ..ops.transforms import add_pose_noise
from ..utils.device import resolve_device
from ..utils.tensor_collection import TensorCollection

logger = logging.getLogger(__name__)


def collect_gt(ds, n_frames: int, resize=None, with_images: bool = True):
    """The first n_frames of a scene dataset → (images (N,3,H,W) float32 in
    [0,1] or None, K (N,3,3), GT infos {scene_id, view_id, label,
    visib_fract, batch_im_id, score}, TCO (n,4,4), boxes (n,4)), all numpy.
    resize=(h, w) resamples the frames as Pillow's BILINEAR does and rescales
    K and the boxes."""
    images, Ks, rows, TCO, boxes = [], [], [], [], []
    for i in range(min(n_frames, len(ds))):
        rgb, _, obs = ds[i]
        K_i = np.asarray(obs["camera"]["K"], np.float32).copy()
        sx = sy = 1.0
        if resize is not None and tuple(rgb.shape[:2]) != tuple(resize):
            h0, w0 = rgb.shape[:2]
            h1, w1 = resize
            rgb = resize_bilinear(rgb, (h1, w1))
            sx, sy = w1 / w0, h1 / h0
            K_i[0] *= sx
            K_i[1] *= sy
        TCW = np.linalg.inv(np.asarray(obs["camera"]["TWC"], np.float64))
        if with_images:
            images.append(np.moveaxis(rgb, -1, 0).astype(np.float32) / 255.0)
        Ks.append(K_i)
        frame = obs["frame_info"]
        for obj in obs["objects"]:
            rows.append((int(frame["scene_id"]), int(frame["view_id"]), obj["label"],
                         float(obj.get("visib_fract", 1.0)), i))
            TCO.append((TCW @ np.asarray(obj["TWO"], np.float64)).astype(np.float32))
            bb = np.asarray(obj.get("bbox", (0, 0, 1, 1)), np.float32)
            boxes.append(bb * np.array([sx, sy, sx, sy], np.float32))
    scene_id, view_id, label, visib, im_id = zip(*rows)
    infos = dict(scene_id=np.asarray(scene_id, np.int64), view_id=np.asarray(view_id, np.int64),
                 label=np.asarray(label, dtype=str), visib_fract=np.asarray(visib, np.float64),
                 batch_im_id=np.asarray(im_id, np.int64), score=np.ones(len(rows)))
    return (np.stack(images) if with_images else None, np.stack(Ks), infos,
            np.stack(TCO).astype(np.float32), np.stack(boxes).astype(np.float32))


def per_pair_errors(mesh_db, labels, TCO_pred, TCO_gt) -> dict:
    """Known-correspondence errors, in float64 on the host: ADD (mean,
    median, p90, meters), ADD over the object's diameter (mean, median,
    fraction under 0.1), the rotation's geodesic angle (degrees, mean and
    median), |Δxy| and |Δz| (meters, mean)."""
    label_ids = np.asarray([mesh_db.label_to_id[l] for l in labels])
    pts = mesh_db.points.cpu().numpy()[label_ids]        # (N, P, 3)
    valid = mesh_db.valid.cpu().numpy()[label_ids]       # (N, P)
    Tp = np.asarray(TCO_pred, np.float64)
    Tg = np.asarray(TCO_gt, np.float64)

    gt_pts = np.einsum("nij,npj->npi", Tg[:, :3, :3], pts) + Tg[:, None, :3, 3]
    pr_pts = np.einsum("nij,npj->npi", Tp[:, :3, :3], pts) + Tp[:, None, :3, 3]
    d = np.linalg.norm(gt_pts - pr_pts, axis=-1)
    w = valid.astype(np.float64)
    add = (d * w).sum(1) / np.maximum(w.sum(1), 1.0)

    # diameters from the valid point cloud's extent
    ctr = (pts * w[..., None]).sum(1, keepdims=True) / np.maximum(w.sum(1)[:, None, None], 1.0)
    diam = 2.0 * (np.linalg.norm(pts - ctr, axis=-1) * w).max(1)
    add_rel = add / np.maximum(diam, 1e-9)

    R_rel = np.einsum("nij,nkj->nik", Tp[:, :3, :3], Tg[:, :3, :3])
    cos = np.clip((np.trace(R_rel, axis1=1, axis2=2) - 1.0) / 2.0, -1.0, 1.0)
    ang = np.degrees(np.arccos(cos))

    dt = Tp[:, :3, 3] - Tg[:, :3, 3]
    dxy = np.linalg.norm(dt[:, :2], axis=-1)
    dz = np.abs(dt[:, 2])
    return dict(
        ADD_mean=float(add.mean()), ADD_median=float(np.median(add)),
        ADD_p90=float(np.percentile(add, 90)),
        ADD_rel_mean=float(add_rel.mean()), ADD_rel_median=float(np.median(add_rel)),
        frac_ADD_lt_0p1d=float((add_rel < 0.1).mean()),
        rot_deg_mean=float(ang.mean()), rot_deg_median=float(np.median(ang)),
        dxy_mean=float(dxy.mean()), dz_mean=float(dz.mean()),
    )


def initial_poses(init: str, mesh_db, labels, TCO_gt, gt_boxes, K_objects,
                  noise_seed: int = 0, euler_deg_std=(15.0, 15.0, 15.0),
                  trans_std=(0.01, 0.01, 0.05), n_points: int = 1000) -> np.ndarray:
    """The poses a refinement starts from, (n,4,4) float32 numpy: 'gt+noise'
    (draws from torch.Generator().manual_seed(noise_seed) on the CPU), or
    'box', the BOP20 z-up auto-depth init from the GT boxes (n,4) and each
    object's intrinsics K_objects (n,3,3), over n_points of each mesh."""
    if init == "gt+noise":
        return add_pose_noise(torch.as_tensor(TCO_gt), torch.Generator().manual_seed(noise_seed),
                              euler_deg_std=tuple(euler_deg_std),
                              trans_std=tuple(trans_std)).numpy()
    if init != "box":
        raise ValueError(init)
    dev = mesh_db.device
    points = mesh_db.sample_points(mesh_db.ids_for(labels), n_points)
    return TCO_init_from_boxes_zup_autodepth(
        torch.as_tensor(gt_boxes, device=dev), points,
        torch.as_tensor(K_objects, device=dev)).cpu().numpy()


def make_eval_bundle(cfg, mesh_db, scene_ds, n_frames: int = 30, n_iterations: int | None = None,
                     noise_seed: int = 0, device: str | torch.device = "cuda"):
    """The default in-training evaluation callback over scene_ds's first
    n_frames.

    cfg: training.configs.RunConfig; mesh_db: BatchedMeshes on `device`.
    Returns eval_callback(state, epoch) -> {"init/<metric>": v,
    "iter=<n>/<metric>": v} (per_pair_errors' metrics), which runs
    state.pp's forward in eval mode under no_grad with the config's compute
    dtype and leaves the module in the mode it found it in, its state dict
    unchanged.
    """
    device = resolve_device(device)
    tcfg = cfg.train
    n_iterations = n_iterations or max(tcfg.n_iterations, 1)
    images, K, gt_infos, TCO_gt, gt_boxes = collect_gt(scene_ds, n_frames,
                                                       resize=tuple(cfg.input_resize) or None)
    labels = gt_infos["label"]
    TCO_init = initial_poses("gt+noise" if tcfg.input_generator == "gt+noise" else "box",
                             mesh_db, labels, TCO_gt, gt_boxes, K[gt_infos["batch_im_id"]],
                             noise_seed, tcfg.noise_euler_deg, tcfg.noise_trans)
    init_errors = per_pair_errors(mesh_db, labels, TCO_init, TCO_gt)
    logger.info(f"eval bundle: {len(labels)} GT pairs / {images.shape[0]} frames, "
                f"init ADD median {init_errors['ADD_median'] * 1000:.2f}mm")
    images = torch.as_tensor(images, device=device)
    K = torch.as_tensor(K, device=device)
    obj_data = TensorCollection(gt_infos, poses=torch.as_tensor(TCO_init, device=device))

    def eval_callback(state, epoch):
        pp = state.pp
        model = LoadedPoseModel(pp, mesh_db, device=device)
        predictor = CoarseRefinePosePredictor(refiner_model=model, device=device)
        training = pp.net.training
        try:
            with torch.no_grad():   # forward() also puts the net in eval mode
                preds = predictor.batched_model_predictions(model, images, K, obj_data,
                                                            n_iterations=n_iterations)
        finally:
            pp.net.train(training)
        metrics = {f"init/{k}": v for k, v in init_errors.items()}
        for n in range(1, n_iterations + 1):
            e = per_pair_errors(mesh_db, labels, preds[f"iteration={n}"].poses.cpu().numpy(),
                                TCO_gt)
            metrics.update({f"iter={n}/{k}": v for k, v in e.items()})
        final = metrics[f"iter={n_iterations}/ADD_median"]
        logger.info(f"eval epoch {epoch}: ADD median {init_errors['ADD_median'] * 1000:.2f} -> "
                    f"{final * 1000:.2f}mm")
        return metrics

    return eval_callback
