"""BOP challenge CSV export (port of cosypose_tpu/evaluation/bop_export.py):
one row a prediction,

    scene_id,im_id,obj_id,score,R (9 floats),t (3 floats, MILLIMETERS),time

the format the official bop_toolkit reads, byte for byte the JAX package's."""

from __future__ import annotations

import numpy as np


def predictions_to_bop_csv(preds, csv_path, use_pose_score=True):
    """preds: TensorCollection with infos scene_id, view_id, label, score
    (, time) and poses (N,4,4) in meters."""
    infos = preds.infos
    poses = preds.poses.detach().cpu().numpy().astype(np.float64) \
        if hasattr(preds.poses, "detach") else np.asarray(preds.poses, np.float64)
    lines = ["scene_id,im_id,obj_id,score,R,t,time"]
    for n in range(len(poses)):
        obj_id = int(str(infos["label"][n]).split("_")[-1])
        R = poses[n, :3, :3].reshape(-1)
        t = poses[n, :3, 3] * 1000.0  # m → mm
        score = infos["score"][n] if use_pose_score else 1.0
        time = infos["time"][n] if "time" in infos else -1.0
        lines.append(f"{int(infos['scene_id'][n])},{int(infos['view_id'][n])},{obj_id},"
                     f"{score},{' '.join(f'{x:.8f}' for x in R)},"
                     f"{' '.join(f'{x:.8f}' for x in t)},{time}")
    with open(csv_path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return csv_path


def csv_to_candidates(csv_path):
    """Inverse: a candidates CSV → (infos {scene_id, view_id, label, score},
    poses (N,4,4) float32)."""
    rows, poses = [], []
    with open(csv_path) as f:
        header = f.readline().strip().split(",")
        for line in f:
            vals = dict(zip(header, line.strip().split(",")))
            T = np.eye(4)
            T[:3, :3] = np.asarray([float(x) for x in vals["R"].split()]).reshape(3, 3)
            T[:3, 3] = np.asarray([float(x) for x in vals["t"].split()]) / 1000.0
            poses.append(T)
            rows.append((int(vals["scene_id"]), int(vals["im_id"]),
                         f"obj_{int(vals['obj_id']):06d}", float(vals["score"])))
    cols = list(zip(*rows)) if rows else [(), (), (), ()]
    infos = dict(scene_id=np.asarray(cols[0], np.int64), view_id=np.asarray(cols[1], np.int64),
                 label=np.asarray(cols[2], dtype=str), score=np.asarray(cols[3], np.float64))
    return infos, np.asarray(poses, np.float32).reshape(-1, 4, 4)
