"""Smoke script: iterate a PoseDataset in batches to time loading and
augmentation (port of cosypose_tpu/scripts/test_dataset.py).

  python -m cosypose_tpu_torch.scripts.test_dataset --dataset ycbv.train.pbr \\
      [--n-frames 50] [--batch-size 8] [--ds-root DIR]
"""

from __future__ import annotations

import argparse
import time

from ..data.datasets_cfg import make_scene_dataset
from ..data.pose_dataset import PoseDataset
from ..utils.logging import get_logger

logger = get_logger(__name__)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", required=True)
    parser.add_argument("--n-frames", type=int, default=50)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--ds-root", default=None)
    args = parser.parse_args(argv)

    pose_ds = PoseDataset(make_scene_dataset(args.dataset, ds_root=args.ds_root))
    t0 = time.perf_counter()
    n = 0
    for start in range(0, min(args.n_frames, len(pose_ds)), args.batch_size):
        ids = range(start, min(start + args.batch_size, len(pose_ds)))
        batch = pose_ds.make_batch(ids)
        if batch["images"].shape[0] != len(ids):
            raise RuntimeError(f"a batch of {batch['images'].shape[0]} for {len(ids)} frames")
        n += len(ids)
    dt = time.perf_counter() - t0
    logger.info(f"{n} frames in {dt:.2f}s → {n / dt:.1f} frames/s")
    return n, dt


if __name__ == "__main__":
    main()
