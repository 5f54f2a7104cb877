"""Precompute the aggregate `<view>_all.png` instance masks of a BOP split
(port of cosypose_tpu/scripts/preprocess_bop_dataset.py): reading a frame
merges its per-object `mask_visib/<view>_<n>.png` files into one id-coded
mask, written beside them, which the loader then reads in one file open.
PNGs are written by the port's own codec (utils/png.py).

  python -m cosypose_tpu_torch.scripts.preprocess_bop_dataset --dataset itodd.pbr \\
      [--ds-root DIR]
"""

from __future__ import annotations

import argparse

import numpy as np

from ..data.datasets_cfg import make_scene_dataset
from ..utils import png
from ..utils.logging import get_logger

logger = get_logger(__name__)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", default="itodd.pbr")
    parser.add_argument("--ds-root", default=None)
    args = parser.parse_args(argv)

    scene_ds = make_scene_dataset(args.dataset, ds_root=args.ds_root)
    written = []
    for n in range(len(scene_ds)):
        _, mask, obs = scene_ds[n]
        info = obs["frame_info"]
        scene_dir = scene_ds.split_dir / f"{int(info['scene_id']):06d}"
        out = scene_dir / "mask_visib" / f"{int(info['view_id']):06d}_all.png"
        png.imwrite(out, np.asarray(mask).astype(np.uint8))
        written.append(out)
        if n % 1000 == 0:
            logger.info(f"{n}/{len(scene_ds)}")
    return written


if __name__ == "__main__":
    main()
