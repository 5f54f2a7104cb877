"""COLMAP multiview reconstruction baseline (port of
cosypose_tpu/scripts/run_colmap_reconstruction.py): for every n-view group of
a test set (MultiViewWrapper's groups), link the group's images into a
workspace and run `colmap automatic_reconstructor` on it. Without the
`colmap` binary on PATH the workspaces are still prepared and the command is
logged; reconstructions are read back with utils/colmap_io.read_model.

  python -m cosypose_tpu_torch.scripts.run_colmap_reconstruction --dataset tless \\
      [--nviews 4] [--ds-root DIR] [--max-groups N] [--out-dir DIR]
"""

from __future__ import annotations

import argparse
import os
import pathlib
import shutil
import subprocess

from .. import config
from ..data.datasets_cfg import make_scene_dataset
from ..data.wrappers import MultiViewWrapper
from ..utils.logging import get_logger

logger = get_logger(__name__)

TEST_SPLITS = {"tless": "tless.primesense.test.bop19", "ycbv": "ycbv.test.keyframes"}


def main(argv=None):
    parser = argparse.ArgumentParser("Running COLMAP")
    parser.add_argument("--dataset", required=True)
    parser.add_argument("--nviews", type=int, default=4)
    parser.add_argument("--ds-root", default=None)
    parser.add_argument("--max-groups", type=int, default=None)
    parser.add_argument("--out-dir", default=None,
                        help="workspaces' parent (default <data>/colmap/<dataset>_nviews=<n>)")
    args = parser.parse_args(argv)
    if args.nviews < 2:
        raise ValueError("--nviews must be at least 2")

    scene_ds = make_scene_dataset(TEST_SPLITS.get(args.dataset, f"{args.dataset}.test"),
                                  ds_root=args.ds_root)
    ds_multi = MultiViewWrapper(scene_ds, n_views=args.nviews)
    view_ids = scene_ds.frame_index["view_id"]
    colmap_bin = shutil.which("colmap")
    colmap_dir = pathlib.Path(args.out_dir or config.LOCAL_DATA_DIR / "colmap"
                              / f"{args.dataset}_nviews={args.nviews}")
    colmap_dir.mkdir(exist_ok=True, parents=True)

    workspaces = []
    for group in ds_multi.groups[:args.max_groups]:
        views = [int(view_ids[i]) for i in group["ds_ids"]]
        scene_id = group["scene_id"]
        group_dir = colmap_dir / (f"{args.dataset}_groupid={group['group_id']}_scene={scene_id}"
                                  f"-views={'-'.join(map(str, views))}")
        images_dir = group_dir / "images"
        images_dir.mkdir(exist_ok=True, parents=True)
        for view_id in views:
            src = scene_ds.split_dir / f"{scene_id:06d}" / "rgb" / f"{view_id:06d}.png"
            if not src.exists():
                src = src.with_suffix(".jpg")
            if not (images_dir / src.name).is_symlink():
                os.symlink(src, images_dir / src.name)
        cmd = ["colmap", "automatic_reconstructor", "--workspace_path", group_dir.as_posix(),
               "--image_path", images_dir.as_posix()]
        if colmap_bin:
            logger.info(f"{group_dir}")
            subprocess.run(cmd, check=False)
        else:
            logger.info(f"prepared {group_dir} (colmap binary not found — run: {' '.join(cmd)})")
        workspaces.append(group_dir)
    return workspaces


if __name__ == "__main__":
    main()
