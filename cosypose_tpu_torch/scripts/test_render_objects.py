"""Smoke script: render every object of an object set at a fixed pose, through
BatchRenderer (the raster kernels on the card), and require a non-empty
render of each (port of cosypose_tpu/scripts/test_render_objects.py).

  python -m cosypose_tpu_torch.scripts.test_render_objects --object-ds ycbv.models \\
      [--ds-root DIR] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from ..data.datasets_cfg import make_object_dataset
from ..ops.mesh_db import build_mesh_db
from ..rendering.scene_renderer import BatchRenderer
from ..utils.logging import get_logger

logger = get_logger(__name__)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--object-ds", required=True)
    parser.add_argument("--ds-root", default=None)
    parser.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    args = parser.parse_args(argv)

    obj_ds = make_object_dataset(args.object_ds, ds_root=args.ds_root)
    mesh_db = build_mesh_db(obj_ds.mesh_specs(), device=args.device)
    n = len(mesh_db.labels)
    TCO = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    TCO[:, 2, 3] = 0.45
    K = np.zeros((n, 3, 3), np.float32)
    K[:, 0, 0] = K[:, 1, 1] = 515
    K[:, 0, 2], K[:, 1, 2], K[:, 2, 2] = 160, 120, 1
    renders = BatchRenderer(mesh_db).render(np.arange(n), TCO, K)
    sums = renders.flatten(1).sum(1).tolist()
    for label, s in zip(mesh_db.labels, sums):
        if not s > 0:
            raise RuntimeError(f"empty render for {label}")
        logger.info(f"{label}: ok (sum={s:.1f})")
    logger.info(f"All {n} objects render correctly")
    return renders


if __name__ == "__main__":
    main()
