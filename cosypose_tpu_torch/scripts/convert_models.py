"""Asset preparation: decimate an object model set and write simplified PLY
copies (port of cosypose_tpu/scripts/convert_models.py). The rasterizer
reads PLY meshes directly, so no URDF or OBJ step exists; models_info.json is
copied beside the decimated models.

  python -m cosypose_tpu_torch.scripts.convert_models --models-dir <dir> \\
      --out-dir <dir> [--max-faces 8192]
"""

from __future__ import annotations

import argparse
import pathlib
import shutil


from ..ops.mesh_io import decimate_mesh, load_mesh, save_ply
from ..utils.logging import get_logger

logger = get_logger(__name__)


def write_ply(path, verts, faces, colors=None):
    """An ASCII PLY of float vertices (with uchar colours from [0, 1]
    colours, when given) and triangle faces."""
    save_ply(path, verts, faces, colors, binary=False)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--models-dir", required=True)
    parser.add_argument("--out-dir", required=True)
    parser.add_argument("--max-faces", type=int, default=8192)
    args = parser.parse_args(argv)

    models_dir, out_dir = pathlib.Path(args.models_dir), pathlib.Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    info_json = models_dir / "models_info.json"
    if info_json.exists():
        shutil.copy(info_json, out_dir / "models_info.json")
    written = []
    for ply in sorted(models_dir.glob("*.ply")):
        verts, faces, colors = load_mesh(ply, with_colors=True)
        n0 = faces.shape[0]
        verts, faces, colors = decimate_mesh(verts, faces, colors, args.max_faces)
        write_ply(out_dir / ply.name, verts, faces, colors)
        written.append(out_dir / ply.name)
        logger.info(f"{ply.name}: {n0} → {faces.shape[0]} faces")
    return written


if __name__ == "__main__":
    main()
