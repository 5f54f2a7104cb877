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

import numpy as np

from ..ops.mesh_io import decimate_mesh, load_mesh
from ..utils.logging import get_logger

logger = get_logger(__name__)


def write_ply(path, verts, faces, colors=None):
    """An ASCII PLY of float vertices (with uchar colours from [0, 1]
    colours, when given) and triangle faces."""
    header = ["ply", "format ascii 1.0", f"element vertex {len(verts)}",
              "property float x", "property float y", "property float z"]
    if colors is not None:
        header += ["property uchar red", "property uchar green", "property uchar blue"]
    header += [f"element face {len(faces)}", "property list uchar int vertex_indices",
               "end_header"]
    lines = list(header)
    for i, v in enumerate(verts):
        row = f"{v[0]:.6f} {v[1]:.6f} {v[2]:.6f}"
        if colors is not None:
            c = np.clip(colors[i] * 255, 0, 255).astype(int)
            row += f" {c[0]} {c[1]} {c[2]}"
        lines.append(row)
    lines += [f"3 {f[0]} {f[1]} {f[2]}" for f in faces]
    pathlib.Path(path).write_text("\n".join(lines) + "\n")


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
