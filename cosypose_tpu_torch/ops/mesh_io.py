"""Minimal mesh loaders (PLY / OBJ), host-side numpy.

The port's own copy of cosypose_tpu/ops/mesh_io.py (loaders and decimation).

The reference loads meshes with trimesh (ref: cosypose/lib3d/rigid_mesh_database.py:14);
trimesh is not a dependency, and BOP model sets ship as PLY, so a small
self-contained loader covers the need. Supports ascii and binary_little_endian PLY
with vertex x/y/z (+ optional extras, skipped) and triangle faces, plus basic OBJ.
"""

from __future__ import annotations

import struct

import numpy as np

_PLY_TYPES = {
    "char": ("b", 1), "int8": ("b", 1),
    "uchar": ("B", 1), "uint8": ("B", 1),
    "short": ("h", 2), "int16": ("h", 2),
    "ushort": ("H", 2), "uint16": ("H", 2),
    "int": ("i", 4), "int32": ("i", 4),
    "uint": ("I", 4), "uint32": ("I", 4),
    "float": ("f", 4), "float32": ("f", 4),
    "double": ("d", 8), "float64": ("d", 8),
}


def load_mesh(path: str, with_colors: bool = False):
    """Load a mesh file → (vertices (V,3) float64, faces (F,3) int64[, colors]).

    with_colors=True additionally returns per-vertex albedo (V,3) in [0,1] (or
    None when the file has no color attributes) — the stand-in for the
    reference's textured URDF rendering (BOP PLY models carry vertex colors).
    """
    path = str(path)
    if path.lower().endswith(".ply"):
        verts, faces, colors = load_ply(path)
    elif path.lower().endswith(".obj"):
        verts, faces = load_obj(path)
        colors = None
    else:
        raise ValueError(f"Unsupported mesh format: {path}")
    if with_colors:
        return verts, faces, colors
    return verts, faces


def load_ply(path: str):
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.find(b"end_header\n")
    if header_end < 0:
        raise ValueError(f"Not a valid PLY file: {path}")
    header = data[:header_end].decode("ascii", errors="replace").splitlines()
    body = data[header_end + len(b"end_header\n"):]

    fmt = None
    elements = []  # list of (name, count, [(prop_name, type, list_count_type|None)])
    for line in header:
        parts = line.strip().split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if parts[1] == "list":
                elements[-1][2].append((parts[4], parts[3], parts[2]))
            else:
                elements[-1][2].append((parts[2], parts[1], None))

    if fmt == "ascii":
        return _parse_ply_ascii(body, elements)
    elif fmt == "binary_little_endian":
        return _parse_ply_binary(body, elements, "<")
    elif fmt == "binary_big_endian":
        return _parse_ply_binary(body, elements, ">")
    raise ValueError(f"Unsupported PLY format {fmt}")


def _extract_colors(names, rec, dt):
    if not all(c in names for c in ("red", "green", "blue")):
        return None
    cols = np.stack(
        [rec[dt.names[names.index(c)]] for c in ("red", "green", "blue")], axis=-1
    ).astype(np.float64)
    if cols.max() > 1.0:
        cols = cols / 255.0
    return cols


def _parse_ply_ascii(body: bytes, elements):
    lines = body.decode("ascii", errors="replace").splitlines()
    pos = 0
    verts, faces, colors = None, [], None
    for name, count, props in elements:
        if name == "vertex":
            names = [p[0] for p in props]
            xi, yi, zi = names.index("x"), names.index("y"), names.index("z")
            arr = np.empty((count, 3), dtype=np.float64)
            has_col = all(c in names for c in ("red", "green", "blue"))
            if has_col:
                ci = [names.index(c) for c in ("red", "green", "blue")]
                colors = np.empty((count, 3), dtype=np.float64)
            for i in range(count):
                vals = lines[pos + i].split()
                arr[i] = (float(vals[xi]), float(vals[yi]), float(vals[zi]))
                if has_col:
                    colors[i] = tuple(float(vals[c]) for c in ci)
            if has_col and colors.max() > 1.0:
                colors = colors / 255.0
            verts = arr
            pos += count
        elif name == "face":
            for i in range(count):
                vals = lines[pos + i].split()
                n = int(vals[0])
                idx = [int(v) for v in vals[1 : 1 + n]]
                for k in range(1, n - 1):  # fan triangulation
                    faces.append((idx[0], idx[k], idx[k + 1]))
            pos += count
        else:
            pos += count
    return verts, np.asarray(faces, dtype=np.int64).reshape(-1, 3), colors


def _parse_ply_binary(body: bytes, elements, endian: str):
    off = 0
    verts, faces, colors = None, [], None
    for name, count, props in elements:
        fixed = all(p[2] is None for p in props)
        if name == "vertex" and fixed:
            fmt = endian + "".join(_PLY_TYPES[p[1]][0] for p in props)
            size = struct.calcsize(fmt)
            names = [p[0] for p in props]
            xi, yi, zi = names.index("x"), names.index("y"), names.index("z")
            dt = np.dtype([(p[0] + f"_{i}", endian + _PLY_TYPES[p[1]][0])
                           for i, p in enumerate(props)])
            rec = np.frombuffer(body, dtype=dt, count=count, offset=off)
            verts = np.stack(
                [rec[dt.names[xi]], rec[dt.names[yi]], rec[dt.names[zi]]], axis=-1
            ).astype(np.float64)
            colors = _extract_colors(names, rec, dt)
            off += size * count
        elif name == "face":
            # typical: one list property (vertex_indices) [+ possibly texcoords]
            for _ in range(count):
                for pname, ptype, ltype in props:
                    lc, ls = _PLY_TYPES[ltype]
                    (n,) = struct.unpack_from(endian + lc, body, off)
                    off += ls
                    pc, ps = _PLY_TYPES[ptype]
                    vals = struct.unpack_from(endian + pc * n, body, off)
                    off += ps * n
                    if pname in ("vertex_indices", "vertex_index"):
                        for k in range(1, n - 1):
                            faces.append((vals[0], vals[k], vals[k + 1]))
        else:
            # skip fixed-size element
            if fixed:
                size = struct.calcsize(endian + "".join(_PLY_TYPES[p[1]][0] for p in props))
                off += size * count
            else:
                raise ValueError(f"Cannot skip variable-size element {name}")
    return verts, np.asarray(faces, dtype=np.int64).reshape(-1, 3), colors


def load_obj(path: str):
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append((float(parts[1]), float(parts[2]), float(parts[3])))
            elif line.startswith("f "):
                idx = [int(p.split("/")[0]) - 1 for p in line.split()[1:]]
                for k in range(1, len(idx) - 1):
                    faces.append((idx[0], idx[k], idx[k + 1]))
    return (
        np.asarray(verts, dtype=np.float64),
        np.asarray(faces, dtype=np.int64).reshape(-1, 3),
    )


def decimate_mesh(verts: np.ndarray, faces: np.ndarray,
                  colors: np.ndarray | None, max_faces: int):
    """Vertex-clustering decimation to at most ~max_faces triangles.

    Replaces trimesh/meshlab simplification used by the reference's asset prep
    (ref: cosypose/scripts/convert_models_to_urdf.py:12-29): vertices are
    snapped to a uniform grid whose resolution shrinks until the face budget is
    met; faces with repeated clusters collapse away. Crude but robust — the
    render-and-compare network consumes low-fidelity renders anyway, and the
    budget keeps the rasterizer's per-tile triangle cap sound.
    """
    if faces.shape[0] <= max_faces:
        return verts, faces, colors
    bbox = verts.max(0) - verts.min(0)
    diag = float(np.linalg.norm(bbox)) + 1e-9
    res = 64
    while res >= 4:
        cell = diag / res
        keys = np.floor((verts - verts.min(0)) / cell).astype(np.int64)
        _, cluster_ids, counts = np.unique(
            keys, axis=0, return_inverse=True, return_counts=True
        )
        n_clusters = counts.shape[0]
        new_verts = np.zeros((n_clusters, 3), np.float64)
        np.add.at(new_verts, cluster_ids, verts)
        new_verts /= counts[:, None]
        new_colors = None
        if colors is not None:
            new_colors = np.zeros((n_clusters, 3), np.float64)
            np.add.at(new_colors, cluster_ids, colors)
            new_colors /= counts[:, None]
        new_faces = cluster_ids[faces]
        keep = (
            (new_faces[:, 0] != new_faces[:, 1])
            & (new_faces[:, 1] != new_faces[:, 2])
            & (new_faces[:, 0] != new_faces[:, 2])
        )
        new_faces = new_faces[keep]
        # drop duplicate faces (ignoring winding-preserving rotation)
        canon = np.sort(new_faces, axis=1)
        _, uniq = np.unique(canon, axis=0, return_index=True)
        new_faces = new_faces[np.sort(uniq)]
        if new_faces.shape[0] <= max_faces:
            return new_verts, new_faces.astype(np.int64), new_colors
        res //= 2
    return new_verts, new_faces.astype(np.int64), new_colors



def save_ply(path, vertices: np.ndarray, faces: np.ndarray | None = None,
             colors: np.ndarray | None = None, binary: bool = True):
    """A PLY of float vertices, uchar colours (given in [0, 255], or in
    [0, 1] when none is above 1) and triangle faces, which load_ply reads back.

    binary=True writes the JAX package's save_ply bytes (little-endian);
    binary=False the ASCII form of its convert_models.write_ply (six decimals
    a coordinate)."""
    vertices = np.asarray(vertices, np.float32 if binary else np.float64)
    n_v = len(vertices)
    header = ["ply", "format binary_little_endian 1.0" if binary else "format ascii 1.0",
              f"element vertex {n_v}", "property float x", "property float y", "property float z"]
    rgb = None
    if colors is not None:
        header += ["property uchar red", "property uchar green", "property uchar blue"]
        rgb = np.clip(np.asarray(colors), 0, 255)
        if rgb.max() <= 1.0:
            rgb = rgb * 255.0
        rgb = rgb.astype(np.uint8)
    if faces is not None:
        faces = np.asarray(faces, np.int32)
        header += [f"element face {len(faces)}", "property list uchar int vertex_indices"]
    header.append("end_header")

    if not binary:
        rows = [f"{v[0]:.6f} {v[1]:.6f} {v[2]:.6f}" for v in vertices]
        if rgb is not None:
            rows = [f"{r} {c[0]} {c[1]} {c[2]}" for r, c in zip(rows, rgb.tolist())]
        if faces is not None:
            rows += [f"3 {f[0]} {f[1]} {f[2]}" for f in faces.tolist()]
        with open(path, "w") as f:
            f.write("\n".join(header + rows) + "\n")
        return
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        if rgb is not None:
            rec = np.empty(n_v, np.dtype([("xyz", np.float32, 3), ("rgb", np.uint8, 3)]))
            rec["xyz"], rec["rgb"] = vertices, rgb
            f.write(rec.tobytes())
        else:
            f.write(vertices.tobytes())
        if faces is not None:
            rec = np.empty(len(faces), np.dtype([("n", np.uint8), ("idx", np.int32, 3)]))
            rec["n"], rec["idx"] = 3, faces
            f.write(rec.tobytes())
