"""COLMAP sparse-model IO (cameras / images / points3D, .bin and .txt): the
port's own copy of cosypose_tpu/utils/colmap_io.py (numpy and struct only).

Reads and writes COLMAP sparse reconstructions, so that the multiview COLMAP
baseline (scripts/run_colmap_reconstruction.py) can be scored against the
RANSAC + BA scene reconstructions. Written from COLMAP's documented binary
and text formats.
"""

from __future__ import annotations

import dataclasses
import pathlib
import struct

import numpy as np

# model_name -> (model_id, n_params)
CAMERA_MODELS = {
    "SIMPLE_PINHOLE": (0, 3),
    "PINHOLE": (1, 4),
    "SIMPLE_RADIAL": (2, 4),
    "RADIAL": (3, 5),
    "OPENCV": (4, 8),
    "OPENCV_FISHEYE": (5, 8),
    "FULL_OPENCV": (6, 12),
    "FOV": (7, 5),
    "SIMPLE_RADIAL_FISHEYE": (8, 4),
    "RADIAL_FISHEYE": (9, 5),
    "THIN_PRISM_FISHEYE": (10, 12),
}
_ID_TO_MODEL = {v[0]: (k, v[1]) for k, v in CAMERA_MODELS.items()}


@dataclasses.dataclass
class Camera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclasses.dataclass
class Image:
    id: int
    qvec: np.ndarray  # (4,) wxyz
    tvec: np.ndarray  # (3,)
    camera_id: int
    name: str
    xys: np.ndarray        # (N, 2)
    point3D_ids: np.ndarray  # (N,)

    def qvec2rotmat(self):
        w, x, y, z = self.qvec
        return np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ])


@dataclasses.dataclass
class Point3D:
    id: int
    xyz: np.ndarray
    rgb: np.ndarray
    error: float
    image_ids: np.ndarray
    point2D_idxs: np.ndarray


def _read(f, fmt):
    return struct.unpack(fmt, f.read(struct.calcsize(fmt)))


# ---------------------------------------------------------------- binary ----


def read_cameras_binary(path):
    cameras = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cam_id, model_id, width, height = _read(f, "<iiQQ")
            name, n_params = _ID_TO_MODEL[model_id]
            params = np.array(_read(f, f"<{n_params}d"))
            cameras[cam_id] = Camera(cam_id, name, width, height, params)
    return cameras


def write_cameras_binary(cameras, path):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        for cam in cameras.values():
            model_id, n_params = CAMERA_MODELS[cam.model]
            f.write(struct.pack("<iiQQ", cam.id, model_id, int(cam.width),
                                int(cam.height)))
            f.write(struct.pack(f"<{n_params}d", *np.asarray(cam.params)))


def read_images_binary(path):
    images = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            im_id = _read(f, "<i")[0]
            qvec = np.array(_read(f, "<4d"))
            tvec = np.array(_read(f, "<3d"))
            cam_id = _read(f, "<i")[0]
            name = b""
            c = f.read(1)
            while c != b"\x00":
                name += c
                c = f.read(1)
            (n_pts,) = _read(f, "<Q")
            # points are (x f64, y f64, point3D_id i64) triplets
            raw = f.read(24 * n_pts)
            if n_pts:
                trip = np.frombuffer(raw, dtype=np.uint8).reshape(n_pts, 24)
                xys = trip[:, :16].copy().view("<f8").reshape(n_pts, 2)
                ids = trip[:, 16:].copy().view("<i8").reshape(n_pts)
            else:
                xys = np.zeros((0, 2))
                ids = np.zeros((0,), np.int64)
            images[im_id] = Image(im_id, qvec, tvec, cam_id,
                                  name.decode("utf-8"), xys, ids)
    return images


def write_images_binary(images, path):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<i", im.id))
            f.write(struct.pack("<4d", *np.asarray(im.qvec, np.float64)))
            f.write(struct.pack("<3d", *np.asarray(im.tvec, np.float64)))
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            n_pts = len(im.xys)
            f.write(struct.pack("<Q", n_pts))
            for (x, y), pid in zip(np.asarray(im.xys, np.float64),
                                   np.asarray(im.point3D_ids, np.int64)):
                f.write(struct.pack("<ddq", x, y, int(pid)))


def read_points3D_binary(path):
    points = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            pid = _read(f, "<q")[0]
            xyz = np.array(_read(f, "<3d"))
            rgb = np.array(_read(f, "<3B"))
            error = _read(f, "<d")[0]
            (track_len,) = _read(f, "<Q")
            track = np.array(_read(f, f"<{2 * track_len}i")).reshape(-1, 2) \
                if track_len else np.zeros((0, 2), np.int32)
            points[pid] = Point3D(pid, xyz, rgb, error,
                                  track[:, 0], track[:, 1])
    return points


def write_points3D_binary(points, path):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(points)))
        for p in points.values():
            f.write(struct.pack("<q", int(p.id)))
            f.write(struct.pack("<3d", *np.asarray(p.xyz, np.float64)))
            f.write(struct.pack("<3B", *np.asarray(p.rgb, np.uint8)))
            f.write(struct.pack("<d", float(p.error)))
            f.write(struct.pack("<Q", len(p.image_ids)))
            for im_id, idx in zip(p.image_ids, p.point2D_idxs):
                f.write(struct.pack("<ii", int(im_id), int(idx)))


# ------------------------------------------------------------------ text ----


def read_cameras_text(path):
    cameras = {}
    for line in pathlib.Path(path).read_text().splitlines():
        if not line.strip() or line.startswith("#"):
            continue
        parts = line.split()
        cam_id, model = int(parts[0]), parts[1]
        cameras[cam_id] = Camera(
            cam_id, model, int(parts[2]), int(parts[3]),
            np.array(list(map(float, parts[4:]))),
        )
    return cameras


def write_cameras_text(cameras, path):
    lines = ["# Camera list: CAMERA_ID MODEL WIDTH HEIGHT PARAMS[]"]
    for cam in cameras.values():
        params = " ".join(repr(float(v)) for v in np.asarray(cam.params))
        lines.append(f"{cam.id} {cam.model} {cam.width} {cam.height} {params}")
    pathlib.Path(path).write_text("\n".join(lines) + "\n")


def read_images_text(path):
    images = {}
    lines = [l for l in pathlib.Path(path).read_text().splitlines()
             if not l.startswith("#")]
    # meta/points line pairs; the points line may be EMPTY (0 observations)
    pairs = []
    i = 0
    while i < len(lines):
        if not lines[i].strip():
            i += 1
            continue
        pairs.append((lines[i], lines[i + 1] if i + 1 < len(lines) else ""))
        i += 2
    for meta, pts in pairs:
        parts = meta.split()
        im_id = int(parts[0])
        qvec = np.array(list(map(float, parts[1:5])))
        tvec = np.array(list(map(float, parts[5:8])))
        cam_id = int(parts[8])
        name = parts[9]
        vals = pts.split()
        if vals:
            arr = np.array(list(map(float, vals))).reshape(-1, 3)
            xys, ids = arr[:, :2], arr[:, 2].astype(np.int64)
        else:
            xys = np.zeros((0, 2))
            ids = np.zeros((0,), np.int64)
        images[im_id] = Image(im_id, qvec, tvec, cam_id, name, xys, ids)
    return images


def write_images_text(images, path):
    lines = ["# Image list: IMAGE_ID QW QX QY QZ TX TY TZ CAMERA_ID NAME",
             "#             POINTS2D[] as (X, Y, POINT3D_ID)"]
    for im in images.values():
        q = " ".join(repr(float(v)) for v in np.asarray(im.qvec))
        t = " ".join(repr(float(v)) for v in np.asarray(im.tvec))
        lines.append(f"{im.id} {q} {t} {im.camera_id} {im.name}")
        pts = " ".join(
            f"{float(x)!r} {float(y)!r} {int(pid)}"
            for (x, y), pid in zip(np.asarray(im.xys),
                                   np.asarray(im.point3D_ids))
        )
        lines.append(pts)
    pathlib.Path(path).write_text("\n".join(lines) + "\n")


def read_points3D_text(path):
    points = {}
    for line in pathlib.Path(path).read_text().splitlines():
        if not line.strip() or line.startswith("#"):
            continue
        parts = line.split()
        pid = int(parts[0])
        xyz = np.array(list(map(float, parts[1:4])))
        rgb = np.array(list(map(int, parts[4:7])))
        error = float(parts[7])
        track = np.array(list(map(int, parts[8:]))).reshape(-1, 2) \
            if len(parts) > 8 else np.zeros((0, 2), np.int64)
        points[pid] = Point3D(pid, xyz, rgb, error, track[:, 0], track[:, 1])
    return points


def write_points3D_text(points, path):
    lines = ["# 3D point list: POINT3D_ID X Y Z R G B ERROR "
             "TRACK[] as (IMAGE_ID, POINT2D_IDX)"]
    for p in points.values():
        xyz = " ".join(repr(float(v)) for v in np.asarray(p.xyz))
        rgb = " ".join(map(str, np.asarray(p.rgb).astype(int).tolist()))
        track = " ".join(
            f"{int(i)} {int(j)}" for i, j in zip(p.image_ids, p.point2D_idxs)
        )
        lines.append(f"{p.id} {xyz} {rgb} {float(p.error)!r} {track}".rstrip())
    pathlib.Path(path).write_text("\n".join(lines) + "\n")


# ----------------------------------------------------------------- model ----


def read_model(path, ext=None):
    path = pathlib.Path(path)
    if ext is None:
        ext = ".bin" if (path / "cameras.bin").exists() else ".txt"
    if ext == ".bin":
        return (read_cameras_binary(path / "cameras.bin"),
                read_images_binary(path / "images.bin"),
                read_points3D_binary(path / "points3D.bin"))
    return (read_cameras_text(path / "cameras.txt"),
            read_images_text(path / "images.txt"),
            read_points3D_text(path / "points3D.txt"))


def write_model(cameras, images, points, path, ext=".bin"):
    path = pathlib.Path(path)
    path.mkdir(parents=True, exist_ok=True)
    if ext == ".bin":
        write_cameras_binary(cameras, path / "cameras.bin")
        write_images_binary(images, path / "images.bin")
        write_points3D_binary(points, path / "points3D.bin")
    else:
        write_cameras_text(cameras, path / "cameras.txt")
        write_images_text(images, path / "images.txt")
        write_points3D_text(points, path / "points3D.txt")
