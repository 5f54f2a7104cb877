"""ctypes binding of the host JPEG decoder, csrc/jpeg_decode.cpp.

The library is built with `g++ -O3 -shared -fPIC` into build/ at first use
(the file name carries a hash of the source and the flags, as the matching
library's does). The build writes a temporary file and renames it, so
DataLoader workers that start together cannot race; a failed build raises.
Every runtime path that reads a JPEG (utils/png.imread) calls `decode` here;
utils/jpeg.py is its plain numpy version, which the tests hold it to.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess

import numpy as np

from .jpeg import JPEGError

_SRC = pathlib.Path(__file__).resolve().parents[1] / "csrc" / "jpeg_decode.cpp"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
ERR_LEN = 512

_lib = None


def build_library() -> pathlib.Path:
    """The shared library in build/, compiled where it is missing."""
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"libcosypose_jpeg_{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"libcosypose_jpeg_{digest}.{os.getpid()}.so"
    proc = subprocess.run(["g++", *GXX_FLAGS, str(_SRC), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {_SRC.name} ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library()))
        u8p, i32p = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32)
        lib.cosypose_jpeg_info.restype = ctypes.c_int
        lib.cosypose_jpeg_info.argtypes = [u8p, ctypes.c_int64, i32p, ctypes.c_char_p,
                                           ctypes.c_int32]
        lib.cosypose_jpeg_decode.restype = ctypes.c_int
        lib.cosypose_jpeg_decode.argtypes = [u8p, ctypes.c_int64, u8p, ctypes.c_int64,
                                             ctypes.c_char_p, ctypes.c_int32]
        _lib = lib
    return _lib


def decode(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """JPEG bytes -> (H, W, 3) uint8 RGB, or (H, W) uint8 for one component;
    JPEGError naming `name` where utils/jpeg.decode raises."""
    lib = _load()
    src = np.frombuffer(data, np.uint8)
    src_p = src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    err = ctypes.create_string_buffer(ERR_LEN)
    hwc = np.zeros(3, np.int32)
    if lib.cosypose_jpeg_info(src_p, src.size, hwc.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                              err, ERR_LEN):
        raise JPEGError(f"{name}: {err.value.decode()}")
    h, w, c = (int(v) for v in hwc)
    out = np.empty((h, w) if c == 1 else (h, w, c), np.uint8)
    if lib.cosypose_jpeg_decode(src_p, src.size, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                                out.size, err, ERR_LEN):
        raise JPEGError(f"{name}: {err.value.decode()}")
    return out
