"""PNG encode and decode with numpy and the standard library (zlib, struct);
the image readers of the port.

The port reads and writes its images without PIL. `decode` reads what Pillow
writes: 8-bit L, LA, RGB and RGBA, 16-bit of the same (big-endian in the file,
native uint16 out), all five row filters, non-interlaced; it returns what
`np.asarray(PIL.Image.open(path))` gives for those files. `encode` writes 8-
or 16-bit L, LA, RGB or RGBA with the Up filter on every row: its rows decode
as one cumulative sum down the image, where the Average and Paeth rows that
Pillow's adaptive filtering picks need a loop over the bytes of each row.
`imread` and `image_size` take JPEG files too (they start with FFD8): the
pixels come from the host decoder csrc/jpeg_decode.cpp (utils/jpeg_cext.py),
equal to Pillow's, and the size from the frame header (utils/jpeg.py).
"""

from __future__ import annotations

import pathlib
import struct
import zlib

import numpy as np

from . import jpeg, jpeg_cext

SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_SOI = b"\xff\xd8"
CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}  # colour type -> samples per pixel
COLOUR_TYPE = {n: t for t, n in CHANNELS.items()}
UP = 2


class PNGError(ValueError):
    pass


def _chunks(data: bytes):
    """(type, payload) of each chunk after the signature, CRCs checked."""
    if data[:8] != SIGNATURE:
        raise PNGError("not a PNG file")
    pos = 8
    while pos + 12 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + payload) != crc:
            raise PNGError(f"bad CRC in chunk {kind!r}")
        yield kind, payload
        if kind == b"IEND":
            return
        pos += 12 + n
    raise PNGError("truncated PNG file (no IEND)")


def image_size(path) -> tuple[int, int]:
    """(height, width) of a PNG file from its IHDR chunk, of a JPEG file from
    its frame header."""
    with open(path, "rb") as f:
        head = f.read(24)
        if head[:2] == JPEG_SOI:
            return jpeg.image_size(head + f.read(), str(path))
    if head[:8] != SIGNATURE or head[12:16] != b"IHDR":
        raise PNGError(f"{path}: not a PNG file")
    w, h = struct.unpack(">II", head[16:24])
    return h, w


def _sub(row: np.ndarray, bpp: int) -> np.ndarray:
    return np.cumsum(row.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)


def _average(row: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    r, up = bytearray(row.tobytes()), prev.tobytes()
    for x in range(len(r)):
        left = r[x - bpp] if x >= bpp else 0
        r[x] = (r[x] + ((left + up[x]) >> 1)) & 255
    return np.frombuffer(bytes(r), np.uint8)


def _paeth(row: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    r, up = bytearray(row.tobytes()), prev.tobytes()
    for x in range(len(r)):
        a, b = (r[x - bpp], up[x]) if x >= bpp else (0, up[x])
        c = up[x - bpp] if x >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        r[x] = (r[x] + (a if pa <= pb and pa <= pc else (b if pb <= pc else c))) & 255
    return np.frombuffer(bytes(r), np.uint8)


def _unfilter(raw: np.ndarray, bpp: int) -> np.ndarray:
    """Filtered scanlines (h, 1 + stride) -> image bytes (h, stride). Runs of
    Up rows are one cumulative sum; None and Sub rows are vectorised; Average
    and Paeth rows loop over their bytes."""
    types, data = raw[:, 0], raw[:, 1:]
    h, stride = data.shape
    if (types > 4).any():
        raise PNGError(f"unknown filter type {int(types.max())}")
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    i = 0
    while i < h:
        t = types[i]
        if t == UP:
            others = np.flatnonzero(types[i:] != UP)
            j = i + (int(others[0]) if others.size else h - i)
            out[i:j] = np.cumsum(data[i:j], axis=0, dtype=np.uint8) + prev
            i = j
        else:
            row = data[i]
            if t == 0:
                out[i] = row
            elif t == 1:
                out[i] = _sub(row, bpp)
            elif t == 3:
                out[i] = _average(row, prev, bpp)
            else:
                out[i] = _paeth(row, prev, bpp)
            i += 1
        prev = out[i - 1]
    return out


def decode(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W) for one channel, else (H, W, C); uint8 or uint16."""
    header, idat = None, []
    for kind, payload in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None:
        raise PNGError("no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if ctype not in CHANNELS or depth not in (8, 16):
        raise PNGError(f"unsupported PNG: colour type {ctype}, bit depth {depth}")
    if interlace:
        raise PNGError("interlaced PNG is not supported")
    channels = CHANNELS[ctype]
    bpp = channels * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * bpp):
        raise PNGError(f"image data holds {raw.size} bytes, want {h * (1 + w * bpp)}")
    pixels = _unfilter(raw.reshape(h, 1 + w * bpp), bpp)
    if depth == 16:
        pixels = pixels.view(">u2").astype(np.uint16)
    shape = (h, w) if channels == 1 else (h, w, channels)
    return pixels.reshape(shape)


def encode(image: np.ndarray, compress_level: int = 6) -> bytes:
    """(H, W) or (H, W, C) uint8 or uint16 -> PNG bytes, Up filter on every row."""
    a = np.asarray(image)
    if a.dtype not in (np.uint8, np.uint16):
        raise PNGError(f"PNG takes uint8 or uint16, got {a.dtype}")
    channels = 1 if a.ndim == 2 else a.shape[2]
    if a.ndim not in (2, 3) or channels not in COLOUR_TYPE:
        raise PNGError(f"PNG takes (H, W) or (H, W, 1|2|3|4), got {a.shape}")
    h, w = a.shape[:2]
    depth = 8 * a.dtype.itemsize
    rows = np.ascontiguousarray(a.astype(">u2") if depth == 16 else a).view(np.uint8)
    rows = rows.reshape(h, -1)
    raw = np.empty((h, 1 + rows.shape[1]), np.uint8)
    raw[:, 0] = UP
    raw[:, 1:] = rows
    raw[1:, 1:] -= rows[:-1]

    def chunk(kind: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    ihdr = struct.pack(">IIBBBBB", w, h, depth, COLOUR_TYPE[channels], 0, 0, 0)
    return (SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), compress_level)) + chunk(b"IEND", b""))


def imread(path, with_mode: bool = False):
    """Decode an image file: PNG (`decode`) or JPEG (utils/jpeg_cext.decode,
    which raises jpeg.JPEGError for a mode it does not decode). With
    with_mode, (image, Pillow's mode name): the format says it (a JPEG's four
    channels are CMYK, a PNG's RGBA), where the array's shape cannot."""
    data = pathlib.Path(path).read_bytes()
    if data[:2] == JPEG_SOI:
        image = jpeg_cext.decode(data, str(path))
        mode = jpeg.MODES[1 if image.ndim == 2 else image.shape[2]]
    else:
        image = decode(data)
        channels = 1 if image.ndim == 2 else image.shape[2]
        mode = "I;16" if image.dtype == np.uint16 and channels == 1 else \
            {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}[channels]
    return (image, mode) if with_mode else image


def imwrite(path, image: np.ndarray, compress_level: int = 6) -> None:
    pathlib.Path(path).write_bytes(encode(image, compress_level))
