"""JPEG fixtures of the port's decoder tests, and a small baseline encoder.

    python -m tests.torch_port_make_jpeg_fixtures     # from the repo root; needs Pillow

Writes, from a numpy seed, into tests/torch_port_data/jpeg/:
  - frame_420_q95.jpg (480x640, baseline 4:2:0, quality 95) and
    frame_420_q90_progressive.jpg (480x640, progressive), by Pillow;
  - small fixtures: a 4:2:2 file with restart markers and a grayscale one by
    Pillow, and by `encode_baseline` below the modes Pillow does not write:
    4:1:1 (h4v1), 4:4:0 (h1v2) and Adobe RGB (APP14 transform 0);
  - a VOC-layout tree VOCdevkit/VOC2012/JPEGImages/*.jpg of VOC's 500x375
    and 375x500 frames at quality 75, 4:2:0, by Pillow;
  - expected.npz: Pillow's decode of every file (`np.asarray(Image.open(p))`),
    each array stored as its differences along the rows (uint8, wrapping) so
    that deflate packs it; `expected()` undoes them.

The content is smooth gradients, flat shapes and noise, so that the Huffman
tables see codes of many lengths. The card's machine has no Pillow: it reads
these files and arrays (chip_smoke.py phase 12).
"""

from __future__ import annotations

import io
import pathlib

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent / "torch_port_data" / "jpeg"
VOC_ROOT = ROOT / "VOCdevkit" / "VOC2012"
EXPECTED = ROOT / "expected.npz"
FRAME = (480, 640)
# (stem, (height, width)): VOC's landscape and portrait frames
VOC_FRAMES = [(f"2008_{i:06d}", (375, 500) if i % 3 else (500, 375)) for i in range(1, 7)]


def content(h: int, w: int, seed: int, sigma: float = 1.5, gray: bool = False) -> np.ndarray:
    """Gradients, a few flat discs and rectangles, Gaussian noise: (h, w, 3) uint8."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    ph = rng.uniform(0, 6, 6)
    img = np.stack([128 + 90 * np.sin(x / w * (3 + c) + ph[c]) * np.cos(y / h * (2 + c) - ph[c + 3])
                    for c in range(3)], -1)
    for _ in range(6):
        cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(0.05, 0.2) * min(h, w)
        img[(y - cy) ** 2 + (x - cx) ** 2 < r ** 2] = rng.randint(0, 256, 3)
        y0, x0 = rng.randint(0, h), rng.randint(0, w)
        img[y0:y0 + rng.randint(2, max(3, h // 4)), x0:x0 + rng.randint(2, max(3, w // 4))] = \
            rng.randint(0, 256, 3)
    img += rng.normal(0, sigma, img.shape)
    img = np.clip(np.rint(img), 0, 255).astype(np.uint8)
    return img[..., 1].copy() if gray else img


# -- a baseline encoder for the modes Pillow does not write ------------------------

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
# Annex K.1's luminance table
LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])


def quant_table(quality: int) -> np.ndarray:
    """LUMA scaled as libjpeg's jpeg_quality_scaling does, clamped to 1..255."""
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((LUMA * scale + 50) // 100, 1, 255)


def _segment(marker: int, payload: bytes) -> bytes:
    return bytes([0xFF, marker]) + (len(payload) + 2).to_bytes(2, "big") + payload


def _fixed_table(symbols: list, length: int):
    """Every symbol gets a code of `length` bits (never all ones): (DHT counts,
    symbols, {symbol: code})."""
    assert len(symbols) < (1 << length)
    counts = [0] * 16
    counts[length - 1] = len(symbols)
    return counts, symbols, {s: i for i, s in enumerate(symbols)}


DC_TABLE = _fixed_table(list(range(12)), 4)
AC_TABLE = _fixed_table([0x00, 0xF0] + [(r << 4) | s for r in range(16) for s in range(1, 11)], 8)


class _BitWriter:
    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, value: int, bits: int):
        self.acc = (self.acc << bits) | (value & ((1 << bits) - 1))
        self.n += bits
        while self.n >= 8:
            self.n -= 8
            byte = (self.acc >> self.n) & 0xFF
            self.out.append(byte)
            if byte == 0xFF:
                self.out.append(0)
        self.acc &= (1 << self.n) - 1

    def flush(self) -> bytes:
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)
        data, self.out = bytes(self.out), bytearray()
        return data


def _category(v: int) -> tuple[int, int]:
    s = abs(int(v)).bit_length()
    return s, (v if v >= 0 else v + (1 << s) - 1)


def _blocks(plane: np.ndarray, rows: int, cols: int, quant: np.ndarray) -> np.ndarray:
    """The plane edge-padded to rows x cols blocks, forward DCT, quantized:
    (rows, cols, 64) in natural order."""
    h, w = plane.shape
    p = np.pad(plane.astype(np.float64), ((0, rows * 8 - h), (0, cols * 8 - w)), mode="edge") - 128
    k = np.arange(8)
    c = np.sqrt(np.where(k == 0, 1.0, 2.0) / 8)[:, None] * np.cos((2 * k[None] + 1) * k[:, None]
                                                                 * np.pi / 16)
    b = p.reshape(rows, 8, cols, 8).transpose(0, 2, 1, 3)
    return np.rint(np.einsum("uy,rcyx,vx->rcuv", c, b, c).reshape(rows, cols, 64)
                   / quant).astype(np.int64)


def encode_baseline(image: np.ndarray, sampling=((1, 1), (1, 1), (1, 1)), restart: int = 0,
                    adobe_rgb: bool = False, quality: int = 80, app: bytes = b"") -> bytes:
    """A baseline JPEG of (H, W, 3) uint8 (YCbCr unless adobe_rgb) or (H, W)
    uint8, with the given per-component sampling factors, one quantization
    table for `quality`, fixed-length Huffman codes, an optional restart
    interval and `app` (whole marker segments) after the JFIF or Adobe one."""
    quant = quant_table(quality)
    img = np.asarray(image)
    h, w = img.shape[:2]
    if img.ndim == 2:
        planes, sampling = [img.astype(np.float64)], ((1, 1),)
    elif adobe_rgb:
        planes = [img[..., i].astype(np.float64) for i in range(3)]
    else:
        r, g, b = (img[..., i].astype(np.float64) for i in range(3))
        planes = [0.299 * r + 0.587 * g + 0.114 * b,
                  -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
                  0.5 * r - 0.418688 * g - 0.081312 * b + 128]
    hmax, vmax = max(s[0] for s in sampling), max(s[1] for s in sampling)
    mx, my = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    coefs = []
    for plane, (ch, cv) in zip(planes, sampling):
        fy, fx = vmax // cv, hmax // ch
        p = np.pad(plane, ((0, -h % fy), (0, -w % fx)), mode="edge")
        p = p.reshape(p.shape[0] // fy, fy, p.shape[1] // fx, fx).mean((1, 3))
        coefs.append(_blocks(np.clip(np.rint(p), 0, 255), my * cv, mx * ch, quant))

    bw, pred = _BitWriter(), [0] * len(planes)
    scan, n_mcu = b"", 0
    for y in range(my):
        for x in range(mx):
            if restart and n_mcu and n_mcu % restart == 0:
                scan += bw.flush() + bytes([0xFF, 0xD0 + (n_mcu // restart - 1) % 8])
                pred = [0] * len(planes)
            n_mcu += 1
            for ci, (ch, cv) in enumerate(sampling):
                for v in range(cv):
                    for u in range(ch):
                        blk = coefs[ci][y * cv + v, x * ch + u][ZIGZAG]
                        s, bits = _category(blk[0] - pred[ci])
                        pred[ci] = int(blk[0])
                        bw.put(DC_TABLE[2][s], 4)
                        bw.put(bits, s)
                        run = 0
                        last = int(np.flatnonzero(blk[1:])[-1]) + 1 if blk[1:].any() else 0
                        for k in range(1, last + 1):
                            if blk[k] == 0:
                                run += 1
                                continue
                            while run > 15:
                                bw.put(AC_TABLE[2][0xF0], 8)
                                run -= 16
                            s, bits = _category(blk[k])
                            bw.put(AC_TABLE[2][(run << 4) | s], 8)
                            bw.put(bits, s)
                            run = 0
                        if last < 63:
                            bw.put(AC_TABLE[2][0x00], 8)
    scan += bw.flush()

    ids = (82, 71, 66) if adobe_rgb else (1, 2, 3)
    out = bytes([0xFF, 0xD8])
    if adobe_rgb:
        out += _segment(0xEE, b"Adobe" + bytes([0, 100, 0, 0, 0, 0, 0]))
    else:
        out += _segment(0xE0, b"JFIF\0" + bytes([1, 1, 0, 0, 1, 0, 1, 0, 0]))
    out += app + _segment(0xDB, bytes([0]) + bytes(quant[ZIGZAG].astype(np.uint8)))
    sof = h.to_bytes(2, "big") + w.to_bytes(2, "big") + bytes([len(planes)])
    for ci, (ch, cv) in enumerate(sampling):
        sof += bytes([ids[ci], (ch << 4) | cv, 0])
    out += _segment(0xC0, bytes([8]) + sof)
    for tc, (counts, symbols, _) in ((0, DC_TABLE), (1, AC_TABLE)):
        out += _segment(0xC4, bytes([tc << 4]) + bytes(counts) + bytes(symbols))
    if restart:
        out += _segment(0xDD, restart.to_bytes(2, "big"))
    sos = bytes([len(planes)]) + b"".join(bytes([ids[ci], 0x00]) for ci in range(len(planes)))
    out += _segment(0xDA, sos + bytes([0, 63, 0]))
    return out + scan + bytes([0xFF, 0xD9])


# -- the committed fixtures ------------------------------------------------------------


def pillow_jpeg(image: np.ndarray, **save_kw) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(image).save(buf, "JPEG", **save_kw)
    return buf.getvalue()


def pillow_decode(data: bytes) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(data)))


def fixture_files() -> dict:
    """{path relative to ROOT: JPEG bytes}."""
    files = {
        "frame_420_q95.jpg": pillow_jpeg(content(*FRAME, seed=1), quality=95, subsampling="4:2:0"),
        "frame_420_q90_progressive.jpg": pillow_jpeg(content(*FRAME, seed=2), quality=90,
                                                     subsampling="4:2:0", progressive=True),
        "small_422_q75_restart.jpg": pillow_jpeg(content(121, 97, seed=3), quality=75,
                                                 subsampling="4:2:2", restart_marker_blocks=5),
        "small_gray_q50.jpg": pillow_jpeg(content(37, 53, seed=4, gray=True), quality=50),
        "small_411.jpg": encode_baseline(content(53, 75, seed=5), ((4, 1), (1, 1), (1, 1))),
        "small_440.jpg": encode_baseline(content(45, 37, seed=6), ((1, 2), (1, 1), (1, 1))),
        "small_adobe_rgb.jpg": encode_baseline(content(29, 41, seed=7), adobe_rgb=True,
                                               restart=3),
    }
    for i, (stem, (h, w)) in enumerate(VOC_FRAMES):
        files[f"VOCdevkit/VOC2012/JPEGImages/{stem}.jpg"] = pillow_jpeg(
            content(h, w, seed=10 + i, sigma=1.0), quality=75, subsampling="4:2:0")
    return files


def fixture_paths() -> list[pathlib.Path]:
    return sorted(p for p in ROOT.rglob("*.jpg"))


def expected() -> dict:
    """{path relative to ROOT: Pillow's array} from expected.npz."""
    with np.load(EXPECTED) as z:
        return {k: np.cumsum(z[k], axis=1, dtype=np.uint8) for k in z.files}


def main():
    ROOT.mkdir(parents=True, exist_ok=True)
    arrays = {}
    for rel, data in fixture_files().items():
        path = ROOT / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(data)
        a = pillow_decode(data)
        d = a.copy()
        d[:, 1:] -= a[:, :-1]
        arrays[rel] = d
    np.savez_compressed(EXPECTED, **arrays)
    total = sum(p.stat().st_size for p in ROOT.rglob("*") if p.is_file())
    print(f"{len(arrays)} fixtures and {EXPECTED.name} under {ROOT}: {total / 1e6:.3f} MB")


if __name__ == "__main__":
    main()
