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
S420 = ((2, 2), (1, 1), (1, 1))
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


# -- encoders for the modes Pillow does not write ------------------------------------

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
# colour coding -> (component ids, APP14 transform or None for a JFIF APP0,
# "none" for no APP segment)
COLOURS = {"ycc": ((1, 2, 3), None), "rgb": ((82, 71, 66), 0), "gray": ((1,), None),
           "cmyk": ((67, 77, 89, 75), 0), "ycck": ((1, 2, 3, 4), 2),
           "cmyk_plain": ((67, 77, 89, 75), "none"), "rgb_plain": ((1, 2, 3), "none"),
           "two": ((1, 2), "none")}
# libjpeg's jpeg_simple_progression for YCbCr: (components, Ss, Se, Ah, Al)
PROGRESSION_3 = [((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((2,), 1, 63, 0, 1),
                 ((1,), 1, 63, 0, 1), ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1),
                 ((0, 1, 2), 0, 0, 1, 0), ((2,), 1, 63, 1, 0), ((1,), 1, 63, 1, 0),
                 ((0,), 1, 63, 1, 0)]


def progression(n: int) -> list:
    """PROGRESSION_3, or for n components libjpeg's per-component pattern:
    DC first, two AC bands at Al 2, their refinement to Al 1, DC refine, the
    last AC refinement."""
    if n == 3:
        return PROGRESSION_3
    comps = tuple(range(n))
    return ([(comps, 0, 0, 0, 1)]
            + [((ci,), ss, se, ah, al) for ci in comps
               for ss, se, ah, al in ((1, 5, 0, 2), (6, 63, 0, 2), (1, 63, 2, 1))]
            + [(comps, 0, 0, 1, 0)] + [((ci,), 1, 63, 1, 0) for ci in comps])


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
LOSSLESS_TABLE = _fixed_table(list(range(17)), 5)   # difference categories 0-16
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


# T.81 Table D.2 (libjpeg's jaricom.c): Qe, Next_Index_LPS, Next_Index_MPS and
# the states whose LPS switches the MPS sense; entry 113 is the fixed 0.5 bin
QE = [
    0x5a1d, 0x2586, 0x1114, 0x080b, 0x03d8, 0x01da, 0x00e5, 0x006f, 0x0036, 0x001a, 0x000d,
    0x0006, 0x0003, 0x0001, 0x5a7f, 0x3f25, 0x2cf2, 0x207c, 0x17b9, 0x1182, 0x0cef, 0x09a1,
    0x072f, 0x055c, 0x0406, 0x0303, 0x0240, 0x01b1, 0x0144, 0x00f5, 0x00b7, 0x008a, 0x0068,
    0x004e, 0x003b, 0x002c, 0x5ae1, 0x484c, 0x3a0d, 0x2ef1, 0x261f, 0x1f33, 0x19a8, 0x1518,
    0x1177, 0x0e74, 0x0bfb, 0x09f8, 0x0861, 0x0706, 0x05cd, 0x04de, 0x040f, 0x0363, 0x02d4,
    0x025c, 0x01f8, 0x01a4, 0x0160, 0x0125, 0x00f6, 0x00cb, 0x00ab, 0x008f, 0x5b12, 0x4d04,
    0x412c, 0x37d8, 0x2fe8, 0x293c, 0x2379, 0x1edf, 0x1aa9, 0x174e, 0x1424, 0x119c, 0x0f6b,
    0x0d51, 0x0bb6, 0x0a40, 0x5832, 0x4d1c, 0x438e, 0x3bdd, 0x34ee, 0x2eae, 0x299a, 0x2516,
    0x5570, 0x4ca9, 0x44d9, 0x3e22, 0x3824, 0x32b4, 0x2e17, 0x56a8, 0x4f46, 0x47e5, 0x41cf,
    0x3c3d, 0x375e, 0x5231, 0x4c0f, 0x4639, 0x415e, 0x5627, 0x50e7, 0x4b85, 0x5597, 0x504f,
    0x5a10, 0x5522, 0x59eb, 0x5a1d]
NEXT_LPS = [
    1, 14, 16, 18, 20, 23, 25, 28, 30, 33, 35, 9, 10, 12, 15, 36, 38, 39, 40, 42, 43, 45, 46,
    48, 49, 51, 52, 54, 56, 57, 59, 60, 62, 63, 32, 33, 37, 64, 65, 67, 68, 69, 70, 72, 73, 74,
    75, 77, 78, 79, 48, 50, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 61, 61, 65, 80, 81, 82, 83,
    84, 86, 87, 87, 72, 72, 74, 74, 75, 77, 77, 80, 88, 89, 90, 91, 92, 93, 86, 88, 95, 96, 97,
    99, 99, 93, 95, 101, 102, 103, 104, 99, 105, 106, 107, 103, 105, 108, 109, 110, 111, 110,
    112, 112, 113]
NEXT_MPS = [min(i + 1, 113) for i in range(114)]
for _i, _n in ((13, 13), (35, 9), (63, 32), (79, 48), (87, 71), (94, 86), (100, 93), (104, 99),
               (107, 103), (109, 107), (111, 109), (112, 111)):
    NEXT_MPS[_i] = _n
SWITCH_MPS = {0, 14, 36, 64, 80, 88, 95, 105, 110, 112}


class _ArithWriter:
    """T.81 Annex D's encoder as libjpeg's jcarith.c writes it: a state byte
    per context (index | MPS << 7), byte stuffing and carry handling inside,
    and the termination that drops trailing zero bytes."""

    def __init__(self):
        self.out = bytearray()
        self.reset()

    def reset(self):
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = 0, 0x10000, 0, 0, 11, -1

    def _emit(self, byte: int):
        self.out.append(byte)

    def _zeros(self):
        while self.zc:
            self._emit(0)
            self.zc -= 1

    def encode(self, stats, i: int, val: int):
        sv = stats[i]
        s = sv & 0x7F
        qe = QE[s]
        self.a -= qe
        if val != sv >> 7:
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            stats[i] = ((sv & 0x80) ^ (0x80 if s in SWITCH_MPS else 0)) | NEXT_LPS[s]
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            stats[i] = (sv & 0x80) | NEXT_MPS[s]
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    if self.buffer >= 0:
                        self._zeros()
                        self._emit(self.buffer + 1)
                        if self.buffer + 1 == 0xFF:
                            self._emit(0)
                    self.zc += self.sc
                    self.sc = 0
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    if self.buffer == 0:
                        self.zc += 1
                    elif self.buffer >= 0:
                        self._zeros()
                        self._emit(self.buffer)
                    if self.sc:
                        self._zeros()
                        for _ in range(self.sc):
                            self._emit(0xFF)
                            self._emit(0)
                        self.sc = 0
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def flush(self) -> bytes:
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._zeros()
                self._emit(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self._emit(0)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._zeros()
                self._emit(self.buffer)
            if self.sc:
                self._zeros()
                for _ in range(self.sc):
                    self._emit(0xFF)
                    self._emit(0)
                self.sc = 0
        if self.c & 0x7FFF800:
            self._zeros()
            for shift, mask in ((19, None), (11, 0x7F800)):
                if mask is not None and not self.c & mask:
                    break
                byte = (self.c >> shift) & 0xFF
                self._emit(byte)
                if byte == 0xFF:
                    self._emit(0)
        self.zc = 0
        data, self.out = bytes(self.out), bytearray()
        self.reset()
        return data


class _ArithCoder:
    """The coefficient models of jcarith.c: statistics per table (64 DC and
    256 AC bins), DC contexts per component, the fixed 0.5 bin; `dac` gives
    the conditioning (L, U) and K of table 0 (defaults 0, 1 and 5)."""

    def __init__(self, n_comps: int, dac=None):
        self.w = _ArithWriter()
        self.L, self.U, self.K = dac or (0, 1, 5)
        self.n = n_comps

    def start(self, ss: int, ah: int, sequential: bool):
        """Statistics and predictions reset at a scan's start and each restart."""
        if sequential or (ss == 0 and ah == 0):
            self.dc_stats = bytearray(64)
            self.last_dc = [0] * self.n
            self.ctx = [0] * self.n
        if sequential or ss:
            self.ac_stats = bytearray(256)
        self.fixed = bytearray([113, 0, 0, 0])

    def _magnitude(self, stats, st, v, x_bin: int, dc: bool):
        """Figure F.8 for v >= 1 from bin st, its X bins from x_bin (a DC
        value goes there after one decision, an AC value after two); returns
        (the top bit m, the last bin, v - 1)."""
        e = self.w
        m = 0
        v -= 1
        if v:
            e.encode(stats, st, 1)
            m = 1
            v2 = v
            if dc:
                st = x_bin
                while v2 >> 1:
                    v2 >>= 1
                    e.encode(stats, st, 1)
                    m <<= 1
                    st += 1
            else:
                v2 >>= 1
                if v2:
                    e.encode(stats, st, 1)
                    m <<= 1
                    st = x_bin
                    while v2 >> 1:
                        v2 >>= 1
                        e.encode(stats, st, 1)
                        m <<= 1
                        st += 1
        e.encode(stats, st, 0)
        return m, st, v

    def dc(self, ci, value):
        e, stats = self.w, self.dc_stats
        st = self.ctx[ci]
        v = value - self.last_dc[ci]
        if v == 0:
            e.encode(stats, st, 0)
            self.ctx[ci] = 0
            return
        self.last_dc[ci] = value
        e.encode(stats, st, 1)
        if v > 0:
            e.encode(stats, st + 1, 0)
            st += 2
            self.ctx[ci] = 4
        else:
            v = -v
            e.encode(stats, st + 1, 1)
            st += 3
            self.ctx[ci] = 8
        m, st, v = self._magnitude(stats, st, v, 20, dc=True)
        if m < (1 << self.L) >> 1:
            self.ctx[ci] = 0
        elif m > (1 << self.U) >> 1:
            self.ctx[ci] += 8
        st += 14
        while m >> 1:
            m >>= 1
            e.encode(stats, st, 1 if m & v else 0)

    def _ac_value(self, k, v):
        """Sign (fixed bin), magnitude category and bits of a nonzero AC value."""
        e, stats = self.w, self.ac_stats
        st = 3 * (k - 1)
        e.encode(self.fixed, 0, 0 if v > 0 else 1)
        st += 2
        m, st, v = self._magnitude(stats, st, abs(v), 189 if k <= self.K else 217, dc=False)
        st += 14
        while m >> 1:
            m >>= 1
            e.encode(stats, st, 1 if m & v else 0)

    def ac(self, zz, ss, se):
        """Figure F.5 / G.10 over zz[ss..se] (zigzag order, already shifted by Al)."""
        e, stats = self.w, self.ac_stats
        ke = se
        while ke > 0 and ke >= ss and zz[ke] == 0:
            ke -= 1
        k = ss
        while k <= ke:
            e.encode(stats, 3 * (k - 1), 0)
            while zz[k] == 0:
                e.encode(stats, 3 * (k - 1) + 1, 0)
                k += 1
            e.encode(stats, 3 * (k - 1) + 1, 1)
            self._ac_value(k, zz[k])
            k += 1
        if k <= se:
            e.encode(stats, 3 * (k - 1), 1)

    def dc_refine(self, bit):
        self.w.encode(self.fixed, 0, bit)

    def ac_refine(self, zz, ss, se, al):
        """Figure G.10's refinement: zz holds the block's coefficients."""
        e, stats = self.w, self.ac_stats
        mag = [abs(int(x)) for x in zz]
        ke = se
        while ke > 0 and not mag[ke] >> al:
            ke -= 1
        kex = ke
        while kex > 0 and not mag[kex] >> (al + 1):
            kex -= 1
        k = ss
        while k <= ke:
            st = 3 * (k - 1)
            if k > kex:
                e.encode(stats, st, 0)
            while True:
                v = mag[k] >> al
                if v:
                    if v >> 1:
                        e.encode(stats, st + 2, v & 1)
                    else:
                        e.encode(stats, st + 1, 1)
                        e.encode(self.fixed, 0, 1 if zz[k] < 0 else 0)
                    break
                e.encode(stats, st + 1, 0)
                st += 3
                k += 1
            k += 1
        if k <= se:
            e.encode(stats, 3 * (k - 1), 1)


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


def _ycc(r, g, b):
    return [0.299 * r + 0.587 * g + 0.114 * b, -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
            0.5 * r - 0.418688 * g - 0.081312 * b + 128]


def _planes(img: np.ndarray, colour: str) -> list:
    """The image as the file's component planes (float). A four-channel image
    is the CMYK array Pillow presents, whose file samples are inverted."""
    ch = [img[..., i].astype(np.float64) for i in range(img.shape[2])] if img.ndim == 3 \
        else [img.astype(np.float64)]
    if colour == "ycc":
        return _ycc(*ch)
    if colour == "ycck":       # jccolor.c cmyk_ycck_convert of the file's CMYK samples
        return _ycc(*ch[:3]) + [255 - ch[3]]
    if colour in ("cmyk", "cmyk_plain"):
        return [255 - c for c in ch]
    return ch


def _headers(colour: str, app: bytes) -> bytes:
    out = bytes([0xFF, 0xD8])
    transform = COLOURS[colour][1]
    if transform is None:
        out += _segment(0xE0, b"JFIF\0" + bytes([1, 1, 0, 0, 1, 0, 1, 0, 0]))
    elif transform != "none":
        out += _segment(0xEE, b"Adobe" + bytes([0, 100, 0, 0, 0, 0, transform]))
    return out + app


def _sof(marker: int, precision: int, h: int, w: int, ids, sampling) -> bytes:
    sof = bytes([precision]) + h.to_bytes(2, "big") + w.to_bytes(2, "big") + bytes([len(ids)])
    for cid, (ch, cv) in zip(ids, sampling):
        sof += bytes([cid, (ch << 4) | cv, 0])
    return _segment(marker, sof)


def _scan_mcus(comps, sampling, geometry):
    """The MCUs of a scan over `comps`: lists of (component, block row, block
    column); one block an MCU over the component's own blocks when alone."""
    (mx, my), dims = geometry
    if len(comps) == 1:
        ci = comps[0]
        wib, hib = dims[ci]
        return [[(ci, by, bx)] for by in range(hib) for bx in range(wib)]
    return [[(ci, y * sampling[ci][1] + v, x * sampling[ci][0] + u)
             for ci in comps for v in range(sampling[ci][1]) for u in range(sampling[ci][0])]
            for y in range(my) for x in range(mx)]


def _entropy_segments(mcus, restart: int, start, code, flush) -> bytes:
    """The scan's entropy-coded data, with RSTn markers every `restart` MCUs."""
    out = b""
    start()
    for n, mcu in enumerate(mcus):
        if restart and n and n % restart == 0:
            out += flush() + bytes([0xFF, 0xD0 + (n // restart - 1) % 8])
            start()
        code(mcu)
    return out + flush()


def encode(image: np.ndarray, sampling=None, colour: str | None = None, restart: int = 0,
           quality: int = 80, app: bytes = b"", arithmetic: bool = False,
           progressive: bool = False, dac=None) -> bytes:
    """A JPEG of (H, W, 3), (H, W, 4) or (H, W) uint8 with the given
    per-component sampling factors, one quantization table for `quality`, an
    optional restart interval and `app` (whole marker segments) after the
    JFIF or Adobe one. Huffman coding is baseline with fixed-length codes;
    arithmetic coding (SOF9, or SOF10 with libjpeg's simple progression) has
    a DAC segment when `dac` = (L, U, K) is given."""
    img = np.asarray(image)
    colour = colour or {2: "gray", 3: "ycc", 4: "cmyk"}[img.ndim if img.ndim == 2 else img.shape[2]]
    ids = COLOURS[colour][0]
    sampling = tuple(sampling or ((1, 1),) * len(ids))
    quant = quant_table(quality)
    h, w = img.shape[:2]
    hmax, vmax = max(s[0] for s in sampling), max(s[1] for s in sampling)
    mx, my = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    coefs, dims = [], []
    for plane, (ch, cv) in zip(_planes(img, colour), sampling):
        fy, fx = vmax // cv, hmax // ch
        p = np.pad(plane, ((0, -h % fy), (0, -w % fx)), mode="edge")
        p = p.reshape(p.shape[0] // fy, fy, p.shape[1] // fx, fx).mean((1, 3))
        coefs.append(_blocks(np.clip(np.rint(p), 0, 255), my * cv, mx * ch, quant)[..., ZIGZAG])
        dims.append((-(-(-(-w * ch // hmax)) // 8), -(-(-(-h * cv // vmax)) // 8)))
    geometry = ((mx, my), dims)

    out = _headers(colour, app) + _segment(0xDB, bytes([0]) + bytes(quant[ZIGZAG].astype(np.uint8)))
    marker = (0xCA if progressive else 0xC9) if arithmetic else 0xC0
    out += _sof(marker, 8, h, w, ids, sampling)
    if not arithmetic:
        for tc, (counts, symbols, _) in ((0, DC_TABLE), (1, AC_TABLE)):
            out += _segment(0xC4, bytes([tc << 4]) + bytes(counts) + bytes(symbols))
    elif dac is not None:
        out += _segment(0xCC, bytes([0x00, (dac[1] << 4) | dac[0], 0x10, dac[2]]))
    if restart:
        out += _segment(0xDD, restart.to_bytes(2, "big"))
    all_comps = tuple(range(len(ids)))
    if not progressive:
        scans = [(all_comps, 0, 63, 0, 0)]
    else:
        scans = progression(len(ids))
    for comps, ss, se, ah, al in scans:
        sos = bytes([len(comps)]) + b"".join(bytes([ids[ci], 0x00]) for ci in comps)
        out += _segment(0xDA, sos + bytes([ss, se, (ah << 4) | al]))
        mcus = _scan_mcus(comps, sampling, geometry)
        if not arithmetic:
            out += _huffman_scan(mcus, coefs, restart, len(ids))
        else:
            out += _arithmetic_scan(mcus, coefs, restart, len(ids), comps, (ss, se, ah, al), dac)
    return out + bytes([0xFF, 0xD9])


def _huffman_scan(mcus, coefs, restart, n_comps) -> bytes:
    bw, pred = _BitWriter(), [0] * n_comps

    def start():
        pred[:] = [0] * n_comps

    def code(mcu):
        for ci, by, bx in mcu:
            blk = coefs[ci][by, bx]
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

    return _entropy_segments(mcus, restart, start, code, bw.flush)


def _arithmetic_scan(mcus, coefs, restart, n_comps, comps, params, dac) -> bytes:
    ss, se, ah, al = params
    coder = _ArithCoder(n_comps, dac)
    sequential = (ss, se, ah, al) == (0, 63, 0, 0)

    def code(mcu):
        for ci, by, bx in mcu:
            blk = [int(x) for x in coefs[ci][by, bx]]
            if ss == 0 and ah == 0:
                coder.dc(ci, blk[0] >> al)
            elif ss == 0:
                coder.dc_refine((blk[0] >> al) & 1)
            if sequential:
                coder.ac(blk, 1, 63)
            elif ss and not ah:
                coder.ac([(abs(x) >> al) * (1 if x >= 0 else -1) for x in blk], ss, se)
            elif ss:
                coder.ac_refine(blk, ss, se, al)

    def start():
        coder.start(ss, ah, sequential)

    return _entropy_segments(mcus, restart, start, code, coder.w.flush)


def encode_baseline(image: np.ndarray, sampling=((1, 1), (1, 1), (1, 1)), restart: int = 0,
                    adobe_rgb: bool = False, quality: int = 80, app: bytes = b"") -> bytes:
    """A baseline JPEG of (H, W, 3) uint8 (YCbCr unless adobe_rgb) or (H, W)
    uint8: `encode` with Huffman coding."""
    img = np.asarray(image)
    if img.ndim == 2:
        return encode(img, restart=restart, quality=quality, app=app)
    return encode(img, sampling, "rgb" if adobe_rgb else "ycc", restart, quality, app)


def encode_lossless(image: np.ndarray, predictor: int = 1, point_transform: int = 0,
                    colour: str | None = None, sampling=None, restart: int = 0,
                    app: bytes = b"") -> bytes:
    """A lossless (SOF3) JPEG of (H, W), (H, W, 3) or (H, W, 4) uint8 at 8-bit
    precision in one interleaved scan (one component: one sample an MCU):
    T.81 Annex H's predictor (1-7; the first row of each restart interval
    predicts from the left, the first column from above, the first sample
    2^(7 - Pt)) and the differences in fixed-length Huffman codes. A
    component's samples are the plane's box means over its sampling ratio."""
    img = np.asarray(image)
    colour = colour or {2: "gray", 3: "rgb_plain", 4: "cmyk"}[img.ndim if img.ndim == 2
                                                             else img.shape[2]]
    ids = COLOURS[colour][0]
    sampling = tuple(sampling or ((1, 1),) * len(ids))
    h, w = img.shape[:2]
    hmax, vmax = max(c[0] for c in sampling), max(c[1] for c in sampling)
    planes = []
    for plane, (ch, cv) in zip(_planes(img, colour), sampling):
        fy, fx = vmax // cv, hmax // ch
        p = np.pad(plane, ((0, -h % fy), (0, -w % fx)), mode="edge")
        p = p.reshape(p.shape[0] // fy, fy, p.shape[1] // fx, fx).mean((1, 3))
        planes.append(np.clip(np.rint(p), 0, 255).astype(np.int64) >> point_transform)
    out = _headers(colour, app) + _sof(0xC3, 8, h, w, ids, sampling)
    counts, symbols, _ = LOSSLESS_TABLE
    out += _segment(0xC4, bytes([0x00]) + bytes(counts) + bytes(symbols))
    if restart:
        out += _segment(0xDD, restart.to_bytes(2, "big"))
    sos = bytes([len(ids)]) + b"".join(bytes([cid, 0x00]) for cid in ids)
    out += _segment(0xDA, sos + bytes([predictor, 0, point_transform]))
    if len(ids) == 1:
        sampling = ((1, 1),)
        mx, my = w, h
    else:
        mx, my = -(-w // hmax), -(-h // vmax)
    pad = [np.pad(p, ((0, my * cv - p.shape[0]), (0, mx * ch - p.shape[1])), mode="edge")
           for p, (ch, cv) in zip(planes, sampling)]
    bw = _BitWriter()
    initial = 1 << (8 - point_transform - 1)
    first_rows = set()

    def code(p, y, x):
        if y in first_rows:
            pred = initial if x == 0 else p[y, x - 1]
        elif x == 0:
            pred = p[y - 1, x]
        else:
            ra, rb, rc = int(p[y, x - 1]), int(p[y - 1, x]), int(p[y - 1, x - 1])
            pred = [None, ra, rb, rc, ra + rb - rc, ra + ((rb - rc) >> 1),
                    rb + ((ra - rc) >> 1), (ra + rb) >> 1][predictor]
        diff = (int(p[y, x]) - int(pred)) & 0xFFFF
        diff = diff - 0x10000 if diff > 0x8000 else diff
        s, bits = _category(diff)
        bw.put(LOSSLESS_TABLE[2][s], 5)
        if s < 16:
            bw.put(bits, s)

    for n in range(mx * my):
        my_i, mx_i = divmod(n, mx)
        if (restart and n % restart == 0) or n == 0:
            if n:
                out += bw.flush() + bytes([0xFF, 0xD0 + (n // restart - 1) % 8])
            first_rows = {my_i * cv for _, cv in sampling}
        elif mx_i == 0:
            first_rows = set()
        for p, (ch, cv) in zip(pad, sampling):
            for v in range(cv):
                for u in range(ch):
                    code(p, my_i * cv + v, mx_i * ch + u)
    out += bw.flush()
    return out + bytes([0xFF, 0xD9])


# -- the committed fixtures ------------------------------------------------------------


def pillow_jpeg(image: np.ndarray, **save_kw) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    mode = "CMYK" if image.ndim == 3 and image.shape[2] == 4 else None
    Image.fromarray(image, mode).save(buf, "JPEG", **save_kw)
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
        "small_arith_420_restart_dac.jpg": encode(content(53, 75, seed=11), S420, restart=4,
                                                  arithmetic=True, dac=(1, 4, 3)),
        "small_arith_gray.jpg": encode(content(37, 53, seed=12, gray=True), arithmetic=True),
        "small_arith_progressive_422.jpg": encode(content(61, 43, seed=13),
                                                  ((2, 1), (1, 1), (1, 1)), restart=5,
                                                  arithmetic=True, progressive=True),
        "frame_arith_420_q90.jpg": encode(content(*FRAME, seed=14), S420, quality=90,
                                          arithmetic=True),
        "small_cmyk_q90.jpg": pillow_jpeg(cmyk_content(41, 29, seed=15), quality=90),
        "frame_cmyk_q90.jpg": pillow_jpeg(cmyk_content(*FRAME, seed=16), quality=90),
        "small_ycck_2211.jpg": encode(cmyk_content(45, 51, seed=17),
                                      ((2, 2), (1, 1), (1, 1), (2, 2)), colour="ycck"),
        "small_lossless_rgb_p4.jpg": encode_lossless(content(37, 53, seed=18), 4),
        "small_lossless_gray_p7_pt2_restart.jpg": encode_lossless(
            content(33, 29, seed=19, gray=True), 7, 2, restart=29 * 3),
        "small_lossless_420_p6.jpg": encode_lossless(content(27, 35, seed=20), 6,
                                                     sampling=S420),
        "small_progressive_cut_4_scans.jpg": progressive_cut((121, 97), seed=21, n_scans=4),
        "small_progressive_cut_dc_only.jpg": progressive_cut((45, 61), seed=22, n_scans=1),
    }
    for i, (stem, (h, w)) in enumerate(VOC_FRAMES):
        files[f"VOCdevkit/VOC2012/JPEGImages/{stem}.jpg"] = pillow_jpeg(
            content(h, w, seed=10 + i, sigma=1.0), quality=75, subsampling="4:2:0")
    return files


def cmyk_content(h: int, w: int, seed: int) -> np.ndarray:
    """(h, w, 4) uint8: content() as C, M, Y and a smooth K plane."""
    return np.concatenate([content(h, w, seed), content(h, w, seed + 100)[..., 1:2] // 2], -1)


def fixture_paths() -> list[pathlib.Path]:
    return sorted(p for p in ROOT.rglob("*.jpg"))


def expected() -> dict:
    """{path relative to ROOT: Pillow's array} from expected.npz."""
    with np.load(EXPECTED) as z:
        return {k: np.cumsum(z[k], axis=1, dtype=np.uint8) for k in z.files}


def progressive_cut(size, seed: int, n_scans: int, quality: int = 75,
                    subsampling: str = "4:2:0") -> bytes:
    """A Pillow progressive file cut after its first n_scans scans (its DC
    scan, then luma's first band, then the chroma bands): AC bits stay
    unknown, so libjpeg smooths its blocks (jdcoefct.c); with the DC scan
    alone it estimates the DC too."""
    prog = pillow_jpeg(content(*size, seed=seed, gray=subsampling == "gray"), quality=quality,
                       progressive=True, **({} if subsampling == "gray"
                                            else {"subsampling": subsampling}))
    sos = [i for i in range(len(prog) - 1) if prog[i] == 0xFF and prog[i + 1] == 0xDA]
    return prog[:sos[n_scans]] + b"\xff\xd9"


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
