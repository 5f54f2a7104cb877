"""JPEG decoding in numpy, equal to Pillow's bit for bit.

The JAX package reads its JPEG frames, backgrounds and textures with Pillow,
which decodes through libjpeg-turbo with its defaults: the accurate integer
IDCT (`jpeg_idct_islow`, jidctint.c), fancy upsampling (jdsample.c), the
table-driven YCbCr -> RGB conversion (jdcolor.c), the arithmetic decoder
(jdarith.c), the lossless one (jdlhuff.c, jdlossls.c) and block smoothing
(jdcoefct.c). This module repeats
those steps in integer arithmetic, so `decode` returns what
`np.asarray(PIL.Image.open(path))` gives: (H, W) uint8 for one component
(mode L), (H, W, 3) RGB for three, (H, W, 4) CMYK for four (Pillow's raw mode
CMYK;I: the samples inverted, as Adobe writes them).

It is the plain version of csrc/jpeg_decode.cpp (utils/jpeg_cext.py), which
every runtime path calls; this one is for the tests and for holding the
library to it. `image_size` reads (height, width) from the frame header alone.

What Pillow 12.1 (libjpeg-turbo 3.1) does with each mode, and so this decoder:

  mode                                          Pillow                  here
  SOF0/SOF1 baseline and extended, Huffman      decodes                 decodes
  SOF2 progressive, Huffman                     decodes                 decodes
  SOF9 sequential, arithmetic (DAC, restarts)   decodes                 decodes
  SOF10 progressive, arithmetic                 decodes                 decodes
  SOF3 lossless, Huffman, 8-bit, predictors
    1-7, point transform, L / RGB / CMYK        decodes (replicated     decodes
                                                upsampling)
  SOF3 of YCbCr or YCCK colour                  OSError                 JPEGError
  SOF3 restart interval not whole MCU rows      OSError                 JPEGError
  SOF11 lossless, arithmetic                    OSError                 JPEGError
  SOF5-7, SOF13-15, DHP, EXP (hierarchical)     OSError                 JPEGError
  precision other than 8 bits (2-16)            UnidentifiedImageError  JPEGError
  four components: Adobe CMYK (transform 0 or
    no APP14) and YCCK (transform 2)            decodes (mode CMYK)     decodes
  two components                                UnidentifiedImageError  JPEGError
  a progressive file whose scans leave low-
    frequency AC bits unknown (cut short)       decodes, smoothing      decodes,
                                                blocks (jdcoefct.c)     smoothing

Sampling: interleaved and non-interleaved scans, 8- and 16-bit quantization
tables, restart intervals and any sampling factors whose ratios are whole
numbers. Everything refused raises JPEGError naming the marker and the file,
as does truncated or corrupt data. Nothing falls back.
"""

from __future__ import annotations

import numpy as np

SOI, EOI, SOS, DQT, DHT, DRI, DNL, COM, DAC = 0xD8, 0xD9, 0xDA, 0xDB, 0xC4, 0xDD, 0xDC, 0xFE, 0xCC
# frame marker -> (progressive, arithmetic, lossless)
SOF_DECODED = {0xC0: (False, False, False), 0xC1: (False, False, False),
               0xC2: (True, False, False), 0xC3: (False, False, True),
               0xC9: (False, True, False), 0xCA: (True, True, False)}
SOF_REFUSED = {
    0xC5: "hierarchical coding (SOF5)", 0xC6: "hierarchical coding (SOF6)",
    0xC7: "hierarchical coding (SOF7)", 0xCB: "lossless arithmetic coding (SOF11)",
    0xCD: "hierarchical coding (SOF13)", 0xCE: "hierarchical coding (SOF14)",
    0xCF: "hierarchical coding (SOF15)",
    0xDE: "hierarchical coding (DHP)", 0xDF: "hierarchical coding (EXP)",
}
NOT_FRAMES = (0xDE, 0xDF)    # refused markers that are not frame headers
MODES = {1: "L", 3: "RGB", 4: "CMYK"}    # component count -> Pillow's mode
NUM_ARITH_TBLS = 16
DC_STAT_BINS, AC_STAT_BINS = 64, 256

# zigzag index -> natural (row-major) index
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63], np.int64)
_ZZ = ZIGZAG.tolist()

# jidctint.c
CONST_BITS, PASS1_BITS = 13, 2
FIX_0_298631336, FIX_0_390180644, FIX_0_541196100 = 2446, 3196, 4433
FIX_0_765366865, FIX_0_899976223, FIX_1_175875602 = 6270, 7373, 9633
FIX_1_501321110, FIX_1_847759065, FIX_1_961570560 = 12299, 15137, 16069
FIX_2_053119869, FIX_2_562915447, FIX_3_072711026 = 16819, 20995, 25172
RANGE_MASK = 1023   # MAXJSAMPLE * 4 + 3

# jdcolor.c
SCALEBITS = 16
ONE_HALF = 1 << (SCALEBITS - 1)
MAX_BLOCKS_IN_MCU = 10   # D_MAX_BLOCKS_IN_MCU
SMOOTHING_COEFS = 10     # jdcoefct.c SAVED_COEFS: the coefficients block smoothing looks at


class JPEGError(ValueError):
    pass


def _fix(x: float) -> int:
    return int(x * (1 << SCALEBITS) + 0.5)


def _colour_tables():
    """build_ycc_rgb_table: Cr->R, Cb->B, and the summed, half-biased Cb/Cr->G."""
    x = np.arange(256, dtype=np.int64) - 128
    cr_r = (_fix(1.40200) * x + ONE_HALF) >> SCALEBITS
    cb_b = (_fix(1.77200) * x + ONE_HALF) >> SCALEBITS
    cr_g = -_fix(0.71414) * x
    cb_g = -_fix(0.34414) * x + ONE_HALF
    return cr_r, cb_b, cr_g, cb_g


CR_R, CB_B, CR_G, CB_G = _colour_tables()


def _idct_range_limit() -> np.ndarray:
    """prepare_range_limit_table's post-IDCT part, indexed by x & RANGE_MASK:
    x in [0, 127] -> 128 + x, [128, 511] -> 255, [512, 895] -> 0,
    [896, 1023] -> x - 896 (the sample wraps as libjpeg's table makes it)."""
    t = np.zeros(1024, np.uint8)
    t[:128] = np.arange(128, 256)
    t[128:512] = 255
    t[896:] = np.arange(128)
    return t


IDCT_LIMIT = _idct_range_limit()


# -- markers ---------------------------------------------------------------


class _Component:
    __slots__ = ("cid", "h", "v", "tq", "dw", "dh", "bw", "bh", "wib", "hib", "coef",
                 "coef_bits", "dc_pred", "dc_ctx", "td", "ta", "pt")

    def __init__(self, cid, h, v, tq):
        self.cid, self.h, self.v, self.tq = cid, h, v, tq
        self.pt = 0    # a lossless scan's point transform


class _Frame:
    def __init__(self, name):
        self.name = name
        self.qt = {}                 # table id -> 64 ints, natural order
        self.dc, self.ac = {}, {}    # table id -> 65,536-entry lookup
        self.restart = 0
        self.progressive = self.arithmetic = self.lossless = False
        self.comps = []
        # DAC conditioning (jdmarker.c get_soi's defaults) and the statistics bins
        self.arith_dc_L = [0] * NUM_ARITH_TBLS
        self.arith_dc_U = [1] * NUM_ARITH_TBLS
        self.arith_ac_K = [5] * NUM_ARITH_TBLS
        self.dc_stats = [bytearray(DC_STAT_BINS) for _ in range(NUM_ARITH_TBLS)]
        self.ac_stats = [bytearray(AC_STAT_BINS) for _ in range(NUM_ARITH_TBLS)]
        self.fixed_bin = bytearray([113, 0, 0, 0])
        self.jfif = False
        self.adobe = None            # APP14 transform flag
        self.height = self.width = 0
        self.eobrun = 0

    def fail(self, what: str):
        raise JPEGError(f"{self.name}: {what}")


def _u16(data, p):
    return (data[p] << 8) | data[p + 1]


def _parse_sof(fr: _Frame, m, d: bytes):
    if m in SOF_REFUSED:
        fr.fail(f"{SOF_REFUSED[m]} is not decoded (marker 0xFF{m:02X})")
    if fr.comps:
        fr.fail(f"a second frame header (marker 0xFF{m:02X})")
    if len(d) < 6:
        fr.fail(f"truncated frame header (marker 0xFF{m:02X})")
    prec, fr.height, fr.width, nf = d[0], _u16(d, 1), _u16(d, 3), d[5]
    if prec != 8:
        fr.fail(f"{prec}-bit precision is not decoded (marker 0xFF{m:02X}, 8-bit only)")
    if fr.height == 0:
        fr.fail(f"a height given by a DNL marker is not decoded (marker 0xFF{m:02X})")
    if fr.width == 0:
        fr.fail(f"empty image (marker 0xFF{m:02X})")
    if nf not in MODES:
        fr.fail(f"{nf} components are not decoded (marker 0xFF{m:02X}; 1, 3 or 4)")
    if len(d) < 6 + 3 * nf:
        fr.fail(f"truncated frame header (marker 0xFF{m:02X})")
    fr.progressive, fr.arithmetic, fr.lossless = SOF_DECODED[m]
    for i in range(nf):
        cid, hv, tq = d[6 + 3 * i], d[7 + 3 * i], d[8 + 3 * i]
        h, v = hv >> 4, hv & 15
        if not (1 <= h <= 4 and 1 <= v <= 4) or tq > 3:
            fr.fail(f"bad sampling factors {h}x{v} or table {tq} (marker 0xFF{m:02X})")
        fr.comps.append(_Component(cid, h, v, tq))
    hmax = max(c.h for c in fr.comps)
    vmax = max(c.v for c in fr.comps)
    fr.hmax, fr.vmax = hmax, vmax
    unit = 1 if fr.lossless else 8      # a lossless data unit is one sample
    fr.mcux = -(-fr.width // (unit * hmax))
    fr.mcuy = -(-fr.height // (unit * vmax))
    for c in fr.comps:
        c.dw = -(-fr.width * c.h // hmax)     # downsampled_width
        c.dh = -(-fr.height * c.v // vmax)
        c.wib, c.hib = -(-c.dw // unit), -(-c.dh // unit)
        c.bw, c.bh = fr.mcux * c.h, fr.mcuy * c.v
        c.coef = [0] * (c.bw * c.bh * unit * unit)
        c.coef_bits = [-1] * 64


def _parse_dqt(fr: _Frame, d: bytes):
    p = 0
    while p < len(d):
        pq, tq = d[p] >> 4, d[p] & 15
        p += 1
        size = 128 if pq else 64
        if pq > 1 or tq > 3 or p + size > len(d):
            fr.fail("bad quantization table (marker 0xFFDB)")
        vals = ([_u16(d, p + 2 * k) for k in range(64)] if pq else list(d[p:p + 64]))
        p += size
        q = [0] * 64
        for k in range(64):
            q[_ZZ[k]] = vals[k]
        fr.qt[tq] = q


def _huffman_lookup(fr: _Frame, counts, symbols):
    """A 65,536-entry list: the next 16 bits -> (code length << 8) | symbol,
    0 where no code starts with those bits."""
    table = np.zeros(1 << 16, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            if code >= (1 << length):
                fr.fail("bad Huffman table (marker 0xFFC4)")
            lo = code << (16 - length)
            table[lo:lo + (1 << (16 - length))] = (length << 8) | symbols[k]
            code += 1
            k += 1
        code <<= 1
    return table.tolist()


def _parse_dht(fr: _Frame, d: bytes):
    p = 0
    while p < len(d):
        if p + 17 > len(d):
            fr.fail("truncated Huffman table (marker 0xFFC4)")
        tc, th = d[p] >> 4, d[p] & 15
        counts = list(d[p + 1:p + 17])
        total = sum(counts)
        p += 17
        if tc > 1 or th > 3 or total > 256 or p + total > len(d):
            fr.fail("bad Huffman table (marker 0xFFC4)")
        symbols = list(d[p:p + total])
        p += total
        (fr.ac if tc else fr.dc)[th] = _huffman_lookup(fr, counts, symbols)


def _parse_dac(fr: _Frame, d: bytes):
    """jdmarker.c get_dac: (index, value) pairs, DC tables' L and U below 16,
    AC tables' K from 16 on."""
    if len(d) % 2:
        fr.fail("bad arithmetic conditioning table (marker 0xFFCC)")
    for p in range(0, len(d), 2):
        index, val = d[p], d[p + 1]
        if index >= 2 * NUM_ARITH_TBLS:
            fr.fail(f"bad arithmetic conditioning table index {index} (marker 0xFFCC)")
        if index >= NUM_ARITH_TBLS:
            fr.arith_ac_K[index - NUM_ARITH_TBLS] = val
        else:
            fr.arith_dc_L[index], fr.arith_dc_U[index] = val & 15, val >> 4
            if val & 15 > val >> 4:
                fr.fail(f"bad arithmetic conditioning value {val} (marker 0xFFCC)")


def _parse_app(fr: _Frame, m, d: bytes):
    # jdmarker.c examine_app0 / examine_app14
    if m == 0xE0 and len(d) >= 14 and d[:5] == b"JFIF\0":
        fr.jfif = True
    elif m == 0xEE and len(d) >= 12 and d[:5] == b"Adobe":
        fr.adobe = d[11]


# -- entropy-coded data ------------------------------------------------------


def _scan_data(data: bytes, p: int, name: str):
    """The entropy-coded segments from p on, unstuffed and split at RST
    markers, the RST numbers, and the position of the marker after them."""
    segs, rsts = [], []
    start = i = p
    n = len(data)
    while True:
        i = data.find(b"\xff", i)
        if i < 0 or i + 1 >= n:
            raise JPEGError(f"{name}: truncated JPEG data (the scan runs to the end)")
        b = data[i + 1]
        if b == 0:
            i += 2
            continue
        if b == 0xFF:    # fill bytes before a marker
            j = i
            while j < n and data[j] == 0xFF:
                j += 1
            if j >= n:
                raise JPEGError(f"{name}: truncated JPEG data (the scan runs to the end)")
            b = data[j]
            if b == 0:
                raise JPEGError(f"{name}: corrupt JPEG data (a stuffed 0xFF after fill bytes, "
                                f"offset {i})")
        else:
            j = i + 1
        segs.append(data[start:i].replace(b"\xff\x00", b"\xff"))
        if 0xD0 <= b <= 0xD7:
            rsts.append(b - 0xD0)
            start = i = j + 1
            continue
        return segs, rsts, i


class _Bits:
    """MSB-first bit reader over one unstuffed segment; reading past its end
    gives zero bits, which `check_end` turns into an error."""

    __slots__ = ("seg", "pos", "acc", "n", "pad")

    def __init__(self, seg: bytes):
        self.seg, self.pos, self.acc, self.n, self.pad = seg, 0, 0, 0, 0

    def fill(self, need: int):
        seg, pos, acc, n = self.seg, self.pos, self.acc, self.n
        while n < need:
            if pos < len(seg):
                acc = (acc << 8) | seg[pos]
                pos += 1
            else:
                acc <<= 8
                self.pad += 8
            n += 8
        self.pos, self.acc, self.n = pos, acc, n

    def bits(self, k: int) -> int:
        if k == 0:
            return 0
        if self.n < k:
            self.fill(k)
        self.n -= k
        v = self.acc >> self.n
        self.acc &= (1 << self.n) - 1
        return v

    def huff(self, table, fr) -> int:
        if self.n < 16:
            self.fill(16)
        e = table[self.acc >> (self.n - 16)]
        if not e:
            fr.fail("corrupt JPEG data (bad Huffman code)")
        self.n -= e >> 8
        self.acc &= (1 << self.n) - 1
        return e & 0xFF

    def check_end(self, fr):
        if self.pos * 8 + self.pad - self.n > len(self.seg) * 8:
            fr.fail("truncated or corrupt JPEG data (a scan segment ends early)")


def _extend(v: int, s: int) -> int:
    return v - (1 << s) + 1 if v < (1 << (s - 1)) else v


# T.81 Table D.2 (libjpeg's jaricom.c): Qe, Next_Index_LPS, Next_Index_MPS, and
# the states whose LPS switches the MPS sense; state 113 is the fixed 0.5 bin
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
_MPS_JUMPS = {13: 13, 35: 9, 63: 32, 79: 48, 87: 71, 94: 86, 100: 93, 104: 99, 107: 103,
              109: 107, 111: 109, 112: 111, 113: 113}
NEXT_MPS = [_MPS_JUMPS.get(i, i + 1) for i in range(114)]
SWITCH_MPS = (0, 14, 36, 64, 80, 88, 95, 105, 110, 112)
# jaricom.c's packing: Qe << 16 | Next_Index_MPS << 8 | Switch_MPS << 7 | Next_Index_LPS
ARITAB = [(QE[i] << 16) | (NEXT_MPS[i] << 8) | ((i in SWITCH_MPS) << 7) | NEXT_LPS[i]
          for i in range(114)]


class _Arith:
    """T.81 Annex D's decoder as jdarith.c runs it over one unstuffed
    segment: a state byte per context (index | MPS << 7); past the segment's
    end it reads zero bytes, as libjpeg does after a marker."""

    __slots__ = ("seg", "pos", "c", "a", "ct")

    def __init__(self, seg: bytes):
        self.seg, self.pos, self.c, self.a, self.ct = seg, 0, 0, 0, -16

    def decode(self, st: bytearray, i: int) -> int:
        a, c, ct = self.a, self.c, self.ct
        while a < 0x8000:
            ct -= 1
            if ct < 0:
                if self.pos < len(self.seg):
                    data = self.seg[self.pos]
                    self.pos += 1
                else:
                    data = 0
                c = (c << 8) | data
                ct += 8
                if ct < 0:
                    ct += 1
                    if ct == 0:
                        a = 0x8000
            a <<= 1
        sv = st[i]
        qe = ARITAB[sv & 0x7F]
        nl, nm, qe = qe & 0xFF, (qe >> 8) & 0xFF, qe >> 16
        a -= qe
        temp = a << ct
        if c >= temp:
            c -= temp
            if a < qe:
                st[i] = (sv & 0x80) ^ nm
            else:
                st[i] = (sv & 0x80) ^ nl
                sv ^= 0x80
            a = qe
        elif a < 0x8000:
            if a < qe:
                st[i] = (sv & 0x80) ^ nl
                sv ^= 0x80
            else:
                st[i] = (sv & 0x80) ^ nm
        self.a, self.c, self.ct = a, c, ct
        return sv >> 7


def _parse_sos(fr: _Frame, d: bytes):
    ns = d[0]
    if not 1 <= ns <= 4 or len(d) < 4 + 2 * ns:
        fr.fail("bad scan header (marker 0xFFDA)")
    by_id = {c.cid: c for c in fr.comps}
    comps = []
    for i in range(ns):
        c = by_id.get(d[1 + 2 * i])
        if c is None:
            fr.fail(f"scan names component {d[1 + 2 * i]}, absent from the frame (marker 0xFFDA)")
        c.td, c.ta = d[2 + 2 * i] >> 4, d[2 + 2 * i] & 15
        comps.append(c)
    q = 1 + 2 * ns
    ss, se, ah, al = d[q], d[q + 1], d[q + 2] >> 4, d[q + 2] & 15
    if fr.lossless:     # Ss is the predictor, Al the point transform (jdlossls.c)
        bad = not 1 <= ss <= 7 or se != 0 or ah or al >= 8
    elif fr.progressive:
        bad = (ss > se or se > 63 or al > 13 or (ah and ah != al + 1)
               or (ss == 0 and se != 0) or (ss > 0 and ns != 1))
    else:
        bad = ss != 0 or se != 63 or ah or al
    if bad:
        fr.fail(f"bad scan parameters Ss={ss} Se={se} Ah={ah} Al={al} (marker 0xFFDA)")
    if ns > 1 and sum(c.h * c.v for c in comps) > MAX_BLOCKS_IN_MCU:
        fr.fail("too many blocks in an MCU (marker 0xFFDA)")
    for c in comps:
        if fr.arithmetic:
            continue    # tables 0-15, conditioned by DAC or its defaults
        if (fr.lossless or ss == 0 and (not ah or not fr.progressive)) and c.td not in fr.dc:
            fr.fail(f"no DC Huffman table {c.td} (marker 0xFFDA)")
        if se > 0 and c.ta not in fr.ac:
            fr.fail(f"no AC Huffman table {c.ta} (marker 0xFFDA)")
    if not fr.lossless:
        for c in comps:
            for k in range(ss, se + 1):
                c.coef_bits[k] = al
    return comps, ss, se, ah, al


def _mcu_blocks(fr: _Frame, comps):
    """(MCU count, a function from MCU index to [(component, block offset)]);
    a lossless file's blocks are single samples."""
    size = 1 if fr.lossless else 64
    if len(comps) == 1:
        c = comps[0]

        def blocks(i, c=c):
            return ((c, ((i // c.wib) * c.bw + i % c.wib) * size),)
        return c.wib * c.hib, blocks

    def blocks(i):
        my, mx = divmod(i, fr.mcux)
        out = []
        for c in comps:
            for v in range(c.v):
                row = (my * c.v + v) * c.bw + mx * c.h
                out.extend((c, (row + h) * size) for h in range(c.h))
        return out
    return fr.mcux * fr.mcuy, blocks


def _decode_scan(fr: _Frame, comps, ss, se, ah, al, segs, rsts):
    n_mcu, blocks = _mcu_blocks(fr, comps)
    ri = fr.restart or n_mcu
    n_int = -(-n_mcu // ri)
    if len(segs) != n_int:
        fr.fail(f"corrupt JPEG data ({len(segs)} restart intervals in a scan of {n_int})")
    for k, r in enumerate(rsts):
        if r != k % 8:
            fr.fail(f"corrupt JPEG data (RST{r} where RST{k % 8} belongs)")
    if fr.lossless:
        for c in comps:
            c.pt = al
        _lossless_scan(fr, comps, ss, segs, blocks, n_mcu, ri)
        return
    steps = _ARITH_STEPS if fr.arithmetic else _HUFFMAN_STEPS
    if fr.progressive:
        step = steps[(ss > 0, ah > 0)]
    else:
        step = steps[None]
    for s_i in range(n_int):
        if fr.arithmetic:
            bits = _Arith(segs[s_i])
            _arith_reset(fr, comps, ss, ah)
        else:
            bits = _Bits(segs[s_i])
        for c in comps:
            c.dc_pred = c.dc_ctx = 0
        fr.eobrun = 0
        for i in range(s_i * ri, min(n_mcu, (s_i + 1) * ri)):
            for c, off in blocks(i):
                step(fr, bits, c, off, ss, se, al)
        if not fr.arithmetic:
            bits.check_end(fr)


def _sequential(fr, bits, c, off, ss, se, al):
    coef, dc, ac = c.coef, fr.dc[c.td], fr.ac[c.ta]
    s = bits.huff(dc, fr)
    if s:
        if s > 15:
            fr.fail("corrupt JPEG data (DC category above 15)")
        c.dc_pred += _extend(bits.bits(s), s)
    coef[off] = c.dc_pred
    k = 1
    while k < 64:
        rs = bits.huff(ac, fr)
        r, s = rs >> 4, rs & 15
        if s:
            k += r
            if k > 63:
                fr.fail("corrupt JPEG data (AC run past the block)")
            coef[off + _ZZ[k]] = _extend(bits.bits(s), s)
            k += 1
        elif r == 15:
            k += 16
        else:
            break


def _dc_first(fr, bits, c, off, ss, se, al):
    s = bits.huff(fr.dc[c.td], fr)
    if s:
        if s > 15:
            fr.fail("corrupt JPEG data (DC category above 15)")
        c.dc_pred += _extend(bits.bits(s), s)
    c.coef[off] = c.dc_pred << al


def _dc_refine(fr, bits, c, off, ss, se, al):
    if bits.bits(1):
        c.coef[off] |= 1 << al


def _ac_first(fr, bits, c, off, ss, se, al):
    if fr.eobrun:
        fr.eobrun -= 1
        return
    coef, ac = c.coef, fr.ac[c.ta]
    k = ss
    while k <= se:
        rs = bits.huff(ac, fr)
        r, s = rs >> 4, rs & 15
        if s:
            k += r
            if k > 63:
                fr.fail("corrupt JPEG data (AC run past the block)")
            coef[off + _ZZ[k]] = _extend(bits.bits(s), s) << al
        elif r == 15:
            k += 15
        else:
            fr.eobrun = (1 << r) + bits.bits(r) - 1
            break
        k += 1


def _ac_refine(fr, bits, c, off, ss, se, al):
    coef, ac = c.coef, fr.ac[c.ta]
    p1, m1 = 1 << al, -1 << al
    k = ss
    if not fr.eobrun:
        while k <= se:
            rs = bits.huff(ac, fr)
            r, s = rs >> 4, rs & 15
            if s:
                s = p1 if bits.bits(1) else m1
            elif r != 15:
                fr.eobrun = (1 << r) + bits.bits(r)
                break
            while k <= se:
                z = off + _ZZ[k]
                if coef[z]:
                    if bits.bits(1) and not coef[z] & p1:
                        coef[z] += p1 if coef[z] >= 0 else m1
                else:
                    r -= 1
                    if r < 0:
                        break
                k += 1
            if s:
                if k > 63:
                    fr.fail("corrupt JPEG data (AC run past the block)")
                coef[off + _ZZ[k]] = s
            k += 1
    if fr.eobrun:
        while k <= se:
            z = off + _ZZ[k]
            if coef[z] and bits.bits(1) and not coef[z] & p1:
                coef[z] += p1 if coef[z] >= 0 else m1
            k += 1
        fr.eobrun -= 1


_HUFFMAN_STEPS = {None: _sequential, (False, False): _dc_first, (False, True): _dc_refine,
                  (True, False): _ac_first, (True, True): _ac_refine}


# -- arithmetic-coded blocks (jdarith.c) -------------------------------------------


def _arith_reset(fr: _Frame, comps, ss: int, ah: int):
    """The statistics a scan's start and each restart clear (jdarith.c
    start_pass, process_restart): DC bins unless a refinement or AC scan, AC
    bins unless a DC scan."""
    for c in comps:
        if not fr.progressive or (ss == 0 and ah == 0):
            fr.dc_stats[c.td][:] = bytes(DC_STAT_BINS)
        if not fr.progressive or ss:
            fr.ac_stats[c.ta][:] = bytes(AC_STAT_BINS)


def _arith_dc_diff(fr: _Frame, dec: _Arith, c: _Component) -> int:
    """Figures F.19-F.24: the DC difference, updating the component's context."""
    stats = fr.dc_stats[c.td]
    st = c.dc_ctx
    if not dec.decode(stats, st):
        c.dc_ctx = 0
        return 0
    sign = dec.decode(stats, st + 1)
    st += 2 + sign
    m = dec.decode(stats, st)
    if m:
        st = 20
        while dec.decode(stats, st):
            m <<= 1
            if m == 0x8000:
                fr.fail("corrupt JPEG data (arithmetic-coded magnitude overflow)")
            st += 1
    if m < (1 << fr.arith_dc_L[c.td]) >> 1:
        c.dc_ctx = 0
    elif m > (1 << fr.arith_dc_U[c.td]) >> 1:
        c.dc_ctx = 12 + sign * 4
    else:
        c.dc_ctx = 4 + sign * 4
    v = m
    st += 14
    while m >> 1:
        m >>= 1
        if dec.decode(stats, st):
            v |= m
    v += 1
    return -v if sign else v


def _arith_ac_value(fr: _Frame, dec: _Arith, c: _Component, st: int, k: int) -> int:
    """Figures F.21-F.24 from bin st (at SE's S0 + 1's outcome): an AC value."""
    stats = fr.ac_stats[c.ta]
    sign = dec.decode(fr.fixed_bin, 0)
    st += 2
    m = dec.decode(stats, st)
    if m and dec.decode(stats, st):
        m <<= 1
        st = 189 if k <= fr.arith_ac_K[c.ta] else 217
        while dec.decode(stats, st):
            m <<= 1
            if m == 0x8000:
                fr.fail("corrupt JPEG data (arithmetic-coded magnitude overflow)")
            st += 1
    v = m
    st += 14
    while m >> 1:
        m >>= 1
        if dec.decode(stats, st):
            v |= m
    v += 1
    return -v if sign else v


def _arith_sequential(fr, dec, c, off, ss, se, al):
    coef = c.coef
    c.dc_pred = (c.dc_pred + _arith_dc_diff(fr, dec, c)) & 0xFFFF
    coef[off] = c.dc_pred - 0x10000 if c.dc_pred & 0x8000 else c.dc_pred
    stats = fr.ac_stats[c.ta]
    k = 0
    while k < 63:
        st = 3 * k
        if dec.decode(stats, st):
            break
        while True:
            k += 1
            if dec.decode(stats, st + 1):
                break
            st += 3
            if k >= 63:
                fr.fail("corrupt JPEG data (arithmetic-coded run past the block)")
        coef[off + _ZZ[k]] = _arith_ac_value(fr, dec, c, st, k)


def _arith_dc_first(fr, dec, c, off, ss, se, al):
    c.dc_pred += _arith_dc_diff(fr, dec, c)
    c.coef[off] = c.dc_pred << al


def _arith_dc_refine(fr, dec, c, off, ss, se, al):
    if dec.decode(fr.fixed_bin, 0):
        c.coef[off] |= 1 << al


def _arith_ac_first(fr, dec, c, off, ss, se, al):
    coef, stats = c.coef, fr.ac_stats[c.ta]
    k = ss
    while k <= se:
        st = 3 * (k - 1)
        if dec.decode(stats, st):
            break
        while not dec.decode(stats, st + 1):
            st += 3
            k += 1
            if k > se:
                fr.fail("corrupt JPEG data (arithmetic-coded run past the band)")
        coef[off + _ZZ[k]] = _arith_ac_value(fr, dec, c, st, k) << al
        k += 1


def _arith_ac_refine(fr, dec, c, off, ss, se, al):
    coef, stats = c.coef, fr.ac_stats[c.ta]
    p1, m1 = 1 << al, -1 << al
    kex = se
    while kex > 0 and not coef[off + _ZZ[kex]]:
        kex -= 1
    k = ss
    while k <= se:
        st = 3 * (k - 1)
        if k > kex and dec.decode(stats, st):
            break
        while True:
            z = off + _ZZ[k]
            if coef[z]:
                if dec.decode(stats, st + 2):
                    coef[z] += m1 if coef[z] < 0 else p1
                break
            if dec.decode(stats, st + 1):
                coef[z] = m1 if dec.decode(fr.fixed_bin, 0) else p1
                break
            st += 3
            k += 1
            if k > se:
                fr.fail("corrupt JPEG data (arithmetic-coded run past the band)")
        k += 1


_ARITH_STEPS = {None: _arith_sequential, (False, False): _arith_dc_first,
                (False, True): _arith_dc_refine, (True, False): _arith_ac_first,
                (True, True): _arith_ac_refine}


# -- lossless samples (jdlhuff.c, jdlossls.c) ------------------------------------------


def _lossless_scan(fr: _Frame, comps, predictor: int, segs, blocks, n_mcu: int, ri: int):
    """Huffman-coded differences undone by T.81 Annex H's predictor. Each
    restart interval is whole MCU rows (libjpeg-turbo's rule); its first row
    of each component predicts from the left, the first sample from
    2^(7 - Pt), every other row's first sample from above."""
    per_row = comps[0].wib if len(comps) == 1 else fr.mcux
    if fr.restart and fr.restart % per_row:
        fr.fail(f"a lossless restart interval of {fr.restart} MCUs is not a whole number of "
                f"MCU rows ({per_row} MCUs)")
    for s_i, seg in enumerate(segs):
        bits = _Bits(seg)
        first = s_i * ri // per_row     # the interval's first MCU row
        for i in range(s_i * ri, min(n_mcu, (s_i + 1) * ri)):
            for c, off in blocks(i):
                s = bits.huff(fr.dc[c.td], fr)
                if s > 16:
                    fr.fail("corrupt JPEG data (difference category above 16)")
                diff = 32768 if s == 16 else _extend(bits.bits(s), s) if s else 0
                y, x = divmod(off, c.bw)
                coef = c.coef
                if y == first * (1 if len(comps) == 1 else c.v):
                    pred = coef[off - 1] if x else 1 << (7 - c.pt)
                elif x == 0:
                    pred = coef[off - c.bw]
                else:
                    ra, rb, rc = coef[off - 1], coef[off - c.bw], coef[off - c.bw - 1]
                    pred = (ra, rb, rc, ra + rb - rc, ra + ((rb - rc) >> 1),
                            rb + ((ra - rc) >> 1), (ra + rb) >> 1)[predictor - 1]
                coef[off] = (diff + pred) & 0xFFFF
        bits.check_end(fr)


# -- reconstruction ------------------------------------------------------------


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def _idct_1d(x, shift):
    """One jpeg_idct_islow pass over the 8 inputs x[0..7] (arrays), DESCALEd."""
    z2, z3 = x[2], x[6]
    z1 = (z2 + z3) * FIX_0_541196100
    tmp2 = z1 - z3 * FIX_1_847759065
    tmp3 = z1 + z2 * FIX_0_765366865
    tmp0 = (x[0] + x[4]) << CONST_BITS
    tmp1 = (x[0] - x[4]) << CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2

    tmp0, tmp1, tmp2, tmp3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = tmp0 + tmp3, tmp1 + tmp2, tmp0 + tmp2, tmp1 + tmp3
    z5 = (z3 + z4) * FIX_1_175875602
    tmp0 = tmp0 * FIX_0_298631336
    tmp1 = tmp1 * FIX_2_053119869
    tmp2 = tmp2 * FIX_3_072711026
    tmp3 = tmp3 * FIX_1_501321110
    z1 = z1 * -FIX_0_899976223
    z2 = z2 * -FIX_2_562915447
    z3 = z3 * -FIX_1_961570560 + z5
    z4 = z4 * -FIX_0_390180644 + z5
    tmp0 += z1 + z3
    tmp1 += z2 + z4
    tmp2 += z2 + z3
    tmp3 += z1 + z4
    return [_descale(tmp10 + tmp3, shift), _descale(tmp11 + tmp2, shift),
            _descale(tmp12 + tmp1, shift), _descale(tmp13 + tmp0, shift),
            _descale(tmp13 - tmp0, shift), _descale(tmp12 - tmp1, shift),
            _descale(tmp11 - tmp2, shift), _descale(tmp10 - tmp3, shift)]


def idct_islow(coef: np.ndarray, quant) -> np.ndarray:
    """(N, 64) quantized coefficients in natural order and the table ->
    (N, 8, 8) uint8 samples, as jpeg_idct_islow writes them."""
    x = coef.astype(np.int64).reshape(-1, 8, 8) * np.asarray(quant, np.int64).reshape(8, 8)
    ws = np.stack(_idct_1d([x[:, u, :] for u in range(8)], CONST_BITS - PASS1_BITS), axis=1)
    out = np.stack(_idct_1d([ws[:, :, u] for u in range(8)], CONST_BITS + PASS1_BITS + 3),
                   axis=2)
    return IDCT_LIMIT[out & RANGE_MASK]


def _plane(fr: _Frame, c: _Component, coef=None) -> np.ndarray:
    """The component's samples: IDCT of `coef` (its coefficients by default)."""
    if fr.lossless:     # jdlossls.c's scaler: the sample << Pt, cast to 8 bits
        return ((np.asarray(c.coef, np.int64) << c.pt) & 0xFF).astype(np.uint8).reshape(c.bh, c.bw)
    q = fr.qt.get(c.tq)
    if q is None:
        fr.fail(f"no quantization table {c.tq}")
    blocks = idct_islow(np.asarray(c.coef if coef is None else coef, np.int64).reshape(-1, 64), q)
    return blocks.reshape(c.bh, c.bw, 8, 8).transpose(0, 2, 1, 3).reshape(c.bh * 8, c.bw * 8)


def _fancy_h2(p: np.ndarray) -> np.ndarray:
    """h2v1_fancy_upsample along the last axis: 3/4 nearer + 1/4 further,
    biases 1 (left output) and 2 (right), the edge sample repeated."""
    p = p.astype(np.int32)
    left = np.concatenate([p[..., :1], p[..., :-1]], -1)
    right = np.concatenate([p[..., 1:], p[..., -1:]], -1)
    out = np.empty(p.shape[:-1] + (2 * p.shape[-1],), np.int32)
    out[..., 0::2] = (3 * p + left + 1) >> 2
    out[..., 1::2] = (3 * p + right + 2) >> 2
    return out


def _fancy_v2(p: np.ndarray) -> np.ndarray:
    """h1v2_fancy_upsample: the same filter down the rows, biases 1 (upper) and 2."""
    return _fancy_h2(p.T).T


def _fancy_h2v2(p: np.ndarray) -> np.ndarray:
    """h2v2_fancy_upsample: column sums 3·nearer row + further row, then
    (3·this + last + 8) >> 4 and (3·this + next + 7) >> 4 across."""
    p = p.astype(np.int32)
    above = np.concatenate([p[:1], p[:-1]], 0)
    below = np.concatenate([p[1:], p[-1:]], 0)
    sums = np.empty((2 * p.shape[0], p.shape[1]), np.int32)
    sums[0::2] = 3 * p + above
    sums[1::2] = 3 * p + below
    last = np.concatenate([sums[:, :1], sums[:, :-1]], 1)
    nxt = np.concatenate([sums[:, 1:], sums[:, -1:]], 1)
    out = np.empty((sums.shape[0], 2 * sums.shape[1]), np.int32)
    out[:, 0::2] = (3 * sums + last + 8) >> 4
    out[:, 1::2] = (3 * sums + nxt + 7) >> 4
    return out


def upsample(fr_h: int, fr_w: int, hmax: int, vmax: int, c_h: int, c_v: int,
             plane: np.ndarray, dh: int, dw: int, fancy: bool = True) -> np.ndarray:
    """A component's decoded plane -> (fr_h, fr_w) uint8, by the method
    jinit_upsampler picks at full scale with fancy upsampling on; a lossless
    file's (one-sample data units) is replicated (`fancy` False)."""
    if c_h == hmax and c_v == vmax:
        return plane[:fr_h, :fr_w]
    p = plane[:dh, :dw]
    if fancy and 2 * c_h == hmax and c_v == vmax and dw > 2:
        out = _fancy_h2(p)
    elif fancy and c_h == hmax and 2 * c_v == vmax:
        out = _fancy_v2(p)
    elif fancy and 2 * c_h == hmax and 2 * c_v == vmax and dw > 2:
        out = _fancy_h2v2(p)
    elif hmax % c_h == 0 and vmax % c_v == 0:    # int_upsample, h2v1/h2v2_upsample
        out = np.repeat(np.repeat(p, vmax // c_v, 0), hmax // c_h, 1)
    else:
        raise JPEGError(f"sampling ratio {hmax}/{c_h} x {vmax}/{c_v} is not a whole number")
    return out[:fr_h, :fr_w].astype(np.uint8)


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """ycc_rgb_convert: table lookups, one shift for G, then the clamp."""
    y = y.astype(np.int64)
    r = y + CR_R[cr]
    g = y + ((CB_G[cb] + CR_G[cr]) >> SCALEBITS)
    b = y + CB_B[cb]
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def _colour_space(fr: _Frame) -> str:
    """default_decompress_parms (jdapimin.c) for three or four components."""
    if len(fr.comps) == 4:
        return "YCCK" if fr.adobe is not None and fr.adobe != 0 else "CMYK"
    if fr.jfif:
        return "YCbCr"
    if fr.adobe is not None:
        return "RGB" if fr.adobe == 0 else "YCbCr"
    ids = tuple(c.cid for c in fr.comps)
    if ids == (82, 71, 66) or (ids == (1, 2, 3) and fr.lossless):
        return "RGB"
    return "YCbCr"


def cmyk_presented(planes, ycck: bool) -> np.ndarray:
    """Four decoded planes -> (H, W, 4) uint8 as Pillow presents a CMYK JPEG
    (raw mode CMYK;I, the samples inverted). libjpeg converts YCCK to CMYK
    (ycck_cmyk_convert: 255 - the YCbCr -> RGB result, clamped; K as it is),
    so a YCCK file comes out as the clamped RGB of its Y, Cb, Cr and 255 - K."""
    if ycck:
        rgb = ycc_to_rgb(*planes[:3])
        return np.concatenate([rgb, (255 - planes[3])[..., None]], -1).astype(np.uint8)
    return (255 - np.stack(planes, -1)).astype(np.uint8)


# zigzag 1-9's natural positions: the AC coefficients block smoothing estimates
SMOOTHED_AC = (1, 8, 16, 9, 2, 3, 10, 17, 24)
# their estimates from the 5x5 window of DC values d[0..24] (row-major) when
# some AC data is known (jdcoefct.c, K.8 over 5x5; the first five) and when
# only DC data is (a Gaussian-like kernel; all nine, and the DC itself)
_AC_KNOWN = (
    {10: -7, 11: 50, 13: -50, 14: 7},
    {2: -7, 7: 50, 17: -50, 22: 7},
    {2: -1, 7: 13, 12: -24, 17: 13, 22: -1},
    {9: 1, 15: 1, 16: -10, 18: 10, 1: -1, 19: -1, 21: 1, 23: -1, 3: 1, 5: -1, 6: 10, 8: -10},
    {10: -1, 11: 13, 12: -24, 13: 13, 14: -1},
)
_DC_ONLY = (
    {0: -1, 1: -1, 3: 1, 4: 1, 5: -3, 6: 13, 8: -13, 9: 3, 10: -3, 11: 38, 13: -38, 14: 3,
     15: -3, 16: 13, 18: -13, 19: 3, 20: -1, 21: -1, 23: 1, 24: 1},
    {0: -1, 1: -3, 2: -3, 3: -3, 4: -1, 5: -1, 6: 13, 7: 38, 8: 13, 9: -1, 15: 1, 16: -13,
     17: -38, 18: -13, 19: 1, 20: 1, 21: 3, 22: 3, 23: 3, 24: 1},
    {2: 1, 6: 2, 7: 7, 8: 2, 11: -5, 12: -14, 13: -5, 16: 2, 17: 7, 18: 2, 22: 1},
    {0: -1, 4: 1, 6: 9, 8: -9, 16: -9, 18: 9, 20: 1, 24: -1},
    {6: 2, 7: -5, 8: 2, 10: 1, 11: 7, 12: -14, 13: 7, 14: 1, 16: 2, 17: -5, 18: 2},
    {6: 1, 8: -1, 11: 2, 13: -2, 16: 1, 18: -1},
    {6: 1, 7: -3, 8: 1, 16: -1, 17: 3, 18: -1},
    {6: 1, 8: -1, 11: -3, 13: 3, 16: 1, 18: -1},
    {6: 1, 7: 2, 8: 1, 16: -1, 17: -2, 18: -1},
)
_DC_ESTIMATE = {0: -2, 1: -6, 2: -8, 3: -6, 4: -2, 5: -6, 6: 6, 7: 42, 8: 6, 9: -6,
                10: -8, 11: 42, 12: 152, 13: 42, 14: -8, 15: -6, 16: 6, 17: 42, 18: 6,
                19: -6, 20: -2, 21: -6, 22: -8, 23: -6, 24: -2}


def _smoothing_ok(fr: _Frame) -> bool:
    """jdcoefct.c smoothing_ok: a progressive file's blocks are smoothed when
    every component's DC is at least partly known, its quantizers for the DC
    and the first nine AC coefficients are nonzero, and some of those AC
    coefficients' bits stay unknown after every scan."""
    if not fr.progressive:
        return False
    useful = False
    for c in fr.comps:
        q = fr.qt.get(c.tq)
        if q is None or c.coef_bits[0] < 0 or 0 in (q[0], *(q[p] for p in SMOOTHED_AC)):
            return False
        useful |= any(b != 0 for b in c.coef_bits[1:SMOOTHING_COEFS])
    return useful


def _estimate(num: np.ndarray, q: int, al: int) -> np.ndarray:
    """((q << 7) + |num|) // (q << 8) with num's sign, capped below 2^Al when
    Al > 0 (the coefficient's unknown low bits)."""
    mag = ((q << 7) + np.abs(num)) // (q << 8)
    if al > 0:
        mag = np.minimum(mag, (1 << al) - 1)
    return np.where(num >= 0, mag, -mag)


def _smoothed(fr: _Frame, c: _Component) -> np.ndarray:
    """jdcoefct.c decompress_smooth_data (libjpeg-turbo 2.1 on): the
    component's coefficients with zero low-frequency AC coefficients whose
    bits are not all known estimated from the 5x5 window of DC values around
    each block (the edge blocks repeated), and, when no AC data is known at
    all, the DC too. The window's rows follow libjpeg's iMCU-row arithmetic."""
    coef = np.asarray(c.coef, np.int64).reshape(c.bh, c.bw, 64)
    out = coef.copy()
    bits, q = c.coef_bits, fr.qt[c.tq]
    change_dc = all(b == -1 for b in bits[1:SMOOTHING_COEFS])
    total, v = fr.mcuy, c.v
    rows = []
    for imcu in range(total):
        block_rows = v if imcu < total - 1 else (c.hib % v or v)
        image_rows = block_rows * total
        for br in range(block_rows):
            ibr, cur = imcu * block_rows + br, imcu * v + br
            prev = cur - 1 if ibr > 0 else cur
            nxt = cur + 1 if ibr < image_rows - 1 else cur
            rows.append((cur - 2 if ibr > 1 else prev, prev, cur, nxt,
                         cur + 2 if ibr < image_rows - 2 else nxt))
    rows = np.asarray(rows)                                            # (hib, 5)
    cols = np.clip(np.arange(c.wib)[:, None] + np.arange(-2, 3), 0, c.wib - 1)
    dc = coef[..., 0][rows[:, :, None, None], cols[None, None]]      # (hib, 5, wib, 5)
    dc = dc.transpose(0, 2, 1, 3).reshape(len(rows), c.wib, 25)
    blocks = out[rows[:, 2], :c.wib]                                  # (hib, wib, 64)
    kernels = _DC_ONLY if change_dc else _AC_KNOWN
    for k, (pos, taps) in enumerate(zip(SMOOTHED_AC, kernels), start=1):
        if bits[k] == 0:
            continue
        num = q[0] * sum(w * dc[..., i] for i, w in taps.items())
        zero = blocks[..., pos] == 0
        blocks[..., pos] = np.where(zero, _estimate(num, q[pos], bits[k]), blocks[..., pos])
    if change_dc:
        num = q[0] * sum(w * dc[..., i] for i, w in _DC_ESTIMATE.items())
        blocks[..., 0] = _estimate(num, q[0], 0)
    out[rows[:, 2], :c.wib] = blocks
    return out.reshape(-1)


def _read(data: bytes, name: str, header_only: bool) -> _Frame:
    """Walk the markers (jdmarker.c read_markers), decoding each scan as it
    comes; with header_only, stop at the frame header."""
    fr = _Frame(name)
    data = bytes(data)
    n = len(data)
    if n < 4 or data[0] != 0xFF or data[1] != SOI:
        fr.fail("not a JPEG file (no SOI marker)")
    p, scans = 2, 0
    while True:
        if p >= n:
            fr.fail("truncated JPEG data (no EOI marker)")
        if data[p] != 0xFF:
            fr.fail(f"corrupt JPEG data (0x{data[p]:02X} where a marker belongs, offset {p})")
        while p < n and data[p] == 0xFF:
            p += 1
        if p >= n:
            fr.fail("truncated JPEG data (no EOI marker)")
        m = data[p]
        p += 1
        if m == EOI:
            break
        if m == SOI or 0xD0 <= m <= 0xD7 or m == 0x01:
            continue
        if p + 2 > n or _u16(data, p) < 2 or p + _u16(data, p) > n:
            fr.fail(f"truncated JPEG data (marker 0xFF{m:02X})")
        a, b = p + 2, p + _u16(data, p)
        p = b
        d = data[a:b]
        if m in SOF_DECODED or (m in SOF_REFUSED and m not in NOT_FRAMES):
            if header_only:
                if len(d) < 5:
                    fr.fail(f"truncated frame header (marker 0xFF{m:02X})")
                fr.height, fr.width = _u16(d, 1), _u16(d, 3)
                return fr
            _parse_sof(fr, m, d)
        elif m in SOF_REFUSED:
            fr.fail(f"{SOF_REFUSED[m]} is not decoded (marker 0xFF{m:02X})")
        elif m == DQT:
            _parse_dqt(fr, d)
        elif m == DHT:
            _parse_dht(fr, d)
        elif m == DAC:
            _parse_dac(fr, d)
        elif m == DRI:
            if len(d) < 2:
                fr.fail("truncated restart interval (marker 0xFFDD)")
            fr.restart = _u16(d, 0)
        elif 0xE0 <= m <= 0xEF:
            _parse_app(fr, m, d)
        elif m == COM:
            pass
        elif m == DNL:
            fr.fail("a DNL marker is not decoded (marker 0xFFDC)")
        elif m == SOS:
            if not fr.comps:
                fr.fail("a scan before the frame header (marker 0xFFDA)")
            scan = _parse_sos(fr, d)
            segs, rsts, p = _scan_data(data, b, name)
            _decode_scan(fr, *scan, segs, rsts)
            scans += 1
        else:
            fr.fail(f"unknown marker 0xFF{m:02X}")
    if not fr.comps:
        fr.fail("no frame header before EOI")
    if not scans:
        fr.fail("no scan before EOI")
    return fr


def image_size(data: bytes, name: str = "<bytes>") -> tuple[int, int]:
    """(height, width) from the frame header, without decoding the scans."""
    fr = _read(data, name, header_only=True)
    return fr.height, fr.width


def decode(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """JPEG bytes -> what `np.asarray(PIL.Image.open(...))` gives: (H, W)
    uint8 for one component (mode L), (H, W, 3) RGB for three, (H, W, 4)
    CMYK for four (`MODES` names them by the channel count)."""
    fr = _read(data, name, header_only=False)
    smooth = _smoothing_ok(fr)
    space = _colour_space(fr) if len(fr.comps) > 1 else "L"
    if fr.lossless and space in ("YCbCr", "YCCK"):
        fr.fail(f"lossless coding (SOF3) of {space} colour is not decoded (libjpeg converts "
                "no colour in lossless mode)")
    planes = [upsample(fr.height, fr.width, fr.hmax, fr.vmax, c.h, c.v,
                       _plane(fr, c, _smoothed(fr, c) if smooth else None), c.dh, c.dw,
                       fancy=not fr.lossless)
              for c in fr.comps]
    if len(planes) == 1:
        return np.ascontiguousarray(planes[0])
    if len(planes) == 4:
        return cmyk_presented(planes, space == "YCCK")
    if space == "RGB":
        return np.stack(planes, -1)
    return ycc_to_rgb(*planes)
