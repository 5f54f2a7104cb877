"""Baseline and progressive JPEG decoding in numpy, equal to Pillow's bit for bit.

The JAX package reads its JPEG frames, backgrounds and textures with Pillow,
which decodes through libjpeg-turbo with its defaults: the accurate integer
IDCT (`jpeg_idct_islow`, jidctint.c), fancy upsampling (jdsample.c) and the
table-driven YCbCr -> RGB conversion (jdcolor.c). This module repeats those
steps in integer arithmetic, so `decode` returns what
`np.asarray(PIL.Image.open(path))` gives: (H, W, 3) uint8 for a
three-component file, (H, W) uint8 for a grayscale one.

It is the plain version of csrc/jpeg_decode.cpp (utils/jpeg_cext.py), which
every runtime path calls; this one is for the tests and for holding the
library to it. `image_size` reads (height, width) from the frame header alone.

Decoded: SOF0 (baseline), SOF1 (extended sequential, Huffman) and SOF2
(progressive, Huffman) at 8-bit precision, with one or three components,
interleaved and non-interleaved scans, 8- and 16-bit quantization tables,
restart intervals, and any sampling factors whose ratios are whole numbers.
Everything else raises JPEGError naming the marker and the file: arithmetic
coding (SOF9-11, DAC), lossless (SOF3) and hierarchical (SOF5-7, DHP, EXP)
files, 12-bit precision, four components (CMYK or YCCK), a progressive file
whose scans leave low-frequency coefficient bits unknown (where libjpeg would
smooth blocks), and truncated or corrupt data. Nothing falls back.
"""

from __future__ import annotations

import numpy as np

SOI, EOI, SOS, DQT, DHT, DRI, DNL, COM, DAC = 0xD8, 0xD9, 0xDA, 0xDB, 0xC4, 0xDD, 0xDC, 0xFE, 0xCC
SOF_DECODED = {0xC0: "SOF0", 0xC1: "SOF1", 0xC2: "SOF2"}
SOF_REFUSED = {
    0xC3: "lossless coding (SOF3)",
    0xC5: "hierarchical coding (SOF5)", 0xC6: "hierarchical coding (SOF6)",
    0xC7: "hierarchical coding (SOF7)",
    0xC9: "arithmetic coding (SOF9)", 0xCA: "arithmetic coding (SOF10)",
    0xCB: "arithmetic coding (SOF11)",
    0xCD: "arithmetic coding (SOF13)", 0xCE: "arithmetic coding (SOF14)",
    0xCF: "arithmetic coding (SOF15)",
    DAC: "arithmetic coding (DAC)", 0xDE: "hierarchical coding (DHP)",
    0xDF: "hierarchical coding (EXP)",
}

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
                 "coef_bits", "dc_pred", "td", "ta")

    def __init__(self, cid, h, v, tq):
        self.cid, self.h, self.v, self.tq = cid, h, v, tq


class _Frame:
    def __init__(self, name):
        self.name = name
        self.qt = {}                 # table id -> 64 ints, natural order
        self.dc, self.ac = {}, {}    # table id -> 65,536-entry lookup
        self.restart = 0
        self.progressive = False
        self.comps = []
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
    if nf == 4:
        fr.fail(f"four components (CMYK or YCCK) are not decoded (marker 0xFF{m:02X})")
    if nf not in (1, 3):
        fr.fail(f"{nf} components are not decoded (marker 0xFF{m:02X}; 1 or 3)")
    if len(d) < 6 + 3 * nf:
        fr.fail(f"truncated frame header (marker 0xFF{m:02X})")
    fr.progressive = m == 0xC2
    for i in range(nf):
        cid, hv, tq = d[6 + 3 * i], d[7 + 3 * i], d[8 + 3 * i]
        h, v = hv >> 4, hv & 15
        if not (1 <= h <= 4 and 1 <= v <= 4) or tq > 3:
            fr.fail(f"bad sampling factors {h}x{v} or table {tq} (marker 0xFF{m:02X})")
        fr.comps.append(_Component(cid, h, v, tq))
    hmax = max(c.h for c in fr.comps)
    vmax = max(c.v for c in fr.comps)
    fr.hmax, fr.vmax = hmax, vmax
    fr.mcux = -(-fr.width // (8 * hmax))
    fr.mcuy = -(-fr.height // (8 * vmax))
    for c in fr.comps:
        c.dw = -(-fr.width * c.h // hmax)     # downsampled_width
        c.dh = -(-fr.height * c.v // vmax)
        c.wib, c.hib = -(-c.dw // 8), -(-c.dh // 8)
        c.bw, c.bh = fr.mcux * c.h, fr.mcuy * c.v
        c.coef = [0] * (c.bw * c.bh * 64)
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
    if fr.progressive:
        bad = (ss > se or se > 63 or al > 13 or (ah and ah != al + 1)
               or (ss == 0 and se != 0) or (ss > 0 and ns != 1))
    else:
        bad = ss != 0 or se != 63 or ah or al
    if bad:
        fr.fail(f"bad scan parameters Ss={ss} Se={se} Ah={ah} Al={al} (marker 0xFFDA)")
    if ns > 1 and sum(c.h * c.v for c in comps) > MAX_BLOCKS_IN_MCU:
        fr.fail("too many blocks in an MCU (marker 0xFFDA)")
    for c in comps:
        if ss == 0 and (not ah or not fr.progressive) and c.td not in fr.dc:
            fr.fail(f"no DC Huffman table {c.td} (marker 0xFFDA)")
        if se > 0 and c.ta not in fr.ac:
            fr.fail(f"no AC Huffman table {c.ta} (marker 0xFFDA)")
        for k in range(ss, se + 1):
            c.coef_bits[k] = al
    return comps, ss, se, ah, al


def _mcu_blocks(fr: _Frame, comps):
    """(MCU count, a function from MCU index to [(component, block offset)])."""
    if len(comps) == 1:
        c = comps[0]

        def blocks(i, c=c):
            return ((c, ((i // c.wib) * c.bw + i % c.wib) * 64),)
        return c.wib * c.hib, blocks

    def blocks(i):
        my, mx = divmod(i, fr.mcux)
        out = []
        for c in comps:
            for v in range(c.v):
                row = (my * c.v + v) * c.bw + mx * c.h
                out.extend((c, (row + h) * 64) for h in range(c.h))
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
    if fr.progressive:
        if ss == 0:
            step = _dc_first if not ah else _dc_refine
        else:
            step = _ac_first if not ah else _ac_refine
    else:
        step = _sequential
    for s_i in range(n_int):
        bits = _Bits(segs[s_i])
        for c in comps:
            c.dc_pred = 0
        fr.eobrun = 0
        for i in range(s_i * ri, min(n_mcu, (s_i + 1) * ri)):
            for c, off in blocks(i):
                step(fr, bits, c, off, ss, se, al)
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


def _plane(fr: _Frame, c: _Component) -> np.ndarray:
    q = fr.qt.get(c.tq)
    if q is None:
        fr.fail(f"no quantization table {c.tq}")
    blocks = idct_islow(np.asarray(c.coef, np.int64).reshape(-1, 64), q)
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
             plane: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """A component's decoded plane -> (fr_h, fr_w) uint8, by the method
    jinit_upsampler picks at full scale with fancy upsampling on."""
    if c_h == hmax and c_v == vmax:
        return plane[:fr_h, :fr_w]
    p = plane[:dh, :dw]
    if 2 * c_h == hmax and c_v == vmax and dw > 2:
        out = _fancy_h2(p)
    elif c_h == hmax and 2 * c_v == vmax:
        out = _fancy_v2(p)
    elif 2 * c_h == hmax and 2 * c_v == vmax and dw > 2:
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
    """default_decompress_parms (jdapimin.c) for three components."""
    if fr.jfif:
        return "YCbCr"
    if fr.adobe is not None:
        return "RGB" if fr.adobe == 0 else "YCbCr"
    ids = tuple(c.cid for c in fr.comps)
    return "RGB" if ids == (82, 71, 66) else "YCbCr"


def _check_smoothing(fr: _Frame):
    """jdcoefct.c smoothing_ok: libjpeg smooths a progressive file's blocks
    when a low-frequency coefficient's bits stay partly unknown after every
    scan; this decoder does not, so such a file is refused."""
    if not fr.progressive:
        return
    useful = False
    for c in fr.comps:
        q = fr.qt.get(c.tq)
        if q is None or c.coef_bits[0] < 0 or 0 in (q[0], q[1], q[8], q[16], q[9], q[2], q[3],
                                                     q[10], q[17], q[24]):
            return
        useful |= any(b != 0 for b in c.coef_bits[1:SMOOTHING_COEFS])
    if useful:
        fr.fail("a progressive file whose scans leave coefficient bits unknown "
                "(libjpeg's block smoothing) is not decoded")


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
        if m in SOF_DECODED or (m in SOF_REFUSED and m not in (DAC, 0xDE, 0xDF)):
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
    """JPEG bytes -> (H, W, 3) uint8 RGB, or (H, W) uint8 for one component."""
    fr = _read(data, name, header_only=False)
    _check_smoothing(fr)
    planes = [upsample(fr.height, fr.width, fr.hmax, fr.vmax, c.h, c.v, _plane(fr, c), c.dh, c.dw)
              for c in fr.comps]
    if len(planes) == 1:
        return np.ascontiguousarray(planes[0])
    if _colour_space(fr) == "RGB":
        return np.stack(planes, -1)
    return ycc_to_rgb(*planes)
