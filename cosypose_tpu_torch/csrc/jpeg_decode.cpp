// Baseline and progressive JPEG decoding on the host, equal to Pillow's bit for bit.
//
// The C++ form of cosypose_tpu_torch/utils/jpeg.py (whose docstring lists
// what is decoded and what is refused): libjpeg-turbo's defaults as Pillow
// runs them, i.e. jpeg_idct_islow (jidctint.c) with its range-limit table,
// fancy upsampling (jdsample.c: h2v1, h1v2 and h2v2 filters, replication for
// every other whole ratio) and the table-driven YCbCr -> RGB conversion
// (jdcolor.c). Built with g++ into build/ at first use by utils/jpeg_cext.py
// and called through ctypes from the data loaders, on the CPU as on the
// card's host.
//
// Plain-C interface:
//   cosypose_jpeg_info(data, n, hwc, err, errlen): height, width and
//     component count from the frame header; 0 on success.
//   cosypose_jpeg_decode(data, n, out, out_size, err, errlen): the image,
//     (H, W, 3) RGB or (H, W) for one component, into out; 0 on success.
// On failure both return 1 and write a message into err.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Error {
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw Error{msg}; }

std::string hex2(int m) {
  char buf[8];
  std::snprintf(buf, sizeof buf, "%02X", m);
  return buf;
}

const int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33, 40, 48,
    41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23,
    30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// jidctint.c
constexpr int CONST_BITS = 13, PASS1_BITS = 2, RANGE_MASK = 1023;
constexpr int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433,
                  FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                  FIX_1_501321110 = 12299, FIX_1_847759065 = 15137, FIX_1_961570560 = 16069,
                  FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;
// jdcolor.c
constexpr int SCALEBITS = 16;
constexpr int64_t ONE_HALF = int64_t(1) << (SCALEBITS - 1);
constexpr int MAX_BLOCKS_IN_MCU = 10, SMOOTHING_COEFS = 10;

struct Tables {
  uint8_t idct_limit[1024];
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  Tables() {
    for (int i = 0; i < 1024; i++)
      idct_limit[i] = i < 128 ? uint8_t(128 + i) : i < 512 ? 255 : i < 896 ? 0 : uint8_t(i - 896);
    auto fix = [](double x) { return int64_t(x * (1 << SCALEBITS) + 0.5); };
    for (int i = 0; i < 256; i++) {
      int64_t x = i - 128;
      cr_r[i] = int((fix(1.40200) * x + ONE_HALF) >> SCALEBITS);
      cb_b[i] = int((fix(1.77200) * x + ONE_HALF) >> SCALEBITS);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + ONE_HALF;
    }
  }
};
const Tables kTables;

struct Component {
  int id = 0, h = 1, v = 1, tq = 0, td = 0, ta = 0;
  int dw = 0, dh = 0, wib = 0, hib = 0, bw = 0, bh = 0;
  std::vector<int32_t> coef;
  int coef_bits[64] = {};
  int dc_pred = 0;
};

struct Huffman {
  std::vector<uint16_t> lut;  // next 16 bits -> (length << 8) | symbol; 0: no code
};

struct Frame {
  int quant[4][64];
  bool has_quant[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  int restart = 0;
  bool progressive = false, jfif = false;
  int adobe = -1;
  int height = 0, width = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  std::vector<Component> comps;
  int eobrun = 0;
};

inline int u16(const uint8_t* d) { return (d[0] << 8) | d[1]; }

const char* refused(int m) {
  switch (m) {
    case 0xC3: return "lossless coding (SOF3)";
    case 0xC5: return "hierarchical coding (SOF5)";
    case 0xC6: return "hierarchical coding (SOF6)";
    case 0xC7: return "hierarchical coding (SOF7)";
    case 0xC9: return "arithmetic coding (SOF9)";
    case 0xCA: return "arithmetic coding (SOF10)";
    case 0xCB: return "arithmetic coding (SOF11)";
    case 0xCD: return "arithmetic coding (SOF13)";
    case 0xCE: return "arithmetic coding (SOF14)";
    case 0xCF: return "arithmetic coding (SOF15)";
    case 0xCC: return "arithmetic coding (DAC)";
    case 0xDE: return "hierarchical coding (DHP)";
    case 0xDF: return "hierarchical coding (EXP)";
    default: return nullptr;
  }
}

bool is_sof(int m) {
  return m == 0xC0 || m == 0xC1 || m == 0xC2 || (refused(m) && m != 0xCC && m != 0xDE &&
                                                  m != 0xDF);
}

void parse_sof(Frame& fr, int m, const uint8_t* d, int len) {
  std::string mk = "marker 0xFF" + hex2(m);
  if (const char* what = refused(m)) fail(std::string(what) + " is not decoded (" + mk + ")");
  if (!fr.comps.empty()) fail("a second frame header (" + mk + ")");
  if (len < 6) fail("truncated frame header (" + mk + ")");
  int prec = d[0], nf = d[5];
  fr.height = u16(d + 1);
  fr.width = u16(d + 3);
  if (prec != 8)
    fail(std::to_string(prec) + "-bit precision is not decoded (" + mk + ", 8-bit only)");
  if (fr.height == 0) fail("a height given by a DNL marker is not decoded (" + mk + ")");
  if (fr.width == 0) fail("empty image (" + mk + ")");
  if (nf == 4) fail("four components (CMYK or YCCK) are not decoded (" + mk + ")");
  if (nf != 1 && nf != 3)
    fail(std::to_string(nf) + " components are not decoded (" + mk + "; 1 or 3)");
  if (len < 6 + 3 * nf) fail("truncated frame header (" + mk + ")");
  fr.progressive = m == 0xC2;
  for (int i = 0; i < nf; i++) {
    Component c;
    c.id = d[6 + 3 * i];
    c.h = d[7 + 3 * i] >> 4;
    c.v = d[7 + 3 * i] & 15;
    c.tq = d[8 + 3 * i];
    if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
      fail("bad sampling factors " + std::to_string(c.h) + "x" + std::to_string(c.v) +
           " or table " + std::to_string(c.tq) + " (" + mk + ")");
    fr.comps.push_back(std::move(c));
  }
  for (auto& c : fr.comps) {
    fr.hmax = std::max(fr.hmax, c.h);
    fr.vmax = std::max(fr.vmax, c.v);
  }
  fr.mcux = (fr.width + 8 * fr.hmax - 1) / (8 * fr.hmax);
  fr.mcuy = (fr.height + 8 * fr.vmax - 1) / (8 * fr.vmax);
  for (auto& c : fr.comps) {
    c.dw = (fr.width * c.h + fr.hmax - 1) / fr.hmax;
    c.dh = (fr.height * c.v + fr.vmax - 1) / fr.vmax;
    c.wib = (c.dw + 7) / 8;
    c.hib = (c.dh + 7) / 8;
    c.bw = fr.mcux * c.h;
    c.bh = fr.mcuy * c.v;
    c.coef.assign(size_t(c.bw) * c.bh * 64, 0);
    for (int k = 0; k < 64; k++) c.coef_bits[k] = -1;
  }
}

void parse_dqt(Frame& fr, const uint8_t* d, int len) {
  int p = 0;
  while (p < len) {
    int pq = d[p] >> 4, tq = d[p] & 15;
    p++;
    int size = pq ? 128 : 64;
    if (pq > 1 || tq > 3 || p + size > len) fail("bad quantization table (marker 0xFFDB)");
    for (int k = 0; k < 64; k++)
      fr.quant[tq][kZigzag[k]] = pq ? u16(d + p + 2 * k) : d[p + k];
    fr.has_quant[tq] = true;
    p += size;
  }
}

void parse_dht(Frame& fr, const uint8_t* d, int len) {
  int p = 0;
  while (p < len) {
    if (p + 17 > len) fail("truncated Huffman table (marker 0xFFC4)");
    int tc = d[p] >> 4, th = d[p] & 15, total = 0;
    const uint8_t* counts = d + p + 1;
    for (int i = 0; i < 16; i++) total += counts[i];
    p += 17;
    if (tc > 1 || th > 3 || total > 256 || p + total > len)
      fail("bad Huffman table (marker 0xFFC4)");
    Huffman& t = tc ? fr.ac[th] : fr.dc[th];
    t.lut.assign(1 << 16, 0);
    int code = 0, k = 0;
    for (int length = 1; length <= 16; length++) {
      for (int i = 0; i < counts[length - 1]; i++) {
        if (code >= (1 << length)) fail("bad Huffman table (marker 0xFFC4)");
        int lo = code << (16 - length);
        uint16_t e = uint16_t((length << 8) | d[p + k]);
        for (int j = 0; j < (1 << (16 - length)); j++) t.lut[lo + j] = e;
        code++;
        k++;
      }
      code <<= 1;
    }
    p += total;
  }
}

// MSB-first bits of one unstuffed segment; past its end zero bits, which
// check_end turns into an error
struct Bits {
  const uint8_t* seg;
  size_t len, pos = 0;
  uint64_t acc = 0;
  int n = 0;
  int64_t pad = 0;
  Bits(const uint8_t* s, size_t l) : seg(s), len(l) {}
  inline void fill(int need) {
    while (n < need) {
      acc = (acc << 8) | (pos < len ? seg[pos] : 0);
      if (pos < len) pos++; else pad += 8;
      n += 8;
    }
  }
  inline int bits(int k) {
    if (k == 0) return 0;
    if (n < k) fill(k);
    n -= k;
    int v = int((acc >> n) & ((uint64_t(1) << k) - 1));
    return v;
  }
  inline int huff(const Huffman& t) {
    if (n < 16) fill(16);
    uint16_t e = t.lut[(acc >> (n - 16)) & 0xFFFF];
    if (!e) fail("corrupt JPEG data (bad Huffman code)");
    n -= e >> 8;
    return e & 0xFF;
  }
  void check_end() const {
    if (int64_t(pos) * 8 + pad - n > int64_t(len) * 8)
      fail("truncated or corrupt JPEG data (a scan segment ends early)");
  }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

struct Scan {
  std::vector<Component*> comps;
  int ss = 0, se = 63, ah = 0, al = 0;
};

Scan parse_sos(Frame& fr, const uint8_t* d, int len) {
  Scan sc;
  int ns = len > 0 ? d[0] : 0;
  if (ns < 1 || ns > 4 || len < 4 + 2 * ns) fail("bad scan header (marker 0xFFDA)");
  for (int i = 0; i < ns; i++) {
    Component* c = nullptr;
    for (auto& x : fr.comps)
      if (x.id == d[1 + 2 * i]) c = &x;
    if (!c)
      fail("scan names component " + std::to_string(d[1 + 2 * i]) +
           ", absent from the frame (marker 0xFFDA)");
    c->td = d[2 + 2 * i] >> 4;
    c->ta = d[2 + 2 * i] & 15;
    if (c->td > 3 || c->ta > 3) fail("bad scan header (marker 0xFFDA)");
    sc.comps.push_back(c);
  }
  int q = 1 + 2 * ns;
  sc.ss = d[q];
  sc.se = d[q + 1];
  sc.ah = d[q + 2] >> 4;
  sc.al = d[q + 2] & 15;
  bool bad;
  if (fr.progressive)
    bad = sc.ss > sc.se || sc.se > 63 || sc.al > 13 || (sc.ah && sc.ah != sc.al + 1) ||
          (sc.ss == 0 && sc.se != 0) || (sc.ss > 0 && ns != 1);
  else
    bad = sc.ss != 0 || sc.se != 63 || sc.ah || sc.al;
  if (bad)
    fail("bad scan parameters Ss=" + std::to_string(sc.ss) + " Se=" + std::to_string(sc.se) +
         " Ah=" + std::to_string(sc.ah) + " Al=" + std::to_string(sc.al) + " (marker 0xFFDA)");
  int blocks = 0;
  for (auto* c : sc.comps) blocks += c->h * c->v;
  if (ns > 1 && blocks > MAX_BLOCKS_IN_MCU) fail("too many blocks in an MCU (marker 0xFFDA)");
  for (auto* c : sc.comps) {
    if (sc.ss == 0 && (!sc.ah || !fr.progressive) && fr.dc[c->td].lut.empty())
      fail("no DC Huffman table " + std::to_string(c->td) + " (marker 0xFFDA)");
    if (sc.se > 0 && fr.ac[c->ta].lut.empty())
      fail("no AC Huffman table " + std::to_string(c->ta) + " (marker 0xFFDA)");
    for (int k = sc.ss; k <= sc.se; k++) c->coef_bits[k] = sc.al;
  }
  return sc;
}

// the entropy-coded segments from p on, unstuffed and split at RST markers;
// returns the position of the marker after them
size_t scan_data(const uint8_t* data, size_t n, size_t p, std::vector<std::vector<uint8_t>>& segs,
                 std::vector<int>& rsts) {
  std::vector<uint8_t> cur;
  size_t i = p;
  while (true) {
    if (i >= n || i + 1 >= n) fail("truncated JPEG data (the scan runs to the end)");
    uint8_t x = data[i];
    if (x != 0xFF) {
      cur.push_back(x);
      i++;
      continue;
    }
    uint8_t b = data[i + 1];
    if (b == 0) {
      cur.push_back(0xFF);
      i += 2;
      continue;
    }
    size_t j = i + 1;
    if (b == 0xFF) {  // fill bytes before a marker
      while (j < n && data[j] == 0xFF) j++;
      if (j >= n) fail("truncated JPEG data (the scan runs to the end)");
      b = data[j];
      if (b == 0)
        fail("corrupt JPEG data (a stuffed 0xFF after fill bytes, offset " + std::to_string(i) +
             ")");
    }
    segs.push_back(std::move(cur));
    cur.clear();
    if (b >= 0xD0 && b <= 0xD7) {
      rsts.push_back(b - 0xD0);
      i = j + 1;
      continue;
    }
    return i;
  }
}

enum Step { SEQUENTIAL, DC_FIRST, DC_REFINE, AC_FIRST, AC_REFINE };

inline void decode_block(Frame& fr, Bits& bits, Component& c, size_t off, const Scan& sc,
                         Step step) {
  int32_t* coef = c.coef.data() + off;
  switch (step) {
    case SEQUENTIAL: {
      const Huffman& dc = fr.dc[c.td];
      const Huffman& ac = fr.ac[c.ta];
      int s = bits.huff(dc);
      if (s) {
        if (s > 15) fail("corrupt JPEG data (DC category above 15)");
        c.dc_pred += extend(bits.bits(s), s);
      }
      coef[0] = c.dc_pred;
      for (int k = 1; k < 64;) {
        int rs = bits.huff(ac), r = rs >> 4;
        s = rs & 15;
        if (s) {
          k += r;
          if (k > 63) fail("corrupt JPEG data (AC run past the block)");
          coef[kZigzag[k]] = extend(bits.bits(s), s);
          k++;
        } else if (r == 15) {
          k += 16;
        } else {
          break;
        }
      }
      return;
    }
    case DC_FIRST: {
      int s = bits.huff(fr.dc[c.td]);
      if (s) {
        if (s > 15) fail("corrupt JPEG data (DC category above 15)");
        c.dc_pred += extend(bits.bits(s), s);
      }
      coef[0] = int32_t(uint32_t(c.dc_pred) << sc.al);
      return;
    }
    case DC_REFINE:
      if (bits.bits(1)) coef[0] |= 1 << sc.al;
      return;
    case AC_FIRST: {
      if (fr.eobrun) {
        fr.eobrun--;
        return;
      }
      const Huffman& ac = fr.ac[c.ta];
      for (int k = sc.ss; k <= sc.se; k++) {
        int rs = bits.huff(ac), r = rs >> 4, s = rs & 15;
        if (s) {
          k += r;
          if (k > 63) fail("corrupt JPEG data (AC run past the block)");
          coef[kZigzag[k]] = int32_t(uint32_t(extend(bits.bits(s), s)) << sc.al);
        } else if (r == 15) {
          k += 15;
        } else {
          fr.eobrun = (1 << r) + bits.bits(r) - 1;
          break;
        }
      }
      return;
    }
    case AC_REFINE: {
      const Huffman& ac = fr.ac[c.ta];
      int p1 = 1 << sc.al, m1 = -(1 << sc.al);
      int k = sc.ss;
      if (!fr.eobrun) {
        for (; k <= sc.se; k++) {
          int rs = bits.huff(ac), r = rs >> 4, s = rs & 15;
          if (s) {
            s = bits.bits(1) ? p1 : m1;
          } else if (r != 15) {
            fr.eobrun = (1 << r) + bits.bits(r);
            break;
          }
          while (k <= sc.se) {
            int32_t& z = coef[kZigzag[k]];
            if (z) {
              if (bits.bits(1) && !(z & p1)) z += z >= 0 ? p1 : m1;
            } else if (--r < 0) {
              break;
            }
            k++;
          }
          if (s) {
            if (k > 63) fail("corrupt JPEG data (AC run past the block)");
            coef[kZigzag[k]] = s;
          }
        }
      }
      if (fr.eobrun) {
        for (; k <= sc.se; k++) {
          int32_t& z = coef[kZigzag[k]];
          if (z && bits.bits(1) && !(z & p1)) z += z >= 0 ? p1 : m1;
        }
        fr.eobrun--;
      }
      return;
    }
  }
}

void decode_scan(Frame& fr, const Scan& sc, const std::vector<std::vector<uint8_t>>& segs,
                 const std::vector<int>& rsts) {
  bool single = sc.comps.size() == 1;
  int64_t n_mcu = single ? int64_t(sc.comps[0]->wib) * sc.comps[0]->hib
                         : int64_t(fr.mcux) * fr.mcuy;
  int64_t ri = fr.restart ? fr.restart : n_mcu;
  int64_t n_int = (n_mcu + ri - 1) / ri;
  if (int64_t(segs.size()) != n_int)
    fail("corrupt JPEG data (" + std::to_string(segs.size()) + " restart intervals in a scan of " +
         std::to_string(n_int) + ")");
  for (size_t k = 0; k < rsts.size(); k++)
    if (rsts[k] != int(k % 8))
      fail("corrupt JPEG data (RST" + std::to_string(rsts[k]) + " where RST" +
           std::to_string(k % 8) + " belongs)");
  Step step = !fr.progressive ? SEQUENTIAL
              : sc.ss == 0    ? (sc.ah ? DC_REFINE : DC_FIRST)
                              : (sc.ah ? AC_REFINE : AC_FIRST);
  for (int64_t s_i = 0; s_i < n_int; s_i++) {
    Bits bits(segs[s_i].data(), segs[s_i].size());
    for (auto* c : sc.comps) c->dc_pred = 0;
    fr.eobrun = 0;
    int64_t end = std::min(n_mcu, (s_i + 1) * ri);
    for (int64_t i = s_i * ri; i < end; i++) {
      if (single) {
        Component& c = *sc.comps[0];
        size_t off = (size_t(i / c.wib) * c.bw + size_t(i % c.wib)) * 64;
        decode_block(fr, bits, c, off, sc, step);
        continue;
      }
      int64_t my = i / fr.mcux, mx = i % fr.mcux;
      for (auto* c : sc.comps)
        for (int v = 0; v < c->v; v++)
          for (int h = 0; h < c->h; h++) {
            size_t off = ((size_t(my) * c->v + v) * c->bw + size_t(mx) * c->h + h) * 64;
            decode_block(fr, bits, *c, off, sc, step);
          }
    }
    bits.check_end();
  }
}

inline int64_t descale(int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; }

// one jpeg_idct_islow pass over in[0..7] (stride `is`), DESCALEd into out (stride `os`)
template <typename In, typename Out, typename F>
inline void idct_1d(const In* in, int is, Out* out, int os, int shift, F store) {
  int64_t z2 = in[2 * is], z3 = in[6 * is];
  int64_t z1 = (z2 + z3) * FIX_0_541196100;
  int64_t tmp2 = z1 - z3 * FIX_1_847759065;
  int64_t tmp3 = z1 + z2 * FIX_0_765366865;
  int64_t tmp0 = (int64_t(in[0]) + in[4 * is]) * (int64_t(1) << CONST_BITS);
  int64_t tmp1 = (int64_t(in[0]) - in[4 * is]) * (int64_t(1) << CONST_BITS);
  int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  tmp0 = in[7 * is];
  tmp1 = in[5 * is];
  tmp2 = in[3 * is];
  tmp3 = in[1 * is];
  z1 = tmp0 + tmp3;
  z2 = tmp1 + tmp2;
  z3 = tmp0 + tmp2;
  int64_t z4 = tmp1 + tmp3;
  int64_t z5 = (z3 + z4) * FIX_1_175875602;
  tmp0 *= FIX_0_298631336;
  tmp1 *= FIX_2_053119869;
  tmp2 *= FIX_3_072711026;
  tmp3 *= FIX_1_501321110;
  z1 *= -FIX_0_899976223;
  z2 *= -FIX_2_562915447;
  z3 = z3 * -FIX_1_961570560 + z5;
  z4 = z4 * -FIX_0_390180644 + z5;
  tmp0 += z1 + z3;
  tmp1 += z2 + z4;
  tmp2 += z2 + z3;
  tmp3 += z1 + z4;
  store(out[0 * os], descale(tmp10 + tmp3, shift));
  store(out[7 * os], descale(tmp10 - tmp3, shift));
  store(out[1 * os], descale(tmp11 + tmp2, shift));
  store(out[6 * os], descale(tmp11 - tmp2, shift));
  store(out[2 * os], descale(tmp12 + tmp1, shift));
  store(out[5 * os], descale(tmp12 - tmp1, shift));
  store(out[3 * os], descale(tmp13 + tmp0, shift));
  store(out[4 * os], descale(tmp13 - tmp0, shift));
}

// a component's blocks -> its plane (bh * 8 rows of bw * 8 samples)
std::vector<uint8_t> plane(const Frame& fr, const Component& c) {
  if (!fr.has_quant[c.tq]) fail("no quantization table " + std::to_string(c.tq));
  const int* q = fr.quant[c.tq];
  size_t stride = size_t(c.bw) * 8;
  std::vector<uint8_t> out(stride * size_t(c.bh) * 8);
  int64_t x[64];
  int ws[64];
  for (int by = 0; by < c.bh; by++)
    for (int bx = 0; bx < c.bw; bx++) {
      const int32_t* blk = c.coef.data() + (size_t(by) * c.bw + bx) * 64;
      for (int k = 0; k < 64; k++) x[k] = int64_t(blk[k]) * q[k];
      for (int col = 0; col < 8; col++)
        idct_1d(x + col, 8, ws + col, 8, CONST_BITS - PASS1_BITS,
                [](int& o, int64_t v) { o = int(v); });
      uint8_t* dst = out.data() + size_t(by) * 8 * stride + size_t(bx) * 8;
      for (int row = 0; row < 8; row++)
        idct_1d(ws + row * 8, 1, dst + row * stride, 1, CONST_BITS + PASS1_BITS + 3,
                [](uint8_t& o, int64_t v) { o = kTables.idct_limit[v & RANGE_MASK]; });
    }
  return out;
}

// a component's plane -> (height, width), by jinit_upsampler's choice at full
// scale with fancy upsampling on; edges repeat the last real sample
std::vector<uint8_t> upsample(const Frame& fr, const Component& c, const std::vector<uint8_t>& p) {
  const int H = fr.height, W = fr.width, dw = c.dw, dh = c.dh;
  const size_t ps = size_t(c.bw) * 8;
  std::vector<uint8_t> out(size_t(H) * W);
  auto at = [&](int y, int x) -> int { return p[size_t(y) * ps + x]; };
  if (c.h == fr.hmax && c.v == fr.vmax) {
    for (int y = 0; y < H; y++) std::memcpy(&out[size_t(y) * W], &p[size_t(y) * ps], W);
    return out;
  }
  if (2 * c.h == fr.hmax && c.v == fr.vmax && dw > 2) {  // h2v1_fancy_upsample
    for (int y = 0; y < H; y++)
      for (int x = 0; x < W; x++) {
        int i = x >> 1, me = 3 * at(y, i);
        out[size_t(y) * W + x] = (x & 1) ? uint8_t((me + at(y, std::min(i + 1, dw - 1)) + 2) >> 2)
                                         : uint8_t((me + at(y, std::max(i - 1, 0)) + 1) >> 2);
      }
    return out;
  }
  if (c.h == fr.hmax && 2 * c.v == fr.vmax) {  // h1v2_fancy_upsample
    for (int y = 0; y < H; y++) {
      int j = y >> 1, far = (y & 1) ? std::min(j + 1, dh - 1) : std::max(j - 1, 0),
          bias = (y & 1) ? 2 : 1;
      for (int x = 0; x < W; x++)
        out[size_t(y) * W + x] = uint8_t((3 * at(j, x) + at(far, x) + bias) >> 2);
    }
    return out;
  }
  if (2 * c.h == fr.hmax && 2 * c.v == fr.vmax && dw > 2) {  // h2v2_fancy_upsample
    std::vector<int> sums(dw);
    for (int y = 0; y < H; y++) {
      int j = y >> 1, far = (y & 1) ? std::min(j + 1, dh - 1) : std::max(j - 1, 0);
      for (int i = 0; i < dw; i++) sums[i] = 3 * at(j, i) + at(far, i);
      for (int x = 0; x < W; x++) {
        int i = x >> 1, me = 3 * sums[i];
        out[size_t(y) * W + x] = (x & 1) ? uint8_t((me + sums[std::min(i + 1, dw - 1)] + 7) >> 4)
                                         : uint8_t((me + sums[std::max(i - 1, 0)] + 8) >> 4);
      }
    }
    return out;
  }
  if (fr.hmax % c.h == 0 && fr.vmax % c.v == 0) {  // int_upsample and the plain h2v1/h2v2
    int fx = fr.hmax / c.h, fy = fr.vmax / c.v;
    for (int y = 0; y < H; y++)
      for (int x = 0; x < W; x++) out[size_t(y) * W + x] = uint8_t(at(y / fy, x / fx));
    return out;
  }
  fail("sampling ratio " + std::to_string(fr.hmax) + "/" + std::to_string(c.h) + " x " +
       std::to_string(fr.vmax) + "/" + std::to_string(c.v) + " is not a whole number");
}

bool rgb_colour_space(const Frame& fr) {  // default_decompress_parms (jdapimin.c)
  if (fr.jfif) return false;
  if (fr.adobe >= 0) return fr.adobe == 0;
  return fr.comps[0].id == 82 && fr.comps[1].id == 71 && fr.comps[2].id == 66;
}

void check_smoothing(const Frame& fr) {  // jdcoefct.c smoothing_ok
  if (!fr.progressive) return;
  static const int kPos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
  bool useful = false;
  for (const auto& c : fr.comps) {
    if (!fr.has_quant[c.tq] || c.coef_bits[0] < 0) return;
    for (int i : kPos)
      if (fr.quant[c.tq][i] == 0) return;
    for (int k = 1; k < SMOOTHING_COEFS; k++) useful |= c.coef_bits[k] != 0;
  }
  if (useful)
    fail("a progressive file whose scans leave coefficient bits unknown (libjpeg's block "
         "smoothing) is not decoded");
}

// walk the markers, decoding each scan; with header_only stop at the frame header
void read(Frame& fr, const uint8_t* data, size_t n, bool header_only, int* nf_out) {
  if (n < 4 || data[0] != 0xFF || data[1] != 0xD8) fail("not a JPEG file (no SOI marker)");
  size_t p = 2;
  int scans = 0;
  while (true) {
    if (p >= n) fail("truncated JPEG data (no EOI marker)");
    if (data[p] != 0xFF)
      fail("corrupt JPEG data (0x" + hex2(data[p]) + " where a marker belongs, offset " +
           std::to_string(p) + ")");
    while (p < n && data[p] == 0xFF) p++;
    if (p >= n) fail("truncated JPEG data (no EOI marker)");
    int m = data[p++];
    if (m == 0xD9) break;
    if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
    if (p + 2 > n || u16(data + p) < 2 || p + u16(data + p) > n)
      fail("truncated JPEG data (marker 0xFF" + hex2(m) + ")");
    size_t a = p + 2, b = p + u16(data + p);
    p = b;
    const uint8_t* d = data + a;
    int len = int(b - a);
    if (is_sof(m)) {
      if (header_only) {
        if (len < 6) fail("truncated frame header (marker 0xFF" + hex2(m) + ")");
        fr.height = u16(d + 1);
        fr.width = u16(d + 3);
        *nf_out = d[5];
        return;
      }
      parse_sof(fr, m, d, len);
    } else if (const char* what = refused(m)) {
      fail(std::string(what) + " is not decoded (marker 0xFF" + hex2(m) + ")");
    } else if (m == 0xDB) {
      parse_dqt(fr, d, len);
    } else if (m == 0xC4) {
      parse_dht(fr, d, len);
    } else if (m == 0xDD) {
      if (len < 2) fail("truncated restart interval (marker 0xFFDD)");
      fr.restart = u16(d);
    } else if (m >= 0xE0 && m <= 0xEF) {  // examine_app0 / examine_app14
      if (m == 0xE0 && len >= 14 && std::memcmp(d, "JFIF\0", 5) == 0) fr.jfif = true;
      if (m == 0xEE && len >= 12 && std::memcmp(d, "Adobe", 5) == 0) fr.adobe = d[11];
    } else if (m == 0xFE) {
    } else if (m == 0xDC) {
      fail("a DNL marker is not decoded (marker 0xFFDC)");
    } else if (m == 0xDA) {
      if (fr.comps.empty()) fail("a scan before the frame header (marker 0xFFDA)");
      Scan sc = parse_sos(fr, d, len);
      std::vector<std::vector<uint8_t>> segs;
      std::vector<int> rsts;
      p = scan_data(data, n, b, segs, rsts);
      decode_scan(fr, sc, segs, rsts);
      scans++;
    } else {
      fail("unknown marker 0xFF" + hex2(m));
    }
  }
  if (fr.comps.empty()) fail("no frame header before EOI");
  if (!scans) fail("no scan before EOI");
}

void write_error(const char* msg, char* err, int32_t errlen) {
  if (err && errlen > 0) {
    std::strncpy(err, msg, size_t(errlen) - 1);
    err[errlen - 1] = 0;
  }
}

}  // namespace

extern "C" {

int cosypose_jpeg_info(const uint8_t* data, int64_t n, int32_t* hwc, char* err, int32_t errlen) {
  try {
    Frame fr;
    int nf = 0;
    read(fr, data, size_t(n), true, &nf);
    hwc[0] = fr.height;
    hwc[1] = fr.width;
    hwc[2] = nf;
    return 0;
  } catch (const Error& e) {
    write_error(e.msg.c_str(), err, errlen);
  } catch (const std::exception& e) {
    write_error(e.what(), err, errlen);
  }
  return 1;
}

int cosypose_jpeg_decode(const uint8_t* data, int64_t n, uint8_t* out, int64_t out_size,
                         char* err, int32_t errlen) {
  try {
    Frame fr;
    read(fr, data, size_t(n), false, nullptr);
    check_smoothing(fr);
    const size_t npix = size_t(fr.height) * fr.width;
    if (out_size != int64_t(npix * fr.comps.size())) fail("output buffer of the wrong size");
    std::vector<std::vector<uint8_t>> planes;
    for (const auto& c : fr.comps) planes.push_back(upsample(fr, c, plane(fr, c)));
    if (planes.size() == 1) {
      std::memcpy(out, planes[0].data(), npix);
      return 0;
    }
    const uint8_t *y = planes[0].data(), *cb = planes[1].data(), *cr = planes[2].data();
    if (rgb_colour_space(fr)) {
      for (size_t i = 0; i < npix; i++) {
        out[3 * i] = y[i];
        out[3 * i + 1] = cb[i];
        out[3 * i + 2] = cr[i];
      }
      return 0;
    }
    auto clamp = [](int v) { return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v); };
    for (size_t i = 0; i < npix; i++) {  // ycc_rgb_convert
      int Y = y[i];
      out[3 * i] = clamp(Y + kTables.cr_r[cr[i]]);
      out[3 * i + 1] = clamp(Y + int((kTables.cb_g[cb[i]] + kTables.cr_g[cr[i]]) >> SCALEBITS));
      out[3 * i + 2] = clamp(Y + kTables.cb_b[cb[i]]);
    }
    return 0;
  } catch (const Error& e) {
    write_error(e.msg.c_str(), err, errlen);
  } catch (const std::exception& e) {
    write_error(e.what(), err, errlen);
  }
  return 1;
}

}  // extern "C"
