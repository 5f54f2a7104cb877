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
#include <array>
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
// jdarith.c
constexpr int NUM_ARITH_TBLS = 16, DC_STAT_BINS = 64, AC_STAT_BINS = 256;

// T.81 Table D.2 (libjpeg's jaricom.c): Qe, Next_Index_LPS and the states whose
// LPS switches the MPS sense; Next_Index_MPS is the next state but for the jumps
// below. State 113 is the fixed 0.5 bin.
const uint16_t kQe[114] = {
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
    0x5a10, 0x5522, 0x59eb, 0x5a1d};
const uint8_t kNextLps[114] = {
    1,   14,  16,  18,  20,  23,  25,  28,  30,  33,  35,  9,   10,  12,  15,  36,  38,  39, 40,
    42,  43,  45,  46,  48,  49,  51,  52,  54,  56,  57,  59,  60,  62,  63,  32,  33,  37, 64,
    65,  67,  68,  69,  70,  72,  73,  74,  75,  77,  78,  79,  48,  50,  50,  51,  52,  53, 54,
    55,  56,  57,  58,  59,  61,  61,  65,  80,  81,  82,  83,  84,  86,  87,  87,  72,  72, 74,
    74,  75,  77,  77,  80,  88,  89,  90,  91,  92,  93,  86,  88,  95,  96,  97,  99,  99, 93,
    95,  101, 102, 103, 104, 99,  105, 106, 107, 103, 105, 108, 109, 110, 111, 110, 112, 112, 113};

// jaricom.c's packing: Qe << 16 | Next_Index_MPS << 8 | Switch_MPS << 7 | Next_Index_LPS
struct Aritab {
  int32_t v[114];
  Aritab() {
    const int jumps[][2] = {{13, 13},   {35, 9},    {63, 32},   {79, 48},   {87, 71},
                            {94, 86},   {100, 93},  {104, 99},  {107, 103}, {109, 107},
                            {111, 109}, {112, 111}, {113, 113}};
    const int switches[] = {0, 14, 36, 64, 80, 88, 95, 105, 110, 112};
    for (int i = 0; i < 114; i++) {
      int next_mps = i + 1, sw = 0;
      for (const auto& j : jumps)
        if (j[0] == i) next_mps = j[1];
      for (int k : switches) sw |= k == i;
      v[i] = (int32_t(kQe[i]) << 16) | (next_mps << 8) | (sw << 7) | kNextLps[i];
    }
  }
};
const Aritab kAritab;

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
  std::vector<int32_t> coef;  // coefficients, or a lossless file's samples
  int coef_bits[64] = {};
  int dc_pred = 0, dc_ctx = 0;
  int pt = 0;  // a lossless scan's point transform
};

struct Huffman {
  std::vector<uint16_t> lut;  // next 16 bits -> (length << 8) | symbol; 0: no code
};

struct Frame {
  int quant[4][64];
  bool has_quant[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  int restart = 0;
  bool progressive = false, arithmetic = false, lossless = false, jfif = false;
  int adobe = -1;
  int height = 0, width = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  std::vector<Component> comps;
  int eobrun = 0;
  // DAC conditioning (jdmarker.c get_soi's defaults) and the statistics bins
  int arith_dc_L[NUM_ARITH_TBLS], arith_dc_U[NUM_ARITH_TBLS], arith_ac_K[NUM_ARITH_TBLS];
  uint8_t dc_stats[NUM_ARITH_TBLS][DC_STAT_BINS], ac_stats[NUM_ARITH_TBLS][AC_STAT_BINS];
  uint8_t fixed_bin[4] = {113, 0, 0, 0};
  Frame() {
    for (int i = 0; i < NUM_ARITH_TBLS; i++) {
      arith_dc_L[i] = 0;
      arith_dc_U[i] = 1;
      arith_ac_K[i] = 5;
    }
  }
};

inline int u16(const uint8_t* d) { return (d[0] << 8) | d[1]; }

const char* refused(int m) {
  switch (m) {
    case 0xC5: return "hierarchical coding (SOF5)";
    case 0xC6: return "hierarchical coding (SOF6)";
    case 0xC7: return "hierarchical coding (SOF7)";
    case 0xCB: return "lossless arithmetic coding (SOF11)";
    case 0xCD: return "hierarchical coding (SOF13)";
    case 0xCE: return "hierarchical coding (SOF14)";
    case 0xCF: return "hierarchical coding (SOF15)";
    case 0xDE: return "hierarchical coding (DHP)";
    case 0xDF: return "hierarchical coding (EXP)";
    default: return nullptr;
  }
}

bool decoded_sof(int m) {
  return m == 0xC0 || m == 0xC1 || m == 0xC2 || m == 0xC3 || m == 0xC9 || m == 0xCA;
}

bool is_sof(int m) { return decoded_sof(m) || (refused(m) && m != 0xDE && m != 0xDF); }

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
  if (nf != 1 && nf != 3 && nf != 4)
    fail(std::to_string(nf) + " components are not decoded (" + mk + "; 1, 3 or 4)");
  if (len < 6 + 3 * nf) fail("truncated frame header (" + mk + ")");
  fr.progressive = m == 0xC2 || m == 0xCA;
  fr.arithmetic = m == 0xC9 || m == 0xCA;
  fr.lossless = m == 0xC3;
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
  const int unit = fr.lossless ? 1 : 8;  // a lossless data unit is one sample
  fr.mcux = (fr.width + unit * fr.hmax - 1) / (unit * fr.hmax);
  fr.mcuy = (fr.height + unit * fr.vmax - 1) / (unit * fr.vmax);
  for (auto& c : fr.comps) {
    c.dw = (fr.width * c.h + fr.hmax - 1) / fr.hmax;
    c.dh = (fr.height * c.v + fr.vmax - 1) / fr.vmax;
    c.wib = (c.dw + unit - 1) / unit;
    c.hib = (c.dh + unit - 1) / unit;
    c.bw = fr.mcux * c.h;
    c.bh = fr.mcuy * c.v;
    c.coef.assign(size_t(c.bw) * c.bh * unit * unit, 0);
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

void parse_dac(Frame& fr, const uint8_t* d, int len) {  // jdmarker.c get_dac
  if (len % 2) fail("bad arithmetic conditioning table (marker 0xFFCC)");
  for (int p = 0; p < len; p += 2) {
    int index = d[p], val = d[p + 1];
    if (index >= 2 * NUM_ARITH_TBLS)
      fail("bad arithmetic conditioning table index " + std::to_string(index) +
           " (marker 0xFFCC)");
    if (index >= NUM_ARITH_TBLS) {
      fr.arith_ac_K[index - NUM_ARITH_TBLS] = val;
    } else {
      fr.arith_dc_L[index] = val & 15;
      fr.arith_dc_U[index] = val >> 4;
      if ((val & 15) > (val >> 4))
        fail("bad arithmetic conditioning value " + std::to_string(val) + " (marker 0xFFCC)");
    }
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

// T.81 Annex D's decoder as jdarith.c runs it over one unstuffed segment: a
// state byte per context (index | MPS << 7); past the segment's end it reads
// zero bytes, as libjpeg does after a marker
struct Arith {
  const uint8_t* seg;
  size_t len, pos = 0;
  int64_t c = 0, a = 0;
  int ct = -16;
  Arith(const uint8_t* s, size_t l) : seg(s), len(l) {}
  inline int decode(uint8_t* st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        int data = pos < len ? seg[pos++] : 0;
        c = (c << 8) | data;
        if ((ct += 8) < 0)
          if (++ct == 0) a = 0x8000;
      }
      a <<= 1;
    }
    int sv = *st;
    int32_t qe = kAritab.v[sv & 0x7F];
    int nl = qe & 0xFF, nm = (qe >> 8) & 0xFF;
    qe >>= 16;
    a -= qe;
    int64_t temp = a << ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {
        *st = uint8_t((sv & 0x80) ^ nm);
      } else {
        *st = uint8_t((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
      a = qe;
    } else if (a < 0x8000) {
      if (a < qe) {
        *st = uint8_t((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = uint8_t((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
};

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
    if (!fr.arithmetic && (c->td > 3 || c->ta > 3)) fail("bad scan header (marker 0xFFDA)");
    sc.comps.push_back(c);
  }
  int q = 1 + 2 * ns;
  sc.ss = d[q];
  sc.se = d[q + 1];
  sc.ah = d[q + 2] >> 4;
  sc.al = d[q + 2] & 15;
  bool bad;
  if (fr.lossless)  // Ss is the predictor, Al the point transform (jdlossls.c)
    bad = sc.ss < 1 || sc.ss > 7 || sc.se != 0 || sc.ah || sc.al >= 8;
  else if (fr.progressive)
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
    if (fr.arithmetic) continue;  // tables 0-15, conditioned by DAC or its defaults
    if ((fr.lossless || (sc.ss == 0 && (!sc.ah || !fr.progressive))) && fr.dc[c->td].lut.empty())
      fail("no DC Huffman table " + std::to_string(c->td) + " (marker 0xFFDA)");
    if (sc.se > 0 && fr.ac[c->ta].lut.empty())
      fail("no AC Huffman table " + std::to_string(c->ta) + " (marker 0xFFDA)");
  }
  if (!fr.lossless)
    for (auto* c : sc.comps)
      for (int k = sc.ss; k <= sc.se; k++) c->coef_bits[k] = sc.al;
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

// -- arithmetic-coded blocks (jdarith.c) ------------------------------------------

// the statistics a scan's start and each restart clear (start_pass, process_restart)
void arith_reset(Frame& fr, const Scan& sc) {
  for (auto* c : sc.comps) {
    if (!fr.progressive || (sc.ss == 0 && sc.ah == 0))
      std::memset(fr.dc_stats[c->td], 0, DC_STAT_BINS);
    if (!fr.progressive || sc.ss) std::memset(fr.ac_stats[c->ta], 0, AC_STAT_BINS);
  }
}

// Figures F.19-F.24: the DC difference, updating the component's context
int arith_dc_diff(Frame& fr, Arith& dec, Component& c) {
  uint8_t* stats = fr.dc_stats[c.td];
  int st = c.dc_ctx;
  if (!dec.decode(stats + st)) {
    c.dc_ctx = 0;
    return 0;
  }
  int sign = dec.decode(stats + st + 1);
  st += 2 + sign;
  int m = dec.decode(stats + st);
  if (m) {
    st = 20;
    while (dec.decode(stats + st)) {
      if ((m <<= 1) == 0x8000) fail("corrupt JPEG data (arithmetic-coded magnitude overflow)");
      st++;
    }
  }
  if (m < (1 << fr.arith_dc_L[c.td]) >> 1)
    c.dc_ctx = 0;
  else if (m > (1 << fr.arith_dc_U[c.td]) >> 1)
    c.dc_ctx = 12 + sign * 4;
  else
    c.dc_ctx = 4 + sign * 4;
  int v = m;
  st += 14;
  while (m >>= 1)
    if (dec.decode(stats + st)) v |= m;
  v += 1;
  return sign ? -v : v;
}

// Figures F.21-F.24 from bin st (after SE's S0 + 1 outcome): an AC value
int arith_ac_value(Frame& fr, Arith& dec, const Component& c, int st, int k) {
  uint8_t* stats = fr.ac_stats[c.ta];
  int sign = dec.decode(fr.fixed_bin);
  st += 2;
  int m = dec.decode(stats + st);
  if (m && dec.decode(stats + st)) {
    m <<= 1;
    st = k <= fr.arith_ac_K[c.ta] ? 189 : 217;
    while (dec.decode(stats + st)) {
      if ((m <<= 1) == 0x8000) fail("corrupt JPEG data (arithmetic-coded magnitude overflow)");
      st++;
    }
  }
  int v = m;
  st += 14;
  while (m >>= 1)
    if (dec.decode(stats + st)) v |= m;
  v += 1;
  return sign ? -v : v;
}

inline void arith_block(Frame& fr, Arith& dec, Component& c, size_t off, const Scan& sc,
                        Step step) {
  int32_t* coef = c.coef.data() + off;
  uint8_t* stats = fr.ac_stats[c.ta];
  switch (step) {
    case SEQUENTIAL: {
      c.dc_pred = (c.dc_pred + arith_dc_diff(fr, dec, c)) & 0xFFFF;
      coef[0] = int16_t(uint16_t(c.dc_pred));
      for (int k = 0; k < 63;) {
        int st = 3 * k;
        if (dec.decode(stats + st)) break;
        for (;;) {
          k++;
          if (dec.decode(stats + st + 1)) break;
          st += 3;
          if (k >= 63) fail("corrupt JPEG data (arithmetic-coded run past the block)");
        }
        coef[kZigzag[k]] = arith_ac_value(fr, dec, c, st, k);
      }
      return;
    }
    case DC_FIRST:
      c.dc_pred += arith_dc_diff(fr, dec, c);
      coef[0] = int32_t(uint32_t(c.dc_pred) << sc.al);
      return;
    case DC_REFINE:
      if (dec.decode(fr.fixed_bin)) coef[0] |= 1 << sc.al;
      return;
    case AC_FIRST:
      for (int k = sc.ss; k <= sc.se; k++) {
        int st = 3 * (k - 1);
        if (dec.decode(stats + st)) break;
        while (!dec.decode(stats + st + 1)) {
          st += 3;
          if (++k > sc.se) fail("corrupt JPEG data (arithmetic-coded run past the band)");
        }
        coef[kZigzag[k]] = int32_t(uint32_t(arith_ac_value(fr, dec, c, st, k)) << sc.al);
      }
      return;
    case AC_REFINE: {
      int p1 = 1 << sc.al, m1 = -(1 << sc.al);
      int kex = sc.se;
      while (kex > 0 && !coef[kZigzag[kex]]) kex--;
      for (int k = sc.ss; k <= sc.se; k++) {
        int st = 3 * (k - 1);
        if (k > kex && dec.decode(stats + st)) break;
        for (;;) {
          int32_t& z = coef[kZigzag[k]];
          if (z) {
            if (dec.decode(stats + st + 2)) z += z < 0 ? m1 : p1;
            break;
          }
          if (dec.decode(stats + st + 1)) {
            z = dec.decode(fr.fixed_bin) ? m1 : p1;
            break;
          }
          st += 3;
          if (++k > sc.se) fail("corrupt JPEG data (arithmetic-coded run past the band)");
        }
      }
      return;
    }
  }
}

// -- lossless samples (jdlhuff.c, jdlossls.c) ------------------------------------------

// Huffman-coded differences undone by T.81 Annex H's predictor. Each restart
// interval is whole MCU rows (libjpeg-turbo's rule); its first row of each
// component predicts from the left, the first sample from 2^(7 - Pt), every
// other row's first sample from above.
void lossless_scan(Frame& fr, const Scan& sc, const std::vector<std::vector<uint8_t>>& segs,
                   int64_t n_mcu, int64_t ri) {
  bool single = sc.comps.size() == 1;
  int64_t per_row = single ? sc.comps[0]->wib : fr.mcux;
  if (fr.restart && fr.restart % per_row)
    fail("a lossless restart interval of " + std::to_string(fr.restart) +
         " MCUs is not a whole number of MCU rows (" + std::to_string(per_row) + " MCUs)");
  const int predictor = sc.ss;
  for (auto* c : sc.comps) c->pt = sc.al;
  for (size_t s_i = 0; s_i < segs.size(); s_i++) {
    Bits bits(segs[s_i].data(), segs[s_i].size());
    int64_t first = int64_t(s_i) * ri / per_row;  // the interval's first MCU row
    int64_t end = std::min(n_mcu, int64_t(s_i + 1) * ri);
    auto sample = [&](Component& c, int64_t y, int64_t x) {
      int s = bits.huff(fr.dc[c.td]);
      if (s > 16) fail("corrupt JPEG data (difference category above 16)");
      int diff = s == 16 ? 32768 : s ? extend(bits.bits(s), s) : 0;
      int32_t* row = c.coef.data() + size_t(y) * c.bw;
      int pred;
      if (y == first * (single ? 1 : c.v)) {
        pred = x ? row[x - 1] : 1 << (7 - c.pt);
      } else if (x == 0) {
        pred = row[x - c.bw];
      } else {
        int ra = row[x - 1], rb = row[x - c.bw], rc = row[x - c.bw - 1];
        switch (predictor) {
          case 1: pred = ra; break;
          case 2: pred = rb; break;
          case 3: pred = rc; break;
          case 4: pred = ra + rb - rc; break;
          case 5: pred = ra + ((rb - rc) >> 1); break;
          case 6: pred = rb + ((ra - rc) >> 1); break;
          default: pred = (ra + rb) >> 1; break;
        }
      }
      row[x] = (diff + pred) & 0xFFFF;
    };
    for (int64_t i = int64_t(s_i) * ri; i < end; i++) {
      if (single) {
        Component& c = *sc.comps[0];
        sample(c, i / c.wib, i % c.wib);
        continue;
      }
      int64_t my = i / fr.mcux, mx = i % fr.mcux;
      for (auto* c : sc.comps)
        for (int v = 0; v < c->v; v++)
          for (int h = 0; h < c->h; h++) sample(*c, my * c->v + v, mx * c->h + h);
    }
    bits.check_end();
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
  if (fr.lossless) {
    lossless_scan(fr, sc, segs, n_mcu, ri);
    return;
  }
  Step step = !fr.progressive ? SEQUENTIAL
              : sc.ss == 0    ? (sc.ah ? DC_REFINE : DC_FIRST)
                              : (sc.ah ? AC_REFINE : AC_FIRST);
  for (int64_t s_i = 0; s_i < n_int; s_i++) {
    Bits bits(segs[s_i].data(), segs[s_i].size());
    Arith dec(segs[s_i].data(), segs[s_i].size());
    if (fr.arithmetic) arith_reset(fr, sc);
    for (auto* c : sc.comps) c->dc_pred = c->dc_ctx = 0;
    fr.eobrun = 0;
    auto block = [&](Component& c, size_t off) {
      if (fr.arithmetic)
        arith_block(fr, dec, c, off, sc, step);
      else
        decode_block(fr, bits, c, off, sc, step);
    };
    int64_t end = std::min(n_mcu, (s_i + 1) * ri);
    for (int64_t i = s_i * ri; i < end; i++) {
      if (single) {
        Component& c = *sc.comps[0];
        block(c, (size_t(i / c.wib) * c.bw + size_t(i % c.wib)) * 64);
        continue;
      }
      int64_t my = i / fr.mcux, mx = i % fr.mcux;
      for (auto* c : sc.comps)
        for (int v = 0; v < c->v; v++)
          for (int h = 0; h < c->h; h++)
            block(*c, ((size_t(my) * c->v + v) * c->bw + size_t(mx) * c->h + h) * 64);
    }
    if (!fr.arithmetic) bits.check_end();
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

// a component's blocks (its coefficients, or `coef`) -> its plane (bh * 8 rows
// of bw * 8 samples)
std::vector<uint8_t> plane(const Frame& fr, const Component& c, const int32_t* coef = nullptr) {
  if (fr.lossless) {  // jdlossls.c's scaler: the sample << Pt, cast to 8 bits
    std::vector<uint8_t> out(c.coef.size());
    for (size_t i = 0; i < out.size(); i++) out[i] = uint8_t(c.coef[i] << c.pt);
    return out;
  }
  if (!fr.has_quant[c.tq]) fail("no quantization table " + std::to_string(c.tq));
  const int* q = fr.quant[c.tq];
  size_t stride = size_t(c.bw) * 8;
  std::vector<uint8_t> out(stride * size_t(c.bh) * 8);
  int64_t x[64];
  int ws[64];
  for (int by = 0; by < c.bh; by++)
    for (int bx = 0; bx < c.bw; bx++) {
      const int32_t* blk = (coef ? coef : c.coef.data()) + (size_t(by) * c.bw + bx) * 64;
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
  const size_t ps = size_t(c.bw) * (fr.lossless ? 1 : 8);
  const bool fancy = !fr.lossless;  // a lossless file's one-sample units are replicated
  std::vector<uint8_t> out(size_t(H) * W);
  auto at = [&](int y, int x) -> int { return p[size_t(y) * ps + x]; };
  if (c.h == fr.hmax && c.v == fr.vmax) {
    for (int y = 0; y < H; y++) std::memcpy(&out[size_t(y) * W], &p[size_t(y) * ps], W);
    return out;
  }
  if (fancy && 2 * c.h == fr.hmax && c.v == fr.vmax && dw > 2) {  // h2v1_fancy_upsample
    for (int y = 0; y < H; y++)
      for (int x = 0; x < W; x++) {
        int i = x >> 1, me = 3 * at(y, i);
        out[size_t(y) * W + x] = (x & 1) ? uint8_t((me + at(y, std::min(i + 1, dw - 1)) + 2) >> 2)
                                         : uint8_t((me + at(y, std::max(i - 1, 0)) + 1) >> 2);
      }
    return out;
  }
  if (fancy && c.h == fr.hmax && 2 * c.v == fr.vmax) {  // h1v2_fancy_upsample
    for (int y = 0; y < H; y++) {
      int j = y >> 1, far = (y & 1) ? std::min(j + 1, dh - 1) : std::max(j - 1, 0),
          bias = (y & 1) ? 2 : 1;
      for (int x = 0; x < W; x++)
        out[size_t(y) * W + x] = uint8_t((3 * at(j, x) + at(far, x) + bias) >> 2);
    }
    return out;
  }
  if (fancy && 2 * c.h == fr.hmax && 2 * c.v == fr.vmax && dw > 2) {  // h2v2_fancy_upsample
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

enum Space { GRAY, RGB, YCBCR, CMYK, YCCK };

Space colour_space(const Frame& fr) {  // default_decompress_parms (jdapimin.c)
  if (fr.comps.size() == 1) return GRAY;
  if (fr.comps.size() == 4) return fr.adobe > 0 ? YCCK : CMYK;
  if (fr.jfif) return YCBCR;
  if (fr.adobe >= 0) return fr.adobe == 0 ? RGB : YCBCR;
  int a = fr.comps[0].id, b = fr.comps[1].id, c = fr.comps[2].id;
  if ((a == 82 && b == 71 && c == 66) || (a == 1 && b == 2 && c == 3 && fr.lossless)) return RGB;
  return YCBCR;
}

// -- block smoothing (jdcoefct.c, libjpeg-turbo 2.1 on) -------------------------------

// zigzag 1-9's natural positions: the AC coefficients block smoothing estimates
const int kSmoothedAc[9] = {1, 8, 16, 9, 2, 3, 10, 17, 24};
struct Tap {
  int i, w;
};
// their estimates from the 5x5 window of DC values d[0..24] (row-major), a
// list of taps each, ending at w = 0: when some AC data is known (K.8 over
// 5x5; the first five) and when only DC data is (all nine, and the DC)
const Tap kAcKnown[5][13] = {
    {{10, -7}, {11, 50}, {13, -50}, {14, 7}, {0, 0}},
    {{2, -7}, {7, 50}, {17, -50}, {22, 7}, {0, 0}},
    {{2, -1}, {7, 13}, {12, -24}, {17, 13}, {22, -1}, {0, 0}},
    {{9, 1}, {15, 1}, {16, -10}, {18, 10}, {1, -1}, {19, -1}, {21, 1}, {23, -1}, {3, 1}, {5, -1},
     {6, 10}, {8, -10}, {0, 0}},
    {{10, -1}, {11, 13}, {12, -24}, {13, 13}, {14, -1}, {0, 0}}};
const Tap kDcOnly[9][21] = {
    {{0, -1}, {1, -1}, {3, 1}, {4, 1}, {5, -3}, {6, 13}, {8, -13}, {9, 3}, {10, -3}, {11, 38},
     {13, -38}, {14, 3}, {15, -3}, {16, 13}, {18, -13}, {19, 3}, {20, -1}, {21, -1}, {23, 1},
     {24, 1}, {0, 0}},
    {{0, -1}, {1, -3}, {2, -3}, {3, -3}, {4, -1}, {5, -1}, {6, 13}, {7, 38}, {8, 13}, {9, -1},
     {15, 1}, {16, -13}, {17, -38}, {18, -13}, {19, 1}, {20, 1}, {21, 3}, {22, 3}, {23, 3},
     {24, 1}, {0, 0}},
    {{2, 1}, {6, 2}, {7, 7}, {8, 2}, {11, -5}, {12, -14}, {13, -5}, {16, 2}, {17, 7}, {18, 2},
     {22, 1}, {0, 0}},
    {{0, -1}, {4, 1}, {6, 9}, {8, -9}, {16, -9}, {18, 9}, {20, 1}, {24, -1}, {0, 0}},
    {{6, 2}, {7, -5}, {8, 2}, {10, 1}, {11, 7}, {12, -14}, {13, 7}, {14, 1}, {16, 2}, {17, -5},
     {18, 2}, {0, 0}},
    {{6, 1}, {8, -1}, {11, 2}, {13, -2}, {16, 1}, {18, -1}, {0, 0}},
    {{6, 1}, {7, -3}, {8, 1}, {16, -1}, {17, 3}, {18, -1}, {0, 0}},
    {{6, 1}, {8, -1}, {11, -3}, {13, 3}, {16, 1}, {18, -1}, {0, 0}},
    {{6, 1}, {7, 2}, {8, 1}, {16, -1}, {17, -2}, {18, -1}, {0, 0}}};
const int kDcEstimate[25] = {-2, -6, -8, -6, -2, -6, 6,  42, 6,  -6, -8, 42, 152,
                             42, -8, -6, 6,  42, 6,  -6, -2, -6, -8, -6, -2};

// smoothing_ok: a progressive file's blocks are smoothed when every
// component's DC is at least partly known, its quantizers for the DC and the
// first nine AC coefficients are nonzero, and some of those AC coefficients'
// bits stay unknown after every scan
bool smoothing_ok(const Frame& fr) {
  if (!fr.progressive) return false;
  bool useful = false;
  for (const auto& c : fr.comps) {
    if (!fr.has_quant[c.tq] || c.coef_bits[0] < 0 || fr.quant[c.tq][0] == 0) return false;
    for (int p : kSmoothedAc)
      if (fr.quant[c.tq][p] == 0) return false;
    for (int k = 1; k < SMOOTHING_COEFS; k++) useful |= c.coef_bits[k] != 0;
  }
  return useful;
}

// ((q << 7) + |num|) / (q << 8) with num's sign, capped below 2^Al when Al > 0
inline int32_t estimate(int64_t num, int64_t q, int al) {
  int64_t mag = ((q << 7) + (num < 0 ? -num : num)) / (q << 8);
  if (al > 0 && mag >= (int64_t(1) << al)) mag = (int64_t(1) << al) - 1;
  return int32_t(num < 0 ? -mag : mag);
}

// decompress_smooth_data: the component's coefficients with zero
// low-frequency AC coefficients whose bits are not all known estimated from
// the 5x5 window of DC values around each block (the edge blocks repeated),
// and, when no AC data is known at all, the DC too. The window's rows follow
// libjpeg's iMCU-row arithmetic.
std::vector<int32_t> smoothed(const Frame& fr, const Component& c) {
  std::vector<int32_t> out = c.coef;
  const int* bits = c.coef_bits;
  const int* q = fr.quant[c.tq];
  bool change_dc = true;
  for (int k = 1; k < SMOOTHING_COEFS; k++) change_dc &= bits[k] == -1;
  const int total = fr.mcuy, v = c.v;
  std::vector<std::array<int, 5>> rows;
  for (int imcu = 0; imcu < total; imcu++) {
    int block_rows = imcu < total - 1 ? v : (c.hib % v ? c.hib % v : v);
    int image_rows = block_rows * total;
    for (int br = 0; br < block_rows; br++) {
      int ibr = imcu * block_rows + br, cur = imcu * v + br;
      int prev = ibr > 0 ? cur - 1 : cur, next = ibr < image_rows - 1 ? cur + 1 : cur;
      rows.push_back({ibr > 1 ? cur - 2 : prev, prev, cur, next, ibr < image_rows - 2 ? cur + 2 : next});
    }
  }
  auto dc_at = [&](int row, int col) { return int64_t(c.coef[(size_t(row) * c.bw + col) * 64]); };
  for (const auto& r : rows)
    for (int x = 0; x < c.wib; x++) {
      int64_t d[25];
      for (int i = 0; i < 5; i++)
        for (int j = 0; j < 5; j++) d[i * 5 + j] = dc_at(r[i], std::min(std::max(x + j - 2, 0), c.wib - 1));
      int32_t* ws = out.data() + (size_t(r[2]) * c.bw + x) * 64;
      const int n = change_dc ? 9 : 5;
      for (int k = 1; k <= n; k++) {
        int pos = kSmoothedAc[k - 1];
        if (bits[k] == 0 || ws[pos] != 0) continue;
        int64_t sum = 0;
        for (const Tap* t = change_dc ? kDcOnly[k - 1] : kAcKnown[k - 1]; t->w; t++) sum += t->w * d[t->i];
        ws[pos] = estimate(q[0] * sum, q[pos], bits[k]);
      }
      if (change_dc) {
        int64_t sum = 0;
        for (int i = 0; i < 25; i++) sum += kDcEstimate[i] * d[i];
        ws[0] = estimate(q[0] * sum, q[0], 0);
      }
    }
  return out;
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
    } else if (m == 0xCC) {
      parse_dac(fr, d, len);
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
    const bool smooth = smoothing_ok(fr);
    const Space space = colour_space(fr);
    if (fr.lossless && (space == YCBCR || space == YCCK))
      fail(std::string("lossless coding (SOF3) of ") + (space == YCBCR ? "YCbCr" : "YCCK") +
           " colour is not decoded (libjpeg converts no colour in lossless mode)");
    const size_t npix = size_t(fr.height) * fr.width;
    if (out_size != int64_t(npix * fr.comps.size())) fail("output buffer of the wrong size");
    std::vector<std::vector<uint8_t>> planes;
    for (const auto& c : fr.comps)
      planes.push_back(upsample(fr, c, smooth ? plane(fr, c, smoothed(fr, c).data()) : plane(fr, c)));
    if (planes.size() == 1) {
      std::memcpy(out, planes[0].data(), npix);
      return 0;
    }
    auto clamp = [](int v) { return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v); };
    const uint8_t *y = planes[0].data(), *cb = planes[1].data(), *cr = planes[2].data();
    if (planes.size() == 4) {  // as Pillow presents CMYK (raw mode CMYK;I, inverted)
      const uint8_t* k = planes[3].data();
      for (size_t i = 0; i < npix; i++) {
        if (space == YCCK) {  // ycck_cmyk_convert, then inverted: the clamped RGB
          int Y = y[i];
          out[4 * i] = clamp(Y + kTables.cr_r[cr[i]]);
          out[4 * i + 1] =
              clamp(Y + int((kTables.cb_g[cb[i]] + kTables.cr_g[cr[i]]) >> SCALEBITS));
          out[4 * i + 2] = clamp(Y + kTables.cb_b[cb[i]]);
        } else {
          out[4 * i] = uint8_t(255 - y[i]);
          out[4 * i + 1] = uint8_t(255 - cb[i]);
          out[4 * i + 2] = uint8_t(255 - cr[i]);
        }
        out[4 * i + 3] = uint8_t(255 - k[i]);
      }
      return 0;
    }
    if (space == RGB) {
      for (size_t i = 0; i < npix; i++) {
        out[3 * i] = y[i];
        out[3 * i + 1] = cb[i];
        out[3 * i + 2] = cr[i];
      }
      return 0;
    }
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
