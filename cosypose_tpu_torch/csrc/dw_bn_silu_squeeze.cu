// The depthwise half of an EfficientNet MBConv block in eval mode, for Hopper
// (sm_90a), in one launch:
//
//   y = silu(batchnorm_eval(depthwise_conv_same(x, w)))   (B, C, OH, OW)
//   s = mean of each (b, c) plane of y                     (B, C)
//
// as models/efficientnet.py MBConvBlock computes it; the plain version is
// ops/depthwise_cuda.py dw_bn_silu_squeeze_plain.
//
// Replaces no TPU kernel: the JAX package leaves this convolution, its
// BatchNorm, the swish and the squeeze's mean to XLA, which fuses them on the
// TPU. On the card ATen ran them as about seven launches a block (the pad's
// fill and copy, the weight's autocast cast, the depthwise conv, BatchNorm,
// SiLU, the mean), each of them reading and writing the whole activation.
//
// What it computes. x is (B, C, H, W), contiguous NCHW, of type T (float,
// bf16 or fp16); w (C, 1, k, k) float32, rounded to T first, as autocast
// rounds the conv's weight; k 3 or 5, stride 1 or 2. The padding is
// TensorFlow's "SAME": OH = ceil(H / stride), total padding p = max((OH - 1) *
// stride + k - H, 0), p // 2 of it above (and left). The k x k sums are
// float32 fused multiply-adds in the order (dy, dx); eval BatchNorm is folded
// from the running statistics on every call, scale = gamma * (1 / sqrt(var +
// eps)), shift = beta - mean * scale; the swish is z / (1 + exp(-z)) in
// float32 with the fast exponential and division (2 + 1.2 |z| float32 ulps,
// and 2); y is rounded to T once. s is the float32 sum of y's values as
// rounded, times 1 / (OH * OW), rounded to T: deterministic, since one block
// owns each plane and sums it in a fixed order (no atomics).
//
// Bound: bytes. Every input element is read once and every output written
// once, (B*C*H*W + B*C*OH*OW + B*C) elements; k*k multiply-adds an output is 2
// to 12 FLOP a byte in bf16, below the card's fp32 balance (~20 FLOP a byte).
// EfficientNet-B3's 26 blocks at B=64 and 240x320 move 2.34 GB: 0.70 ms at
// 3.35 TB/s. Design:
//  - NCHW planes are contiguous, so a block owns whole planes: the squeeze is a
//    reduction inside the block, with no atomics;
//  - a job is a group of P planes (at most 64: the late stages' 15x20 and 8x10
//    planes go many to a block, so that no block spends its work on 80
//    outputs) or a band of output rows of one large plane, its input rows
//    within kBandBytes of shared memory;
//  - the grid is as many blocks as the card holds at once, each walking its
//    jobs with two buffers: the copy of the next job is in flight (cp.async,
//    16, 8 or 4 bytes a copy as the rows' alignment allows) while the block
//    computes the current one, so the copies' latency is hidden in the block;
//  - in shared memory each row sits in a slot of Wp elements with the SAME
//    padding's zeros beside it (and whole zero rows above and below the
//    plane), so the stencil reads without a bounds test; the padded tensor
//    never exists in device memory;
//  - each thread computes tiles of kTileRows x kTileCols outputs, reading each
//    input row of a tile once into registers for every output row it feeds
//    (k5, stride 1: 4 shared-memory reads an output, where one output a thread
//    would take 25), with float32 fused multiply-adds; the group's parameters
//    come with its input into shared memory, and the k x k weights (rounded)
//    and folded BatchNorm into registers where a thread's tile changes plane;
//    a tile row is stored with one vector store where it is whole and aligned;
//  - a block's threads take the job's tiles in turn, across its planes, so
//    that small planes keep every thread busy; the copies are split over the
//    lanes with no division in the loop;
//  - the plane's sum, in a fixed order: a large plane's in each thread's
//    register over its tiles and bands, then shuffles and the warps' sums; a
//    small plane's tiles' sums in shared memory, added by a segment of lanes
//    a plane and shuffles.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;          // threads a block
constexpr int kTileCols = 4;           // output columns of a thread's tile
constexpr int kBandBytes = 32 * 1024;  // shared memory a job's input aims at
constexpr int kMaxPlanes = 64;         // planes a block, at most

// output rows of a thread's tile: fewer at stride 2, whose tiles read more
template <int S>
__host__ __device__ constexpr int tile_rows() { return S == 1 ? 4 : 2; }

template <typename T>
struct Cvt;
template <>
struct Cvt<float> {
  static __device__ __forceinline__ float to_f(float v) { return v; }
  static __device__ __forceinline__ float from_f(float v) { return v; }
};
template <>
struct Cvt<__nv_bfloat16> {
  static __device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
  static __device__ __forceinline__ __nv_bfloat16 from_f(float v) { return __float2bfloat16(v); }
};
template <>
struct Cvt<__half> {
  static __device__ __forceinline__ float to_f(__half v) { return __half2float(v); }
  static __device__ __forceinline__ __half from_f(float v) { return __float2half(v); }
};

// A 16-bit element of a 32-bit word (its low or high half) as a float.
template <typename T>
__device__ __forceinline__ float half_of(unsigned word, bool high);
template <>
__device__ __forceinline__ float half_of<__nv_bfloat16>(unsigned word, bool high) {
  return __uint_as_float(high ? word & 0xffff0000u : word << 16);
}
template <>
__device__ __forceinline__ float half_of<__half>(unsigned word, bool high) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>(high ? word >> 16 : word)));
}

// The N elements of a tile's input row from shared memory, src[0 ... N - 1],
// as floats: for a 16-bit T, 8-byte loads from the 4-element boundary OFF
// elements before src (OFF known at compile time), each element shifted out
// of its word; a float T element by element.
template <typename T, int N, int OFF>
__device__ __forceinline__ void read_row(float (&v)[N], const T* src) {
  if constexpr (sizeof(T) == 2) {
    constexpr int kWords = (OFF + N + 3) / 4;
    const uint2* words = reinterpret_cast<const uint2*>(src - OFF);
    unsigned h[2 * kWords];
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      const uint2 q = words[k];
      h[2 * k] = q.x;
      h[2 * k + 1] = q.y;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = half_of<T>(h[(OFF + i) / 2], (OFF + i) % 2);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = Cvt<T>::to_f(src[i]);
  }
}

// kTileCols elements of T in one store: 16 bytes of float, 8 of a 16-bit type
template <int BYTES>
struct VecOf;
template <>
struct VecOf<8> {
  using type = uint2;
};
template <>
struct VecOf<16> {
  using type = uint4;
};

__device__ __forceinline__ void cp_async(void* smem, const void* gmem, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

struct Shape {
  int BC, C, H, W, OH, OW;  // planes (B * C), channels, input and output sizes
  int pt, pl, pr;           // the SAME padding above, left and right
  int P, BR, bands;         // planes a job; output rows a band (OH where P > 1), bands a plane
  int NR, Wp;               // shared-memory rows a plane (a buffer) and their slot (elements)
  int copy;                 // bytes a cp.async (16, 8 or 4), or 0: element by element
  int groups;               // jobs' plane groups, ceil(BC / P)
};

// How a warp's lanes take a job's rows: `kstep` lanes a row (a row is `pieces`
// items: its copies, then its padding's zeros), `rows` rows a warp at once;
// lane `lane` takes row `row` of those and items item, item + kstep, ...
struct CopyLanes {
  int per, pieces, kstep, rows, row, item;
  __device__ CopyLanes(const Shape& sh, int esize, int lane) {
    per = sh.copy ? sh.copy / esize : 1;  // elements a copy
    pieces = (sh.W + per - 1) / per + 1;
    kstep = min(pieces, 32);
    rows = 32 / kstep;
    row = lane / kstep;
    item = lane - row * kstep;
  }
};

// The input of a job (group, band) into one buffer: rows [r0, r0 + nr) of
// each of its planes, row iy of plane p at slot (p * NR + iy - r0) * Wp, its
// element x at slot column kVec + x, the padding's zeros at columns kVec - pl
// ... kVec - 1 and kVec + W ... kVec + W + pr - 1, padding rows all zero.
// Copies go out as cp.async where sh.copy allows (committed by the caller);
// the zeros and an element-by-element copy are plain stores. No division: the
// lanes' split is CopyLanes', and each warp steps through the rows with a
// running (plane, row).
template <typename T>
__device__ __forceinline__ void issue(const T* __restrict__ x, T* buf, const Shape& sh,
                                      const CopyLanes& cl, long long q0, int planes, int r0,
                                      int nr) {
  constexpr int kVec = 16 / sizeof(T);
  if (cl.row >= cl.rows) return;
  const int warp = threadIdx.x >> 5, step = (kThreads / 32) * cl.rows;
  const long long HW = static_cast<long long>(sh.H) * sh.W;
  const int r = warp * cl.rows + cl.row;  // the first row, over the job's planes
  int p = r / nr, j = r - p * nr;  // then a running (plane, row)
  while (p < planes) {
    const int iy = r0 + j;
    T* slot = buf + (p * sh.NR + j) * sh.Wp;
    if (iy < 0 || iy >= sh.H) {  // a padding row: zeros
      for (int i = cl.item * kVec; i < sh.Wp; i += cl.kstep * kVec)
        *reinterpret_cast<uint4*>(slot + i) = make_uint4(0, 0, 0, 0);
    } else {
      const T* src = x + (q0 + p) * HW + static_cast<long long>(iy) * sh.W;
      for (int k = cl.item; k < cl.pieces; k += cl.kstep) {
        if (k == cl.pieces - 1) {  // the padding's zeros beside the row
          for (int i = 1; i <= sh.pl; ++i) slot[kVec - i] = Cvt<T>::from_f(0.f);
          for (int i = 0; i < sh.pr; ++i) slot[kVec + sh.W + i] = Cvt<T>::from_f(0.f);
        } else if (sh.copy) {
          cp_async(slot + kVec + k * cl.per, src + k * cl.per, sh.copy);
        } else {
          slot[kVec + k] = src[k];
        }
      }
    }
    j += step;
    while (j >= nr) {
      j -= nr;
      ++p;
    }
  }
}

// A group's parameters into one buffer, as they are in device memory (4-byte
// cp.async): the planes' k x k weights, then their BatchNorm weight, bias,
// running mean and running variance, P floats each. Plane q is channel q % C.
template <int K>
__device__ __forceinline__ void issue_params(float* wts, const float* __restrict__ w,
                                             const float* __restrict__ gamma,
                                             const float* __restrict__ beta,
                                             const float* __restrict__ mean,
                                             const float* __restrict__ var, const Shape& sh,
                                             long long q0, int planes) {
  const int c0 = static_cast<int>(q0 % sh.C);
  for (int i = threadIdx.x; i < planes * K * K; i += kThreads) {
    const int p = i / (K * K);
    cp_async(wts + i, w + ((c0 + p) % sh.C) * K * K + (i - p * K * K), 4);
  }
  float* dst = wts + sh.P * K * K;
  for (int i = threadIdx.x; i < 4 * planes; i += kThreads) {
    const int v = i / planes, p = i - v * planes;
    const float* src = v == 0 ? gamma : v == 1 ? beta : v == 2 ? mean : var;
    cp_async(dst + v * sh.P + p, src + (c0 + p) % sh.C, 4);
  }
}

// PL: the SAME padding left of the input (sh.pl), known at compile time so
// that a tile's rows are read with aligned loads.
template <typename T, int K, int S, int PL>
__global__ void __launch_bounds__(kThreads, 4)
    dw_bn_silu_squeeze_kernel(const T* __restrict__ x, const float* __restrict__ w,
                              const float* __restrict__ gamma, const float* __restrict__ beta,
                              const float* __restrict__ mean, const float* __restrict__ var,
                              float eps, T* __restrict__ y, T* __restrict__ s, Shape sh) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float warp_sums[kThreads / 32];
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kTileRows = tile_rows<S>();
  constexpr int kInRows = (kTileRows - 1) * S + K;  // input rows of a tile
  constexpr int kInCols = (kTileCols - 1) * S + K;  // input columns of a tile
  const int wts_floats = sh.P * (K * K + 4);        // a parameter buffer's
  // shared memory: two input buffers, two parameter buffers, the tiles' sums
  T* const buf0 = reinterpret_cast<T*>(smem_raw);
  T* const buf1 = buf0 + sh.P * sh.NR * sh.Wp;
  float* const wts0 = reinterpret_cast<float*>(buf1 + sh.P * sh.NR * sh.Wp);
  float* const wts1 = wts0 + wts_floats;
  float* const partial = wts1 + wts_floats;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const CopyLanes cl(sh, sizeof(T), lane);
  const int tile_cols = (sh.OW + kTileCols - 1) / kTileCols;
  // this block's jobs: groups blockIdx.x, + gridDim.x, ..., each in sh.bands bands
  const int my_groups = (sh.groups - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  const int jobs = my_groups * sh.bands;
  auto job_q0 = [&](int j) {
    const long long group = blockIdx.x + static_cast<long long>(j / sh.bands) * gridDim.x;
    return group * sh.P;
  };
  auto job_planes = [&](long long q0) {
    return static_cast<int>(min(static_cast<long long>(sh.P), sh.BC - q0));
  };
  auto job_issue = [&](int j) {
    const long long q0 = job_q0(j);
    const int planes = job_planes(q0);
    const int oy0 = (j % sh.bands) * sh.BR;
    const int oy1 = min(oy0 + sh.BR, sh.OH);
    issue<T>(x, (j & 1) ? buf1 : buf0, sh, cl, q0, planes, oy0 * S - sh.pt,
             (oy1 - oy0 - 1) * S + K);
    if (j % sh.bands == 0)  // a group's parameters, in the buffer of its parity
      issue_params<K>(((j / sh.bands) & 1) ? wts1 : wts0, w, gamma, beta, mean, var, sh, q0,
                      planes);
    cp_async_commit();
  };

  if (jobs > 0) job_issue(0);
  float sum = 0.f;  // P == 1: this thread's share of the plane's sum, over its bands
  for (int j = 0; j < jobs; ++j) {
    const long long q0 = job_q0(j);
    const int planes = job_planes(q0);
    const int band = j % sh.bands;
    const bool more = j + 1 < jobs;
    if (more) job_issue(j + 1);
    if (more) cp_async_wait<1>();
    else cp_async_wait<0>();
    __syncthreads();  // job j's input is in its buffer
    const int oy0 = band * sh.BR;
    const int oy1 = min(oy0 + sh.BR, sh.OH);
    const int tiles = ((oy1 - oy0 + kTileRows - 1) / kTileRows) * tile_cols;  // a plane's
    const T* data = (j & 1) ? buf1 : buf0;
    float* const wts = ((j / sh.bands) & 1) ? wts1 : wts0;
    if (band == 0) {  // the group's parameters in place: weights rounded, BatchNorm folded
      sum = 0.f;
      for (int i = tid; i < planes * K * K; i += kThreads)
        wts[i] = Cvt<T>::to_f(Cvt<T>::from_f(wts[i]));
      if (tid < planes) {  // gamma, beta -> scale, shift
        float* bn = wts + sh.P * K * K + tid;
        const float scale = bn[0] * (1.f / sqrtf(bn[3 * sh.P] + eps));
        bn[sh.P] = bn[sh.P] - bn[2 * sh.P] * scale;
        bn[0] = scale;
      }
      __syncthreads();
    }
    float wr[K * K];
    float scale = 0.f, shift = 0.f;
    int last = -1;
    for (int u = tid; u < planes * tiles; u += kThreads) {
      const int p = u / tiles, t = u - p * tiles;  // the tile's plane, and its tile there
      if (p != last) {  // the plane's weights and folded BatchNorm
#pragma unroll
        for (int i = 0; i < K * K; ++i) wr[i] = wts[p * K * K + i];
        scale = wts[sh.P * K * K + p];
        shift = wts[sh.P * K * K + sh.P + p];
        last = p;
      }
      const int tr = (t / tile_cols) * kTileRows;  // the tile's first output row in the band
      const int tx = (t - (t / tile_cols) * tile_cols) * kTileCols;
      float acc[kTileRows][kTileCols];
#pragma unroll
      for (int ry = 0; ry < kTileRows; ++ry)
#pragma unroll
        for (int r = 0; r < kTileCols; ++r) acc[ry][r] = 0.f;
      const T* src = data + (p * sh.NR + tr * S) * sh.Wp + kVec - PL + tx * S;
#pragma unroll
      for (int jj = 0; jj < kInRows; ++jj) {
        float v[kInCols];
        read_row<T, kInCols, (4 - PL % 4) % 4>(v, src + jj * sh.Wp);
#pragma unroll
        for (int ry = 0; ry < kTileRows; ++ry) {
          const int dy = jj - ry * S;
          if (dy < 0 || dy >= K) continue;  // known at compile time
#pragma unroll
          for (int dx = 0; dx < K; ++dx)
#pragma unroll
            for (int r = 0; r < kTileCols; ++r)
              acc[ry][r] = fmaf(wr[dy * K + dx], v[r * S + dx], acc[ry][r]);
        }
      }
      // the tile's outputs, a row of kTileCols in one vector store where it is
      // whole and aligned
      T* const yt =
          y + (q0 + p) * sh.OH * sh.OW + static_cast<long long>(oy0 + tr) * sh.OW + tx;
      const int rows = min(kTileRows, oy1 - oy0 - tr);
      const bool whole = tx + kTileCols <= sh.OW;
      float tile_sum = 0.f;
#pragma unroll
      for (int ry = 0; ry < kTileRows; ++ry) {
        if (ry >= rows) continue;
        __align__(16) T out[kTileCols];
#pragma unroll
        for (int r = 0; r < kTileCols; ++r) {
          const float z = fmaf(acc[ry][r], scale, shift);
          out[r] = Cvt<T>::from_f(__fdividef(z, 1.f + __expf(-z)));
          if (whole || tx + r < sh.OW) tile_sum += Cvt<T>::to_f(out[r]);
        }
        T* const row = yt + ry * sh.OW;
        if (whole && reinterpret_cast<size_t>(row) % (kTileCols * sizeof(T)) == 0) {
          using V = typename VecOf<kTileCols * sizeof(T)>::type;
          *reinterpret_cast<V*>(row) = *reinterpret_cast<const V*>(out);
        } else {
#pragma unroll
          for (int r = 0; r < kTileCols; ++r)
            if (tx + r < sh.OW) row[r] = out[r];
        }
      }
      if (sh.P == 1)
        sum += tile_sum;
      else
        partial[u] = tile_sum;
    }
    if (sh.P == 1) {
      if (band == sh.bands - 1) {  // the plane's sum: each warp's, then the warps' in order
        for (int o = 16; o > 0; o >>= 1) sum += __shfl_down_sync(0xffffffffu, sum, o);
        if (lane == 0) warp_sums[warp] = sum;
        __syncthreads();
        if (tid == 0) {
          float total = 0.f;
          for (int i = 0; i < kThreads / 32; ++i) total += warp_sums[i];
          s[q0] = Cvt<T>::from_f(total * (1.f / static_cast<float>(sh.OH * sh.OW)));
        }
      }
    } else {
      __syncthreads();  // the tiles' sums are in
      // each plane's sum over its tiles, `seg` lanes a plane (a power of two):
      // lane i adds tiles i, i + seg, ..., then the segment's lanes by shuffles
      const int seg = tiles >= 32 ? 32 : 1 << (32 - __clz(tiles - 1));
      const int sp = lane / seg, li = lane - sp * seg;
      for (int p0 = warp * (32 / seg); p0 < planes; p0 += kThreads / seg) {
        const int p = p0 + sp;
        float total = 0.f;
        if (p < planes)
          for (int i = li; i < tiles; i += seg) total += partial[p * tiles + i];
        for (int o = seg / 2; o > 0; o >>= 1)
          total += __shfl_down_sync(0xffffffffu, total, o, seg);
        if (li == 0 && p < planes)
          s[q0 + p] = Cvt<T>::from_f(total * (1.f / static_cast<float>(sh.OH * sh.OW)));
      }
    }
    __syncthreads();  // job j's buffers and the tiles' sums free for job j + 1, j + 2
  }
}

// The plan of a shape (Shape's comments) for x at x_address; returns the
// dynamic shared memory in bytes: two input buffers of P * NR * Wp elements,
// two parameter buffers and, where P > 1, the tiles' sums.
int plan(Shape& sh, int K, int S, int esize, unsigned long long x_address) {
  const int vec = 16 / esize;
  const int kTileRows = S == 1 ? tile_rows<1>() : tile_rows<2>();
  const int tile_cols = (sh.OW + kTileCols - 1) / kTileCols;
  const int tile_rows_all = (sh.OH + kTileRows - 1) / kTileRows;
  // a slot: vec elements ahead of the row (its left padding), the row, its
  // right padding and the last tile's overhang
  const int read = std::max(sh.W + sh.pr, (tile_cols * kTileCols - 1) * S + K - sh.pl);
  sh.Wp = (vec + read + 3 + vec - 1) / vec * vec;  // + 3: read_row's last word
  const long long row_bytes = static_cast<long long>(sh.Wp) * esize;
  // the widest copy that every row of every plane starts on
  const long long rb = static_cast<long long>(sh.W) * esize, pb = rb * sh.H;
  sh.copy = 0;
  for (int bytes = 16; bytes >= 4 && !sh.copy; bytes /= 2)
    if (rb % bytes == 0 && pb % bytes == 0 && x_address % bytes == 0) sh.copy = bytes;
  const int whole = (tile_rows_all * kTileRows - 1) * S + K;  // a whole plane's rows
  // small planes: P planes a job, the count (at most kMaxPlanes) whose tiles
  // keep the block's threads busiest (at most four tiles a thread; the larger
  // P where two are as busy), its planes within kBandBytes
  int P = 1;
  double busiest = 0.0;
  for (int cand = 1; cand <= kMaxPlanes; ++cand) {
    const long long n = static_cast<long long>(cand) * tile_rows_all * tile_cols;
    if (n > 4 * kThreads || cand * whole * row_bytes > kBandBytes) break;
    const double busy = static_cast<double>(n) / (kThreads * ((n + kThreads - 1) / kThreads));
    if (busy >= busiest) {
      busiest = busy;
      P = cand;
    }
  }
  sh.P = P;
  if (P > 1 || whole * row_bytes <= kBandBytes) {
    sh.BR = sh.OH;
  } else {  // bands of whole tiles, of equal height
    const int rows = static_cast<int>(std::max(static_cast<long long>(kTileRows * S + K),
                                               kBandBytes / row_bytes));
    const int br = std::max(kTileRows, ((rows - K) / S + 1) / kTileRows * kTileRows);
    const int bands = (sh.OH + br - 1) / br;
    sh.BR = ((sh.OH + bands - 1) / bands + kTileRows - 1) / kTileRows * kTileRows;
  }
  sh.bands = (sh.OH + sh.BR - 1) / sh.BR;
  sh.NR = ((std::min(sh.BR, sh.OH) + kTileRows - 1) / kTileRows * kTileRows - 1) * S + K;
  sh.groups = (sh.BC + P - 1) / P;
  const int max_tiles = P > 1 ? P * tile_rows_all * tile_cols : 0;  // their sums
  return static_cast<int>(2LL * P * sh.NR * row_bytes) +
         static_cast<int>(sizeof(float)) * (2 * P * (K * K + 4) + max_tiles);
}

template <typename T, int K, int S, int PL>
cudaError_t launch(const void* x, const float* w, const float* gamma, const float* beta,
                   const float* mean, const float* var, float eps, void* y, void* s,
                   const Shape& sh, int smem, int sms, cudaStream_t stream) {
  auto kernel = dw_bn_silu_squeeze_kernel<T, K, S, PL>;
  if (smem > 48 * 1024) {  // above 48 KB only by opt-in
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  int per_sm = 0;  // blocks an SM holds at once, for this shared memory
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  const int blocks = std::max(1, std::min(sh.groups, per_sm * sms));
  kernel<<<blocks, kThreads, smem, stream>>>(static_cast<const T*>(x), w, gamma, beta, mean,
                                             var, eps, static_cast<T*>(y), static_cast<T*>(s),
                                             sh);
  return cudaGetLastError();
}

// The kernel of (k, stride, pl): at stride 1 pl is (k - 1) / 2; at stride 2,
// (k - 2) / 2 or (k - 1) / 2 as W is even or odd.
template <typename T>
cudaError_t launch_k(int k, int stride, const void* x, const float* w, const float* gamma,
                     const float* beta, const float* mean, const float* var, float eps, void* y,
                     void* s, const Shape& sh, int smem, int sms, cudaStream_t st) {
#define DW_LAUNCH(K, S, PL) \
  launch<T, K, S, PL>(x, w, gamma, beta, mean, var, eps, y, s, sh, smem, sms, st)
  if (stride == 1) return k == 3 ? DW_LAUNCH(3, 1, 1) : DW_LAUNCH(5, 1, 2);
  if (k == 3) return sh.pl == 0 ? DW_LAUNCH(3, 2, 0) : DW_LAUNCH(3, 2, 1);
  return sh.pl == 1 ? DW_LAUNCH(5, 2, 1) : DW_LAUNCH(5, 2, 2);
#undef DW_LAUNCH
}

struct Device {
  int optin = 0, sms = 0;  // opt-in shared memory a block, SMs; read once
};
Device devices[64];

}  // namespace

// Plain C entry point, loaded with ctypes. dtype: 0 float32, 1 bf16, 2 fp16
// (x, y and s); w, gamma, beta, mean and var float32. Launches on `stream`
// and returns cudaGetLastError() (0 when the launch was accepted);
// cudaErrorInvalidValue for a kernel size or stride it does not take (3 or 5;
// 1 or 2), a row too wide for shared memory, or an empty tensor.
extern "C" int cosypose_dw_bn_silu_squeeze(const void* x, const float* w, const float* gamma,
                                           const float* beta, const float* mean,
                                           const float* var, float eps, void* y, void* s, int B,
                                           int C, int H, int W, int k, int stride, int dtype,
                                           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0 || dtype < 0 || dtype > 2 || (k != 3 && k != 5) ||
      (stride != 1 && stride != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  Shape sh;
  sh.BC = B * C;
  sh.C = C;
  sh.H = H;
  sh.W = W;
  sh.OH = (H + stride - 1) / stride;
  sh.OW = (W + stride - 1) / stride;
  const int ph = std::max((sh.OH - 1) * stride + k - H, 0);
  const int pw = std::max((sh.OW - 1) * stride + k - W, 0);
  sh.pt = ph / 2;
  sh.pl = pw / 2;
  sh.pr = pw - sh.pl;
  const int esize = dtype == 0 ? 4 : 2;
  const int smem = plan(sh, k, stride, esize, reinterpret_cast<unsigned long long>(x));
  if (device < 0 || device >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  Device& d = devices[device];
  if (d.optin == 0) {
    err = cudaDeviceGetAttribute(&d.optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) {
      d.optin = 0;
      return static_cast<int>(err);
    }
  }
  if (smem > d.optin)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      err = launch_k<float>(k, stride, x, w, gamma, beta, mean, var, eps, y, s, sh, smem, d.sms,
                            st);
      break;
    case 1:
      err = launch_k<__nv_bfloat16>(k, stride, x, w, gamma, beta, mean, var, eps, y, s, sh, smem,
                                    d.sms, st);
      break;
    default:
      err = launch_k<__half>(k, stride, x, w, gamma, beta, mean, var, eps, y, s, sh, smem, d.sms,
                             st);
  }
  return static_cast<int>(err);
}
