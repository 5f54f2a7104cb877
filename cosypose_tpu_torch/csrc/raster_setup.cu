// Triangle setup and y-sort of the binned rasterizer, for Hopper (sm_90a):
// kernel A of the raster path (raster_setup -> raster_resolve, two launches;
// above one block's rows an item, raster_setup, then raster_merge once a
// pass, then raster_resolve).
//
// Replaces the XLA plane setup and packing that feed the Pallas TPU kernel
// cosypose_tpu/ops/rasterizer_pallas.py: camera transform (:149-155),
// _triangle_planes (cosypose_tpu/ops/rasterizer.py:42, vmapped at :156) and
// the packing of the coefficient rows with invalid rows zeroed (:161-177),
// the y-sort key (:199) and its stable argsort (:200). In the port's plain
// version these are camera_corners + triangle_planes (ops/rasterizer.py), the
// packing of ops/rasterizer_cuda.setup_plain and sort_order (torch.sort).
//
// What it computes. For each item b and row f < Fp: for f < F, the
// triangle's camera-frame corners (TCO applied), their projection by K with
// z clamped to z_near, the headlight shading of the face normal, and from
// these the barycentric, 1/z and colour/z planes, the screen bbox and the
// validity (given valid, no corner behind z_near, not degenerate). Output row
// (32 floats, 128 B):
//   0:3 lam_a, 3:6 lam_b, 6:9 lam_c, 9:12 iz_abc, 12:15 col_a, 15:18 col_b,
//   18:21 col_c, 21 attr, 22 0, 23 valid (1.0), 24:28 bbox (x0, y0, x1, y1),
//   28:32 cover box (x0, y0, x1, y1)
// and the sort key 0.5 * (y0 + y1). Invalid rows and the padding rows
// F <= f < Fp are all zero with key +inf, so they sort to the tail. Then the
// item's permutation order (B, Fp) int64: its rows by key, equal keys in mesh
// order, element for element what torch.sort(ykey, dim=1, stable=True)
// gives on the card (-0.0 tied with +0.0, NaN above +inf).
//
// The cover box holds every pixel centre of the H x W image at which the
// resolve kernel's rounded inside tests (lambda_i >= -1e-6, each plane
// evaluated as ((a*x + b*y) + c) in float32) can pass; raster_resolve culls by
// it. It is not the bbox: a sub-pixel triangle's float32 planes can pass
// those tests pixels away from its corners. Computed in float64 from the
// rounded coefficients: the half-planes a_i x + b_i y + c_i >= -t_i, with
// t_i = 1e-6 + 2^-20 (|a_i| W + |b_i| H + |c_i|) above the float32 evaluation's
// rounding (below 2^-22 of that magnitude), meet in a triangle whenever their
// normals positively span the plane; its corners' box, widened by 1e-3 px and
// 1e-6 of the coordinates and clipped to [0, W] x [0, H], is the cover box.
// Where the normals do not span the plane (within 1e-6 of parallel), the
// cover box is the image. A box with no pixel centre (all zero) culls the row
// everywhere. ops/rasterizer_cuda.cover_box is the same in PyTorch.
//
// Bound on an H100: bytes, and in practice the launch and the latency of
// one block's work. Per triangle it reads 36 B of corners, 36 B of colours,
// 1 B of validity (4 B of attribute) and writes 140 B (row, key, order);
// ~220 fp32 operations per triangle are far under the bytes' time. At the
// main path's B=128, F=176 that is ~4.7 MB, ~1.4 us at 3.35 TB/s. The sort
// used to be a torch.sort of the keys after this kernel: its own launches,
// and the keys' round trip through device memory, each costing more than the
// setup itself.
//
// Design. Three regimes, chosen by shape (and the occupancy query) before
// any launch; a block sorts at most S rows in shared memory (S the largest
// power of two whose 8 B composites fit the shared memory a block may opt in
// to: 16,384 on an H100, cosypose_raster_setup_block_rows).
//  1. Fp <= S: a cluster of C blocks per item (C chosen by the launcher: 1
//     when the items alone fill the SMs, up to 8 when few items would leave
//     most SMs idle, and no more than lets every cluster be resident at
//     once), each block a slice of at most ceil(Fp / C) rows.
//  2. S < Fp <= 8 S, only where the caller forces it (cluster = C): the same
//     kernel in clusters of at least ceil(Fp / S) blocks, so that every
//     slice fits one block.
//  3. Fp > S, the launcher's choice: blocks of one run each (run_rows rows,
//     no cluster), each writing its sorted run of composites to device
//     memory (8 B a row), then raster_merge_kernel, one launch a pass,
//     merging the runs in pairs until one run holds the item; the last pass
//     writes the order. The one case where a render takes more than two
//     launches.
// In each block of raster_setup_kernel:
//  1. Its threads stride over the slice's rows; each row is computed and
//     written as eight 16-byte stores, and its composite key goes to shared
//     memory: the high 32 bits an order-preserving map of the float key
//     (-0.0 as +0.0, as torch.sort orders on the card), the low 32 bits f.
//     Composites are unique, so sorting them is stable by construction, and
//     the row index bounds Fp at 2^32 rows (device memory bounds it first).
//  2. A bitonic sort of the slice's composites in shared memory, padded to a
//     power of two with all-ones composites (8 B a row: 128 KB at S = 16,384
//     rows, within the 227 KB a block may opt in to).
//  3. With one slice an item the sorted low halves are the order. In a
//     cluster each block ranks its own composites among the other slices by
//     binary searches in their shared memory (distributed shared memory of
//     the cluster), the searches of a composite in up to 8 slices interleaved
//     so that their loads overlap (rank_in_runs), and writes
//     order[b, rank] = f: no merge buffer, no second pass. In regime 3 the
//     block writes its sorted run.
// In regimes 1 and 2 the keys never leave the SM: only the permutation is
// written.
//
// Regime 3 on an H100 (chip_smoke.py phase 14, PERF.md §6). What bounds it
// is latency, not bytes: the merge moves 16 B a key a pass (0.0025 ms a
// pass at 2 x 262,144 rows), the runs launch is 132 SMs each running one
// bitonic sort. The rank kernel before it ranked each composite among every
// other run by binary searches in device memory (~15 dependent 8-byte probes
// a run a key), after 16,384-row runs whose bitonic sorts took most of 0.52
// ms.
// This design:
//  - Run length (RasterKernels.run_rows): the shortest power of two from
//    256 with which the runs launch is one wave (B x runs at most the SM
//    count; a block of this kernel holds an SM's registers). A bitonic sort
//    costs ~log^2 of its length a row, so short runs are cheap, but each
//    halving adds a merge pass (~6-8 us): at every size phase 14 times, this
//    rule picked the fastest of the lengths 256-16,384.
//  - The merge: pairwise merge path, log2(runs) launches (chosen over one
//    k-way pass: with up to 128 runs an item a k-way split needs a search in
//    every run for every block, the per-key searches this replaces in
//    smaller form, where a pairwise split is one 32-probe search of two runs
//    a block). Each block owns kMergeTile outputs: one warp each finds where
//    its first and last output split the two runs (co_rank, 32 probes a
//    step, ~4 dependent loads), the block stages the two spans into shared
//    memory with cp.async, each thread finds its own split there and merges
//    kMergeEach outputs, and the block writes them coalesced. The passes
//    alternate between a scratch and `order` itself, so no copy is made.
//  - Above S the launcher takes regime 3 at every shape: phase 14 measured
//    it 2.5 to 8.4 times faster than regime 2's clusters (2 x 65,896 rows:
//    0.072-0.074 against 0.495-0.498 ms), which rank through distributed
//    shared memory by dependent probes; the merge alone takes less than
//    torch.sort of the same keys at every size there.

// Exactness: the arithmetic follows the association of the plain version's
// ops (corners as ((r0 v0 + r1 v1) + r2 v2) + t, sums of three in order) with
// __fmul_rn / __fadd_rn / __fdiv_rn / __fsqrt_rn, and the build passes
// -fmad=false, so validity and the 1/z plane equal the plain version's bit
// for bit; torch.linalg.norm may round the normal's length otherwise, and
// with it the colour planes: ops/rasterizer_cuda.py states the tolerance.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <algorithm>

namespace cg = cooperative_groups;

namespace {

constexpr int kRow = 32;
constexpr int kThreads = 512;     // a block
constexpr int kMaxCluster = 8;    // blocks an item, at most (the portable cluster size)
constexpr int kMinSlice = 256;    // rows a block, at least, when an item is split

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float sum3(float a, float b, float c) { return add(add(a, b), c); }

// the cover box (see above) of the planes (a_i, b_i, c_i) on an H x W image, into out[0:4]
__device__ void cover_box(const float* a, const float* b, const float* c, int H, int W,
                          float* out) {
  double t[3];
  for (int i = 0; i < 3; ++i)
    t[i] = 1e-6 + 0x1p-20 * (fabs(double(a[i])) * W + fabs(double(b[i])) * H + fabs(double(c[i])));
  double x0 = 0.0, y0 = 0.0, x1 = W, y1 = H;
  bool spans = true;
  int sign = 0;
  double vx[3], vy[3];
  for (int k = 0; k < 3; ++k) {
    const int i = k, j = (k + 1) % 3;
    const double det = double(a[i]) * b[j] - double(a[j]) * b[i];  // exact products
    const double ni = sqrt(double(a[i]) * a[i] + double(b[i]) * b[i]);
    const double nj = sqrt(double(a[j]) * a[j] + double(b[j]) * b[j]);
    const int sg = det > 0.0 ? 1 : -1;
    if (!(fabs(det) >= 1e-6 * ni * nj) || (sign != 0 && sg != sign)) spans = false;
    sign = sg;
    const double ri = -t[i] - c[i], rj = -t[j] - c[j];
    vx[k] = (ri * b[j] - rj * b[i]) / det;
    vy[k] = (double(a[i]) * rj - double(a[j]) * ri) / det;
  }
  if (spans) {
    x0 = fmin(fmin(vx[0], vx[1]), vx[2]);
    y0 = fmin(fmin(vy[0], vy[1]), vy[2]);
    x1 = fmax(fmax(vx[0], vx[1]), vx[2]);
    y1 = fmax(fmax(vy[0], vy[1]), vy[2]);
    x0 = fmax(x0 - 1e-3 - 1e-6 * fabs(x0), 0.0);
    y0 = fmax(y0 - 1e-3 - 1e-6 * fabs(y0), 0.0);
    x1 = fmin(x1 + 1e-3 + 1e-6 * fabs(x1), double(W));
    y1 = fmin(y1 + 1e-3 + 1e-6 * fabs(y1), double(H));
  }
  if (x0 <= x1 && y0 <= y1) {  // float rounding outward
    out[0] = __double2float_rd(x0);
    out[1] = __double2float_rd(y0);
    out[2] = __double2float_ru(x1);
    out[3] = __double2float_ru(y1);
  }
}

// Row f of item b, written to rows[b, f] as eight 16-byte stores; returns its
// sort key (+inf for an invalid or padding row).
__device__ __forceinline__ float setup_row(
    const float* __restrict__ tri_verts, const unsigned char* __restrict__ tri_valid,
    const float* __restrict__ TCO, const float* __restrict__ K,
    const float* __restrict__ colors, const float* __restrict__ tri_attr,
    float* __restrict__ rows, int b, int f, int F, int Fp, int H, int W, float z_near) {
  const long long idx = static_cast<long long>(b) * Fp + f;
  float r[kRow];
#pragma unroll
  for (int i = 0; i < kRow; ++i) r[i] = 0.f;
  float key = CUDART_INF_F;

  if (f < F) {
    const long long tri = static_cast<long long>(b) * F + f;
    const float* T = TCO + b * 16;
    const float* Kb = K + b * 9;
    const float* v = tri_verts + tri * 9;

    // camera-frame corners p[k] = R v[k] + t
    float p[3][3];
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int i = 0; i < 3; ++i)
        p[k][i] = add(sum3(mul(T[i * 4 + 0], v[k * 3 + 0]), mul(T[i * 4 + 1], v[k * 3 + 1]),
                           mul(T[i * 4 + 2], v[k * 3 + 2])),
                      T[i * 4 + 3]);

    const float fx = Kb[0], cx = Kb[2], fy = Kb[4], cy = Kb[5];
    bool behind = false;
    float u[3], w[3], tiz[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float z = p[k][2];
      behind |= z < z_near;
      const float zs = z < z_near ? z_near : z;
      u[k] = add(__fdiv_rn(mul(fx, p[k][0]), zs), cx);
      w[k] = add(__fdiv_rn(mul(fy, p[k][1]), zs), cy);
      tiz[k] = __fdiv_rn(1.f, zs);
    }

    // headlight Lambertian on the camera-frame normal, two-sided
    float e1[3], e2[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      e1[i] = sub(p[1][i], p[0][i]);
      e2[i] = sub(p[2][i], p[0][i]);
    }
    const float n0 = sub(mul(e1[1], e2[2]), mul(e1[2], e2[1]));
    const float n1 = sub(mul(e1[2], e2[0]), mul(e1[0], e2[2]));
    const float n2 = sub(mul(e1[0], e2[1]), mul(e1[1], e2[0]));
    const float norm = fmaxf(__fsqrt_rn(sum3(mul(n0, n0), mul(n1, n1), mul(n2, n2))), 1e-12f);
    const float intensity = add(0.35f, mul(0.65f, fabsf(__fdiv_rn(n2, norm))));

    const float area2 = sub(mul(sub(u[1], u[0]), sub(w[2], w[0])),
                            mul(sub(u[2], u[0]), sub(w[1], w[0])));
    const bool degenerate = fabsf(area2) < 1e-9f;
    const float inv = degenerate ? 0.f : __fdiv_rn(1.f, area2);
    const bool valid = tri_valid[tri] != 0 && !behind && !degenerate;

    if (valid) {
      const float a[3] = {mul(sub(w[1], w[2]), inv), mul(sub(w[2], w[0]), inv),
                          mul(sub(w[0], w[1]), inv)};
      const float bb[3] = {mul(sub(u[2], u[1]), inv), mul(sub(u[0], u[2]), inv),
                           mul(sub(u[1], u[0]), inv)};
      const float c[3] = {mul(sub(mul(u[1], w[2]), mul(u[2], w[1])), inv),
                          mul(sub(mul(u[2], w[0]), mul(u[0], w[2])), inv),
                          mul(sub(mul(u[0], w[1]), mul(u[1], w[0])), inv)};
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        r[i] = a[i];
        r[3 + i] = bb[i];
        r[6 + i] = c[i];
      }
      r[9] = sum3(mul(a[0], tiz[0]), mul(a[1], tiz[1]), mul(a[2], tiz[2]));
      r[10] = sum3(mul(bb[0], tiz[0]), mul(bb[1], tiz[1]), mul(bb[2], tiz[2]));
      r[11] = sum3(mul(c[0], tiz[0]), mul(c[1], tiz[1]), mul(c[2], tiz[2]));
      // colour/z of corner k, channel ch: (albedo * intensity) * (1/z)
      float ctiz[3][3];
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          const float albedo = colors ? colors[tri * 9 + k * 3 + ch] : 0.7f;
          ctiz[k][ch] = mul(mul(albedo, intensity), tiz[k]);
        }
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        r[12 + ch] = sum3(mul(a[0], ctiz[0][ch]), mul(a[1], ctiz[1][ch]), mul(a[2], ctiz[2][ch]));
        r[15 + ch] = sum3(mul(bb[0], ctiz[0][ch]), mul(bb[1], ctiz[1][ch]),
                          mul(bb[2], ctiz[2][ch]));
        r[18 + ch] = sum3(mul(c[0], ctiz[0][ch]), mul(c[1], ctiz[1][ch]), mul(c[2], ctiz[2][ch]));
      }
      r[21] = tri_attr ? tri_attr[tri] : 0.f;
      r[23] = 1.f;
      r[24] = fminf(fminf(u[0], u[1]), u[2]);
      r[25] = fminf(fminf(w[0], w[1]), w[2]);
      r[26] = fmaxf(fmaxf(u[0], u[1]), u[2]);
      r[27] = fmaxf(fmaxf(w[0], w[1]), w[2]);
      cover_box(a, bb, c, H, W, r + 28);
      key = mul(0.5f, add(r[25], r[27]));
    }
  }

  float4* out = reinterpret_cast<float4*>(rows + idx * kRow);
#pragma unroll
  for (int i = 0; i < kRow / 4; ++i)
    out[i] = make_float4(r[4 * i], r[4 * i + 1], r[4 * i + 2], r[4 * i + 3]);
  return key;
}

// The composite sort key of row f: an order-preserving map of the float key
// in the high half, f in the low half. The map orders as torch.sort does on
// the card (CUB's radix order): -0.0 tied with +0.0, denormals by value, a
// NaN by its bits (above +inf, or below -inf with the sign bit set; the
// kernel's own NaNs are positive). ops/rasterizer_cuda.sort_composite_keys is
// the same in PyTorch.
__device__ __forceinline__ unsigned long long composite(float key, int f) {
  unsigned u = key == 0.f ? 0u : __float_as_uint(key);
  u ^= (u & 0x80000000u) ? 0xffffffffu : 0x80000000u;
  return (static_cast<unsigned long long>(u) << 32) | static_cast<unsigned>(f);
}

// Ascending bitonic sort of keys[0:n] in shared memory, n a power of two.
__device__ void bitonic_sort(unsigned long long* keys, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < n / 2; t += blockDim.x) {
        const int i = 2 * t - (t & (stride - 1));  // the pair (i, i + stride)
        const unsigned long long a = keys[i], c = keys[i + stride];
        if ((a > c) == ((i & size) == 0)) {
          keys[i] = c;
          keys[i + stride] = a;
        }
      }
      __syncthreads();
    }
  }
}

// The sum of the lower bounds of k in up to kMaxCluster sorted runs (run[r]
// holds size[r] composites; a size of 0 leaves run r out), one probe of every
// run a step so that the loads overlap; `longest` bounds every size. The
// runs lie in a cluster's shared memory or in device memory.
__device__ __forceinline__ int rank_in_runs(unsigned long long k,
                                            const unsigned long long* const (&run)[kMaxCluster],
                                            const int (&size)[kMaxCluster], int longest) {
  int base[kMaxCluster], len[kMaxCluster];
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r) {
    base[r] = 0;
    len[r] = size[r];
  }
  for (int s = longest; s > 0; s >>= 1) {
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      if (len[r] > 0) {
        const int half = len[r] >> 1;
        if (run[r][base[r] + half] < k) {
          base[r] += half + 1;
          len[r] -= half + 1;
        } else {
          len[r] = half;
        }
      }
    }
  }
  int pos = 0;
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r) pos += base[r];
  return pos;
}

// One block a slice of `slice` rows, n_slices slices an item (in clusters of
// n_slices blocks, or, with `runs`, blocks without a cluster that write their
// sorted slices to runs for raster_merge_kernel).
__global__ void __launch_bounds__(kThreads, 1) raster_setup_kernel(
    const float* __restrict__ tri_verts, const unsigned char* __restrict__ tri_valid,
    const float* __restrict__ TCO, const float* __restrict__ K,
    const float* __restrict__ colors, const float* __restrict__ tri_attr,
    float* __restrict__ rows, float* __restrict__ ykey, long long* __restrict__ order,
    unsigned long long* __restrict__ runs, int F, int Fp, int H, int W, float z_near, int slice,
    int slice_pow2, int n_slices) {
  extern __shared__ unsigned long long keys[];  // this block's slice, sorted in place
  const int b = static_cast<int>(blockIdx.x) / n_slices;
  const int part = static_cast<int>(blockIdx.x) - b * n_slices;  // the cluster rank, in a cluster
  const int lo = part * slice;
  const int n = max(0, min(slice, Fp - lo));  // rows of this slice

  for (int i = threadIdx.x; i < slice_pow2; i += blockDim.x) {
    unsigned long long k = ~0ull;
    if (i < n) {
      const int f = lo + i;
      const float key =
          setup_row(tri_verts, tri_valid, TCO, K, colors, tri_attr, rows, b, f, F, Fp, H, W, z_near);
      ykey[static_cast<long long>(b) * Fp + f] = key;
      k = composite(key, f);
    }
    keys[i] = k;
  }
  __syncthreads();
  bitonic_sort(keys, slice_pow2);

  if (runs) {  // regime 3: the sorted run, for raster_merge_kernel
    unsigned long long* run = runs + static_cast<long long>(b) * Fp + lo;
    for (int i = threadIdx.x; i < n; i += blockDim.x) run[i] = keys[i];
    return;
  }
  long long* out = order + static_cast<long long>(b) * Fp;
  if (n_slices == 1) {
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      out[i] = static_cast<long long>(static_cast<unsigned>(keys[i]));
    return;
  }

  const cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every slice of the item sorted
  const unsigned long long* other[kMaxCluster];
  int size[kMaxCluster];
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r) {
    other[r] = r < n_slices ? cluster.map_shared_rank(keys, r) : keys;
    size[r] = r < n_slices && r != part ? max(0, min(slice, Fp - r * slice)) : 0;
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const unsigned long long k = keys[i];
    out[i + rank_in_runs(k, other, size, slice)] = static_cast<long long>(static_cast<unsigned>(k));
  }
  cluster.sync();  // no block leaves while another still reads its slice
}

// Regime 3's merge (raster_merge_kernel), one launch a pass: the item's
// runs of `width` composites (the last one shorter) merged in pairs, runs
// 2p and 2p + 1 into one run of 2 width. Each block owns kMergeTile
// consecutive outputs of one pair: two warps find where the block's first
// and last output split the two runs (co_rank), the block stages those two
// spans into shared memory with cp.async, each thread merges kMergeEach
// outputs there from its own split (a binary search in shared memory), and
// the block writes its outputs coalesced: composites to `dst`, or, in the
// last pass, their low halves to `order`. Composites are unique, so no two
// keys compare equal and the merge is stable by construction.
constexpr int kMergeThreads = 256;
constexpr int kMergeTile = 2048;  // outputs a block
constexpr int kMergeEach = kMergeTile / kMergeThreads;
constexpr unsigned kAll = 0xffffffffu;

// How many of the d smallest composites of the merge of sorted a[0:m] and
// b[0:n] come from a: the first i in [max(0, d - n), min(d, m)] with
// !(a[i] < b[d - 1 - i]) (the predicate holds below it and fails from it on).
// One warp, 32 probes a step (ops/rasterizer_cuda.co_rank is the same in
// PyTorch, one probe a step).
__device__ int co_rank(const unsigned long long* __restrict__ a, int m,
                       const unsigned long long* __restrict__ b, int n, int d) {
  const int lane = threadIdx.x & 31;
  int lo = max(0, d - n), hi = min(d, m);
  while (hi - lo > 32) {  // probes lo < p_0 < ... < p_31 < hi
    const int p = lo + static_cast<int>((static_cast<long long>(lane + 1) * (hi - lo)) / 33);
    const int below = __popc(__ballot_sync(kAll, __ldg(a + p) < __ldg(b + d - 1 - p)));
    const int p_last = __shfl_sync(kAll, p, max(below - 1, 0));
    const int p_next = __shfl_sync(kAll, p, min(below, 31));
    if (below > 0) lo = p_last + 1;
    if (below < 32) hi = p_next;
  }
  const int p = lo + lane;
  return lo + __popc(__ballot_sync(kAll, p < hi && __ldg(a + p) < __ldg(b + d - 1 - p)));
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem) : "memory");
}

__global__ void __launch_bounds__(kMergeThreads) raster_merge_kernel(
    const unsigned long long* __restrict__ src, unsigned long long* __restrict__ dst,
    long long* __restrict__ order, int Fp, int width, int tiles_per_pair) {
  __shared__ unsigned long long in[kMergeTile];   // the two spans, a's then b's
  __shared__ unsigned long long out[kMergeTile];  // the block's outputs, merged
  __shared__ int split[2];
  const int pair = static_cast<int>(blockIdx.x) / tiles_per_pair;
  const int d0 = (static_cast<int>(blockIdx.x) - pair * tiles_per_pair) * kMergeTile;
  const long long a0 = 2LL * pair * width;  // the pair's first row in the item
  const int m = static_cast<int>(min(static_cast<long long>(width), Fp - a0));
  const int n = static_cast<int>(max(0LL, min(static_cast<long long>(width), Fp - a0 - m)));
  if (d0 >= m + n) return;
  const int d1 = min(d0 + kMergeTile, m + n);
  const long long base = static_cast<long long>(blockIdx.y) * Fp + a0;
  const unsigned long long* a = src + base;
  const unsigned long long* b = a + m;

  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const int i = co_rank(a, m, b, n, warp ? d1 : d0);
    if ((threadIdx.x & 31) == 0) split[warp] = i;
  }
  __syncthreads();
  const int i0 = split[0], la = split[1] - i0;
  const int j0 = d0 - i0, len = d1 - d0, lb = len - la;
  for (int k = threadIdx.x; k < len; k += kMergeThreads)
    cp_async8(in + k, k < la ? a + i0 + k : b + j0 + (k - la));
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int k0 = threadIdx.x * kMergeEach;
  if (k0 < len) {
    int lo = max(0, k0 - lb), hi = min(k0, la);  // co_rank of k0 in in[0:la], in[la:len]
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (in[mid] < in[la + k0 - 1 - mid]) lo = mid + 1;
      else hi = mid;
    }
    int i = lo, j = k0 - lo;
    const int k1 = min(k0 + kMergeEach, len);
    for (int k = k0; k < k1; ++k) {
      const bool from_a = j >= lb || (i < la && in[i] < in[la + j]);
      out[k] = from_a ? in[i++] : in[la + j++];
    }
  }
  __syncthreads();
  if (order) {
    long long* o = order + base + d0;
    for (int k = threadIdx.x; k < len; k += kMergeThreads)
      o[k] = static_cast<long long>(static_cast<unsigned>(out[k]));
  } else {
    unsigned long long* o = dst + base + d0;
    for (int k = threadIdx.x; k < len; k += kMergeThreads) o[k] = out[k];
  }
}

// The merge passes of runs of run_rows rows: ceil(log2(runs)), at least one
// (a lone run is copied to `order` by the last pass).
static int merge_passes(int Fp, int run_rows) {
  int passes = 1;
  for (long long w = 2LL * run_rows; w < Fp; w *= 2) ++passes;
  return passes;
}

// Grid, cluster and shared memory of raster_setup_kernel for B items of Fp
// rows, n_slices slices an item, in clusters of `cluster` blocks (n_slices, or
// 1 for regime 3), slices of ceil(Fp / slices) rows or, where given,
// `slice_rows`.
struct SetupLaunch {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t config = {};
  int slice = 0, slice_pow2 = 1, n_slices = 1;

  cudaError_t configure(int B, int Fp, int slices, int cluster, cudaStream_t stream,
                        int slice_rows = 0) {
    n_slices = slices;
    slice = slice_rows > 0 ? slice_rows : (Fp + slices - 1) / slices;
    slice_pow2 = 1;
    while (slice_pow2 < slice) slice_pow2 <<= 1;
    const size_t smem = static_cast<size_t>(slice_pow2) * sizeof(unsigned long long);
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    config.blockDim = dim3(kThreads);
    config.stream = stream;
    config.attrs = attr;
    config.numAttrs = 1;
    config.gridDim = dim3(static_cast<unsigned>(B) * static_cast<unsigned>(slices));
    config.dynamicSmemBytes = smem;
    if (smem <= 48 * 1024) return cudaSuccess;  // above 48 KB only by opt-in
    return cudaFuncSetAttribute(raster_setup_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem));
  }

  // B clusters of c blocks: how many can be resident at once
  cudaError_t resident(int B, int Fp, int c, int* out) {
    const cudaError_t err = configure(B, Fp, c, c, nullptr);
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveClusters(out, raster_setup_kernel, &config);
  }
};

// S, the rows one block sorts, or the CUDA error negated
static int block_rows(int device) {
  int optin = 0;
  const cudaError_t err =
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  int rows = 1;
  while (static_cast<size_t>(rows) * 2 * sizeof(unsigned long long) <= static_cast<size_t>(optin))
    rows *= 2;
  return rows;
}

}  // namespace

// S on `device`: the largest power of two whose composites (8 B a row) fit
// the shared memory a block may opt in to (16,384 on an H100), the rows one
// block sorts; or -1 with the CUDA error negated where the attribute cannot
// be read.
extern "C" int cosypose_raster_setup_block_rows(int device) { return block_rows(device); }

// The launcher's choice for B items of Fp rows on `device`: regime 1, the
// blocks a cluster (1 to 8: the most, up to 8, that the SMs hold for B
// items, that leave kMinSlice rows a block, and for which all B clusters are
// resident at once, since a cluster lives within one GPC and B x C blocks
// below the SM count may still need a second wave), where Fp <= S; above
// S, 0 for regime 3 (sorted runs in device memory and their merge), which
// took 2.5 to 8.4 times less time than regime 2's clusters on an H100
// (PERF.md §6). A negative value is a CUDA error negated.
extern "C" int cosypose_raster_setup_plan(int B, int Fp, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  const int S = block_rows(device);
  if (S <= 0) return S;
  if (Fp > S) return 0;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  int cluster = max(1, min(min(kMaxCluster, sms / max(B, 1)), (Fp + kMinSlice - 1) / kMinSlice));
  SetupLaunch launch;
  for (; cluster > 1; --cluster) {
    int resident = 0;
    err = launch.resident(B, Fp, cluster, &resident);
    if (err != cudaSuccess) return -static_cast<int>(err);
    if (resident >= B) return cluster;
  }
  return 1;
}

// Plain C entry point, loaded with ctypes. `colors` and `tri_attr` may be
// null (flat 0.7 albedo, zero attribute). With `runs` null: `cluster` is the
// number of blocks an item (1 to 8, each slice at most S rows), or 0 to let
// the launcher choose as cosypose_raster_setup_plan does (an error where
// that choice is regime 3). With `runs` (B x Fp composites, 8 B each):
// regime 3, blocks of `run_rows` rows each (at most S) writing their sorted
// runs there, and order untouched until cosypose_raster_setup_merge.
// Launches on `stream` and returns the launch's error (0 when it was
// accepted).
extern "C" int cosypose_raster_setup(
    const float* tri_verts, const unsigned char* tri_valid, const float* TCO, const float* K,
    const float* colors, const float* tri_attr, float* rows, float* ykey, long long* order,
    unsigned long long* runs, int B, int F, int Fp, int H, int W, float z_near, int cluster,
    int run_rows, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0 || Fp == 0) return 0;
  SetupLaunch launch;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (runs) {
    if (run_rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
    err = launch.configure(B, Fp, (Fp + run_rows - 1) / run_rows, 1, s, run_rows);
  } else {
    if (cluster > kMaxCluster) return static_cast<int>(cudaErrorInvalidValue);
    if (cluster <= 0) {
      cluster = cosypose_raster_setup_plan(B, Fp, device);
      if (cluster < 0) return -cluster;
      if (cluster == 0) return static_cast<int>(cudaErrorInvalidValue);  // regime 3 needs runs
    }
    err = launch.configure(B, Fp, cluster, cluster, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchKernelEx(&launch.config, raster_setup_kernel, tri_verts, tri_valid, TCO, K,
                           colors, tri_attr, rows, ykey, order, runs, F, Fp, H, W, z_near,
                           launch.slice, launch.slice_pow2, launch.n_slices);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The merge passes regime 3 takes for runs of run_rows rows: how many
// launches cosypose_raster_setup_merge makes. The wrapper has
// cosypose_raster_setup write the runs to `scratch` where this is odd and to
// `order` where it is even: the passes alternate between the two, and the
// last reads `scratch` and writes `order`.
extern "C" int cosypose_raster_setup_merge_passes(int Fp, int run_rows) {
  return run_rows > 0 ? merge_passes(Fp, run_rows) : -static_cast<int>(cudaErrorInvalidValue);
}

// Regime 3's merge: order (B, Fp) from the runs of run_rows rows that
// cosypose_raster_setup wrote (to scratch or order, as above), one launch a
// pass on `stream`; `scratch` holds B x Fp composites.
extern "C" int cosypose_raster_setup_merge(unsigned long long* scratch, long long* order, int B,
                                           int Fp, int run_rows, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0 || Fp == 0) return 0;
  if (run_rows <= 0 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned long long* other = reinterpret_cast<unsigned long long*>(order);
  const int passes = merge_passes(Fp, run_rows);
  for (int p = 0; p < passes; ++p) {
    const long long width = static_cast<long long>(run_rows) << p;
    const bool from_scratch = (passes - 1 - p) % 2 == 0;
    const int pairs = static_cast<int>((Fp + 2 * width - 1) / (2 * width));
    const int tiles = static_cast<int>(
        (std::min(2 * width, static_cast<long long>(Fp)) + kMergeTile - 1) / kMergeTile);
    const dim3 grid(static_cast<unsigned>(pairs) * static_cast<unsigned>(tiles),
                    static_cast<unsigned>(B));
    raster_merge_kernel<<<grid, kMergeThreads, 0, s>>>(
        from_scratch ? scratch : other, from_scratch ? other : scratch,
        p == passes - 1 ? order : nullptr, Fp, static_cast<int>(width), tiles);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
