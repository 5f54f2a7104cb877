// Per-tile depth resolve of the binned triangle rasterizer, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel cosypose_tpu/ops/rasterizer_pallas.py:
// _kernel_broadcast (launched by rasterize_pallas, pl.pallas_call at :287),
// both of its static variants (WITH_ATTR carries the winner's flat attribute,
// lane 21, e.g. an instance id).
//
// What it computes. For one (tile, batch item), loop over the tile's
// counts[b, t] chunks of 8 packed triangle rows, in list order. For each
// triangle, evaluate the 3 barycentric planes and the 1/z plane at the pixel
// centre, and keep the nearest surface by a strict `>` on 1/z against a
// zero-initialised z-buffer, inside test lambda_i >= -1e-6. Carry the winner's
// colour/z. Write depth = 1/iz and rgb = clip(colz/iz, 0, 1), 0 where no
// triangle hit.
//
// Inputs (the PyTorch prologue in ops/rasterizer_cuda.py builds them):
//   coef      (B, Fp, 24) fp32: y-sorted rows, invalid rows zeroed (inert:
//             1/z == 0 never beats the zero-initialised buffer under `>`).
//             Layout 0:3 lam_a, 3:6 lam_b, 6:9 lam_c, 9:12 iz_abc,
//             12:15 col_a, 15:18 col_b, 18:21 col_c, 21 attr, 22:24 bbox y.
//   chunk_idx (B, n_tiles, Kc) int32: ascending ids of the 8-row chunks that
//             overlap the tile, cut at the budget Kc.
//   counts    (B, n_tiles) int32: how many entries of the list are live.
// Outputs are written straight into the (B,3,H,W) / (B,H,W) image layout;
// threads of the ragged edge compute but do not store.
//
// Unlike the TPU kernel it does not take a per-tile copy of the binned rows
// (at GPU-sized tiles that copy would be ~2 GB at B=128): the block reads its
// own count and list and stages the listed chunks in shared memory, STAGE
// chunks per round, with coalesced loads of whole 768-byte chunks.
//
// Design: one block per (tile, batch item), one thread per pixel; z-buffer,
// colour and attribute stay in registers.
//
// Bound on an H100: fp32 ALU, with memory close behind. Each (pixel,
// triangle) visit costs 20 fp32 operations (4 planes of 2 mul + 2 add, 3
// inside tests and the depth test), and 12 more for the 3 colour planes when
// the triangle wins, against 67 TFLOP/s fp32 outside the tensor cores. The
// bytes are mostly the 16 B per pixel written (the coefficient rows are a few
// MB); at the render loop's shapes their time at 3.35 TB/s is about 0.8 of
// the operations' time, so a faster kernel must trim both.
//
// Exactness: every plane is evaluated with __fmul_rn / __fadd_rn in the
// association of the Pallas body ((a*x + b*y) + c) and the build passes
// -fmad=false, so no FMA contraction changes the rounding: the kernel matches
// its plain PyTorch version to the bit, and the masks compare equal. Division
// is IEEE (__fdiv_rn, no fast math), and the strict `>` keeps list order as
// the tie-break.

#include <cuda_runtime.h>

namespace {

constexpr int kCoef = 24;
constexpr int kChunk = 8;               // triangle rows per chunk
constexpr int kStage = 8;               // chunks staged per round (6 KB)

__device__ __forceinline__ float plane(float a, float b, float c, float x, float y) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, x), __fmul_rn(b, y)), c);
}

// clip to [0, 1], NaN passes through as in jnp.clip / torch.clamp
__device__ __forceinline__ float clip01(float v) {
  return v < 0.f ? 0.f : (v > 1.f ? 1.f : v);
}

template <bool WITH_ATTR>
__global__ void raster_resolve_kernel(
    const float* __restrict__ coef, const int* __restrict__ chunk_idx,
    const int* __restrict__ counts, float* __restrict__ rgb,
    float* __restrict__ depth, float* __restrict__ attr,
    int Fp, int n_tiles, int Kc, int H, int W, int th, int tw, int ntx) {
  __shared__ float rows[kStage * kChunk * kCoef];

  const int t = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int y = (t / ntx) * th + tid / tw;
  const int x = (t % ntx) * tw + tid % tw;
  const float py = static_cast<float>(y) + 0.5f;
  const float px = static_cast<float>(x) + 0.5f;

  const int n = counts[b * n_tiles + t];
  const int* list = chunk_idx + (static_cast<long long>(b) * n_tiles + t) * Kc;
  const float* rows_b = coef + static_cast<long long>(b) * Fp * kCoef;

  float iz = 0.f, c0 = 0.f, c1 = 0.f, c2 = 0.f, at = 0.f;
  for (int k0 = 0; k0 < n; k0 += kStage) {
    const int nk = min(kStage, n - k0);
    __syncthreads();  // the previous round's rows are no longer read
    for (int i = tid; i < nk * kChunk * kCoef; i += blockDim.x) {
      const int s = i / (kChunk * kCoef);
      const int e = i - s * (kChunk * kCoef);
      rows[i] = rows_b[static_cast<long long>(list[k0 + s]) * (kChunk * kCoef) + e];
    }
    __syncthreads();
    for (int r = 0; r < nk * kChunk; ++r) {
      const float* q = rows + r * kCoef;
      const float l0 = plane(q[0], q[3], q[6], px, py);
      const float l1 = plane(q[1], q[4], q[7], px, py);
      const float l2 = plane(q[2], q[5], q[8], px, py);
      const float zv = plane(q[9], q[10], q[11], px, py);
      if (l0 >= -1e-6f && l1 >= -1e-6f && l2 >= -1e-6f && zv > iz) {
        iz = zv;
        c0 = plane(q[12], q[15], q[18], px, py);
        c1 = plane(q[13], q[16], q[19], px, py);
        c2 = plane(q[14], q[17], q[20], px, py);
        if (WITH_ATTR) at = q[21];
      }
    }
  }

  if (y >= H || x >= W) return;
  const bool hit = iz > 0.f;
  const float safe = fmaxf(iz, 1e-12f);
  const long long hw = static_cast<long long>(H) * W;
  const long long p = static_cast<long long>(y) * W + x;
  depth[b * hw + p] = hit ? __fdiv_rn(1.f, safe) : 0.f;
  float* out = rgb + b * 3 * hw + p;
  out[0] = hit ? clip01(__fdiv_rn(c0, safe)) : 0.f;
  out[hw] = hit ? clip01(__fdiv_rn(c1, safe)) : 0.f;
  out[2 * hw] = hit ? clip01(__fdiv_rn(c2, safe)) : 0.f;
  if (WITH_ATTR) attr[b * hw + p] = hit ? at : 0.f;
}

}  // namespace

// Plain C entry point, loaded with ctypes. Launches on `stream` and returns
// cudaGetLastError() (0 when the launch was accepted).
extern "C" int cosypose_raster_resolve(
    const float* coef, const int* chunk_idx, const int* counts, float* rgb,
    float* depth, float* attr, int B, int Fp, int n_tiles, int Kc, int H,
    int W, int th, int tw, int ntx, int with_attr, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_tiles, B);
  const dim3 block(th * tw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (with_attr) {
    raster_resolve_kernel<true><<<grid, block, 0, s>>>(
        coef, chunk_idx, counts, rgb, depth, attr, Fp, n_tiles, Kc, H, W, th, tw, ntx);
  } else {
    raster_resolve_kernel<false><<<grid, block, 0, s>>>(
        coef, chunk_idx, counts, rgb, depth, attr, Fp, n_tiles, Kc, H, W, th, tw, ntx);
  }
  return static_cast<int>(cudaGetLastError());
}
