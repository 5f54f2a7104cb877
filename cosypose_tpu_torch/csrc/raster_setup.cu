// Triangle setup of the binned rasterizer, for Hopper (sm_90a): kernel A of
// the raster path (raster_setup -> torch.sort -> raster_resolve).
//
// Replaces the XLA plane setup and packing that feed the Pallas TPU kernel
// cosypose_tpu/ops/rasterizer_pallas.py: camera transform (:149-155),
// _triangle_planes (cosypose_tpu/ops/rasterizer.py:42, vmapped at :156) and
// the packing of the coefficient rows with invalid rows zeroed (:161-177),
// plus the y-sort key (:199). In the port's plain version these are
// camera_corners + triangle_planes (ops/rasterizer.py) and the packing of
// ops/rasterizer_cuda.setup_plain: some 150 small PyTorch ops per call.
//
// What it computes. One thread per (item b, row f < Fp): for f < F, the
// triangle's camera-frame corners (TCO applied), their projection by K with
// z clamped to z_near, the headlight shading of the face normal, and from
// these the barycentric, 1/z and colour/z planes, the screen bbox and the
// validity (given valid, no corner behind z_near, not degenerate). Output row
// (32 floats, 128 B):
//   0:3 lam_a, 3:6 lam_b, 6:9 lam_c, 9:12 iz_abc, 12:15 col_a, 15:18 col_b,
//   18:21 col_c, 21 attr, 22 0, 23 valid (1.0), 24:28 bbox (x0, y0, x1, y1),
//   28:32 cover box (x0, y0, x1, y1)
// and the sort key 0.5 * (y0 + y1). Invalid rows and the padding rows
// F <= f < Fp are all zero with key +inf, so they sort to the tail.
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
// Bound on an H100: bytes, and in practice the launch. Per triangle it reads
// 36 B of corners, 36 B of colours, 1 B of validity (4 B of attribute) and
// writes 132 B; ~220 fp32 operations per triangle are far under the bytes'
// time. At the main path's B=128, F=176 that is ~4.5 MB, ~1.3 us at
// 3.35 TB/s, so the launch itself dominates. The design makes it one launch
// in place of ~150: each thread writes its row as eight 16-byte stores.
//
// Exactness: the arithmetic follows the association of the plain version's
// ops (corners as ((r0 v0 + r1 v1) + r2 v2) + t, sums of three in order) with
// __fmul_rn / __fadd_rn / __fdiv_rn / __fsqrt_rn, and the build passes
// -fmad=false, so validity and the 1/z plane equal the plain version's bit
// for bit; torch.linalg.norm may round the normal's length otherwise, and
// with it the colour planes: ops/rasterizer_cuda.py states the tolerance.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kRow = 32;

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

__global__ void __launch_bounds__(128) raster_setup_kernel(
    const float* __restrict__ tri_verts, const unsigned char* __restrict__ tri_valid,
    const float* __restrict__ TCO, const float* __restrict__ K,
    const float* __restrict__ colors, const float* __restrict__ tri_attr,
    float* __restrict__ rows, float* __restrict__ ykey, int B, int F, int Fp, int H, int W,
    float z_near) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(B) * Fp) return;
  const int b = static_cast<int>(idx / Fp);
  const int f = static_cast<int>(idx - static_cast<long long>(b) * Fp);

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
  ykey[idx] = key;
}

}  // namespace

// Plain C entry point, loaded with ctypes. `colors` and `tri_attr` may be
// null (flat 0.7 albedo, zero attribute). Launches on `stream` and returns
// cudaGetLastError() (0 when the launch was accepted).
extern "C" int cosypose_raster_setup(
    const float* tri_verts, const unsigned char* tri_valid, const float* TCO, const float* K,
    const float* colors, const float* tri_attr, float* rows, float* ykey, int B, int F, int Fp,
    int H, int W, float z_near, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n = static_cast<long long>(B) * Fp;
  const int block = 128;
  const dim3 grid(static_cast<unsigned>((n + block - 1) / block));
  raster_setup_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      tri_verts, tri_valid, TCO, K, colors, tri_attr, rows, ykey, B, F, Fp, H, W, z_near);
  return static_cast<int>(cudaGetLastError());
}
