// Greedy non-maximum suppression over groups of score-sorted boxes, for Hopper
// (sm_90a), in one launch for every group of a call:
//
//   keep[i] = valid[i] and no kept box j of i's group with j before i has
//             iou(box j, box i) > threshold
//
// as ops/nms_cuda.py nms_plain computes it. Boxes are (x1, y1, x2, y2)
// float32; a group is a contiguous range of rows given by `offsets` (G + 1
// int64), each range already in the order of its scores (highest first), so
// the greedy scan is over row order. Mask R-CNN calls it twice a frame: once
// for the RPN's proposals with a group a (image, pyramid level), once for the
// box head's detections with a group an (image, class).
//
// Replaces no TPU kernel: the JAX package's detector is a CenterNet whose
// NMS is a vectorised loop over 64 peaks. torchvision, which the published
// Mask R-CNN calls, has no CUDA build on the card's machine.
//
// The IoU is torchvision's nms kernel's, op for op in float32 (the width and
// height of the intersection clamped at 0, the areas as products of the
// differences, inter / (area_a + area_b - inter) > threshold, IEEE division,
// no FMA contraction: built with -fmad=false), so it equals the plain
// version bit for bit and the kept rows are the same.
//
// Bound: latency. The scan is sequential by nature (a box's fate depends on
// the fates of every box before it); a call moves 16 bytes a box in and one
// out, microseconds of bandwidth. Design, one block of 1024 threads a group:
//  - the group's rows go in phases of 64 (a 64-bit word of the bitmask);
//  - in a phase the block first computes the word's diagonal block of the
//    IoU bitmask, bit b of row r set when row r suppresses row b > r (each
//    warp a (row, half word) pair: 32 IoUs and one ballot);
//  - one warp then resolves the 64 rows in order against the removed bits
//    that earlier phases left in shared memory, holding the diagonal words in
//    registers and passing them by shuffle; that fixes the phase's kept rows;
//  - the block then computes the kept rows' words of the later columns only
//    (a row that is suppressed never suppresses), and ORs them into the
//    removed bits in shared memory (32-bit shared atomics): the bitmask is
//    never stored in device memory and never copied to the host;
//  - groups are independent, so they run on separate SMs at once.
// Invalid rows (valid[i] == 0; null means all valid) start removed: they are
// never kept and never suppress.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool suppresses(const float4 a, const float4 b, float threshold) {
  const float left = fmaxf(a.x, b.x), right = fminf(a.z, b.z);
  const float top = fmaxf(a.y, b.y), bottom = fminf(a.w, b.w);
  const float width = fmaxf(right - left, 0.0f), height = fmaxf(bottom - top, 0.0f);
  const float inter = width * height;
  const float area_a = (a.z - a.x) * (a.w - a.y);
  const float area_b = (b.z - b.x) * (b.w - b.y);
  return inter / (area_a + area_b - inter) > threshold;
}

__global__ void __launch_bounds__(kThreads)
nms_kernel(const float4* __restrict__ boxes, const int64_t* __restrict__ offsets,
           const uint8_t* __restrict__ valid, float threshold, uint8_t* __restrict__ keep) {
  // removed bits of the group, a 64-bit word as two 32-bit halves (low first)
  extern __shared__ unsigned removed[];
  __shared__ unsigned diag[128];     // the phase's diagonal words, halves
  __shared__ int kept_rows[64];      // the phase's kept rows, in order
  __shared__ int n_kept;

  const int64_t start = offsets[blockIdx.x];
  const int n = static_cast<int>(offsets[blockIdx.x + 1] - start);
  const int words = (n + 63) / 64;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float4* bx = boxes + start;

  for (int h = threadIdx.x; h < 2 * words; h += kThreads) {
    unsigned r = 0;
    if (valid != nullptr)
      for (int b = 0; b < 32; ++b) {
        const int i = h * 32 + b;
        if (i < n && !valid[start + i]) r |= 1u << b;
      }
    removed[h] = r;
  }
  __syncthreads();

  for (int p = 0; p < words; ++p) {
    const int base = p * 64;
    const int rows = min(64, n - base);
    for (int t = warp; t < 128; t += kWarps) {
      const int r = t >> 1, b = (t & 1) * 32 + lane;
      bool hit = false;
      if (r < rows && b < rows && b > r) hit = suppresses(bx[base + r], bx[base + b], threshold);
      const unsigned m = __ballot_sync(kFull, hit);
      if (lane == 0) diag[t] = m;
    }
    __syncthreads();
    if (warp == 0) {
      const unsigned long long d0 =
          (static_cast<unsigned long long>(diag[2 * lane + 1]) << 32) | diag[2 * lane];
      const unsigned long long d1 =
          (static_cast<unsigned long long>(diag[2 * lane + 65]) << 32) | diag[2 * lane + 64];
      unsigned long long gone =
          (static_cast<unsigned long long>(removed[2 * p + 1]) << 32) | removed[2 * p];
      unsigned long long kept = 0;
      for (int r = 0; r < rows; ++r) {
        const unsigned long long d = __shfl_sync(kFull, r < 32 ? d0 : d1, r & 31);
        if (!((gone >> r) & 1ull)) {
          kept |= 1ull << r;
          gone |= d;
        }
      }
      if (lane < rows) keep[start + base + lane] = (kept >> lane) & 1ull;
      if (lane + 32 < rows) keep[start + base + lane + 32] = (kept >> (lane + 32)) & 1ull;
      if (lane == 0) {
        int k = 0;
        for (unsigned long long m = kept; m; m &= m - 1) kept_rows[k++] = __ffsll(m) - 1;
        n_kept = k;
      }
    }
    __syncthreads();
    const int later = words - p - 1;
    const int tasks = n_kept * later * 2;
    for (int t = warp; t < tasks; t += kWarps) {
      const int k = t / (later * 2), rest = t - k * later * 2;
      const int h = 2 * (p + 1) + rest;  // the half word of the later columns
      const int j = h * 32 + lane;
      const bool hit = j < n && suppresses(bx[base + kept_rows[k]], bx[j], threshold);
      const unsigned m = __ballot_sync(kFull, hit);
      if (lane == 0 && m) atomicOr(&removed[h], m);
    }
    __syncthreads();
  }
}

}  // namespace

// boxes (n_boxes, 4) float32, offsets (n_groups + 1) int64 with offsets[0] =
// 0 and offsets[n_groups] = n_boxes, valid (n_boxes) uint8 or null, keep
// (n_boxes) uint8 written. Returns a cudaError_t (0 on success).
extern "C" int cosypose_nms(const void* boxes, const void* offsets, const void* valid,
                            int n_groups, int n_boxes, float threshold, void* keep, int device,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_groups < 0 || n_boxes < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n_groups == 0 || n_boxes == 0) return 0;
  // a group is at most n_boxes rows: its removed bits fit the default 48 KB
  const size_t smem = static_cast<size_t>((n_boxes + 63) / 64) * 8;
  if (smem > 48 * 1024 - 1024) return static_cast<int>(cudaErrorInvalidValue);
  nms_kernel<<<n_groups, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const int64_t*>(offsets),
      static_cast<const uint8_t*>(valid), threshold, static_cast<uint8_t*>(keep));
  return static_cast<int>(cudaGetLastError());
}
