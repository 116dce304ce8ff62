// Sum of rows per segment, each segment's rows walked in sorted order.
//
// out[n] = sum of src[perm[j]] over the j with sorted[j] == n, where
// sorted = index[perm] is sorted: the transpose of the gather x[index].
// It is the dvs half of the TPU kernel graphs4cfd_tpu/ops/pallas_gnblock.py:
// _make_bwd_kernel_wg (the one-hot window update at line 719), which sums
// the per-edge first-layer cotangents per sender, and the backward of
// ops/segment.py:gather_sorted_bwd.  A first kernel finds each segment's
// run of `sorted` by binary search; then one block per segment adds its
// rows in a fixed order: no atomics, the same bits on every run.  Bound by bytes: each row of src is
// read once, each row of out written once.
#include "tile.cuh"

namespace g4c {

// off[n] = first position j with sorted[j] >= n, for n = 0 .. nseg: the
// segments' runs, one binary search per thread.
__global__ void __launch_bounds__(NTHREADS)
    segment_offsets_kernel(const int* __restrict__ sorted, int64_t rows,
                           int nseg, int64_t* __restrict__ off) {
  const int64_t n = (int64_t)blockIdx.x * NTHREADS + threadIdx.x;
  if (n > nseg) return;
  int64_t lo = 0, hi = rows;
  while (lo < hi) {
    const int64_t mid = (lo + hi) / 2;
    if (__ldg(sorted + mid) < n)
      lo = mid + 1;
    else
      hi = mid;
  }
  off[n] = lo;
}

// One block per segment: warp w adds the rows off[seg] + w, + w + 8, ...
// (a lane owns 4 adjacent columns of a 128-column slice), then the 8 warp
// sums are added in warp order.  A padded batch piles all its pad edges
// onto one segment; 8 warps walk it, each with several rows in flight.
__global__ void __launch_bounds__(NTHREADS)
    sorted_segment_sum_kernel(const float* __restrict__ src,
                              const int* __restrict__ perm,
                              const int64_t* __restrict__ off, int F,
                              int vec4, float* __restrict__ out) {
  constexpr int NW = NTHREADS / 32;
  __shared__ float part[NW][128];
  const int seg = blockIdx.x;
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int64_t lo = __ldg(off + seg), hi = __ldg(off + seg + 1);
  for (int c0 = 0; c0 < F; c0 += 128) {
    const int c = c0 + 4 * lane;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    if (vec4) {
      if (c < F)
#pragma unroll 4
        for (int64_t j = lo + w; j < hi; j += NW) {
          const float4 x = __ldg(reinterpret_cast<const float4*>(
              src + (size_t)__ldg(perm + j) * F + c));
          s.x += x.x;
          s.y += x.y;
          s.z += x.z;
          s.w += x.w;
        }
    } else {
      for (int64_t j = lo + w; j < hi; j += NW) {
        const float* r = src + (size_t)__ldg(perm + j) * F;
        if (c < F) s.x += __ldg(r + c);
        if (c + 1 < F) s.y += __ldg(r + c + 1);
        if (c + 2 < F) s.z += __ldg(r + c + 2);
        if (c + 3 < F) s.w += __ldg(r + c + 3);
      }
    }
    part[w][4 * lane] = s.x;
    part[w][4 * lane + 1] = s.y;
    part[w][4 * lane + 2] = s.z;
    part[w][4 * lane + 3] = s.w;
    __syncthreads();
    if (threadIdx.x < 128 && c0 + threadIdx.x < F) {
      float t = 0.f;
      for (int q = 0; q < NW; ++q) t += part[q][threadIdx.x];
      out[(size_t)seg * F + c0 + threadIdx.x] = t;
    }
    __syncthreads();
  }
}

}  // namespace g4c

extern "C" {

// src [rows, F] f32, perm and sorted [rows] int32 -> out [nseg, F];
// off: nseg + 1 int64 of scratch.
int g4c_sorted_segment_sum(const void* src, const void* perm,
                           const void* sorted, int64_t rows, int F, int nseg,
                           void* off, void* out, void* stream) {
  using namespace g4c;
  if (rows < 0 || F < 1 || nseg < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned grid = (unsigned)((nseg + 1 + NTHREADS - 1) / NTHREADS);
  segment_offsets_kernel<<<grid, NTHREADS, 0, s>>>(
      (const int*)sorted, rows, nseg, (int64_t*)off);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int vec4 = F % 4 == 0 && (uintptr_t)src % 16 == 0;
  sorted_segment_sum_kernel<<<nseg, NTHREADS, 0, s>>>(
      (const float*)src, (const int*)perm, (const int64_t*)off, F, vec4,
      (float*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
