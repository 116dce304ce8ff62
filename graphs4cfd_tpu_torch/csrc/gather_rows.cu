// Row gather out[m] = table[idx[m]], f32 rows, int32 indices.
//
// Replaces the TPU kernel graphs4cfd_tpu/ops/pallas_gather.py:windowed_take
// (_wt_fwd, kernel _fwd_kernel): the gather from a graph-parallel halo
// table.  That kernel turns the gather into a one-hot matmul over a
// window of the table, because the TPU cannot load rows by index; here
// each warp loads its rows by index, so there is no window plan and no
// out-of-window exception path.  Its transpose (_wt_vjp_bwd) is
// sorted_segment_sum.cu over a host sort of the indices.
//
// Bound by bytes: each gathered row is read once and written once, with
// nothing to compute.  One warp copies one output row at a time, a lane
// 4 adjacent floats (16-byte loads and stores when H % 4 == 0 and the
// rows are 16-byte aligned), so a warp moves 512 bytes per step; the
// grid strides over the rows.  An index outside [0, S) gives a NaN row
// and the table is never read outside its rows.
#include "tile.cuh"

namespace g4c {

__global__ void __launch_bounds__(NTHREADS)
    gather_rows_kernel(const float* __restrict__ table,
                       const int* __restrict__ idx, int64_t M, int H, int S,
                       int vec4, float* __restrict__ out) {
  constexpr int NW = NTHREADS / 32;
  const int lane = threadIdx.x % 32;
  const int64_t nwarps = (int64_t)gridDim.x * NW;
  for (int64_t m = (int64_t)blockIdx.x * NW + threadIdx.x / 32; m < M;
       m += nwarps) {
    const int s = __ldg(idx + m);
    float* dst = out + (size_t)m * H;
    if (s < 0 || s >= S) {
      for (int c = lane; c < H; c += 32) dst[c] = __int_as_float(0x7fc00000);
      continue;
    }
    const float* src = table + (size_t)s * H;
    if (vec4) {
      for (int c = 4 * lane; c < H; c += 128)
        *reinterpret_cast<float4*>(dst + c) =
            __ldg(reinterpret_cast<const float4*>(src + c));
    } else {
      for (int c = lane; c < H; c += 32) dst[c] = __ldg(src + c);
    }
  }
}

}  // namespace g4c

extern "C" {

// table [S, H] f32, idx [M] int32 -> out [M, H] f32.
int g4c_gather_rows(const void* table, const void* idx, int64_t M, int H,
                    int S, void* out, void* stream) {
  using namespace g4c;
  if (M < 1 || H < 1 || S < 1) return (int)cudaErrorInvalidValue;
  constexpr int NW = NTHREADS / 32;
  const int vec4 = H % 4 == 0 && (uintptr_t)table % 16 == 0 &&
                   (uintptr_t)out % 16 == 0;
  int64_t blocks = (M + NW - 1) / NW;
  if (blocks > 65535 * 8) blocks = 65535 * 8;
  gather_rows_kernel<<<(unsigned)blocks, NTHREADS, 0, (cudaStream_t)stream>>>(
      (const float*)table, (const int*)idx, M, H, S, vec4, (float*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
