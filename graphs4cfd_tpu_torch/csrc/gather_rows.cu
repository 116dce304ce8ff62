// Row gather out[m] = table[idx[m]], f32 or bf16 rows, int32 indices.
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
// nothing to compute.  A gather copies bits, so one kernel serves both
// element types through the element's bits (T: uint32_t for f32, uint16_t
// for bf16, the bf16 policy's halo tables).  One warp copies one output
// row at a time, a lane 16 bytes (4 f32 or 8 bf16) when the row's bytes
// are a multiple of 16 and the rows are 16-byte aligned, else one element;
// the grid strides over the rows.  An index outside [0, S) gives a NaN row
// (the type's quiet NaN) and the table is never read outside its rows.
#include "tile.cuh"

namespace g4c {

template <typename T>
struct RowBits;
template <>
struct RowBits<uint32_t> {
  static constexpr uint32_t nan = 0x7fc00000u;  // f32 quiet NaN
};
template <>
struct RowBits<uint16_t> {
  static constexpr uint16_t nan = 0x7fc0u;      // bf16 quiet NaN
};

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
    gather_rows_kernel(const T* __restrict__ table,
                       const int* __restrict__ idx, int64_t M, int H, int S,
                       int vec, T* __restrict__ out) {
  constexpr int NW = NTHREADS / 32;
  constexpr int V = 16 / sizeof(T);               // elements a 16-byte lane
  const int lane = threadIdx.x % 32;
  const int64_t nwarps = (int64_t)gridDim.x * NW;
  for (int64_t m = (int64_t)blockIdx.x * NW + threadIdx.x / 32; m < M;
       m += nwarps) {
    const int s = __ldg(idx + m);
    T* dst = out + (size_t)m * H;
    if (s < 0 || s >= S) {
      for (int c = lane; c < H; c += 32) dst[c] = RowBits<T>::nan;
      continue;
    }
    const T* src = table + (size_t)s * H;
    if (vec) {
      for (int c = V * lane; c < H; c += 32 * V)
        *reinterpret_cast<uint4*>(dst + c) =
            __ldg(reinterpret_cast<const uint4*>(src + c));
    } else {
      for (int c = lane; c < H; c += 32) dst[c] = __ldg(src + c);
    }
  }
}

template <typename T>
int launch_gather(const void* table, const void* idx, int64_t M, int H,
                  int S, void* out, cudaStream_t stream) {
  constexpr int NW = NTHREADS / 32;
  const int vec = (H * sizeof(T)) % 16 == 0 && (uintptr_t)table % 16 == 0 &&
                  (uintptr_t)out % 16 == 0;
  int64_t blocks = (M + NW - 1) / NW;
  if (blocks > 65535 * 8) blocks = 65535 * 8;
  gather_rows_kernel<T><<<(unsigned)blocks, NTHREADS, 0, stream>>>(
      (const T*)table, (const int*)idx, M, H, S, vec, (T*)out);
  return (int)cudaGetLastError();
}

}  // namespace g4c

extern "C" {

// table [S, H] f32 (is_bf16 0) or bf16 (is_bf16 1), idx [M] int32 ->
// out [M, H] of the table's type.
int g4c_gather_rows(const void* table, const void* idx, int64_t M, int H,
                    int S, void* out, int is_bf16, void* stream) {
  using namespace g4c;
  if (M < 1 || H < 1 || S < 1) return (int)cudaErrorInvalidValue;
  return is_bf16 ? launch_gather<uint16_t>(table, idx, M, H, S, out,
                                           (cudaStream_t)stream)
                 : launch_gather<uint32_t>(table, idx, M, H, S, out,
                                           (cudaStream_t)stream);
}

}  // extern "C"
