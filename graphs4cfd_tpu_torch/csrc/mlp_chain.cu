// Fused MLP chain, forward: Linear -> SELU -> ... -> Linear (-> LayerNorm).
//
// Replaces the TPU kernel graphs4cfd_tpu/ops/pallas_mlp.py:_make_fwd_kernel
// (called from _fused_fwd_impl, entry fused_mlp).  With `preact` the input
// is the pre-activation of a first layer computed outside (start=1) and the
// chain begins with SELU of it.
//
// Bound on the H100: a 128-wide layer does 256 FLOPs per row and layer for
// the few hundred bytes a row reads and writes once, far above the ridge
// (67 TFLOP/s f32 / 3.35 TB/s = 20 FLOP/byte; 495 TFLOP/s TF32 / 3.35 TB/s
// = 148, or 49 at three TF32 products per f32 one), so the products bound
// it: at the MuS level-1 edge encoder (242,688 rows, 2 -> 128 -> 128 ->
// 128) 0.239 ms on the f32 CUDA cores, 0.097 ms on the tensor cores as
// 3xTF32.
//
// Design (mlp_tile.cuh), and what it does about the limits of the first,
// SIMT version (64-row tiles, a 4 x NT register tile of f32 FMAs per
// thread, about 13 TFLOP/s): one block of 8 warps per tile of 96 rows
// (EdgeL, the GN tile's edge side), every product on the tensor cores as
// 3xTF32 mma.sync through mma_tf32x3.cuh, the weights through its
// two-stage cp.async ring (L2 evict_last), each layer's output in place of
// its input in one shared-memory tile (88 KB for 128-wide chains: two
// blocks per SM; 64-row tiles below 32,768 rows, which load the SMs more
// evenly; for outputs wider than 128, two 64-row tiles, whose layers
// alternate between them).  Narrow inputs
// (K = 2, 4, 5) are padded to 8 columns with zeros in shared memory, rows
// that are not 16-byte units are loaded 4 bytes at a time, ragged last
// tiles are zero-padded and masked on the way out.
//
// The bf16 policy (compute_dtype bfloat16, pallas_mlp.py's fused_mlp with
// x and the output in bf16) has a kernel of its own, for every width this
// one takes: mlp_chain_fwd_bf16.cu (64-row m-tiles a warpgroup, bf16 tiles
// in shared memory, wgmma, the weights rounded to bf16 once a block).  Its
// bound at the edge encoder: 16.0 GFLOP at 989 TFLOP/s (0.016 ms) against
// 260 bytes a row, 63 MB (0.019 ms): the bytes, by a little.
#include "mlp_tile.cuh"
#include "mlp_tile_bf16.cuh"

namespace g4c {
namespace mlp {

// A second tile when an output is wider than one product pass.
__host__ __device__ inline bool wide_outputs(int n, const int* dims) {
  for (int l = 1; l <= n; ++l)
    if (dims[l] > COLS) return true;
  return false;
}

template <class L>
__global__ void __launch_bounds__(THREADS, 2)
    mlp_chain_kernel(const MlpArgs<float> a) {
  extern __shared__ float smem[];
  constexpr int R = rows_of<L>();
  const bool wide = wide_outputs(a.n, a.dims);
  float* T1 = wide ? smem + R * a.ld : nullptr;
  float* ring = smem + (wide ? 2 : 1) * R * a.ld;
  const int64_t row0 = (int64_t)blockIdx.x * R;
  const int valid = a.rows - row0 < R ? (int)(a.rows - row0) : R;
  chain_forward<L, false>(a, smem, T1, ring, row0, valid);
}

template <class L>
static cudaError_t launch_fwd(const MlpArgs<float>& a, size_t smem,
                              cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      mlp_chain_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  constexpr int R = rows_of<L>();
  const unsigned grid = (unsigned)((a.rows + R - 1) / R);
  mlp_chain_kernel<L><<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

// The chain's arguments, with the activations of type T.
template <class T>
static MlpArgs<T> chain_args(const void* x, void* out, int64_t rows, int n,
                             const void* const* w, const void* const* b,
                             const int* dims, const void* ln_scale,
                             const void* ln_bias, int preact) {
  MlpArgs<T> a{};
  a.x = (const T*)x;
  a.out = (T*)out;
  a.rows = rows;
  a.n = n;
  for (int l = 0; l <= n; ++l) a.dims[l] = dims[l];
  for (int l = 0; l < n; ++l) {
    a.w[l] = (const float*)w[l];
    a.b[l] = (const float*)b[l];
  }
  a.ln_scale = (const float*)ln_scale;
  a.ln_bias = (const float*)ln_bias;
  a.preact = preact;
  return a;
}

// The f32 chain on the tile that suits its row count.
static int launch_chain(MlpArgs<float> a, size_t smem, cudaStream_t s) {
  a.ld = round8(mlp_wmax(a.n, a.dims, 2 * COLS)) + 4;
  return (int)(small_tiles(a.rows, wide_outputs(a.n, a.dims))
                   ? launch_fwd<SmallL>(a, smem, s)
                   : launch_fwd<EdgeL>(a, smem, s));
}

}  // namespace mlp
}  // namespace g4c

extern "C" {

// Shared-memory bytes one block needs for a chain of `rows` rows (of the
// bf16 policy's kernel, at its most warpgroups a block, if `is_bf16`), or
// 0 if the widths are not taken: 1-8 layers, output widths up to 256.
size_t g4c_mlp_chain_smem(int n, const int* dims, int64_t rows,
                          int is_bf16) {
  using namespace g4c::mlp;
  const int wmax = mlp_wmax(n, dims, 2 * COLS);
  if (wmax == 0) return 0;
  if (is_bf16) {
    const bool streamed = g4c::mlp16::fwd_streamed(n, dims);
    const int g = g4c::mlp16::fwd_fit(n, dims, streamed);
    return g == 0 ? 0 : g4c::mlp16::fwd_smem_bytes(n, dims, streamed, g);
  }
  const bool wide = wide_outputs(n, dims);
  return sizeof(float) *
         mlp_smem_floats(wmax, wide ? 2 : 1,
                         small_tiles(rows, wide) ? SMALL_ROWS : ROWS);
}

// x [rows, dims[0]] -> out [rows, dims[n]]; w[l] [dims[l], dims[l+1]],
// b[l] [dims[l+1]], ln_scale/ln_bias [dims[n]] or null, f32; x and out
// bf16 if `is_bf16`, else f32.  Row-major, on the device.  Returns the
// launch's cudaError_t.
int g4c_mlp_chain(const void* x, void* out, int64_t rows, int n,
                  const void* const* w, const void* const* b, const int* dims,
                  const void* ln_scale, const void* ln_bias, int preact,
                  int is_bf16, void* stream) {
  using namespace g4c;
  using namespace g4c::mlp;
  const size_t smem = g4c_mlp_chain_smem(n, dims, rows, is_bf16);
  if (smem == 0 || smem > 232448 || rows < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return (int)mlp16::launch_fwd(
        chain_args<tc::bf16>(x, out, rows, n, w, b, dims, ln_scale, ln_bias,
                             preact),
        s);
  return launch_chain(chain_args<float>(x, out, rows, n, w, b, dims,
                                        ln_scale, ln_bias, preact),
                      smem, s);
}

const char* g4c_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
