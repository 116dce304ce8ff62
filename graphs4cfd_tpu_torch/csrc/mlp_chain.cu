// Fused MLP chain, forward: Linear -> SELU -> ... -> Linear (-> LayerNorm).
//
// Replaces the TPU kernel graphs4cfd_tpu/ops/pallas_mlp.py:_make_fwd_kernel
// (called from _fused_fwd_impl, entry fused_mlp).  With `preact` the input
// is the pre-activation of a first layer computed outside (start=1) and the
// chain begins with SELU of it.
//
// Bound on the H100: a 2-layer 128-wide tail does 65,536 FLOPs per row for
// the 1 KB it reads and writes, 64 FLOP/byte, above the f32 CUDA-core ridge
// (67 TFLOP/s / 3.35 TB/s = 20 FLOP/byte), so the products bound it at any
// size; at the coarse levels (1-14 K rows) launch latency and the 130 KB of
// weights that every block reads come on top.  Design: one block of 256 threads owns 64
// rows, keeps the running activation tile in shared memory (two buffers,
// ping-pong), streams each weight matrix through shared memory in 32-row
// slices, and holds a 4 x NT register tile of outputs per thread.  Input
// and output cross device memory once; the intermediates never do.
#include "tile.cuh"

namespace g4c {

constexpr int MLP_BM = 64;  // rows per block = TY * 4

struct MlpArgs {
  const float* x;
  float* out;
  int64_t rows;
  int n;  // layers
  const float* w[MAX_LAYERS];
  const float* b[MAX_LAYERS];
  int dims[MAX_LAYERS + 1];
  const float* ln_scale;  // null: no LayerNorm
  const float* ln_bias;
  int preact;
  int ld;  // row stride of the activation buffers
};

template <int NT>
__global__ void __launch_bounds__(NTHREADS)
    mlp_chain_kernel(const MlpArgs a) {
  constexpr int TM = MLP_BM / TY;
  extern __shared__ float smem[];
  float* cur = smem;
  float* nxt = cur + MLP_BM * a.ld;
  float* wtile = nxt + MLP_BM * a.ld;
  const int64_t row0 = (int64_t)blockIdx.x * MLP_BM;
  const int valid = a.rows - row0 < MLP_BM ? (int)(a.rows - row0) : MLP_BM;

  load_tile(a.x, row0, valid, a.dims[0], cur, a.ld, MLP_BM, a.preact != 0);
  for (int l = 0; l < a.n; ++l) {
    const int N = a.dims[l + 1];
    float acc[TM][NT];
    zero(acc);
    mm_acc<TM, NT>(acc, cur, a.ld, a.dims[l], a.w[l], N, wtile);
    add_bias(acc, N, a.b[l]);
    if (l < a.n - 1) {
      apply_selu(acc);
      store_smem(acc, nxt, a.ld, N);
      float* t = cur;
      cur = nxt;
      nxt = t;
    } else {
      if (a.ln_scale != nullptr) layer_norm(acc, N, a.ln_scale, a.ln_bias);
      store_global(acc, a.out, row0, valid, N, false);
    }
  }
}

template <int NT>
static cudaError_t launch_mlp(const MlpArgs& a, size_t smem,
                              cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      mlp_chain_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned grid = (unsigned)((a.rows + MLP_BM - 1) / MLP_BM);
  mlp_chain_kernel<NT><<<grid, NTHREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace g4c

extern "C" {

// Shared-memory bytes one block needs, or 0 if the widths are not taken.
size_t g4c_mlp_chain_smem(int n, const int* dims) {
  using namespace g4c;
  if (n < 1 || n > MAX_LAYERS) return 0;
  int wmax = 0, nmax = 0;
  for (int l = 0; l <= n; ++l) {
    if (dims[l] < 1) return 0;
    if (l < n && dims[l] > wmax) wmax = dims[l];
    if (l > 0 && dims[l] > nmax) nmax = dims[l];
  }
  if (nmax > 16 * TX) return 0;
  return sizeof(float) * (2 * (size_t)MLP_BM * (wmax + 4) + (size_t)BK * nmax);
}

// x [rows, dims[0]] -> out [rows, dims[n]]; w[l] [dims[l], dims[l+1]],
// b[l] [dims[l+1]], ln_scale/ln_bias [dims[n]] or null.  All f32,
// row-major, on the device.  Returns the launch's cudaError_t.
int g4c_mlp_chain(const void* x, void* out, int64_t rows, int n,
                  const void* const* w, const void* const* b, const int* dims,
                  const void* ln_scale, const void* ln_bias, int preact,
                  void* stream) {
  using namespace g4c;
  const size_t smem = g4c_mlp_chain_smem(n, dims);
  if (smem == 0 || smem > 232448 || rows < 1) return (int)cudaErrorInvalidValue;
  MlpArgs a{};
  a.x = (const float*)x;
  a.out = (float*)out;
  a.rows = rows;
  a.n = n;
  int wmax = 0, nmax = 0;
  for (int l = 0; l <= n; ++l) {
    a.dims[l] = dims[l];
    if (l < n && dims[l] > wmax) wmax = dims[l];
    if (l > 0 && dims[l] > nmax) nmax = dims[l];
  }
  for (int l = 0; l < n; ++l) {
    a.w[l] = (const float*)w[l];
    a.b[l] = (const float*)b[l];
  }
  a.ln_scale = (const float*)ln_scale;
  a.ln_bias = (const float*)ln_bias;
  a.preact = preact;
  a.ld = wmax + 4;
  cudaStream_t s = (cudaStream_t)stream;
  if (nmax <= 4 * TX) return (int)launch_mlp<4>(a, smem, s);
  if (nmax <= 8 * TX) return (int)launch_mlp<8>(a, smem, s);
  return (int)launch_mlp<16>(a, smem, s);
}

const char* g4c_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
