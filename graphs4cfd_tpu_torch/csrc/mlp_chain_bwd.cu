// Fused MLP chain, backward: from the chain's input x and the cotangent g
// of its output, dx (optional), every dW, db and the LayerNorm's
// (dscale, dbias).
//
// Replaces the TPU kernel graphs4cfd_tpu/ops/pallas_mlp.py:_make_bwd_kernel
// (called from _fused_vjp_bwd).  As there, the forward is recomputed from
// x inside the kernel ("remat"): only x and the weights are kept between
// the passes.  With `preact` the input is the pre-activation of a first
// layer computed outside (start=1) and dx carries SELU'(x).
//
// Bound on the H100: the recomputed forward plus two products per layer
// (dW = h^T da and dh = da W^T), 3 x 2 x rows x sum(K N) FLOPs, against a
// few hundred bytes per row: bound by the f32 CUDA cores (67 TFLOP/s) at
// every size of the path.  Design: the TPU kernel sums dW over a
// sequential grid; here a persistent grid of as many blocks as the card
// holds at once walks the 64-row tiles in a fixed order (block b takes
// tiles b, b + G, ...).  A block keeps each layer's activation h in shared
// memory (SELU' comes from h itself, so no pre-activation is kept), adds
// its tiles' dW, db and dLN into its own partial in device memory (each
// element owned by one thread: no atomics), and a second kernel sums the G
// partials in block order.  Every run gives the same bits.
#include "tile.cuh"

namespace g4c {

constexpr int MLPB_BM = 64;  // rows per tile = TY * 4

struct MlpBwdArgs {
  const float* x;
  const float* g;
  float* dx;  // null: no input gradient
  int64_t rows;
  int n;
  const float* w[MAX_LAYERS];
  const float* b[MAX_LAYERS];
  int dims[MAX_LAYERS + 1];
  const float* ln_scale;  // null: no LayerNorm
  int preact;
  int ld0, ldh;  // row strides of the input tile and the hidden tiles
  float* work;   // [gridDim.x][P] partial gradients
  int64_t P;
  int64_t off_w[MAX_LAYERS], off_b[MAX_LAYERS], off_ln;
};

template <int NT>
__global__ void __launch_bounds__(NTHREADS)
    mlp_chain_bwd_kernel(const MlpBwdArgs a) {
  constexpr int TM = MLPB_BM / TY;
  extern __shared__ float smem[];
  // act[l]: the input of layer l (selu(x) or x for l = 0); D: a cotangent
  float* act[MAX_LAYERS];
  act[0] = smem;
  float* p = smem + MLPB_BM * a.ld0;
  for (int l = 1; l < a.n; ++l) {
    act[l] = p;
    p += MLPB_BM * a.ldh;
  }
  float* D = p;
  float* wtile = D + MLPB_BM * a.ldh;
  float* part = a.work + (size_t)blockIdx.x * a.P;
  for (int64_t i = threadIdx.x; i < a.P; i += NTHREADS) part[i] = 0.f;
  const int N = a.dims[a.n];
  const int64_t ntiles = (a.rows + MLPB_BM - 1) / MLPB_BM;

  for (int64_t t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int64_t row0 = t * MLPB_BM;
    const int valid =
        a.rows - row0 < MLPB_BM ? (int)(a.rows - row0) : MLPB_BM;
    __syncthreads();
    load_tile(a.x, row0, valid, a.dims[0], act[0], a.ld0, MLPB_BM,
              a.preact != 0);
    // remat forward; the last pre-LN output stays in acc
    float acc[TM][NT];
    for (int l = 0; l < a.n; ++l) {
      zero(acc);
      mm_acc<TM, NT>(acc, act[l], l ? a.ldh : a.ld0, a.dims[l], a.w[l],
                     a.dims[l + 1], wtile);
      add_bias(acc, a.dims[l + 1], a.b[l]);
      if (l < a.n - 1) {
        apply_selu(acc);
        store_smem(acc, act[l + 1], a.ldh, a.dims[l + 1]);
      }
    }
    float gr[TM][NT];
    load_regs(gr, a.g, row0, valid, N);
    if (a.ln_scale != nullptr)
      ln_backward(gr, acc, N, a.ln_scale, D, a.ldh, MLPB_BM,
                  part + a.off_ln, part + a.off_ln + N);
    __syncthreads();
    store_smem(gr, D, a.ldh, N);
    for (int l = a.n - 1; l >= 0; --l) {
      const int K = a.dims[l], Nl = a.dims[l + 1];
      __syncthreads();
      colsum_rmw(D, a.ldh, MLPB_BM, Nl, part + a.off_b[l]);
      wgrad_rmw<NT>(act[l], l ? a.ldh : a.ld0, K, D, a.ldh, Nl, MLPB_BM,
                    part + a.off_w[l]);
      if (l > 0) {
        zero(acc);
        mm_acc_wt<TM, NT>(acc, D, a.ldh, Nl, a.w[l], Nl, K, wtile);
        mul_dselu_of_selu(acc, act[l], a.ldh, K);
        __syncthreads();
        store_smem(acc, D, a.ldh, K);
      } else if (a.dx != nullptr) {
        const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
        for (int c0 = 0; c0 < K; c0 += TX * NT) {
          const int Kc = min(TX * NT, K - c0);
          zero(acc);
          mm_acc_wt<TM, NT>(acc, D, a.ldh, Nl, a.w[0] + (size_t)c0 * Nl, Nl,
                            Kc, wtile);
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            const int r = ty * TM + i;
            if (r >= valid) continue;
#pragma unroll
            for (int j = 0; j < NT; ++j) {
              const int c = tx + TX * j;
              if (c >= Kc) continue;
              float v = acc[i][j];
              if (a.preact) v *= dselu_of_selu(act[0][r * a.ld0 + c0 + c]);
              a.dx[(size_t)(row0 + r) * K + c0 + c] = v;
            }
          }
        }
      }
    }
  }
}

// Output widths (and with them the cotangent tiles) up to 16 * NT.
static int mlp_bwd_nt(int n, const int* dims) {
  int nmax = 0;
  for (int l = 1; l <= n; ++l) nmax = dims[l] > nmax ? dims[l] : nmax;
  return nmax <= 4 * TX ? 4 : (nmax <= 8 * TX ? 8 : 0);
}

template <int NT>
static cudaError_t launch_mlp_bwd(const MlpBwdArgs& a, size_t smem, int grid,
                                  float* out, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      mlp_chain_bwd_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  mlp_chain_bwd_kernel<NT><<<grid, NTHREADS, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce(a.work, grid, a.P, out, stream);
}

}  // namespace g4c

extern "C" {

// Shared-memory bytes one block needs, or 0 if the widths are not taken:
// 1-8 layers, output widths up to 128.
size_t g4c_mlp_chain_bwd_smem(int n, const int* dims) {
  using namespace g4c;
  if (n < 1 || n > MAX_LAYERS) return 0;
  for (int l = 0; l <= n; ++l)
    if (dims[l] < 1) return 0;
  const int nt = mlp_bwd_nt(n, dims);
  if (nt == 0) return 0;
  int nmax = 0, kmax = 0;
  for (int l = 0; l < n; ++l) {
    nmax = dims[l + 1] > nmax ? dims[l + 1] : nmax;
    kmax = dims[l] > kmax ? dims[l] : kmax;
  }
  const int kc = kmax < TX * nt ? kmax : TX * nt;
  const int wt = (nmax > kc ? nmax : kc) + 1;
  return sizeof(float) * ((size_t)MLPB_BM * (dims[0] + 4) +
                          (size_t)n * MLPB_BM * (nmax + 4) + (size_t)BK * wt);
}

// Blocks of the persistent grid for `rows` rows, or 0 on error.
int g4c_mlp_chain_bwd_grid(int n, const int* dims, int64_t rows) {
  using namespace g4c;
  const size_t smem = g4c_mlp_chain_bwd_smem(n, dims);
  if (smem == 0 || rows < 1) return 0;
  const int64_t tiles = (rows + MLPB_BM - 1) / MLPB_BM;
  const int held = mlp_bwd_nt(n, dims) == 4
                       ? resident_blocks(mlp_chain_bwd_kernel<4>, smem)
                       : resident_blocks(mlp_chain_bwd_kernel<8>, smem);
  return (int)(tiles < held ? tiles : held);
}

// x [rows, dims[0]], g [rows, dims[n]] -> dx [rows, dims[0]] (or null),
// and into `out` the gradients W0, b0, W1, b1, ..., LN scale, LN bias,
// flat in that order; `work` holds grid x that many floats.  Weights as in
// g4c_mlp_chain.  Returns the first cudaError_t of the two launches.
int g4c_mlp_chain_bwd(const void* x, const void* g, void* dx, int64_t rows,
                      int n, const void* const* w, const void* const* b,
                      const int* dims, const void* ln_scale, int preact,
                      void* work, int grid, void* out, void* stream) {
  using namespace g4c;
  const size_t smem = g4c_mlp_chain_bwd_smem(n, dims);
  if (smem == 0 || smem > 232448 || rows < 1 || grid < 1)
    return (int)cudaErrorInvalidValue;
  MlpBwdArgs a{};
  a.x = (const float*)x;
  a.g = (const float*)g;
  a.dx = (float*)dx;
  a.rows = rows;
  a.n = n;
  int nmax = 0;
  int64_t off = 0;
  for (int l = 0; l <= n; ++l) a.dims[l] = dims[l];
  for (int l = 0; l < n; ++l) {
    a.w[l] = (const float*)w[l];
    a.b[l] = (const float*)b[l];
    a.off_w[l] = off;
    off += (int64_t)dims[l] * dims[l + 1];
    a.off_b[l] = off;
    off += dims[l + 1];
    nmax = dims[l + 1] > nmax ? dims[l + 1] : nmax;
  }
  a.off_ln = off;
  a.ln_scale = (const float*)ln_scale;
  if (ln_scale != nullptr) off += 2 * (int64_t)dims[n];
  a.P = off;
  a.preact = preact;
  a.ld0 = dims[0] + 4;
  a.ldh = nmax + 4;
  a.work = (float*)work;
  cudaStream_t s = (cudaStream_t)stream;
  if (mlp_bwd_nt(n, dims) == 4)
    return (int)launch_mlp_bwd<4>(a, smem, grid, (float*)out, s);
  return (int)launch_mlp_bwd<8>(a, smem, grid, (float*)out, s);
}

}  // extern "C"
