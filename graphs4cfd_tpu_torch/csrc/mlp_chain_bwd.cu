// Fused MLP chain, backward: from the chain's input x and the cotangent g
// of its output, dx (optional), every dW, db and the LayerNorm's
// (dscale, dbias).
//
// Replaces the TPU kernel graphs4cfd_tpu/ops/pallas_mlp.py:_make_bwd_kernel
// (called from _fused_vjp_bwd).  As there, the forward is recomputed from
// x ("remat"): only x and the weights are kept between the passes.  With
// `preact` the input is the pre-activation of a first layer computed
// outside (start=1) and dx carries SELU'(x).
//
// Bound on the H100: the recomputed forward plus two products per layer
// (dh = da W^T and dW = h^T da), 3 x 2 x rows x sum(K N) FLOPs against a
// few hundred bytes per row, so the products bound it: at the MuS level-1
// edge encoder (242,688 rows, 2 -> 128 -> 128 -> 128, no dx) 0.718 ms on
// the f32 CUDA cores, 0.291 ms on the tensor cores as 3xTF32.
//
// Design, in three launches (one kernel of the port's table; the GN
// backward's shape), and what it does about the limits of the first, SIMT
// version (64-row tiles on a persistent grid, each tile adding its dW, db
// and dLN into its block's whole partial in device memory: 133 KB a tile
// for a 2-layer 128-wide chain, about 1 GB a launch at the edge encoder;
// one block per SM; about 10 TFLOP/s):
//   1. mlp_chain_bwd_kernel, one block per tile of 96 rows (mlp_tile.cuh):
//      the remat forward, the LayerNorm backward as a row pass, then per
//      layer dh = da W^T on the tensor cores (3xTF32 mma.sync) and SELU'
//      from the layer inputs the forward wrote to device memory (read back
//      from L2), and dx where it is asked for.  One tile holds each layer's
//      activations or cotangents in turn: 88 KB of shared memory for
//      128-wide chains, two blocks per SM.  The tile writes, once, the
//      weight gradients' per-row operands that no input or output carries:
//      the inputs of layers 1..n-1 after SELU (and SELU(x) with preact:
//      written here, so that the weight-gradient kernel reads every
//      operand as it is), and the layer-output cotangents that are not g
//      itself; and its column sums (db, dLN) as one partial row.
//   2. gn_wgrad_kernel (wgrad.cu): every dW = X^T D as a split over fixed
//      chunks of rows (2048, down to 256 for the coarse levels' few rows:
//      wgrad_chunk).  At the edge encoder the operands are about 0.5 GB,
//      written once and read once.
//   3. gn_reduce_kernel (wgrad.cu): the chunk partials and the tiles'
//      column sums, each summed in a fixed order.
// No float atomics: two launches give the same bits.
//
// The bf16 policy (pallas_mlp.py's backward under compute_dtype=bfloat16)
// plans the same three launches with bf16 activations: x, g, dx and the
// layer-output cotangents the tile kernel writes for the weight gradients
// are bf16 in device memory, the layer inputs xo f32 (SELU' reads them
// back), every product takes both operands rounded to bf16, and SELU', the
// LayerNorm backward, the column sums and the parameter gradients are f32.
// Its tile kernel is mlp_chain_bwd_bf16.cu's (128-row tiles of bf16 in
// shared memory, wgmma), its weight-gradient kernel wgrad_bf16.cu's.
#include "mlp_tile.cuh"
#include "mlp_tile_bf16.cuh"
#include "wgrad.cuh"

namespace g4c {
namespace mlp {

template <class Act>
__global__ void __launch_bounds__(THREADS, 2)
    mlp_chain_bwd_kernel(const MlpArgs<Act> a) {
  using L = EdgeL;
  using C = tc::Tf32x3;
  extern __shared__ float smem[];
  float* T = smem;
  float* ring = smem + ROWS * a.ld;
  const int64_t row0 = (int64_t)blockIdx.x * ROWS;
  const int valid = a.rows - row0 < ROWS ? (int)(a.rows - row0) : ROWS;
  const int mt = (valid + 15) / 16, ld = a.ld, n = a.n, N = a.dims[n];
  float* cs = a.colsum + (size_t)blockIdx.x * a.pc;

  chain_forward<L, true>(a, T, nullptr, ring, row0, valid);

  // T = the cotangent of the last layer's output: the LayerNorm backward
  // of g (T holds the pre-LN output), or g itself
  if (a.ln_scale != nullptr) {
    float c1[4] = {0.f, 0.f, 0.f, 0.f}, c2[4] = {0.f, 0.f, 0.f, 0.f};
    for (int r = threadIdx.x >> 5; r < mt * 16; r += tc::WARPS) {
      float dx[4] = {0.f, 0.f, 0.f, 0.f};
      if (r < valid) {
        float x[4], g[4];
        load_row(x, T + r * ld, N);
        load_row(g, a.g + (row0 + r) * N, N);
        ln_out_bwd(x, g, N, a.ln_scale, nullptr, false, nullptr, c1, c2, dx);
      }
      store_row(T + r * ld, dx, round8(N));
    }
    colsum_out(c1, N, ring, cs + a.cs_ln);
    colsum_out(c2, N, ring, cs + a.cs_ln + N);
  } else {
    tc::load_rows(T, ld, a.g, row0, valid, mt * 16, N, N,
                  tc::stream_policy());
    tc::cp_commit();
    tc::cp_wait<0>();
  }

  for (int l = n - 1; l >= 0; --l) {
    const int K = a.dims[l], Nl = a.dims[l + 1];
    // T = da, the cotangent of layer l's output: its rows (unless it is
    // g) and its column sums (db)
    copy_rows(T, ld, valid, Nl, a.d_op[l], row0, ring, cs + a.cs_b[l], true);
    if (l > 0) {
      Acc<L> acc;  // da of layer l - 1 = (da W^T) * SELU'
      tc::zero(acc);
      mm_t<L, C>(acc, T, ld, mt, a.w[l], K, Nl, ring);
      mul_dselu<L>(acc, a.xo[l] + row0 * K, valid, K);
      store_tile<L>(acc, T, ld, K, mt);
    } else if (a.dx != nullptr) {
      for (int c0 = 0; c0 < K; c0 += COLS) {  // dx = da W^T, 128 columns
        const int cw = min(COLS, K - c0);    // at a time
        Acc<L> acc;
        tc::zero(acc);
        mm_t<L, C>(acc, T, ld, mt, a.w[0] + (size_t)c0 * Nl, cw, Nl, ring);
        if (a.preact) mul_dselu<L>(acc, a.xo[0] + row0 * K, valid, K);
        store_out<L>(acc, a.dx + c0, row0, valid, cw, K);
      }
    }
  }
}

// Where everything of one launch lives: the operands and column sums in
// the plan's work buffer, the gradients in `out` (W0, b0, W1, b1, ...,
// LN scale, LN bias, flat).  With work null only the sizes are computed.
template <class Act>
static void mlp_bwd_plan(MlpArgs<Act>& a, bool ln, float* out, SplitPlan& p) {
  const int n = a.n, N = a.dims[n];
  const int64_t rows = a.rows;
  const int trows =
      std::is_same<Act, tc::bf16>::value ? mlp16::ROWS : ROWS;  // tile rows
  const int ntiles = (int)((rows + trows - 1) / trows);
  int64_t off = 0, off_w[MAX_LAYERS], off_b[MAX_LAYERS];
  for (int l = 0; l < n; ++l) {
    off_w[l] = off;
    off += (int64_t)a.dims[l] * a.dims[l + 1];
    off_b[l] = off;
    off += a.dims[l + 1];
  }
  const int64_t off_ln = off;
  a.xo[0] = a.preact ? p.take((size_t)rows * a.dims[0]) : nullptr;
  for (int l = 1; l < n; ++l) a.xo[l] = p.take((size_t)rows * a.dims[l]);
  for (int l = 0; l < n; ++l)
    a.d_op[l] = l == n - 1 && !ln
                    ? nullptr
                    : p.take_as<Act>((size_t)rows * a.dims[l + 1]);
  int pc = 0;
  for (int l = 0; l < n; ++l) {
    a.cs_b[l] = pc;
    pc += a.dims[l + 1];
  }
  a.cs_ln = pc;
  if (ln) pc += 2 * N;
  a.pc = pc;
  a.colsum = p.take((size_t)ntiles * pc);
  if constexpr (std::is_same<Act, tc::bf16>::value)
    a.wimg = p.take_as<uint8_t>((size_t)mlp16::weight_slices(n, a.dims) *
                                gn16::W_BYTES);
  for (int l = 0; l < n; ++l) {
    const Act* d = a.d_op[l] != nullptr ? a.d_op[l] : a.g;
    if (a.xo[l] != nullptr)
      p.prod(a.xo[l], d, rows, a.dims[l], a.dims[l + 1], out + off_w[l]);
    else
      p.prod(a.x, d, rows, a.dims[l], a.dims[l + 1], out + off_w[l]);
  }
  for (int l = 0; l < n; ++l)
    p.seg(a.colsum + a.cs_b[l], out + off_b[l], pc, ntiles, a.dims[l + 1]);
  if (ln) p.seg(a.colsum + a.cs_ln, out + off_ln, pc, ntiles, 2 * N);
}

template <class Act>
static void mlp_bwd_shape(MlpArgs<Act>& a, int64_t rows, int n,
                          const int* dims,
                          int preact, int wmax) {
  a.rows = rows;
  a.n = n;
  for (int l = 0; l <= n; ++l) a.dims[l] = dims[l];
  a.preact = preact;
  a.ld = round8(wmax) + 4;
}

template <class Act>
static int launch_bwd(const void* x, const void* g, void* dx, int64_t rows,
                      int n, const void* const* w, const void* const* b,
                      const int* dims, const void* ln_scale, int preact,
                      void* work, void* out, int parts, size_t smem,
                      cudaStream_t s) {
  MlpArgs<Act> a{};
  mlp_bwd_shape(a, rows, n, dims, preact, mlp_wmax(n, dims, COLS));
  a.x = (const Act*)x;
  a.g = (const Act*)g;
  a.dx = (Act*)dx;
  for (int l = 0; l < n; ++l) {
    a.w[l] = (const float*)w[l];
    a.b[l] = (const float*)b[l];
  }
  a.ln_scale = (const float*)ln_scale;
  SplitPlan p((float*)work, std::is_same<Act, tc::bf16>::value);
  mlp_bwd_plan(a, ln_scale != nullptr, (float*)out, p);
  cudaError_t err;
  if (parts & 1) {
    if constexpr (std::is_same<Act, tc::bf16>::value) {
      err = mlp16::launch_bwd_tile(a, smem, s);
    } else {
      err = cudaFuncSetAttribute(mlp_chain_bwd_kernel<Act>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
      if (err != cudaSuccess) return (int)err;
      const unsigned grid = (unsigned)((rows + ROWS - 1) / ROWS);
      mlp_chain_bwd_kernel<Act><<<grid, THREADS, smem, s>>>(a);
      err = cudaGetLastError();
    }
    if (err != cudaSuccess) return (int)err;
  }
  if (parts & 2) {
    err = launch_wgrad(p, s);
    if (err != cudaSuccess) return (int)err;
  }
  if (parts & 4) {
    err = launch_reduce(p, s);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace mlp
}  // namespace g4c

extern "C" {

// Shared-memory bytes one block of the tile kernel needs (the bf16
// policy's if `is_bf16`), or 0 if the widths are not taken: 1-8 layers,
// output widths up to 128, and with `preact` an input up to 128 wide.
size_t g4c_mlp_chain_bwd_smem(int n, const int* dims, int preact,
                              int is_bf16) {
  using namespace g4c::mlp;
  const int wmax = mlp_wmax(n, dims, COLS);
  if (wmax == 0 || (preact && dims[0] > COLS)) return 0;
  if (is_bf16) return g4c::mlp16::smem_bytes(dims[0], n);
  return sizeof(float) * mlp_smem_floats(wmax, 1, ROWS);
}

// Floats of the work buffer of g4c_mlp_chain_bwd, or 0 if the widths are
// not taken (`is_bf16`: the bf16 policy's launch).
size_t g4c_mlp_chain_bwd_work(int n, const int* dims, int64_t rows,
                              int has_ln, int preact, int is_bf16) {
  using namespace g4c;
  using namespace g4c::mlp;
  if (g4c_mlp_chain_bwd_smem(n, dims, preact, is_bf16) == 0 || rows < 1)
    return 0;
  SplitPlan p(nullptr, is_bf16 != 0);
  if (is_bf16) {
    MlpArgs<tc::bf16> a{};
    mlp_bwd_shape(a, rows, n, dims, preact, mlp_wmax(n, dims, COLS));
    mlp_bwd_plan(a, has_ln != 0, nullptr, p);
  } else {
    MlpArgs<float> a{};
    mlp_bwd_shape(a, rows, n, dims, preact, mlp_wmax(n, dims, COLS));
    mlp_bwd_plan(a, has_ln != 0, nullptr, p);
  }
  return p.used;
}

// x [rows, dims[0]], g [rows, dims[n]] -> dx [rows, dims[0]] (or null),
// and into `out` the gradients W0, b0, W1, b1, ..., LN scale, LN bias,
// flat in that order; `work` holds g4c_mlp_chain_bwd_work floats.  Weights
// as in g4c_mlp_chain; x, g and dx bf16 if `is_bf16`, else f32; the
// gradients f32.  `parts` selects the launches (1: the tile kernel, 2: the
// weight-gradient kernel, 4: the reduction; 7 for all), so that a caller
// can time them apart.  Returns the first cudaError_t.
int g4c_mlp_chain_bwd(const void* x, const void* g, void* dx, int64_t rows,
                      int n, const void* const* w, const void* const* b,
                      const int* dims, const void* ln_scale, int preact,
                      void* work, void* out, int parts, int is_bf16,
                      void* stream) {
  using namespace g4c;
  using namespace g4c::mlp;
  const size_t smem = g4c_mlp_chain_bwd_smem(n, dims, preact, is_bf16);
  if (smem == 0 || smem > 232448 || rows < 1 || work == nullptr)
    return (int)cudaErrorInvalidValue;
  auto launch = is_bf16 ? launch_bwd<tc::bf16> : launch_bwd<float>;
  return launch(x, g, dx, rows, n, w, b, dims, ln_scale, preact, work, out,
                parts, smem, (cudaStream_t)stream);
}

}  // extern "C"
