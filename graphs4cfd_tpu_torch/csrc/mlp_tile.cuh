// The MLP-chain tile shared by mlp_chain.cu (forward) and mlp_chain_bwd.cu
// (whose tile kernel recomputes this forward, then runs the chain
// backwards): arguments, geometry and the forward itself.
//
// An MLP chain is the GN block's edge side without the sender gather and
// the mean over k, so it runs on the GN tile's code (gn_tile.cuh): a tile
// of rows holds each layer's activations in turn, every product runs on
// the tensor cores as 3xTF32 (mma_tf32x3.cuh), wider outputs (up to 256,
// the forward only) in two column passes of 128, and the LayerNorm is a
// row pass, one warp per row.  The tiles have EdgeL's 2 x 4 warps of
// 3 x 4 fragments (96 rows).  The forward takes SmallL's 2 x 4 warps of
// 2 x 4 fragments (64 rows) for chains of fewer than SMALL_BELOW rows (the
// coarse levels) and for outputs wider than 128: the products are bound
// by the rate of mma.sync on each SM, and a short chain's 96-row tiles
// load its SMs unevenly (14,336 rows: 150 tiles on 132 SMs, 18 of them
// with two); at most two blocks fit an SM, so 64 rows keep such a chain in
// one wave with less work on the busiest SM.  A row's outputs do not
// depend on the tile shape (the same products in the same order).  The
// backward keeps 96 rows at every size: its per-tile column sums (the
// bias and LayerNorm gradients) do depend on it, and 64-row tiles were
// faster at one measured shape and slower at another (PERF.md).
// Weights stream through the two-stage cp.async ring with L2 evict_last; x
// streams in with evict_first and the output goes out with streaming
// stores.  These are the f32 chain's tiles; the bf16 policy's chains have
// tiles of their own (mlp_tile_bf16.cuh: bf16 in shared memory, wgmma),
// which share MlpArgs.
#pragma once

#include "gn_tile.cuh"

namespace g4c {
namespace mlp {

using namespace gn;

using SmallL = Layout<2, 2, 4, 4>;
constexpr int64_t SMALL_BELOW = 32768;  // forward rows on SmallL tiles

template <class L>
__host__ __device__ constexpr int rows_of() {
  return L::WM * L::MT * 16;
}
constexpr int ROWS = rows_of<EdgeL>();         // 96
constexpr int SMALL_ROWS = rows_of<SmallL>();  // 64
constexpr int COLS = EdgeL::WN * EdgeL::NT * 8;  // columns of a product pass
static_assert(SmallL::WN * SmallL::NT * 8 == COLS, "one pass width");

// Whether the forward of a chain of `rows` rows runs on SmallL tiles
// (`wide`: an output is wider than one pass).
__host__ __device__ inline bool small_tiles(int64_t rows, bool wide) {
  return wide || rows < SMALL_BELOW;
}

// T: the type of x, the output, g, dx and the cotangent operands d_op; the
// weights, the operands xo and the column sums are f32.
template <class T>
struct MlpArgs {
  const T* x;  // [rows, dims[0]]
  int64_t rows;
  int n;  // layers
  const float* w[MAX_LAYERS];
  const float* b[MAX_LAYERS];
  int dims[MAX_LAYERS + 1];
  const float* ln_scale;  // null: no LayerNorm
  const float* ln_bias;
  int preact;  // x is the pre-activation of a first layer: SELU it
  int ld;      // row stride of the tiles (4 mod 8)
  // forward output [rows, dims[n]]
  T* out;
  // backward: the output cotangent g and, if not null, dx
  const T* g;
  T* dx;
  // the weight-gradient operands the tile kernel writes: xo[l] the input of
  // layer l after SELU (l >= 1; l = 0 only with preact), d_op[l] the
  // cotangent of layer l's output (null for the last layer without a
  // LayerNorm: that is g itself)
  float* xo[MAX_LAYERS];
  T* d_op[MAX_LAYERS];
  // per-tile column sums (bias and LayerNorm gradients), [tiles][pc]
  float* colsum;
  int pc;
  int cs_b[MAX_LAYERS], cs_ln;
  // the bf16 backward's weights as 128 x 128 bf16 slices in the tile's
  // swizzled layout (mlp_chain_bwd_bf16.cu)
  uint8_t* wimg;
};

// The widest width of the chain, or 0 if the widths are not taken: 1-8
// layers, every width at least 1, every output width at most max_out.
static int mlp_wmax(int n, const int* dims, int max_out) {
  if (n < 1 || n > MAX_LAYERS) return 0;
  int wmax = 0;
  for (int l = 0; l <= n; ++l) {
    if (dims[l] < 1 || (l > 0 && dims[l] > max_out)) return 0;
    wmax = dims[l] > wmax ? dims[l] : wmax;
  }
  return wmax;
}

// Shared-memory floats of `tiles` activation tiles of `rows` rows and the
// ring.
static size_t mlp_smem_floats(int wmax, int tiles, int rows) {
  return (size_t)tiles * rows * (round8(wmax) + 4) + 2 * (size_t)tc::STAGE;
}

// out[row0 + r, :N] = LayerNorm(T[r, :N]) for r < valid, N <= 256 (a lane
// holds columns 128 h + row_col(i), h = 0, 1); streaming stores.
__device__ __forceinline__ void ln_rows_out(const float* T, int ld, int valid,
                                            int N, const float* scale,
                                            const float* bias,
                                            float* __restrict__ out,
                                            int64_t row0) {
  const float inv_n = 1.f / (float)N;
  float sc[2][4], bi[2][4];  // the same columns in every row
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    load_row(sc[h], scale + COLS * h, N - COLS * h);
    load_row(bi[h], bias + COLS * h, N - COLS * h);
  }
  for (int r = threadIdx.x >> 5; r < valid; r += tc::WARPS) {
    float x[2][4], s = 0.f, q = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      load_row(x[h], T + r * ld + COLS * h, N - COLS * h);
#pragma unroll
      for (int i = 0; i < 4; ++i) s += x[h][i];
    }
    const float mean = warp_sum(s) * inv_n;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (COLS * h + row_col(i) < N) {
          const float d = x[h][i] - mean;
          q += d * d;
        }
    const float rstd = rsqrtf(warp_sum(q) * inv_n + LN_EPS);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (COLS * h >= N) break;
      float y[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        y[i] = (x[h][i] - mean) * rstd * sc[h][i] + bi[h][i];
      store_row(out + (row0 + r) * N + COLS * h, y, N - COLS * h, true);
    }
  }
}

// The forward of the tile of rows [row0, row0 + valid) on tiles of layout
// L.  T0 holds the input tile, then each layer's output in turn (in place
// when T1 is null; with T1, for outputs wider than 128, the layers
// alternate between the two).  BWD = false writes out; BWD = true writes
// the operands xo and, with a LayerNorm, leaves the last layer's pre-LN
// output in the returned tile (without one the backward needs no output
// of the last layer, which is then not recomputed).  Ends with a barrier
// if BWD.
template <class L, bool BWD>
__device__ __forceinline__ float* chain_forward(const MlpArgs<float>& a,
                                                float* T0,
                                                float* T1, float* ring,
                                                int64_t row0, int valid) {
  const int mt = (valid + 15) / 16, ld = a.ld, K0 = a.dims[0];
  tc::load_rows(T0, ld, a.x, row0, valid, mt * 16, K0, K0,
                tc::stream_policy());
  tc::cp_commit();
  if (a.preact) {
    tc::cp_wait<0>();
    __syncthreads();
    for (int r = threadIdx.x >> 5; r < mt * 16; r += tc::WARPS)
      for (int c = threadIdx.x & 31; c < K0; c += 32)
        T0[r * ld + c] = selu(T0[r * ld + c]);
    if (BWD) copy_rows(T0, ld, valid, K0, a.xo[0], row0, nullptr, nullptr,
                       false);
  }
  float* cur = T0;
  for (int l = 0; l < a.n; ++l) {
    const int K = a.dims[l], N = a.dims[l + 1];
    const bool last = l == a.n - 1;
    if (BWD && last && a.ln_scale == nullptr) break;
    float* dst = T1 == nullptr ? cur : (cur == T0 ? T1 : T0);
    for (int c0 = 0; c0 < N; c0 += COLS) {
      const int cw = min(COLS, N - c0);
      Acc<L> acc;
      tc::zero(acc);
      // the product ends with a barrier: dst may be cur
      tc::mm<L::WM, L::MT, L::WN, L::NT>(
          acc, cur, ld, mt, a.w[l] + c0, K, cw, ring, N);
      add_bias<L>(acc, cw, a.b[l] + c0);
      if (!last) {
        apply_selu<L>(acc);
        store_tile<L>(acc, dst + c0, ld, cw, mt);
      } else if (BWD || a.ln_scale != nullptr) {
        store_tile<L>(acc, dst + c0, ld, cw, mt);
      } else {
        store_out<L>(acc, a.out + c0, row0, valid, cw, N);
      }
    }
    if (BWD && !last)
      copy_rows(dst, ld, valid, N, a.xo[l + 1], row0, nullptr, nullptr,
                false);
    cur = dst;
  }
  if (BWD || a.ln_scale != nullptr) __syncthreads();
  if (!BWD && a.ln_scale != nullptr)
    ln_rows_out(cur, ld, valid, a.dims[a.n], a.ln_scale, a.ln_bias, a.out,
                row0);
  return cur;
}

}  // namespace mlp
}  // namespace g4c
