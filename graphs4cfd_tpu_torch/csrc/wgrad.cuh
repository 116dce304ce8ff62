// The weight gradients and the fixed-order reduction of the backward
// kernels, shared by gn_block_bwd.cu and mlp_chain_bwd.cu (the kernels and
// their launchers are defined once, in wgrad.cu).
//
// A backward's tile kernel writes, once, the per-row operands of every
// weight gradient dW = X^T D and, per tile, one row of column sums (the
// bias and LayerNorm gradients).  Then:
//   gn_wgrad_kernel: every dW as a split over fixed chunks of rows
//     (wgrad_chunk: 2048, fewer for a product of few rows); a block owns
//     (product, chunk, 128-row slice of K), keeps its 128 x N sums in
//     registers over the chunk (3xTF32 on the tensor cores, X and D
//     through a three-stage cp.async ring) and writes its partial once
//     (wgrad_bf16_kernel does the same for a bf16 plan, wgrad_bf16.cu);
//   gn_reduce_kernel: the chunk partials and the tiles' column sums, each
//     segment summed in a fixed order (warp w sums partials w, w + 8, ...
//     in order, then the 8 warps' sums are added in order).
// No float atomics: two launches give the same bits.  SplitPlan lays the
// operands, partials and column sums out in one work buffer and lists the
// products and segments.
//
// Under the bf16 policy (SplitPlan::bf16) the products run on
// wgrad_bf16.cu's kernel (wgmma over bf16 tiles): both operands rounded to
// bf16, as the JAX package's backward kernels compute dW =
// dot(x.astype(bf16).T, d.astype(bf16), preferred_element_type=f32).  X may
// then be a bf16 row (the activations, read at half the bytes) or an f32
// one (the layer inputs the tile kernels also read back for SELU', which
// must not be rounded there); each product says which.  D is bf16.  The
// partials and the reduction stay f32, so the parameter gradients are f32
// and deterministic.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "tile.cuh"

namespace g4c {

constexpr int WG_CHUNK = 2048;      // rows of one weight-gradient partial
constexpr int WG_MIN_CHUNK = 256;   // ... at the least
constexpr int WG_MIN_CHUNKS = 64;   // partials a product is split into
constexpr int MAX_PRODS = 2 * MAX_LAYERS + 2;
constexpr int MAX_SEGS = MAX_PRODS + 2 * MAX_LAYERS + 4;

struct WgProd {
  const void* x;   // [rows, K], bf16 if xb else f32
  const void* d;   // [rows, N], N <= 128, bf16 if db else f32
  int xb, db;
  float* part;     // [chunks][K][N]
  int64_t rows;
  int chunk;       // rows of a partial
  int K, N;
  int first;  // first block of this product
  int kt;     // 128-row slices of K
};

struct WgArgs {
  WgProd p[MAX_PRODS];
  int np;
};

struct RedSeg {
  const float* src;  // G partials of `len` floats, `stride` apart
  float* dst;
  int64_t stride;
  int G, len;
};

struct RedArgs {
  RedSeg s[MAX_SEGS];
  int ns;
};

// Rows of each partial of a product over `rows` rows: WG_CHUNK, halved
// (down to WG_MIN_CHUNK) while the product would have fewer than
// WG_MIN_CHUNKS partials, so that a product of few rows (the coarse
// levels' chains) still spreads over the card.  A function of the row
// count alone: the order of the sums is fixed for a shape.
inline int wgrad_chunk(int64_t rows) {
  int c = WG_CHUNK;
  while (c > WG_MIN_CHUNK && (rows + c - 1) / c < WG_MIN_CHUNKS) c /= 2;
  return c;
}

// The products and reductions of one backward launch, and its work buffer.
// With work null only the sizes are computed (`used`: floats of the work
// buffer).
struct SplitPlan {
  WgArgs wg;
  RedArgs red;
  int wg_blocks = 0;
  int red_x = 0;  // blocks along a segment (the longest one)
  float* work;
  size_t used = 0;
  bool bf16;  // the products on the bf16 core

  explicit SplitPlan(float* work_, bool bf16_ = false)
      : work(work_), bf16(bf16_) {
    wg.np = 0;
    red.ns = 0;
  }

  // n floats of the work buffer (null when only sizing)
  float* take(size_t n) {
    float* q = work != nullptr ? work + used : nullptr;
    used += (n + 63) & ~(size_t)63;
    return q;
  }

  // n values of type T (float or bf16) of the work buffer
  template <class T>
  T* take_as(size_t n) {
    return reinterpret_cast<T*>(take((n * sizeof(T) + 3) / 4));
  }

  // dst[p] = the sum of G partials src[g * stride + p], p < len
  void seg(const float* src, float* dst, int64_t stride, int G, int len) {
    red.s[red.ns++] = RedSeg{src, dst, stride, G, len};
    const int bx = (len + 31) / 32;
    red_x = bx > red_x ? bx : red_x;
  }

  // dst [K][N] = x^T d over `rows` rows, through chunk partials; x and d
  // are f32 or bf16 rows
  template <class X, class D>
  void prod(const X* x, const D* d, int64_t rows, int K, int N, float* dst) {
    const int chunk = wgrad_chunk(rows);
    const int chunks = (int)((rows + chunk - 1) / chunk);
    const int kt = (K + 127) / 128;
    float* part = take((size_t)chunks * K * N);
    wg.p[wg.np++] = WgProd{x,
                           d,
                           std::is_same<X, __nv_bfloat16>::value,
                           std::is_same<D, __nv_bfloat16>::value,
                           part,
                           rows,
                           chunk,
                           K,
                           N,
                           wg_blocks,
                           kt};
    wg_blocks += chunks * kt;
    seg(part, dst, (int64_t)K * N, chunks, K * N);
  }
};

// The weight-gradient kernel over the plan's products, then the reduction
// over its segments; each returns its launch's error.
cudaError_t launch_wgrad(const SplitPlan& p, cudaStream_t s);
cudaError_t launch_reduce(const SplitPlan& p, cudaStream_t s);
// The bf16 plan's weight-gradient kernel (wgrad_bf16.cu): every D bf16 and
// N at most 128, else cudaErrorInvalidValue.
cudaError_t launch_wgrad_bf16(const SplitPlan& p, cudaStream_t s);

}  // namespace g4c
