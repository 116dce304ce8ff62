// Block-level building blocks shared by the MLP-chain and GN-block kernels.
//
// A thread block of 16 x 16 threads owns a tile of rows.  Its activation
// tile lives in shared memory (row stride `ld` floats); each product
// act[rows, K] @ W[K, N] keeps its outputs in registers, thread (ty, tx)
// holding rows ty*TM .. ty*TM+TM-1 and columns tx, tx+16, ..., tx+16*(NT-1).
// The weight matrix (row-major [K][N], as the JAX package stores it) is
// streamed through shared memory in slices of BK rows.  Everything is f32
// on the CUDA cores: the tensor cores' TF32 would not hold the port to its
// f32 reference at 1e-4.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace g4c {

constexpr int TX = 16;
constexpr int TY = 16;
constexpr int NTHREADS = TX * TY;
constexpr int BK = 32;
constexpr int MAX_LAYERS = 8;
constexpr float SELU_ALPHA = 1.6732632423543772848170429916717f;
constexpr float SELU_SCALE = 1.0507009873554804934193349852946f;
constexpr float LN_EPS = 1e-5f;

__device__ __forceinline__ float selu(float a) {
  return SELU_SCALE * (a > 0.f ? a : SELU_ALPHA * expm1f(a));
}

template <int TM, int NT>
__device__ __forceinline__ void zero(float (&acc)[TM][NT]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[i][j] = 0.f;
}

// acc += A[rows, 0:K] @ W[0:K, 0:N].  A is in shared memory with TY*TM rows
// (rows past the valid ones hold zeros or values that are never stored).
// Starts with a barrier, so the caller's writes to A are visible and the
// previous product's reads of `wtile` are done.
template <int TM, int NT>
__device__ __forceinline__ void mm_acc(float (&acc)[TM][NT], const float* A,
                                       int lda, int K,
                                       const float* __restrict__ W, int N,
                                       float* wtile) {
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  for (int k0 = 0; k0 < K; k0 += BK) {
    const int kc = min(BK, K - k0);
    __syncthreads();
    const float* Ws = W + (size_t)k0 * N;
    for (int idx = threadIdx.x; idx < kc * N; idx += NTHREADS)
      wtile[idx] = __ldg(Ws + idx);
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kc; ++kk) {
      float a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = A[(ty * TM + i) * lda + k0 + kk];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = tx + TX * j;
        const float w = c < N ? wtile[kk * N + c] : 0.f;
#pragma unroll
        for (int i = 0; i < TM; ++i) acc[i][j] = fmaf(a[i], w, acc[i][j]);
      }
    }
  }
}

template <int TM, int NT>
__device__ __forceinline__ void add_bias(float (&acc)[TM][NT], int N,
                                         const float* __restrict__ b) {
  const int tx = threadIdx.x % TX;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int c = tx + TX * j;
    const float bj = c < N ? __ldg(b + c) : 0.f;
#pragma unroll
    for (int i = 0; i < TM; ++i) acc[i][j] += bj;
  }
}

template <int TM, int NT>
__device__ __forceinline__ void apply_selu(float (&acc)[TM][NT]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[i][j] = selu(acc[i][j]);
}

// Sum over the 16 threads of a row group (they share a half warp).
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = TX / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// LayerNorm over the N valid columns of each row: biased variance, two
// passes in f32, eps 1e-5.
template <int TM, int NT>
__device__ __forceinline__ void layer_norm(float (&acc)[TM][NT], int N,
                                           const float* __restrict__ scale,
                                           const float* __restrict__ bias) {
  const int tx = threadIdx.x % TX;
  const float inv_n = 1.f / (float)N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j)
      if (tx + TX * j < N) s += acc[i][j];
    const float mean = row_sum(s) * inv_n;
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j)
      if (tx + TX * j < N) {
        const float d = acc[i][j] - mean;
        q += d * d;
      }
    const float rstd = rsqrtf(row_sum(q) * inv_n + LN_EPS);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = tx + TX * j;
      if (c < N)
        acc[i][j] = (acc[i][j] - mean) * rstd * __ldg(scale + c) +
                    __ldg(bias + c);
    }
  }
}

template <int TM, int NT>
__device__ __forceinline__ void store_smem(const float (&acc)[TM][NT],
                                           float* out, int ld, int N) {
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = tx + TX * j;
      if (c < N) out[(ty * TM + i) * ld + c] = acc[i][j];
    }
}

// out[row0 + r, c] = acc (optionally through SELU) for the valid rows.
template <int TM, int NT>
__device__ __forceinline__ void store_global(const float (&acc)[TM][NT],
                                             float* __restrict__ out,
                                             int64_t row0, int valid, int N,
                                             bool selu_out) {
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = ty * TM + i;
    if (r >= valid) continue;
    float* o = out + (size_t)(row0 + r) * N;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = tx + TX * j;
      if (c < N) o[c] = selu_out ? selu(acc[i][j]) : acc[i][j];
    }
  }
}

// dst[r, c] = src[row0 + r, c] (optionally through SELU) for r < valid,
// zero for valid <= r < rows; src is row-major with F columns.
__device__ __forceinline__ void load_tile(const float* __restrict__ src,
                                          int64_t row0, int valid, int F,
                                          float* dst, int ld, int rows,
                                          bool selu_in) {
  for (int idx = threadIdx.x; idx < rows * F; idx += NTHREADS) {
    const int r = idx / F, c = idx - r * F;
    float x = 0.f;
    if (r < valid) {
      x = __ldg(src + (size_t)(row0 + r) * F + c);
      if (selu_in) x = selu(x);
    }
    dst[r * ld + c] = x;
  }
}

}  // namespace g4c
