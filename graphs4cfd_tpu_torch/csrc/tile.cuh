// Block-level building blocks of the MLP-chain kernels, and the constants
// and activations the GN-block kernels share with them.
//
// A thread block of 16 x 16 threads owns a tile of rows.  Its activation
// tile lives in shared memory (row stride `ld` floats); each product
// act[rows, K] @ W[K, N] keeps its outputs in registers, thread (ty, tx)
// holding rows ty*TM .. ty*TM+TM-1 and columns tx, tx+16, ..., tx+16*(NT-1).
// The weight matrix (row-major [K][N], as the JAX package stores it) is
// streamed through shared memory in slices of BK rows.  Everything is f32
// on the CUDA cores: one TF32 product would not hold the port to its f32
// reference at 1e-4.  (The GN-block kernels run theirs on the tensor cores
// as 3xTF32, which does: mma_tf32x3.cuh.)
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace g4c {

constexpr int TX = 16;
constexpr int TY = 16;
constexpr int NTHREADS = TX * TY;
constexpr int BK = 32;
constexpr int MAX_LAYERS = 8;
// Widest node input of the GN-block kernels (gMuS's v after an up step);
// every other width is at most 8 * TX = 128.
constexpr int MAX_FV = 256;
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

// out[row0 + r, c] = acc (optionally through SELU) for the valid rows and
// c < N; out is row-major with row stride ldo (N if ldo is 0), so a caller
// can write a column slice of a wider output by offsetting out.
template <int TM, int NT>
__device__ __forceinline__ void store_global(const float (&acc)[TM][NT],
                                             float* __restrict__ out,
                                             int64_t row0, int valid, int N,
                                             bool selu_out, int ldo = 0) {
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const size_t stride = ldo > 0 ? ldo : N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = ty * TM + i;
    if (r >= valid) continue;
    float* o = out + (size_t)(row0 + r) * stride;
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

// ---- building blocks of the backward kernels -----------------------------

// SELU's derivative from its output h = selu(a): a > 0 exactly when h > 0,
// and below 0 scale * alpha * exp(a) = h + scale * alpha.  So a backward
// that keeps the activations needs no pre-activations.
__device__ __forceinline__ float dselu_of_selu(float h) {
  return h > 0.f ? SELU_SCALE : h + SELU_SCALE * SELU_ALPHA;
}

// SELU's derivative at the pre-activation a.
__device__ __forceinline__ float dselu(float a) {
  return a > 0.f ? SELU_SCALE : SELU_SCALE * SELU_ALPHA * expf(a);
}

// acc[r, c] = src[row0 + r, c] for r < valid and c < N (src row-major with
// N columns), zero elsewhere: a cotangent tile in the products' layout.
template <int TM, int NT>
__device__ __forceinline__ void load_regs(float (&acc)[TM][NT],
                                          const float* __restrict__ src,
                                          int64_t row0, int valid, int N) {
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = ty * TM + i;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = tx + TX * j;
      acc[i][j] = (r < valid && c < N)
                      ? __ldg(src + (size_t)(row0 + r) * N + c) : 0.f;
    }
  }
}

// acc *= SELU'(a), with the activations h = selu(a) in shared memory.
template <int TM, int NT>
__device__ __forceinline__ void mul_dselu_of_selu(float (&acc)[TM][NT],
                                                  const float* H, int ld,
                                                  int N) {
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = tx + TX * j;
      if (c < N) acc[i][j] *= dselu_of_selu(H[(ty * TM + i) * ld + c]);
    }
}

// acc[rows, 0:Kc] += A[rows, 0:N] @ W[0:Kc, 0:N]^T, where W is row-major
// with row stride ldw (a weight [K, N] read transposed, from its row c0:
// the caller offsets W).  Slices of BK columns of W go through shared
// memory as [BK][Kc + 1] (the +1 keeps the transposing stores off one
// bank).  Starts with a barrier, as mm_acc does.
template <int TM, int NT>
__device__ __forceinline__ void mm_acc_wt(float (&acc)[TM][NT],
                                          const float* A, int lda, int N,
                                          const float* __restrict__ W,
                                          int ldw, int Kc, float* wtile) {
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int ldt = Kc + 1;
  for (int n0 = 0; n0 < N; n0 += BK) {
    const int nc = min(BK, N - n0);
    __syncthreads();
    for (int idx = threadIdx.x; idx < nc * Kc; idx += NTHREADS) {
      const int c = idx / nc, nn = idx - c * nc;
      wtile[nn * ldt + c] = __ldg(W + (size_t)c * ldw + n0 + nn);
    }
    __syncthreads();
#pragma unroll 4
    for (int nn = 0; nn < nc; ++nn) {
      float a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = A[(ty * TM + i) * lda + n0 + nn];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = tx + TX * j;
        const float w = c < Kc ? wtile[nn * ldt + c] : 0.f;
#pragma unroll
        for (int i = 0; i < TM; ++i) acc[i][j] = fmaf(a[i], w, acc[i][j]);
      }
    }
  }
}

// part[K, N] += A[0:rows, 0:K]^T @ D[0:rows, 0:N]: a weight gradient's
// share of one tile, added into the block's own partial in device memory
// (row-major, row stride N).  A and D are in shared memory; each partial
// element belongs to one thread, so the sums need no atomics and run in a
// fixed order.  Thread (ty, tx) owns rows ty*8 .. ty*8+7 of each 128-row
// slice of K and columns tx, tx+16, ...  The caller synchronises before
// (A and D written) and after (before either is overwritten).
template <int NT>
__device__ __forceinline__ void wgrad_rmw(const float* A, int lda, int K,
                                          const float* D, int ldd, int N,
                                          int rows, float* __restrict__ part) {
  constexpr int TK = 8;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  for (int k0 = 0; k0 < K; k0 += TY * TK) {
    float acc[TK][NT];
    zero(acc);
    const int kb = k0 + ty * TK;
    for (int r = 0; r < rows; ++r) {
      float a[TK], d[NT];
#pragma unroll
      for (int i = 0; i < TK; ++i)
        a[i] = kb + i < K ? A[r * lda + kb + i] : 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = tx + TX * j;
        d[j] = c < N ? D[r * ldd + c] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < TK; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) acc[i][j] = fmaf(a[i], d[j], acc[i][j]);
    }
    // all loads of a group before its stores, so that they are in flight
    // together (a load after a store to `part` would wait for it)
#pragma unroll
    for (int i0 = 0; i0 < TK; i0 += 4) {
      float old[4][NT];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int c = tx + TX * j;
          old[i][j] = (kb + i0 + i < K && c < N)
                          ? part[(size_t)(kb + i0 + i) * N + c] : 0.f;
        }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int c = tx + TX * j;
          if (kb + i0 + i < K && c < N)
            part[(size_t)(kb + i0 + i) * N + c] = old[i][j] + acc[i0 + i][j];
        }
    }
  }
}

// part[c] += sum over r < rows of S[r, c], for c < N (a bias or LayerNorm
// gradient's share of one tile); one thread per column, rows in order.
__device__ __forceinline__ void colsum_rmw(const float* S, int ld, int rows,
                                           int N, float* __restrict__ part) {
  for (int c = threadIdx.x; c < N; c += NTHREADS) {
    float s = 0.f;
    for (int r = 0; r < rows; ++r) s += S[r * ld + c];
    part[c] += s;
  }
}

// Per-row mean and 1/std of the N valid columns (LayerNorm statistics,
// biased variance, eps 1e-5, two passes in f32).
template <int TM, int NT>
__device__ __forceinline__ void row_stats(const float (&x)[TM][NT], int N,
                                          float (&mean)[TM],
                                          float (&rstd)[TM]) {
  const int tx = threadIdx.x % TX;
  const float inv_n = 1.f / (float)N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j)
      if (tx + TX * j < N) s += x[i][j];
    mean[i] = row_sum(s) * inv_n;
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j)
      if (tx + TX * j < N) {
        const float d = x[i][j] - mean[i];
        q += d * d;
      }
    rstd[i] = rsqrtf(row_sum(q) * inv_n + LN_EPS);
  }
}

// LayerNorm backward: g (cotangent of the LN output) becomes the cotangent
// of its input x (pre-LN, in registers).  The scale and bias gradients of
// the tile's rows are added into part_scale / part_bias through the
// shared-memory scratch S (rows x ld, overwritten).  Rows with g = 0
// contribute nothing.
template <int TM, int NT>
__device__ __forceinline__ void ln_backward(float (&g)[TM][NT],
                                            const float (&x)[TM][NT], int N,
                                            const float* __restrict__ scale,
                                            float* S, int ld, int rows,
                                            float* part_scale,
                                            float* part_bias) {
  const int tx = threadIdx.x % TX;
  float mean[TM], rstd[TM];
  row_stats(x, N, mean, rstd);
  __syncthreads();
  float xh[TM][NT];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      xh[i][j] = (x[i][j] - mean[i]) * rstd[i];
      xh[i][j] *= g[i][j];
    }
  store_smem(xh, S, ld, N);
  __syncthreads();
  colsum_rmw(S, ld, rows, N, part_scale);
  __syncthreads();
  store_smem(g, S, ld, N);
  __syncthreads();
  colsum_rmw(S, ld, rows, N, part_bias);
  __syncthreads();
  const float inv_n = 1.f / (float)N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = tx + TX * j;
      if (c < N) {
        const float dxh = g[i][j] * __ldg(scale + c);
        s1 += dxh;
        s2 += dxh * (x[i][j] - mean[i]) * rstd[i];
      }
    }
    const float m1 = row_sum(s1) * inv_n, m2 = row_sum(s2) * inv_n;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = tx + TX * j;
      const float xhat = (x[i][j] - mean[i]) * rstd[i];
      g[i][j] = c < N ? (g[i][j] * __ldg(scale + c) - m1 - xhat * m2) *
                            rstd[i]
                      : 0.f;
    }
  }
}

// out[p] = sum over b < G of work[b * P + p], b in order: the blocks'
// partial weight gradients, summed the same way on every run.
static __global__ void __launch_bounds__(NTHREADS)
    reduce_partials(const float* __restrict__ work, int G, int64_t P,
                    float* __restrict__ out) {
  const int64_t p = (int64_t)blockIdx.x * NTHREADS + threadIdx.x;
  if (p >= P) return;
  float s = 0.f;
  for (int b = 0; b < G; ++b) s += work[(size_t)b * P + p];
  out[p] = s;
}

static cudaError_t launch_reduce(const float* work, int G, int64_t P,
                                 float* out, cudaStream_t stream) {
  const unsigned grid = (unsigned)((P + NTHREADS - 1) / NTHREADS);
  reduce_partials<<<grid, NTHREADS, 0, stream>>>(work, G, P, out);
  return cudaGetLastError();
}

// Blocks of `kernel` (NTHREADS threads, `smem` bytes) that run at once on
// the card, or 0 on error: the persistent backward grids have this many.
template <typename K>
static int resident_blocks(K kernel, size_t smem) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    NTHREADS, smem) !=
          cudaSuccess)
    return 0;
  return sms * per_sm;
}

}  // namespace g4c
