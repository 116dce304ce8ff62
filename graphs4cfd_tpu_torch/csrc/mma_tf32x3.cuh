// f32 matrix products on Hopper's tensor cores by the error-compensated
// TF32 split ("3xTF32", CUTLASS's OpMultiplyAddFastF32): every product of
// the GN-block kernels (gn_block.cu, gn_block_bwd.cu), the MLP-chain
// kernels (mlp_chain.cu, mlp_chain_bwd.cu) and the weight gradients they
// share (wgrad.cu).
//
// Each f32 operand x is split as x = hi + lo: hi is x with the 13 low
// mantissa bits cleared (a TF32 value, exact), lo = tf32(x - hi) rounded to
// nearest, ties away (cvt.rna), so hi + lo keeps 21 of x's 24 bits.  A
// product is lo_a*hi_b + hi_a*lo_b + hi_a*hi_b with warp-level
// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32; the dropped lo*lo
// term is below f32's own rounding.  The tensor cores add into their
// accumulator with truncation, not rounding, so over a long reduction
// (2048 rows in the weight gradients) the error grows with the length, one
// way: each step of 8 is therefore accumulated into a zeroed fragment and
// added to the f32 sums with an IEEE add.  So the products hold the
// kernels to their f32 gates (1e-4, 2e-4), which one TF32 product (1e-3
// relative) would not.  (Adding into the fragment itself instead, in the
// MLP chains' tile products, saved no time on the H100: the three
// mma.sync of a step, not the adds, bound the products.)
//
// Why mma.sync and not wgmma: wgmma takes 64-row tiles per warpgroup, and
// the node side of a GN tile has 16 receivers.  A 64-receiver node tile
// would need 64*k = 384 edge rows of f32 activations (203 KB at k=6), which
// do not fit beside the rest of the tile in 227 KB.  bf16 tiles, half the
// size, do: the bf16 policy's GN kernels run on wgmma (gn_tile_bf16.cuh).
//
// Layout: a block of 8 warps; each warp owns MT x NT fragments of 16 x 8
// outputs (rows mt*16 + g, + 8; columns nt*8 + 2t, + 1 for lane = 4g + t).
// Operands come from shared memory with row strides padded so that the
// fragment loads of a warp hit 32 different banks: a row-major A operand
// (row index m, reduction index k) has a stride of 4 mod 8 floats, a
// row-major B operand (reduction index k, column n) 8 mod 16.  Weight
// slices of BK reduction rows stream through a two-stage ring with cp.async
// (the next slice loads while the tensor cores work on this one); Hopper's
// TMA cannot gather rows by index, so the GN kernels load their sender rows
// with 16-byte cp.async too.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace g4c {
namespace tc {

constexpr int THREADS = 256;  // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int BK = 32;        // reduction rows per weight slice
// floats of one ring stage: a slice [BK][round16(N) + 8] (N <= 128) or a
// transposed slice [round8(Kc)][BK + 4] (Kc <= 128)
constexpr int STAGE = 128 * (BK + 4);

__host__ __device__ constexpr int round8(int x) { return (x + 7) & ~7; }
__host__ __device__ constexpr int round16(int x) { return (x + 15) & ~15; }

// ---- PTX primitives -------------------------------------------------------

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// NaN and infinity stay what they are in hi (and make lo NaN).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = to_tf32(x - __uint_as_float(hi));
}

// d += a * b for one 16 x 8 x 8 fragment, TF32 inputs, f32 accumulation.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// L2 policies: evict_last for what many tiles read again (weights, the
// gathered table), evict_first for what one tile streams once.
__device__ __forceinline__ uint64_t keep_policy() {
  uint64_t p;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}
__device__ __forceinline__ uint64_t stream_policy() {
  uint64_t p;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}

// 16 (or, with bytes 0, zero) bytes from global to shared memory, async,
// with an L2 policy.
__device__ __forceinline__ void cp16(float* dst, const float* src, int bytes,
                                     uint64_t policy) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile(
      "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2, %3;\n" ::
          "r"(s),
      "l"(src), "r"(bytes), "l"(policy)
      : "memory");
}

// 4 (or, with bytes 0, zero) bytes, async.
__device__ __forceinline__ void cp4(float* dst, const float* src, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- the warp's product ---------------------------------------------------

template <int MT, int NT>
__device__ __forceinline__ void zero(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
}

// acc += A @ B over `ksteps` (at most BK / 8) steps of 8, 3xTF32, each
// step's three products summed in a zeroed fragment, then added.  A(m, k) =
// A[m*am + k*ak] and B(k, n) = B[k*bk + n*bn] in shared memory, offset to
// the warp's first row and column; fragments i >= mtv or j >= ntv are
// skipped (warp-uniform).
template <int MT, int NT>
__device__ __forceinline__ void warp_mma(float (&acc)[MT][NT][4],
                                         const float* A, int am, int ak,
                                         const float* B, int bk, int bn,
                                         int ksteps, int mtv, int ntv) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* a0 = A + g * am + t * ak;
  const float* b0 = B + t * bk + g * bn;
#pragma unroll
  for (int s = 0; s < BK / 8; ++s) {
    if (s >= ksteps) break;
    uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float* bp = b0 + s * 8 * bk + j * 8 * bn;
      if (j < ntv) {
        split(bp[0], bh[j][0], bl[j][0]);
        split(bp[4 * bk], bh[j][1], bl[j][1]);
      } else {
        bh[j][0] = bh[j][1] = bl[j][0] = bl[j][1] = 0u;
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      if (i >= mtv) continue;
      const float* ap = a0 + i * 16 * am + s * 8 * ak;
      uint32_t ah[4], al[4];
      split(ap[0], ah[0], al[0]);
      split(ap[8 * am], ah[1], al[1]);
      split(ap[4 * ak], ah[2], al[2]);
      split(ap[8 * am + 4 * ak], ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (j >= ntv) continue;
        float t[4] = {0.f, 0.f, 0.f, 0.f};
        mma(t, al, bh[j][0], bh[j][1]);
        mma(t, ah, bl[j][0], bl[j][1]);
        mma(t, ah, bh[j][0], bh[j][1]);
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] += t[q];
      }
    }
  }
}

// The f32 product core: mm and mm_t run their warps' products through
// Core::run.
struct Tf32x3 {
  template <int MT, int NT>
  __device__ static __forceinline__ void run(float (&acc)[MT][NT][4],
                                             const float* A, int am, int ak,
                                             const float* B, int bk, int bn,
                                             int ksteps, int mtv, int ntv) {
    warp_mma<MT, NT>(acc, A, am, ak, B, bk, bn, ksteps, mtv, ntv);
  }
};

// Row and column of fragment element q (0..3) of fragment (i, j), relative
// to the warp's first row and column.
__device__ __forceinline__ int frag_row(int i, int q) {
  return i * 16 + ((threadIdx.x & 31) >> 2) + (q >= 2 ? 8 : 0);
}
__device__ __forceinline__ int frag_col(int j, int q) {
  return j * 8 + (threadIdx.x & 3) * 2 + (q & 1);
}

// ---- copies ---------------------------------------------------------------

__device__ __forceinline__ bool aligned16(const void* p) {
  return ((uintptr_t)p & 15u) == 0;
}

// dst[r, c] = src[row0 + r, c] (row stride lds floats) for r < valid and
// c < F, zero for valid <= r < rows or F <= c < round8(F).  Async, with
// the L2 policy `policy` where the rows are whole 16-byte units.
__device__ __forceinline__ void load_rows(float* dst, int ld,
                                          const float* __restrict__ src,
                                          int64_t row0, int valid, int rows,
                                          int F, int64_t lds,
                                          uint64_t policy) {
  const int F8 = round8(F);
  if ((F & 3) == 0 && (lds & 3) == 0 && aligned16(src)) {
    const int cpr = F8 / 4;
    if (THREADS % cpr == 0) {  // each thread keeps its column
      const int c = (threadIdx.x % cpr) * 4, step = THREADS / cpr;
      for (int r = threadIdx.x / cpr; r < rows; r += step) {
        const bool ok = r < valid && c < F;
        cp16(dst + r * ld + c, ok ? src + (row0 + r) * lds + c : src,
             ok ? 16 : 0, policy);
      }
      return;
    }
    for (int idx = threadIdx.x; idx < rows * cpr; idx += THREADS) {
      const int r = idx / cpr, c = (idx - r * cpr) * 4;
      const bool ok = r < valid && c < F;
      cp16(dst + r * ld + c, ok ? src + (row0 + r) * lds + c : src,
           ok ? 16 : 0, policy);
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * F8; idx += THREADS) {
      const int r = idx / F8, c = idx - r * F8;
      const bool ok = r < valid && c < F;
      cp4(dst + r * ld + c, ok ? src + (row0 + r) * lds + c : src,
          ok ? 4 : 0);
    }
  }
}

// A weight slice: dst[r, c] = W[k0 + r, c] (W row-major with row stride
// ldg) for r < rows, zero past K or N (up to round8(N)).  Async.
__device__ __forceinline__ void load_w(float* dst, int ld,
                                       const float* __restrict__ W, int K,
                                       int N, int k0, int rows, int ldg) {
  load_rows(dst, ld, W, k0, K - k0, rows, N, ldg, keep_policy());
}

// A transposed weight slice: dst[c, j] = W[c, n0 + j] (W rows c with
// stride N) for c < round8(Kc), j < BK, zero past Kc or N.  Async.
__device__ __forceinline__ void load_wt(float* dst,
                                        const float* __restrict__ W, int Kc,
                                        int N, int n0) {
  constexpr int ld = BK + 4;
  const int rows = round8(Kc);
  if ((N & 3) == 0 && aligned16(W)) {
    constexpr int cpr = BK / 4;
    const int j = (threadIdx.x % cpr) * 4;
    for (int c = threadIdx.x / cpr; c < rows; c += THREADS / cpr) {
      const bool ok = c < Kc && n0 + j < N;
      cp16(dst + c * ld + j, ok ? W + (size_t)c * N + n0 + j : W,
           ok ? 16 : 0, keep_policy());
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * BK; idx += THREADS) {
      const int c = idx / BK, j = idx - c * BK;
      const bool ok = c < Kc && n0 + j < N;
      cp4(dst + c * ld + j, ok ? W + (size_t)c * N + n0 + j : W,
          ok ? 4 : 0);
    }
  }
}

// ---- block products through the ring ---------------------------------------
//
// A block of 8 warps as WM x WN warps, each owning MT x NT fragments.  The
// A operand is a shared-memory tile with `mtiles` valid 16-row tiles.  The
// caller's writes to A are made visible by the first barrier inside; the
// product ends with a barrier, so the caller may then overwrite A or the
// ring.  Every cp.async group is complete on return.

// acc += A[:, 0:K] @ W[0:K, 0:N], W row-major [K][N] in device memory
// (row stride ldg, N if 0: a column slice of a wider weight).
template <int WM, int MT, int WN, int NT, class Core = Tf32x3>
__device__ __forceinline__ void mm(float (&acc)[MT][NT][4], const float* A,
                                   int lda, int mtiles,
                                   const float* __restrict__ W, int K, int N,
                                   float* ring, int ldg = 0) {
  const int warp = threadIdx.x >> 5, wm = warp / WN, wn = warp % WN;
  const int mtv = min(max(mtiles - wm * MT, 0), MT);
  const int ntv = min(max(round8(N) / 8 - wn * NT, 0), NT);
  const int K8 = round8(K), ldw = round16(N) + 8;
  const int ns = (K8 + BK - 1) / BK;
  if (ldg == 0) ldg = N;
  load_w(ring, ldw, W, K, N, 0, min(BK, K8), ldg);
  cp_commit();
  for (int s = 0; s < ns; ++s) {
    cp_wait<0>();
    __syncthreads();  // slice s landed; every warp is done with slice s - 1
    if (s + 1 < ns) {
      const int k1 = (s + 1) * BK;
      load_w(ring + ((s + 1) & 1) * STAGE, ldw, W, K, N, k1,
             min(BK, K8 - k1), ldg);
      cp_commit();
    }
    const int kc = min(BK, K8 - s * BK);
    Core::template run<MT, NT>(acc, A + wm * MT * 16 * lda + s * BK, lda, 1,
                               ring + (s & 1) * STAGE + wn * NT * 8, ldw, 1,
                               kc / 8, mtv, ntv);
  }
  __syncthreads();
}

// acc[:, 0:Kc] += A[:, 0:N] @ W[0:Kc, 0:N]^T, W's rows with stride N (a
// weight [K][N] read transposed from the row the caller offsets it to).
template <int WM, int MT, int WN, int NT, class Core = Tf32x3>
__device__ __forceinline__ void mm_t(float (&acc)[MT][NT][4], const float* A,
                                     int lda, int mtiles,
                                     const float* __restrict__ W, int Kc,
                                     int N, float* ring) {
  constexpr int ldt = BK + 4;
  const int warp = threadIdx.x >> 5, wm = warp / WN, wn = warp % WN;
  const int mtv = min(max(mtiles - wm * MT, 0), MT);
  const int ntv = min(max(round8(Kc) / 8 - wn * NT, 0), NT);
  const int N8 = round8(N);
  const int ns = (N8 + BK - 1) / BK;
  load_wt(ring, W, Kc, N, 0);
  cp_commit();
  for (int s = 0; s < ns; ++s) {
    cp_wait<0>();
    __syncthreads();  // slice s landed; every warp is done with slice s - 1
    if (s + 1 < ns) {
      load_wt(ring + ((s + 1) & 1) * STAGE, W, Kc, N, (s + 1) * BK);
      cp_commit();
    }
    const int nc = min(BK, N8 - s * BK);
    Core::template run<MT, NT>(acc, A + wm * MT * 16 * lda + s * BK, lda, 1,
                               ring + (s & 1) * STAGE + wn * NT * 8 * ldt, 1,
                               ldt, nc / 8, mtv, ntv);
  }
  __syncthreads();
}

}  // namespace tc
}  // namespace g4c
