// The GN-block tile of the bf16 policy (compute_dtype bfloat16), shared by
// gn_block_bf16.cu's two kernels: the forward, and the backward's tile
// kernel, which recomputes this forward and then runs both chains
// backwards on the same tile.  The f32 kernels keep their own tile
// (gn_tile.cuh, 3xTF32 mma.sync); this one is built for Hopper's
// warpgroup products.
//
// Geometry: a block is two warpgroups (256 threads) and owns `npb`
// receivers and their npb * k edge rows, padded to `er` rows, a multiple of
// 64: at most 64 receivers and 384 edge rows (64 x k=6, the MuS and gMuS
// levels; 64 x k=5 = 320 rows at REMuS's EdgeMP).  Larger k, or less
// shared memory (a 256-wide node input, a one-layer edge chain), takes
// fewer receivers (geometry()).  Every product is one
// wgmma.mma_async.m64nNk16 per 16 reduction rows on a 64-row tile:
//   - edge side: the m-tiles (64 edge rows each) go in turn to the two
//     warpgroups (m-tile 2p + warpgroup in phase p), N = 128 columns;
//   - node side: the 64 node rows are one m-tile (rows past npb are
//     zero), each warpgroup computing 64 of the 128 columns.
// The accumulators stay in registers: biases, SELU, the sender rows, the
// LayerNorms (an edge row lies in the four lanes of one quad; a node row
// in two warpgroups, whose halves meet in shared memory) and SELU' run on
// them in f32.
//
// Operands in shared memory are bf16, in wgmma's 128-byte swizzled layout:
// a tile of R rows is stored as 64-column blocks of R rows x 128 bytes;
// 16-byte chunk c of row r sits at chunk c ^ (r & 7) (toff()).  The A
// operand (edge rows, node rows, each layer's SELU output or cotangent) is
// K-major.  The weights are staged once per product as a [K][N] slice of
// up to 128 x 128 in the same layout, rounded to bf16 from the f32
// parameters as they are staged (the JAX kernels' w.astype(bf16) per
// call, with no launch of its own).  The forward reads the slice as an
// MN-major B operand (wgmma's transpose bit), the backward's dh = da W^T
// reads the same slice as a K-major one: no transposed copy.  A slice's
// loads leave before the barrier that frees the last one.  The rows of e
// and v stream into their tiles in 16-byte loads, bf16 in and bf16 in the
// tile, marked first out of L2 (so the gathered table and the weights stay
// there); the sender rows vs[senders[r]] come by index, by cp.async, into
// a 64 x 128 tile of each warpgroup's own (NA, and the v tile, which is
// loaded again after the first edge layer) while the first edge layer's
// products run (TMA cannot gather rows).  e' leaves through E after the
// edge chain, in 16-byte stores that drain during the node chain.
//
// Rounding follows pallas_gnblock.py:89-106 under compute_dtype bfloat16:
// each product's operands rounded to bf16 (nearest even), f32 sums; a
// layer's SELU output rounded once into the next product's tile; the mean
// over k of the f32 e_new (aggr), rounded once for aggr @ Wa.  The mean is
// summed in a fixed order with no atomics: a receiver's rows may straddle
// two m-tiles, so the adds run in k rounds per phase (round rho adds the
// rows whose index within their receiver is rho; one barrier a round), in
// each receiver's row order.  Two launches give the same bits.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "gn_tile.cuh"

namespace g4c {
namespace gn16 {

using gn::GnArgs;
using tc::bf16;

constexpr int THREADS = 256;      // two warpgroups
constexpr int NODE_ROWS = 64;     // node rows of a tile: one m64 product
constexpr int ER_MAX = 384;       // edge rows of a tile, at most
constexpr int LDN = 136;          // row stride (floats) of the f32 node tiles
constexpr int W_BYTES = 32768;    // a staged weight slice, 128 x 128 bf16
constexpr int VBLOCK_BYTES = 8192;  // 64 rows x 64 bf16 columns
constexpr int SCRATCH_BYTES = 4096 + 1024;  // column sums, row statistics
constexpr int SMEM_LIMIT = 232448;

// ---- geometry --------------------------------------------------------------

__host__ __device__ inline int round64(int x) { return (x + 63) / 64 * 64; }

// 64-column blocks of the v tile: round64(fv) / 64, at least 2 (it also
// takes a 64 x 128 tile of sender rows in the first edge layer).
__host__ __device__ inline int vblocks(int fv) {
  return round64(fv) / 64 > 2 ? round64(fv) / 64 : 2;
}

// Shared-memory bytes of a tile of npb receivers: the edge tile E
// [er x 128], the v tile [64 x 64 vblocks(fv)], the node tile NA [64 x
// 128] (bf16), the weight slice, the f32 node tile NF [npb][LDN] (vr, then
// aggr; the backward's daggr / k, then dvr), a second one for aggr when the
// edge chain has one layer (vr is still needed), the scratch, and 1 KB to
// align the swizzled tiles to 1024 bytes.
__host__ __device__ inline size_t smem_bytes(int npb, int k, int fv,
                                             int ne) {
  const size_t nf = (size_t)npb * LDN * 4;
  return 1024 + (size_t)round64(npb * k) * 256 +
         (size_t)vblocks(fv) * VBLOCK_BYTES + 2 * VBLOCK_BYTES + W_BYTES +
         nf * (ne == 1 ? 2 : 1) + SCRATCH_BYTES;
}

// Receivers per tile and padded edge rows: as many receivers as fit, at
// most 64 and at most ER_MAX / k.
__host__ __device__ inline void geometry(int k, int fv, int ne, int* npb,
                                         int* er) {
  int n = ER_MAX / k < NODE_ROWS ? ER_MAX / k : NODE_ROWS;
  while (n > 1 && smem_bytes(n, k, fv, ne) > SMEM_LIMIT) --n;
  *npb = n;
  *er = round64(n * k);
}

inline size_t smem_for(int k, int fv, int ne) {
  int npb, er;
  geometry(k, fv, ne, &npb, &er);
  return smem_bytes(npb, k, fv, ne);
}

// Byte offset of element (r, c) in a swizzled tile of R rows.
__host__ __device__ __forceinline__ uint32_t toff(int R, int r, int c) {
  return (uint32_t)((((c >> 6) * R + r) << 7) +
                    ((((c & 63) >> 3) ^ (r & 7)) << 4) + ((c & 7) << 1));
}

// ---- wgmma -----------------------------------------------------------------

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// A shared-memory matrix descriptor, 128-byte swizzle; lbo, sbo in bytes.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3ffff) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Shared-memory writes of this thread (st.shared, cp.async) made visible
// to the async proxy that wgmma reads through (then a barrier).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Keep the compiler from moving accumulator accesses across a wgmma.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A B for one m64 x n128 x k16 step; TB: B is MN-major (1) or
// K-major (0); TA: A likewise (1 only for the weight gradients' A = X^T,
// wgrad_bf16.cu).
template <int TB, int TA = 0>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %68, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB), "n"(TA));
}

// The same, m64 x n64 x k16.
template <int TB, int TA = 0>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %36, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB), "n"(TA));
}

// d (+)= A[mt] B over `ksteps` steps of 16 on this warpgroup: A the 64-row
// slice mt of a swizzled tile of R rows at shared address `a` (K-major),
// B the staged weight slice at `b`.  TB = 1: B[k][n] = slice[k][n] (the
// forward's x W; columns past 64 in the slice's second column block,
// `lbo` bytes on: half a 128-row slice, or ksteps * 2048 for an image of
// only the rows it needs); TB = 0: B[k][n] = slice[n][k] (the backward's
// da W^T).  Issued and committed; wg_wait() before reading d.  NJ: 16
// (n128) or 8 (n64).
template <int NJ, int TB>
__device__ __forceinline__ void wg_mm(float (&d)[4 * NJ], uint32_t a, int R,
                                      int mt, uint32_t b, int ksteps,
                                      bool accumulate,
                                      uint32_t lbo = W_BYTES / 2) {
  fence_regs(d);
  wg_fence();
  for (int s = 0; s < ksteps; ++s) {
    const uint64_t da =
        desc(a + (s >> 2) * R * 128 + mt * 8192 + (s & 3) * 32, 16, 1024);
    const uint64_t db =
        TB ? desc(b + s * 2048, lbo, 1024)
           : desc(b + (s >> 2) * (W_BYTES / 2) + (s & 3) * 32, 16, 1024);
    const int scale = accumulate || s > 0 ? 1 : 0;
    if constexpr (NJ == 16)
      wgmma_n128<TB>(d, da, db, scale);
    else
      wgmma_n64<TB>(d, da, db, scale);
  }
  wg_commit();
}

// A barrier of this thread's warpgroup (named barriers 1 and 2).
__device__ __forceinline__ void wg_sync() {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + (int)(threadIdx.x >> 7))
               : "memory");
}

// Wait for this warpgroup's products; then d may be read and, once every
// thread of the warpgroup is past the wait, their operands overwritten.
template <int R>
__device__ __forceinline__ void wg_wait(float (&d)[R]) {
  wg_wait_all();
  fence_regs(d);
  wg_sync();
}

// ---- threads and fragments -------------------------------------------------
//
// Accumulator element i = 4j + 2h + b of a thread (warp w of its
// warpgroup, lane 4g + q) is row 16w + g + 8h, column 8j + 2q + b of the
// warpgroup's 64 x (8 NJ) product.

__device__ __forceinline__ int wg_id() { return threadIdx.x >> 7; }
__device__ __forceinline__ int frow(int h) {
  return ((threadIdx.x >> 5) & 3) * 16 + ((threadIdx.x & 31) >> 2) + 8 * h;
}
__device__ __forceinline__ int fcol(int j, int b) {
  return 8 * j + 2 * (threadIdx.x & 3) + b;
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  return tc::pack_bf16(lo, hi);
}
__device__ __forceinline__ float lo_of(uint32_t p) {
  return __uint_as_float(p << 16);
}
__device__ __forceinline__ float hi_of(uint32_t p) {
  return __uint_as_float(p & 0xffff0000u);
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// d[c] += bias[c0 + c] for columns c0 + c < N
template <int NJ>
__device__ __forceinline__ void add_bias(float (&d)[4 * NJ],
                                         const float* __restrict__ bias,
                                         int c0, int N) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int c = c0 + fcol(j, b);
      const float x = c < N ? __ldg(bias + c) : 0.f;
      d[4 * j + b] += x;
      d[4 * j + 2 + b] += x;
    }
}

// selu() (tile.cuh) without a branch: expm1f for every element, then a
// select, so that a warp's lanes never part ways over the sign of their
// values (the same bits).
__device__ __forceinline__ float selu_nb(float a) {
  const float em1 = expm1f(a);
  return SELU_SCALE * (a > 0.f ? a : SELU_ALPHA * em1);
}

// dselu() (tile.cuh) without a branch, likewise.
__device__ __forceinline__ float dselu_nb(float a) {
  const float e = expf(a);
  return a > 0.f ? SELU_SCALE : SELU_SCALE * SELU_ALPHA * e;
}

template <int R>
__device__ __forceinline__ void apply_selu(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) d[i] = selu_nb(d[i]);
}

// The product's rows into rows [64 mt, 64 mt + 64) and columns [c0, c0 +
// 8 NJ) of a swizzled tile of R rows, rounded to bf16 (SELU first if
// `sel`).
template <int NJ>
__device__ __forceinline__ void store_tile(const float (&d)[4 * NJ],
                                           uint8_t* tile, int R, int mt,
                                           int c0, bool sel = false) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = mt * 64 + frow(h);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      float x = d[4 * j + 2 * h], y = d[4 * j + 2 * h + 1];
      if (sel) {
        x = selu_nb(x);
        y = selu_nb(y);
      }
      *reinterpret_cast<uint32_t*>(tile + toff(R, r, c0 + fcol(j, 0))) =
          pack(x, y);
    }
  }
}

// out[r, c] (row stride N) = rows [64 mt, 64 mt + 64) of a swizzled tile
// of R rows, for r < valid and c < N, by this warpgroup: 16-byte stores
// where the rows are whole 16-byte units.  After a wg_sync() that follows
// the tile's writes.
template <class OutT>
__device__ __forceinline__ void tile_rows_out(const uint8_t* tile, int R,
                                              int mt, OutT* __restrict__ out,
                                              int valid, int N,
                                              bool stream) {
  const int t = threadIdx.x & 127;
  if (valid > 64) valid = 64;
  if ((N & 7) == 0 && tc::aligned16(out)) {
    const int cpr = N / 8;
    for (int idx = t; idx < valid * cpr; idx += 128) {
      const int r = idx / cpr, c = (idx - r * cpr) * 8;
      const uint4 q =
          *reinterpret_cast<const uint4*>(tile + toff(R, mt * 64 + r, c));
      uint4* o = reinterpret_cast<uint4*>(out + (int64_t)r * N + c);
      if (stream)
        __stcs(o, q);
      else
        *o = q;
    }
  } else {
    for (int idx = t; idx < valid * N; idx += 128) {
      const int r = idx / N, c = idx - r * N;
      out[(int64_t)r * N + c] =
          *reinterpret_cast<const bf16*>(tile + toff(R, mt * 64 + r, c));
    }
  }
}

__device__ __forceinline__ void put2(float* p, float x, float y, bool pair,
                                     bool two, bool stream) {
  if (pair) {
    if (stream)
      __stcs(reinterpret_cast<float2*>(p), make_float2(x, y));
    else
      *reinterpret_cast<float2*>(p) = make_float2(x, y);
  } else {
    p[0] = x;
    if (two) p[1] = y;
  }
}
__device__ __forceinline__ void put2(bf16* p, float x, float y, bool pair,
                                     bool two, bool stream) {
  if (pair) {
    if (stream)
      __stcs(reinterpret_cast<unsigned int*>(p), pack(x, y));
    else
      *reinterpret_cast<uint32_t*>(p) = pack(x, y);
  } else {
    p[0] = __float2bfloat16_rn(x);
    if (two) p[1] = __float2bfloat16_rn(y);
  }
}

// out[r, c0 + c] (row stride ld) = d for rows r < valid of the product and
// columns c0 + c < N; SELU first if `sel`.
template <int NJ, class OutT>
__device__ __forceinline__ void store_rows(const float (&d)[4 * NJ],
                                           OutT* __restrict__ out, int valid,
                                           int c0, int N, int64_t ld,
                                           bool stream, bool sel = false) {
  const bool even = (ld & 1) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = frow(h);
    if (r >= valid) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = c0 + fcol(j, 0);
      if (c >= N) continue;
      float x = d[4 * j + 2 * h], y = d[4 * j + 2 * h + 1];
      if (sel) {
        x = selu_nb(x);
        y = selu_nb(y);
      }
      put2(out + (int64_t)r * ld + c, x, y, even && c + 1 < N, c + 1 < N,
           stream);
    }
  }
}

// d *= SELU'(a) where X = selu(a) is row-major [rows, K] (row stride ld,
// K if 0) in device or shared memory (this block wrote it), from the
// product's row 0; rows >= valid and columns >= K become 0.
template <int NJ>
__device__ __forceinline__ void mul_dselu(float (&d)[4 * NJ],
                                          const float* __restrict__ X,
                                          int valid, int c0, int K,
                                          int64_t ld = 0) {
  if (ld == 0) ld = K;
  const bool even = (K & 1) == 0 && (ld & 1) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = frow(h);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = c0 + fcol(j, 0);
      float x = 0.f, y = 0.f;
      if (r < valid && c < K) {
        const float* p = X + (int64_t)r * ld + c;
        if (even) {
          const float2 t = *reinterpret_cast<const float2*>(p);
          x = t.x;
          y = t.y;
        } else {
          x = p[0];
          y = c + 1 < K ? p[1] : 0.f;
        }
      }
      d[4 * j + 2 * h] = r < valid && c < K
                             ? d[4 * j + 2 * h] * dselu_of_selu(x)
                             : 0.f;
      d[4 * j + 2 * h + 1] = r < valid && c + 1 < K
                                 ? d[4 * j + 2 * h + 1] * dselu_of_selu(y)
                                 : 0.f;
    }
  }
}

// ---- shared memory ---------------------------------------------------------

struct Smem {
  uint8_t* e;   // edge tile E, bf16 [er x 128]
  uint8_t* vt;  // v tile, bf16 [64 x 64 vblocks(fv)]
  uint8_t* na;  // node tile NA, bf16 [64 x 128]
  uint8_t* w;   // weight slice, bf16 [128 x 128]
  float* nf;    // f32 [npb][LDN]: vr, aggr (ne > 1); daggr / k, dvr
  float* ag;    // f32 [npb][LDN]: aggr (nf when ne > 1)
  float* cs;    // column-sum scratch, 8 x 128 f32
  float* rs;    // row-statistics scratch, 2 x 64 f32
};

__device__ __forceinline__ Smem layout(const GnArgs<bf16>& a, uint8_t* raw) {
  Smem m;
  uint8_t* p = raw + ((1024 - (saddr(raw) & 1023)) & 1023);
  m.e = p;
  p += a.er * 256;
  m.vt = p;
  p += vblocks(a.fv) * VBLOCK_BYTES;
  m.na = p;
  p += 2 * VBLOCK_BYTES;
  m.w = p;
  p += W_BYTES;
  m.nf = reinterpret_cast<float*>(p);
  p += (size_t)a.npb * LDN * 4;
  m.ag = m.nf;
  if (a.ne == 1) {
    m.ag = reinterpret_cast<float*>(p);
    p += (size_t)a.npb * LDN * 4;
  }
  m.cs = reinterpret_cast<float*>(p);
  m.rs = m.cs + 1024;
  return m;
}

// ---- loads -----------------------------------------------------------------

// 16 (or, with bytes 0, zero) bytes from global to shared memory, async.
// No L2 cache-policy operand: cp.async with an evict_first policy stopped
// these kernels with an illegal instruction on the H100.
__device__ __forceinline__ void cp16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   saddr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// 16 bytes of rows that one tile reads once, past L1 and first out of L2
// (the gathered table and the weights stay there).
__device__ __forceinline__ uint4 ld_stream(const void* p, uint64_t policy) {
  uint4 q;
  asm volatile(
      "ld.global.nc.L1::no_allocate.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, "
      "[%4], %5;\n"
      : "=r"(q.x), "=r"(q.y), "=r"(q.z), "=r"(q.w)
      : "l"(p), "l"(policy));
  return q;
}

// tile[r, c] = src[row0 + r, c] (row stride F) for r < valid, c < F; zero
// for valid <= r < rows or F <= c < round16(F).  Where the rows are whole
// 16-byte units: streamed through registers, 8 loads in flight a thread
// (`stream`), or by cp.async (visible after a wait); else synchronous.
__device__ __forceinline__ void load_tile(uint8_t* tile, int R,
                                          const bf16* __restrict__ src,
                                          int64_t row0, int valid, int rows,
                                          int F, bool stream) {
  const int F16 = tc::round16(F);
  if ((F & 7) == 0 && tc::aligned16(src)) {
    const int cpr = F16 / 8, n = rows * cpr;
    if (stream) {
      const uint64_t pol = tc::stream_policy();
      for (int i0 = threadIdx.x; i0 < n; i0 += 8 * THREADS) {
        uint4 q[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int idx = i0 + u * THREADS, r = idx / cpr,
                    c = (idx - r * cpr) * 8;
          q[u] = make_uint4(0u, 0u, 0u, 0u);
          if (idx < n && r < valid && c < F)
            q[u] = ld_stream(src + (row0 + r) * F + c, pol);
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int idx = i0 + u * THREADS, r = idx / cpr,
                    c = (idx - r * cpr) * 8;
          if (idx < n) *reinterpret_cast<uint4*>(tile + toff(R, r, c)) = q[u];
        }
      }
      return;
    }
    for (int idx = threadIdx.x; idx < n; idx += THREADS) {
      const int r = idx / cpr, c = (idx - r * cpr) * 8;
      const bool ok = r < valid && c < F;
      cp16(tile + toff(R, r, c), ok ? src + (row0 + r) * F + c : src,
           ok ? 16 : 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * F16; idx += THREADS) {
      const int r = idx / F16, c = idx - r * F16;
      *reinterpret_cast<bf16*>(tile + toff(R, r, c)) =
          r < valid && c < F ? src[(row0 + r) * F + c]
                             : __float2bfloat16_rn(0.f);
    }
  }
}

// A weight slice in registers: x[i] = W[r, c .. c + 3] (W row-major, row
// stride N; zero past `rows` or N) for this thread's 16 pieces of 128 x 128,
// all loads in flight at once.
__device__ __forceinline__ void slice_load(float4 (&x)[16],
                                           const float* __restrict__ W,
                                           int rows, int N) {
  const bool vec = (N & 3) == 0 && tc::aligned16(W);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int idx = threadIdx.x + i * THREADS;
    const int r = idx >> 5, c = (idx & 31) * 4;
    x[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows && c < N) {
      const float* p = W + (size_t)r * N + c;
      if (vec) {
        x[i] = __ldg(reinterpret_cast<const float4*>(p));
      } else {
        x[i].x = __ldg(p);
        if (c + 1 < N) x[i].y = __ldg(p + 1);
        if (c + 2 < N) x[i].z = __ldg(p + 2);
        if (c + 3 < N) x[i].w = __ldg(p + 3);
      }
    }
  }
}

// The slice into shared memory, rounded to bf16 (zero outside W).
__device__ __forceinline__ void slice_store(uint8_t* w,
                                            const float4 (&x)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int idx = threadIdx.x + i * THREADS;
    const int r = idx >> 5, c = (idx & 31) * 4;
    *reinterpret_cast<uint2*>(w + toff(128, r, c)) =
        make_uint2(pack(x[i].x, x[i].y), pack(x[i].z, x[i].w));
  }
}

// Stage the slice whose loads x holds (slice_load): after the barrier
// after which every warpgroup is done with the last slice (and has written
// its A operands), stored and made visible to the products; `tiles`: also
// wait for this thread's cp.async rows first.
__device__ __forceinline__ void stage_x(const Smem& m, const float4 (&x)[16],
                                        bool tiles = false) {
  __syncthreads();
  slice_store(m.w, x);
  if (tiles) tc::cp_wait<0>();
  fence_async_smem();
  __syncthreads();
}

__device__ __forceinline__ int ksteps(int K) { return (K + 15) >> 4; }

// d (+)= A[64 x K] W[K x N] for this warpgroup's 64 columns: A a 64-row
// tile, W f32 rows in device memory, staged 128 rows at a time.  (Loading
// the next slice behind the products instead keeps 64 more registers live
// and spills.)
__device__ __forceinline__ void node_mm(float (&d)[32], const Smem& m,
                                        const uint8_t* A, const float* W,
                                        int K, int N, bool accumulate) {
  for (int k0 = 0; k0 < K; k0 += 128) {
    const int kc = K - k0 < 128 ? K - k0 : 128;
    float4 x[16];
    slice_load(x, W + (size_t)k0 * N, kc, N);
    stage_x(m, x, true);  // and the tiles' rows
    wg_mm<8, 1>(d, saddr(A) + (k0 >> 6) * VBLOCK_BYTES, 64, 0,
                saddr(m.w) + wg_id() * (W_BYTES / 2), ksteps(kc),
                accumulate || k0 > 0);
    wg_wait(d);
  }
}

// d (+)= A[64 x N] W^T for this warpgroup's 64 of W's Kr <= 128 rows: W f32
// [Kr][N] (N <= 128) in device memory.
__device__ __forceinline__ void node_mm_t(float (&d)[32], const Smem& m,
                                          const uint8_t* A, const float* W,
                                          int Kr, int N, bool accumulate) {
  float4 x[16];
  slice_load(x, W, Kr, N);
  stage_x(m, x);
  wg_mm<8, 0>(d, saddr(A), 64, 0, saddr(m.w) + wg_id() * VBLOCK_BYTES,
              ksteps(N), accumulate);
  wg_wait(d);
}

// ---- row reductions --------------------------------------------------------

// s0, s1 (this thread's quad-summed parts of rows frow(0), frow(1)) summed
// over both warpgroups' columns.  Two barriers.
__device__ __forceinline__ void xwg_sum(float& s0, float& s1, float* rs) {
  const int r = frow(0), w = wg_id();
  if ((threadIdx.x & 3) == 0) {
    rs[w * 64 + r] = s0;
    rs[w * 64 + r + 8] = s1;
  }
  __syncthreads();
  s0 = rs[r] + rs[64 + r];
  s1 = rs[r + 8] + rs[64 + r + 8];
  __syncthreads();
}

// LayerNorm statistics (biased variance, two passes, eps 1e-5) of this
// thread's two rows of d over their N columns: NJ = 16, one warpgroup's
// rows of 128 columns (c0 = 0); NJ = 8, a node row split over the two
// warpgroups (c0 = 64 * warpgroup; rs the scratch, four barriers).
template <int NJ>
__device__ __forceinline__ void row_stats(const float (&d)[4 * NJ], int c0,
                                          int N, float* rs, float (&mean)[2],
                                          float (&rstd)[2]) {
  const float inv_n = 1.f / (float)N;
  float s[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int b = 0; b < 2; ++b)
        if (c0 + fcol(j, b) < N) s[h] += d[4 * j + 2 * h + b];
  s[0] = quad_sum(s[0]);
  s[1] = quad_sum(s[1]);
  if (NJ == 8) xwg_sum(s[0], s[1], rs);
  mean[0] = s[0] * inv_n;
  mean[1] = s[1] * inv_n;
  float v[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int b = 0; b < 2; ++b)
        if (c0 + fcol(j, b) < N) {
          const float t = d[4 * j + 2 * h + b] - mean[h];
          v[h] += t * t;
        }
  v[0] = quad_sum(v[0]);
  v[1] = quad_sum(v[1]);
  if (NJ == 8) xwg_sum(v[0], v[1], rs);
  rstd[0] = rsqrtf(v[0] * inv_n + LN_EPS);
  rstd[1] = rsqrtf(v[1] * inv_n + LN_EPS);
}

// LayerNorm of each row of d, in place (row_stats' layouts); columns >= N
// become 0.
template <int NJ>
__device__ __forceinline__ void layer_norm(float (&d)[4 * NJ], int c0, int N,
                                           const float* __restrict__ scale,
                                           const float* __restrict__ bias,
                                           float* rs) {
  float mean[2], rstd[2];
  row_stats<NJ>(d, c0, N, rs, mean, rstd);
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int c = c0 + fcol(j, b);
      const float sc = c < N ? __ldg(scale + c) : 0.f;
      const float bi = c < N ? __ldg(bias + c) : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        d[4 * j + 2 * h + b] =
            c < N ? (d[4 * j + 2 * h + b] - mean[h]) * rstd[h] * sc + bi : 0.f;
    }
}

// T[n, c] += d at this thread's rows of m-tile mt, n = row / k, for rows <
// ev, in k rounds (round rho adds the rows whose place within their
// receiver is rho), one barrier before each: called by every thread in
// each phase, `has` whether its warpgroup holds an m-tile there.  So each
// receiver's rows are added in row order, whatever m-tiles they lie in.
__device__ __forceinline__ void rounds_add(const float (&d)[64], bool has,
                                           int mt, int ev, int k, float* T) {
  int row[2], n[2], rho[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = mt * 64 + frow(h);
    n[h] = row[h] / k;
    rho[h] = row[h] - n[h] * k;
  }
  for (int r = 0; r < k; ++r) {
    __syncthreads();
    if (!has) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (row[h] >= ev || rho[h] != r) continue;
      float* t = T + n[h] * LDN;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        float2* p = reinterpret_cast<float2*>(t + fcol(j, 0));
        float2 x = *p;
        x.x += d[4 * j + 2 * h];
        x.y += d[4 * j + 2 * h + 1];
        *p = x;
      }
    }
  }
}

// out[c] = the sum over the eight warps of s (each thread's sums over its
// rows at its columns 8j + 2q + b, s[2j + b]), c < N, in a fixed order.
// Two barriers.
__device__ __forceinline__ void edge_colsum(float (&s)[32], int N, float* cs,
                                            float* out) {
  const int w = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    s[i] += __shfl_xor_sync(0xffffffffu, s[i], 4);
    s[i] += __shfl_xor_sync(0xffffffffu, s[i], 8);
    s[i] += __shfl_xor_sync(0xffffffffu, s[i], 16);
  }
  if ((threadIdx.x & 31) < 4)
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int b = 0; b < 2; ++b) cs[w * 128 + fcol(j, b)] = s[2 * j + b];
  __syncthreads();
  for (int c = threadIdx.x; c < N; c += THREADS) {
    float t = 0.f;
    for (int v = 0; v < 8; ++v) t += cs[v * 128 + c];
    out[c] = t;
  }
  __syncthreads();
}

// Prefetch rows [0, min(valid, 64)) of an f32 [rows][K] array into L1, by
// this warpgroup (one 128-byte line a thread a step).
__device__ __forceinline__ void prefetch_rows(const float* X, int valid,
                                              int K) {
  const int lines = (K * 4 + 127) / 128, n = (valid < 64 ? valid : 64) * lines;
  for (int i = threadIdx.x & 127; i < n; i += 128) {
    const int r = i / lines, l = i - r * lines;
    asm volatile("prefetch.global.L1 [%0];\n" ::"l"(X + (int64_t)r * K +
                                                     l * 32));
  }
}

// Zero rows [0, rows) of an f32 node tile.
__device__ __forceinline__ void zero_nf(float* T, int rows) {
  for (int i = threadIdx.x; i < rows * LDN; i += THREADS) T[i] = 0.f;
}

// NA = bf16(T * scale) over 64 rows (rows >= valid zero), and, if x is not
// null, x[r, c] = T[r, c] * scale for r < valid, c < N in f32 (or, for a
// bf16 x, rounded).  T [npb][LDN] f32.
template <class XT>
__device__ __forceinline__ void node_tile_from(uint8_t* na, const float* T,
                                               float scale, int valid, int N,
                                               XT* x) {
  for (int idx = threadIdx.x; idx < 64 * 16; idx += THREADS) {
    const int r = idx >> 4, c = (idx & 15) * 8;
    float f[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = r < valid ? T[r * LDN + c + i] * scale
                                                 : 0.f;
    *reinterpret_cast<uint4*>(na + toff(64, r, c)) =
        make_uint4(pack(f[0], f[1]), pack(f[2], f[3]), pack(f[4], f[5]),
                   pack(f[6], f[7]));
    if (x != nullptr && r < valid)
#pragma unroll
      for (int i = 0; i < 8; i += 2)
        if (c + i < N)
          put2(x + (int64_t)r * N + c + i, f[i], f[i + 1],
               (N & 1) == 0 && c + i + 1 < N, c + i + 1 < N, false);
  }
}

// ---- the forward -----------------------------------------------------------

// The sender rows of m-tile mt, by this warpgroup, into a 64 x 128 bf16
// swizzled tile: buf[r, c] = vs[senders[64 mt + r], c] for c < H1, zero
// past H1, past the tile's rows and for a sender outside [0, S) (not
// read; the epilogue makes its row NaN).  cp.async where the rows are
// whole 16-byte units, else synchronous.
__device__ __forceinline__ void gather_tile(uint8_t* buf,
                                            const GnArgs<bf16>& a,
                                            int64_t e0, int mt, int ev,
                                            int H1) {
  const int t = threadIdx.x & 127;
  if ((H1 & 7) == 0 && tc::aligned16(a.vs)) {
    for (int idx = t; idx < 64 * 16; idx += 128) {
      const int r = idx >> 4, c = (idx & 15) * 8, row = mt * 64 + r;
      const int s = row < ev ? __ldg(a.senders + e0 + row) : -1;
      const bool ok = (unsigned)s < (unsigned)a.S && c < H1;
      cp16(buf + toff(64, r, c), ok ? a.vs + (size_t)s * H1 + c : a.vs,
           ok ? 16 : 0);
    }
  } else {
    for (int idx = t; idx < 64 * 128; idx += 128) {
      const int r = idx >> 7, c = idx & 127, row = mt * 64 + r;
      const int s = row < ev ? __ldg(a.senders + e0 + row) : -1;
      const bool ok = (unsigned)s < (unsigned)a.S && c < H1;
      *reinterpret_cast<bf16*>(buf + toff(64, r, c)) =
          ok ? a.vs[(size_t)s * H1 + c] : __float2bfloat16_rn(0.f);
    }
  }
}

// The forward of one tile of receivers [n0, n0 + nv).  BWD = false writes
// e'; BWD = true writes the backward's operands instead: the inputs of edge
// layers 2..ne (xe), e_pre (the edge chain's pre-LayerNorm output, epre),
// aggr (xn[0]) and the inputs of node layers 2..nn (xn).  Leaves the node
// chain's pre-LayerNorm output in d (this warpgroup's 64 columns).
template <bool BWD>
__device__ __forceinline__ void forward(const GnArgs<bf16>& a, const Smem& m,
                                        int64_t n0, int nv, float (&d)[32]) {
  const int k = a.k, er = a.er, emt = er / 64, phases = (emt + 1) / 2;
  const int64_t e0 = n0 * k;
  const int ev = nv * k;
  const int H1 = a.ed[1], He = a.ed[a.ne], fv = a.fv;
  const int wg = wg_id();

  const int Hn1 = a.nd[1];
  load_tile(m.vt, 64, a.v, n0, nv, 64, fv, true);
  load_tile(m.e, er, a.e, e0, ev, er, a.fe, true);

  // vr = v @ Wr into NF
  node_mm(d, m, m.vt, a.ew[0] + (size_t)(a.fe + a.fs) * H1, fv, H1, false);
  {
    const int r0 = frow(0);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (r0 + 8 * h < a.npb)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<float2*>(m.nf + (r0 + 8 * h) * LDN + 64 * wg +
                                     fcol(j, 0)) =
              make_float2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
  }

  // the edge chain, one m-tile of 64 edge rows per warpgroup and phase
  for (int l = 0; l < a.ne; ++l) {
    const int K = l == 0 ? a.fe : a.ed[l], N = a.ed[l + 1];
    const bool last = l == a.ne - 1;
    {
      float4 x[16];  // W_l (rows [0, fe) of the first: We)
      slice_load(x, a.ew[l], K, N);
      stage_x(m, x);
    }
    // the aggr sums (in NF once layer 0 has read vr from there)
    if (last) zero_nf(m.ag, a.npb);
    // the v rows again, where layer 0 gathered sender rows (the node
    // chain's first product waits for them)
    if (l == 1) {
      load_tile(m.vt, 64, a.v, n0, nv, 64, fv, false);
      tc::cp_commit();
    }
    for (int p = 0; p < phases; ++p) {
      const int mt = 2 * p + wg;
      const bool has = mt < emt;
      const int valid = ev - mt * 64;
      float acc[64];
      // the sender rows of the first layer land in a tile of their own (NA
      // for warpgroup 0, the v tile for 1) while the products run
      uint8_t* vsg = wg == 0 ? m.na : m.vt;
      if (l == 0 && has) {
        wg_sync();  // the warpgroup is done with its last phase's rows
        gather_tile(vsg, a, e0, mt, ev, H1);
        tc::cp_commit();
      }
      // every warpgroup runs the products (one without an m-tile here
      // repeats m-tile 0's and drops them): a product under a branch on
      // the warpgroup would serialize the wgmma pipeline
      wg_mm<16, 1>(acc, saddr(m.e), er, has ? mt : 0, saddr(m.w), ksteps(K),
                   false);
      wg_wait(acc);
      if (has) {
        if (l == 0) {
          // h1 = e @ We + vs[senders] + vr[receiver] + b1
          tc::cp_wait<0>();
          wg_sync();
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = mt * 64 + frow(h);
            const bool ok = r < ev;
            const bool bad =
                ok && (unsigned)__ldg(a.senders + e0 + r) >= (unsigned)a.S;
            const float* vr = m.nf + (ok ? r / k : 0) * LDN;
#pragma unroll
            for (int j = 0; j < 16; ++j) {
              const int c = fcol(j, 0);
              const float2 t = ok ? *reinterpret_cast<const float2*>(vr + c)
                                  : make_float2(0.f, 0.f);
              const uint32_t g =
                  bad && c < H1 ? 0x7fc07fc0u
                                : *reinterpret_cast<const uint32_t*>(
                                      vsg + toff(64, frow(h), c));
              // in the plain version's order: (e We + vs) + vr, then b1
              acc[4 * j + 2 * h] = (acc[4 * j + 2 * h] + lo_of(g)) + t.x;
              acc[4 * j + 2 * h + 1] =
                  (acc[4 * j + 2 * h + 1] + hi_of(g)) + t.y;
            }
          }
        }
        add_bias<16>(acc, a.eb[l], 0, N);
        if (!last) {
          apply_selu(acc);
          if (BWD)
            store_rows<16>(acc, a.xe[l] + (e0 + mt * 64) * N, valid, 0, N,
                           N, false);
          store_tile<16>(acc, m.e, er, mt, 0);
        } else {
          if (BWD)
            store_rows<16>(acc, a.epre + (e0 + mt * 64) * He, valid, 0, He,
                           He, false);
          if (a.eln_scale != nullptr)
            layer_norm<16>(acc, 0, He, a.eln_scale, a.eln_bias, m.rs);
          // e' into the m-tile's rows of E (its product is done); out
          // after the chain
          if (!BWD && a.e_out != nullptr)
            store_tile<16>(acc, m.e, er, mt, 0, a.out_selu != 0);
        }
      }
      // aggr: the f32 e_new summed per receiver, in row order
      if (last) rounds_add(acc, has, mt, ev, k, m.ag);
    }
  }
  __syncthreads();
  if (a.ne == 1) {
    load_tile(m.vt, 64, a.v, n0, nv, 64, fv, false);
    tc::cp_commit();
  }
  // e' from E in 16-byte stores by every thread, draining while the node
  // chain runs (it does not touch E)
  if (!BWD && a.e_out != nullptr)
    for (int mt = wg; mt < emt; mt += 2)
      tile_rows_out(m.e, er, mt, a.e_out + (e0 + mt * 64) * He,
                    ev - mt * 64, He, true);

  // aggr = the mean over k into NA (bf16) and, for the backward, xn[0]
  node_tile_from(m.na, m.ag, 1.f / (float)k, nv, He,
                 BWD ? a.xn[0] + n0 * He : (float*)nullptr);

  // the node chain: aggr @ Wa + v @ Wv + bn1, then layers 2..nn
  node_mm(d, m, m.na, a.nw[0], He, Hn1, false);
  node_mm(d, m, m.vt, a.nw[0] + (size_t)He * Hn1, fv, Hn1, true);
  add_bias<8>(d, a.nb[0], 64 * wg, Hn1);
  for (int l = 1; l < a.nn; ++l) {
    const int K = a.nd[l];
    apply_selu(d);
    if (BWD) store_rows<8>(d, a.xn[l] + n0 * K, nv, 64 * wg, K, K, false);
    __syncthreads();  // both warpgroups are done reading NA
    store_tile<8>(d, m.na, 64, 0, 64 * wg);
    node_mm(d, m, m.na, a.nw[l], K, a.nd[l + 1], false);
    add_bias<8>(d, a.nb[l], 64 * wg, a.nd[l + 1]);
  }
}

// The two kernels (gn_block_bf16.cu): each returns its launch's error.
cudaError_t launch_fwd(const GnArgs<bf16>& a, size_t smem, cudaStream_t s);
cudaError_t launch_bwd_tile(const GnArgs<bf16>& a, size_t smem,
                            cudaStream_t s);

}  // namespace gn16
}  // namespace g4c
