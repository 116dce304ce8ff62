// The MLP chain's forward under the bf16 policy (compute_dtype bfloat16),
// on Hopper's warpgroup products over bf16 tiles in shared memory
// (geometry: mlp_tile_bf16.cuh; wgmma helpers: gn_tile_bf16.cuh).
//
// Replaces, under compute_dtype=bfloat16, the TPU kernel
// graphs4cfd_tpu/ops/pallas_mlp.py:_make_fwd_kernel (kernel :75, entry
// fused_mlp:255), as mlp_chain.cu's kernel does in f32: Linear -> SELU ->
// ... -> Linear, then an optional LayerNorm; with `preact` x is the
// pre-activation of a first layer computed outside and the chain starts
// with SELU of it.
//
// Rounding follows pallas_mlp.py:_chain_forward:49-63 under compute_dtype
// bfloat16: each product's operands rounded to bf16 (nearest even) and
// summed in f32; SELU(x) with preact, the biases, SELU and the LayerNorm
// (eps 1e-5, biased variance) in f32; each layer's SELU output rounded
// once into the next product's tile, the output once.
//
// Bound on the H100: at the MuS level-1 edge encoder (242,688 rows, 2 ->
// 128 -> 128 -> 128) 16.0 GFLOP (0.016 ms at 989 TFLOP/s) against 260
// bytes a row, 63 MB (0.019 ms): the bytes, by a little.  Past both, the
// epilogues on the CUDA cores: every hidden value takes an expm1f for
// SELU (62 M of them there), more instructions than its share of the
// products.  The design it replaces (the f32 tile templated on bf16: f32
// activation tiles, every operand rounded again at each mma.sync fragment
// load, f32 weights re-staged through a two-stage ring by every tile,
// synchronous row loads, a separate one-warp-a-row LayerNorm pass) ran at
// 12-21 times the bound.  Here:
//   - a warpgroup takes a 64-row m-tile through every layer alone: m64n128
//     wgmma products, 128 output columns a pass, the accumulators in
//     registers; bias, SELU and the LayerNorm (a row in the four lanes of
//     a quad) run on them, and each layer's output goes back into the same
//     bf16 tile in wgmma's swizzled layout, rounded once.  Its only
//     barriers are its own, so the up to four warpgroups of a block
//     overlap each other's loads, products and epilogues;
//   - the weights are rounded to bf16 once a block, into images of only
//     the k16 steps each layer needs (4 KB a step: a 2 -> 128 -> 128 ->
//     128 encoder keeps 68 KB), which stay in shared memory while the
//     block walks its m-tiles (one wave of blocks, m-tiles dealt out in
//     turn);
//   - x arrives as one contiguous run of the m-tile's rows, 16 bytes a
//     thread, 8 loads in flight, past L1 and first out of L2, whatever the
//     row width (K0 = 2-5 are padded with zeros to one k16 step);
//   - the output leaves through the tile in 16-byte streaming stores;
//   - registers decide the speed (64 accumulators of 128 a thread at four
//     warpgroups): the chains of the models (weights resident, outputs up
//     to 128) take an instantiation that holds no other path, and the
//     bias and LayerNorm parameters load a quarter at a time.  The other
//     instantiation (GENERAL) takes outputs up to 256 wide in two passes
//     into a second tile, the LayerNorm over both through an f32 stash,
//     and weights whose images do not fit, rounded a 128-row chunk at a
//     time into a slot of the warpgroup's own ("streamed").
// Times at the chain cases: PERF.md section 6.  No float atomics, and a
// row's output depends only on that row: the same products in the same
// order whatever the row count, the tile, the block or the path.
#include <map>
#include <mutex>
#include <tuple>

#include "mlp_tile_bf16.cuh"

namespace g4c {
namespace mlp16 {

using gn16::bf16;
using mlp::MlpArgs;

extern __shared__ __align__(16) uint8_t smem_fwd16[];

// The bf16 image of rows [k0, k0 + 16 ks) and columns [n0, n0 + 128) of W
// [K][N] (zero past K or N): two 64-column blocks of 16 ks rows in the
// products' 128-byte swizzled layout (toff), the second ks * 2048 bytes
// on.  Threads tid, tid + nt, ... each convert B pieces of 4 values at a
// time (B loads in flight).
template <int B>
__device__ __forceinline__ void wimage(uint8_t* dst,
                                       const float* __restrict__ W, int K,
                                       int N, int k0, int ks, int n0,
                                       int tid, int nt) {
  const int R = 16 * ks, total = R * 32;
  const bool vec = (N & 3) == 0 && tc::aligned16(W);
  for (int i0 = tid; i0 < total; i0 += B * nt) {
    float4 v[B];
#pragma unroll
    for (int u = 0; u < B; ++u) {
      const int idx = i0 + u * nt, k = k0 + (idx >> 5),
                c = n0 + (idx & 31) * 4;
      v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (idx < total && k < K && c < N) {
        const float* p = W + (size_t)k * N + c;
        if (vec) {
          v[u] = __ldg(reinterpret_cast<const float4*>(p));
        } else {
          v[u].x = __ldg(p);
          if (c + 1 < N) v[u].y = __ldg(p + 1);
          if (c + 2 < N) v[u].z = __ldg(p + 2);
          if (c + 3 < N) v[u].w = __ldg(p + 3);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < B; ++u) {
      const int idx = i0 + u * nt;
      if (idx < total)
        *reinterpret_cast<uint2*>(dst +
                                  gn16::toff(R, idx >> 5, (idx & 31) * 4)) =
            make_uint2(gn16::pack(v[u].x, v[u].y),
                       gn16::pack(v[u].z, v[u].w));
    }
  }
}

// The raw bits of x[e] (0 past `total`) as the low half of a word.
__device__ __forceinline__ uint32_t bits_at(const bf16* __restrict__ x,
                                            int e, int total) {
  return e < total ? (uint32_t)__bfloat16_as_ushort(x[e]) : 0u;
}

// bf16 value h of x, or SELU of it in f32 rounded once (preact).
__device__ __forceinline__ uint32_t x_value(uint32_t h, bool preact) {
  if (!preact) return h;
  const float y = gn16::selu_nb(__uint_as_float(h << 16));
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(y));
}

// Values e0 .. e0 + 7 of the m-tile's run (row e / K0, column e % K0; q
// holds them, zero past the run) into E.
__device__ __forceinline__ void put8(uint8_t* E, const uint4& q, int e0,
                                     int K0, int total, bool preact) {
  int r = e0 / K0, c = e0 - r * K0;
  if ((K0 & 7) == 0) {  // 8 values of one row, a 16-byte unit of the tile
    uint4 v = q;
    if (preact) {
      uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        w[i] = x_value(w[i] & 0xffffu, true) |
               (x_value(w[i] >> 16, true) << 16);
    }
    *reinterpret_cast<uint4*>(E + gn16::toff(FWD_ROWS, r, c)) = v;
    return;
  }
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if (e0 + k >= total) break;
    const uint32_t h = (k & 1) ? w[k >> 1] >> 16 : w[k >> 1] & 0xffffu;
    *reinterpret_cast<uint16_t*>(E + gn16::toff(FWD_ROWS, r, c)) =
        (uint16_t)x_value(h, preact);
    if (++c == K0) {
      c = 0;
      ++r;
    }
  }
}

// Zeros in E where the m-tile's x leaves none: in 16-byte units, those
// from column K0 & ~7 on below round16(K0), and every unit of the rows
// past valid.  A unit that x then shares (K0 not a multiple of 8) is
// zeroed before it: a barrier follows.
__device__ __forceinline__ void zero_pad(uint8_t* E, int valid, int K0) {
  const int units = tc::round16(K0) / 8, z0 = K0 / 8;
  if (z0 == units && valid == FWD_ROWS) return;
  for (int i = threadIdx.x & 127; i < FWD_ROWS * units; i += 128) {
    const int r = i / units, u = i - r * units;
    if (r >= valid || u >= z0)
      *reinterpret_cast<uint4*>(E + gn16::toff(FWD_ROWS, r, 8 * u)) =
          make_uint4(0u, 0u, 0u, 0u);
  }
  if (K0 & 7) gn16::wg_sync();
}

// Chunk i (values 8i .. 8i + 7) of a run of `total` values at src, 16-byte
// aligned: one 16-byte load past L1 and first out of L2, or, for the run's
// last chunk cut short, its values one by one (zero past the run).
__device__ __forceinline__ uint4 x_chunk(const bf16* __restrict__ src, int i,
                                         int total, uint64_t pol) {
  const int e = 8 * i;
  if (e + 8 <= total) return gn16::ld_stream(src + e, pol);
  uint4 q;
  q.x = bits_at(src, e, total) | bits_at(src, e + 1, total) << 16;
  q.y = bits_at(src, e + 2, total) | bits_at(src, e + 3, total) << 16;
  q.z = bits_at(src, e + 4, total) | bits_at(src, e + 5, total) << 16;
  q.w = bits_at(src, e + 6, total) | bits_at(src, e + 7, total) << 16;
  return q;
}

// This warpgroup's m-tile of x into E: E[r, c] = x[row0 + r, c] (SELU of
// it with preact) for r < valid, c < K0, zero for the other columns below
// round16(K0) and for the rows past valid.  The m-tile's rows are one run
// of valid * K0 values, 16 bytes a thread, 8 loads in flight, where x is
// 16-byte aligned (its start is then too: row0 is a multiple of 64); else
// 2 bytes at a time.  Visible to the products after fence_async_smem() and
// the warpgroup's barrier.
__device__ __forceinline__ void load_x(uint8_t* E, const bf16* __restrict__ x,
                                       int64_t row0, int valid, int K0,
                                       bool preact) {
  const int t = threadIdx.x & 127, total = valid * K0;
  const bf16* src = x + row0 * K0;
  zero_pad(E, valid, K0);
  if (tc::aligned16(x)) {
    const int chunks = (total + 7) / 8;
    const uint64_t pol = tc::stream_policy();
    for (int i0 = t; i0 < chunks; i0 += 8 * 128) {
      uint4 q[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        q[u] = i0 + u * 128 < chunks ? x_chunk(src, i0 + u * 128, total, pol)
                                     : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i = i0 + u * 128;
        if (i < chunks) put8(E, q[u], 8 * i, K0, total, preact);
      }
    }
  } else {
    for (int e = t; e < total; e += 128) {
      const int r = e / K0, c = e - r * K0;
      *reinterpret_cast<uint16_t*>(E + gn16::toff(FWD_ROWS, r, c)) =
          (uint16_t)x_value(bits_at(src, e, total), preact);
    }
  }
}

// The bias and LayerNorm of a pass take their parameters a quarter of the
// columns at a time: a compiler barrier between the quarters keeps the
// loads from being hoisted all together, which would hold 32-64 more
// registers beside the 64 accumulators.  FULL: the pass has all 128
// columns (N - c0 >= 128), so no column needs its mask.
__device__ __forceinline__ void quarter_fence() {
  asm volatile("" ::: "memory");
}

// d[c] += bias[c0 + c] for columns c0 + c < N (add_bias's sums).
template <bool FULL>
__device__ __forceinline__ void add_bias_q(float (&d)[64],
                                           const float* __restrict__ bias,
                                           int c0, int N) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll
    for (int j = 4 * q; j < 4 * q + 4; ++j)
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int c = c0 + gn16::fcol(j, b);
        const float x = FULL || c < N ? __ldg(bias + c) : 0.f;
        d[4 * j + b] += x;
        d[4 * j + 2 + b] += x;
      }
    quarter_fence();
  }
}

// The LayerNorm of each of this thread's two rows of d over N <= 128
// columns, in place (row_stats<16> and layer_norm<16>'s arithmetic, in
// their order); columns >= N become 0.
template <bool FULL>
__device__ __forceinline__ void layer_norm_q(float (&d)[64], int N,
                                             const float* __restrict__ scale,
                                             const float* __restrict__ bias) {
  const float inv_n = 1.f / (float)N;
  float s[2] = {0.f, 0.f}, v[2] = {0.f, 0.f}, mean[2], rstd[2];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int b = 0; b < 2; ++b)
        if (FULL || gn16::fcol(j, b) < N) s[h] += d[4 * j + 2 * h + b];
#pragma unroll
  for (int h = 0; h < 2; ++h) mean[h] = gn16::quad_sum(s[h]) * inv_n;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int b = 0; b < 2; ++b)
        if (FULL || gn16::fcol(j, b) < N) {
          const float t = d[4 * j + 2 * h + b] - mean[h];
          v[h] += t * t;
        }
#pragma unroll
  for (int h = 0; h < 2; ++h)
    rstd[h] = rsqrtf(gn16::quad_sum(v[h]) * inv_n + LN_EPS);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll
    for (int j = 4 * q; j < 4 * q + 4; ++j)
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int c = gn16::fcol(j, b);
        const bool in = FULL || c < N;
        const float sc = in ? __ldg(scale + c) : 0.f;
        const float bi = in ? __ldg(bias + c) : 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h)
          d[4 * j + 2 * h + b] =
              in ? (d[4 * j + 2 * h + b] - mean[h]) * rstd[h] * sc + bi : 0.f;
      }
    quarter_fence();
  }
}

// out[r, c] (row stride N) = the tile's rows r < valid, c < N, by this
// warpgroup (tile_rows_out's stores; 16 bytes at a time where the rows
// are whole 16-byte units, shifts for the 128-wide rows of the models).
__device__ __forceinline__ void rows_out(const uint8_t* tile,
                                         bf16* __restrict__ out, int valid,
                                         int N) {
  const int t = threadIdx.x & 127;
  if (N == 128 && tc::aligned16(out)) {
    for (int i = t; i < valid * 16; i += 128) {
      const int r = i >> 4, c = (i & 15) * 8;
      __stcs(reinterpret_cast<uint4*>(out + (int64_t)r * 128 + c),
             *reinterpret_cast<const uint4*>(tile +
                                             gn16::toff(FWD_ROWS, r, c)));
    }
  } else {
    gn16::tile_rows_out<bf16>(tile, FWD_ROWS, 0, out, valid, N, true);
  }
}

// The LayerNorm of an output of 128 < N <= 256 columns, whose first pass
// (columns [0, 128), pre-LN, f32) this thread left in its own slots of
// the stash (st[i * 128]) and whose second (columns 128 + fcol) d holds:
// both normalized (biased variance, eps 1e-5) into the warpgroup's rows of
// `tile`, rounded to bf16.
__device__ __forceinline__ void ln_wide(float (&d)[64], const float* st,
                                        int N, const float* __restrict__ sc,
                                        const float* __restrict__ bi,
                                        uint8_t* tile) {
  const float inv_n = 1.f / (float)N;
  float s[2] = {0.f, 0.f}, v[2] = {0.f, 0.f}, mean[2], rstd[2];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int i = 4 * j + 2 * h + b;
        s[h] += st[i * 128];
        if (128 + gn16::fcol(j, b) < N) s[h] += d[i];
      }
#pragma unroll
  for (int h = 0; h < 2; ++h) mean[h] = gn16::quad_sum(s[h]) * inv_n;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int i = 4 * j + 2 * h + b;
        const float a = st[i * 128] - mean[h];
        v[h] += a * a;
        if (128 + gn16::fcol(j, b) < N) {
          const float c = d[i] - mean[h];
          v[h] += c * c;
        }
      }
#pragma unroll
  for (int h = 0; h < 2; ++h)
    rstd[h] = rsqrtf(gn16::quad_sum(v[h]) * inv_n + LN_EPS);
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int c = 128 + gn16::fcol(j, b);
      const float g = c < N ? __ldg(sc + c) : 0.f;
      const float o = c < N ? __ldg(bi + c) : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float& x = d[4 * j + 2 * h + b];
        x = c < N ? (x - mean[h]) * rstd[h] * g + o : 0.f;
      }
    }
  gn16::store_tile<16>(d, tile, FWD_ROWS, 0, 128);
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = gn16::fcol(j, 0), i = 4 * j + 2 * h;
      const float x =
          (st[i * 128] - mean[h]) * rstd[h] * __ldg(sc + c) + __ldg(bi + c);
      const float y = (st[(i + 1) * 128] - mean[h]) * rstd[h] *
                          __ldg(sc + c + 1) +
                      __ldg(bi + c + 1);
      *reinterpret_cast<uint32_t*>(
          tile + gn16::toff(FWD_ROWS, gn16::frow(h), c)) = gn16::pack(x, y);
    }
}

// GENERAL: the chain's weights are streamed or an output is wider than
// 128; the other instantiation (every chain of the models) holds neither
// path's code.
template <bool GENERAL>
__global__ void __launch_bounds__(FWD_THREADS, 1)
    mlp_chain_fwd_bf16_kernel(const MlpArgs<bf16> a) {
  const int n = a.n, K0 = a.dims[0], N = a.dims[n];
  const bool streamed = GENERAL && fwd_streamed(n, a.dims),
             wide = GENERAL && fwd_wide(n, a.dims);
  const int G = blockDim.x >> 7, wg = threadIdx.x >> 7,
            t = threadIdx.x & 127;
  uint8_t* p = smem_fwd16 + ((1024 - (gn16::saddr(smem_fwd16) & 1023)) & 1023);

  // the resident weight images, layer by layer, 128 columns at a time
  const uint8_t* wres = p;
  if (!streamed) {
    for (int l = 0; l < n; ++l) {
      const int ks = gn16::ksteps(a.dims[l]);
      for (int c0 = 0; c0 < a.dims[l + 1]; c0 += 128) {
        wimage<8>(p, a.w[l], a.dims[l], a.dims[l + 1], 0, ks, c0,
                  threadIdx.x, blockDim.x);
        p += (size_t)ks * FWD_STEP_BYTES;
      }
    }
    gn16::fence_async_smem();
  }
  __syncthreads();

  // this warpgroup's tiles
  uint8_t* own = p + (size_t)wg * fwd_wg_bytes(n, a.dims, streamed);
  const size_t e_bytes = (size_t)FWD_ROWS * fwd_tile_cols(n, a.dims) * 2;
  uint8_t* const E0 = own;
  uint8_t* const E1 = wide ? own + e_bytes : own;
  uint8_t* aux = own + e_bytes * (wide ? 2 : 1);
  float* const stash = reinterpret_cast<float*>(aux) + t;  // wide
  uint8_t* const slot = aux + (wide ? FWD_AUX_BYTES : 0);   // streamed

  // m-tiles dealt out in turn: blockIdx.x + gridDim.x * (wg + G k)
  float acc[64];
  const int tiles = (int)((a.rows + FWD_ROWS - 1) / FWD_ROWS);
  for (int mt = blockIdx.x + gridDim.x * wg; mt < tiles;
       mt += gridDim.x * G) {
    const int64_t row0 = (int64_t)mt * FWD_ROWS;
    const int valid = (int)(a.rows - row0 < FWD_ROWS ? a.rows - row0
                                                     : FWD_ROWS);
    uint8_t* ein = E0;
    uint8_t* eout = E1;  // E0 unless wide: in place
    load_x(ein, a.x, row0, valid, K0, a.preact != 0);
    gn16::fence_async_smem();
    gn16::wg_sync();
    const uint8_t* img = wres;
    for (int l = 0; l < n; ++l) {
      const int K = a.dims[l], Nl = a.dims[l + 1], ks = gn16::ksteps(K);
      const bool last = l == n - 1;
      const int c1 = GENERAL ? Nl : 1;  // 128-column passes
      for (int c0 = 0; c0 < c1; c0 += 128) {
        // the products overwrite acc (scale-d 0 first), but their asm
        // reads it: zeroed here, the last pass's values are dead outside
        // the epilogue (no registers held across the x loads)
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] = 0.f;
        if (!streamed) {
          gn16::wg_mm<16, 1>(acc, gn16::saddr(ein), FWD_ROWS, 0,
                             gn16::saddr(img), ks, false,
                             ks * (FWD_STEP_BYTES / 2));
          img += (size_t)ks * FWD_STEP_BYTES;
          gn16::wg_wait(acc);
        } else {
          for (int k0 = 0; k0 < K; k0 += 128) {
            const int kc = gn16::ksteps(K - k0 < 128 ? K - k0 : 128);
            wimage<4>(slot, a.w[l], K, Nl, k0, kc, c0, t, 128);
            gn16::fence_async_smem();
            gn16::wg_sync();
            gn16::wg_mm<16, 1>(acc,
                               gn16::saddr(ein) + (k0 >> 6) * FWD_ROWS * 128,
                               FWD_ROWS, 0, gn16::saddr(slot), kc, k0 > 0,
                               kc * (FWD_STEP_BYTES / 2));
            gn16::wg_wait(acc);  // and the slot is free again
          }
        }
        if (Nl - c0 >= 128)
          add_bias_q<true>(acc, a.b[l], c0, Nl);
        else
          add_bias_q<false>(acc, a.b[l], c0, Nl);
        if (!last) {
          gn16::apply_selu(acc);
          gn16::store_tile<16>(acc, eout, FWD_ROWS, 0, c0);
        } else if (a.ln_scale == nullptr) {
          gn16::store_tile<16>(acc, eout, FWD_ROWS, 0, c0);
        } else if (!GENERAL || Nl <= 128) {
          if (Nl == 128)
            layer_norm_q<true>(acc, Nl, a.ln_scale, a.ln_bias);
          else
            layer_norm_q<false>(acc, Nl, a.ln_scale, a.ln_bias);
          gn16::store_tile<16>(acc, eout, FWD_ROWS, 0, 0);
        } else if (c0 == 0) {  // wide: the LayerNorm over two passes
#pragma unroll
          for (int i = 0; i < 64; ++i) stash[i * 128] = acc[i];
        } else {
          ln_wide(acc, stash, Nl, a.ln_scale, a.ln_bias, eout);
        }
      }
      gn16::fence_async_smem();
      gn16::wg_sync();
      if (wide) {  // layer l's output is the next one's input
        uint8_t* s = ein;
        ein = eout;
        eout = s;
      }
    }
    // the output: in ein (wide) or in place
    rows_out(ein, a.out + row0 * N, valid, N);
    gn16::wg_sync();  // E is free for the next m-tile
  }
}

// The kernel of the models' chains, or the GENERAL one (outputs over 128
// or streamed weights).
static void (*fwd_kernel(bool general))(const MlpArgs<bf16>) {
  return general ? mlp_chain_fwd_bf16_kernel<true>
                 : mlp_chain_fwd_bf16_kernel<false>;
}

static bool fwd_general(int n, const int* dims) {
  return fwd_streamed(n, dims) || fwd_wide(n, dims);
}

// What a launch would otherwise ask the runtime every time (a MuS rollout
// step launches the forward 92 times), asked once and kept: the current
// device and its SM count, and a kernel's resident blocks an SM by
// (device, instantiation, warpgroups, bytes), its shared-memory limit
// raised to SMEM_LIMIT on that device on the first ask.
static std::mutex cache_mu;

static cudaError_t fwd_sms(int* dev, int* sms) {
  static std::map<int, int> known;
  cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(cache_mu);
  auto it = known.find(*dev);
  if (it == known.end()) {
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, *dev);
    if (err != cudaSuccess) return err;
    it = known.emplace(*dev, *sms).first;
  }
  *sms = it->second;
  return cudaSuccess;
}

static cudaError_t fwd_blocks(int dev, bool general, int g, size_t smem,
                              int* blocks) {
  static std::map<std::tuple<int, bool, int, size_t>, int> known;
  std::lock_guard<std::mutex> lock(cache_mu);
  const auto key = std::make_tuple(dev, general, g, smem);
  auto it = known.find(key);
  if (it == known.end()) {
    const auto kernel = fwd_kernel(general);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                          128 * g, smem);
    if (err != cudaSuccess) return err;
    it = known.emplace(key, *blocks).first;
  }
  *blocks = it->second;
  return cudaSuccess;
}

cudaError_t launch_fwd(const MlpArgs<bf16>& a, cudaStream_t s) {
  int dev = 0, sms = 0, occ = 0;
  cudaError_t err = fwd_sms(&dev, &sms);
  if (err != cudaSuccess) return err;
  const bool streamed = fwd_streamed(a.n, a.dims);
  const bool general = fwd_general(a.n, a.dims);
  const int64_t tiles = (a.rows + FWD_ROWS - 1) / FWD_ROWS;
  // as many warpgroups a block as fit, but no more than spread the m-tiles
  // over every SM
  int g = fwd_fit(a.n, a.dims, streamed);
  const int64_t spread = (tiles + sms - 1) / sms;
  if (spread < g) g = (int)spread;
  const size_t smem = fwd_smem_bytes(a.n, a.dims, streamed, g);
  err = fwd_blocks(dev, general, g, smem, &occ);
  if (err != cudaSuccess) return err;
  int64_t blocks = (tiles + g - 1) / g;
  if (blocks > (int64_t)sms * (occ > 0 ? occ : 1))
    blocks = (int64_t)sms * (occ > 0 ? occ : 1);
  const auto kernel = fwd_kernel(general);
  kernel<<<(unsigned)blocks, 128 * g, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace mlp16
}  // namespace g4c

extern "C" {

// The bf16 chain forward's geometry for widths dims[0..n]: warpgroups a
// block at most, shared-memory bytes at that count, whether the weights
// are streamed, the registers a thread of the kernel that takes the chain
// and its resident blocks an SM at those bytes; returns the CUDA error.
int g4c_mlp_chain_fwd_bf16_geometry(int n, const int* dims, int* warpgroups,
                                    size_t* smem, int* streamed, int* regs,
                                    int* blocks) {
  using namespace g4c::mlp16;
  *streamed = fwd_streamed(n, dims);
  *warpgroups = fwd_fit(n, dims, *streamed != 0);
  *smem = fwd_smem_bytes(n, dims, *streamed != 0, *warpgroups);
  const bool general = fwd_general(n, dims);
  cudaFuncAttributes at;
  cudaError_t err =
      cudaFuncGetAttributes(&at, (const void*)fwd_kernel(general));
  if (err != cudaSuccess) return (int)err;
  *regs = at.numRegs;
  int dev = 0, sms = 0;
  err = fwd_sms(&dev, &sms);
  if (err != cudaSuccess) return (int)err;
  return (int)fwd_blocks(dev, general, *warpgroups, *smem, blocks);
}

}  // extern "C"
