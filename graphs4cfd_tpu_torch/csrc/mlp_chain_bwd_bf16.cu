// The MLP chain's backward tile kernel under the bf16 policy (compute_dtype
// bfloat16), on Hopper's warpgroup products over bf16 tiles in shared
// memory (geometry: mlp_tile_bf16.cuh; wgmma helpers: gn_tile_bf16.cuh).
//
// Replaces, under compute_dtype=bfloat16, the tile part of the TPU kernel
// graphs4cfd_tpu/ops/pallas_mlp.py:_make_bwd_kernel (kernel :88, called
// from _fused_vjp_bwd), as mlp_chain_bwd.cu's tile kernel does in f32: from
// the chain's input x and the cotangent g of its output, the recomputed
// forward ("remat"), the LayerNorm backward, then per layer dh = da W^T
// and SELU', and dx where it is asked for.  It writes the weight
// gradients' per-row operands (xo: the f32 inputs of layers 1..n-1 after
// SELU, and SELU(x) with preact_input; d_op: the bf16 cotangents of the
// layer outputs that are not g) and one row of column sums a tile (db,
// dLN); wgrad_bf16.cu's kernel and gn_reduce_kernel do the rest.
//
// Rounding follows pallas_mlp.py under compute_dtype bfloat16: each
// product's operands rounded to bf16 (nearest even) and summed in f32; the
// biases, SELU, SELU' (from the f32 xo), the LayerNorm backward and the
// column sums in f32 on the accumulators.
//
// Bound on the H100: at the MuS level-1 edge encoder (242,688 rows, 2 ->
// 128 -> 128 -> 128, no dx) the tile kernel's products are about 24 GFLOP
// (0.024 ms at 989 TFLOP/s) against about 0.31 GB of rows (x, g and the
// operands it writes, at their stored widths): 0.09 ms, so bytes bound
// it.  The design it replaces (the f32 96-row tile templated on bf16: f32
// tiles in shared memory, every operand rounded again at each mma.sync
// fragment load, synchronous bf16 row loads, 88 KB of shared memory) ran
// at 15-25 times that.  Here:
//   - a tile is two 64-row m-tiles, one a warpgroup; every product is one
//     wgmma.m64n128k16 per 16 reduction rows (the forward's x W and, with
//     W^T read through the transpose bit of the same slice, the
//     backward's da W^T), the accumulators in registers;
//   - activations are bf16 in shared memory, rounded once where the JAX
//     kernel rounds them; x and g stream in through registers marked first
//     out of L2 (g fetched into L2 as the tile starts); the narrow first
//     layers (K0 = 2-5) are padded with zeros to one k16 step;
//   - the weights are rounded to bf16 once a launch, by a small kernel
//     that writes each 128 x 128 slice as the tile's swizzled image; the
//     tile kernel copies each slice in by 16-byte cp.async, the next one
//     while the current layer's epilogue runs (no registers, half the
//     bytes of f32 slices);
//   - SELU' reads the f32 layer inputs xo from f32 tiles in shared memory
//     that the recomputed forward filled (as many hidden layers as fit:
//     two at the flagship widths); xo leaves for the weight gradients from
//     there in 16-byte stores.  Reading them back from device memory, one
//     block an SM, cost a third of the kernel's time;
//   - the LayerNorm backward runs on the accumulators (a row lies in the
//     four lanes of one quad), g read from the tile;
//   - bf16 rows leave in 16-byte stores through shared memory.
// About 200 KB of shared memory at the flagship widths and up to 255
// registers a thread: one block an SM.  No float atomics: each column sum
// is added in a fixed order (a thread's two rows, the lanes of its warp,
// then the 8 warps in order), so two launches give the same bits.  The
// column sums depend on the tile shape (128 rows here), so the bf16 db and
// dLN may differ from the 96-row design's in the last bits.
#include "mlp_tile_bf16.cuh"

namespace g4c {
namespace mlp16 {

using gn16::bf16;
using mlp::MlpArgs;

extern __shared__ __align__(16) uint8_t smem_mlp16[];

struct Smem {
  uint8_t* e;  // activation tile E, bf16 [128 x 128]
  uint8_t* x;  // input tile [128 x round64(K0)] (E when K0 <= 128)
  uint8_t* w;  // weight slice, bf16 [128 x 128]
  float* cs;   // column-sum scratch, 8 x 128 f32
  float* rs;   // row-sum scratch, 4 x 64 f32
  float* xs;   // f32 xo tiles [xs_tiles][128][XS_LD]: xo[1], xo[2], ...
};

__device__ __forceinline__ Smem layout(int k0) {
  Smem m;
  uint8_t* p =
      smem_mlp16 + ((1024 - (gn16::saddr(smem_mlp16) & 1023)) & 1023);
  m.e = p;
  p += E_BYTES;
  m.x = m.e;
  if (k0 > 128) {
    m.x = p;
    p += (size_t)ROWS * gn16::round64(k0) * 2;
  }
  m.w = p;
  p += gn16::W_BYTES;
  m.cs = reinterpret_cast<float*>(p);
  m.rs = m.cs + 1024;
  p += CS_BYTES;
  m.xs = reinterpret_cast<float*>(p);
  return m;
}

// ---- threads -------------------------------------------------------------
//
// Warpgroup w computes m-tile mt = w / 2 (rows [64 mt, 64 mt + 64) of the
// tile) at columns [64 ch, 64 ch + 64), ch = w % 2: one m64n64k16 wgmma
// per 16 reduction rows, 32 accumulators a thread (element 4j + 2h + b at
// row frow(h), column 64 ch + fcol(j, b)).

__device__ __forceinline__ int mtile() { return threadIdx.x >> 8; }
__device__ __forceinline__ int chalf() { return (threadIdx.x >> 7) & 1; }

// A barrier of the two warpgroups of this thread's m-tile (named barriers
// 5 and 6; 1-4 are the warpgroups').
__device__ __forceinline__ void pair_sync() {
  asm volatile("bar.sync %0, 256;\n" ::"r"(5 + mtile()) : "memory");
}

// ---- the weight slices ---------------------------------------------------

// The chain's weights as bf16 slices: slice s of the launch (layer l's
// rows [128 t, 128 t + 128), its slices in turn, layer by layer) becomes
// the 128 x 128 image the tile stages, in its swizzled layout, zero past
// the layer's rows and columns.  One block (256 threads) a slice.
__global__ void __launch_bounds__(gn16::THREADS)
    mlp_wslices_kernel(const MlpArgs<bf16> a) {
  int l = 0, t = blockIdx.x;
  while (t >= (a.dims[l] + 127) / 128) t -= (a.dims[l++] + 127) / 128;
  const int K = a.dims[l], N = a.dims[l + 1];
  const float* W = a.w[l] + (size_t)t * 128 * N;
  float4 x[16];
  gn16::slice_load(x, W, K - 128 * t < 128 ? K - 128 * t : 128, N);
  gn16::slice_store(a.wimg + (size_t)blockIdx.x * gn16::W_BYTES, x);
}

// The slices the tile kernel uses, in the order it uses them: the
// recomputed forward's layers 0..nf-1 (each of its slices), the backward's
// layers n-1..1, then layer 0's slices again for dx.
struct Schedule {
  unsigned char slice[3 * MAX_LAYERS + 16];
  int count;
};

__device__ __forceinline__ Schedule schedule(const MlpArgs<bf16>& a) {
  Schedule s;
  int base[MAX_LAYERS], b = 0;
  for (int l = 0; l < a.n; ++l) {
    base[l] = b;
    b += (a.dims[l] + 127) / 128;
  }
  const int nf = a.ln_scale != nullptr ? a.n : a.n - 1;
  s.count = 0;
  for (int l = 0; l < nf; ++l)
    for (int t = 0; t < (a.dims[l] + 127) / 128; ++t)
      s.slice[s.count++] = (unsigned char)(base[l] + t);
  for (int l = a.n - 1; l >= 1; --l) s.slice[s.count++] = (unsigned char)base[l];
  if (a.dx != nullptr)
    for (int t = 0; t < (a.dims[0] + 127) / 128; ++t)
      s.slice[s.count++] = (unsigned char)t;
  return s;
}

// Copy slice u of the schedule (if any) into the weight tile by 16-byte
// cp.async, one commit group; every thread calls it once the tile is free.
__device__ __forceinline__ void fetch(const Smem& m, const MlpArgs<bf16>& a,
                                      const Schedule& s, int u) {
  if (u < s.count) {
    const uint8_t* src = a.wimg + (size_t)s.slice[u] * gn16::W_BYTES;
#pragma unroll
    for (int i = 0; i < gn16::W_BYTES / 16 / THREADS; ++i) {
      const int off = (threadIdx.x + i * THREADS) * 16;
      gn16::cp16(m.w + off, src + off, 16);
    }
  }
  tc::cp_commit();
}

// The fetched slice landed and, with every thread's A operands, is visible
// to the products.
__device__ __forceinline__ void landed() {
  tc::cp_wait<0>();
  gn16::fence_async_smem();
  __syncthreads();
}

// Every warpgroup is done with the weight tile (and with E): fetch slice u
// into it.
__device__ __forceinline__ void release(const Smem& m, const MlpArgs<bf16>& a,
                                        const Schedule& s, int u) {
  __syncthreads();
  fetch(m, a, s, u);
}

// ---- rows and columns ----------------------------------------------------

// out[c] (c < N) = the sum over the tile's rows of this thread's values at
// its columns, s[2j + b] its sum over its two rows at column 64 ch +
// fcol(j, b): over the warp's lanes, then the 8 warps that hold a column
// in row order.  Every thread calls it; two barriers.
__device__ __forceinline__ void colsum(float (&s)[16], int N, float* cs,
                                       float* out) {
  const int slot = 4 * mtile() + ((threadIdx.x >> 5) & 3);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    s[i] += __shfl_xor_sync(0xffffffffu, s[i], 4);
    s[i] += __shfl_xor_sync(0xffffffffu, s[i], 8);
    s[i] += __shfl_xor_sync(0xffffffffu, s[i], 16);
  }
  if ((threadIdx.x & 31) < 4)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int b = 0; b < 2; ++b)
        cs[slot * 128 + 64 * chalf() + gn16::fcol(j, b)] = s[2 * j + b];
  __syncthreads();
  for (int c = threadIdx.x; c < N; c += THREADS) {
    float t = 0.f;
    for (int v = 0; v < 8; ++v) t += cs[v * 128 + c];
    out[c] = t;
  }
  __syncthreads();
}

// colsum of d itself.
__device__ __forceinline__ void tile_colsum(const float (&d)[32], int N,
                                            float* cs, float* out) {
  float s[16];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int b = 0; b < 2; ++b) s[2 * j + b] = d[4 * j + b] + d[4 * j + 2 + b];
  colsum(s, N, cs, out);
}

// s0, s1 (this thread's quad-summed parts of rows frow(0), frow(1)) summed
// over the two column halves of its m-tile.  Two pair barriers.
__device__ __forceinline__ void row_sum(float& s0, float& s1, float* rs) {
  const int r = gn16::frow(0), w = gn16::wg_id(), p = w & ~1;
  if ((threadIdx.x & 3) == 0) {
    rs[w * 64 + r] = s0;
    rs[w * 64 + r + 8] = s1;
  }
  pair_sync();
  s0 = rs[p * 64 + r] + rs[(p + 1) * 64 + r];
  s1 = rs[p * 64 + r + 8] + rs[(p + 1) * 64 + r + 8];
  pair_sync();
}

// This thread's elements of the bf16 E rows of its m-tile as f32, zero at
// columns >= N.
__device__ __forceinline__ void tile_to_regs(float (&d)[32],
                                             const uint8_t* e, int N) {
  const int c0 = 64 * chalf();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 64 * mtile() + gn16::frow(h);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = c0 + gn16::fcol(j, 0);
      const uint32_t p =
          *reinterpret_cast<const uint32_t*>(e + gn16::toff(ROWS, r, c));
      d[4 * j + 2 * h] = c < N ? gn16::lo_of(p) : 0.f;
      d[4 * j + 2 * h + 1] = c + 1 < N ? gn16::hi_of(p) : 0.f;
    }
  }
}

// d = bf16(d) into E at this thread's elements, then out[r, c] (row
// stride N) for the m-tile's valid rows in 16-byte stores, by its two
// warpgroups.
__device__ __forceinline__ void rows_out(const float (&d)[32], const Smem& m,
                                         bf16* __restrict__ out, int valid,
                                         int N) {
  const int mt = mtile(), t = threadIdx.x & 255;
  gn16::store_tile<8>(d, m.e, ROWS, mt, 64 * chalf());
  pair_sync();
  if ((N & 7) == 0 && tc::aligned16(out)) {
    const int cpr = N / 8;
    for (int idx = t; idx < valid * cpr; idx += 256) {
      const int r = idx / cpr, c = (idx - r * cpr) * 8;
      *reinterpret_cast<uint4*>(out + (int64_t)r * N + c) =
          *reinterpret_cast<const uint4*>(m.e +
                                          gn16::toff(ROWS, 64 * mt + r, c));
    }
  } else {
    for (int idx = t; idx < valid * N; idx += 256) {
      const int r = idx / N, c = idx - r * N;
      out[(int64_t)r * N + c] = *reinterpret_cast<const bf16*>(
          m.e + gn16::toff(ROWS, 64 * mt + r, c));
    }
  }
}

// d (SELU output, f32) into the f32 xo tile xs at this thread's elements,
// then out[r, c] (row stride N) for the m-tile's valid rows in 16-byte
// stores, by its two warpgroups.
__device__ __forceinline__ void xo_out(const float (&d)[32], float* xs,
                                       float* __restrict__ out, int valid,
                                       int N) {
  const int t = threadIdx.x & 255;
  float* own = xs + 64 * mtile() * XS_LD;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float2*>(own + gn16::frow(h) * XS_LD +
                                 64 * chalf() + gn16::fcol(j, 0)) =
          make_float2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
  pair_sync();
  if ((N & 3) == 0 && tc::aligned16(out)) {
    const int cpr = N / 4;
    for (int idx = t; idx < valid * cpr; idx += 256) {
      const int r = idx / cpr, c = (idx - r * cpr) * 4;
      *reinterpret_cast<float4*>(out + (int64_t)r * N + c) =
          *reinterpret_cast<const float4*>(own + r * XS_LD + c);
    }
  } else {
    for (int idx = t; idx < valid * N; idx += 256) {
      const int r = idx / N, c = idx - r * N;
      out[(int64_t)r * N + c] = own[r * XS_LD + c];
    }
  }
}

// ---- the tile kernel -----------------------------------------------------

__global__ void __launch_bounds__(THREADS, 1)
    mlp_chain_bwd_bf16_kernel(const MlpArgs<bf16> a) {
  const int n = a.n, K0 = a.dims[0], N = a.dims[n];
  const Smem m = layout(K0);
  const int xst = xs_tiles(K0, n);
  const Schedule sched = schedule(a);
  const int64_t row0 = (int64_t)blockIdx.x * ROWS;
  const int valid = a.rows - row0 < ROWS ? (int)(a.rows - row0) : ROWS;
  const int mt = mtile(), ch = chalf(), c0 = 64 * ch;
  const int64_t mrow0 = row0 + 64 * mt;  // this thread's m-tile
  const int mvalid = min(max(valid - 64 * mt, 0), 64);
  float* cs = a.colsum + (size_t)blockIdx.x * a.pc;
  float acc[32];
  int u = 0;  // the schedule's next slice

  fetch(m, a, sched, 0);
  // g into L2 meanwhile (one 128-byte line a thread a step)
  {
    const int lines = (N * 2 + 127) / 128;
    for (int i = threadIdx.x; i < valid * lines; i += THREADS) {
      const int r = i / lines;
      asm volatile("prefetch.global.L2 [%0];\n" ::"l"(
          a.g + (row0 + r) * N + (i - r * lines) * 64));
    }
  }
  // x into its tile (zero past the valid rows and up to 16 columns), by
  // the first two warpgroups
  if (threadIdx.x < gn16::THREADS)
    gn16::load_tile(m.x, ROWS, a.x, row0, valid, ROWS, K0, true);
  if (a.preact) {  // K0 <= 128: x = SELU(x) in place, and xo[0] in f32
    __syncthreads();
    for (int idx = threadIdx.x; idx < valid * K0; idx += THREADS) {
      const int r = idx / K0, c = idx - r * K0;
      bf16* p = reinterpret_cast<bf16*>(m.x + gn16::toff(ROWS, r, c));
      const float h = gn16::selu_nb(__bfloat162float(*p));
      a.xo[0][(row0 + r) * K0 + c] = h;
      *p = __float2bfloat16_rn(h);
    }
  }

  // the recomputed forward: layers 0..n-2, and n-1 for its LayerNorm;
  // each layer's SELU output rounded into E (in place: release() waits for
  // every product of the layer)
  for (int l = 0; l < n; ++l) {
    const int K = a.dims[l], Nl = a.dims[l + 1];
    const bool last = l == n - 1;
    if (last && a.ln_scale == nullptr) break;
    for (int k0 = 0; k0 < K; k0 += 128) {
      const int kc = K - k0 < 128 ? K - k0 : 128;
      landed();
      const uint8_t* A = l == 0 ? m.x : m.e;
      gn16::wg_mm<8, 1>(acc, gn16::saddr(A) + (k0 >> 6) * ROWS * 128, ROWS,
                        mt, gn16::saddr(m.w) + ch * (gn16::W_BYTES / 2),
                        gn16::ksteps(kc), k0 > 0);
      gn16::wg_wait(acc);
      release(m, a, sched, ++u);
    }
    gn16::add_bias<8>(acc, a.b[l], c0, Nl);
    if (last) break;  // acc: the pre-LayerNorm output
    gn16::apply_selu(acc);
    if (l + 1 <= xst)
      xo_out(acc, m.xs + (size_t)l * ROWS * XS_LD, a.xo[l + 1] + mrow0 * Nl,
             mvalid, Nl);
    else
      gn16::store_rows<8>(acc, a.xo[l + 1] + mrow0 * Nl, mvalid, c0, Nl, Nl,
                          false);
    gn16::store_tile<8>(acc, m.e, ROWS, mt, c0);
  }

  // g into E (every warpgroup is done with its last product: release()'s
  // barrier, or none ran), zero past the valid rows
  __syncthreads();
  if (threadIdx.x < gn16::THREADS)
    gn16::load_tile(m.e, ROWS, a.g, row0, valid, ROWS, N, true);
  __syncthreads();
  if (a.ln_scale != nullptr) {
    // acc: the pre-LN rows; da = the LayerNorm backward of g, and the
    // scale and bias gradients' column sums.  Row statistics over both
    // column halves (biased variance, two passes, eps 1e-5).
    const float inv_n = 1.f / (float)N;
    float st[2] = {0.f, 0.f}, mean[2], rstd[2];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (c0 + gn16::fcol(j, i & 1) < N) st[i >> 1] += acc[4 * j + i];
    st[0] = gn16::quad_sum(st[0]);
    st[1] = gn16::quad_sum(st[1]);
    row_sum(st[0], st[1], m.rs);
    mean[0] = st[0] * inv_n;
    mean[1] = st[1] * inv_n;
    st[0] = st[1] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (c0 + gn16::fcol(j, i & 1) < N) {
          const float t = acc[4 * j + i] - mean[i >> 1];
          st[i >> 1] += t * t;
        }
    st[0] = gn16::quad_sum(st[0]);
    st[1] = gn16::quad_sum(st[1]);
    row_sum(st[0], st[1], m.rs);
    rstd[0] = rsqrtf(st[0] * inv_n + LN_EPS);
    rstd[1] = rsqrtf(st[1] * inv_n + LN_EPS);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = c0 + gn16::fcol(j, i & 1);
        acc[4 * j + i] =
            c < N ? (acc[4 * j + i] - mean[i >> 1]) * rstd[i >> 1] : 0.f;
      }
    float g[32];
    tile_to_regs(g, m.e, N);
    float s[16];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int b = 0; b < 2; ++b)
        s[2 * j + b] = g[4 * j + b] * acc[4 * j + b] +
                       g[4 * j + 2 + b] * acc[4 * j + 2 + b];
    colsum(s, N, m.cs, cs + a.cs_ln);  // dscale
    tile_colsum(g, N, m.cs, cs + a.cs_ln + N);  // dbias
    float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int c = c0 + gn16::fcol(j, b);
        const float sc = c < N ? __ldg(a.ln_scale + c) : 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * j + 2 * h + b;
          // rounded as the plain version's g * scale (no fused
          // multiply-add), so that dxh - mean(dxh) is exact for one column
          g[i] = __fmul_rn(g[i], sc);  // dxh
          s1[h] += g[i];
          s2[h] += g[i] * acc[i];
        }
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      s1[h] = gn16::quad_sum(s1[h]);
      s2[h] = gn16::quad_sum(s2[h]);
    }
    row_sum(s1[0], s1[1], m.rs);
    row_sum(s2[0], s2[1], m.rs);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int h = i >> 1, c = c0 + gn16::fcol(j, i & 1);
        acc[4 * j + i] = c < N ? ((g[4 * j + i] - s1[h] * inv_n) -
                                  acc[4 * j + i] * (s2[h] * inv_n)) *
                                     rstd[h]
                               : 0.f;
      }
  } else {
    tile_to_regs(acc, m.e, N);  // da = g
  }

  // backwards through the layers; acc holds da, the cotangent of layer
  // l's output (rows past the valid ones 0), and E its bf16 rounding
  for (int l = n - 1;; --l) {
    const int Nl = a.dims[l + 1];
    tile_colsum(acc, Nl, m.cs, cs + a.cs_b[l]);  // db
    if (a.d_op[l] != nullptr) rows_out(acc, m, a.d_op[l] + mrow0 * Nl,
                                       mvalid, Nl);
    if (l == 0) break;
    const int K = a.dims[l];
    // SELU' reads the m-tile's f32 layer inputs: from their tile, or into
    // L1 meanwhile
    if (l > xst && ch == 0)
      gn16::prefetch_rows(a.xo[l] + mrow0 * K, mvalid, K);
    landed();
    gn16::wg_mm<8, 0>(acc, gn16::saddr(m.e), ROWS, mt,
                      gn16::saddr(m.w) + ch * gn16::VBLOCK_BYTES,
                      gn16::ksteps(Nl), false);
    gn16::wg_wait(acc);
    release(m, a, sched, ++u);
    if (l <= xst)
      gn16::mul_dselu<8>(acc,
                         m.xs + ((size_t)(l - 1) * ROWS + 64 * mt) * XS_LD,
                         mvalid, c0, K, XS_LD);
    else
      gn16::mul_dselu<8>(acc, a.xo[l] + mrow0 * K, mvalid, c0, K);
  }
  // dx = da W0^T (SELU'(x) too with preact), 128 columns at a time
  if (a.dx != nullptr) {
    const int N0 = a.dims[1];
    for (int x0 = 0; x0 < K0; x0 += 128) {
      landed();
      gn16::wg_mm<8, 0>(acc, gn16::saddr(m.e), ROWS, mt,
                        gn16::saddr(m.w) + ch * gn16::VBLOCK_BYTES,
                        gn16::ksteps(N0), false);
      gn16::wg_wait(acc);
      release(m, a, sched, ++u);
      if (a.preact) gn16::mul_dselu<8>(acc, a.xo[0] + mrow0 * K0, mvalid,
                                       x0 + c0, K0);
      gn16::store_rows<8>(acc, a.dx + mrow0 * K0, mvalid, x0 + c0, K0, K0,
                          true);
    }
  }
  tc::cp_wait<0>();
}

cudaError_t launch_bwd_tile(const MlpArgs<bf16>& a, size_t smem,
                            cudaStream_t s) {
  mlp_wslices_kernel<<<weight_slices(a.n, a.dims), gn16::THREADS, 0, s>>>(
      a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(mlp_chain_bwd_bf16_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned grid = (unsigned)((a.rows + ROWS - 1) / ROWS);
  mlp_chain_bwd_bf16_kernel<<<grid, THREADS, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace mlp16
}  // namespace g4c

extern "C" {

// Registers a thread and resident blocks an SM of the bf16 chain backward's
// tile kernel at `smem` bytes of shared memory; returns the CUDA error.
int g4c_mlp_chain_bwd_bf16_occupancy(size_t smem, int* regs, int* blocks) {
  using namespace g4c::mlp16;
  cudaFuncAttributes at;
  cudaError_t err =
      cudaFuncGetAttributes(&at, (const void*)mlp_chain_bwd_bf16_kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = at.numRegs;
  err = cudaFuncSetAttribute(mlp_chain_bwd_bf16_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, mlp_chain_bwd_bf16_kernel, THREADS, smem);
}

}  // extern "C"
