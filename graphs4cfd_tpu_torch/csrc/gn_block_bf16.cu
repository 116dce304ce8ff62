// Fused fixed-k GN block under the bf16 policy (compute_dtype bfloat16):
// the forward and the backward's tile kernel, on Hopper's warpgroup
// products (wgmma) over bf16 tiles in shared memory (gn_tile_bf16.cuh).
//
// Replaces, under compute_dtype=bfloat16, the TPU kernels that gn_block.cu
// and gn_block_bwd.cu replace in f32: the forward of
// ops/pallas_gnblock.py:gn_block_fused_wg (kernel :517), gn_block_fused
// (kernel :132) and ops/pallas_edgemp.py:edge_mp_folded (kernel :112),
// and the tile part of their VJPs _gn_wg_vjp_bwd (kernel :556),
// _gn_vjp_bwd (kernel :152) and _edgemp_fold_vjp_bwd (kernel :151).  The
// wrappers reach them through g4c_gn_block and g4c_gn_block_bwd with
// is_bf16 set; the backward's weight gradients are wgrad_bf16.cu's, its
// reduction wgrad.cu's, its dvs the sorted segment sum.
//
// Bounds on the H100 (MuS level 1, V=40448, k=6, H=128): the forward's
// products are 30.5 GFLOP (0.031 ms at 989 TFLOP/s) against 0.16 GB of
// bf16 traffic (0.047 ms), so bytes bound it; the backward tile kernel's
// 91.5 GFLOP (0.093 ms) bound it.  The mma.sync design these kernels
// replace (the f32 tile templated on bf16: f32 tiles in shared memory,
// every operand rounded again at each fragment load, synchronous bf16 row
// loads, 16-row node tiles) ran at 20-70 times those bounds.  Here:
//   - operands are bf16 in shared memory, rounded once where the JAX
//     kernels round them, in wgmma's swizzled layout (no bank conflicts,
//     no per-fragment conversion);
//   - every product is a wgmma on a 64-row tile: the edge side 64 x 128
//     per warpgroup, the node side 64 receivers (in place of 16) as two
//     64 x 64 halves;
//   - the e and v rows stream in marked first out of L2, so that the
//     gathered table and the weights stay there; the sender rows load by
//     index (cp.async) while the first edge layer's products run;
//   - bias, SELU, LayerNorm and SELU' run on the f32 accumulators, as the
//     plain version computes them (SELU through expm1f with no branch; a
//     faster exp - 1 moved the bf16 REMuS step past its gate); a layer's
//     output is rounded once into the next product's tile;
//   - bf16 rows leave in 16-byte stores through shared memory.
// One block (two warpgroups, 256 threads) per SM: about 200 KB of shared
// memory at the flagship widths (64 receivers, 384 edge rows), and the
// registers (255 a thread) bound what a thread keeps in flight: loading
// the next weight slice behind the products spilled and ran slower.
//
// The backward tile kernel recomputes the forward, writing SELU's f32
// inputs (xe, xn, read back for SELU') and the edge chain's f32
// pre-LayerNorm output (read back by the edge LayerNorm's backward, which
// runs one warp per receiver after the node chain's backward has given
// daggr), then runs both chains backwards with dh = da W^T through the
// same staged weight slices.  It writes what the f32 tile kernel writes
// (de, dv, dh1, the weight gradients' operands, the tiles' column sums),
// each column sum in a fixed order; dvr = sum_k dh1 is summed in f32 in
// each receiver's row order, as the mean over k is in the forward.  No
// float atomics: two launches give the same bits.
#include "gn_tile_bf16.cuh"

namespace g4c {
namespace gn16 {

extern __shared__ __align__(16) uint8_t smem16[];

// ---- column sums ---------------------------------------------------------

// out[c] = the sum over the 64 node rows of d at column c < N (this
// warpgroup's 64 columns; rows past the valid ones hold 0), in a fixed
// order.  Two barriers.
__device__ __forceinline__ void node_colsum(const float (&d)[32], int N,
                                            float* cs, float* out) {
  const int w = (threadIdx.x >> 5) & 3, c0 = 64 * wg_id();
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      float s = d[4 * j + b] + d[4 * j + 2 + b];
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      if ((threadIdx.x & 31) < 4) cs[w * 128 + c0 + fcol(j, b)] = s;
    }
  __syncthreads();
  for (int c = threadIdx.x; c < N; c += THREADS)
    out[c] = ((cs[c] + cs[128 + c]) + cs[256 + c]) + cs[384 + c];
  __syncthreads();
}

// v summed over the warp's lanes, RB values at once (their shuffle chains
// interleaved).
template <int RB>
__device__ __forceinline__ void warp_sums(float (&v)[RB]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int j = 0; j < RB; ++j) v[j] += __shfl_xor_sync(0xffffffffu, v[j], o);
}

// gn::ln_out_bwd for RB rows of one receiver at once (a lane on columns
// gn::row_col(i)): x the pre-LayerNorm rows, g their output cotangents
// (rows j >= valid ignored), ad the receiver's daggr / k row (added after
// the output SELU); dx the cotangents of x; the scale and bias gradients'
// shares to c1, c2.  sc, bi: the lane's LayerNorm scale and bias (bias read
// only if selu_out).
template <int RB>
__device__ __forceinline__ void ln_rows_bwd(const float (&x)[RB][4],
                                            float (&g)[RB][4],
                                            const float (&ad)[4], int valid,
                                            int N, const float (&sc)[4],
                                            const float (&bi)[4],
                                            bool selu_out, float (&c1)[4],
                                            float (&c2)[4],
                                            float (&dx)[RB][4]) {
  const float inv_n = 1.f / (float)N;
  float mean[RB], rstd[RB], s1[RB], s2[RB];
#pragma unroll
  for (int j = 0; j < RB; ++j) mean[j] = x[j][0] + x[j][1] + x[j][2] + x[j][3];
  warp_sums<RB>(mean);
#pragma unroll
  for (int j = 0; j < RB; ++j) {
    mean[j] *= inv_n;
    rstd[j] = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (gn::row_col(i) < N) {
        const float t = x[j][i] - mean[j];
        rstd[j] += t * t;
      }
  }
  warp_sums<RB>(rstd);
  float xh[RB][4];
#pragma unroll
  for (int j = 0; j < RB; ++j) {
    rstd[j] = rsqrtf(rstd[j] * inv_n + LN_EPS);
    s1[j] = s2[j] = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool in = gn::row_col(i) < N;
      xh[j][i] = in ? (x[j][i] - mean[j]) * rstd[j] : 0.f;
      float gi = g[j][i];
      if (selu_out && in) gi *= dselu_nb(xh[j][i] * sc[i] + bi[i]);
      gi += ad[i];
      if (j < valid) {
        c1[i] += gi * xh[j][i];
        c2[i] += gi;
      }
      g[j][i] = gi * sc[i];  // dxh
      s1[j] += g[j][i];
      s2[j] += g[j][i] * xh[j][i];
    }
  }
  warp_sums<RB>(s1);
  warp_sums<RB>(s2);
#pragma unroll
  for (int j = 0; j < RB; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      dx[j][i] = gn::row_col(i) < N ? (g[j][i] - s1[j] * inv_n -
                                       xh[j][i] * s2[j] * inv_n) *
                                          rstd[j]
                                    : 0.f;
}

// ---- the kernels ---------------------------------------------------------

__global__ void __launch_bounds__(THREADS, 1)
    gn_block_bf16_kernel(const GnArgs<bf16> a) {
  const Smem m = layout(a, smem16);
  const int64_t n0 = (int64_t)blockIdx.x * a.npb;
  const int nv = a.V - n0 < a.npb ? (int)(a.V - n0) : a.npb;
  float d[32];
  forward<false>(a, m, n0, nv, d);
  // v_new = LayerNorm(v_pre), then SELU if out_selu
  const int Hn = a.nd[a.nn], c0 = 64 * wg_id();
  if (a.nln_scale != nullptr)
    layer_norm<8>(d, c0, Hn, a.nln_scale, a.nln_bias, m.rs);
  store_rows<8>(d, a.v_out + n0 * Hn, nv, c0, Hn, Hn, true, a.out_selu != 0);
}

__global__ void __launch_bounds__(THREADS, 1)
    gn_block_bwd_bf16_kernel(const GnArgs<bf16> a) {
  const Smem m = layout(a, smem16);
  const int64_t n0 = (int64_t)blockIdx.x * a.npb;
  const int nv = a.V - n0 < a.npb ? (int)(a.V - n0) : a.npb;
  const int k = a.k, er = a.er, emt = er / 64, phases = (emt + 1) / 2;
  const int64_t e0 = n0 * k;
  const int ev = nv * k;
  const int H1 = a.ed[1], He = a.ed[a.ne], Hn1 = a.nd[1], Hn = a.nd[a.nn];
  const int wg = wg_id(), c0 = 64 * wg;
  float* cs = a.colsum + (size_t)blockIdx.x * a.pc;
  float d[32];

  forward<true>(a, m, n0, nv, d);  // d: v_pre

  // ---- node LayerNorm and output SELU backward, on the accumulators ----
  {
    float g[32];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = frow(h);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const int c = c0 + fcol(j, b);
          g[4 * j + 2 * h + b] =
              r < nv && c < Hn ? __bfloat162float(a.gv[(n0 + r) * Hn + c])
                               : 0.f;
        }
    }
    if (a.nln_scale == nullptr) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = c0 + fcol(j, i & 1);
          const float gi = g[4 * j + i];
          d[4 * j + i] =
              a.out_selu && c < Hn ? gi * dselu_nb(d[4 * j + i]) : gi;
        }
    } else {
      float mean[2], rstd[2], c1[32], c2[32], s1[2] = {0.f, 0.f},
                                              s2[2] = {0.f, 0.f};
      row_stats<8>(d, c0, Hn, m.rs, mean, rstd);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const int c = c0 + fcol(j, b);
          const float sc = c < Hn ? __ldg(a.nln_scale + c) : 0.f;
          const float bi = c < Hn && a.out_selu ? __ldg(a.nln_bias + c) : 0.f;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = 4 * j + 2 * h + b;
            const float xh = c < Hn ? (d[i] - mean[h]) * rstd[h] : 0.f;
            float gi = g[i];
            if (a.out_selu && c < Hn) gi *= dselu_nb(xh * sc + bi);
            c1[i] = gi * xh;
            c2[i] = gi;
            const float dxh = gi * sc;
            s1[h] += dxh;
            s2[h] += dxh * xh;
            d[i] = xh;
            g[i] = dxh;
          }
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        s1[h] = quad_sum(s1[h]);
        s2[h] = quad_sum(s2[h]);
      }
      xwg_sum(s1[0], s1[1], m.rs);
      xwg_sum(s2[0], s2[1], m.rs);
      const float inv_n = 1.f / (float)Hn;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int h = i >> 1, c = c0 + fcol(j, i & 1);
          d[4 * j + i] = c < Hn ? (g[4 * j + i] - s1[h] * inv_n -
                                   d[4 * j + i] * s2[h] * inv_n) *
                                      rstd[h]
                                : 0.f;
        }
      node_colsum(c1, Hn, m.cs, cs + a.cs_nln);
      node_colsum(c2, Hn, m.cs, cs + a.cs_nln + Hn);
    }
  }

  // ---- node chain backward; d holds the cotangent of layer l's output ----
  for (int l = a.nn - 1; l >= 0; --l) {
    const int N = a.nd[l + 1];
    store_rows<8>(d, a.dn_op[l] + n0 * N, nv, c0, N, N, false);
    node_colsum(d, N, m.cs, cs + a.cs_nb[l]);
    store_tile<8>(d, m.na, 64, 0, c0);  // NA = bf16(d); at l = 0, dhn
    if (l == 0) break;
    const int K = a.nd[l];
    node_mm_t(d, m, m.na, a.nw[l], K, N, false);
    mul_dselu<8>(d, a.xn[l] + n0 * K, nv, c0, K);
  }
  // daggr / k = (dhn Wa^T) / k into NF (vr and aggr are dead)
  {
    float t[32];
    node_mm_t(t, m, m.na, a.nw[0], He, Hn1, false);
    const float inv_k = 1.f / (float)k;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = frow(h);
      if (r < a.npb)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<float2*>(m.nf + r * LDN + c0 + fcol(j, 0)) =
              make_float2(t[4 * j + 2 * h] * inv_k,
                          t[4 * j + 2 * h + 1] * inv_k);
    }
  }
  __syncthreads();

  // ---- edge LayerNorm and output SELU backward, one warp per receiver:
  // e_pre (f32, written by the forward) and ge from device memory, daggr / k
  // from NF; the result into E (bf16) and the cotangent operand of the
  // last edge layer.  A receiver's rows go RB at a time: their loads in
  // flight together, their reductions interleaved ----
  {
    constexpr int RB = 6;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    float c1[4] = {0.f, 0.f, 0.f, 0.f}, c2[4] = {0.f, 0.f, 0.f, 0.f},
          c3[4] = {0.f, 0.f, 0.f, 0.f};
    float sc[4] = {1.f, 1.f, 1.f, 1.f}, bi[4] = {0.f, 0.f, 0.f, 0.f};
    if (a.eln_scale != nullptr) {
      gn::load_row(sc, a.eln_scale, He);
      gn::load_row(bi, a.eln_bias, He);
    }
    const bool selu_out = a.ge != nullptr && a.out_selu;
    bf16* dop = a.de_op[a.ne - 1];
    for (int r = warp; r < a.npb; r += tc::WARPS)
      for (int j0 = 0; j0 < k; j0 += RB) {
        const int valid = r < nv ? (k - j0 < RB ? k - j0 : RB) : 0;
        float xr[RB][4], gg[RB][4], ad[4], dx[RB][4];
#pragma unroll
        for (int j = 0; j < RB; ++j) {
          const int qr = r * k + j0 + j;
#pragma unroll
          for (int i = 0; i < 4; ++i) xr[j][i] = gg[j][i] = 0.f;
          if (j < valid) {
            gn::load_row(xr[j], a.epre + (e0 + qr) * He, He);
            if (a.ge != nullptr)
              gn::load_row(gg[j], a.ge + (e0 + qr) * He, He);
          }
        }
        gn::load_row(ad, m.nf + r * LDN, He);
        if (a.eln_scale != nullptr) {
          ln_rows_bwd<RB>(xr, gg, ad, valid, He, sc, bi, selu_out, c1, c2,
                          dx);
        } else {
#pragma unroll
          for (int j = 0; j < RB; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              dx[j][i] = (selu_out && gn::row_col(i) < He
                              ? gg[j][i] * dselu_nb(xr[j][i])
                              : gg[j][i]) +
                         ad[i];
        }
#pragma unroll
        for (int j = 0; j < RB; ++j) {
          if (j0 + j >= k) break;
          const int qr = r * k + j0 + j;
          if (j < valid) {
            gn::store_row(dop + (e0 + qr) * He, dx[j], He);
#pragma unroll
            for (int i = 0; i < 4; ++i) c3[i] += dx[j][i];
          } else {
#pragma unroll
            for (int i = 0; i < 4; ++i) dx[j][i] = 0.f;
          }
          *reinterpret_cast<uint2*>(m.e + toff(er, qr, 4 * lane)) =
              make_uint2(pack(dx[j][0], dx[j][1]), pack(dx[j][2], dx[j][3]));
        }
      }
    for (int qr = a.npb * k + warp; qr < er; qr += tc::WARPS)
      *reinterpret_cast<uint2*>(m.e + toff(er, qr, 4 * lane)) =
          make_uint2(0u, 0u);
    if (a.eln_scale != nullptr) {
      gn::colsum_out(c1, He, m.cs, cs + a.cs_eln);
      gn::colsum_out(c2, He, m.cs, cs + a.cs_eln + He);
    }
    gn::colsum_out(c3, He, m.cs, cs + a.cs_eb[a.ne - 1]);
  }

  // ---- edge chain backward: E holds the cotangent of layer l's output ----
  for (int l = a.ne - 1; l >= 1; --l) {
    const int K = a.ed[l], N = a.ed[l + 1];
    const bool first = l == 1;  // this step gives dh1
    if (first) zero_nf(m.nf, a.npb);  // dvr sums; daggr is dead
    {
      float4 x[16];
      slice_load(x, a.ew[l], K, N);
      stage_x(m, x);
    }
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    for (int p = 0; p < phases; ++p) {
      const int mt = 2 * p + wg;
      const bool has = mt < emt;
      const int valid = ev - mt * 64;
      float acc[64];
      // SELU' reads the m-tile's f32 layer inputs: into L1 meanwhile
      if (has) prefetch_rows(a.xe[l - 1] + (e0 + mt * 64) * K, valid, K);
      wg_mm<16, 0>(acc, saddr(m.e), er, has ? mt : 0, saddr(m.w), ksteps(N),
                   false);  // every warpgroup (forward(), the edge chain)
      wg_wait(acc);
      if (has) {
        mul_dselu<16>(acc, a.xe[l - 1] + (e0 + mt * 64) * K, valid, 0, K);
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int b = 0; b < 2; ++b)
            s[2 * j + b] += acc[4 * j + b] + acc[4 * j + 2 + b];
        // bf16(D): the next product's operand in E, and from there the
        // cotangent operand (dh1 at the first layer) in 16-byte stores
        store_tile<16>(acc, m.e, er, mt, 0);
        wg_sync();
        tile_rows_out(m.e, er, mt,
                      (first ? a.dh1 : a.de_op[l - 1]) + (e0 + mt * 64) * K,
                      valid, K, false);
      }
      // dvr = sum_k dh1, in f32, in each receiver's row order
      if (first) rounds_add(acc, has, mt, ev, k, m.nf);
    }
    edge_colsum(s, K, m.cs, cs + a.cs_eb[l - 1]);
  }

  // ---- de = dh1 We^T ----
  {
    float4 x[16];
    slice_load(x, a.ew[0], a.fe, H1);
    stage_x(m, x);
  }
  for (int p = 0; p < phases; ++p) {
    const int mt = 2 * p + wg;
    float acc[64];
    wg_mm<16, 0>(acc, saddr(m.e), er, mt < emt ? mt : 0, saddr(m.w),
                 ksteps(H1), false);
    wg_wait(acc);
    if (mt >= emt) continue;
    // de through the m-tile's rows of E (its dh1 is no longer needed)
    store_tile<16>(acc, m.e, er, mt, 0);
    wg_sync();
    tile_rows_out(m.e, er, mt, a.de + (e0 + mt * 64) * a.fe, ev - mt * 64,
                  a.fe, true);
  }
  __syncthreads();  // E (dh1) is dead: its first 16 KB take the dvr tile

  // dvr into a 64-row bf16 tile at E and to device memory (bf16)
  node_tile_from(m.e, m.nf, 1.f, nv, H1, a.dvr + n0 * H1);
  // dv = dhn Wv^T + dvr Wr^T, 128 columns at a time
  for (int v0 = 0; v0 < a.fv; v0 += 128) {
    const int cw = a.fv - v0 < 128 ? a.fv - v0 : 128;
    float t[32];
    node_mm_t(t, m, m.na, a.nw[0] + (size_t)(He + v0) * Hn1, cw, Hn1, false);
    node_mm_t(t, m, m.e, a.ew[0] + (size_t)(a.fe + a.fs + v0) * H1, cw, H1,
              true);
    store_rows<8>(t, a.dv + n0 * a.fv + v0, nv, c0, cw, a.fv, true);
  }
}

cudaError_t launch_fwd(const GnArgs<bf16>& a, size_t smem, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      gn_block_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned grid = (unsigned)((a.V + a.npb - 1) / a.npb);
  gn_block_bf16_kernel<<<grid, THREADS, smem, s>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_bwd_tile(const GnArgs<bf16>& a, size_t smem,
                            cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      gn_block_bwd_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned grid = (unsigned)((a.V + a.npb - 1) / a.npb);
  gn_block_bwd_bf16_kernel<<<grid, THREADS, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace gn16
}  // namespace g4c

extern "C" {

// Registers per thread and resident blocks per SM of the bf16 forward
// (bwd 0) or backward tile kernel (bwd 1) at `smem` bytes of shared
// memory; returns the CUDA error.
int g4c_gn_bf16_occupancy(int bwd, size_t smem, int* regs, int* blocks) {
  using namespace g4c::gn16;
  const void* f = bwd ? (const void*)gn_block_bwd_bf16_kernel
                      : (const void*)gn_block_bf16_kernel;
  cudaFuncAttributes at;
  cudaError_t err = cudaFuncGetAttributes(&at, f);
  if (err != cudaSuccess) return (int)err;
  *regs = at.numRegs;
  err = cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, f, THREADS,
                                                            smem);
}

}  // extern "C"
