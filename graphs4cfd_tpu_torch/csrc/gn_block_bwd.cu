// Fused fixed-k GN block, backward, with the sender gather inside.
//
// Replaces the TPU kernel graphs4cfd_tpu/ops/pallas_gnblock.py:
// _make_bwd_kernel_wg (called from _gn_wg_vjp_bwd) and computes its math
// (pallas_gnblock.py:639-709).  The forward of gn_block.cu is recomputed
// per tile ("remat"), then, with gv, ge the cotangents of v', e' (ge null
// when e' was not stored):
//
//   gv *= SELU'(v_new), ge *= SELU'(e_new)             if out_selu
//   node LayerNorm and chain backward                  -> dhn, node dW/db
//   dWa = aggr^T dhn, dWv = v^T dhn, daggr = dhn Wa^T
//   de_new = ge + repeat_k(daggr / k)       (aggregation read e' pre-SELU)
//   edge LayerNorm and chain backward                  -> dh1, edge dW/db
//   dWe = e^T dh1, dvr = sum_k dh1, dWr = v^T dvr
//   de = dh1 We^T, dv = dhn Wv^T + dvr Wr^T, and dh1 itself [E, H1]
//
// dh1 goes out per edge row; ops.segment.sorted_segment_sum then sums it
// per sender in sorted order (csrc/sorted_segment_sum.cu) into dvs, the
// cotangent of vs = v @ Ws.  The rows of dW1 that belong to Ws are zero:
// vs is computed outside, and autograd gives Ws its gradient from dvs.
// vs has S rows (the node set, or the finer level's edges in REMuS's
// down_edge_mp); as in the forward, a sender outside [0, S) makes its edge
// row NaN in the recomputed forward, so its receiver's gradient rows (and
// the weight gradients) come out NaN, and the table is never read outside.
//
// The same kernels are the backward of the REMuS line-graph GN blocks: of
// ops/pallas_edgemp.py:_make_bwd_kernel_fold (entry _edgemp_fold_vjp_bwd),
// one EdgeMP layer, whose d_tab is dvs summed over angle_src, and of
// ops/pallas_gnblock.py:_make_bwd_kernel (entry _gn_vjp_bwd), down_edge_mp,
// whose dvsg summed per fine edge is dvs.
//
// Bounds on the H100 (V=40448, k=6, H=128, f32): the recomputed forward
// (30.5 GFLOP) and two products per forward product, 91.5 GFLOP in all,
// against 0.5 GB of traffic (each input read once, each output written
// once).  On the f32 CUDA cores (67 TFLOP/s) that is 1.365 ms; on the
// tensor cores, at three TF32 operations per 3xTF32 product (495
// TFLOP/s), 0.555 ms.
//
// Design, in three launches (one kernel of the port's table), and what it
// does about the limits of the first, SIMT version (11.85 ms at MuS level
// 1, where each 96-edge tile added its share of every dW, db and dLN into
// its block's 595 KB partial in device memory: 1.5 GB read and 1.5 GB
// written per launch, through an L2 the partials did not fit):
//   1. gn_block_bwd_kernel, one block per tile of receivers (gn_tile.cuh):
//      the remat forward and the chains backwards for the activation
//      cotangents (de, dv, dh1), every product on the tensor cores
//      (3xTF32 mma.sync, mma_tf32x3.cuh).  One edge tile holds each
//      layer's activations or cotangents in turn; SELU' comes from the
//      layer inputs the forward wrote to device memory (read back from
//      L2).  The tile writes, once, the weight gradients' per-row operands
//      that no output carries already: the input (after SELU) and the
//      output cotangent of edge layers 2..ne and node layers 1..nn, and
//      dvr = sum_k dh1; and its column sums (db, dLN) as one partial row.
//      104 KB of shared memory (112 KB at fv = 256): two blocks per SM.
//   2. gn_wgrad_kernel: every dW = X^T D as a split over fixed chunks of
//      2048 rows; a block owns (product, chunk, 128-row slice of K), keeps
//      its 128 x N sums in registers over the chunk (3xTF32 on the tensor
//      cores, X and D through a three-stage cp.async ring) and writes its
//      partial once.  dWe = e^T dh1, dWr = v^T dvr, dWa = aggr^T dhn and
//      dWv = v^T dhn read e, v and dh1 as they are.  At MuS level 1 the
//      operands are about 0.64 GB, written once and read once.
//   3. gn_reduce_kernel: the chunk partials and the tiles' column sums,
//      each summed in a fixed order.
// No float atomics: two launches give the same bits.
//
// Widths as in gn_block.cu: the node input fv may be up to 256 (gMuS's
// mp121 and mp221), every other width at most 128; dv [V, fv] is computed
// and stored 128 columns at a time, and dWr, dWv in 128-row slices of K.
#include "gn_tile.cuh"

namespace g4c {
namespace gn {

constexpr int WG_CHUNK = 2048;  // rows of one weight-gradient partial
constexpr int WG_RS = 32;       // rows per ring stage
constexpr int WG_STAGES = 3;
constexpr int WG_LD = 136;      // 8 mod 16: conflict-free X^T and D reads
constexpr int WG_STAGE = 2 * WG_RS * WG_LD;
constexpr int MAX_PRODS = 2 * MAX_LAYERS + 2;
constexpr int MAX_SEGS = MAX_PRODS + 2 * MAX_LAYERS + 4;

struct WgProd {
  const float* x;  // [rows, K]
  const float* d;  // [rows, N]
  float* part;     // [chunks][K][N]
  int64_t rows;
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

// The backward of a row's LayerNorm (scale, bias; none if scale is null)
// and output SELU (if `selu_out`): x is the pre-LN row, g the cotangent of
// the output, plus add[c] (a shared-memory row, if not null) after the
// SELU; dx the cotangent of x.  The scale and bias gradients' shares go to
// c1 (g * xhat) and c2 (g).
__device__ __forceinline__ void ln_out_bwd(const float (&x)[4], float (&g)[4],
                                           int N, const float* scale,
                                           const float* bias, bool selu_out,
                                           const float* add, float (&c1)[4],
                                           float (&c2)[4], float (&dx)[4]) {
  float ad[4] = {0.f, 0.f, 0.f, 0.f};
  if (add != nullptr) load_row(ad, add, N);
  if (scale == nullptr) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      dx[i] = (selu_out && row_col(i) < N ? g[i] * dselu(x[i]) : g[i]) + ad[i];
    return;
  }
  float mean, rstd, sc[4], bi[4], xh[4], dxh[4], s1 = 0.f, s2 = 0.f;
  row_stats(x, N, mean, rstd);
  load_row(sc, scale, N);
  load_row(bi, bias, N);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    xh[i] = row_col(i) < N ? (x[i] - mean) * rstd : 0.f;
    if (selu_out && row_col(i) < N) g[i] *= dselu(xh[i] * sc[i] + bi[i]);
    g[i] += ad[i];
    c1[i] += g[i] * xh[i];
    c2[i] += g[i];
    dxh[i] = g[i] * sc[i];
    s1 += dxh[i];
    s2 += dxh[i] * xh[i];
  }
  const float inv_n = 1.f / (float)N;
  const float m1 = warp_sum(s1) * inv_n, m2 = warp_sum(s2) * inv_n;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    dx[i] = row_col(i) < N ? (dxh[i] - m1 - xh[i] * m2) * rstd : 0.f;
}

__global__ void __launch_bounds__(THREADS, 2)
    gn_block_bwd_kernel(const GnArgs a) {
  extern __shared__ float smem[];
  const Smem m = smem_layout(a, smem);
  const int64_t n0 = (int64_t)blockIdx.x * a.npb;
  const int nv = a.V - n0 < a.npb ? (int)(a.V - n0) : a.npb;
  const int k = a.k, lda = a.lda, emt = a.emt;
  const int64_t e0 = n0 * k;
  const int ev = nv * k;
  const int H1 = a.ed[1], He = a.ed[a.ne];
  const int Hn1 = a.nd[1], Hn = a.nd[a.nn];
  const int warp = threadIdx.x >> 5;
  float* cs = a.colsum + (size_t)blockIdx.x * a.pc;
  float* scratch = m.ring;

  gn_forward<true>(a, m, n0, nv);

  // ---- node LayerNorm and output SELU backward; N1 holds v_pre ----
  {
    float c1[4] = {0.f, 0.f, 0.f, 0.f}, c2[4] = {0.f, 0.f, 0.f, 0.f};
    for (int r = warp; r < NR; r += tc::WARPS) {
      float dx[4] = {0.f, 0.f, 0.f, 0.f};
      if (r < nv) {
        float x[4], g[4];
        load_row(x, m.N1 + r * lda, Hn);
        load_row(g, a.gv + (n0 + r) * Hn, Hn);
        ln_out_bwd(x, g, Hn, a.nln_scale, a.nln_bias, a.out_selu, nullptr,
                   c1, c2, dx);
      }
      store_row(m.N1 + r * lda, dx, round8(Hn));
    }
    if (a.nln_scale != nullptr) {
      colsum_out(c1, Hn, scratch, cs + a.cs_nln);
      colsum_out(c2, Hn, scratch, cs + a.cs_nln + Hn);
    } else {
      __syncthreads();
    }
  }

  // ---- node chain backward ----
  for (int l = a.nn - 1; l >= 1; --l) {
    const int K = a.nd[l], N = a.nd[l + 1];
    copy_rows(m.N1, lda, nv, N, a.dn_op[l], n0, scratch, cs + a.cs_nb[l],
              true);
    Acc<NodeL> nacc;
    tc::zero(nacc);
    mm_t<NodeL>(nacc, m.N1, lda, 1, a.nw[l], K, N, m.ring);
    mul_dselu<NodeL>(nacc, a.xn[l] + n0 * K, nv, K);
    store_tile<NodeL>(nacc, m.N1, lda, K, 1);
  }
  // N1 = dhn, the cotangent of the first node layer's pre-activation
  copy_rows(m.N1, lda, nv, Hn1, a.dn_op[0], n0, scratch, cs + a.cs_nb[0],
            true);
  {
    Acc<NodeL> nacc;
    tc::zero(nacc);
    mm_t<NodeL>(nacc, m.N1, lda, 1, a.nw[0], He, Hn1, m.ring);
    const float inv_k = 1.f / (float)k;
#pragma unroll
    for (int j = 0; j < NodeL::NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) nacc[0][j][q] *= inv_k;
    store_tile<NodeL>(nacc, m.N2, lda, He, 1);  // daggr / k
  }
  __syncthreads();

  // ---- edge LayerNorm and output SELU backward; E holds e_pre ----
  {
    float c1[4] = {0.f, 0.f, 0.f, 0.f}, c2[4] = {0.f, 0.f, 0.f, 0.f};
    for (int q = warp; q < emt * 16; q += tc::WARPS) {
      float dx[4] = {0.f, 0.f, 0.f, 0.f};
      if (q < ev) {
        float x[4], g[4] = {0.f, 0.f, 0.f, 0.f};
        load_row(x, m.E + q * lda, He);
        if (a.ge != nullptr) load_row(g, a.ge + (e0 + q) * He, He);
        ln_out_bwd(x, g, He, a.eln_scale, a.eln_bias,
                   a.ge != nullptr && a.out_selu, m.N2 + (q / k) * lda, c1,
                   c2, dx);
      }
      store_row(m.E + q * lda, dx, round8(He));
    }
    if (a.eln_scale != nullptr) {
      colsum_out(c1, He, scratch, cs + a.cs_eln);
      colsum_out(c2, He, scratch, cs + a.cs_eln + He);
    } else {
      __syncthreads();
    }
  }

  // ---- edge chain backward ----
  for (int l = a.ne - 1; l >= 1; --l) {
    const int K = a.ed[l], N = a.ed[l + 1];
    copy_rows(m.E, lda, ev, N, a.de_op[l], e0, scratch, cs + a.cs_eb[l],
              true);
    Acc<EdgeL> acc;
    tc::zero(acc);
    mm_t<EdgeL>(acc, m.E, lda, emt, a.ew[l], K, N, m.ring);
    mul_dselu<EdgeL>(acc, a.xe[l - 1] + e0 * K, ev, K);
    store_tile<EdgeL>(acc, m.E, lda, K, emt);
  }
  // E = dh1, the cotangent of the first edge layer's pre-activation
  copy_rows(m.E, lda, ev, H1, a.dh1, e0, scratch, cs + a.cs_eb[0], true);
  // dvr = sum over each receiver's k rows of dh1, in order, into N2 (daggr
  // is dead) and device memory
  for (int r = warp; r < NR; r += tc::WARPS) {
    float sum[4] = {0.f, 0.f, 0.f, 0.f};
    if (r < nv)
      for (int j = 0; j < k; ++j) {
        float x[4];
        load_row(x, m.E + (r * k + j) * lda, H1);
#pragma unroll
        for (int i = 0; i < 4; ++i) sum[i] += x[i];
      }
    store_row(m.N2 + r * lda, sum, round8(H1));
    if (r < nv) store_row(a.dvr + (n0 + r) * H1, sum, H1, true);
  }
  {
    Acc<EdgeL> acc;  // de = dh1 We^T
    tc::zero(acc);
    mm_t<EdgeL>(acc, m.E, lda, emt, a.ew[0], a.fe, H1, m.ring);
    store_out<EdgeL>(acc, a.de, e0, ev, a.fe, a.fe);
  }
  // dv = dhn Wv^T + dvr Wr^T, 128 columns at a time
  for (int c0 = 0; c0 < a.fv; c0 += 128) {
    const int cw = min(128, a.fv - c0);
    Acc<NodeL> nacc;
    tc::zero(nacc);
    mm_t<NodeL>(nacc, m.N1, lda, 1, a.nw[0] + (size_t)(He + c0) * Hn1, cw,
                Hn1, m.ring);
    mm_t<NodeL>(nacc, m.N2, lda, 1,
                a.ew[0] + (size_t)(a.fe + a.fs + c0) * H1, cw, H1, m.ring);
    store_out<NodeL>(nacc, a.dv + c0, n0, nv, cw, a.fv);
  }
}

// part[chunk][kb + r][c] = sum over the chunk's rows of x[row][kb + r] *
// d[row][c], for one (product, chunk, 128-row slice of K) per block.
__global__ void __launch_bounds__(THREADS, 2)
    gn_wgrad_kernel(const WgArgs a) {
  extern __shared__ float smem[];
  int pi = 0;
  while (pi + 1 < a.np && (int)blockIdx.x >= a.p[pi + 1].first) ++pi;
  const float* x = a.p[pi].x;
  const float* d = a.p[pi].d;
  float* part = a.p[pi].part;
  const int64_t rows = a.p[pi].rows;
  const int K = a.p[pi].K, N = a.p[pi].N, kt = a.p[pi].kt;
  const int local = (int)blockIdx.x - a.p[pi].first;
  const int chunk = local / kt, kb = (local - chunk * kt) * 128;
  const int kw = min(128, K - kb);
  const int64_t r0 = (int64_t)chunk * WG_CHUNK;
  const int nrows = (int)min((int64_t)WG_CHUNK, rows - r0);
  const int ns = (nrows + WG_RS - 1) / WG_RS;

  using L = Layout<2, 4, 4, 4>;
  const int warp = threadIdx.x >> 5, wm = warp / L::WN, wn = warp % L::WN;
  const int mtv = min(max((kw + 15) / 16 - wm * L::MT, 0), L::MT);
  const int ntv = min(max(round8(N) / 8 - wn * L::NT, 0), L::NT);
  auto issue = [&](int s) {
    float* st = smem + (s % WG_STAGES) * WG_STAGE;
    const int64_t q0 = r0 + (int64_t)s * WG_RS;
    const int valid = (int)min((int64_t)WG_RS, r0 + nrows - q0);
    tc::load_rows(st, WG_LD, x + kb, q0, valid, WG_RS, kw, K,
                  tc::stream_policy());
    tc::load_rows(st + WG_RS * WG_LD, WG_LD, d, q0, valid, WG_RS, N, N,
                  tc::stream_policy());
  };
  Acc<L> acc;
  tc::zero(acc);
  for (int s = 0; s < WG_STAGES - 1; ++s) {
    if (s < ns) issue(s);
    tc::cp_commit();
  }
  for (int s = 0; s < ns; ++s) {
    tc::cp_wait<WG_STAGES - 2>();
    __syncthreads();  // stage s landed; every warp is done with stage s - 1
    if (s + WG_STAGES - 1 < ns) issue(s + WG_STAGES - 1);
    tc::cp_commit();
    const float* st = smem + (s % WG_STAGES) * WG_STAGE;
    tc::warp_mma<L::MT, L::NT>(acc, st + wm * L::MT * 16, 1, WG_LD,
                               st + WG_RS * WG_LD + wn * L::NT * 8, WG_LD, 1,
                               WG_RS / 8, mtv, ntv);
  }
  float* out = part + (size_t)chunk * K * N + (size_t)kb * N;
  const int rb = wm * L::MT * 16, cb = wn * L::NT * 8;
#pragma unroll
  for (int i = 0; i < L::MT; ++i)
#pragma unroll
    for (int j = 0; j < L::NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = rb + tc::frag_row(i, q), c = cb + tc::frag_col(j, q);
        if (r < kw && c < N) out[(size_t)r * N + c] = acc[i][j][q];
      }
}

// dst[p] = sum over g < G of src[g * stride + p]: warp w sums g = w, w + 8,
// ... in order, then the 8 warps' sums are added in order.  Not tile.cuh's
// reduce_partials (one thread per output, g = 0, 1, ... in order), which
// mlp_chain_bwd.cu still launches: one launch here takes every segment of
// the backward (grid.y, each with its own source, stride and length), where
// reduce_partials would take one launch per weight, bias and LayerNorm
// tensor, and each of its threads runs one chain of dependent loads over
// every partial, where eight warps here split that chain.
// When mlp_chain_bwd moves to mma_tf32x3.cuh it takes this kernel's
// segment list and reduce_partials goes, so one reduction remains.
__global__ void __launch_bounds__(THREADS) gn_reduce_kernel(const RedArgs a) {
  __shared__ float part[tc::WARPS][32];
  const RedSeg& s = a.s[blockIdx.y];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int p = blockIdx.x * 32 + lane;
  if ((int)blockIdx.x * 32 >= s.len) return;
  float acc = 0.f;
  if (p < s.len)
    for (int g = warp; g < s.G; g += tc::WARPS)
      acc += s.src[(size_t)g * s.stride + p];
  part[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && p < s.len) {
    float t = 0.f;
    for (int w = 0; w < tc::WARPS; ++w) t += part[w][lane];
    s.dst[p] = t;
  }
}

// Where everything of one launch lives.  With work null only the sizes are
// computed (the return value: floats of the work buffer).
struct BwdPlan {
  WgArgs wg;
  RedArgs red;
  int wg_blocks;
  int red_x;  // blocks along a segment (the longest one)
  float* ws_rows;  // the Ws rows of the first edge layer's gradient
  size_t ws_floats;
};

static size_t gn_bwd_plan(GnArgs& a, int has_eln, int has_nln, float* out,
                          float* work, BwdPlan& p) {
  const int V = a.V, k = a.k, fe = a.fe, fv = a.fv, ne = a.ne, nn = a.nn;
  const int64_t E = (int64_t)V * k;
  const int ntiles = (V + a.npb - 1) / a.npb;
  const int H1 = a.ed[1], He = a.ed[ne], Hn1 = a.nd[1];
  size_t used = 0;
  auto take = [&](size_t n) {
    float* q = work != nullptr ? work + used : nullptr;
    used += (n + 63) & ~(size_t)63;
    return q;
  };
  // flat gradient offsets: each chain W0, b0, W1, b1, ..., LN scale, bias
  int64_t off = 0, off_ew[MAX_LAYERS], off_eb[MAX_LAYERS], off_eln;
  int64_t off_nw[MAX_LAYERS], off_nb[MAX_LAYERS], off_nln;
  for (int l = 0; l < ne; ++l) {
    off_ew[l] = off;
    off += (int64_t)a.ed[l] * a.ed[l + 1];
    off_eb[l] = off;
    off += a.ed[l + 1];
  }
  off_eln = off;
  if (has_eln) off += 2 * (int64_t)He;
  for (int l = 0; l < nn; ++l) {
    off_nw[l] = off;
    off += (int64_t)a.nd[l] * a.nd[l + 1];
    off_nb[l] = off;
    off += a.nd[l + 1];
  }
  off_nln = off;
  p.ws_rows = out + off_ew[0] + (int64_t)fe * H1;
  p.ws_floats = (size_t)a.fs * H1;

  // the operands the tile kernel writes
  for (int l = 1; l < ne; ++l) a.xe[l - 1] = take((size_t)E * a.ed[l]);
  for (int l = 1; l < ne; ++l) a.de_op[l] = take((size_t)E * a.ed[l + 1]);
  a.xn[0] = take((size_t)V * He);
  for (int l = 1; l < nn; ++l) a.xn[l] = take((size_t)V * a.nd[l]);
  for (int l = 0; l < nn; ++l) a.dn_op[l] = take((size_t)V * a.nd[l + 1]);
  a.dvr = take((size_t)V * H1);
  // the tiles' column sums
  int pc = 0;
  for (int l = 0; l < ne; ++l) {
    a.cs_eb[l] = pc;
    pc += a.ed[l + 1];
  }
  a.cs_eln = pc;
  if (has_eln) pc += 2 * He;
  for (int l = 0; l < nn; ++l) {
    a.cs_nb[l] = pc;
    pc += a.nd[l + 1];
  }
  a.cs_nln = pc;
  if (has_nln) pc += 2 * a.nd[nn];
  a.pc = pc;
  a.colsum = take((size_t)ntiles * pc);

  // the weight-gradient products and their reductions
  p.wg.np = 0;
  p.red.ns = 0;
  p.wg_blocks = 0;
  p.red_x = 0;
  auto seg = [&](const float* src, float* dst, int64_t stride, int G,
                 int len) {
    p.red.s[p.red.ns++] = RedSeg{src, dst, stride, G, len};
    const int bx = (len + 31) / 32;
    p.red_x = bx > p.red_x ? bx : p.red_x;
  };
  auto prod = [&](const float* x, const float* d, int64_t rows, int K, int N,
                  int64_t dst) {
    const int chunks = (int)((rows + WG_CHUNK - 1) / WG_CHUNK);
    const int kt = (K + 127) / 128;
    float* part = take((size_t)chunks * K * N);
    p.wg.p[p.wg.np++] = WgProd{x, d, part, rows, K, N, p.wg_blocks, kt};
    p.wg_blocks += chunks * kt;
    seg(part, out + dst, (int64_t)K * N, chunks, K * N);
  };
  prod(a.e, a.dh1, E, fe, H1, off_ew[0]);
  prod(a.v, a.dvr, V, fv, H1, off_ew[0] + (int64_t)(fe + a.fs) * H1);
  for (int l = 1; l < ne; ++l)
    prod(a.xe[l - 1], a.de_op[l], E, a.ed[l], a.ed[l + 1], off_ew[l]);
  prod(a.xn[0], a.dn_op[0], V, He, Hn1, off_nw[0]);
  prod(a.v, a.dn_op[0], V, fv, Hn1, off_nw[0] + (int64_t)He * Hn1);
  for (int l = 1; l < nn; ++l)
    prod(a.xn[l], a.dn_op[l], V, a.nd[l], a.nd[l + 1], off_nw[l]);
  for (int l = 0; l < ne; ++l)
    seg(a.colsum + a.cs_eb[l], out + off_eb[l], pc, ntiles, a.ed[l + 1]);
  if (has_eln) seg(a.colsum + a.cs_eln, out + off_eln, pc, ntiles, 2 * He);
  for (int l = 0; l < nn; ++l)
    seg(a.colsum + a.cs_nb[l], out + off_nb[l], pc, ntiles, a.nd[l + 1]);
  if (has_nln)
    seg(a.colsum + a.cs_nln, out + off_nln, pc, ntiles, 2 * a.nd[nn]);
  return used;
}

static void gn_bwd_shape(GnArgs& a, int V, int k, int fe, int fs, int fv,
                         int ne, const int* ed, int nn, const int* nd,
                         int wmax) {
  a.V = V;
  a.k = k;
  a.fe = fe;
  a.fs = fs;
  a.fv = fv;
  gn_geometry(k, &a.npb, &a.emt);
  a.ne = ne;
  a.nn = nn;
  for (int l = 0; l <= ne; ++l) a.ed[l] = ed[l];
  for (int l = 0; l <= nn; ++l) a.nd[l] = nd[l];
  a.lda = round8(wmax) + 4;
  a.ldv = round8(fv) + 4;
}

}  // namespace gn
}  // namespace g4c

extern "C" {

// Shared-memory bytes one block of the tile kernel needs, or 0 if the
// shapes are not taken: 2 <= k <= 96, 2..8 layers per chain, fe and every
// chain width at most 128, fv at most 256.
size_t g4c_gn_block_bwd_smem(int k, int fe, int fv, int ne, const int* ed,
                             int nn, const int* nd) {
  using namespace g4c::gn;
  const int wmax = gn_wmax(k, fe, fv, ne, ed, nn, nd, 2);
  if (wmax == 0) return 0;
  return sizeof(float) * gn_smem_floats(k, wmax, fv);
}

// Floats of the work buffer of g4c_gn_block_bwd, or 0 if the shapes are not
// taken.
size_t g4c_gn_block_bwd_work(int k, int fe, int fv, int ne, const int* ed,
                             int nn, const int* nd, int V, int has_eln,
                             int has_nln) {
  using namespace g4c::gn;
  const int wmax = gn_wmax(k, fe, fv, ne, ed, nn, nd, 2);
  if (wmax == 0 || V < 1) return 0;
  GnArgs a{};
  gn_bwd_shape(a, V, k, fe, 0, fv, ne, ed, nn, nd, wmax);
  BwdPlan p;
  return gn_bwd_plan(a, has_eln, has_nln, nullptr, nullptr, p);
}

// e [V*k, fe], vs [S, ed[1]], v [V, fv], senders [V*k] int32 (in [0, S),
// else NaN); ge [V*k, ed[ne]] or null, gv [V, nd[nn]] -> de [V*k, fe],
// dv [V, fv], dh1 [V*k, ed[1]], and into `out` the gradients of the edge
// chain then the node chain, each W0, b0, W1, b1, ..., LN scale, LN bias,
// flat (the Ws rows [fe, fe + fs) of W0 zero); `work` holds
// g4c_gn_block_bwd_work floats.  Weights as in g4c_gn_block.  `parts`
// selects the launches (1: the tile kernel, 2: the weight-gradient kernel,
// 4: the reduction; 7 for all), so that a caller can time them apart.
int g4c_gn_block_bwd(const void* e, const void* vs, const void* v,
                     const void* senders, const void* ge, const void* gv,
                     void* de, void* dv, void* dh1, int V, int S, int k,
                     int fe, int fs, int fv, int ne, const void* const* ew,
                     const void* const* eb, const int* ed,
                     const void* eln_scale, const void* eln_bias, int nn,
                     const void* const* nw, const void* const* nb,
                     const int* nd, const void* nln_scale,
                     const void* nln_bias, int out_selu, void* work,
                     void* out, int parts, void* stream) {
  using namespace g4c;
  using namespace g4c::gn;
  const size_t smem = g4c_gn_block_bwd_smem(k, fe, fv, ne, ed, nn, nd);
  if (smem == 0 || smem > 232448 || V < 1 || S < 1 || fs < 0 ||
      work == nullptr)
    return (int)cudaErrorInvalidValue;
  GnArgs a{};
  gn_bwd_shape(a, V, k, fe, fs, fv, ne, ed, nn, nd,
               gn_wmax(k, fe, fv, ne, ed, nn, nd, 2));
  a.e = (const float*)e;
  a.vs = (const float*)vs;
  a.v = (const float*)v;
  a.senders = (const int*)senders;
  a.S = S;
  a.ge = (const float*)ge;
  a.gv = (const float*)gv;
  a.de = (float*)de;
  a.dv = (float*)dv;
  a.dh1 = (float*)dh1;
  for (int l = 0; l < ne; ++l) {
    a.ew[l] = (const float*)ew[l];
    a.eb[l] = (const float*)eb[l];
  }
  for (int l = 0; l < nn; ++l) {
    a.nw[l] = (const float*)nw[l];
    a.nb[l] = (const float*)nb[l];
  }
  a.eln_scale = (const float*)eln_scale;
  a.eln_bias = (const float*)eln_bias;
  a.nln_scale = (const float*)nln_scale;
  a.nln_bias = (const float*)nln_bias;
  a.out_selu = out_selu;
  BwdPlan p;
  gn_bwd_plan(a, eln_scale != nullptr, nln_scale != nullptr, (float*)out,
              (float*)work, p);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (parts & 1) {
    err = cudaFuncSetAttribute(gn_block_bwd_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    const unsigned grid = (unsigned)((V + a.npb - 1) / a.npb);
    gn_block_bwd_kernel<<<grid, THREADS, smem, s>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (parts & 2) {
    const int wsmem = (int)(sizeof(float) * WG_STAGES * WG_STAGE);
    err = cudaFuncSetAttribute(
        gn_wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, wsmem);
    if (err != cudaSuccess) return (int)err;
    gn_wgrad_kernel<<<p.wg_blocks, THREADS, wsmem, s>>>(p.wg);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (parts & 4) {
    if (p.ws_floats > 0) {
      err = cudaMemsetAsync(p.ws_rows, 0, p.ws_floats * sizeof(float), s);
      if (err != cudaSuccess) return (int)err;
    }
    gn_reduce_kernel<<<dim3(p.red_x, p.red.ns), THREADS, 0, s>>>(p.red);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // extern "C"
