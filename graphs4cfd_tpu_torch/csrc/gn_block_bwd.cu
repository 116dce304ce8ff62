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
//   2. gn_wgrad_kernel (wgrad.cu, shared with mlp_chain_bwd.cu): every
//      dW = X^T D as a split over fixed chunks of 2048 rows (fewer for a
//      product of few rows: wgrad.cuh's wgrad_chunk); a block owns
//      (product, chunk, 128-row slice of K), keeps its 128 x N sums in
//      registers over the chunk (3xTF32 on the tensor cores, X and D
//      through a three-stage cp.async ring) and writes its partial once.
//      dWe = e^T dh1, dWr = v^T dvr, dWa = aggr^T dhn and dWv = v^T dhn
//      read e, v and dh1 as they are.  At MuS level 1 the operands are
//      about 0.64 GB, written once and read once.
//   3. gn_reduce_kernel (wgrad.cu): the chunk partials and the tiles'
//      column sums, each summed in a fixed order.
// No float atomics: two launches give the same bits.
//
// The bf16 policy, as pallas_gnblock.py's backward kernels under
// compute_dtype=bfloat16: e, vs, v, gv, ge, de, dv and dh1 (the per-edge
// sender cotangent, dvsg there) are bf16 in device memory; its tile kernel
// is gn_block_bf16.cu's (bf16 tiles, wgmma), launched from here with the
// same plan, and wgrad_bf16.cu's kernel runs dW = X^T D (wgmma over bf16
// tiles), both operands rounded to bf16.  SELU', the LayerNorm backward, the mean
// over k, dvr and the column sums are f32.  The cotangent operands the
// tile writes (each layer's output cotangent, dvr) are bf16; the layer
// inputs (xe, xn) and, for the bf16 tile, the edge chain's pre-LayerNorm
// output (epre) stay f32: the tile reads them back for SELU' and the
// LayerNorm's backward, which the JAX kernels take from f32 values.  The
// weight and bias gradients stay f32.
//
// Widths as in gn_block.cu: the node input fv may be up to 256 (gMuS's
// mp121 and mp221), every other width at most 128; dv [V, fv] is computed
// and stored 128 columns at a time, and dWr, dWv in 128-row slices of K.
#include "gn_tile.cuh"
#include "gn_tile_bf16.cuh"
#include "wgrad.cuh"

namespace g4c {
namespace gn {

template <class T>
__global__ void __launch_bounds__(THREADS, 2)
    gn_block_bwd_kernel(const GnArgs<T> a) {
  using C = tc::Tf32x3;
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

  gn_forward<T, true>(a, m, n0, nv);

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
    mm_t<NodeL, C>(nacc, m.N1, lda, 1, a.nw[l], K, N, m.ring);
    mul_dselu<NodeL>(nacc, a.xn[l] + n0 * K, nv, K);
    store_tile<NodeL>(nacc, m.N1, lda, K, 1);
  }
  // N1 = dhn, the cotangent of the first node layer's pre-activation
  copy_rows(m.N1, lda, nv, Hn1, a.dn_op[0], n0, scratch, cs + a.cs_nb[0],
            true);
  {
    Acc<NodeL> nacc;
    tc::zero(nacc);
    mm_t<NodeL, C>(nacc, m.N1, lda, 1, a.nw[0], He, Hn1, m.ring);
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
    mm_t<EdgeL, C>(acc, m.E, lda, emt, a.ew[l], K, N, m.ring);
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
    mm_t<EdgeL, C>(acc, m.E, lda, emt, a.ew[0], a.fe, H1, m.ring);
    store_out<EdgeL>(acc, a.de, e0, ev, a.fe, a.fe);
  }
  // dv = dhn Wv^T + dvr Wr^T, 128 columns at a time
  for (int c0 = 0; c0 < a.fv; c0 += 128) {
    const int cw = min(128, a.fv - c0);
    Acc<NodeL> nacc;
    tc::zero(nacc);
    mm_t<NodeL, C>(nacc, m.N1, lda, 1, a.nw[0] + (size_t)(He + c0) * Hn1,
                   cw, Hn1, m.ring);
    mm_t<NodeL, C>(nacc, m.N2, lda, 1,
                   a.ew[0] + (size_t)(a.fe + a.fs + c0) * H1, cw, H1,
                   m.ring);
    store_out<NodeL>(nacc, a.dv + c0, n0, nv, cw, a.fv);
  }
}

// Where everything of one launch lives: the operands and column sums in
// `work` (the plan's products and segments read them), the gradients in
// `out`.  With work null only the sizes are computed (p.used).
template <class T>
static void gn_bwd_plan(GnArgs<T>& a, int has_eln, int has_nln, float* out,
                        SplitPlan& p) {
  const int V = a.V, k = a.k, fe = a.fe, fv = a.fv, ne = a.ne, nn = a.nn;
  const int64_t E = (int64_t)V * k;
  const int ntiles = (V + a.npb - 1) / a.npb;
  const int H1 = a.ed[1], He = a.ed[ne], Hn1 = a.nd[1];
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

  // the operands the tile kernel writes
  for (int l = 1; l < ne; ++l) a.xe[l - 1] = p.take((size_t)E * a.ed[l]);
  for (int l = 1; l < ne; ++l)
    a.de_op[l] = p.take_as<T>((size_t)E * a.ed[l + 1]);
  a.xn[0] = p.take((size_t)V * He);
  for (int l = 1; l < nn; ++l) a.xn[l] = p.take((size_t)V * a.nd[l]);
  for (int l = 0; l < nn; ++l)
    a.dn_op[l] = p.take_as<T>((size_t)V * a.nd[l + 1]);
  a.dvr = p.take_as<T>((size_t)V * H1);
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
  a.colsum = p.take((size_t)ntiles * pc);

  // the weight-gradient products and their reductions
  p.prod(a.e, a.dh1, E, fe, H1, out + off_ew[0]);
  p.prod(a.v, a.dvr, V, fv, H1, out + off_ew[0] + (int64_t)(fe + a.fs) * H1);
  for (int l = 1; l < ne; ++l)
    p.prod(a.xe[l - 1], a.de_op[l], E, a.ed[l], a.ed[l + 1], out + off_ew[l]);
  p.prod(a.xn[0], a.dn_op[0], V, He, Hn1, out + off_nw[0]);
  p.prod(a.v, a.dn_op[0], V, fv, Hn1, out + off_nw[0] + (int64_t)He * Hn1);
  for (int l = 1; l < nn; ++l)
    p.prod(a.xn[l], a.dn_op[l], V, a.nd[l], a.nd[l + 1], out + off_nw[l]);
  for (int l = 0; l < ne; ++l)
    p.seg(a.colsum + a.cs_eb[l], out + off_eb[l], pc, ntiles, a.ed[l + 1]);
  if (has_eln)
    p.seg(a.colsum + a.cs_eln, out + off_eln, pc, ntiles, 2 * He);
  for (int l = 0; l < nn; ++l)
    p.seg(a.colsum + a.cs_nb[l], out + off_nb[l], pc, ntiles, a.nd[l + 1]);
  if (has_nln)
    p.seg(a.colsum + a.cs_nln, out + off_nln, pc, ntiles, 2 * a.nd[nn]);
  // the bf16 tile kernel's e_pre, read back by its edge LayerNorm backward
  if constexpr (std::is_same<T, tc::bf16>::value)
    a.epre = p.take((size_t)E * He);
}

template <class T>
static void gn_bwd_shape(GnArgs<T>& a, int V, int k, int fe, int fs, int fv,
                         int ne, const int* ed, int nn, const int* nd,
                         int wmax) {
  a.V = V;
  a.k = k;
  a.fe = fe;
  a.fs = fs;
  a.fv = fv;
  if constexpr (std::is_same<T, tc::bf16>::value) {
    gn16::geometry(k, fv, ne, &a.npb, &a.er);
    a.emt = a.er / 64;
  } else {
    gn_geometry(k, &a.npb, &a.emt);
  }
  a.ne = ne;
  a.nn = nn;
  for (int l = 0; l <= ne; ++l) a.ed[l] = ed[l];
  for (int l = 0; l <= nn; ++l) a.nd[l] = nd[l];
  a.lda = round8(wmax) + 4;
  a.ldv = round8(fv) + 4;
}

template <class T>
static int launch_bwd(const void* e, const void* vs, const void* v,
                      const void* senders, const void* ge, const void* gv,
                      void* de, void* dv, void* dh1, int V, int S, int k,
                      int fe, int fs, int fv, int ne, const void* const* ew,
                      const void* const* eb, const int* ed,
                      const void* eln_scale, const void* eln_bias, int nn,
                      const void* const* nw, const void* const* nb,
                      const int* nd, const void* nln_scale,
                      const void* nln_bias, int out_selu, void* work,
                      void* out, int parts, size_t smem, cudaStream_t s) {
  GnArgs<T> a{};
  gn_bwd_shape(a, V, k, fe, fs, fv, ne, ed, nn, nd,
               gn_wmax(k, fe, fv, ne, ed, nn, nd, 2));
  a.e = (const T*)e;
  a.vs = (const T*)vs;
  a.v = (const T*)v;
  a.senders = (const int*)senders;
  a.S = S;
  a.ge = (const T*)ge;
  a.gv = (const T*)gv;
  a.de = (T*)de;
  a.dv = (T*)dv;
  a.dh1 = (T*)dh1;
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
  SplitPlan p((float*)work, std::is_same<T, tc::bf16>::value);
  gn_bwd_plan(a, eln_scale != nullptr, nln_scale != nullptr, (float*)out, p);
  cudaError_t err;
  if (parts & 1) {
    if constexpr (std::is_same<T, tc::bf16>::value) {
      // the bf16 policy's tile kernel (gn_block_bf16.cu)
      err = gn16::launch_bwd_tile(a, smem, s);
    } else {
      err = cudaFuncSetAttribute(gn_block_bwd_kernel<T>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
      if (err != cudaSuccess) return (int)err;
      const unsigned grid = (unsigned)((V + a.npb - 1) / a.npb);
      gn_block_bwd_kernel<T><<<grid, THREADS, smem, s>>>(a);
      err = cudaGetLastError();
    }
    if (err != cudaSuccess) return (int)err;
  }
  if (parts & 2) {
    err = launch_wgrad(p, s);
    if (err != cudaSuccess) return (int)err;
  }
  if (parts & 4) {
    // the Ws rows of the first edge layer's gradient (vs comes from outside)
    const size_t ws_floats = (size_t)fs * ed[1];
    if (ws_floats > 0) {
      err = cudaMemsetAsync((float*)out + (size_t)fe * ed[1], 0,
                            ws_floats * sizeof(float), s);
      if (err != cudaSuccess) return (int)err;
    }
    err = launch_reduce(p, s);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace gn
}  // namespace g4c

extern "C" {

// Shared-memory bytes one block of the tile kernel needs (of the bf16
// policy's if `is_bf16`), or 0 if the shapes are not taken: 2 <= k <= 96,
// 2..8 layers per chain, fe and every chain width at most 128, fv at most
// 256.
size_t g4c_gn_block_bwd_smem(int k, int fe, int fv, int ne, const int* ed,
                             int nn, const int* nd, int is_bf16) {
  using namespace g4c::gn;
  const int wmax = gn_wmax(k, fe, fv, ne, ed, nn, nd, 2);
  if (wmax == 0) return 0;
  if (is_bf16) return g4c::gn16::smem_for(k, fv, ne);
  return sizeof(float) * gn_smem_floats(k, wmax, fv);
}

// Floats of the work buffer of g4c_gn_block_bwd, or 0 if the shapes are not
// taken (`is_bf16`: the bf16 policy's launch).
size_t g4c_gn_block_bwd_work(int k, int fe, int fv, int ne, const int* ed,
                             int nn, const int* nd, int V, int has_eln,
                             int has_nln, int is_bf16) {
  using namespace g4c;
  using namespace g4c::gn;
  const int wmax = gn_wmax(k, fe, fv, ne, ed, nn, nd, 2);
  if (wmax == 0 || V < 1) return 0;
  SplitPlan p(nullptr, is_bf16 != 0);
  if (is_bf16) {
    GnArgs<tc::bf16> a{};
    gn_bwd_shape(a, V, k, fe, 0, fv, ne, ed, nn, nd, wmax);
    gn_bwd_plan(a, has_eln, has_nln, nullptr, p);
  } else {
    GnArgs<float> a{};
    gn_bwd_shape(a, V, k, fe, 0, fv, ne, ed, nn, nd, wmax);
    gn_bwd_plan(a, has_eln, has_nln, nullptr, p);
  }
  return p.used;
}

// e [V*k, fe], vs [S, ed[1]], v [V, fv], senders [V*k] int32 (in [0, S),
// else NaN); ge [V*k, ed[ne]] or null, gv [V, nd[nn]] -> de [V*k, fe],
// dv [V, fv], dh1 [V*k, ed[1]], and into `out` the gradients of the edge
// chain then the node chain, each W0, b0, W1, b1, ..., LN scale, LN bias,
// flat (the Ws rows [fe, fe + fs) of W0 zero); `work` holds
// g4c_gn_block_bwd_work floats.  Weights as in g4c_gn_block.  The
// activations and their cotangents (e, vs, v, ge, gv, de, dv, dh1) are
// bf16 if `is_bf16`, else f32; the gradients in `out` are f32.  `parts`
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
                     void* out, int parts, int is_bf16, void* stream) {
  using namespace g4c;
  using namespace g4c::gn;
  const size_t smem =
      g4c_gn_block_bwd_smem(k, fe, fv, ne, ed, nn, nd, is_bf16);
  if (smem == 0 || smem > 232448 || V < 1 || S < 1 || fs < 0 ||
      work == nullptr)
    return (int)cudaErrorInvalidValue;
  auto launch = is_bf16 ? launch_bwd<tc::bf16> : launch_bwd<float>;
  return launch(e, vs, v, senders, ge, gv, de, dv, dh1, V, S, k, fe, fs, fv,
                ne, ew, eb, ed, eln_scale, eln_bias, nn, nw, nb, nd,
                nln_scale, nln_bias, out_selu, work, out, parts, smem,
                (cudaStream_t)stream);
}

}  // extern "C"
