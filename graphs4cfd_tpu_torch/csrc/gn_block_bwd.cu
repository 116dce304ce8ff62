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
//   dWa += aggr^T dhn, dWv += v^T dhn, daggr = dhn Wa^T
//   de_new = ge + repeat_k(daggr / k)       (aggregation read e' pre-SELU)
//   edge LayerNorm and chain backward                  -> dh1, edge dW/db
//   dWe += e^T dh1, dvr = sum_k dh1, dWr += v^T dvr
//   de = dh1 We^T, dv = dhn Wv^T + dvr Wr^T, and dh1 itself [E, H1]
//
// dh1 goes out per edge row; ops.segment.sorted_segment_sum then sums it
// per sender in sorted order (csrc/sorted_segment_sum.cu) into dvs, the
// cotangent of vs = v @ Ws.  The rows of dW1 that belong to Ws stay zero:
// vs is computed outside, and autograd gives Ws its gradient from dvs.
// vs has S rows (the node set, or the finer level's edges in REMuS's
// down_edge_mp); as in the forward, a sender outside [0, S) makes its edge
// row NaN in the recomputed forward, so its receiver's gradient rows (and
// the weight gradients) come out NaN, and the table is never read outside.
//
// The same kernel is the backward of the REMuS line-graph GN blocks: of
// ops/pallas_edgemp.py:_make_bwd_kernel_fold (entry _edgemp_fold_vjp_bwd),
// one EdgeMP layer, whose d_tab is dvs summed over angle_src, and of
// ops/pallas_gnblock.py:_make_bwd_kernel (entry _gn_vjp_bwd), down_edge_mp,
// whose dvsg summed per fine edge is dvs.
//
// Bound on the H100 (V=40448, k=6, H=128, f32): the recomputed forward
// (30.5 GFLOP) and two products per forward product, 91.5 GFLOP in all,
// against 0.5 GB of traffic: bound by the f32 CUDA cores (67 TFLOP/s) at
// 1.37 ms.  Design: the TPU kernel accumulates the weight gradients over
// its sequential grid; here a persistent grid of as many blocks as the
// card holds at once walks the 96-edge tiles in a fixed order (block b
// takes tiles b, b + G, ...), adds each tile's dW, db and dLN into the
// block's own partial in device memory (each element owned by one thread:
// no atomics), and a second kernel sums the G partials in block order.
// All activations of a tile stay in shared memory (SELU' comes from the
// stored activations); the edge rows' pre-LN output and its statistics
// are kept for the aggregation and the edge LayerNorm backward.
#include "tile.cuh"

namespace g4c {

constexpr int GNB_TME = 6;               // edge rows per thread
constexpr int GNB_ER = TY * GNB_TME;     // edge rows per tile

struct GnBwdArgs {
  const float* e;
  const float* vs;
  const float* v;
  const int* senders;
  const float* ge;  // null: e' was not stored (skip_e)
  const float* gv;
  float* de;
  float* dv;
  float* dh1;
  int V, S, k, fe, fs, fv;
  int nodes_per_block;
  int ne, nn;
  const float* ew[MAX_LAYERS];  // as in GnArgs (gn_block.cu)
  const float* eb[MAX_LAYERS];
  int ed[MAX_LAYERS + 1];
  const float* eln_scale;
  const float* eln_bias;
  const float* nw[MAX_LAYERS];
  const float* nb[MAX_LAYERS];
  int nd[MAX_LAYERS + 1];
  const float* nln_scale;
  const float* nln_bias;
  int out_selu;
  int ld;
  float* work;  // [gridDim.x][P] partial gradients
  int64_t P;
  int64_t off_ew[MAX_LAYERS], off_eb[MAX_LAYERS], off_eln;
  int64_t off_nw[MAX_LAYERS], off_nb[MAX_LAYERS], off_nln;
};

template <int TMN, int NT>
__global__ void __launch_bounds__(NTHREADS)
    gn_block_bwd_kernel(const GnBwdArgs a) {
  constexpr int NR = TY * TMN;  // node rows of the node tiles
  constexpr int ER = GNB_ER;
  extern __shared__ float smem[];
  const int ld = a.ld;
  float* vt = smem;        // v tile                      [NR][ld]
  float* ag = vt + NR * ld;  // aggr, then daggr / k, then dvr
  float* dn = ag + NR * ld;  // vr, then the node cotangents
  float* p = dn + NR * ld;
  float* nact[MAX_LAYERS];   // inputs of node layers 1..nn-1
  for (int l = 0; l < a.nn - 1; ++l) {
    nact[l] = p;
    p += NR * ld;
  }
  float* eact[MAX_LAYERS];   // inputs of edge layers 1..ne-1
  for (int l = 0; l < a.ne - 1; ++l) {
    eact[l] = p;
    p += ER * ld;
  }
  float* dt = p;             // e, then e_pre, then the edge cotangents
  float* erow = dt + ER * ld;  // LayerNorm mean and 1/std of the edge rows
  float* wtile = erow + 2 * ER;
  float* part = a.work + (size_t)blockIdx.x * a.P;
  for (int64_t i = threadIdx.x; i < a.P; i += NTHREADS) part[i] = 0.f;

  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int k = a.k, fe = a.fe, fv = a.fv;
  const size_t wr_row = (size_t)(fe + a.fs);  // first row of Wr in ew[0]
  const int H1 = a.ed[1], He = a.ed[a.ne];
  const int Hn1 = a.nd[1], Hn = a.nd[a.nn];
  const float inv_k = 1.f / (float)k;
  const int ntiles = (a.V + a.nodes_per_block - 1) / a.nodes_per_block;

  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int64_t n0 = (int64_t)t * a.nodes_per_block;
    const int nv = a.V - n0 < a.nodes_per_block ? (int)(a.V - n0)
                                                : a.nodes_per_block;
    const int64_t e0 = n0 * k;
    const int ev = nv * k;
    __syncthreads();

    // ---- remat forward (as gn_block.cu) ----
    load_tile(a.v, n0, nv, fv, vt, ld, NR, false);
    float nacc[TMN][NT];
    zero(nacc);
    mm_acc<TMN, NT>(nacc, vt, ld, fv, a.ew[0] + wr_row * H1, H1, wtile);
    store_smem(nacc, dn, ld, H1);
    load_tile(a.e, e0, ev, fe, dt, ld, ER, false);
    float acc[GNB_TME][NT];
    zero(acc);
    mm_acc<GNB_TME, NT>(acc, dt, ld, fe, a.ew[0], H1, wtile);
#pragma unroll
    for (int i = 0; i < GNB_TME; ++i) {
      const int r = ty * GNB_TME + i;
      if (r >= ev) continue;
      const int s = __ldg(a.senders + e0 + r);
      if ((unsigned)s >= (unsigned)a.S) {
#pragma unroll
        for (int j = 0; j < NT; ++j) acc[i][j] = __int_as_float(0x7fc00000);
        continue;
      }
      const float* vsr = a.vs + (size_t)s * H1;
      const float* vrr = dn + (r / k) * ld;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = tx + TX * j;
        if (c < H1) acc[i][j] += __ldg(vsr + c) + vrr[c];
      }
    }
    add_bias(acc, H1, a.eb[0]);
    for (int l = 1; l < a.ne; ++l) {
      apply_selu(acc);
      store_smem(acc, eact[l - 1], ld, a.ed[l]);
      zero(acc);
      mm_acc<GNB_TME, NT>(acc, eact[l - 1], ld, a.ed[l], a.ew[l],
                          a.ed[l + 1], wtile);
      add_bias(acc, a.ed[l + 1], a.eb[l]);
    }
    if (a.eln_scale != nullptr) {
      float mean[GNB_TME], rstd[GNB_TME];
      row_stats(acc, He, mean, rstd);
      if (tx == 0)
#pragma unroll
        for (int i = 0; i < GNB_TME; ++i) {
          erow[ty * GNB_TME + i] = mean[i];
          erow[ER + ty * GNB_TME + i] = rstd[i];
        }
    }
    store_smem(acc, dt, ld, He);  // e_pre
    __syncthreads();
    // aggr = mean over each receiver's k rows of e_new (pre-SELU)
    for (int idx = threadIdx.x; idx < NR * He; idx += NTHREADS) {
      const int r = idx / He, c = idx - r * He;
      float s = 0.f;
      if (r < nv)
        for (int j = 0; j < k; ++j) {
          const int q = r * k + j;
          float x = dt[q * ld + c];
          if (a.eln_scale != nullptr)
            x = (x - erow[q]) * erow[ER + q] * __ldg(a.eln_scale + c) +
                __ldg(a.eln_bias + c);
          s += x;
        }
      ag[r * ld + c] = s * inv_k;
    }
    zero(nacc);
    mm_acc<TMN, NT>(nacc, ag, ld, He, a.nw[0], Hn1, wtile);
    mm_acc<TMN, NT>(nacc, vt, ld, fv, a.nw[0] + (size_t)He * Hn1, Hn1,
                    wtile);
    add_bias(nacc, Hn1, a.nb[0]);
    for (int l = 1; l < a.nn; ++l) {
      apply_selu(nacc);
      store_smem(nacc, nact[l - 1], ld, a.nd[l]);
      zero(nacc);
      mm_acc<TMN, NT>(nacc, nact[l - 1], ld, a.nd[l], a.nw[l], a.nd[l + 1],
                      wtile);
      add_bias(nacc, a.nd[l + 1], a.nb[l]);
    }

    // ---- node backward; v_pre is in nacc ----
    float gn[TMN][NT];
    load_regs(gn, a.gv, n0, nv, Hn);
    if (a.out_selu) {
      float mean[TMN], rstd[TMN];
      if (a.nln_scale != nullptr) row_stats(nacc, Hn, mean, rstd);
#pragma unroll
      for (int i = 0; i < TMN; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int c = tx + TX * j;
          if (c >= Hn) continue;
          const float vn = a.nln_scale != nullptr
                               ? (nacc[i][j] - mean[i]) * rstd[i] *
                                         __ldg(a.nln_scale + c) +
                                     __ldg(a.nln_bias + c)
                               : nacc[i][j];
          gn[i][j] *= dselu(vn);
        }
    }
    if (a.nln_scale != nullptr)
      ln_backward(gn, nacc, Hn, a.nln_scale, dn, ld, NR, part + a.off_nln,
                  part + a.off_nln + Hn);
    __syncthreads();
    store_smem(gn, dn, ld, Hn);
    for (int l = a.nn - 1; l >= 1; --l) {
      const int K = a.nd[l], N = a.nd[l + 1];
      __syncthreads();
      colsum_rmw(dn, ld, NR, N, part + a.off_nb[l]);
      wgrad_rmw<NT>(nact[l - 1], ld, K, dn, ld, N, NR, part + a.off_nw[l]);
      zero(nacc);
      mm_acc_wt<TMN, NT>(nacc, dn, ld, N, a.nw[l], N, K, wtile);
      mul_dselu_of_selu(nacc, nact[l - 1], ld, K);
      __syncthreads();
      store_smem(nacc, dn, ld, K);
    }
    // dn = dhn, the cotangent of the first node layer's pre-activation
    __syncthreads();
    colsum_rmw(dn, ld, NR, Hn1, part + a.off_nb[0]);
    wgrad_rmw<NT>(ag, ld, He, dn, ld, Hn1, NR, part + a.off_nw[0]);
    wgrad_rmw<NT>(vt, ld, fv, dn, ld, Hn1, NR,
                  part + a.off_nw[0] + (size_t)He * Hn1);
    zero(nacc);
    mm_acc_wt<TMN, NT>(nacc, dn, ld, Hn1, a.nw[0], Hn1, He, wtile);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < TMN; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) nacc[i][j] *= inv_k;
    store_smem(nacc, ag, ld, He);  // daggr / k
    __syncthreads();

    // ---- edge backward ----
    float ep[GNB_TME][NT];
    load_smem(ep, dt, ld, He);
    if (a.ge != nullptr) {
      load_regs(acc, a.ge, e0, ev, He);
      if (a.out_selu)
#pragma unroll
        for (int i = 0; i < GNB_TME; ++i) {
          const int r = ty * GNB_TME + i;
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const int c = tx + TX * j;
            if (c >= He) continue;
            const float en = a.eln_scale != nullptr
                                 ? (ep[i][j] - erow[r]) * erow[ER + r] *
                                           __ldg(a.eln_scale + c) +
                                       __ldg(a.eln_bias + c)
                                 : ep[i][j];
            acc[i][j] *= dselu(en);
          }
        }
    } else {
      zero(acc);
    }
#pragma unroll
    for (int i = 0; i < GNB_TME; ++i) {
      const int r = ty * GNB_TME + i;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = tx + TX * j;
        if (c < He) acc[i][j] += ag[(r / k) * ld + c];
      }
    }
    if (a.eln_scale != nullptr)
      ln_backward(acc, ep, He, a.eln_scale, dt, ld, ER, part + a.off_eln,
                  part + a.off_eln + He);
    __syncthreads();
    store_smem(acc, dt, ld, He);
    for (int l = a.ne - 1; l >= 1; --l) {
      const int K = a.ed[l], N = a.ed[l + 1];
      __syncthreads();
      colsum_rmw(dt, ld, ER, N, part + a.off_eb[l]);
      wgrad_rmw<NT>(eact[l - 1], ld, K, dt, ld, N, ER, part + a.off_ew[l]);
      zero(acc);
      mm_acc_wt<GNB_TME, NT>(acc, dt, ld, N, a.ew[l], N, K, wtile);
      mul_dselu_of_selu(acc, eact[l - 1], ld, K);
      __syncthreads();
      store_smem(acc, dt, ld, K);
    }
    // dt = dh1, the cotangent of the first edge layer's pre-activation
    __syncthreads();
    colsum_rmw(dt, ld, ER, H1, part + a.off_eb[0]);
    for (int idx = threadIdx.x; idx < ev * H1; idx += NTHREADS) {
      const int r = idx / H1, c = idx - r * H1;
      a.dh1[(size_t)(e0 + r) * H1 + c] = dt[r * ld + c];
    }
    for (int idx = threadIdx.x; idx < NR * H1; idx += NTHREADS) {
      const int r = idx / H1, c = idx - r * H1;
      float s = 0.f;
      if (r < nv)
        for (int j = 0; j < k; ++j) s += dt[(r * k + j) * ld + c];
      ag[r * ld + c] = s;  // dvr
    }
    load_tile(a.e, e0, ev, fe, eact[0], ld, ER, false);
    __syncthreads();
    wgrad_rmw<NT>(eact[0], ld, fe, dt, ld, H1, ER, part + a.off_ew[0]);
    wgrad_rmw<NT>(vt, ld, fv, ag, ld, H1, NR,
                  part + a.off_ew[0] + wr_row * H1);
    zero(acc);
    mm_acc_wt<GNB_TME, NT>(acc, dt, ld, H1, a.ew[0], H1, fe, wtile);
    store_global(acc, a.de, e0, ev, fe, false);
    zero(nacc);
    mm_acc_wt<TMN, NT>(nacc, dn, ld, Hn1, a.nw[0] + (size_t)He * Hn1, Hn1,
                       fv, wtile);
    mm_acc_wt<TMN, NT>(nacc, ag, ld, H1, a.ew[0] + wr_row * H1, H1, fv,
                       wtile);
    store_global(nacc, a.dv, n0, nv, fv, false);
  }
}

static int gn_bwd_node_rows_per_thread(int k) {
  return (GNB_ER / k + TY - 1) / TY;
}

// Widest feature of the block, or 0 if the shapes are not taken:
// 2 <= k <= 96, 2..8 layers per chain, every width at most 128.
static int gn_bwd_wmax(int k, int fe, int fv, int ne, const int* ed, int nn,
                       const int* nd) {
  if (k < 2 || k > GNB_ER || ne < 2 || ne > MAX_LAYERS || nn < 2 ||
      nn > MAX_LAYERS || fe < 1 || fv < 1)
    return 0;
  int wmax = fe > fv ? fe : fv;
  for (int l = 1; l <= ne; ++l) {
    if (ed[l] < 1) return 0;
    wmax = ed[l] > wmax ? ed[l] : wmax;
  }
  for (int l = 1; l <= nn; ++l) {
    if (nd[l] < 1) return 0;
    wmax = nd[l] > wmax ? nd[l] : wmax;
  }
  return wmax <= 8 * TX ? wmax : 0;
}

template <int TMN, int NT>
static int gn_bwd_held(size_t smem) {
  return resident_blocks(gn_block_bwd_kernel<TMN, NT>, smem);
}

template <int TMN, int NT>
static cudaError_t launch_gn_bwd(const GnBwdArgs& a, size_t smem, int grid,
                                 float* out, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      gn_block_bwd_kernel<TMN, NT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  gn_block_bwd_kernel<TMN, NT><<<grid, NTHREADS, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce(a.work, grid, a.P, out, stream);
}

}  // namespace g4c

extern "C" {

// Shared-memory bytes one block needs, or 0 if the shapes are not taken.
size_t g4c_gn_block_bwd_smem(int k, int fe, int fv, int ne, const int* ed,
                             int nn, const int* nd) {
  using namespace g4c;
  const int wmax = gn_bwd_wmax(k, fe, fv, ne, ed, nn, nd);
  if (wmax == 0) return 0;
  const int nr = TY * gn_bwd_node_rows_per_thread(k);
  return sizeof(float) *
         ((size_t)(nr * (2 + nn) + GNB_ER * ne) * (wmax + 4) +
          2 * GNB_ER + (size_t)BK * (wmax + 1));
}

// Blocks of the persistent grid, or 0 on error.
int g4c_gn_block_bwd_grid(int k, int fe, int fv, int ne, const int* ed,
                          int nn, const int* nd, int V) {
  using namespace g4c;
  const size_t smem = g4c_gn_block_bwd_smem(k, fe, fv, ne, ed, nn, nd);
  if (smem == 0 || V < 1) return 0;
  const int npb = GNB_ER / k;
  const int tiles = (V + npb - 1) / npb;
  const bool narrow = gn_bwd_wmax(k, fe, fv, ne, ed, nn, nd) <= 4 * TX;
  int held;
  switch (gn_bwd_node_rows_per_thread(k)) {
    case 1:
      held = narrow ? gn_bwd_held<1, 4>(smem) : gn_bwd_held<1, 8>(smem);
      break;
    case 2:
      held = narrow ? gn_bwd_held<2, 4>(smem) : gn_bwd_held<2, 8>(smem);
      break;
    default:
      held = narrow ? gn_bwd_held<3, 4>(smem) : gn_bwd_held<3, 8>(smem);
  }
  return tiles < held ? tiles : held;
}

// e [V*k, fe], vs [S, ed[1]], v [V, fv], senders [V*k] int32 (in [0, S),
// else NaN); ge [V*k, ed[ne]] or null, gv [V, nd[nn]] -> de [V*k, fe],
// dv [V, fv], dh1 [V*k, ed[1]], and into `out` the gradients of the edge
// chain then the node chain, each W0, b0, W1, b1, ..., LN scale, LN bias,
// flat (the Ws rows [fe, fe + fs) of W0 stay zero); `work` holds grid x
// that many floats.  Weights as in g4c_gn_block.
int g4c_gn_block_bwd(const void* e, const void* vs, const void* v,
                     const void* senders, const void* ge, const void* gv,
                     void* de, void* dv, void* dh1, int V, int S, int k,
                     int fe, int fs, int fv, int ne, const void* const* ew,
                     const void* const* eb, const int* ed,
                     const void* eln_scale, const void* eln_bias, int nn,
                     const void* const* nw, const void* const* nb,
                     const int* nd, const void* nln_scale,
                     const void* nln_bias, int out_selu, void* work,
                     int grid, void* out, void* stream) {
  using namespace g4c;
  const size_t smem = g4c_gn_block_bwd_smem(k, fe, fv, ne, ed, nn, nd);
  if (smem == 0 || smem > 232448 || V < 1 || S < 1 || grid < 1 || fs < 0)
    return (int)cudaErrorInvalidValue;
  GnBwdArgs a{};
  a.e = (const float*)e;
  a.vs = (const float*)vs;
  a.v = (const float*)v;
  a.senders = (const int*)senders;
  a.ge = (const float*)ge;
  a.gv = (const float*)gv;
  a.de = (float*)de;
  a.dv = (float*)dv;
  a.dh1 = (float*)dh1;
  a.V = V;
  a.S = S;
  a.k = k;
  a.fe = fe;
  a.fs = fs;
  a.fv = fv;
  a.nodes_per_block = GNB_ER / k;
  a.ne = ne;
  a.nn = nn;
  int64_t off = 0;
  for (int l = 0; l <= ne; ++l) a.ed[l] = ed[l];
  for (int l = 0; l < ne; ++l) {
    a.ew[l] = (const float*)ew[l];
    a.eb[l] = (const float*)eb[l];
    a.off_ew[l] = off;
    off += (int64_t)ed[l] * ed[l + 1];
    a.off_eb[l] = off;
    off += ed[l + 1];
  }
  a.eln_scale = (const float*)eln_scale;
  a.eln_bias = (const float*)eln_bias;
  a.off_eln = off;
  if (eln_scale != nullptr) off += 2 * (int64_t)ed[ne];
  for (int l = 0; l <= nn; ++l) a.nd[l] = nd[l];
  for (int l = 0; l < nn; ++l) {
    a.nw[l] = (const float*)nw[l];
    a.nb[l] = (const float*)nb[l];
    a.off_nw[l] = off;
    off += (int64_t)nd[l] * nd[l + 1];
    a.off_nb[l] = off;
    off += nd[l + 1];
  }
  a.nln_scale = (const float*)nln_scale;
  a.nln_bias = (const float*)nln_bias;
  a.off_nln = off;
  if (nln_scale != nullptr) off += 2 * (int64_t)nd[nn];
  a.P = off;
  a.out_selu = out_selu;
  const int wmax = gn_bwd_wmax(k, fe, fv, ne, ed, nn, nd);
  a.ld = wmax + 4;
  a.work = (float*)work;
  cudaStream_t s = (cudaStream_t)stream;
  float* o = (float*)out;
  const bool narrow = wmax <= 4 * TX;
  switch (gn_bwd_node_rows_per_thread(k)) {
    case 1:
      return (int)(narrow ? launch_gn_bwd<1, 4>(a, smem, grid, o, s)
                          : launch_gn_bwd<1, 8>(a, smem, grid, o, s));
    case 2:
      return (int)(narrow ? launch_gn_bwd<2, 4>(a, smem, grid, o, s)
                          : launch_gn_bwd<2, 8>(a, smem, grid, o, s));
    default:
      return (int)(narrow ? launch_gn_bwd<3, 4>(a, smem, grid, o, s)
                          : launch_gn_bwd<3, 8>(a, smem, grid, o, s));
  }
}

}  // extern "C"
