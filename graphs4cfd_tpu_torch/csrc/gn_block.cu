// Fused fixed-k GN block, forward, with the sender gather inside.
//
// Replaces three TPU kernels of the JAX package, which compute one function:
//   ops/pallas_gnblock.py:_make_fwd_kernel_wg (entry gn_block_fused_wg), the
//     MuS level-1 GN block, _fwd_math;
//   ops/pallas_gnblock.py:_make_fwd_kernel (entry gn_block_fused), the GN
//     block with the sender rows gathered outside; REMuS's down_edge_mp;
//   ops/pallas_edgemp.py:_make_fwd_kernel_fold (entry edge_mp_folded), one
//     REMuS EdgeMP layer on the line graph, _fwd_math_folded.
// EdgeMP is a GN block on the line graph: the k angles of an edge play the
// edges, the edges play the nodes, angle_src is the sender map and the
// source table is the edge table itself (down_edge_mp: the finer level's).
//
//   h1     = e @ We + vs[senders] + repeat_k(v @ Wr) + b1
//   e_new  = edge chain (SELU between layers) + LayerNorm
//   aggr   = mean over the k edges of each receiver of e_new (pre-SELU)
//   hn     = aggr @ Wa + v @ Wv + bn1
//   v_new  = node chain + LayerNorm
//   outputs SELU(e_new), SELU(v_new) if out_selu; e' not stored if skip_e.
//
// vs = src @ Ws [S, ed[1]] is computed outside (a plain matmul); its S rows
// need not be the V receivers (down_edge_mp: S fine edges feed V coarse
// ones), and a sender outside [0, S) makes its receiver's outputs NaN
// instead of reading outside the table.  The TPU kernels gather vs rows
// with a one-hot matmul over a planned window because Mosaic cannot gather
// rows; here each block loads the rows vs[senders[r]] by index straight
// from device memory (MuS: a 20 MB table, held in the 50 MB L2; REMuS level
// 1: 52 MB, more than L2 holds).
//
// Bound on the H100 (V=40448, k=6, H=128, f32): 2*E*H^2*3 + 2*V*H^2*5 =
// 30 GFLOP against 0.31 GB of traffic, so the f32 CUDA cores (67 TFLOP/s)
// bound it at 0.45 ms.  Design: receiver v owns edge rows [v*k, (v+1)*k),
// so a block that owns 96/k receivers owns 96 contiguous edge rows and the
// mean over k stays inside the block.  Edge and node activation tiles stay
// in shared memory from the first layer to the outputs; weights stream
// through shared memory in 32-row slices; no [E, H] gathered tensor and no
// intermediate crosses device memory.
#include "tile.cuh"

namespace g4c {

constexpr int GN_TME = 6;                 // edge rows per thread
constexpr int GN_ER = TY * GN_TME;        // edge rows per block

struct GnArgs {
  const float* e;
  const float* vs;
  const float* v;
  const int* senders;
  float* e_out;  // null when skip_e
  float* v_out;
  int V, S, k, fe, fs, fv;
  int nodes_per_block;
  int ne, nn;  // layers of the edge and node chains
  // ew[0] is the full first edge layer [fe + fs + fv, ed[1]]: rows [0, fe)
  // are We, rows [fe + fs, fe + fs + fv) are Wr (the Ws rows between them
  // are consumed outside).
  const float* ew[MAX_LAYERS];
  const float* eb[MAX_LAYERS];
  int ed[MAX_LAYERS + 1];
  const float* eln_scale;
  const float* eln_bias;
  // nw[0] is the full first node layer [ed[ne] + fv, nd[1]]: rows
  // [0, ed[ne]) are Wa, the rest Wv.
  const float* nw[MAX_LAYERS];
  const float* nb[MAX_LAYERS];
  int nd[MAX_LAYERS + 1];
  const float* nln_scale;
  const float* nln_bias;
  int out_selu;
  int ld;
};

template <int TMN, int NT>
__global__ void __launch_bounds__(NTHREADS) gn_block_kernel(const GnArgs a) {
  constexpr int NR = TY * TMN;  // node rows of the node tiles
  extern __shared__ float smem[];
  float* vt = smem;             // v tile            [NR][ld]
  float* na = vt + NR * a.ld;   // node buffer A     [NR][ld]
  float* nb = na + NR * a.ld;   // node buffer B     [NR][ld]
  float* ea = nb + NR * a.ld;   // edge buffer A     [GN_ER][ld]
  float* eb = ea + GN_ER * a.ld;  // edge buffer B   [GN_ER][ld]
  float* wtile = eb + GN_ER * a.ld;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int k = a.k;
  const int64_t n0 = (int64_t)blockIdx.x * a.nodes_per_block;
  const int nv = a.V - n0 < a.nodes_per_block ? (int)(a.V - n0)
                                              : a.nodes_per_block;
  const int64_t e0 = n0 * k;
  const int ev = nv * k;
  const int H1 = a.ed[1];

  // vr = v @ Wr for the block's receivers
  load_tile(a.v, n0, nv, a.fv, vt, a.ld, NR, false);
  {
    float acc[TMN][NT];
    zero(acc);
    mm_acc<TMN, NT>(acc, vt, a.ld, a.fv, a.ew[0] + (size_t)(a.fe + a.fs) * H1,
                    H1, wtile);
    store_smem(acc, na, a.ld, H1);
  }

  // first edge layer: e @ We + vs[senders] + vr[receiver] + b1
  load_tile(a.e, e0, ev, a.fe, ea, a.ld, GN_ER, false);
  float acc[GN_TME][NT];
  zero(acc);
  mm_acc<GN_TME, NT>(acc, ea, a.ld, a.fe, a.ew[0], H1, wtile);
#pragma unroll
  for (int i = 0; i < GN_TME; ++i) {
    const int r = ty * GN_TME + i;
    if (r >= ev) continue;
    const int s = __ldg(a.senders + e0 + r);
    const float* vrr = na + (r / k) * a.ld;
    if ((unsigned)s >= (unsigned)a.S) {
#pragma unroll
      for (int j = 0; j < NT; ++j) acc[i][j] = __int_as_float(0x7fc00000);
      continue;
    }
    const float* vsr = a.vs + (size_t)s * H1;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = tx + TX * j;
      if (c < H1) acc[i][j] += __ldg(vsr + c) + vrr[c];
    }
  }
  add_bias(acc, H1, a.eb[0]);

  // rest of the edge chain; e_new ends in registers
  float* cur = ea;
  float* nxt = eb;
  for (int l = 1; l < a.ne; ++l) {
    apply_selu(acc);
    store_smem(acc, nxt, a.ld, a.ed[l]);
    float* t = cur;
    cur = nxt;
    nxt = t;
    zero(acc);
    mm_acc<GN_TME, NT>(acc, cur, a.ld, a.ed[l], a.ew[l], a.ed[l + 1], wtile);
    add_bias(acc, a.ed[l + 1], a.eb[l]);
  }
  const int He = a.ed[a.ne];
  if (a.eln_scale != nullptr) layer_norm(acc, He, a.eln_scale, a.eln_bias);
  if (a.e_out != nullptr)
    store_global(acc, a.e_out, e0, ev, He, a.out_selu != 0);
  // `nxt` was last read by the product before the one just finished
  store_smem(acc, nxt, a.ld, He);
  __syncthreads();

  // aggr = mean over each receiver's k rows of the pre-SELU e_new, in a
  // fixed order; vr in `na` is dead now
  const float inv_k = 1.f / (float)k;
  for (int idx = threadIdx.x; idx < NR * He; idx += NTHREADS) {
    const int r = idx / He, c = idx - r * He;
    float s = 0.f;
    if (r < nv)
      for (int j = 0; j < k; ++j) s += nxt[(r * k + j) * a.ld + c];
    na[r * a.ld + c] = s * inv_k;
  }

  // node chain: aggr @ Wa + v @ Wv + bn1, then layers 2..nn
  const int Hn1 = a.nd[1];
  float nacc[TMN][NT];
  zero(nacc);
  mm_acc<TMN, NT>(nacc, na, a.ld, He, a.nw[0], Hn1, wtile);
  mm_acc<TMN, NT>(nacc, vt, a.ld, a.fv, a.nw[0] + (size_t)He * Hn1, Hn1,
                  wtile);
  add_bias(nacc, Hn1, a.nb[0]);
  cur = na;
  nxt = nb;
  for (int l = 1; l < a.nn; ++l) {
    apply_selu(nacc);
    store_smem(nacc, nxt, a.ld, a.nd[l]);
    float* t = cur;
    cur = nxt;
    nxt = t;
    zero(nacc);
    mm_acc<TMN, NT>(nacc, cur, a.ld, a.nd[l], a.nw[l], a.nd[l + 1], wtile);
    add_bias(nacc, a.nd[l + 1], a.nb[l]);
  }
  const int Hn = a.nd[a.nn];
  if (a.nln_scale != nullptr) layer_norm(nacc, Hn, a.nln_scale, a.nln_bias);
  store_global(nacc, a.v_out, n0, nv, Hn, a.out_selu != 0);
}

template <int TMN, int NT>
static cudaError_t launch_gn(const GnArgs& a, size_t smem,
                             cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      gn_block_kernel<TMN, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned grid =
      (unsigned)((a.V + a.nodes_per_block - 1) / a.nodes_per_block);
  gn_block_kernel<TMN, NT><<<grid, NTHREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

static int gn_node_rows_per_thread(int k) {
  const int nodes = GN_ER / k;
  return (nodes + TY - 1) / TY;
}

}  // namespace g4c

extern "C" {

// Shared-memory bytes one block needs, or 0 if the shapes are not taken:
// 2 <= k <= 96, 1..8 layers per chain, every width at most 128.
size_t g4c_gn_block_smem(int k, int fe, int fv, int ne, const int* ed,
                         int nn, const int* nd) {
  using namespace g4c;
  if (k < 2 || k > GN_ER || ne < 1 || ne > MAX_LAYERS || nn < 1 ||
      nn > MAX_LAYERS || fe < 1 || fv < 1)
    return 0;
  int wmax = fe > fv ? fe : fv;
  for (int l = 1; l <= ne; ++l) wmax = ed[l] > wmax ? ed[l] : wmax;
  for (int l = 1; l <= nn; ++l) wmax = nd[l] > wmax ? nd[l] : wmax;
  for (int l = 1; l <= ne; ++l)
    if (ed[l] < 1) return 0;
  for (int l = 1; l <= nn; ++l)
    if (nd[l] < 1) return 0;
  if (wmax > 8 * TX) return 0;
  const int nr = TY * gn_node_rows_per_thread(k);
  return sizeof(float) *
         ((size_t)(3 * nr + 2 * GN_ER) * (wmax + 4) + (size_t)BK * wmax);
}

// e [V*k, fe], vs [S, ed[1]], v [V, fv], senders [V*k] int32 in [0, S);
// e_out [V*k, ed[ne]] or null (skip_e), v_out [V, nd[nn]].  Weights as
// described in GnArgs, f32 row-major; LayerNorm pointers may be null.
int g4c_gn_block(const void* e, const void* vs, const void* v,
                 const void* senders, void* e_out, void* v_out, int V, int S,
                 int k, int fe, int fs, int fv, int ne, const void* const* ew,
                 const void* const* eb, const int* ed, const void* eln_scale,
                 const void* eln_bias, int nn, const void* const* nw,
                 const void* const* nb, const int* nd, const void* nln_scale,
                 const void* nln_bias, int out_selu, void* stream) {
  using namespace g4c;
  const size_t smem = g4c_gn_block_smem(k, fe, fv, ne, ed, nn, nd);
  if (smem == 0 || smem > 232448 || V < 1 || S < 1 || fs < 0)
    return (int)cudaErrorInvalidValue;
  GnArgs a{};
  a.e = (const float*)e;
  a.vs = (const float*)vs;
  a.v = (const float*)v;
  a.senders = (const int*)senders;
  a.e_out = (float*)e_out;
  a.v_out = (float*)v_out;
  a.V = V;
  a.S = S;
  a.k = k;
  a.fe = fe;
  a.fs = fs;
  a.fv = fv;
  a.nodes_per_block = GN_ER / k;
  a.ne = ne;
  a.nn = nn;
  int wmax = fe > fv ? fe : fv;
  for (int l = 0; l < ne; ++l) {
    a.ew[l] = (const float*)ew[l];
    a.eb[l] = (const float*)eb[l];
  }
  for (int l = 0; l <= ne; ++l) {
    a.ed[l] = ed[l];
    if (l > 0 && ed[l] > wmax) wmax = ed[l];
  }
  for (int l = 0; l < nn; ++l) {
    a.nw[l] = (const float*)nw[l];
    a.nb[l] = (const float*)nb[l];
  }
  for (int l = 0; l <= nn; ++l) {
    a.nd[l] = nd[l];
    if (l > 0 && nd[l] > wmax) wmax = nd[l];
  }
  a.eln_scale = (const float*)eln_scale;
  a.eln_bias = (const float*)eln_bias;
  a.nln_scale = (const float*)nln_scale;
  a.nln_bias = (const float*)nln_bias;
  a.out_selu = out_selu;
  a.ld = wmax + 4;
  cudaStream_t s = (cudaStream_t)stream;
  const int tmn = gn_node_rows_per_thread(k);
  const bool narrow = wmax <= 4 * TX;
  switch (tmn) {
    case 1:
      return (int)(narrow ? launch_gn<1, 4>(a, smem, s)
                          : launch_gn<1, 8>(a, smem, s));
    case 2:
      return (int)(narrow ? launch_gn<2, 4>(a, smem, s)
                          : launch_gn<2, 8>(a, smem, s));
    default:
      return (int)(narrow ? launch_gn<3, 4>(a, smem, s)
                          : launch_gn<3, 8>(a, smem, s));
  }
}

}  // extern "C"
