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
// rows; here each tile loads the rows vs[senders[r]] by index with 16-byte
// cp.async (MuS: a 20 MB table, held in the 50 MB L2; REMuS level 1: 52 MB).
//
// Bounds on the H100 (V=40448, k=6, H=128, f32): 2*E*H^2*3 + 2*V*H^2*5 =
// 30 GFLOP against 0.31 GB of traffic.  On the f32 CUDA cores (67 TFLOP/s)
// that is 0.455 ms; on the tensor cores, whose 3xTF32 products cost three
// TF32 operations each (495 TFLOP/s), 0.18 ms.
//
// Design (gn_tile.cuh, mma_tf32x3.cuh), and what it does about the limits
// of the first, SIMT version (2.86 ms at MuS level 1):
//   - the f32 SIMT product loop, whose weight slices were read with
//     synchronous loads between two barriers, becomes 3xTF32 mma.sync on
//     the tensor cores, fed from shared memory with bank-conflict-free
//     strides, the weight slices through a two-stage cp.async ring;
//   - the e and v tiles arrive by cp.async while the tile computes v @ Wr;
//   - each layer's output replaces its input in one edge tile (no
//     ping-pong pair), and LayerNorm, the mean over k and the output
//     stores run row-wise: one block needs 104 KB at the flagship widths
//     (112 KB at fv = 256), so two blocks (16 warps) share an SM where one
//     did before;
//   - 16-row node tiles stay (a receiver's k edges must share the tile),
//     but their products are one 16 x 128 fragment row over 8 warps.
// No intermediate crosses device memory: from the first layer to the
// outputs the tile lives in shared memory.
//
// The bf16 policy (compute_dtype bfloat16: bf16 e, vs, v and outputs)
// launches its own kernel from g4c_gn_block (gn_block_bf16.cu: bf16 tiles
// of 64 receivers, wgmma), with this launcher's arguments.
//
// Widths: every chain width and the edge input fe are at most 128; the
// node input fv may be up to 256 (gMuS concatenates the skip after each up
// step, so mp121 and mp221 take v [V, 256]).  v enters only as the K side
// of v @ Wr and v @ Wv, so only the v tile has its own row stride.
#include "gn_tile.cuh"
#include "gn_tile_bf16.cuh"

namespace g4c {
namespace gn {

template <class T>
__global__ void __launch_bounds__(THREADS, 2) gn_block_kernel(
    const GnArgs<T> a) {
  extern __shared__ float smem[];
  const Smem m = smem_layout(a, smem);
  const int64_t n0 = (int64_t)blockIdx.x * a.npb;
  const int nv = a.V - n0 < a.npb ? (int)(a.V - n0) : a.npb;
  gn_forward<T, false>(a, m, n0, nv);

  // v_new = LayerNorm(v_pre), then SELU if out_selu
  const int Hn = a.nd[a.nn];
  for (int r = threadIdx.x >> 5; r < nv; r += tc::WARPS) {
    float x[4];
    load_row(x, m.N1 + r * a.lda, Hn);
    if (a.nln_scale != nullptr) {
      float mean, rstd, sc[4], bi[4];
      row_stats(x, Hn, mean, rstd);
      load_row(sc, a.nln_scale, Hn);
      load_row(bi, a.nln_bias, Hn);
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = (x[i] - mean) * rstd * sc[i] + bi[i];
    }
    if (a.out_selu)
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = selu(x[i]);
    store_row(a.v_out + (n0 + r) * Hn, x, Hn, true);
  }
}

template <class T>
static int launch_fwd(const void* e, const void* vs, const void* v,
                      const void* senders, void* e_out, void* v_out, int V,
                      int S, int k, int fe, int fs, int fv, int ne,
                      const void* const* ew, const void* const* eb,
                      const int* ed, const void* eln_scale,
                      const void* eln_bias, int nn, const void* const* nw,
                      const void* const* nb, const int* nd,
                      const void* nln_scale, const void* nln_bias,
                      int out_selu, size_t smem, cudaStream_t stream) {
  GnArgs<T> a{};
  a.e = (const T*)e;
  a.vs = (const T*)vs;
  a.v = (const T*)v;
  a.senders = (const int*)senders;
  a.e_out = (T*)e_out;
  a.v_out = (T*)v_out;
  a.V = V;
  a.S = S;
  a.k = k;
  a.fe = fe;
  a.fs = fs;
  a.fv = fv;
  gn_geometry(k, &a.npb, &a.emt);
  a.ne = ne;
  a.nn = nn;
  for (int l = 0; l < ne; ++l) {
    a.ew[l] = (const float*)ew[l];
    a.eb[l] = (const float*)eb[l];
  }
  for (int l = 0; l <= ne; ++l) a.ed[l] = ed[l];
  for (int l = 0; l < nn; ++l) {
    a.nw[l] = (const float*)nw[l];
    a.nb[l] = (const float*)nb[l];
  }
  for (int l = 0; l <= nn; ++l) a.nd[l] = nd[l];
  a.eln_scale = (const float*)eln_scale;
  a.eln_bias = (const float*)eln_bias;
  a.nln_scale = (const float*)nln_scale;
  a.nln_bias = (const float*)nln_bias;
  a.out_selu = out_selu;
  if constexpr (std::is_same<T, tc::bf16>::value) {
    // the bf16 policy's kernel (gn_block_bf16.cu): wgmma on bf16 tiles
    gn16::geometry(k, fv, ne, &a.npb, &a.er);
    a.emt = a.er / 64;
    return (int)gn16::launch_fwd(a, smem, stream);
  } else {
    a.lda = round8(gn_wmax(k, fe, fv, ne, ed, nn, nd, 1)) + 4;
    a.ldv = round8(fv) + 4;
    cudaError_t err = cudaFuncSetAttribute(
        gn_block_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    const unsigned grid = (unsigned)((V + a.npb - 1) / a.npb);
    gn_block_kernel<T><<<grid, THREADS, smem, stream>>>(a);
    return (int)cudaGetLastError();
  }
}

}  // namespace gn
}  // namespace g4c

extern "C" {

// Shared-memory bytes one block needs (of the bf16 policy's kernel if
// `is_bf16`), or 0 if the shapes are not taken: 2 <= k <= 96, 1..8 layers
// per chain, fe and every chain width at most 128, fv at most 256.
size_t g4c_gn_block_smem(int k, int fe, int fv, int ne, const int* ed,
                         int nn, const int* nd, int is_bf16) {
  using namespace g4c::gn;
  const int wmax = gn_wmax(k, fe, fv, ne, ed, nn, nd, 1);
  if (wmax == 0) return 0;
  if (is_bf16) return g4c::gn16::smem_for(k, fv, ne);
  return sizeof(float) * gn_smem_floats(k, wmax, fv);
}

// e [V*k, fe], vs [S, ed[1]], v [V, fv], senders [V*k] int32 in [0, S);
// e_out [V*k, ed[ne]] or null (skip_e), v_out [V, nd[nn]].  Weights as
// described in GnArgs, f32 row-major; LayerNorm pointers may be null.  The
// activations (e, vs, v, e_out, v_out) are bf16 if `is_bf16`, else f32.
int g4c_gn_block(const void* e, const void* vs, const void* v,
                 const void* senders, void* e_out, void* v_out, int V, int S,
                 int k, int fe, int fs, int fv, int ne, const void* const* ew,
                 const void* const* eb, const int* ed, const void* eln_scale,
                 const void* eln_bias, int nn, const void* const* nw,
                 const void* const* nb, const int* nd, const void* nln_scale,
                 const void* nln_bias, int out_selu, int is_bf16,
                 void* stream) {
  using namespace g4c;
  using namespace g4c::gn;
  const size_t smem =
      g4c_gn_block_smem(k, fe, fv, ne, ed, nn, nd, is_bf16);
  if (smem == 0 || smem > 232448 || V < 1 || S < 1 || fs < 0)
    return (int)cudaErrorInvalidValue;
  auto launch = is_bf16 ? launch_fwd<tc::bf16> : launch_fwd<float>;
  return launch(e, vs, v, senders, e_out, v_out, V, S, k, fe, fs, fv, ne, ew,
                eb, ed, eln_scale, eln_bias, nn, nw, nb, nd, nln_scale,
                nln_bias, out_selu, smem, (cudaStream_t)stream);
}

}  // extern "C"
