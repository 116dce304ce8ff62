// The GN-block tile shared by gn_block.cu (forward) and gn_block_bwd.cu
// (whose tile kernel recomputes this forward, then runs the chains
// backwards): geometry, arguments, the row passes and the forward itself.
//
// A tile owns `npb` receivers (at most 16) and their npb * k edge rows
// (receiver v owns edge rows [v*k, (v+1)*k)), so the mean over k stays in
// the tile.  npb = min(16, 96 / k): 16 receivers and 16k edge rows for
// k <= 6, fewer receivers for larger k.  Edge tiles have `emt` 16-row
// fragments (edge rows padded to 16), node tiles one (16 rows).  Every
// product runs on the tensor cores (mma_tf32x3.cuh): the edge side as 2 x 4
// warps of 3 x 4 fragments (96 rows x 128 columns), the node side as 1 x 8
// warps of 1 x 2 fragments (16 x 128).  Row-wise work (LayerNorm, the mean
// over k, copies to device memory, column sums) runs one warp per row, each
// lane on four adjacent columns.
//
// The tile code is templated on T, the type of the activations in device
// memory; the kernels instantiate it for float (products on the 3xTF32
// core, tc::Tf32x3).  The bf16 policy's GN kernels have a tile of
// their own (gn_tile_bf16.cuh: bf16 tiles, wgmma); GnArgs and the row
// passes here serve both.
#pragma once

#include <type_traits>

#include "bf16.cuh"
#include "mma_tf32x3.cuh"
#include "tile.cuh"

namespace g4c {
namespace gn {

using tc::bf16;
using tc::round8;
using tc::THREADS;

constexpr int NR = 16;      // node rows of a tile
constexpr int ER_MAX = 96;  // edge rows of a tile, at most

template <int WM_, int MT_, int WN_, int NT_>
struct Layout {
  static constexpr int WM = WM_, MT = MT_, WN = WN_, NT = NT_;
};
using EdgeL = Layout<2, 3, 4, 4>;
using NodeL = Layout<1, 1, 8, 2>;

template <class L>
using Acc = float[L::MT][L::NT][4];

// T: the type of the activations in device memory (e, vs, v, the outputs,
// their cotangents and the backward's cotangent operands); the weights, the
// layer inputs the backward writes for SELU' (xe, xn) and the column sums
// are f32.
template <class T>
struct GnArgs {
  const T* e;
  const T* vs;
  const T* v;
  const int* senders;
  int V, S, k, fe, fs, fv;
  int npb;  // receivers per tile
  int emt;  // 16-row fragments of the edge tile
  int ne, nn;
  // ew[0] is the full first edge layer [fe + fs + fv, ed[1]]: rows [0, fe)
  // are We, rows [fe + fs, fe + fs + fv) are Wr (the Ws rows between them
  // are consumed outside); nw[0] is [Wa; Wv], [ed[ne] + fv, nd[1]].
  const float* ew[MAX_LAYERS];
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
  int lda;  // row stride of the edge and node tiles (4 mod 8)
  int ldv;  // row stride of the v tile (4 mod 8)
  // forward outputs (e_out null when skip_e)
  T* e_out;
  T* v_out;
  // backward: cotangents in (ge null when e' was not stored), gradients out
  const T* ge;
  const T* gv;
  T* de;
  T* dv;
  T* dh1;
  // the weight-gradient operands the tile kernel writes: xe[l - 1] the
  // input of edge layer l and de_op[l] the cotangent of its output
  // (l = 1..ne-1); xn[0] = aggr, xn[l] the input of node layer l (l >= 1),
  // dn_op[l] the cotangent of node layer l's output (l = 0..nn-1); dvr the
  // per-receiver sum of dh1 over its k edges
  float* xe[MAX_LAYERS];
  T* de_op[MAX_LAYERS];
  float* xn[MAX_LAYERS];
  T* dn_op[MAX_LAYERS];
  T* dvr;
  // per-tile column sums (bias and LayerNorm gradients), [tiles][pc]
  float* colsum;
  int pc;
  int cs_eb[MAX_LAYERS], cs_eln, cs_nb[MAX_LAYERS], cs_nln;
  // the bf16 tile's (gn_tile_bf16.cuh): padded edge rows of a tile, and the
  // edge chain's f32 pre-LayerNorm output the backward writes and reads back
  int er;
  float* epre;
};

// ---- fragments ------------------------------------------------------------

template <class L>
__device__ __forceinline__ int warp_row0() {
  return (threadIdx.x >> 5) / L::WN * L::MT * 16;
}
template <class L>
__device__ __forceinline__ int warp_col0() {
  return (threadIdx.x >> 5) % L::WN * L::NT * 8;
}

// acc[r, c] += b[c] for c < N
template <class L>
__device__ __forceinline__ void add_bias(Acc<L>& acc, int N,
                                         const float* __restrict__ b) {
  const int c0 = warp_col0<L>();
#pragma unroll
  for (int j = 0; j < L::NT; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = c0 + tc::frag_col(j, q);
      const float bc = c < N ? __ldg(b + c) : 0.f;
#pragma unroll
      for (int i = 0; i < L::MT; ++i) acc[i][j][q] += bc;
    }
}

template <class L>
__device__ __forceinline__ void apply_selu(Acc<L>& acc) {
#pragma unroll
  for (int i = 0; i < L::MT; ++i)
#pragma unroll
    for (int j = 0; j < L::NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = selu(acc[i][j][q]);
}

// dst[r, c] = acc for c < N, zero for N <= c < round8(N), over the valid
// fragments of a tile of `mtiles` 16-row fragments.
template <class L>
__device__ __forceinline__ void store_tile(const Acc<L>& acc, float* dst,
                                           int ld, int N, int mtiles) {
  const int r0 = warp_row0<L>(), c0 = warp_col0<L>();
  const int N8 = round8(N);
#pragma unroll
  for (int i = 0; i < L::MT; ++i) {
    if (r0 / 16 + i >= mtiles) continue;
#pragma unroll
    for (int j = 0; j < L::NT; ++j) {
      if (c0 + j * 8 >= N8) continue;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = r0 + tc::frag_row(i, q), c = c0 + tc::frag_col(j, q);
        dst[r * ld + c] = c < N ? acc[i][j][q] : 0.f;
      }
    }
  }
}

// out[row0 + r, c] = acc (row stride ldo) for r < valid, c < N; streaming
// stores (an output nothing in the launch reads again), rounded to T.
template <class L, class T>
__device__ __forceinline__ void store_out(const Acc<L>& acc,
                                          T* __restrict__ out,
                                          int64_t row0, int valid, int N,
                                          int64_t ldo) {
  const int r0 = warp_row0<L>(), c0 = warp_col0<L>();
#pragma unroll
  for (int i = 0; i < L::MT; ++i)
#pragma unroll
    for (int j = 0; j < L::NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = r0 + tc::frag_row(i, q), c = c0 + tc::frag_col(j, q);
        if (r < valid && c < N)
          __stcs(out + (row0 + r) * ldo + c, acc[i][j][q]);
      }
}

// acc *= SELU'(a) where X = selu(a) is row-major [rows, N] in device memory
// (written by this block); rows >= valid become 0.
template <class L>
__device__ __forceinline__ void mul_dselu(Acc<L>& acc,
                                          const float* __restrict__ X,
                                          int valid, int N) {
  const int r0 = warp_row0<L>(), c0 = warp_col0<L>();
#pragma unroll
  for (int i = 0; i < L::MT; ++i)
#pragma unroll
    for (int j = 0; j < L::NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = r0 + tc::frag_row(i, q), c = c0 + tc::frag_col(j, q);
        acc[i][j][q] = (r < valid && c < N)
                           ? acc[i][j][q] * dselu_of_selu(X[(size_t)r * N + c])
                           : 0.f;
      }
}

// C: the product core (tc::Tf32x3).
template <class L, class C = tc::Tf32x3>
__device__ __forceinline__ void mm(Acc<L>& acc, const float* A, int lda,
                                   int mtiles, const float* W, int K, int N,
                                   float* ring) {
  tc::mm<L::WM, L::MT, L::WN, L::NT, C>(acc, A, lda, mtiles, W, K, N, ring);
}

template <class L, class C = tc::Tf32x3>
__device__ __forceinline__ void mm_t(Acc<L>& acc, const float* A, int lda,
                                     int mtiles, const float* W, int Kc,
                                     int N, float* ring) {
  tc::mm_t<L::WM, L::MT, L::WN, L::NT, C>(acc, A, lda, mtiles, W, Kc, N,
                                          ring);
}

// ---- rows -----------------------------------------------------------------

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// In the row passes a lane holds columns 4*lane .. 4*lane + 3 of its row
// (rows are at most 128 wide), read and written 16 bytes at a time where
// the row allows.
__device__ __forceinline__ int row_col(int i) {
  return 4 * (threadIdx.x & 31) + i;
}

// x[i] = row[row_col(i)] for columns < N, else 0.
__device__ __forceinline__ void load_row(float (&x)[4], const float* row,
                                         int N) {
  const int c = row_col(0);
  if (c + 3 < N && tc::aligned16(row)) {
    const float4 q = *reinterpret_cast<const float4*>(row + c);
    x[0] = q.x;
    x[1] = q.y;
    x[2] = q.z;
    x[3] = q.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = c + i < N ? row[c + i] : 0.f;
  }
}

// row[row_col(i)] = x[i] for columns < N (streaming stores if `stream`).
__device__ __forceinline__ void store_row(float* row, const float (&x)[4],
                                          int N, bool stream = false) {
  const int c = row_col(0);
  if (c + 3 < N && tc::aligned16(row)) {
    const float4 q = make_float4(x[0], x[1], x[2], x[3]);
    if (stream)
      __stcs(reinterpret_cast<float4*>(row + c), q);
    else
      *reinterpret_cast<float4*>(row + c) = q;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (c + i < N) row[c + i] = x[i];
  }
}

__device__ __forceinline__ bool aligned8(const void* p) {
  return ((uintptr_t)p & 7u) == 0;
}

// load_row of a bf16 row in device memory (8 bytes a lane).
__device__ __forceinline__ void load_row(float (&x)[4], const bf16* row,
                                         int N) {
  const int c = row_col(0);
  if (c + 3 < N && aligned8(row)) {
    const uint2 q = *reinterpret_cast<const uint2*>(row + c);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
    const float2 lo = __bfloat1622float2(h[0]), hi = __bfloat1622float2(h[1]);
    x[0] = lo.x;
    x[1] = lo.y;
    x[2] = hi.x;
    x[3] = hi.y;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      x[i] = c + i < N ? __bfloat162float(row[c + i]) : 0.f;
  }
}

// store_row to a bf16 row in device memory, each value rounded to nearest
// even.
__device__ __forceinline__ void store_row(bf16* row, const float (&x)[4],
                                          int N, bool stream = false) {
  const int c = row_col(0);
  if (c + 3 < N && aligned8(row)) {
    const uint2 q = make_uint2(tc::pack_bf16(x[0], x[1]),
                               tc::pack_bf16(x[2], x[3]));
    if (stream)
      __stcs(reinterpret_cast<uint2*>(row + c), q);
    else
      *reinterpret_cast<uint2*>(row + c) = q;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (c + i < N) row[c + i] = __float2bfloat16_rn(x[i]);
  }
}

// LayerNorm statistics of a row held as x[i] at columns row_col(i) < N
// (zero elsewhere): biased variance, two passes, eps 1e-5.
__device__ __forceinline__ void row_stats(const float (&x)[4], int N,
                                          float& mean, float& rstd) {
  const float inv_n = 1.f / (float)N;
  mean = warp_sum(x[0] + x[1] + x[2] + x[3]) * inv_n;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (row_col(i) < N) {
      const float d = x[i] - mean;
      q += d * d;
    }
  rstd = rsqrtf(warp_sum(q) * inv_n + LN_EPS);
}

// out[c] = sum over the warps, in order, of each warp's cs[i] at column
// row_col(i), for c < N (scratch: 8 x 128 floats of shared memory).  Ends
// with a barrier.
__device__ __forceinline__ void colsum_out(const float (&cs)[4], int N,
                                           float* scratch, float* out) {
  store_row(scratch + (threadIdx.x >> 5) * 128, cs, 128);
  __syncthreads();
  for (int c = threadIdx.x; c < N; c += THREADS) {
    float s = 0.f;
    for (int w = 0; w < tc::WARPS; ++w) s += scratch[w * 128 + c];
    out[c] = s;
  }
  __syncthreads();
}

// out[row0 + r, :N] = T[r, :N] for r < valid (a tile to device memory,
// rounded to out's type, if out is not null; streaming stores if nothing
// in this launch reads `out` back), and, if cs_out is not null, cs_out[c] =
// the column sums over those rows (of the f32 tile).  Starts and ends with
// a barrier.
template <class OutT>
__device__ __forceinline__ void copy_rows(const float* T, int ld, int valid,
                                          int N, OutT* __restrict__ out,
                                          int64_t row0, float* scratch,
                                          float* cs_out, bool stream) {
  __syncthreads();
  float cs[4] = {0.f, 0.f, 0.f, 0.f};
  for (int r = threadIdx.x >> 5; r < valid; r += tc::WARPS) {
    float x[4];
    load_row(x, T + r * ld, N);
    if (out != nullptr) store_row(out + (row0 + r) * N, x, N, stream);
#pragma unroll
    for (int i = 0; i < 4; ++i) cs[i] += x[i];
  }
  if (cs_out != nullptr)
    colsum_out(cs, N, scratch, cs_out);
  else
    __syncthreads();
}

// The backward of a row's LayerNorm (scale, bias; none if scale is null)
// and output SELU (if `selu_out`; only then is `bias` read): x is the
// pre-LN row, g the cotangent of the output, plus add[c] (a shared-memory
// row, if not null) after the SELU; dx the cotangent of x.  The scale and
// bias gradients' shares go to c1 (g * xhat) and c2 (g).
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
  float mean, rstd, sc[4], bi[4] = {0.f, 0.f, 0.f, 0.f}, xh[4], dxh[4];
  float s1 = 0.f, s2 = 0.f;
  row_stats(x, N, mean, rstd);
  load_row(sc, scale, N);
  if (selu_out) load_row(bi, bias, N);
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

// ---- geometry -------------------------------------------------------------

// The widest chain width or edge input, or 0 if the shapes are not taken:
// 2 <= k <= 96, 1..8 layers per chain (min_layers..8), fe and every chain
// width in [1, 128], fv in [1, 256].
static int gn_wmax(int k, int fe, int fv, int ne, const int* ed, int nn,
                   const int* nd, int min_layers) {
  if (k < 2 || k > ER_MAX || ne < min_layers || ne > MAX_LAYERS ||
      nn < min_layers || nn > MAX_LAYERS || fe < 1 || fv < 1 || fv > MAX_FV)
    return 0;
  int wmax = fe;
  for (int l = 1; l <= ne; ++l) {
    if (ed[l] < 1) return 0;
    wmax = ed[l] > wmax ? ed[l] : wmax;
  }
  for (int l = 1; l <= nn; ++l) {
    if (nd[l] < 1) return 0;
    wmax = nd[l] > wmax ? nd[l] : wmax;
  }
  return wmax <= 128 ? wmax : 0;
}

// Receivers per tile and 16-row fragments of the edge tile.
static void gn_geometry(int k, int* npb, int* emt) {
  *npb = ER_MAX / k < NR ? ER_MAX / k : NR;
  *emt = (*npb * k + 15) / 16;
}

// Shared-memory floats of a tile: E, N1, VT and the ring (the backward's
// N2 lives in VT once the forward is recomputed).
static size_t gn_smem_floats(int k, int wmax, int fv) {
  int npb, emt;
  gn_geometry(k, &npb, &emt);
  const size_t lda = round8(wmax) + 4, ldv = round8(fv) + 4;
  return (size_t)emt * 16 * lda + (size_t)NR * lda +
         (size_t)NR * (ldv > lda ? ldv : lda) + 2 * (size_t)tc::STAGE;
}

// ---- the forward ----------------------------------------------------------

// Shared memory of a tile: the edge tile E [emt*16][lda], the node tile N1
// [16][lda], the v tile VT [16][ldv], (backward only, in VT's place after
// the forward) a second node tile N2 [16][lda], and the ring of two weight
// slices.
struct Smem {
  float* E;
  float* N1;
  float* N2;
  float* VT;
  float* ring;
};

// The tile's shared memory from its start (gn_smem_floats floats).
template <class T>
__device__ __forceinline__ Smem smem_layout(const GnArgs<T>& a, float* smem) {
  Smem m;
  m.E = smem;
  m.N1 = m.E + a.emt * 16 * a.lda;
  m.VT = m.N1 + NR * a.lda;
  m.N2 = m.VT;
  m.ring = m.VT + NR * (a.ldv > a.lda ? a.ldv : a.lda);
  return m;
}

// The forward of one tile of receivers [n0, n0 + nv).  BWD = false writes
// e' and v'; BWD = true writes the weight-gradient operands (the inputs of
// edge layers 2..ne, aggr and the inputs of node layers 2..nn) and leaves
// the edge chain's pre-LayerNorm output in E and the node chain's in N1.
template <class T, bool BWD>
__device__ __forceinline__ void gn_forward(const GnArgs<T>& a, const Smem& m,
                                           int64_t n0, int nv) {
  using C = tc::Tf32x3;
  const int k = a.k, lda = a.lda, emt = a.emt;
  const int64_t e0 = n0 * k;
  const int ev = nv * k;
  const int H1 = a.ed[1], He = a.ed[a.ne];
  const int warp = threadIdx.x >> 5;

  tc::load_rows(m.VT, a.ldv, a.v, n0, nv, NR, a.fv, a.fv,
                tc::stream_policy());
  tc::load_rows(m.E, lda, a.e, e0, ev, emt * 16, a.fe, a.fe,
                tc::stream_policy());
  tc::cp_commit();

  // vr = v @ Wr for the tile's receivers (the tile loads land meanwhile)
  {
    Acc<NodeL> acc;
    tc::zero(acc);
    mm<NodeL, C>(acc, m.VT, a.ldv, 1,
                 a.ew[0] + (size_t)(a.fe + a.fs) * H1, a.fv, H1, m.ring);
    store_tile<NodeL>(acc, m.N1, lda, H1, 1);
  }

  // first edge layer: e @ We + vs[senders] + vr[receiver] + b1
  Acc<EdgeL> acc;
  tc::zero(acc);
  mm<EdgeL, C>(acc, m.E, lda, emt, a.ew[0], a.fe, H1, m.ring);
  {
    // the sender rows by index into E (e is read); a sender outside
    // [0, S) gives a NaN row and is not read
    const int H8 = round8(H1);
    static_assert(std::is_same<T, float>::value,
                  "the bf16 GN tile is gn_tile_bf16.cuh's");
    {
      const bool vec = (H1 & 3) == 0 && tc::aligned16(a.vs);
      const int step = vec ? 4 : 1, cpr = H8 / step;
      const uint64_t keep = tc::keep_policy();
      for (int idx = threadIdx.x; idx < emt * 16 * cpr; idx += THREADS) {
        const int r = idx / cpr, c = (idx - r * cpr) * step;
        float* dst = m.E + r * lda + c;
        const int s = r < ev ? __ldg(a.senders + e0 + r) : 0;
        if (r < ev && (unsigned)s >= (unsigned)a.S) {
          for (int q = 0; q < step; ++q)
            dst[q] = c + q < H1 ? __int_as_float(0x7fc00000) : 0.f;
          continue;
        }
        const bool ok = r < ev && c < H1;
        const float* src = ok ? a.vs + (size_t)s * H1 + c : a.vs;
        if (vec)
          tc::cp16(dst, src, ok ? 16 : 0, keep);
        else
          tc::cp4(dst, src, ok ? 4 : 0);
      }
    }
    tc::cp_commit();
    tc::cp_wait<0>();
    __syncthreads();
    const int r0 = warp_row0<EdgeL>(), c0 = warp_col0<EdgeL>();
#pragma unroll
    for (int i = 0; i < EdgeL::MT; ++i)
#pragma unroll
      for (int j = 0; j < EdgeL::NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = r0 + tc::frag_row(i, q), c = c0 + tc::frag_col(j, q);
          if (r < emt * 16 && c < H1)
            acc[i][j][q] += m.E[r * lda + c] + m.N1[(r / k) * lda + c] +
                            __ldg(a.eb[0] + c);
        }
  }
  // the rest of the edge chain; each layer's SELU output replaces the
  // previous one in E (the product ended with a barrier)
  for (int l = 1; l < a.ne; ++l) {
    apply_selu<EdgeL>(acc);
    store_tile<EdgeL>(acc, m.E, lda, a.ed[l], emt);
    if (BWD) copy_rows(m.E, lda, ev, a.ed[l], a.xe[l - 1], e0, nullptr,
                       nullptr, false);
    tc::zero(acc);
    mm<EdgeL, C>(acc, m.E, lda, emt, a.ew[l], a.ed[l], a.ed[l + 1],
                 m.ring);
    add_bias<EdgeL>(acc, a.ed[l + 1], a.eb[l]);
  }
  store_tile<EdgeL>(acc, m.E, lda, He, emt);  // e_pre
  __syncthreads();

  // e_new = LayerNorm(e_pre); aggr = its mean over each receiver's k rows,
  // in order, into N1 (vr is dead); e' = SELU(e_new) if out_selu
  {
    const float inv_k = 1.f / (float)k;
    for (int r = warp; r < NR; r += tc::WARPS) {
      float ag[4] = {0.f, 0.f, 0.f, 0.f};
      if (r < nv)
        for (int j = 0; j < k; ++j) {
          const int q = r * k + j;
          float x[4];
          load_row(x, m.E + q * lda, He);
          if (a.eln_scale != nullptr) {
            float mean, rstd, sc[4], bi[4];
            row_stats(x, He, mean, rstd);
            load_row(sc, a.eln_scale, He);
            load_row(bi, a.eln_bias, He);
#pragma unroll
            for (int i = 0; i < 4; ++i)
              x[i] = (x[i] - mean) * rstd * sc[i] + bi[i];
          }
          if (!BWD && a.e_out != nullptr) {
            float y[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) y[i] = a.out_selu ? selu(x[i]) : x[i];
            store_row(a.e_out + (e0 + q) * He, y, He, true);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) ag[i] += x[i];
        }
#pragma unroll
      for (int i = 0; i < 4; ++i) ag[i] = r < nv ? ag[i] * inv_k : 0.f;
      store_row(m.N1 + r * lda, ag, round8(He));
      if (BWD && r < nv)
        store_row(a.xn[0] + (n0 + r) * He, ag, He, true);
    }
  }

  // node chain: aggr @ Wa + v @ Wv + bn1, then layers 2..nn
  const int Hn1 = a.nd[1];
  Acc<NodeL> nacc;
  tc::zero(nacc);
  mm<NodeL, C>(nacc, m.N1, lda, 1, a.nw[0], He, Hn1, m.ring);
  mm<NodeL, C>(nacc, m.VT, a.ldv, 1, a.nw[0] + (size_t)He * Hn1, a.fv, Hn1,
               m.ring);
  add_bias<NodeL>(nacc, Hn1, a.nb[0]);
  for (int l = 1; l < a.nn; ++l) {
    apply_selu<NodeL>(nacc);
    store_tile<NodeL>(nacc, m.N1, lda, a.nd[l], 1);
    if (BWD) copy_rows(m.N1, lda, nv, a.nd[l], a.xn[l], n0, nullptr,
                       nullptr, false);
    tc::zero(nacc);
    mm<NodeL, C>(nacc, m.N1, lda, 1, a.nw[l], a.nd[l], a.nd[l + 1],
                 m.ring);
    add_bias<NodeL>(nacc, a.nd[l + 1], a.nb[l]);
  }
  store_tile<NodeL>(nacc, m.N1, lda, a.nd[a.nn], 1);  // v_pre
  __syncthreads();
}

}  // namespace gn
}  // namespace g4c
