// The backward kernels' weight-gradient kernel and fixed-order reduction
// (wgrad.cuh says what they compute), launched by gn_block_bwd.cu and
// mlp_chain_bwd.cu.
//
// At MuS level 1 the GN backward's operands are about 0.64 GB, the MLP
// chain's edge encoder's about 0.5 GB: each written once by a tile kernel
// and read once here.
#include "gn_tile.cuh"
#include "wgrad.cuh"

namespace g4c {
namespace gn {

constexpr int WG_RS = 32;  // rows per ring stage
constexpr int WG_STAGES = 3;
constexpr int WG_LD = 136;  // 8 mod 16: conflict-free X^T and D reads
constexpr int WG_STAGE = 2 * WG_RS * WG_LD;

// part[chunk][kb + r][c] = sum over the chunk's rows of x[row][kb + r] *
// d[row][c], for one (product, chunk, 128-row slice of K) per block, with
// the product core C (tc::Tf32x3, or tc::Bf16 under the bf16 policy, whose
// operands may be bf16 rows: those load through registers, mma_bf16.cuh).
template <class C>
__global__ void __launch_bounds__(THREADS, 2)
    gn_wgrad_kernel(const WgArgs a) {
  constexpr bool BF16 = std::is_same<C, tc::Bf16>::value;
  extern __shared__ float smem[];
  int pi = 0;
  while (pi + 1 < a.np && (int)blockIdx.x >= a.p[pi + 1].first) ++pi;
  const float* x = (const float*)a.p[pi].x;
  const float* d = (const float*)a.p[pi].d;
  const int xb = a.p[pi].xb, db = a.p[pi].db;
  float* part = a.p[pi].part;
  const int64_t rows = a.p[pi].rows;
  const int K = a.p[pi].K, N = a.p[pi].N, kt = a.p[pi].kt;
  const int local = (int)blockIdx.x - a.p[pi].first;
  const int chunk = local / kt, kb = (local - chunk * kt) * 128;
  const int kw = min(128, K - kb);
  const int64_t r0 = (int64_t)chunk * a.p[pi].chunk;
  const int nrows = (int)min((int64_t)a.p[pi].chunk, rows - r0);
  const int ns = (nrows + WG_RS - 1) / WG_RS;

  using L = Layout<2, 4, 4, 4>;
  const int warp = threadIdx.x >> 5, wm = warp / L::WN, wn = warp % L::WN;
  const int mtv = min(max((kw + 15) / 16 - wm * L::MT, 0), L::MT);
  const int ntv = min(max(round8(N) / 8 - wn * L::NT, 0), L::NT);
  auto issue = [&](int s) {
    float* st = smem + (s % WG_STAGES) * WG_STAGE;
    const int64_t q0 = r0 + (int64_t)s * WG_RS;
    const int valid = (int)min((int64_t)WG_RS, r0 + nrows - q0);
    if (BF16 && xb)
      tc::load_rows(st, WG_LD, (const tc::bf16*)a.p[pi].x + kb, q0, valid,
                    WG_RS, kw, K, tc::stream_policy());
    else
      tc::load_rows(st, WG_LD, x + kb, q0, valid, WG_RS, kw, K,
                    tc::stream_policy());
    if (BF16 && db)
      tc::load_rows(st + WG_RS * WG_LD, WG_LD, (const tc::bf16*)a.p[pi].d,
                    q0, valid, WG_RS, N, N, tc::stream_policy());
    else
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
    C::template run<L::MT, L::NT>(acc, st + wm * L::MT * 16, 1, WG_LD,
                                  st + WG_RS * WG_LD + wn * L::NT * 8, WG_LD,
                                  1, WG_RS / 8, mtv, ntv);
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
// ... in order, then the 8 warps' sums are added in order.  One launch
// takes every segment of a backward (grid.y, each with its own source,
// stride and length), and eight warps split each output's chain of
// dependent loads.
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

template <class C>
static cudaError_t launch_wgrad_core(const SplitPlan& p, cudaStream_t s) {
  const int smem = (int)(sizeof(float) * WG_STAGES * WG_STAGE);
  cudaError_t err = cudaFuncSetAttribute(
      gn_wgrad_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  gn_wgrad_kernel<C><<<p.wg_blocks, THREADS, smem, s>>>(p.wg);
  return cudaGetLastError();
}

}  // namespace gn

cudaError_t launch_wgrad(const SplitPlan& p, cudaStream_t s) {
  using namespace gn;
  if (p.wg_blocks == 0) return cudaSuccess;
  return p.bf16 ? launch_wgrad_core<tc::Bf16>(p, s)
                : launch_wgrad_core<tc::Tf32x3>(p, s);
}

cudaError_t launch_reduce(const SplitPlan& p, cudaStream_t s) {
  using namespace gn;
  if (p.red.ns == 0) return cudaSuccess;
  gn_reduce_kernel<<<dim3(p.red_x, p.red.ns), THREADS, 0, s>>>(p.red);
  return cudaGetLastError();
}

}  // namespace g4c
