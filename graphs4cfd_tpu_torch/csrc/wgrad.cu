// The backward kernels' weight-gradient kernel and fixed-order reduction
// (wgrad.cuh says what they compute), launched by gn_block_bwd.cu and
// mlp_chain_bwd.cu, and on their own by g4c_wgrad (ops.wgrad).  A bf16
// plan goes to the bf16 weight-gradient kernel (wgrad_bf16.cu).
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
// d[row][c], for one (product, chunk, 128-row slice of K) per block, f32
// rows on the 3xTF32 core (bf16 plans: wgrad_bf16.cu).
__global__ void __launch_bounds__(THREADS, 2)
    gn_wgrad_kernel(const WgArgs a) {
  using C = tc::Tf32x3;
  extern __shared__ float smem[];
  int pi = 0;
  while (pi + 1 < a.np && (int)blockIdx.x >= a.p[pi + 1].first) ++pi;
  const float* x = (const float*)a.p[pi].x;
  const float* d = (const float*)a.p[pi].d;
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

}  // namespace gn

cudaError_t launch_wgrad(const SplitPlan& p, cudaStream_t s) {
  using namespace gn;
  if (p.wg_blocks == 0) return cudaSuccess;
  if (p.bf16) return launch_wgrad_bf16(p, s);
  const int smem = (int)(sizeof(float) * WG_STAGES * WG_STAGE);
  cudaError_t err = cudaFuncSetAttribute(
      gn_wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  gn_wgrad_kernel<<<p.wg_blocks, THREADS, smem, s>>>(p.wg);
  return cudaGetLastError();
}

cudaError_t launch_reduce(const SplitPlan& p, cudaStream_t s) {
  using namespace gn;
  if (p.red.ns == 0) return cudaSuccess;
  gn_reduce_kernel<<<dim3(p.red_x, p.red.ns), THREADS, 0, s>>>(p.red);
  return cudaGetLastError();
}

}  // namespace g4c

extern "C" {

// The weight gradients of n products on their own, as a backward launches
// them: out[i] [K[i]][N[i]] = x[i]^T d[i] over rows[i] rows, through the
// weight-gradient kernel and the reduction (`parts`: 2 the kernel, 4 the
// reduction, 6 both).  Under `is_bf16` every d is bf16, x bf16 if xb[i]
// else f32, and both operands are rounded to bf16 (the bf16 kernel); else
// every operand is f32 (the f32 kernel).  `work` holds g4c_wgrad_work
// floats.  Returns the first cudaError_t.
int g4c_wgrad(int n, const void* const* x, const int* xb,
              const void* const* d, const int64_t* rows, const int* K,
              const int* N, void* const* out, void* work, int parts,
              int is_bf16, void* stream) {
  using namespace g4c;
  if (n < 1 || n > MAX_PRODS || work == nullptr)
    return (int)cudaErrorInvalidValue;
  SplitPlan p((float*)work, is_bf16 != 0);
  for (int i = 0; i < n; ++i) {
    if (rows[i] < 1 || K[i] < 1 || N[i] < 1 || N[i] > 128 ||
        (!is_bf16 && xb[i]))
      return (int)cudaErrorInvalidValue;
    float* o = (float*)out[i];
    if (!is_bf16)
      p.prod((const float*)x[i], (const float*)d[i], rows[i], K[i], N[i], o);
    else if (xb[i])
      p.prod((const tc::bf16*)x[i], (const tc::bf16*)d[i], rows[i], K[i],
             N[i], o);
    else
      p.prod((const float*)x[i], (const tc::bf16*)d[i], rows[i], K[i], N[i],
             o);
  }
  cudaError_t err;
  if (parts & 2) {
    err = launch_wgrad(p, (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
  }
  if (parts & 4) {
    err = launch_reduce(p, (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// Floats of g4c_wgrad's work buffer (the chunk partials).
size_t g4c_wgrad_work(int n, const int64_t* rows, const int* K,
                      const int* N) {
  using namespace g4c;
  SplitPlan p(nullptr);
  for (int i = 0; i < n && i < MAX_PRODS; ++i)
    p.prod((const float*)nullptr, (const float*)nullptr, rows[i], K[i], N[i],
           nullptr);
  return p.used;
}

}  // extern "C"
