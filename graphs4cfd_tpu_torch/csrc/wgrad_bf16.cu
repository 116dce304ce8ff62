// The weight-gradient kernel of the bf16 policy (compute_dtype bfloat16):
// every dW = X^T D of a bf16 backward's plan (SplitPlan::bf16; wgrad.cuh
// says what the plan holds), on Hopper's warpgroup products over bf16
// tiles in shared memory.  launch_wgrad (wgrad.cu) takes it for a bf16
// plan; the f32 plans keep gn_wgrad_kernel (3xTF32 mma.sync), and both keep
// gn_reduce_kernel after them.
//
// Replaces, under compute_dtype=bfloat16, the weight-gradient products of
// the TPU backward kernels: graphs4cfd_tpu/ops/pallas_mlp.py:136-137 and
// pallas_gnblock.py:62-63, jnp.dot(h_prev.astype(bf16).T, da.astype(bf16),
// preferred_element_type=f32), in the backwards of rows 2, 4, 6 and 10 of
// PERF.md's table.  What it computes is unchanged: for every product and
// every chunk of wgrad_chunk(rows) rows, part[chunk] = X[chunk]^T D[chunk]
// with both operands rounded to bf16 (nearest even) and the sums in f32;
// gn_reduce_kernel then adds the partials in a fixed order.  No float
// atomics: two launches give the same bits.
//
// Bound on the H100: bytes.  At MuS level 1 the GN backward's eight
// products are 30.5 GFLOP (0.031 ms at 989 TFLOP/s) against about 0.6 GB
// of operands (the f32 layer inputs at 4 bytes, the rest at 2), 0.18 ms at
// 3.35 TB/s.  The design it replaces (gn_wgrad_kernel on the bf16
// mma.sync core) widened every bf16 row to f32 in shared memory with
// synchronous loads and rounded every fragment back: its three-stage ring
// did not overlap loads with products and moved twice the shared-memory
// bytes.  Here:
//   - a block owns (product, chunk, 128-column slice of K) as before: two
//     warpgroups, each the 64 x N sums of 64 columns of K in registers (64
//     floats a thread at N = 128), as one wgmma.m64n128k16 per 16 rows:
//     A = X^T read MN-major through the transpose bit, B = D read
//     MN-major, both from the same 128-byte swizzled layout the bf16 GN
//     tile uses (gn_tile_bf16.cuh: toff, desc, wgmma_n128);
//   - the rows stream through a ring of STAGES stages of 64 rows: bf16 rows
//     by 16-byte cp.async straight into the swizzled tiles, STAGES - 1
//     stages ahead; f32 operands (the layer inputs the tile kernels also
//     read back for SELU') through registers, loaded one stage ahead and
//     rounded to bf16 on their way into the tile while the products of the
//     stage before run (the same rounding as a bf16 copy would give; a
//     copy written by the tile kernels would move as many bytes in all and
//     add stores to a tile kernel bound by its registers);
//   - narrow widths (K = 2-5, N = 1 or 3: rows that are not whole 16-byte
//     units) load element by element, only their own columns: K and N are
//     padded to the instruction's 64 x 128 x 16 with whatever the tile
//     holds, which reaches only entries past K or N, never written (rows
//     past the chunk are zero in both operands);
//   - about 100 KB of shared memory and no more than 128 registers a
//     thread, so that two blocks share an SM: one block's loads run while
//     the other's products or barriers do.
// The ring waits with cp.async groups and a block barrier per stage (both
// warpgroups read the whole D stage, so a stage is free only when both are
// done with it), each thread's cp.async writes made visible to the
// products with fence.proxy.async, as the GN tile's sender rows are.
#include "gn_tile_bf16.cuh"
#include "wgrad.cuh"

namespace g4c {
namespace wg16 {

using gn16::bf16;
using gn16::THREADS;

constexpr int STAGE_ROWS = 64;  // rows of a ring stage: four k16 steps
constexpr int STAGES = 3;
constexpr int TILE_BYTES = 16384;  // 64 rows x 128 bf16 (two column blocks)
constexpr int STAGE_BYTES = 2 * TILE_BYTES;  // the X tile, then the D tile
constexpr int SMEM_BYTES = 1024 + STAGES * STAGE_BYTES;

extern __shared__ __align__(16) uint8_t smem_wg[];

// f32 values of one stage of X held in registers: 64 rows x 128 columns
// as 8 float4 a thread.
struct XRegs {
  float4 q[8];
};

// Stage rows [q0, q0 + valid) of X's columns [kb, kb + kw) (row stride K)
// into registers, zero past them: 16-byte loads when the rows allow.
__device__ __forceinline__ void x_load(XRegs& x, const float* __restrict__ X,
                                       int64_t q0, int valid, int kb, int kw,
                                       int K) {
  const bool vec = (K & 3) == 0 && tc::aligned16(X);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int idx = threadIdx.x + i * THREADS;
    const int r = idx >> 5, c = (idx & 31) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid && c < kw) {
      const float* p = X + (q0 + r) * K + kb + c;
      if (vec && c + 4 <= kw) {
        v = __ldg(reinterpret_cast<const float4*>(p));
      } else {
        v.x = __ldg(p);
        if (c + 1 < kw) v.y = __ldg(p + 1);
        if (c + 2 < kw) v.z = __ldg(p + 2);
        if (c + 3 < kw) v.w = __ldg(p + 3);
      }
    }
    x.q[i] = v;
  }
}

// The registers into the swizzled X tile, rounded to bf16.
__device__ __forceinline__ void x_store(uint8_t* tile, const XRegs& x) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int idx = threadIdx.x + i * THREADS;
    const int r = idx >> 5, c = (idx & 31) * 4;
    *reinterpret_cast<uint2*>(tile + gn16::toff(STAGE_ROWS, r, c)) =
        make_uint2(gn16::pack(x.q[i].x, x.q[i].y),
                   gn16::pack(x.q[i].z, x.q[i].w));
  }
}

// tile[r, c] = src[q0 + r, c0 + c] (bf16, row stride F) for r < valid,
// c < w, and zero for valid <= r < 64.  cp.async 16 bytes at a time where
// the rows are whole 16-byte units (visible after the caller's wait; the
// rest of the 64 x 128 tile zero too), else synchronous and only the w
// columns: a column past w of X or of D enters only an entry of the
// product past K or N, which is not written.
__device__ __forceinline__ void bf16_stage(uint8_t* tile,
                                           const bf16* __restrict__ src,
                                           int64_t q0, int valid, int c0,
                                           int w, int F) {
  if ((F & 7) == 0 && tc::aligned16(src)) {
    for (int idx = threadIdx.x; idx < STAGE_ROWS * 16; idx += THREADS) {
      const int r = idx >> 4, c = (idx & 15) * 8;
      const bool ok = r < valid && c < w;
      gn16::cp16(tile + gn16::toff(STAGE_ROWS, r, c),
                 ok ? src + (q0 + r) * F + c0 + c : src, ok ? 16 : 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < STAGE_ROWS * w; idx += THREADS) {
      const int r = idx / w, c = idx - r * w;
      *reinterpret_cast<bf16*>(tile + gn16::toff(STAGE_ROWS, r, c)) =
          r < valid ? src[(q0 + r) * F + c0 + c] : __float2bfloat16_rn(0.f);
    }
  }
}

// d (+)= X^T D over one stage: this warpgroup's 64 columns of the X tile
// (A, MN-major: the transpose bit) times the D tile (B, MN-major), four
// k16 steps.  Issued and committed; gn16::wg_wait() before reading d.
__device__ __forceinline__ void stage_mm(float (&d)[64], uint32_t xt,
                                         uint32_t dt, bool accumulate) {
  gn16::fence_regs(d);
  gn16::wg_fence();
#pragma unroll
  for (int s = 0; s < STAGE_ROWS / 16; ++s) {
    const uint64_t da = gn16::desc(xt + s * 2048, STAGE_ROWS * 128, 1024);
    const uint64_t db = gn16::desc(dt + s * 2048, STAGE_ROWS * 128, 1024);
    gn16::wgmma_n128<1, 1>(d, da, db, accumulate || s > 0 ? 1 : 0);
  }
  gn16::wg_commit();
}

// part[chunk][kb + r][c] = sum over the chunk's rows of X[row][kb + r] *
// D[row][c], rounded operands, f32 sums; one (product, chunk, 128-column
// slice of K) per block.  D is bf16; X bf16 (xb) or f32.
__global__ void __launch_bounds__(THREADS, 2)
    wgrad_bf16_kernel(const WgArgs a) {
  uint8_t* base = smem_wg + ((1024 - (gn16::saddr(smem_wg) & 1023)) & 1023);
  int pi = 0;
  while (pi + 1 < a.np && (int)blockIdx.x >= a.p[pi + 1].first) ++pi;
  const WgProd& p = a.p[pi];
  const int K = p.K, N = p.N, kt = p.kt, xb = p.xb;
  const int local = (int)blockIdx.x - p.first;
  const int chunk = local / kt, kb = (local - chunk * kt) * 128;
  const int kw = min(128, K - kb);
  const int64_t r0 = (int64_t)chunk * p.chunk;
  const int nrows = (int)min((int64_t)p.chunk, p.rows - r0);
  const int ns = (nrows + STAGE_ROWS - 1) / STAGE_ROWS;
  const int wg = gn16::wg_id();
  const float* xf = (const float*)p.x;
  XRegs xr;

  auto slot = [&](int s) { return base + (s % STAGES) * STAGE_BYTES; };
  auto rows_of = [&](int s) {
    return (int)min((int64_t)STAGE_ROWS, r0 + nrows - (r0 + s * STAGE_ROWS));
  };
  // the cp.async part of stage s: D, and X where it is bf16
  auto issue = [&](int s) {
    const int64_t q0 = r0 + (int64_t)s * STAGE_ROWS;
    const int valid = rows_of(s);
    if (xb) bf16_stage(slot(s), (const bf16*)p.x, q0, valid, kb, kw, K);
    bf16_stage(slot(s) + TILE_BYTES, (const bf16*)p.d, q0, valid, 0, N, N);
  };

  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ns) issue(s);
    tc::cp_commit();
  }
  if (!xb && ns > 0) {
    x_load(xr, xf, r0, rows_of(0), kb, kw, K);
    x_store(slot(0), xr);
    if (ns > 1) x_load(xr, xf, r0 + STAGE_ROWS, rows_of(1), kb, kw, K);
  }
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int s = 0; s < ns; ++s) {
    tc::cp_wait<STAGES - 2>();
    gn16::fence_async_smem();
    // stage s landed (every thread's part); every warpgroup is done with
    // stage s - 1, whose slot the next loads take
    __syncthreads();
    if (s + STAGES - 1 < ns) issue(s + STAGES - 1);
    tc::cp_commit();
    stage_mm(acc, gn16::saddr(slot(s)) + wg * (STAGE_ROWS * 128),
             gn16::saddr(slot(s) + TILE_BYTES), s > 0);
    // the f32 X of stage s + 1 (loaded during stage s - 1) into its slot
    // while the products run, and the loads of stage s + 2
    if (!xb && s + 1 < ns) {
      x_store(slot(s + 1), xr);
      if (s + 2 < ns)
        x_load(xr, xf, r0 + (int64_t)(s + 2) * STAGE_ROWS, rows_of(s + 2),
               kb, kw, K);
    }
    gn16::wg_wait(acc);
  }

  // this warpgroup's 64 columns of K, where they exist
  float* out = p.part + (size_t)chunk * K * N + (size_t)kb * N;
  const bool even = (N & 1) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 64 * wg + gn16::frow(h);
    if (r >= kw) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = gn16::fcol(j, 0);
      if (c >= N) continue;
      float* o = out + (size_t)r * N + c;
      if (even) {
        *reinterpret_cast<float2*>(o) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      } else {
        o[0] = acc[4 * j + 2 * h];
        if (c + 1 < N) o[1] = acc[4 * j + 2 * h + 1];
      }
    }
  }
}

}  // namespace wg16

cudaError_t launch_wgrad_bf16(const SplitPlan& p, cudaStream_t s) {
  using namespace wg16;
  for (int i = 0; i < p.wg.np; ++i)
    if (!p.wg.p[i].db || p.wg.p[i].N > 128) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      wgrad_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return err;
  wgrad_bf16_kernel<<<p.wg_blocks, THREADS, SMEM_BYTES, s>>>(p.wg);
  return cudaGetLastError();
}

}  // namespace g4c

extern "C" {

// Shared-memory bytes of one block of the bf16 weight-gradient kernel, its
// registers a thread and resident blocks an SM; returns the CUDA error.
int g4c_wgrad_bf16_occupancy(size_t* smem, int* regs, int* blocks) {
  using namespace g4c::wg16;
  cudaFuncAttributes at;
  cudaError_t err = cudaFuncGetAttributes(&at, (const void*)wgrad_bf16_kernel);
  if (err != cudaSuccess) return (int)err;
  *smem = SMEM_BYTES;
  *regs = at.numRegs;
  err = cudaFuncSetAttribute(wgrad_bf16_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, wgrad_bf16_kernel, THREADS, SMEM_BYTES);
}

}  // extern "C"
