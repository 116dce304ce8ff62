// bf16 matrix products on Hopper's tensor cores, a product core of the
// bf16 policy (compute_dtype bfloat16): every product of the MLP-chain
// forward when its activations are bf16, and the bf16 rows it reads and
// writes in device memory (the bf16 GN-block kernels, the bf16 chain
// backward and the bf16 weight gradients run wgmma over bf16 tiles,
// gn_tile_bf16.cuh).
//
// The JAX package's kernels compute each product of the bf16 policy as
// jnp.dot(x.astype(bf16), w.astype(bf16), preferred_element_type=f32):
// both operands rounded to bf16, the products exact, the sums in f32
// (pallas_mlp.py:57-58, 135-139; pallas_gnblock.py:56-65, 85-101).  So
// this core rounds each operand to nearest even as it loads the fragment
// (the tiles in shared memory stay f32: the biases, SELU, LayerNorm and
// the mean over k run in f32 between the products, as there) and runs one
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 per 16 reduction
// rows, where 3xTF32 (mma_tf32x3.cuh) runs three m16n8k8 per 8: six times
// fewer product instructions, and a product has 16 of the tensor cores'
// 989 TFLOP/s where one TF32 product has 8 of 495.  As there, each step is
// accumulated into a zeroed fragment and added to the f32 sums with an
// IEEE add, so a long reduction does not pile up the tensor cores'
// truncation one way.
//
// Fragments (PTX ISA, mma.m16n8k16 with .bf16): lane 4g + t holds A rows
// g and g + 8 at reduction columns 2t, 2t + 1 and 2t + 8, 2t + 9, B rows
// 2t, 2t + 1 and 2t + 8, 2t + 9 at column g, each pair packed into 32 bits
// with the lower column in the low half; C as in m16n8k8.  A reduction
// slice whose length is 8 mod 16 (widths are padded to 8) runs its last
// step with the upper 8 rows zero in both operands, whatever shared
// memory holds there.
//
// Rows in device memory are bf16.  Tiles load them 16 bytes (8 values) a
// thread where the row allows (widths that are multiples of 8), convert
// them in registers with the intrinsics and store f32 to shared memory:
// cp.async copies bytes and cannot widen, so these loads are synchronous
// and visible after the caller's next barrier, as the cp.async ones are
// after its wait and barrier.  Keeping the tiles f32 leaves the tile
// geometry and shared-memory layouts of the f32 kernels unchanged.  The
// bf16 GN kernels do not use this core: their tiles are bf16 in shared
// memory and their products wgmma (gn_tile_bf16.cuh).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tf32x3.cuh"

namespace g4c {
namespace tc {

using bf16 = __nv_bfloat16;

// ---- conversions, through the intrinsics only ------------------------------

// lo and hi rounded to nearest even and packed, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// The 8 bf16 values of 16 bytes as floats.
__device__ __forceinline__ void unpack8(const uint4& q, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

// ---- the product ------------------------------------------------------------

// d += a * b for one 16 x 8 x 16 fragment, bf16 inputs, f32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// warp_mma's contract (mma_tf32x3.cuh) with both operands rounded to bf16:
// acc += A @ B over `ksteps` (at most BK / 8) steps of 8 reduction rows,
// run as steps of 16.
template <int MT, int NT>
__device__ __forceinline__ void warp_mma_bf16(float (&acc)[MT][NT][4],
                                              const float* A, int am, int ak,
                                              const float* B, int bk, int bn,
                                              int ksteps, int mtv, int ntv) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* a0 = A + g * am + 2 * t * ak;
  const float* b0 = B + 2 * t * bk + g * bn;
#pragma unroll
  for (int s = 0; s < BK / 16; ++s) {
    if (2 * s >= ksteps) break;
    const bool full = 2 * s + 1 < ksteps;  // rows 8..15 of the step exist
    uint32_t b[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float* bp = b0 + s * 16 * bk + j * 8 * bn;
      if (j < ntv) {
        b[j][0] = pack_bf16(bp[0], bp[bk]);
        b[j][1] = full ? pack_bf16(bp[8 * bk], bp[9 * bk]) : 0u;
      } else {
        b[j][0] = b[j][1] = 0u;
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      if (i >= mtv) continue;
      const float* ap = a0 + i * 16 * am + s * 16 * ak;
      uint32_t a[4];
      a[0] = pack_bf16(ap[0], ap[ak]);
      a[1] = pack_bf16(ap[8 * am], ap[8 * am + ak]);
      a[2] = full ? pack_bf16(ap[8 * ak], ap[9 * ak]) : 0u;
      a[3] = full ? pack_bf16(ap[8 * am + 8 * ak], ap[8 * am + 9 * ak]) : 0u;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (j >= ntv) continue;
        float d[4] = {0.f, 0.f, 0.f, 0.f};
        mma_bf16(d, a, b[j][0], b[j][1]);
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] += d[q];
      }
    }
  }
}

// The bf16 product core (Tf32x3 in mma_tf32x3.cuh is the f32 one).
struct Bf16 {
  template <int MT, int NT>
  __device__ static __forceinline__ void run(float (&acc)[MT][NT][4],
                                             const float* A, int am, int ak,
                                             const float* B, int bk, int bn,
                                             int ksteps, int mtv, int ntv) {
    warp_mma_bf16<MT, NT>(acc, A, am, ak, B, bk, bn, ksteps, mtv, ntv);
  }
};

// The product core of a kernel whose activations are of type T.
template <class T>
struct CoreOf {
  using type = Tf32x3;
};
template <>
struct CoreOf<bf16> {
  using type = Bf16;
};
template <class T>
using Core = typename CoreOf<T>::type;

// ---- bf16 rows --------------------------------------------------------------

// load_rows (mma_tf32x3.cuh) for bf16 rows: dst[r, c] = src[row0 + r, c]
// as f32 for r < valid and c < F, zero for valid <= r < rows or F <= c <
// round8(F).  Synchronous; `policy` is not used.
__device__ __forceinline__ void load_rows(float* dst, int ld,
                                          const bf16* __restrict__ src,
                                          int64_t row0, int valid, int rows,
                                          int F, int64_t lds,
                                          uint64_t /*policy*/) {
  const int F8 = round8(F);
  if ((F & 7) == 0 && (lds & 7) == 0 && aligned16(src)) {
    const int cpr = F8 / 8;
    for (int idx = threadIdx.x; idx < rows * cpr; idx += THREADS) {
      const int r = idx / cpr, c = (idx - r * cpr) * 8;
      float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (r < valid)
        unpack8(__ldg(reinterpret_cast<const uint4*>(
                    src + (row0 + r) * lds + c)),
                f);
      float4* d = reinterpret_cast<float4*>(dst + r * ld + c);
      d[0] = make_float4(f[0], f[1], f[2], f[3]);
      d[1] = make_float4(f[4], f[5], f[6], f[7]);
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * F8; idx += THREADS) {
      const int r = idx / F8, c = idx - r * F8;
      dst[r * ld + c] = r < valid && c < F
                            ? __bfloat162float(src[(row0 + r) * lds + c])
                            : 0.f;
    }
  }
}

// A streaming store of one value of an output row.
__device__ __forceinline__ void st_stream(float* p, float x) { __stcs(p, x); }
__device__ __forceinline__ void st_stream(bf16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

}  // namespace tc
}  // namespace g4c
