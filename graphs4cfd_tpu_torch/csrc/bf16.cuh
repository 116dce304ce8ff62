// The bf16 type of the bf16 policy (compute_dtype bfloat16) and its
// rounding, shared by the bf16 kernels (gn_tile_bf16.cuh's tiles, the GN
// tile's bf16 rows): conversions go through the intrinsics only, rounding
// to nearest even as the JAX package's x.astype(bfloat16) does.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace g4c {
namespace tc {

using bf16 = __nv_bfloat16;

// lo and hi rounded to nearest even and packed, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

}  // namespace tc
}  // namespace g4c
