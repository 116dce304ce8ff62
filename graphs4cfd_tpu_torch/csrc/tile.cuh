// Constants and activations the port's kernels share: the block size of
// the row-wise kernels (gather_rows.cu, sorted_segment_sum.cu), the chain
// limits, SELU and its derivative, LayerNorm's epsilon.  The products of
// the MLP-chain and GN-block kernels run on the tensor cores
// (mma_tf32x3.cuh, gn_tile.cuh, mlp_tile.cuh).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace g4c {

constexpr int NTHREADS = 256;
constexpr int MAX_LAYERS = 8;
// Widest node input of the GN-block kernels (gMuS's v after an up step);
// every other width of theirs is at most 128.
constexpr int MAX_FV = 256;
constexpr float SELU_ALPHA = 1.6732632423543772848170429916717f;
constexpr float SELU_SCALE = 1.0507009873554804934193349852946f;
constexpr float LN_EPS = 1e-5f;

__device__ __forceinline__ float selu(float a) {
  return SELU_SCALE * (a > 0.f ? a : SELU_ALPHA * expm1f(a));
}

// SELU's derivative from its output h = selu(a): a > 0 exactly when h > 0,
// and below 0 scale * alpha * exp(a) = h + scale * alpha.  So a backward
// that keeps the activations needs no pre-activations.
__device__ __forceinline__ float dselu_of_selu(float h) {
  return h > 0.f ? SELU_SCALE : h + SELU_SCALE * SELU_ALPHA;
}

// SELU's derivative at the pre-activation a.
__device__ __forceinline__ float dselu(float a) {
  return a > 0.f ? SELU_SCALE : SELU_SCALE * SELU_ALPHA * expf(a);
}

}  // namespace g4c
