// The MLP-chain backward's tile under the bf16 policy (compute_dtype
// bfloat16): its geometry and launcher, shared by mlp_chain_bwd.cu (which
// plans the launch and takes this tile kernel for bf16 activations) and
// mlp_chain_bwd_bf16.cu (the kernels).  The f32 chain keeps its 96-row
// 3xTF32 tiles (mlp_tile.cuh).
//
// A block is four warpgroups and owns ROWS = 128 rows: two 64-row m-tiles,
// each computed by two warpgroups, 64 output columns each.  Shared memory:
// the activation tile E [128 x 128] bf16 in wgmma's 128-byte swizzled
// layout (gn_tile_bf16.cuh: toff), an input tile X [128 x round64(K0)]
// when the chain's input is wider than 128 (else x lands in E), one weight
// slice [128 x 128] bf16, the scratch (the column sums' 8 x 128 f32, the
// row sums' 4 x 64), 1 KB to align the tiles to 1024 bytes, and as many
// f32 tiles [128][XS_LD] of the layer inputs SELU' reads back (xo[1],
// xo[2], ...) as fit; the others are read back from device memory.
#pragma once

#include "gn_tile_bf16.cuh"
#include "mlp_tile.cuh"

namespace g4c {
namespace mlp16 {

constexpr int THREADS = 512;       // four warpgroups
constexpr int ROWS = 128;          // rows of a tile: two 64-row m-tiles
constexpr int E_BYTES = ROWS * 256;  // 128 rows x 128 bf16
constexpr int CS_BYTES = 4096 + 1024;  // column sums, row sums
constexpr int XS_LD = 132;         // row stride (floats) of an f32 xo tile
constexpr int XS_BYTES = ROWS * XS_LD * 4;
constexpr int SMEM_LIMIT = 232448;

// Shared-memory bytes of a tile of a chain whose input is k0 wide, without
// its f32 xo tiles.
__host__ __device__ inline size_t base_bytes(int k0) {
  return 1024 + (size_t)E_BYTES +
         (k0 > 128 ? (size_t)ROWS * gn16::round64(k0) * 2 : 0) +
         gn16::W_BYTES + CS_BYTES;
}

// The f32 xo tiles of an n-layer chain held in shared memory (those of
// layers 1..xs_tiles): as many of its n - 1 hidden layers as fit.
__host__ __device__ inline int xs_tiles(int k0, int n) {
  int t = n - 1;
  while (t > 0 && base_bytes(k0) + (size_t)t * XS_BYTES > SMEM_LIMIT) --t;
  return t;
}

__host__ __device__ inline size_t smem_bytes(int k0, int n) {
  return base_bytes(k0) + (size_t)xs_tiles(k0, n) * XS_BYTES;
}

// 128 x 128 weight slices of the chain's layers: ceil(K_l / 128) each.
__host__ __device__ inline int weight_slices(int n, const int* dims) {
  int s = 0;
  for (int l = 0; l < n; ++l) s += (dims[l] + 127) / 128;
  return s;
}

// The weight-slice kernel, then the tile kernel (mlp_chain_bwd_bf16.cu)
// over ceil(rows / ROWS) tiles; returns the first launch error.
cudaError_t launch_bwd_tile(const mlp::MlpArgs<tc::bf16>& a, size_t smem,
                            cudaStream_t s);

}  // namespace mlp16
}  // namespace g4c
