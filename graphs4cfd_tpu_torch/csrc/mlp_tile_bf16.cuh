// The MLP chain's tiles under the bf16 policy (compute_dtype bfloat16):
// their geometry and launchers.  The backward's tile is shared by
// mlp_chain_bwd.cu (which plans the launch and takes this tile kernel for
// bf16 activations) and mlp_chain_bwd_bf16.cu (the kernels); the forward's
// by mlp_chain.cu (which sends every bf16 chain to it) and
// mlp_chain_fwd_bf16.cu (the kernel).  The f32 chain keeps its 96-row
// 3xTF32 tiles (mlp_tile.cuh).
//
// The backward: a block is four warpgroups and owns ROWS = 128 rows: two
// 64-row m-tiles, each computed by two warpgroups, 64 output columns each.
// Shared memory: the activation tile E [128 x 128] bf16 in wgmma's
// 128-byte swizzled layout (gn_tile_bf16.cuh: toff), an input tile X [128
// x round64(K0)] when the chain's input is wider than 128 (else x lands in
// E), one weight slice [128 x 128] bf16, the scratch (the column sums' 8 x
// 128 f32, the row sums' 4 x 64), 1 KB to align the tiles to 1024 bytes,
// and as many f32 tiles [128][XS_LD] of the layer inputs SELU' reads back
// (xo[1], xo[2], ...) as fit; the others are read back from device memory.
//
// The forward: each warpgroup of a block owns 64-row m-tiles (FWD_ROWS) and
// takes a tile through every layer on its own, 128 output columns a pass
// (m64n128 products, 64 accumulators a thread), with no barrier but its
// own; a block has up to FWD_WG_MAX warpgroups, which share the weights.
// Shared memory: 1 KB of alignment; the weights of every layer as bf16
// images in the products' swizzled layout, rounded once a block
// ("resident": ceil(K / 16) k16 steps of two 64-column blocks, 4 KB a
// step, for each 128 output columns), or, where they do not fit with one
// warpgroup, none ("streamed": each warpgroup rounds a 128-row chunk at a
// time into a slot of its own); and for each warpgroup its activation tile
// E [64 x max(round64(K0), 128)] bf16, which takes x and then each layer's
// output in place.  A chain with an output wider than 128 ("wide") takes
// two such tiles of at least 256 columns, whose layers alternate between
// them, and an f32 stash of a 64 x 128 pass for its LayerNorm.
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

// ---- the forward ----------------------------------------------------------

constexpr int FWD_ROWS = 64;     // rows of an m-tile, one warpgroup's
constexpr int FWD_WG_MAX = 4;    // warpgroups a block, at most
constexpr int FWD_THREADS = 128 * FWD_WG_MAX;
constexpr int FWD_STEP_BYTES = 4096;  // a k16 step of a 128-column image
constexpr int FWD_AUX_BYTES = 32768;  // the stash (64 x 128 f32), a slot

// Whether an output of the chain is wider than 128 (two passes).
__host__ __device__ inline bool fwd_wide(int n, const int* dims) {
  for (int l = 1; l <= n; ++l)
    if (dims[l] > 128) return true;
  return false;
}

// Bytes of the resident weight images of every layer.
__host__ __device__ inline size_t fwd_weight_bytes(int n, const int* dims) {
  size_t b = 0;
  for (int l = 0; l < n; ++l)
    b += (size_t)((dims[l] + 15) / 16) * FWD_STEP_BYTES *
         ((dims[l + 1] + 127) / 128);
  return b;
}

// Columns of a warpgroup's activation tile.
__host__ __device__ inline int fwd_tile_cols(int n, const int* dims) {
  const int w = fwd_wide(n, dims) ? 256 : 128;
  return gn16::round64(dims[0]) > w ? gn16::round64(dims[0]) : w;
}

// Bytes of a warpgroup's own tiles: E (two and the stash if wide), and
// its weight slot if `streamed`.
__host__ __device__ inline size_t fwd_wg_bytes(int n, const int* dims,
                                               bool streamed) {
  const bool wide = fwd_wide(n, dims);
  return (size_t)FWD_ROWS * fwd_tile_cols(n, dims) * 2 * (wide ? 2 : 1) +
         (wide ? FWD_AUX_BYTES : 0) + (streamed ? FWD_AUX_BYTES : 0);
}

__host__ __device__ inline size_t fwd_smem_bytes(int n, const int* dims,
                                                 bool streamed, int g) {
  return 1024 + (streamed ? 0 : fwd_weight_bytes(n, dims)) +
         (size_t)g * fwd_wg_bytes(n, dims, streamed);
}

// Warpgroups a block that fit shared memory, at most FWD_WG_MAX (0: none).
__host__ __device__ inline int fwd_fit(int n, const int* dims,
                                       bool streamed) {
  int g = FWD_WG_MAX;
  while (g > 0 && fwd_smem_bytes(n, dims, streamed, g) > SMEM_LIMIT) --g;
  return g;
}

// The weights are streamed where their images do not fit with one
// warpgroup.
__host__ __device__ inline bool fwd_streamed(int n, const int* dims) {
  return fwd_fit(n, dims, false) == 0;
}

// Rows of x [rows, dims[0]] -> out [rows, dims[n]], bf16, through the
// forward's kernel (mlp_chain_fwd_bf16.cu): ceil(rows / FWD_ROWS) m-tiles
// over at most one wave of blocks; returns the launch error.
cudaError_t launch_fwd(const mlp::MlpArgs<tc::bf16>& a, cudaStream_t s);

}  // namespace mlp16
}  // namespace g4c
