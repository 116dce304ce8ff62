// Sum of rows per segment, each segment's rows added in sorted order.
//
// out[n] = sum of src[perm[j]] over the j with sorted[j] == n, where
// sorted = index[perm] is sorted: the transpose of the gather x[index].
// It replaces the TPU kernels that sum rows into target rows: the one-hot
// dvs update of graphs4cfd_tpu/ops/pallas_gnblock.py:_make_bwd_kernel_wg
// (line 719), which sums the per-edge first-layer cotangents per sender,
// and the transpose of the windowed gather,
// graphs4cfd_tpu/ops/pallas_gather.py:_wt_vjp_bwd (its kernels at lines 57
// and 80).  It is also the backward of ops/segment.py:gather_sorted.
// Bound by bytes: each row of src is read once and each row of out
// written once, with one add per element read.
//
// Segments hold a few rows each (5 at REMuS, 6 at MuS and gMuS), and many
// hold none (most of a halo table's rows, most fine edges under
// down_edge_mp).  One block per segment left most of its 8 warps idle,
// kept one row in flight per busy warp, paid two barriers per 128-column
// slice, and ran as about a hundred waves of short blocks.  So:
//
// * One warp per segment, 8 consecutive segments to a block.  A lane owns
//   4 adjacent columns of a 128-column slice (16-byte loads and stores
//   when F % 4 == 0 and the rows are 16-byte aligned, else 4-byte ones).
//   The warp loads the segment's perm entries in one coalesced load, one
//   lane per row, puts its rows in flight BATCH at a time, and adds them
//   in sorted order, j = lo ... hi - 1, starting from 0: the order in
//   which the plain version (index_put_ with accumulate=True) walks a run
//   on CUDA, so its bits.  No shared memory, no barriers.
// * An empty segment's warp writes zeros and leaves.
// * A segment of more than L rows (a padded batch piles its pad rows onto
//   one segment: 12,000 at the REMuS angle sources, 854 at a halo
//   transpose; halo tables have runs of 50-600) is not walked by one warp:
//   in a chain of dependent loads that long, one warp would be the whole
//   kernel's tail.  Tile blocks, first in the grid, cut the sorted
//   positions into block tiles of NW * TILE rows, TILE rows to a warp.
//   Since L >= TILE, such a segment holds the first or the last row of
//   every warp's rows it meets: each warp takes those of the segments of
//   its first and its last row that have more than L rows, and adds its
//   rows of each in sorted order.  Warp 0 adds each segment's parts in
//   warp order: into out where the segment lies inside the block tile,
//   else into the block's partial (slot 0 for the tile's first row's
//   segment, 1 for its last row's).  The block that writes a segment's
//   last partial (an integer counter per segment; no float atomics) adds
//   the partials: warp w those of blocks w, w + 8, ... in that order,
//   then warp 0 the 8 warps' sums in warp order.  A fixed order: the same
//   bits on every run, though not the plain version's.  A tile block
//   leaves before anything else when no warp finds a row of the same
//   segment L / 2 rows after or before its first or last row (then none
//   of its segments has more than L rows), which is most of them.
// * L is the caller's long_rows: ops/segment.py LONG_ROWS = 32 (against
//   16, 64 and 128 in profile_torch_step.py --segment-cases).
// * A first kernel finds each segment's run, [lo[n], hi[n]), one thread
//   per position j of sorted: where sorted[j - 1] != sorted[j] it writes
//   lo[sorted[j]] = j and hi[sorted[j - 1]] = j (and zeroes the segment's
//   counter).  A pass over sorted, with nothing searched and nothing
//   written for an empty segment: a binary search per segment (the
//   earlier design) was a chain of up to 19 dependent loads per thread,
//   and filling the offsets of runs of empty segments left the work to
//   the few threads at their ends.  So lo[n] and hi[n] of an empty
//   segment hold whatever the scratch held.  A warp takes lo[n] = a as
//   segment n's start only if 0 <= a < rows, sorted[a] == n and a == 0
//   or sorted[a - 1] < n: that holds for no a when segment n is empty,
//   and for its true start only, which the first kernel wrote, when it
//   is not.
// * The sums are launched as a programmatic dependent launch: their
//   blocks start while the first kernel runs, and wait for it only where
//   they need lo and hi.
// * Under the bf16 policy src is bf16 (the GN backward's per-edge sender
//   cotangents, dh1, which the JAX kernels hand on as bf16 rows and add
//   into an f32 table: pallas_gnblock.py:719, pallas_gather.py:184,193):
//   the rows are read 8 bytes (4 values) a lane, widened with the
//   intrinsics, and added in f32 in the same order; out stays f32.  The
//   bytes read halve.
#include <cuda_bf16.h>

#include <climits>

#include "tile.cuh"

namespace g4c {

constexpr unsigned FULL = 0xffffffffu;
constexpr int NW = NTHREADS / 32;
// rows a warp keeps in flight before it adds them (more would take
// registers from the warps an SM holds, or spill)
constexpr int BATCH = 4;
// rows of a block tile per warp; a block tile is NW * TILE rows
constexpr int TILE = 8;
constexpr int BLOCK_ROWS = NW * TILE;

struct SegScratch {
  int64_t* lo;  // [nseg] a nonempty segment's first position in sorted
  int64_t* hi;  // [nseg] and one past its last
  int* done;    // [nseg] partials written, for segments above L rows
  float* part;  // [tile blocks, 2, F] the long segments' partials
};

static int64_t seg_tile_blocks(int64_t rows) {
  return (rows + BLOCK_ROWS - 1) / BLOCK_ROWS;
}

static size_t align256(size_t b) { return (b + 255) / 256 * 256; }

static SegScratch seg_scratch(void* work, int nseg) {
  char* p = (char*)work;
  SegScratch s;
  s.lo = (int64_t*)p;
  p += align256(sizeof(int64_t) * nseg);
  s.hi = (int64_t*)p;
  p += align256(sizeof(int64_t) * nseg);
  s.done = (int*)p;
  p += align256(sizeof(int) * nseg);
  s.part = (float*)p;
  return s;
}

static size_t seg_work_bytes(int64_t rows, int F, int nseg) {
  return 2 * align256(sizeof(int64_t) * nseg) + align256(sizeof(int) * nseg) +
         sizeof(float) * 2 * (size_t)F * seg_tile_blocks(rows);
}

// 4 adjacent floats from column c of a row (zeros past F)
template <bool V4>
__device__ __forceinline__ float4 load4(const float* row, int c, int F) {
  if (V4)
    return c < F ? __ldg(reinterpret_cast<const float4*>(row + c))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  return make_float4(c < F ? __ldg(row + c) : 0.f,
                     c + 1 < F ? __ldg(row + c + 1) : 0.f,
                     c + 2 < F ? __ldg(row + c + 2) : 0.f,
                     c + 3 < F ? __ldg(row + c + 3) : 0.f);
}

// the same for a bf16 row, widened (V4: 8 bytes at once)
template <bool V4>
__device__ __forceinline__ float4 load4(const __nv_bfloat16* row, int c,
                                        int F) {
  if (V4) {
    if (c >= F) return make_float4(0.f, 0.f, 0.f, 0.f);
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(row + c));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
    const float2 lo = __bfloat1622float2(h[0]), hi = __bfloat1622float2(h[1]);
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  }
  return make_float4(c < F ? __bfloat162float(__ldg(row + c)) : 0.f,
                     c + 1 < F ? __bfloat162float(__ldg(row + c + 1)) : 0.f,
                     c + 2 < F ? __bfloat162float(__ldg(row + c + 2)) : 0.f,
                     c + 3 < F ? __bfloat162float(__ldg(row + c + 3)) : 0.f);
}

// the same for a partial another block wrote in this launch (not through
// the read-only path, and not from L1)
template <bool V4>
__device__ __forceinline__ float4 load4_cg(const float* row, int c, int F) {
  if (V4)
    return c < F ? __ldcg(reinterpret_cast<const float4*>(row + c))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  return make_float4(c < F ? __ldcg(row + c) : 0.f,
                     c + 1 < F ? __ldcg(row + c + 1) : 0.f,
                     c + 2 < F ? __ldcg(row + c + 2) : 0.f,
                     c + 3 < F ? __ldcg(row + c + 3) : 0.f);
}

template <bool V4>
__device__ __forceinline__ void store4(float* row, int c, int F, float4 v) {
  if (V4) {
    if (c < F) *reinterpret_cast<float4*>(row + c) = v;
    return;
  }
  if (c < F) row[c] = v.x;
  if (c + 1 < F) row[c + 1] = v.y;
  if (c + 2 < F) row[c + 2] = v.z;
  if (c + 3 < F) row[c + 3] = v.w;
}

__device__ __forceinline__ void add4(float4& s, float4 x) {
  s.x += x.x;
  s.y += x.y;
  s.z += x.z;
  s.w += x.w;
}

// perm[a + lane] where a + lane < b (a lane per row of the first 32)
__device__ __forceinline__ int load_perm(const int* __restrict__ perm,
                                         int64_t a, int64_t b, int lane) {
  return a + lane < b ? __ldg(perm + a + lane) : 0;
}

// The sum over j = a ... b - 1, in that order from 0, of columns c .. c + 3
// of src[perm[j]]; p = load_perm(perm, a, b, lane).  The whole warp calls
// it with the same a, b.
template <class T, bool V4>
__device__ float4 sum_rows(const T* __restrict__ src,
                           const int* __restrict__ perm, int64_t a,
                           int64_t b, int F, int c, int lane, int p) {
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int64_t g = a; g < b; g += 32) {
    const int nb = (int)(b - g < 32 ? b - g : 32);
    if (g > a) p = load_perm(perm, g, b, lane);
    for (int r0 = 0; r0 < nb; r0 += BATCH) {
      float4 x[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int pr = __shfl_sync(FULL, p, (r0 + u) & 31);
        x[u] = r0 + u < nb ? load4<V4>(src + (size_t)pr * F, c, F)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < BATCH; ++u)
        if (r0 + u < nb) add4(s, x[u]);
    }
  }
  return s;
}

// The sums wait for the bounds kernel here (programmatic dependent
// launch: their blocks start while it runs, and what they load before
// this point does not depend on it).
__device__ __forceinline__ void wait_for_bounds() {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  asm volatile("griddepcontrol.wait;" ::: "memory");
#endif
}

__device__ __forceinline__ void let_sums_start() {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  asm volatile("griddepcontrol.launch_dependents;");
#endif
}

// Tile block b: the segments of more than L rows in its block tile (see
// the note at the top).  Every warp works out the same candidates, so the
// block leaves or goes on as one without a barrier.
template <class T, bool V4>
__device__ void tile_block(const T* __restrict__ src,
                           const int* __restrict__ perm,
                           const int* __restrict__ sorted, int64_t rows,
                           int F, int nseg, int L, SegScratch s,
                           float* __restrict__ out, int w, int lane) {
  __shared__ float4 piece[NW][2][32];
  __shared__ int last[2];
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const int64_t b = blockIdx.x, x0 = b * BLOCK_ROWS;
  const int64_t x1 = (x0 + BLOCK_ROWS < rows ? x0 + BLOCK_ROWS : rows) - 1;
  const int64_t t0 = x0 + TILE * w, t1 = t0 + TILE < rows ? t0 + TILE : rows;
  const int p = load_perm(perm, t0, t1, lane);
  // lane l < 2 NW: row r of warp l / 2 (its first row, or its last for odd
  // l), the segment there (raw) and, if rows L / 2 after or before r are
  // in it too, that segment as a candidate (else it has no more than L
  // rows)
  int raw = -1, cand = -1;
  {
    const int64_t u0 = x0 + TILE * (lane / 2);
    const int64_t r = lane % 2 ? (u0 + TILE < rows ? u0 + TILE : rows) - 1 : u0;
    if (lane < 2 * NW && u0 < rows) {
      raw = __ldg(sorted + r);
      const int after = r + L / 2 < rows ? __ldg(sorted + r + L / 2) : -1;
      const int before = r - L / 2 >= 0 ? __ldg(sorted + r - L / 2) : -1;
      if (raw >= 0 && raw < nseg && (after == raw || before == raw))
        cand = raw;
    }
  }
  if (!__any_sync(FULL, cand >= 0)) return;  // the whole block
  wait_for_bounds();
  int64_t clo = 0, chi = 0;
  if (cand >= 0) clo = s.lo[cand], chi = s.hi[cand];
  // the long ones; a warp's last-row entry only where it differs from its
  // first-row segment
  int seg_l = chi - clo > L ? cand : -1;
  const int raw_before = __shfl_up_sync(FULL, raw, 1);
  if (lane % 2 && raw_before == raw) seg_l = -1;
  if (!__any_sync(FULL, seg_l >= 0)) return;  // the whole block
  int seg[2];
  int64_t lo[2], hi[2];
  for (int k = 0; k < 2; ++k) {
    seg[k] = __shfl_sync(FULL, seg_l, 2 * w + k);
    lo[k] = __shfl_sync(FULL, clo, 2 * w + k);
    hi[k] = __shfl_sync(FULL, chi, 2 * w + k);
  }
  // the long segments of the tile's first and last rows: slots 0 and 1
  const int wl = (int)((x1 - x0) / TILE);
  const int kl = __shfl_sync(FULL, raw, 2 * wl + 1) ==
                         __shfl_sync(FULL, raw, 2 * wl)
                     ? 2 * wl
                     : 2 * wl + 1;
  int e[2];
  int64_t elo[2], ehi[2];
  e[0] = __shfl_sync(FULL, seg_l, 0);
  elo[0] = __shfl_sync(FULL, clo, 0);
  ehi[0] = __shfl_sync(FULL, chi, 0);
  e[1] = __shfl_sync(FULL, seg_l, kl);
  elo[1] = __shfl_sync(FULL, clo, kl);
  ehi[1] = __shfl_sync(FULL, chi, kl);
  if (e[1] == e[0]) e[1] = -1;
  const unsigned has = __ballot_sync(FULL, seg_l >= 0);
  for (int c0 = 0; c0 < F; c0 += 128) {
    const int c = c0 + 4 * lane;
    for (int k = 0; k < 2; ++k) {
      // this warp's rows of segment k: [a, z) within [t0, t1)
      const int64_t a = lo[k] > t0 ? lo[k] : t0, z = hi[k] < t1 ? hi[k] : t1;
      const int pa = __shfl_sync(FULL, p, (int)(lane + a - t0) & 31);
      piece[w][k][lane] = seg[k] >= 0 && a < z
                              ? sum_rows<T, V4>(src, perm, a, z, F, c, lane,
                                                pa)
                              : zero;
    }
    __syncthreads();
    if (w == 0) {
      // each segment's parts in warp order (a segment's entries are next
      // to each other among those that exist): into out where all its
      // rows are in this tile, else into the block's partial slot
      float4 acc = zero;
      for (unsigned m = has; m; m &= m - 1) {
        const int i = __ffs(m) - 1, next = __ffs(m & (m - 1)) - 1;
        const int n = __shfl_sync(FULL, seg_l, i);
        add4(acc, piece[i / 2][i % 2][lane]);
        if (next >= 0 && __shfl_sync(FULL, seg_l, next) == n) continue;
        float* dst = n == e[0]   ? s.part + (size_t)(2 * b) * F
                     : n == e[1] ? s.part + (size_t)(2 * b + 1) * F
                                 : out + (size_t)n * F;
        store4<V4>(dst, c, F, acc);
        acc = zero;
      }
    }
    __syncthreads();
  }
  if (w == 0) {
    __threadfence();
    __syncwarp();
    // slot k's segment's partials: blocks lo / BLOCK_ROWS ... (hi - 1) / ...
    if (lane < 2)
      last[lane] = e[lane] >= 0 && atomicAdd(s.done + e[lane], 1) ==
                                       (int)((ehi[lane] - 1) / BLOCK_ROWS -
                                             elo[lane] / BLOCK_ROWS);
  }
  __syncthreads();
  for (int k = 0; k < 2; ++k) {
    if (!last[k]) continue;
    __threadfence();
    const int64_t ba = elo[k] / BLOCK_ROWS, bb = (ehi[k] - 1) / BLOCK_ROWS;
    // the segment's partial of block g is in slot 1 only where it starts
    // inside block g's tile (then it is the segment of the last row)
    const int first = elo[k] % BLOCK_ROWS != 0;
    for (int c0 = 0; c0 < F; c0 += 128) {
      const int c = c0 + 4 * lane;
      float4 acc = zero;
      for (int64_t g = ba + w; g <= bb; g += NW * BATCH) {
        float4 x[BATCH];
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {
          const int64_t gg = g + (int64_t)NW * u;
          x[u] = gg <= bb ? load4_cg<V4>(s.part + (size_t)(2 * gg +
                                                           (gg == ba &&
                                                            first)) *
                                                      F,
                                         c, F)
                          : zero;
        }
#pragma unroll
        for (int u = 0; u < BATCH; ++u)
          if (g + (int64_t)NW * u <= bb) add4(acc, x[u]);
      }
      piece[w][0][lane] = acc;
      __syncthreads();
      if (w == 0) {
        acc = zero;
        for (int u = 0; u < NW; ++u) add4(acc, piece[u][0][lane]);
        store4<V4>(out + (size_t)e[k] * F, c, F, acc);
      }
      __syncthreads();
    }
  }
}

// lo[n] and hi[n] of each nonempty segment n, and done[n] = 0: thread j
// (0 .. rows) compares sorted[j - 1] with sorted[j].
__global__ void __launch_bounds__(NTHREADS)
    segment_bounds_kernel(const int* __restrict__ sorted, int64_t rows,
                          int nseg, SegScratch s) {
  let_sums_start();
  const int64_t j = (int64_t)blockIdx.x * NTHREADS + threadIdx.x;
  if (j > rows) return;
  const int prev = j > 0 ? __ldg(sorted + j - 1) : INT_MIN;
  const int cur = j < rows ? __ldg(sorted + j) : INT_MAX;
  if (prev == cur) return;
  if (cur >= 0 && cur < nseg) {
    s.lo[cur] = j;
    s.done[cur] = 0;
  }
  if (prev >= 0 && prev < nseg) s.hi[prev] = j;
}

// Blocks [0, tile_blocks): tile blocks (tile_block), for the segments
// above L rows.  Then a warp per segment.  6 blocks an SM: 40 registers.
template <class T, bool V4>
__global__ void __launch_bounds__(NTHREADS, 6)
    sorted_segment_sum_kernel(const T* __restrict__ src,
                              const int* __restrict__ perm,
                              const int* __restrict__ sorted, int64_t rows,
                              int F, int nseg, int L, int64_t tile_blocks,
                              SegScratch s, float* __restrict__ out) {
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  if ((int64_t)blockIdx.x < tile_blocks) {
    tile_block<T, V4>(src, perm, sorted, rows, F, nseg, L, s, out, w, lane);
    return;
  }
  const int64_t n = ((int64_t)blockIdx.x - tile_blocks) * NW + w;
  wait_for_bounds();
  if (n >= nseg) return;
  // segment n's run, if lo[n] is its start (see the note at the top)
  int64_t lo = s.lo[n], hi = s.hi[n];
  int p = 0, start = 0;
  if (lo >= 0 && lo < rows) {
    const int first = __ldg(sorted + lo);
    const int before = lo > 0 ? __ldg(sorted + lo - 1) : INT_MIN;
    start = first == n && before < n;
    p = load_perm(perm, lo, hi < rows ? hi : rows, lane);
  }
  if (!start) lo = hi = 0;
  if (hi - lo > L) return;
  float* o = out + (size_t)n * F;
  for (int c0 = 0; c0 < F; c0 += 128) {
    const int c = c0 + 4 * lane;
    store4<V4>(o, c, F,
               lo == hi ? make_float4(0.f, 0.f, 0.f, 0.f)
                        : sum_rows<T, V4>(src, perm, lo, hi, F, c, lane, p));
  }
}

// The sums' launch, src of type T.
template <class T>
static cudaError_t launch_sums(const void* src, const void* perm,
                               const void* sorted, int64_t rows, int F,
                               int nseg, int long_rows, int64_t tile_blocks,
                               const SegScratch& s, void* out,
                               cudaStream_t st) {
  const bool v4 = F % 4 == 0 && (uintptr_t)src % (4 * sizeof(T)) == 0 &&
                  (uintptr_t)out % 16 == 0 && (uintptr_t)s.part % 16 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(tile_blocks + (nseg + NW - 1) / NW));
  cfg.blockDim = dim3(NTHREADS);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg,
                            v4 ? sorted_segment_sum_kernel<T, true>
                               : sorted_segment_sum_kernel<T, false>,
                            (const T*)src, (const int*)perm,
                            (const int*)sorted, rows, F, nseg, long_rows,
                            tile_blocks, s, (float*)out);
}

}  // namespace g4c

extern "C" {

// Bytes of scratch that g4c_sorted_segment_sum takes.
size_t g4c_sorted_segment_sum_work(int64_t rows, int F, int nseg) {
  return g4c::seg_work_bytes(rows, F, nseg);
}

// src [rows, F] (bf16 if `is_bf16`, else f32), perm and sorted [rows]
// int32 -> out [nseg, F] f32;
// long_rows (L) at least TILE = 8; work:
// g4c_sorted_segment_sum_work bytes of scratch, 256-byte aligned, whatever
// it holds.  parts: 1 the bounds kernel, 2 the sums, 3 both (in turn; a
// caller may record an event between them).
int g4c_sorted_segment_sum(const void* src, const void* perm,
                           const void* sorted, int64_t rows, int F, int nseg,
                           int long_rows, void* work, void* out, int parts,
                           int is_bf16, void* stream) {
  using namespace g4c;
  if (rows < 0 || F < 1 || nseg < 1 || long_rows < TILE)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const SegScratch s = seg_scratch(work, nseg);
  if (parts & 1) {
    const unsigned grid = (unsigned)((rows + 1 + NTHREADS - 1) / NTHREADS);
    segment_bounds_kernel<<<grid, NTHREADS, 0, st>>>((const int*)sorted,
                                                     rows, nseg, s);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (parts & 2) {
    // no segment has more than L rows unless rows does
    const int64_t tile_blocks = rows > long_rows ? seg_tile_blocks(rows) : 0;
    const cudaError_t err =
        is_bf16 ? launch_sums<__nv_bfloat16>(src, perm, sorted, rows, F, nseg,
                                             long_rows, tile_blocks, s, out,
                                             st)
                : launch_sums<float>(src, perm, sorted, rows, F, nseg,
                                     long_rows, tile_blocks, s, out, st);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
