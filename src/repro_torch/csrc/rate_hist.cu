// Global quantizer-index histogram for Hopper (sm_90a).
//
// Replaces the Pallas kernel rate_hist._kernel (index_histogram_2d),
// which accumulated counts across its sequential grid into one output
// block.  Blocks here run in parallel, so the reduction is two-level:
// each warp counts into its own 64-bin row of shared memory (eight
// warps, so eight times fewer collisions on the hot bins of a skewed
// index distribution than one shared row), then the block folds its rows
// and adds each non-zero bin to the global (64,) output with one atomic.
//
// Bound by bytes: one int32 read per index.  The grid-stride loop keeps
// reads coalesced and the global atomics down to n_levels per block.
//
// repro_index_histogram_tiles replaces rate_hist._kernel_tiles
// (index_histogram_tiles_2d), the per-(row, band) histogram over the
// banded view that the wrapper then folded into channel groups.  Here a
// block owns one TilePlan tile (or one kChunk-element part of a large
// one) and walks that tile's elements in the tensor's own layout -- the
// group's channels times the band's coded positions, channel-fastest when
// channels are innermost in memory -- so no banded copy, no band-valid
// mask and no fold are needed.  Counts go to per-warp shared bins as in
// the global kernel; a tile counted by one block stores its N bins, a
// larger one adds each non-zero bin with one atomic per part to an
// output the entry point zeroes first.

#include "common.cuh"

namespace {

constexpr int kHistWidth = 64;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = kThreads * 16;  // elements one block counts

__global__ void index_histogram_kernel(const int* __restrict__ idx,
                                       long long n, int n_levels,
                                       int* __restrict__ hist) {
  __shared__ int sh[kWarps][kHistWidth];
  for (int i = threadIdx.x; i < kWarps * kHistWidth; i += blockDim.x)
    (&sh[0][0])[i] = 0;
  __syncthreads();
  int* mine = sh[threadIdx.x >> 5];
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    int v = idx[i];
    if ((unsigned)v < (unsigned)n_levels) atomicAdd(&mine[v], 1);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < n_levels; b += blockDim.x) {
    int s = 0;
    for (int w = 0; w < kWarps; ++w) s += sh[w][b];
    if (s) atomicAdd(&hist[b], s);
  }
}

// Block b counts part b % chunks of tile b / chunks: channels
// [g * group_size, +nch) of channel group g = tile / n_sblocks, coded
// positions [bounds[s], bounds[s + 1]) of band s = tile % n_sblocks
// (through perm for 2-D plans, whose bands are not contiguous runs).
__global__ void index_histogram_tiles_kernel(
    const int* __restrict__ idx, int C, int inner, int group_size,
    int n_sblocks, const int* __restrict__ bounds,
    const int* __restrict__ perm, int n_levels, int chunks,
    int* __restrict__ out) {
  __shared__ int sh[kWarps][kHistWidth];
  for (int i = threadIdx.x; i < kWarps * kHistWidth; i += blockDim.x)
    (&sh[0][0])[i] = 0;
  __syncthreads();
  int tile = blockIdx.x / chunks, part = blockIdx.x % chunks;
  int c0 = (tile / n_sblocks) * group_size;
  int nch = min(group_size, C - c0);
  int k0 = bounds[tile % n_sblocks];
  int len = bounds[tile % n_sblocks + 1] - k0;
  int end = min(nch * len, (part + 1) * kChunk);
  int* mine = sh[threadIdx.x >> 5];
  for (int e = part * kChunk + threadIdx.x; e < end; e += blockDim.x) {
    int c, k;
    if (inner == 1) {
      c = c0 + e % nch;
      k = k0 + e / nch;
    } else {
      k = k0 + e % len;
      c = c0 + e / len;
    }
    int m = perm != nullptr ? __ldg(&perm[k]) : k;
    int v = idx[((m / inner) * C + c) * inner + m % inner];
    if ((unsigned)v < (unsigned)n_levels) atomicAdd(&mine[v], 1);
  }
  __syncthreads();
  int* o = out + tile * n_levels;
  for (int b = threadIdx.x; b < n_levels; b += blockDim.x) {
    int s = 0;
    for (int w = 0; w < kWarps; ++w) s += sh[w][b];
    if (chunks == 1)
      o[b] = s;
    else if (s)
      atomicAdd(&o[b], s);
  }
}

}  // namespace

extern "C" int repro_index_histogram_tiles(const void* idx, int C, int inner,
                                           int group_size, int n_tiles,
                                           int n_sblocks, const void* bounds,
                                           const void* perm, int max_tile,
                                           int n_levels, void* out,
                                           void* stream) {
  if (C <= 0 || inner <= 0 || group_size <= 0 || n_tiles <= 0 ||
      n_sblocks <= 0 || n_tiles % n_sblocks || max_tile <= 0 ||
      n_levels < 1 || n_levels > kHistWidth)
    return (int)cudaErrorInvalidValue;
  int chunks = (max_tile + kChunk - 1) / kChunk;
  long long blocks = (long long)n_tiles * chunks;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (chunks > 1) {
    cudaError_t e = cudaMemsetAsync(
        out, 0, (size_t)n_tiles * n_levels * sizeof(int), s);
    if (e != cudaSuccess) return (int)e;
  }
  index_histogram_tiles_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
      (const int*)idx, C, inner, group_size, n_sblocks, (const int*)bounds,
      (const int*)perm, n_levels, chunks, (int*)out);
  return (int)cudaGetLastError();
}

extern "C" int repro_index_histogram(const void* idx, long long n,
                                     int n_levels, void* hist,
                                     void* stream) {
  if (n <= 0 || n_levels < 1 || n_levels > kHistWidth)
    return (int)cudaErrorInvalidValue;
  long long want = (n + kThreads - 1) / kThreads;
  int blocks = (int)(want < 132 * 8 ? want : 132 * 8);
  index_histogram_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)idx, n, n_levels, (int*)hist);
  return (int)cudaGetLastError();
}
