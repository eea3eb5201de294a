// Quantizer-index histograms for Hopper (sm_90a).
//
// repro_index_histogram replaces the Pallas kernel rate_hist._kernel
// (index_histogram_2d), which accumulated counts across its sequential
// grid into one output block.  Bound by bytes (one int32 read per index),
// and at the serving sizes -- 16,384 indices at a decode boundary, 64 KB
// -- by the launch itself, so one call is one device operation: no fill
// of the output, no padding copy, no atomics on the output.  Each thread
// reads four 16-byte vectors of indices per iteration (a scalar tail for
// the rest) and counts them in registers (repro::bin8/widen8 for N <= 4,
// 16-bit fields for N <= 16, one shared atomic per distinct bin of a
// warp for N <= 64; common.cuh); each warp sums its counter words with
// __reduce_add_sync.  Blocks then meet in repro::store_histogram: up to
// kOneBlockMax indices one block reads them all and stores the bins; up
// to eight blocks' worth (the decode boundary) a cluster of eight blocks
// sums its rows in block 0's shared memory after one cluster barrier;
// above that up to two blocks per SM store partial rows into scratch,
// and the last block to finish (an acquire-release ticket) sums them.
// That last route's ticket is this file's __device__ counter, reset by
// that last block: two launches running at once on two streams of one
// device are not supported.  Values outside [0, n_levels) are not
// counted.  What binds it on the H100 (PERF.md): the launch (an
// empty grid takes ~1.9 us back to back), one read round trip, then the
// cluster barrier pair (~0.6 us) or the ticket's chain (~1.2 us).

// repro_index_histogram_tiles replaces rate_hist._kernel_tiles
// (index_histogram_tiles_2d), the per-(row, band) histogram over the
// banded view that the wrapper then folded into channel groups.  Here a
// block owns one TilePlan tile (or one kChunk-element part of a large
// one) and walks that tile's elements in the tensor's own layout -- the
// group's channels times the band's coded positions, channel-fastest when
// channels are innermost in memory -- so no banded copy, no band-valid
// mask and no fold are needed.  Counts go to per-warp shared bins; a tile
// counted by one block stores its N bins, a larger one adds each non-zero
// bin with one atomic per part to an output the entry point zeroes first.

#include <cstdint>

#include "common.cuh"

namespace {

using repro::kHistWidth;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = kThreads * 16;  // elements one block counts

// kOneBlockMax: the crossover between the one-block and the cluster route,
// from tools/hist_crossover.py on the H100 (PERF.md).
constexpr long long kOneBlockMax = 4096;
constexpr int kHistThreads = 256;
constexpr int kPerIter = 16;     // indices a thread reads per iteration
enum CountMode : int { kCount8 = 0, kCount16 = 1, kMatch = 2 };

__device__ unsigned g_ticket;    // see the note at the top

template <int MODE>
__global__ void __launch_bounds__(kHistThreads)
index_histogram_kernel(const int* __restrict__ idx, long long n, bool vec,
                       int n_levels, bool cluster, int* __restrict__ hist,
                       int* __restrict__ rows) {
  __shared__ int sh[kHistWidth];                 // the match path's bins
  repro::cluster_start(cluster);
  if constexpr (MODE == kMatch) {
    if (threadIdx.x < kHistWidth) sh[threadIdx.x] = 0;
    __syncthreads();
  }
  const unsigned nl = (unsigned)n_levels;
  const long long lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * blockDim.x;
  uint32_t cnt[repro::kCountWords] = {};
  auto count = [&](const int (&q)[kPerIter]) {
    if constexpr (MODE == kCount8) {
      uint32_t c8 = 0;
#pragma unroll
      for (int k = 0; k < kPerIter; ++k)
        c8 += repro::bin8(q[k], (unsigned)q[k] < nl);
      repro::widen8(c8, cnt);
    } else if constexpr (MODE == kCount16) {
#pragma unroll
      for (int k = 0; k < kPerIter; ++k)
        repro::count16(q[k], (unsigned)q[k] < nl, cnt);
    } else {
#pragma unroll
      for (int k = 0; k < kPerIter; ++k)
        repro::match_count(sh, (unsigned)q[k] < nl, (unsigned)q[k]);
    }
  };
  // four 16-byte vectors a thread per iteration (two were slower at 2^20
  // indices, PERF.md); the loops run while any lane of the warp has
  // work, so every lane takes part in each match
  const long long n_vec = vec ? n / 4 : 0;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long v = t; v - lane < n_vec; v += 4 * stride) {
    int q[kPerIter];
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      long long u = v + h * stride;
      int4 a = u < n_vec ? __ldg(reinterpret_cast<const int4*>(idx) + u)
                         : make_int4(-1, -1, -1, -1);
      q[4 * h] = a.x;
      q[4 * h + 1] = a.y;
      q[4 * h + 2] = a.z;
      q[4 * h + 3] = a.w;
    }
    count(q);
  }
  for (long long i = n_vec * 4 + t; i - lane < n; i += kPerIter * stride) {
    int q[kPerIter];
#pragma unroll
    for (int k = 0; k < kPerIter; ++k) {
      long long j = i + k * stride;
      q[k] = j < n ? __ldg(idx + j) : -1;
    }
    count(q);
  }
  repro::store_histogram<MODE == kMatch>(cnt, sh, n_levels, cluster, hist,
                                         rows, &g_ticket);
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

// rows: scratch of rows_cap * kHistWidth int32 (one row per block of the
// many-block route).
extern "C" int repro_index_histogram(const void* idx, long long n,
                                     int n_levels, void* hist, void* rows,
                                     long long rows_cap, void* stream) {
  if (n <= 0 || n_levels < 1 || n_levels > kHistWidth)
    return (int)cudaErrorInvalidValue;
  int sms = repro::sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  repro::HistGrid g = repro::histogram_grid(n, kHistThreads, kPerIter,
                                            kOneBlockMax, sms);
  if (g.blocks > rows_cap || g.blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  bool vec = reinterpret_cast<uintptr_t>(idx) % 16 == 0;
  auto kernel = n_levels <= 4    ? index_histogram_kernel<kCount8>
                : n_levels <= 16 ? index_histogram_kernel<kCount16>
                                 : index_histogram_kernel<kMatch>;
  cudaError_t e = repro::launch_grid(
      kernel, g.blocks, kHistThreads, g.cluster, (cudaStream_t)stream,
      (const int*)idx, n, vec, n_levels, g.cluster, (int*)hist, (int*)rows);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}
