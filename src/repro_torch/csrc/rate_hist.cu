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
// The ticket is the caller's word for the launch's stream (one per
// device and stream, kernels/_build.py), reset by that last block, so
// launches on several streams of one device may run at once.  Values
// outside [0, n_levels) are not counted.  What binds it on the H100
// (PERF.md): the launch (an empty grid takes ~1.9 us back to back), one
// read round trip, then the cluster barrier pair (~0.6 us) or the
// ticket's chain (~1.2 us).
//
// repro_index_histogram_tiles replaces rate_hist._kernel_tiles
// (index_histogram_tiles_2d), the per-(row, band) histogram over the
// banded view that the wrapper then folded into channel groups.  Here
// the tensor is read in its own layout -- a tile is the group's channels
// times the band's coded positions (through perm for 2-D plans) -- so no
// banded copy, no band-valid mask and no fold are needed.  Bound by bytes
// and, at the serving sizes (512 tiles of 32 or 2,048 indices), by the
// launch and one read round trip, so one call is one device operation
// whatever the tile size: no fill, no atomics on the output, every bin
// stored once.  G threads own a tile, by its size:
//   * tiles of up to 32 * kTileElemsPerThread indices: a warp, so a block
//     holds four tiles and each warp sums its counter words with
//     __reduce_add_sync -- no barrier (the decode boundary: 32 indices a
//     tile, one a lane; 8 lanes a tile with four a lane took 0.0035 ms,
//     a warp 0.0032, PERF.md);
//   * up to 256 * kTileElemsPerThread: one block of G (64-256) threads,
//     ~kTileElemsPerThread indices each, reduced as block_bins does (the
//     prefill boundary: 256 threads a tile);
//   * above: a cluster of eight blocks a tile, summed in distributed
//     shared memory as store_histogram's cluster route does.
// A tile's base, channel count and band bounds are computed once a
// thread.  With channels innermost (inner == 1, the serving boundaries)
// a thread's lanes walk channels, so a warp's loads are contiguous runs
// of a row; with inner > 1 they walk positions.  A position's address
// takes one invariant division (repro::fast_div), each element one add.
// Threads count in registers as #4 does; where one thread would count
// more than kCountsPerThread (tiles above a cluster's worth) or N > 16,
// the warp's equal bins take one shared atomic each (match_count), whose
// 32-bit bins have no such limit, so no tile needs a ticket.

#include <cstdint>

#include "common.cuh"

namespace {

using repro::kHistWidth;
constexpr unsigned kFull = 0xFFFFFFFFu;

// kOneBlockMax: the crossover between the one-block and the cluster route,
// from tools/hist_crossover.py on the H100 (PERF.md).
constexpr long long kOneBlockMax = 4096;
constexpr int kHistThreads = 256;
constexpr int kPerIter = 16;     // indices a thread reads per iteration
enum CountMode : int { kCount8 = 0, kCount16 = 1, kMatch = 2 };

template <int MODE>
__global__ void __launch_bounds__(kHistThreads)
index_histogram_kernel(const int* __restrict__ idx, long long n, bool vec,
                       int n_levels, bool cluster, int* __restrict__ hist,
                       int* __restrict__ rows, unsigned* __restrict__ ticket) {
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
                                         rows, ticket);
}

// -- per-tile histograms --------------------------------------------------------

constexpr int kTileElemsPerThread = 8;   // the indices G is sized for
constexpr int kWarpBlock = 128;          // block of the warp route
constexpr int kBatch = 8;                // positions a thread loads at once
enum TileRoute : int { kWarp = 0, kBlock = 1, kCluster = 2 };

// How G threads walk a tile: W lanes across its channels times R = G / W
// across its positions (channels fastest when inner == 1, positions
// fastest otherwise); lc = ceil(full group's channels / W) channels a
// lane.  G, W and R are powers of two: lw and lr the logs of W and R.
struct TileWalk {
  int G, W, R, lc, lw, lr;
  bool chan_fast;
};

// G threads own each tile, and block b's thread x is thread j of tile
// `tile` (ROUTE as above).  A thread loads its tile's geometry once, then
// counts the elements (position k, channel w + W * l) of the positions
// k0 + r, k0 + r + R, ... of its band, for l < lc.  FLAT: channels
// innermost and no perm (the serving boundaries), so position k's row
// starts at k * C and a batch's loads are plain predicated loads.
template <int MODE, int ROUTE, bool FLAT>
__global__ void __launch_bounds__(kHistThreads)
index_histogram_tiles_kernel(const int* __restrict__ idx, int C, int inner,
                             repro::FastDiv inner_div, int group_size,
                             int n_tiles, int n_sblocks,
                             const int* __restrict__ bounds,
                             const int* __restrict__ perm, int positions,
                             int n_levels, TileWalk walk,
                             int* __restrict__ out) {
  // the match path's bins: one row of kHistWidth per tile of the block
  __shared__ int sh[MODE != kMatch  ? 1
                    : ROUTE == kWarp ? kWarpBlock / 32 * kHistWidth
                                     : kHistWidth];
  const int lane = threadIdx.x & 31;
  int tile, j;
  if constexpr (ROUTE == kWarp) {
    tile = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
    j = lane;
  } else if constexpr (ROUTE == kBlock) {
    tile = blockIdx.x;
    j = threadIdx.x;
  } else {
    repro::cluster_start(true);
    tile = blockIdx.x / repro::kClusterBlocks;
    j = (blockIdx.x % repro::kClusterBlocks) * blockDim.x + threadIdx.x;
  }
  const int slot = ROUTE == kWarp ? threadIdx.x >> 5 : 0;
  int* bins = sh + slot * kHistWidth;
  if constexpr (MODE == kMatch && ROUTE == kWarp) {
    bins[lane] = bins[lane + 32] = 0;          // the warp's own row
    __syncwarp();
  } else if constexpr (MODE == kMatch) {
    if (threadIdx.x < kHistWidth) sh[threadIdx.x] = 0;
    __syncthreads();
  }
  int w, r;
  if (walk.chan_fast) {
    w = j & (walk.W - 1);
    r = j >> walk.lw;
  } else {
    r = j & (walk.R - 1);
    w = j >> walk.lr;
  }
  // the tile's geometry, once: channels [c0, c0 + nch), coded positions
  // [k0, k1) (an empty range for the warps past the last tile); one
  // band spans all positions, so only plans of several read their bounds
  int c0 = 0, nch = 0, k0 = 0, k1 = 0;
  if (tile < n_tiles) {
    const int g = n_sblocks == 1 ? tile : tile / n_sblocks;
    const int s = tile - g * n_sblocks;
    c0 = g * group_size;
    nch = min(group_size, C - c0);
    k0 = n_sblocks == 1 ? 0 : __ldg(&bounds[s]);
    k1 = n_sblocks == 1 ? positions : __ldg(&bounds[s + 1]);
  }
  const unsigned nl = (unsigned)n_levels;
  const unsigned cstride = FLAT ? 1u : (unsigned)inner;   // a channel on
  const unsigned row = (unsigned)C * (unsigned)inner;
  // offset of coded position k's first channel of the tile
  auto position = [&](int k) -> unsigned {
    if constexpr (FLAT) return (unsigned)k * (unsigned)C + (unsigned)c0;
    unsigned m = perm != nullptr ? (unsigned)__ldg(&perm[k]) : (unsigned)k;
    if (inner == 1) return m * (unsigned)C + (unsigned)c0;
    unsigned b = repro::fast_div(m, inner_div);
    return b * row + (m - b * (unsigned)inner) + (unsigned)c0 * cstride;
  };
  // a thread's positions in batches of kBatch, each batch's loads issued
  // before any is counted (one read round trip a batch, not a position);
  // a lane's channels w, w + W, ... one after another (lc is mostly 1)
  uint32_t cnt[repro::kCountWords] = {};
  const unsigned key0 = (unsigned)(slot * kHistWidth);
  for (int l = 0; l < walk.lc; ++l) {
    const int c = w + walk.W * l;
    const unsigned coff = (unsigned)c * cstride;
    const bool on_c = c < nch;
    for (int k = k0 + r;; k += kBatch * walk.R) {
      // the match path runs while any lane of the warp has a position, so
      // every lane takes part in each match; the others while this one does
      const bool more = on_c && k < k1;
      if constexpr (MODE == kMatch) {
        if (!__any_sync(kFull, more)) break;
      } else if (!more) {
        break;
      }
      int v[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int kk = k + i * walk.R;
        v[i] = more && kk < k1 ? __ldg(idx + position(kk) + coff) : -1;
      }
      if constexpr (MODE == kCount8) {
        uint32_t c8 = 0;
#pragma unroll
        for (int i = 0; i < kBatch; ++i)
          c8 += repro::bin8(v[i], (unsigned)v[i] < nl);
        repro::widen8(c8, cnt);
      } else if constexpr (MODE == kCount16) {
#pragma unroll
        for (int i = 0; i < kBatch; ++i)
          repro::count16(v[i], (unsigned)v[i] < nl, cnt);
      } else {
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
          const bool ok = (unsigned)v[i] < nl;
          repro::match_count(sh, ok, key0 + (ok ? (unsigned)v[i] : 0u));
        }
      }
    }
  }
  if constexpr (ROUTE == kWarp) {
    // the warp sums its words (or reads its tile's shared row) and lane b
    // stores bins b and b + 32
    uint32_t sum[repro::kCountWords] = {};
    if constexpr (MODE == kMatch) {
      __syncwarp();
    } else {
      const int n_words = (n_levels + 1) / 2;
#pragma unroll
      for (int i = 0; i < repro::kCountWords; ++i) {
        if (i >= n_words) break;              // uniform across the grid
        sum[i] = __reduce_add_sync(kFull, cnt[i]);
      }
    }
    if (tile >= n_tiles) return;
    int* o = out + (long long)tile * n_levels;
    for (int b = lane; b < n_levels; b += 32) {
      if constexpr (MODE == kMatch) {
        o[b] = bins[b];
      } else {
        uint32_t word = 0;
#pragma unroll
        for (int i = 0; i < repro::kCountWords; ++i)
          if (i == (b >> 1)) word = sum[i];
        o[b] = (int)(word >> ((b & 1) * 16) & 0xFFFFu);
      }
    }
    return;
  }
  int a0, a1;
  repro::block_bins<MODE == kMatch>(cnt, sh, n_levels, a0, a1);
  int* o = out + (long long)tile * n_levels;
  if constexpr (ROUTE == kCluster) {
    repro::cluster_store(a0, a1, n_levels, o);
  } else if (threadIdx.x < 32) {
    if (lane < n_levels) o[lane] = a0;
    if (lane + 32 < n_levels) o[lane + 32] = a1;
  }
}

int pow2_at_least(long long v) {
  int p = 1;
  while (p < v && p < (1 << 30)) p *= 2;
  return p;
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
  // G threads a tile, ~kTileElemsPerThread indices each
  // a full group's channels and the longest band's positions (with one
  // band: every position, the kernel's k1)
  const int gsc = group_size < C ? group_size : C;
  const long long max_len = (max_tile + gsc - 1) / gsc;
  long long want = (max_tile + kTileElemsPerThread - 1) / kTileElemsPerThread;
  TileWalk walk{};
  int route, threads;
  long long blocks;
  if (want <= 32) {
    route = kWarp;
    walk.G = 32;
    threads = kWarpBlock;
    blocks = (n_tiles + kWarpBlock / 32 - 1) / (kWarpBlock / 32);
  } else if (want <= kHistThreads) {
    route = kBlock;
    walk.G = pow2_at_least(want < 64 ? 64 : want);
    threads = walk.G;
    blocks = n_tiles;
  } else {
    route = kCluster;
    threads = kHistThreads;
    walk.G = repro::kClusterBlocks * kHistThreads;
    blocks = (long long)n_tiles * repro::kClusterBlocks;
  }
  walk.chan_fast = inner == 1;
  if (walk.chan_fast) {
    int wc = pow2_at_least(gsc);
    walk.W = wc < walk.G ? wc : walk.G;
    if (walk.W > 32) walk.W = 32;
    walk.R = walk.G / walk.W;
  } else {
    int rc = (int)pow2_at_least(max_len);
    walk.R = rc < walk.G ? rc : walk.G;
    walk.W = walk.G / walk.R;
  }
  walk.lc = (gsc + walk.W - 1) / walk.W;
  auto log2i = [](int v) { int l = 0; while ((1 << l) < v) ++l; return l; };
  walk.lw = log2i(walk.W);
  walk.lr = log2i(walk.R);
  const bool flat = inner == 1 && perm == nullptr;
  // the most a thread counts: its 16-bit fields hold kCountsPerThread
  const long long per_thread = (max_len + walk.R - 1) / walk.R * walk.lc;
  int mode = n_levels <= 4 ? kCount8 : n_levels <= 16 ? kCount16 : kMatch;
  if (per_thread > repro::kCountsPerThread) mode = kMatch;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  repro::FastDiv fd = repro::make_fast_div((unsigned)inner);
#define REPRO_TILES(MODE, ROUTE)                                              \
  e = repro::launch_grid(                                                    \
      flat ? &index_histogram_tiles_kernel<MODE, ROUTE, true>                 \
           : &index_histogram_tiles_kernel<MODE, ROUTE, false>,               \
      blocks, threads, ROUTE == kCluster, (cudaStream_t)stream,               \
      (const int*)idx, C, inner, fd, group_size, n_tiles, n_sblocks,          \
      (const int*)bounds, (const int*)perm, (int)max_len, n_levels, walk,     \
      (int*)out)
#define REPRO_TILES_ROUTE(MODE)                                               \
  if (route == kWarp) { REPRO_TILES(MODE, kWarp); }                           \
  else if (route == kBlock) { REPRO_TILES(MODE, kBlock); }                    \
  else { REPRO_TILES(MODE, kCluster); }
  cudaError_t e;
  if (mode == kCount8) { REPRO_TILES_ROUTE(kCount8); }
  else if (mode == kCount16) { REPRO_TILES_ROUTE(kCount16); }
  else { REPRO_TILES_ROUTE(kMatch); }
#undef REPRO_TILES_ROUTE
#undef REPRO_TILES
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// rows: scratch of rows_cap * kHistWidth int32 (one row per block of the
// many-block route); ticket: the stream's zeroed word (store_histogram).
extern "C" int repro_index_histogram(const void* idx, long long n,
                                     int n_levels, void* hist, void* rows,
                                     long long rows_cap, void* ticket,
                                     void* stream) {
  if (n <= 0 || n_levels < 1 || n_levels > kHistWidth || ticket == nullptr)
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
      (const int*)idx, n, vec, n_levels, g.cluster, (int*)hist, (int*)rows,
      (unsigned*)ticket);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}
