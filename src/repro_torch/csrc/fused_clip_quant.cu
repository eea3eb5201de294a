// Fused clip + quantize kernels for Hopper (sm_90a).
//
// repro_clip_quant replaces the Pallas kernel fused_clip_quant._kernel
// (clip_quant_2d): per-tensor clip -> quantize -> dequantize.
// repro_clip_quant_tiles_fast and repro_clip_quant_tiles replace
// fused_clip_quant._kernel_tiles (clip_quant_tiles_2d, clip_quant_rows_2d):
// the same with per-tile ranges under a TilePlan -- the first for plans
// with channels innermost and one spatial block (with the per-tile
// histogram, or the packed indices, in the same launch on request), the
// second for every other plan.
// repro_encode_tiles replaces fused_clip_quant._kernel_encode
// (encode_tiles_2d): clip -> quantize -> bit-pack -> per-(row, band)
// histogram in one pass.
//
// All three are bound by bytes: each element is read once and its outputs
// written once, with a handful of float operations in between.  The
// designs keep exactly one pass over device memory.  clip_quant takes
// its values four at a time -- one 8-byte load of bfloat16 (16 bytes of
// float32), one 16-byte store of their indices, one store of their
// reconstruction when asked -- so every warp access is contiguous
// (eight values a thread and 16-byte loads made each index store a
// 32-byte-strided half sector, and the kernel slower, PERF.md);
// asked for the histogram of its
// indices, it counts them in registers as it quantizes and stores the
// bins as the index histogram (#4) does (repro::store_histogram,
// common.cuh), so the serving path's rate estimate takes no second pass
// over the indices, and a caller that needs no reconstruction gets none
// written.  The histogram variant picks its grid as #4 does: one block
// up to kOneBlockMax values, a cluster of eight blocks up to eight
// blocks' worth (a decode boundary, 16,384 bfloat16 values), the ticket
// route above, on the caller's ticket word for its stream.  There the
// launch, not the bytes, is the cost: an empty grid takes ~1.9 us back
// to back, this kernel 3.7 us (PERF.md).
// repro_clip_quant_pack is the same pass writing the indices bit-packed to
// the wire width (1, 2 or 4 bits; pack_bits._kernel's byte layout) in
// place of the int32 indices, with the histogram: the packed split
// runtime's quantize-and-pack stage as one launch, where the reference
// packs in a second pass (its pack_bits module notes that the pack
// belongs in this one).  It keeps no int32 index tensor and no
// reconstruction: 2 B read and 1 / per B written a value at bfloat16.
// clip_quant_tiles (the element route) is a grid-stride elementwise loop
// with each thread looking up its element's tile (repro::tile_of) and
// that tile's range, so the tensor is read in its own layout -- the
// Pallas kernel's banded, lane-padded copy existed only so a (rows, 1)
// range column could broadcast over a VMEM block; the fast route's note
// below says how it takes a tile's range once.  encode_tiles keeps the
// int32 index tensor out of device memory; its note below says what
// bounds it.

#include <cstdint>

#include "common.cuh"

namespace {

using repro::kHistWidth;  // lanes per (row, band) histogram
constexpr int kThreads = 256;

// -- per-tensor clip + quantize (+ dequantize) (+ histogram) -----------------

// kOneBlockMax: the crossover between the one-block and the cluster route
// of the histogram variant, from tools/hist_crossover.py on the H100
// (PERF.md).
constexpr long long kOneBlockMax = 4096;
constexpr int kPerIter = 8;           // values a thread per iteration
using repro::kCount16;
using repro::kCount8;
using repro::kMatch;
using repro::kNoHist;
using repro::Quad;

template <typename T>
__device__ __forceinline__ int quantize_one(T v, float lo, float hi,
                                            float scale, float inv_scale,
                                            T* d) {
  float q = repro::quant_level(repro::to_f32(v), lo, hi, scale);
  *d = repro::from_f32<T>(__fadd_rn(lo, __fmul_rn(q, inv_scale)));
  return (int)q;
}

// A thread quantizes two groups of four values an iteration, `stride`
// groups apart.  The loops run while any lane of the warp has work, so
// every lane takes part in each match.
template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads)
clip_quant_kernel(const T* __restrict__ x, long long n, bool vec, float lo,
                  float hi, float scale, float inv_scale, int n_levels,
                  bool cluster, int* __restrict__ idx, T* __restrict__ deq,
                  int* __restrict__ hist, int* __restrict__ rows,
                  unsigned* __restrict__ ticket) {
  using Q = typename Quad<T>::type;
  __shared__ int sh[kHistWidth];                 // the match path's bins
  repro::cluster_start(cluster);
  if constexpr (MODE == kMatch) {
    if (threadIdx.x < kHistWidth) sh[threadIdx.x] = 0;
    __syncthreads();
  }
  const unsigned nl = (unsigned)n_levels;
  const long long lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t cnt[repro::kCountWords] = {};
  const long long n_grp = vec ? n / 4 : 0;
  for (long long g = t; g - lane < n_grp; g += 2 * stride) {
    int q[kPerIter];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long u = g + h * stride;
      if (u < n_grp) {
        Q raw = __ldg(reinterpret_cast<const Q*>(x) + u);
        const T* e = reinterpret_cast<const T*>(&raw);
        Q out;
        T* d = reinterpret_cast<T*>(&out);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          q[4 * h + k] = quantize_one(e[k], lo, hi, scale, inv_scale, &d[k]);
        reinterpret_cast<int4*>(idx)[u] =
            make_int4(q[4 * h], q[4 * h + 1], q[4 * h + 2], q[4 * h + 3]);
        if (deq != nullptr) reinterpret_cast<Q*>(deq)[u] = out;
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) q[4 * h + k] = -1;   // counted nowhere
      }
    }
    repro::count_levels<MODE>(q, nl, sh, cnt);
  }
  // the scalar tail (all of it when a buffer is not aligned)
  for (long long i = n_grp * 4 + t; i - lane < n; i += kPerIter * stride) {
    int q[kPerIter];
#pragma unroll
    for (int k = 0; k < kPerIter; ++k) {
      const long long j = i + k * stride;
      q[k] = -1;
      if (j < n) {
        T d;
        q[k] = quantize_one(x[j], lo, hi, scale, inv_scale, &d);
        idx[j] = q[k];
        if (deq != nullptr) deq[j] = d;
      }
    }
    repro::count_levels<MODE>(q, nl, sh, cnt);
  }
  if constexpr (MODE != kNoHist)
    repro::store_histogram<MODE == kMatch>(cnt, sh, n_levels, cluster,
                                           hist, rows, ticket);
}

// clip_quant_kernel's histogram variant writing packed bytes.  A thread
// quantizes units of whole bytes from the values it loads: a group of
// four (BITS 2: one byte; BITS 4: two, one 16-bit store) two units an
// iteration `stride` units apart, or two adjacent groups (BITS 1: one
// byte) one unit an iteration; so a warp's byte stores are contiguous.
// The tail (all of it when a buffer is not aligned) packs whole bytes
// from consecutive values: kPerIter / PER bytes a thread an iteration,
// `stride` bytes apart.  Lanes are summed and each byte's low 8 bits
// kept, as pack_bits.cu does (the indices lie in [0, 2^BITS) here).
template <typename T, int MODE, int BITS>
__global__ void __launch_bounds__(kThreads)
clip_quant_pack_kernel(const T* __restrict__ x, long long n, bool vec,
                       float lo, float hi, float scale, int n_levels,
                       bool cluster, unsigned char* __restrict__ packed,
                       int* __restrict__ hist, int* __restrict__ rows,
                       unsigned* __restrict__ ticket) {
  using Q = typename Quad<T>::type;
  constexpr int PER = 8 / BITS;                  // values a byte
  constexpr int UV = BITS == 1 ? 8 : 4;          // values a unit
  constexpr int UB = UV / PER;                   // bytes a unit: 1 or 2
  constexpr int UNITS = kPerIter / UV;           // units an iteration
  __shared__ int sh[kHistWidth];                 // the match path's bins
  repro::cluster_start(cluster);
  if constexpr (MODE == kMatch) {
    if (threadIdx.x < kHistWidth) sh[threadIdx.x] = 0;
    __syncthreads();
  }
  const unsigned nl = (unsigned)n_levels;
  const long long lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t cnt[repro::kCountWords] = {};
  const long long n_unit = vec ? n / UV : 0;
  for (long long u0 = t; u0 - lane < n_unit; u0 += UNITS * stride) {
    int q[kPerIter];
#pragma unroll
    for (int h = 0; h < UNITS; ++h) {
      const long long u = u0 + h * stride;
      if (u < n_unit) {
        Q raw[UV / 4];
#pragma unroll
        for (int i = 0; i < UV / 4; ++i)
          raw[i] = __ldg(reinterpret_cast<const Q*>(x) + u * (UV / 4) + i);
        const T* e = reinterpret_cast<const T*>(raw);
        unsigned word = 0;
#pragma unroll
        for (int b = 0; b < UB; ++b) {
          unsigned acc = 0;
#pragma unroll
          for (int j = 0; j < PER; ++j) {
            const int k = b * PER + j;
            q[h * UV + k] = (int)repro::quant_level(repro::to_f32(e[k]), lo,
                                                    hi, scale);
            acc += (unsigned)q[h * UV + k] << (j * BITS);
          }
          word |= (acc & 0xFFu) << (8 * b);
        }
        if constexpr (UB == 2)
          reinterpret_cast<uint16_t*>(packed)[u] = (uint16_t)word;
        else
          packed[u] = (unsigned char)word;
      } else {
#pragma unroll
        for (int k = 0; k < UV; ++k) q[h * UV + k] = -1;   // counted nowhere
      }
    }
    repro::count_levels<MODE>(q, nl, sh, cnt);
  }
  constexpr int BPI = kPerIter / PER;            // tail bytes an iteration
  const long long n_bytes = (n + PER - 1) / PER;
  for (long long b0 = n_unit * UB + t; b0 - lane < n_bytes;
       b0 += BPI * stride) {
    int q[kPerIter];
#pragma unroll
    for (int h = 0; h < BPI; ++h) {
      const long long b = b0 + h * stride;
      unsigned acc = 0;
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const long long i = b * PER + j;
        q[h * PER + j] = -1;
        if (b < n_bytes && i < n) {
          q[h * PER + j] = (int)repro::quant_level(repro::to_f32(x[i]), lo,
                                                   hi, scale);
          acc += (unsigned)q[h * PER + j] << (j * BITS);
        }
      }
      if (b < n_bytes) packed[b] = (unsigned char)(acc & 0xFFu);
    }
    repro::count_levels<MODE>(q, nl, sh, cnt);
  }
  repro::store_histogram<MODE == kMatch>(cnt, sh, n_levels, cluster, hist,
                                         rows, ticket);
}

// The tiled formula of the reference: float32 span = max(hi - lo, 1e-12),
// scale = (N - 1) / span and delta = span / (N - 1) with correctly
// rounded divides, every step rounded once.
template <typename T>
__global__ void clip_quant_tiles_kernel(const T* __restrict__ x, unsigned n,
                                        unsigned C, unsigned inner,
                                        const int* __restrict__ cgroup,
                                        const int* __restrict__ sblock,
                                        int n_sblocks,
                                        const float* __restrict__ lo,
                                        const float* __restrict__ hi,
                                        int n_levels, int* __restrict__ idx,
                                        T* __restrict__ deq) {
  const float nm1 = (float)(n_levels - 1);
  unsigned stride = gridDim.x * blockDim.x;
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    int t = repro::tile_of(i, C, inner, cgroup, sblock, n_sblocks);
    float l = __ldg(&lo[t]), h = __ldg(&hi[t]);
    float span = fmaxf(__fsub_rn(h, l), 1e-12f);
    float q = repro::quant_level(repro::to_f32(x[i]), l, h,
                                 __fdiv_rn(nm1, span));
    idx[i] = (int)q;
    if (deq != nullptr)
      deq[i] = repro::from_f32<T>(
          __fadd_rn(l, __fmul_rn(q, __fdiv_rn(span, nm1))));
  }
}

// -- per-tile clip + quantize, channels innermost: the fast route -------------
//
// With channels innermost, one spatial block and channel groups of a
// multiple of 8 channels, the 8 values of a unit -- 8 consecutive
// channels of one row, one 16-byte load of bfloat16 -- lie in one tile.
// A block covers UW unit columns (whole tiles, at least 8 columns: 128
// bytes of a bfloat16 row) x RB row slots, unit column fastest, so a
// warp's loads and stores are runs of whole sectors of a few rows; a
// thread keeps its column, so it loads its tile's range and computes its
// scale and step once (the same correctly rounded divides as the element
// route), then takes PER units down the column, RB rows apart, the loads
// of up to kBatch of them issued before any is quantized.  Bound by
// bytes, and at the serving sizes by the launch and one read round trip
// (PERF.md).  Counting: a thread counts its levels in 16-bit register
// fields (repro::bin8 / count16); a warp sums a tile's fields with an
// xor butterfly over the lane bits that do not pick the tile (its units
// and its row slots), one lane of each tile adds the sums into the
// block's shared row of bins for the tile, and the block stores its
// tiles' rows once.  A tile taller than kBatch
// passes of a block takes more blocks down its column, up to kSplit, a
// thread block cluster whose blocks add their rows in block 0's shared
// memory (cluster_store_rows) before block 0 stores them: no tile needs
// the ticket.  Where a thread would count more than kCountsPerThread
// levels, or N > 16, the warp's equal (tile, level) keys take one shared
// atomic each (repro::match_count).  OUT names what is written: int32
// indices (and the reconstruction where deq is given), or the indices
// packed to OUT bits (pack_bits' layout: a unit's 8 indices make OUT
// consecutive bytes, one store), with no int32 index tensor.

constexpr int kUnit = 8;               // values of a unit
constexpr int kRowsPerThread = 2;      // units a thread takes (no counts)
constexpr int kBatch = 4;              // units whose loads go out together
constexpr int kSplit = 8;              // blocks of a tile's rows at most
constexpr int kLogMinColumns = 3;      // log2 unit columns a block, at least
constexpr int kStageBins = 8 * kHistWidth;   // tiles x bins a split block

struct FastTiles {
  long long rows;        // the tensor seen as (rows, C)
  int units;             // units a row: C / kUnit
  int n_tiles;
  int lug;               // log2 units a tile (group_size / kUnit)
  int luw;               // log2 unit columns a block (UW, whole tiles)
  int lrb;               // log2 row slots a block (RB)
  int per;               // units a thread takes down its column
  int nbr;               // blocks down a column (row chunks); a cluster
                         // of them when counting and nbr > 1
};

// Every thread of the cluster calls this, its block's `count` bins in sh:
// block 0 adds the cluster's rows and stores the first `keep` of them to
// out.  The cluster barrier's first phase was arrived at as the kernel
// started (repro::cluster_start).
__device__ __forceinline__ void cluster_store_rows(const int* sh, int count,
                                                   int keep,
                                                   int* __restrict__ out) {
  namespace cg = cooperative_groups;
  __shared__ int s_recv[kSplit * kStageBins];
  cg::cluster_group cl = cg::this_cluster();
  const unsigned rank = cl.block_rank(), ranks = cl.num_blocks();
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  int* dst = cl.map_shared_rank(s_recv + rank * kStageBins, 0);
  for (int i = threadIdx.x; i < count; i += blockDim.x) dst[i] = sh[i];
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
  if (rank != 0) return;
  for (int i = threadIdx.x; i < keep; i += blockDim.x) {
    int sum = 0;
    for (unsigned r = 0; r < ranks; ++r) sum += s_recv[r * kStageBins + i];
    out[i] = sum;
  }
}

template <typename T, int MODE, int OUT>
__global__ void __launch_bounds__(kThreads)
clip_quant_tiles_fast_kernel(const T* __restrict__ x, bool vec, FastTiles g,
                             const float* __restrict__ lo,
                             const float* __restrict__ hi, int n_levels,
                             int* __restrict__ idx, T* __restrict__ deq,
                             unsigned char* __restrict__ packed,
                             int* __restrict__ hist) {
  extern __shared__ int sh[];          // a row of bins a tile of the block
  constexpr unsigned kFull = 0xFFFFFFFFu;
  const bool split = MODE != kNoHist && g.nbr > 1;
  repro::cluster_start(split);
  const int uw = 1 << g.luw, rb = 1 << g.lrb;
  const long long bu = blockIdx.x / g.nbr, br = blockIdx.x % g.nbr;
  const int ul = threadIdx.x & (uw - 1);
  const int n_slots = uw >> g.lug > 0 ? uw >> g.lug : 1;   // tiles a block
  if constexpr (MODE != kNoHist) {
    for (int i = threadIdx.x; i < n_slots * n_levels; i += blockDim.x)
      sh[i] = 0;
    if constexpr (MODE == kMatch) __syncthreads();
  }
  // the thread's column, tile and range, once
  const long long uc = bu * uw + ul;
  const long long row0 = br * ((long long)rb * g.per) + (threadIdx.x >> g.luw);
  const bool col_ok = uc < g.units;
  const int tile = (int)(uc >> g.lug);
  const int tslot = ul >> g.lug;
  float l = 0.f, h = 1.f;
  if (col_ok) {
    l = __ldg(&lo[tile]);
    h = __ldg(&hi[tile]);
  }
  const float nm1 = (float)(n_levels - 1);
  const float span = fmaxf(__fsub_rn(h, l), 1e-12f);
  const float scale = __fdiv_rn(nm1, span), delta = __fdiv_rn(span, nm1);
  const unsigned nl = (unsigned)n_levels;
  uint32_t cnt[repro::kCountWords] = {};
  // every thread runs g.per units, a batch's loads issued before any of
  // its units is quantized; a batch stops where g.per does (uniform), so
  // a warp's lanes meet in each match
  constexpr int kVecs = kUnit * (int)sizeof(T) / 16;   // uint4 a unit
  for (int k = 0; k < g.per; k += kBatch) {
    uint4 raw[kBatch][kVecs];
    long long off[kBatch];
    bool act[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (k + u >= g.per) break;
      const long long row = row0 + (long long)(k + u) * rb;
      act[u] = col_ok && row < g.rows;
      off[u] = (row * g.units + uc) * kUnit;
      if (!act[u]) continue;
      if (vec) {
#pragma unroll
        for (int i = 0; i < kVecs; ++i)
          raw[u][i] = __ldg(reinterpret_cast<const uint4*>(x + off[u]) + i);
      } else {
        T* e = reinterpret_cast<T*>(raw[u]);
#pragma unroll
        for (int i = 0; i < kUnit; ++i) e[i] = x[off[u] + i];
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (k + u >= g.per) break;
      const T* e = reinterpret_cast<const T*>(raw[u]);
      int q[kUnit];
#pragma unroll
      for (int i = 0; i < kUnit; ++i)
        q[i] = act[u] ? (int)repro::quant_level(repro::to_f32(e[i]), l, h,
                                                scale)
                      : -1;
      if (!act[u]) {
        // counted nowhere (q = -1), but it takes part in the matches
      } else if constexpr (OUT == 0) {
        int4* pi = reinterpret_cast<int4*>(idx + off[u]);
        pi[0] = make_int4(q[0], q[1], q[2], q[3]);
        pi[1] = make_int4(q[4], q[5], q[6], q[7]);
        if (deq != nullptr) {
          alignas(16) T d[kUnit];
#pragma unroll
          for (int i = 0; i < kUnit; ++i)
            d[i] = repro::from_f32<T>(
                __fadd_rn(l, __fmul_rn((float)q[i], delta)));
#pragma unroll
          for (int i = 0; i < kVecs; ++i)
            reinterpret_cast<uint4*>(deq + off[u])[i] =
                reinterpret_cast<const uint4*>(d)[i];
        }
      } else {
        // a unit's 8 indices are OUT consecutive bytes of pack_bits'
        // layout
        uint32_t word = 0;
#pragma unroll
        for (int i = 0; i < kUnit; ++i) word |= (uint32_t)q[i] << (i * OUT);
        const long long unit = off[u] / kUnit;
        if constexpr (OUT == 1)
          packed[unit] = (unsigned char)word;
        else if constexpr (OUT == 2)
          reinterpret_cast<uint16_t*>(packed)[unit] = (uint16_t)word;
        else
          reinterpret_cast<uint32_t*>(packed)[unit] = word;
      }
      if constexpr (MODE == kCount8) {
        uint32_t c8 = 0;
#pragma unroll
        for (int i = 0; i < kUnit; ++i)
          c8 += repro::bin8(q[i], (unsigned)q[i] < nl);
        repro::widen8(c8, cnt);
      } else if constexpr (MODE == kCount16) {
#pragma unroll
        for (int i = 0; i < kUnit; ++i)
          repro::count16(q[i], (unsigned)q[i] < nl, cnt);
      } else if constexpr (MODE == kMatch) {
#pragma unroll
        for (int i = 0; i < kUnit; ++i) {
          const bool on = (unsigned)q[i] < nl;
          repro::match_count(sh, on,
                             on ? (unsigned)(tslot * n_levels + q[i]) : 0u);
        }
      }
    }
  }
  if constexpr (MODE == kNoHist) return;
  const long long t0 = (bu * uw) >> g.lug;            // the block's tiles
  const long long left = (long long)g.n_tiles - t0;
  const int keep = (int)(left < n_slots ? left : n_slots) * n_levels;
  const int lane = threadIdx.x & 31;
  if constexpr (MODE != kMatch) {
    // a tile's sums in every one of its lanes: a butterfly over the lane
    // bits below the tile's (its units) and above the block's columns
    // (row slots); then one lane a tile and warp adds them to the
    // block's row of the tile
    const int n_words = (n_levels + 1) / 2;
#pragma unroll
    for (int b = 0; b < 5; ++b) {
      if (b >= g.lug && b < g.luw) continue;          // uniform
#pragma unroll
      for (int w = 0; w < repro::kCountWords; ++w)
        if (w < n_words) cnt[w] += __shfl_xor_sync(kFull, cnt[w], 1 << b);
    }
    __syncthreads();                     // the zeroed rows
    const int red = ((1 << g.lug) - 1) | (~((1 << g.luw) - 1) & 31);
    if ((lane & red) == 0) {
      int* row = sh + tslot * n_levels;
#pragma unroll
      for (int w = 0; w < repro::kCountWords; ++w) {
        const int c0 = (int)(cnt[w] & 0xFFFFu), c1 = (int)(cnt[w] >> 16);
        if (2 * w < n_levels && c0) atomicAdd(row + 2 * w, c0);
        if (2 * w + 1 < n_levels && c1) atomicAdd(row + 2 * w + 1, c1);
      }
    }
  }
  __syncthreads();
  if (split) {
    cluster_store_rows(sh, n_slots * n_levels, keep, hist + t0 * n_levels);
  } else {
    for (int i = threadIdx.x; i < keep; i += blockDim.x)
      hist[t0 * n_levels + i] = sh[i];
  }
}

// -- encode megakernel -------------------------------------------------------
//
// The packed bytes are row-major over (row, band, byte in band), so byte
// gb reads the per consecutive inputs x[gb * per ...] and belongs to the
// (row, band) cell gb / bytes_per_band.  The kernel is bound by its
// launch and its per-thread work more than by its ~4.5 MB of traffic
// (PERF.md: an empty kernel on the same grid takes half its time),
// so the design cuts the threads and the steps between them:
//   * a thread makes 4 consecutive packed bytes (when the band holds a
//     multiple of 4) from one vector load -- 64 B of float32 at N=4 --
//     and stores them as one 32-bit word;
//   * a block owns whole cells -- up to kMaxCells short bands, or one
//     long band its threads loop over -- sized to leave two blocks per
//     SM, so no thread idles on a 64-byte band and every histogram row
//     is written once with plain stores (the output needs no zeroing);
//   * each thread reads its cell's range and computes its scale itself,
//     alongside its first load: no barrier before the quantizer;
//   * counting: for N <= 16 a thread keeps 16-bit counters, two bins to
//     a word (8-bit fields summed in registers for N <= 4), and the lanes
//     whose bytes share a cell add them with one __reduce_add_sync per
//     word; one shared slot per lane group, summed per cell after the one
//     barrier, no atomics.  Otherwise (N > 16, or bands that split a lane
//     group) __match_any_sync groups a warp's equal (cell, bin) keys so
//     each distinct key costs one shared atomic.

constexpr int kMaxCells = 32;   // cells of one block (shared bins)
constexpr int kWords = repro::kCountWords;  // 16-bit counter words, N <= 16

// BYTES consecutive packed bytes per thread, all in one cell (the band's
// byte count is a multiple of BYTES); the `group` lanes whose bytes share
// a cell reduce their counters together.
template <typename T, int PER, int BYTES>
__global__ void __launch_bounds__(kThreads)
encode_tiles_kernel(const T* __restrict__ x, bool vec, int n_sblocks, int bpb,
                    long long n_cells, int cells_per_block, int group,
                    const float* __restrict__ lo,
                    const float* __restrict__ hi,
                    const int* __restrict__ band_valid, int n_levels,
                    int bits, bool reduce16,
                    unsigned char* __restrict__ packed,
                    int* __restrict__ hist) {
  constexpr int E = BYTES * PER;                 // inputs per thread
  __shared__ int sh[kMaxCells * kHistWidth];     // the match path's bins
  __shared__ uint32_t s_cnt[kThreads * kWords];  // per lane group
  const long long cell0 = (long long)blockIdx.x * cells_per_block;
  const int k_cells = (int)min((long long)cells_per_block, n_cells - cell0);
  const int n_bytes = k_cells * bpb;
  const T* xb = x + cell0 * bpb * PER;
  unsigned char* pb = packed + cell0 * bpb;
  // a thread's bytes all lie in one cell (one iteration per thread, or
  // one cell per block): its range, scale and valid count are loaded and
  // computed by the thread itself, together with its first inputs, so no
  // barrier stands before the quantizer
  const int cl = min((int)(threadIdx.x * BYTES / bpb), k_cells - 1);
  const int cell = (int)cell0 + cl;              // == row * n_sblocks + band
  float v[E];
  if (threadIdx.x * BYTES < n_bytes)
    repro::load_group<T, E>(xb + (long long)threadIdx.x * E, vec, v);
  const float l = lo[cell], h = hi[cell];
  const int valid = band_valid[cell % n_sblocks];
  const float scale = __fdiv_rn((float)(n_levels - 1),
                                fmaxf(__fsub_rn(h, l), 1e-12f));
  if (!reduce16) {
    for (int i = threadIdx.x; i < k_cells * kHistWidth; i += blockDim.x)
      sh[i] = 0;
    __syncthreads();
  }

  const int lane = threadIdx.x & 31;
  // 16-bit counters, bins 2w and 2w + 1 in word w; a thread's bytes all
  // lie in one cell (one iteration per thread, or one cell per block)
  uint32_t cnt[kWords] = {};
  const int n_iter = (cells_per_block * bpb + blockDim.x * BYTES - 1) /
                     (blockDim.x * BYTES);
  for (int it = 0; it < n_iter; ++it) {
    int lb = (it * blockDim.x + threadIdx.x) * BYTES;  // first byte
    bool act = lb < n_bytes;
    int col = (lb - cl * bpb) * PER;          // first column in the band
    int q[E];
    if (act) {
      if (it > 0) repro::load_group<T, E>(xb + (long long)lb * PER, vec, v);
      uint32_t word = 0;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        q[e] = (int)repro::quant_level(v[e], l, h, scale);
        word |= (uint32_t)q[e] << ((e / PER) * 8 + (e % PER) * bits);
      }
      if (BYTES == 4)
        *reinterpret_cast<uint32_t*>(pb + lb) = word;
      else
        pb[lb] = (unsigned char)word;
    }
    if (reduce16) {
      if (act && n_levels <= 4) {            // uniform: the served case
        uint32_t c8 = 0;                     // four 8-bit bins, <= E each
#pragma unroll
        for (int e = 0; e < E; ++e) c8 += repro::bin8(q[e], col + e < valid);
        repro::widen8(c8, cnt);
      } else if (act) {
#pragma unroll
        for (int e = 0; e < E; ++e) repro::count16(q[e], col + e < valid, cnt);
      }
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        bool counted = act && col + e < valid;
        repro::match_count(sh, counted,
                           (unsigned)(cl * kHistWidth + (counted ? q[e] : 0)));
      }
    }
  }
  if (!reduce16) {
    __syncthreads();
    for (int i = threadIdx.x; i < k_cells * kHistWidth; i += blockDim.x)
      hist[cell0 * kHistWidth + i] = sh[i];
    return;
  }
  // one reduction per counter word and lane group, one shared slot per
  // group, no atomics
  const int n_words = (n_levels + 1) / 2;
  const unsigned gmask = (group == 32 ? 0xFFFFFFFFu : (1u << group) - 1u)
                         << (lane & ~(group - 1));
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    if (w >= n_words) break;                 // uniform across the block
    uint32_t r = __reduce_add_sync(gmask, cnt[w]);
    if ((lane & (group - 1)) == 0)
      s_cnt[(threadIdx.x / group) * kWords + w] = r;
  }
  __syncthreads();
  const int n_groups = blockDim.x / group;
  // groups per cell: a block of several cells runs one iteration, and
  // a cell's bytes are a whole number of groups; one cell takes them all
  const int gpc = cells_per_block > 1 ? bpb / (group * BYTES) : n_groups;
  for (int i = threadIdx.x; i < k_cells * kHistWidth; i += blockDim.x) {
    int cl = i / kHistWidth, bin = i % kHistWidth, sum = 0;
    if (bin < n_levels) {
      for (int g = cl * gpc; g < (cl + 1) * gpc; ++g)
        sum += (s_cnt[g * kWords + bin / 2] >> (bin & 1) * 16) & 0xFFFF;
    }
    hist[cell0 * kHistWidth + i] = sum;
  }
}

}  // namespace

namespace {

template <typename T>
int launch_clip_quant(const void* x, long long n, bool vec, float lo,
                      float hi, float scale, float inv_scale, int n_levels,
                      void* idx, void* deq, void* hist, void* rows,
                      long long rows_cap, void* ticket, int sms,
                      cudaStream_t s) {
  repro::HistGrid g{0, false};
  if (hist == nullptr) {
    // one group of four a thread: the most blocks in flight
    long long per_block = (long long)kThreads * 4;
    long long want = (n + per_block - 1) / per_block;
    g.blocks = want < 16LL * sms ? want : 16LL * sms;
  } else {
    g = repro::histogram_grid(n, kThreads, kPerIter, kOneBlockMax, sms);
    if (g.blocks > rows_cap) return (int)cudaErrorInvalidValue;
  }
  if (g.blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  auto kernel = hist == nullptr ? clip_quant_kernel<T, kNoHist>
                : n_levels <= 4  ? clip_quant_kernel<T, kCount8>
                : n_levels <= 16 ? clip_quant_kernel<T, kCount16>
                                 : clip_quant_kernel<T, kMatch>;
  cudaError_t e = repro::launch_grid(
      kernel, g.blocks, kThreads, g.cluster, s, (const T*)x, n, vec, lo, hi,
      scale, inv_scale, n_levels, g.cluster, (int*)idx, (T*)deq, (int*)hist,
      (int*)rows, (unsigned*)ticket);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

template <typename T, int BITS>
int launch_clip_quant_pack(const void* x, long long n, bool vec, float lo,
                           float hi, float scale, int n_levels,
                           void* packed, void* hist, void* rows,
                           long long rows_cap, void* ticket, int sms,
                           cudaStream_t s) {
  repro::HistGrid g =
      repro::histogram_grid(n, kThreads, kPerIter, kOneBlockMax, sms);
  if (g.blocks > rows_cap || g.blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  auto kernel = n_levels <= 4    ? clip_quant_pack_kernel<T, kCount8, BITS>
                : n_levels <= 16 ? clip_quant_pack_kernel<T, kCount16, BITS>
                                 : clip_quant_pack_kernel<T, kMatch, BITS>;
  cudaError_t e = repro::launch_grid(
      kernel, g.blocks, kThreads, g.cluster, s, (const T*)x, n, vec, lo, hi,
      scale, n_levels, g.cluster, (unsigned char*)packed, (int*)hist,
      (int*)rows, (unsigned*)ticket);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace

// deq may be null (no reconstruction written); hist may be null (no
// histogram), else rows is scratch of rows_cap * kHistWidth int32 and
// ticket the stream's zeroed word (repro::store_histogram).
extern "C" int repro_clip_quant(const void* x, int dtype, long long n,
                                float lo, float hi, float scale,
                                float inv_scale, int n_levels, void* idx,
                                void* deq, void* hist, void* rows,
                                long long rows_cap, void* ticket,
                                void* stream) {
  if (n <= 0 || n_levels < 2 || (hist != nullptr && n_levels > kHistWidth) ||
      (hist != nullptr && ticket == nullptr))
    return (int)cudaErrorInvalidValue;
  int sms = repro::sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  // groups of four: 16-byte indices, 4-value loads and stores of x's type
  const unsigned quad = dtype == repro::kF32 ? 16u : 8u;
  auto aligned = [](const void* p, unsigned a) {
    return reinterpret_cast<uintptr_t>(p) % a == 0;
  };
  bool vec = aligned(x, quad) && aligned(idx, 16) &&
             (deq == nullptr || aligned(deq, quad));
  REPRO_DISPATCH_FLOAT(dtype, T,
      return launch_clip_quant<T>(x, n, vec, lo, hi, scale, inv_scale,
                                  n_levels, idx, deq, hist, rows, rows_cap,
                                  ticket, sms, (cudaStream_t)stream));
  return (int)cudaErrorInvalidValue;
}

// packed: ceil(n / (8 / bits)) bytes; hist, rows and ticket as above.
// Indices must fit the width: n_levels <= 2^bits.
extern "C" int repro_clip_quant_pack(const void* x, int dtype, long long n,
                                     float lo, float hi, float scale,
                                     int n_levels, int bits, void* packed,
                                     void* hist, void* rows,
                                     long long rows_cap, void* ticket,
                                     void* stream) {
  if (n <= 0 || n_levels < 2 || n_levels > kHistWidth ||
      (bits != 1 && bits != 2 && bits != 4) || n_levels > (1 << bits) ||
      hist == nullptr || ticket == nullptr)
    return (int)cudaErrorInvalidValue;
  int sms = repro::sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const unsigned quad = dtype == repro::kF32 ? 16u : 8u;
  bool vec = reinterpret_cast<uintptr_t>(x) % quad == 0 &&
             reinterpret_cast<uintptr_t>(packed) % 2 == 0;
  cudaStream_t s = (cudaStream_t)stream;
#define REPRO_PACK(BITS)                                                    \
  REPRO_DISPATCH_FLOAT(dtype, T,                                            \
      return launch_clip_quant_pack<T, BITS>(x, n, vec, lo, hi, scale,      \
                                             n_levels, packed, hist, rows,  \
                                             rows_cap, ticket, sms, s))
  switch (bits) {
    case 1: REPRO_PACK(1); break;
    case 2: REPRO_PACK(2); break;
    default: REPRO_PACK(4); break;
  }
#undef REPRO_PACK
  return (int)cudaErrorInvalidValue;
}

extern "C" int repro_clip_quant_tiles(const void* x, int dtype, int n, int C,
                                      int inner, const void* cgroup,
                                      const void* sblock, int n_sblocks,
                                      const void* lo, const void* hi,
                                      int n_levels, void* idx, void* deq,
                                      void* stream) {
  if (n <= 0 || C <= 0 || inner <= 0 || n_sblocks <= 0 || n_levels < 2)
    return (int)cudaErrorInvalidValue;
  int want = (n + kThreads - 1) / kThreads;
  int blocks = want < 132 * 16 ? want : 132 * 16;
  cudaStream_t s = (cudaStream_t)stream;
  REPRO_DISPATCH_FLOAT(dtype, T,
      clip_quant_tiles_kernel<T><<<blocks, kThreads, 0, s>>>(
          (const T*)x, (unsigned)n, (unsigned)C, (unsigned)inner,
          (const int*)cgroup, (const int*)sblock, n_sblocks,
          (const float*)lo, (const float*)hi, n_levels, (int*)idx,
          (T*)deq));
  return (int)cudaGetLastError();
}

namespace {

int log2_of(long long v) {
  int l = 0;
  while ((1LL << l) < v) ++l;
  return l;
}

// The fast route's geometry: blocks of UW unit columns (at least 8,
// 128 bytes of a bfloat16 row, and whole tiles) x RB row slots (all the
// rows up to kThreads / UW), widened to kThreads threads when the rows
// are few, then narrowed (down to 64 threads) while the grid would not
// give every SM a block.  Without counts a thread
// takes kRowsPerThread units; with them kBatch, before a tile's rows take
// more blocks (a cluster, a power of two of them, at most kSplit), each
// thread PER units.
FastTiles fast_tiles(long long rows, int C, int group_size, int sms,
                     bool counting, int& threads, long long& blocks) {
  FastTiles g{};
  g.rows = rows;
  g.units = C / kUnit;
  const int ug = group_size / kUnit;
  g.lug = log2_of(ug);
  g.n_tiles = (C + group_size - 1) / group_size;
  const int lu = log2_of(g.units);                  // columns, pow2 above
  int luw = lu < kLogMinColumns ? lu : kLogMinColumns;
  if (luw < g.lug) luw = lu < g.lug ? lu : g.lug;   // whole tiles
  const int lr = log2_of(rows);
  int lrb = lr < 8 - luw ? lr : 8 - luw;
  if (luw + lrb < 8 && luw < lu) luw = lu < 8 - lrb ? lu : 8 - lrb;
  if (luw + lrb < 5) lrb = 5 - luw;                 // a whole warp
  const long long rb = 1LL << lrb;
  const long long passes = (rows + rb - 1) / rb;    // of RB rows
  // with counts: kBatch units a thread before a tile's rows take more
  // blocks, at most kSplit (a power of two)
  long long split = (passes + kBatch - 1) / kBatch;
  split = split < kSplit ? 1LL << log2_of(split) : kSplit;
  long long per = counting ? (passes + split - 1) / split
                  : passes < kRowsPerThread ? passes : kRowsPerThread;
  long long nbr = (rows + rb * per - 1) / (rb * per);
  if (counting && nbr > 1) nbr = 1LL << log2_of(nbr);   // a cluster
  for (;;) {
    const long long nbu = (g.units + (1LL << luw) - 1) >> luw;
    if (nbu * nbr >= sms || luw <= kLogMinColumns || luw <= g.lug ||
        luw + lrb <= 6)
      break;
    --luw;
  }
  g.luw = luw;
  g.lrb = lrb;
  g.per = (int)per;
  g.nbr = (int)nbr;
  threads = 1 << (luw + lrb);
  blocks = ((g.units + (1LL << luw) - 1) >> luw) * nbr;
  return g;
}

template <typename T, int OUT>
int launch_tiles_fast(const void* x, long long rows, int C, int group_size,
                      const void* lo, const void* hi, int n_levels,
                      void* idx, void* deq, void* packed, void* hist,
                      int sms, cudaStream_t s) {
  int threads;
  long long blocks;
  FastTiles g = fast_tiles(rows, C, group_size, sms, hist != nullptr,
                           threads, blocks);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // the most a thread counts: its 16-bit fields' warp sums stay < 2^16
  const bool regs = (long long)g.per * kUnit <= repro::kCountsPerThread;
  const int mode = hist == nullptr ? kNoHist
                   : !regs || n_levels > 16 ? kMatch
                   : n_levels <= 4 ? kCount8 : kCount16;
  const int n_slots = g.luw > g.lug ? 1 << (g.luw - g.lug) : 1;
  const size_t smem = hist == nullptr ? 0
                      : (size_t)n_slots * n_levels * sizeof(int);
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int cluster = hist != nullptr && g.nbr > 1 ? g.nbr : 0;
  auto kernel = mode == kCount8    ? clip_quant_tiles_fast_kernel<T, kCount8, OUT>
                : mode == kCount16 ? clip_quant_tiles_fast_kernel<T, kCount16, OUT>
                                   : clip_quant_tiles_fast_kernel<T, kMatch, OUT>;
  if constexpr (OUT == 0) {            // packing always counts
    if (mode == kNoHist) kernel = clip_quant_tiles_fast_kernel<T, kNoHist, 0>;
  }
  cudaError_t e = repro::launch_grid_smem(
      kernel, blocks, threads, smem, cluster, s, (const T*)x, vec, g,
      (const float*)lo, (const float*)hi, n_levels, (int*)idx, (T*)deq,
      (unsigned char*)packed, (int*)hist);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace

// The fast route of the per-tile quantizer: x is (rows, C) with channels
// innermost, one spatial block, channel groups of group_size (a power of
// two from 8 to 256) and C a multiple of 8; lo/hi hold one range a group.
// bits 0: int32 indices to idx, the reconstruction to deq (may be null);
// bits 1, 2 or 4: the indices packed to that width into `packed` (idx and
// deq null), with the histogram.  hist (may be null with bits 0): the
// (n_groups, n_levels) int32 per-tile counts, every bin stored.
extern "C" int repro_clip_quant_tiles_fast(
    const void* x, int dtype, long long rows, int C, int group_size,
    const void* lo, const void* hi, int n_levels, int bits, void* idx,
    void* deq, void* packed, void* hist, void* stream) {
  const bool pow2 = group_size > 0 && (group_size & (group_size - 1)) == 0;
  if (rows <= 0 || C <= 0 || C % kUnit || !pow2 || group_size < kUnit ||
      group_size > 256 || n_levels < 2 || rows * C >= (1LL << 31) ||
      (hist != nullptr && n_levels > kHistWidth))
    return (int)cudaErrorInvalidValue;
  if (bits == 0 ? (idx == nullptr || packed != nullptr)
                : ((bits != 1 && bits != 2 && bits != 4) || idx != nullptr ||
                   deq != nullptr || packed == nullptr || hist == nullptr ||
                   n_levels > (1 << bits)))
    return (int)cudaErrorInvalidValue;
  int sms = repro::sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  cudaStream_t s = (cudaStream_t)stream;
#define REPRO_TILES_FAST(OUT)                                              \
  REPRO_DISPATCH_FLOAT(dtype, T,                                           \
      return launch_tiles_fast<T, OUT>(x, rows, C, group_size, lo, hi,     \
                                       n_levels, idx, deq, packed, hist,   \
                                       sms, s))
  switch (bits) {
    case 0: REPRO_TILES_FAST(0); break;
    case 1: REPRO_TILES_FAST(1); break;
    case 2: REPRO_TILES_FAST(2); break;
    default: REPRO_TILES_FAST(4); break;
  }
#undef REPRO_TILES_FAST
  return (int)cudaErrorInvalidValue;
}

extern "C" int repro_encode_tiles(const void* x, int dtype, int rows,
                                  int cols, int sb_cols, int n_sblocks,
                                  const void* lo, const void* hi,
                                  const void* band_valid, int n_levels,
                                  int bits, void* packed, void* hist,
                                  void* stream) {
  int per = (bits == 1 || bits == 2 || bits == 4) ? 8 / bits : 1;
  if (rows <= 0 || sb_cols <= 0 || sb_cols % per ||
      cols != n_sblocks * sb_cols || n_levels < 1 || n_levels > kHistWidth)
    return (int)cudaErrorInvalidValue;
  int bpb = sb_cols / per;                      // packed bytes per band
  long long n_cells = (long long)rows * n_sblocks;
  int bytes = bpb % 4 == 0 ? 4 : 1;             // packed bytes per thread
  // whole cells per block: up to kThreads * bytes bytes of short bands
  // while that leaves two blocks per SM, or one long band looped over by
  // kThreads threads
  int sms = repro::sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  int span = kThreads * bytes;
  long long fill = (n_cells + 2LL * sms - 1) / (2LL * sms);
  int cpb = bpb >= span ? 1 : (int)min((long long)min(span / bpb, kMaxCells),
                                      max(fill, 1LL));
  int threads = min(kThreads, (cpb * bpb / bytes + 31) / 32 * 32);
  long long blocks = (n_cells + cpb - 1) / cpb;
  if (n_cells > 0x7fffffffLL || n_cells * bpb * per >= (1LL << 40))
    return (int)cudaErrorInvalidValue;
  // lanes whose bytes share a cell: a power of two up to a warp dividing
  // the band's thread count; their 16-bit counters reach at most
  // group * bytes * per * n_iter
  int group = 1;
  while (group < 32 && (bpb / bytes) % (group * 2) == 0) group *= 2;
  long long n_iter = (cpb * (long long)bpb + threads * bytes - 1) /
                     (threads * bytes);
  bool reduce16 = n_levels <= 16 &&
                  (long long)group * bytes * per * n_iter < (1 << 16);
  cudaStream_t s = (cudaStream_t)stream;
  bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0;
#define REPRO_ENCODE(PER, BYTES)                                          \
  REPRO_DISPATCH_FLOAT(dtype, T,                                          \
      encode_tiles_kernel<T, PER, BYTES><<<(unsigned)blocks, threads, 0,  \
                                           s>>>(                          \
          (const T*)x, vec, n_sblocks, bpb, n_cells, cpb, group,          \
          (const float*)lo, (const float*)hi, (const int*)band_valid,     \
          n_levels, bits, reduce16, (unsigned char*)packed, (int*)hist))
#define REPRO_ENCODE_PER(PER)                                             \
  if (bytes == 4) { REPRO_ENCODE(PER, 4); } else { REPRO_ENCODE(PER, 1); }
  switch (per) {
    case 1: REPRO_ENCODE_PER(1); break;
    case 2: REPRO_ENCODE_PER(2); break;
    case 4: REPRO_ENCODE_PER(4); break;
    default: REPRO_ENCODE_PER(8); break;
  }
#undef REPRO_ENCODE_PER
#undef REPRO_ENCODE
  return (int)cudaGetLastError();
}
