// Non-uniform (ECSQ) quantization by decision thresholds for Hopper
// (sm_90a): the deploy-time side of the paper's Algorithm 1.
//
// repro_ecsq_assign replaces the Pallas kernel ecsq_assign._kernel
// (ecsq_assign_2d): one designed quantizer for the whole tensor; on
// request the same launch writes no reconstruction and counts the N-bin
// histogram of its indices, the rate estimate of the ECSQ codec's
// ``codec=`` hookup, so no index histogram (#4) runs after it.
// repro_ecsq_assign_pack is the same pass writing the indices packed to
// the wire width with the histogram: the packed split runtime's
// quantize-and-pack stage in one launch, with no pack (#9) after it.
// repro_ecsq_assign_tiles_fast and repro_ecsq_assign_tiles replace
// ecsq_assign._kernel_tiles (ecsq_assign_tiles_2d): one quantizer per
// TilePlan tile.
//
// All compute idx = #{k < N-1 : clip(x) >= t_k} -- ties go to the upper
// bin, as searchsorted(side="right") does -- and deq = level[idx], so the
// reconstruction is a table entry and the only rounding is the one to
// x's dtype.  The count is exact for any table, sorted or not.  The
// Pallas bodies looped over the table with iota-masked selects because a
// TPU vector cannot index a lane by a value; a thread here compares
// against each threshold and selects (or gathers) its level directly.
//
// Bound by bytes at N = 4 (one read, two writes per element), and at the
// serving sizes by the launch and one read round trip; at N = 64 the 63
// compares per element approach the card's instruction rate.  The
// per-tensor kernels' notes below say where they keep their one table.
// The per-tile tables are n_tiles * (2N - 1) floats (14 KB
// for 512 tiles at N = 4, 254 KB at N = 64): staging all of them in every
// block would move more bytes than the tensor, so each thread reads its
// tile's row through the read-only L1 path, where a warp's 32 neighbouring
// elements share a few tiles' rows.  The element -> tile lookup is the
// uniform tile kernel's (repro::tile_of), in the tensor's own layout.

#include <limits>

#include "common.cuh"

namespace {

constexpr int kMaxLevels = 64;
constexpr int kThreads = 256;

// -- per-tensor ECSQ (#7) -------------------------------------------------------
//
// One pass with four outputs: the indices and the reconstruction, the
// indices alone, either with the N-bin histogram of the indices, or the
// indices packed to 1, 2 or 4 bits (pack_bits._kernel's byte layout)
// with the histogram and no int32 index tensor.  A thread takes two
// groups of four values an iteration, `stride` groups apart, each one
// 8-byte load of bfloat16 (16 of float32), one 16-byte index store and
// one store of its four reconstructions, so every warp access is
// contiguous; the next iteration's loads go out before this one's values
// are quantized.  The scalar tail (all of it when a buffer is not
// aligned) takes consecutive values.  Counting and the cross-block
// histogram are #1's (repro::count_levels, repro::store_histogram), on
// #1's grids.
//
// The table travels by value in the kernel's parameters (EcsqTable, 508
// bytes, filled by the C entry from host memory), so no thread loads it
// from device memory: the compares read it from the constant bank, where
// a warp's lanes read the same word, unrolled to NT - 1 thresholds (NT
// >= N: 4, 16 or 64; the thresholds past N - 1 are NaN, which no value
// reaches) and branch-free, and the level is a select.  Against the
// parent's table in shared memory behind a barrier, and against a table
// in device memory loaded into registers beside the first loads of x,
// this was the faster at the decode boundary (tools/ecsq_variants.py,
// PERF.md).

constexpr long long kOneBlockMax = 4096;   // #1's one-block crossover
constexpr int kPerIter = 8;                // values a thread an iteration

struct EcsqTable {
  float thr[kMaxLevels - 1], lvl[kMaxLevels];
};

template <int NT, int P>
__device__ __forceinline__ void ecsq_quantize(const EcsqTable& tab,
                                              const float (&v)[P], float lo,
                                              float hi, int (&q)[P],
                                              float (&d)[P]) {
#pragma unroll
  for (int e = 0; e < P; ++e) {
    const float xc = fminf(fmaxf(v[e], lo), hi);
    int c = 0;
#pragma unroll
    for (int k = 0; k < NT - 1; ++k) c += xc >= tab.thr[k];
    float dv = tab.lvl[0];
#pragma unroll
    for (int k = 1; k < NT; ++k) dv = c == k ? tab.lvl[k] : dv;
    q[e] = c;
    d[e] = dv;
  }
}

// The two loads of an iteration: groups g and g + stride (below n_grp).
template <typename Q>
__device__ __forceinline__ void load_pair(const void* x, long long g,
                                          long long stride, long long n_grp,
                                          Q (&raw)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long u = g + h * stride;
    if (u < n_grp) raw[h] = __ldg(reinterpret_cast<const Q*>(x) + u);
  }
}

template <typename T, int P>
__device__ __forceinline__ void widen(const T* e, float (&v)[P]) {
#pragma unroll
  for (int k = 0; k < P; ++k) v[k] = repro::to_f32(e[k]);
}

// The loops run while any lane of the warp has work, so every lane takes
// part in each match.
template <typename T, int MODE, int NT>
__global__ void __launch_bounds__(kThreads)
ecsq_assign_kernel(const T* __restrict__ x, long long n, bool vec, float lo,
                   float hi, const __grid_constant__ EcsqTable tab,
                   int n_levels, bool cluster,
                   int* __restrict__ idx, T* __restrict__ deq,
                   int* __restrict__ hist, int* __restrict__ rows,
                   unsigned* __restrict__ ticket) {
  using Q = typename repro::Quad<T>::type;
  __shared__ int sh[repro::kHistWidth];          // the match path's bins
  repro::cluster_start(cluster);
  const unsigned nl = (unsigned)n_levels;
  const long long lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n_grp = vec ? n / 4 : 0;
  if constexpr (MODE == repro::kMatch) {
    if (threadIdx.x < repro::kHistWidth) sh[threadIdx.x] = 0;
    __syncthreads();
  }
  Q raw[2];
  load_pair(x, t, stride, n_grp, raw);
  uint32_t cnt[repro::kCountWords] = {};
  for (long long g = t; g - lane < n_grp; g += 2 * stride) {
    Q next[2];
    load_pair(x, g + 2 * stride, stride, n_grp, next);
    float v[kPerIter], d[kPerIter];
    int q[kPerIter];
    widen(reinterpret_cast<const T*>(raw), v);
    ecsq_quantize<NT>(tab, v, lo, hi, q, d);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long u = g + h * stride;
      if (u < n_grp) {
        reinterpret_cast<int4*>(idx)[u] =
            make_int4(q[4 * h], q[4 * h + 1], q[4 * h + 2], q[4 * h + 3]);
        if (deq != nullptr) {
          Q out;
          T* o = reinterpret_cast<T*>(&out);
#pragma unroll
          for (int k = 0; k < 4; ++k) o[k] = repro::from_f32<T>(d[4 * h + k]);
          reinterpret_cast<Q*>(deq)[u] = out;
        }
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) q[4 * h + k] = -1;   // counted nowhere
      }
    }
    repro::count_levels<MODE>(q, nl, sh, cnt);
    raw[0] = next[0];
    raw[1] = next[1];
  }
  // the scalar tail (all of it when a buffer is not aligned)
  for (long long i = n_grp * 4 + t; i - lane < n; i += kPerIter * stride) {
    float v[kPerIter], d[kPerIter];
    int q[kPerIter];
#pragma unroll
    for (int k = 0; k < kPerIter; ++k) {
      const long long j = i + k * stride;
      v[k] = j < n ? repro::to_f32(x[j]) : 0.f;
    }
    ecsq_quantize<NT>(tab, v, lo, hi, q, d);
#pragma unroll
    for (int k = 0; k < kPerIter; ++k) {
      const long long j = i + k * stride;
      if (j < n) {
        idx[j] = q[k];
        if (deq != nullptr) deq[j] = repro::from_f32<T>(d[k]);
      } else {
        q[k] = -1;
      }
    }
    repro::count_levels<MODE>(q, nl, sh, cnt);
  }
  if constexpr (MODE != repro::kNoHist)
    repro::store_histogram<MODE == repro::kMatch>(cnt, sh, n_levels, cluster,
                                                  hist, rows, ticket);
}

// The 8 / BITS indices from q as one byte, the lanes summed and the low 8
// bits kept, as pack_bits.cu does.
template <int BITS>
__device__ __forceinline__ unsigned pack_byte(const int* q) {
  unsigned acc = 0;
#pragma unroll
  for (int j = 0; j < 8 / BITS; ++j) acc += (unsigned)q[j] << (j * BITS);
  return acc & 0xFFu;
}

// ecsq_assign_kernel's counting pass writing packed bytes.  An iteration's
// eight values make whole bytes: two units of four (BITS 2: a byte each;
// BITS 4: two bytes, one 16-bit store) `stride` units apart, or one unit
// of eight (BITS 1: one byte); so a warp's byte stores are contiguous.
// The tail packs whole bytes from consecutive values, kPerIter / PER
// bytes a thread an iteration, `stride` bytes apart.
template <typename T, int MODE, int NT, int BITS>
__global__ void __launch_bounds__(kThreads)
ecsq_assign_pack_kernel(const T* __restrict__ x, long long n, bool vec,
                        float lo, float hi,
                        const __grid_constant__ EcsqTable tab,
                        int n_levels, bool cluster,
                        unsigned char* __restrict__ packed,
                        int* __restrict__ hist, int* __restrict__ rows,
                        unsigned* __restrict__ ticket) {
  using Q = typename repro::Quad<T>::type;
  constexpr int PER = 8 / BITS;                  // values a byte
  constexpr int UV = BITS == 1 ? 8 : 4;          // values a unit
  constexpr int UB = UV / PER;                   // bytes a unit: 1 or 2
  constexpr int UNITS = kPerIter / UV;           // units an iteration
  __shared__ int sh[repro::kHistWidth];          // the match path's bins
  repro::cluster_start(cluster);
  const unsigned nl = (unsigned)n_levels;
  const long long lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n_unit = vec ? n / UV : 0;
  // an iteration's two loads at unit u0: the groups of units u0 and
  // u0 + stride (UNITS 2), or unit u0's two groups (UNITS 1)
  auto load = [&](long long u0, Q (&raw)[2]) {
    if constexpr (UNITS == 2) {
      load_pair(x, u0, stride, n_unit, raw);
    } else if (u0 < n_unit) {
      raw[0] = __ldg(reinterpret_cast<const Q*>(x) + 2 * u0);
      raw[1] = __ldg(reinterpret_cast<const Q*>(x) + 2 * u0 + 1);
    }
  };
  if constexpr (MODE == repro::kMatch) {
    if (threadIdx.x < repro::kHistWidth) sh[threadIdx.x] = 0;
    __syncthreads();
  }
  Q raw[2];
  load(t, raw);
  uint32_t cnt[repro::kCountWords] = {};
  for (long long u0 = t; u0 - lane < n_unit; u0 += UNITS * stride) {
    Q next[2];
    load(u0 + UNITS * stride, next);
    float v[kPerIter], d[kPerIter];
    int q[kPerIter];
    widen(reinterpret_cast<const T*>(raw), v);
    ecsq_quantize<NT>(tab, v, lo, hi, q, d);
#pragma unroll
    for (int h = 0; h < UNITS; ++h) {
      const long long u = u0 + h * stride;
      if (u < n_unit) {
        unsigned word = 0;
#pragma unroll
        for (int b = 0; b < UB; ++b)
          word |= pack_byte<BITS>(q + h * UV + b * PER) << (8 * b);
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
    raw[0] = next[0];
    raw[1] = next[1];
  }
  constexpr int BPI = kPerIter / PER;            // tail bytes an iteration
  const long long n_bytes = (n + PER - 1) / PER;
  for (long long b0 = n_unit * UB + t; b0 - lane < n_bytes;
       b0 += BPI * stride) {
    float v[kPerIter], d[kPerIter];
    int q[kPerIter];
#pragma unroll
    for (int h = 0; h < BPI; ++h) {
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const long long i = (b0 + h * stride) * PER + j;
        v[h * PER + j] = i < n ? repro::to_f32(x[i]) : 0.f;
      }
    }
    ecsq_quantize<NT>(tab, v, lo, hi, q, d);
#pragma unroll
    for (int h = 0; h < BPI; ++h) {
      const long long b = b0 + h * stride;
      int z[PER];                                // the last byte's pad: 0
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        if (b >= n_bytes || b * PER + j >= n) q[h * PER + j] = -1;
        z[j] = max(q[h * PER + j], 0);
      }
      if (b < n_bytes) packed[b] = (unsigned char)pack_byte<BITS>(z);
    }
    repro::count_levels<MODE>(q, nl, sh, cnt);
  }
  repro::store_histogram<MODE == repro::kMatch>(cnt, sh, n_levels, cluster,
                                                hist, rows, ticket);
}

template <typename T>
__global__ void ecsq_assign_tiles_kernel(
    const T* __restrict__ x, unsigned n, unsigned C, unsigned inner,
    const int* __restrict__ cgroup, const int* __restrict__ sblock,
    int n_sblocks, const float* __restrict__ lo,
    const float* __restrict__ hi, const float* __restrict__ thr,
    const float* __restrict__ lvl, int n_levels, int* __restrict__ idx,
    T* __restrict__ deq) {
  unsigned stride = gridDim.x * blockDim.x;
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    int t = repro::tile_of(i, C, inner, cgroup, sblock, n_sblocks);
    float xc = fminf(fmaxf(repro::to_f32(x[i]), __ldg(&lo[t])),
                     __ldg(&hi[t]));
    const float* tt = thr + (long long)t * (n_levels - 1);
    int q = 0;
    for (int k = 0; k < n_levels - 1; ++k) q += xc >= __ldg(&tt[k]);
    idx[i] = q;
    if (deq != nullptr)
      deq[i] = repro::from_f32<T>(__ldg(&lvl[(long long)t * n_levels + q]));
  }
}

// -- per-tile ECSQ, channels innermost: the fast route ---------------------
//
// The geometry of the uniform tile kernel's fast route (csrc/
// fused_clip_quant.cu): channels innermost, one spatial block, channel
// groups of a multiple of 8 channels, so a unit -- 8 consecutive channels
// of one row, one 16-byte load of bfloat16 -- lies in one tile.  A block
// covers RB rows x UW unit columns (unit column fastest, so a warp's loads
// and stores are runs of whole sectors), a unit a thread.  A thread loads
// its tile's range, N - 1 thresholds and N levels once: into registers
// for N <= 16 (NT the table's register width), else the block stages the
// at most kStageTiles tiles its columns touch in shared memory, where a
// warp's lanes of one tile read the same word.  The compares are
// branch-free counts, the level a select over the register table (or a
// shared load), the indices and the reconstruction vector stores.  CODED:
// the indices only, in coded order -- channel-major, position c * rows +
// row -- through a shared transpose of the block's (8 UW channels, RB
// rows) so that each channel's RB rows leave as one contiguous run.

constexpr int kUnit = 8;
constexpr int kStageTiles = 32;           // tiles of a block (shared tables)
constexpr int kCodedStage = 4096;         // int32 of the coded transpose

struct FastEcsq {
  long long rows;
  int units, C, lug, n_tiles;
  int lrb, luw;                           // log2 rows, units of a block
  long long nbu;                          // blocks across a row
};

template <typename T, int NT, bool CODED>
__global__ void __launch_bounds__(kThreads)
ecsq_assign_tiles_fast_kernel(const T* __restrict__ x, bool vec, FastEcsq g,
                              const float* __restrict__ lo,
                              const float* __restrict__ hi,
                              const float* __restrict__ thr,
                              const float* __restrict__ lvl, int n_levels,
                              int* __restrict__ idx, T* __restrict__ deq) {
  __shared__ float s_tab[NT == 0 ? kStageTiles * (2 * kMaxLevels + 1) : 1];
  __shared__ int s_idx[CODED ? kCodedStage : 1];
  const int uw = 1 << g.luw, rb = 1 << g.lrb;
  const long long bu = blockIdx.x % g.nbu, br = blockIdx.x / g.nbu;
  const int ul = threadIdx.x & (uw - 1), rl = threadIdx.x >> g.luw;
  const long long uc = bu * uw + ul, row = br * rb + rl;
  const bool act = uc < g.units && row < g.rows;
  const int tile = (int)((act ? uc : bu * uw) >> g.lug);
  const int nm1 = n_levels - 1;
  const long long off = (row * g.units + uc) * kUnit;
  float v[kUnit];
  if (act) repro::load_group<T, kUnit>(x + off, vec, v);
  float l = 0.f, h = 0.f;
  if (act) {
    l = __ldg(&lo[tile]);
    h = __ldg(&hi[tile]);
  }
  int q[kUnit];
  float d[kUnit];
  if constexpr (NT > 0) {
    float t[NT - 1], lv[NT];
    const float* tt = thr + (long long)tile * nm1;
    const float* tv = lvl + (long long)tile * n_levels;
#pragma unroll
    for (int k = 0; k < NT - 1; ++k)
      t[k] = act && k < nm1 ? __ldg(tt + k) : 0.f;
#pragma unroll
    for (int k = 0; k < NT; ++k)
      lv[k] = act && k < n_levels ? __ldg(tv + k) : 0.f;
#pragma unroll
    for (int e = 0; e < kUnit; ++e) {
      const float xc = fminf(fmaxf(v[e], l), h);
      int c = 0;
#pragma unroll
      for (int k = 0; k < NT - 1; ++k) c += (k < nm1) & (xc >= t[k]);
      float dv = lv[0];
#pragma unroll
      for (int k = 1; k < NT; ++k) dv = c == k ? lv[k] : dv;
      q[e] = c;
      d[e] = dv;
    }
  } else {
    // the tables of the tiles this block's columns touch
    const int t_first = (int)((bu * uw) >> g.lug);
    const long long u_last = min(bu * uw + uw, (long long)g.units) - 1;
    const int nt = (int)(u_last >> g.lug) - t_first + 1;     // <= kStageTiles
    float* s_thr = s_tab;
    float* s_lvl = s_tab + kStageTiles * kMaxLevels;
    for (int i = threadIdx.x; i < nt * nm1; i += blockDim.x)
      s_thr[i] = __ldg(&thr[(long long)t_first * nm1 + i]);
    for (int i = threadIdx.x; i < nt * n_levels; i += blockDim.x)
      s_lvl[i] = __ldg(&lvl[(long long)t_first * n_levels + i]);
    __syncthreads();
    const float* tt = s_thr + (tile - t_first) * nm1;
    const float* tv = s_lvl + (tile - t_first) * n_levels;
#pragma unroll
    for (int e = 0; e < kUnit; ++e) {
      const float xc = fminf(fmaxf(v[e], l), h);
      int c = 0;
      for (int k = 0; k < nm1; ++k) c += xc >= tt[k];
      q[e] = c;
      d[e] = act ? tv[c] : 0.f;
    }
  }
  if constexpr (CODED) {
    // transpose the block's (channels, rows) through shared memory: each
    // channel's rows leave as one run of coded positions
    const int cs = rb + 1;                 // padded: fewer bank conflicts
    if (act) {
#pragma unroll
      for (int e = 0; e < kUnit; ++e) s_idx[(ul * kUnit + e) * cs + rl] = q[e];
    }
    __syncthreads();
    const int n_ch = uw * kUnit;
    const long long c0 = bu * uw * kUnit, r0 = br * rb;
    for (int i = threadIdx.x; i < n_ch * rb; i += blockDim.x) {
      const int cl = i >> g.lrb, r = i & (rb - 1);
      if (c0 + cl < g.C && r0 + r < g.rows)
        idx[(c0 + cl) * g.rows + r0 + r] = s_idx[cl * cs + r];
    }
  } else {
    if (!act) return;
    int4* pi = reinterpret_cast<int4*>(idx + off);
    pi[0] = make_int4(q[0], q[1], q[2], q[3]);
    pi[1] = make_int4(q[4], q[5], q[6], q[7]);
    if (deq != nullptr) {
      alignas(16) T dt[kUnit];
#pragma unroll
      for (int e = 0; e < kUnit; ++e) dt[e] = repro::from_f32<T>(d[e]);
#pragma unroll
      for (int i = 0; i < kUnit * (int)sizeof(T) / 16; ++i)
        reinterpret_cast<uint4*>(deq + off)[i] =
            reinterpret_cast<const uint4*>(dt)[i];
    }
  }
}

int log2_of(long long v) {
  int l = 0;
  while ((1LL << l) < v) ++l;
  return l;
}

int grid_for(int n) {
  int want = (n + kThreads - 1) / kThreads;
  return want < 132 * 16 ? want : 132 * 16;
}

// The table from host memory: N - 1 thresholds padded with NaN, N levels.
EcsqTable host_table(const void* thr, const void* lvl, int n_levels) {
  EcsqTable tab;
  const float* t = static_cast<const float*>(thr);
  const float* l = static_cast<const float*>(lvl);
  for (int k = 0; k < kMaxLevels; ++k) {
    if (k < kMaxLevels - 1)
      tab.thr[k] = k < n_levels - 1 ? t[k]
                                    : std::numeric_limits<float>::quiet_NaN();
    tab.lvl[k] = k < n_levels ? l[k] : 0.f;
  }
  return tab;
}

template <typename T, int MODE>
int launch_ecsq(const void* x, long long n, bool vec, float lo, float hi,
                const EcsqTable& tab, int n_levels, void* idx, void* deq,
                void* hist, void* rows, long long rows_cap, void* ticket,
                int sms, cudaStream_t s) {
  repro::HistGrid g{0, false};
  if constexpr (MODE == repro::kNoHist) {
    // one group of four a thread: the most blocks in flight
    long long per_block = (long long)kThreads * 4;
    long long want = (n + per_block - 1) / per_block;
    g.blocks = want < 16LL * sms ? want : 16LL * sms;
  } else {
    g = repro::histogram_grid(n, kThreads, kPerIter, kOneBlockMax, sms);
    if (g.blocks > rows_cap) return (int)cudaErrorInvalidValue;
  }
  if (g.blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // the table's width: each counting mode's own, else by n_levels
  auto kernel = ecsq_assign_kernel<T, MODE, MODE == repro::kCount8 ? 4
                                            : MODE == repro::kCount16 ? 16
                                                                      : 64>;
  if constexpr (MODE == repro::kNoHist) {
    if (n_levels <= 4) kernel = ecsq_assign_kernel<T, MODE, 4>;
    else if (n_levels <= 16) kernel = ecsq_assign_kernel<T, MODE, 16>;
  }
  cudaError_t e = repro::launch_grid(
      kernel, g.blocks, kThreads, g.cluster, s, (const T*)x, n, vec, lo, hi,
      tab, n_levels, g.cluster, (int*)idx, (T*)deq, (int*)hist, (int*)rows,
      (unsigned*)ticket);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

template <typename T, int BITS>
int launch_ecsq_pack(const void* x, long long n, bool vec, float lo,
                     float hi, const EcsqTable& tab, int n_levels,
                     void* packed, void* hist, void* rows,
                     long long rows_cap, void* ticket, int sms,
                     cudaStream_t s) {
  repro::HistGrid g =
      repro::histogram_grid(n, kThreads, kPerIter, kOneBlockMax, sms);
  if (g.blocks > rows_cap || g.blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  // n_levels <= 2^BITS: 4 levels at most below 4 bits
  auto kernel = ecsq_assign_pack_kernel<T, repro::kCount8, 4, BITS>;
  if constexpr (BITS == 4) {
    if (n_levels > 4) kernel = ecsq_assign_pack_kernel<T, repro::kCount16, 16, 4>;
  }
  cudaError_t e = repro::launch_grid(
      kernel, g.blocks, kThreads, g.cluster, s, (const T*)x, n, vec, lo, hi,
      tab, n_levels, g.cluster, (unsigned char*)packed, (int*)hist,
      (int*)rows, (unsigned*)ticket);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace

// The per-tensor ECSQ quantizer: thr (N - 1) and lvl (N) float32 in host
// memory, read before the call returns.  deq may be null (no
// reconstruction written); hist may be null (no histogram), else rows is
// scratch of rows_cap * 64 int32 and ticket the stream's zeroed word
// (repro::store_histogram).
extern "C" int repro_ecsq_assign(const void* x, int dtype, long long n,
                                 float lo, float hi, const void* thr,
                                 const void* lvl, int n_levels, void* idx,
                                 void* deq, void* hist, void* rows,
                                 long long rows_cap, void* ticket,
                                 void* stream) {
  if (n <= 0 || n_levels < 2 || n_levels > kMaxLevels || idx == nullptr ||
      (hist != nullptr && ticket == nullptr))
    return (int)cudaErrorInvalidValue;
  int sms = repro::sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  // groups of four: 16-byte indices, 4-value loads and stores of x's type
  const unsigned quad = dtype == repro::kF32 ? 16u : 8u;
  auto aligned = [](const void* p, unsigned a) {
    return reinterpret_cast<uintptr_t>(p) % a == 0;
  };
  const bool vec = aligned(x, quad) && aligned(idx, 16) &&
                   (deq == nullptr || aligned(deq, quad));
  const EcsqTable tab = host_table(thr, lvl, n_levels);
  cudaStream_t s = (cudaStream_t)stream;
#define REPRO_ECSQ(MODE)                                                    \
  REPRO_DISPATCH_FLOAT(dtype, T,                                            \
      return launch_ecsq<T, MODE>(x, n, vec, lo, hi, tab, n_levels, idx,   \
                                  deq, hist, rows, rows_cap, ticket, sms,   \
                                  s))
  if (hist == nullptr) { REPRO_ECSQ(repro::kNoHist); }
  else if (n_levels <= 4) { REPRO_ECSQ(repro::kCount8); }
  else if (n_levels <= 16) { REPRO_ECSQ(repro::kCount16); }
  else { REPRO_ECSQ(repro::kMatch); }
#undef REPRO_ECSQ
  return (int)cudaErrorInvalidValue;
}

// The same pass writing the indices packed to bits (1, 2 or 4; n_levels
// <= 2^bits) into packed (ceil(n / (8 / bits)) bytes), with the
// histogram; hist, rows and ticket as above.
extern "C" int repro_ecsq_assign_pack(const void* x, int dtype, long long n,
                                      float lo, float hi, const void* thr,
                                      const void* lvl, int n_levels,
                                      int bits, void* packed, void* hist,
                                      void* rows, long long rows_cap,
                                      void* ticket, void* stream) {
  if (n <= 0 || n_levels < 2 || (bits != 1 && bits != 2 && bits != 4) ||
      n_levels > (1 << bits) || packed == nullptr || hist == nullptr ||
      ticket == nullptr)
    return (int)cudaErrorInvalidValue;
  int sms = repro::sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const unsigned quad = dtype == repro::kF32 ? 16u : 8u;
  const bool vec = reinterpret_cast<uintptr_t>(x) % quad == 0 &&
                   reinterpret_cast<uintptr_t>(packed) % 2 == 0;
  const EcsqTable tab = host_table(thr, lvl, n_levels);
  cudaStream_t s = (cudaStream_t)stream;
#define REPRO_PACK(BITS)                                                    \
  REPRO_DISPATCH_FLOAT(dtype, T,                                            \
      return launch_ecsq_pack<T, BITS>(x, n, vec, lo, hi, tab, n_levels,    \
                                       packed, hist, rows, rows_cap,        \
                                       ticket, sms, s))
  switch (bits) {
    case 1: REPRO_PACK(1); break;
    case 2: REPRO_PACK(2); break;
    default: REPRO_PACK(4); break;
  }
#undef REPRO_PACK
  return (int)cudaErrorInvalidValue;
}

// The fast route of the per-tile ECSQ quantizer: x is (rows, C) with
// channels innermost, one spatial block, channel groups of group_size (a
// power of two from 8 to 256) and C a multiple of 8; lo/hi, thr (N - 1 a
// group) and lvl (N a group) hold one table a group.  coded 0: int32
// indices in x's layout to idx, the reconstruction to deq (may be null);
// coded 1: the indices in coded order (channel-major) to idx, deq null.
extern "C" int repro_ecsq_assign_tiles_fast(
    const void* x, int dtype, long long rows, int C, int group_size,
    const void* lo, const void* hi, const void* thr, const void* lvl,
    int n_levels, void* idx, void* deq, int coded, void* stream) {
  const bool pow2 = group_size > 0 && (group_size & (group_size - 1)) == 0;
  if (rows <= 0 || C <= 0 || C % kUnit || !pow2 || group_size < kUnit ||
      group_size > 256 || n_levels < 2 || n_levels > kMaxLevels ||
      rows * C >= (1LL << 31) || idx == nullptr ||
      (coded && deq != nullptr))
    return (int)cudaErrorInvalidValue;
  FastEcsq g{};
  g.rows = rows;
  g.C = C;
  g.units = C / kUnit;
  g.lug = log2_of(group_size / kUnit);
  g.n_tiles = (C + group_size - 1) / group_size;
  // RB rows (up to 32) x UW unit columns, a unit a thread; with shared
  // tables at most 32 columns (kStageTiles tiles)
  g.lrb = log2_of(rows < 32 ? rows : 32);
  g.luw = log2_of(g.units);
  const int cap = log2_of(kThreads) - g.lrb;
  if (g.luw > cap) g.luw = cap;
  if (n_levels > 16 && g.luw > 5) g.luw = 5;
  const long long nbr = (rows + (1LL << g.lrb) - 1) >> g.lrb;
  // narrower blocks (down to 64 threads) while the grid would not give
  // every SM a block
  int sms = repro::sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  while (((g.units + (1LL << g.luw) - 1) >> g.luw) * nbr < sms &&
         g.luw > 3 && g.luw + g.lrb > 6)
    --g.luw;
  g.nbu = (g.units + (1LL << g.luw) - 1) >> g.luw;
  const long long blocks = g.nbu * nbr;
  const int threads = 1 << (g.lrb + g.luw);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  cudaStream_t s = (cudaStream_t)stream;
#define REPRO_ECSQ_FAST(NT, CODED)                                          \
  REPRO_DISPATCH_FLOAT(dtype, T,                                            \
      ecsq_assign_tiles_fast_kernel<T, NT, CODED>                           \
          <<<(unsigned)blocks, threads, 0, s>>>(                            \
              (const T*)x, vec, g, (const float*)lo, (const float*)hi,      \
              (const float*)thr, (const float*)lvl, n_levels, (int*)idx,    \
              (T*)deq))
#define REPRO_ECSQ_FAST_NT(NT)                                              \
  if (coded) { REPRO_ECSQ_FAST(NT, true); } else { REPRO_ECSQ_FAST(NT, false); }
  if (n_levels <= 4) { REPRO_ECSQ_FAST_NT(4); }
  else if (n_levels <= 16) { REPRO_ECSQ_FAST_NT(16); }
  else { REPRO_ECSQ_FAST_NT(0); }
#undef REPRO_ECSQ_FAST_NT
#undef REPRO_ECSQ_FAST
  return (int)cudaGetLastError();
}

extern "C" int repro_ecsq_assign_tiles(const void* x, int dtype, int n,
                                       int C, int inner, const void* cgroup,
                                       const void* sblock, int n_sblocks,
                                       const void* lo, const void* hi,
                                       const void* thr, const void* lvl,
                                       int n_levels, void* idx, void* deq,
                                       void* stream) {
  if (n <= 0 || C <= 0 || inner <= 0 || n_sblocks <= 0 || n_levels < 2 ||
      n_levels > kMaxLevels)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  REPRO_DISPATCH_FLOAT(dtype, T,
      ecsq_assign_tiles_kernel<T><<<grid_for(n), kThreads, 0, s>>>(
          (const T*)x, (unsigned)n, (unsigned)C, (unsigned)inner,
          (const int*)cgroup, (const int*)sblock, n_sblocks,
          (const float*)lo, (const float*)hi, (const float*)thr,
          (const float*)lvl, n_levels, (int*)idx, (T*)deq));
  return (int)cudaGetLastError();
}
