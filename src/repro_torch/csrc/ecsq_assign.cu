// Non-uniform (ECSQ) quantization by decision thresholds for Hopper
// (sm_90a): the deploy-time side of the paper's Algorithm 1.
//
// repro_ecsq_assign replaces the Pallas kernel ecsq_assign._kernel
// (ecsq_assign_2d): one designed quantizer for the whole tensor.
// repro_ecsq_assign_tiles replaces ecsq_assign._kernel_tiles
// (ecsq_assign_tiles_2d): one quantizer per TilePlan tile.
//
// Both compute idx = #{k < N-1 : clip(x) >= t_k} -- ties go to the upper
// bin, as searchsorted(side="right") does -- and deq = level[idx], so the
// reconstruction is a table entry and the only rounding is the one to
// x's dtype.  The Pallas bodies looped over the table with iota-masked
// selects because a TPU vector cannot index a lane by a value; a thread
// here compares against each threshold and gathers its level directly.
//
// Bound by bytes at N = 4 (one read, two writes per element); at N = 64
// the 63 compares per element approach the card's instruction rate.  The
// per-tensor kernel stages its one table (at most 64 + 63 floats) in
// shared memory, where every thread reads the same word at once (a
// broadcast).  The per-tile tables are n_tiles * (2N - 1) floats (14 KB
// for 512 tiles at N = 4, 254 KB at N = 64): staging all of them in every
// block would move more bytes than the tensor, so each thread reads its
// tile's row through the read-only L1 path, where a warp's 32 neighbouring
// elements share a few tiles' rows.  The element -> tile lookup is the
// uniform tile kernel's (repro::tile_of), in the tensor's own layout.

#include "common.cuh"

namespace {

constexpr int kMaxLevels = 64;
constexpr int kThreads = 256;

template <typename T>
__global__ void ecsq_assign_kernel(const T* __restrict__ x, unsigned n,
                                   float lo, float hi,
                                   const float* __restrict__ thr,
                                   const float* __restrict__ lvl,
                                   int n_levels, int* __restrict__ idx,
                                   T* __restrict__ deq) {
  __shared__ float s_thr[kMaxLevels], s_lvl[kMaxLevels];
  for (int k = threadIdx.x; k < n_levels; k += blockDim.x) {
    s_lvl[k] = lvl[k];
    if (k < n_levels - 1) s_thr[k] = thr[k];
  }
  __syncthreads();
  unsigned stride = gridDim.x * blockDim.x;
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float xc = fminf(fmaxf(repro::to_f32(x[i]), lo), hi);
    int q = 0;
    for (int k = 0; k < n_levels - 1; ++k) q += xc >= s_thr[k];
    idx[i] = q;
    if (deq != nullptr) deq[i] = repro::from_f32<T>(s_lvl[q]);
  }
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

}  // namespace

extern "C" int repro_ecsq_assign(const void* x, int dtype, int n, float lo,
                                 float hi, const void* thr, const void* lvl,
                                 int n_levels, void* idx, void* deq,
                                 void* stream) {
  if (n <= 0 || n_levels < 2 || n_levels > kMaxLevels)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  REPRO_DISPATCH_FLOAT(dtype, T,
      ecsq_assign_kernel<T><<<grid_for(n), kThreads, 0, s>>>(
          (const T*)x, (unsigned)n, lo, hi, (const float*)thr,
          (const float*)lvl, n_levels, (int*)idx, (T*)deq));
  return (int)cudaGetLastError();
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
