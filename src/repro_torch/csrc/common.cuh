// Shared device helpers for the hand-written Hopper kernels.
//
// Every float step of the quantizer is an explicitly rounded intrinsic
// (__fsub_rn, __fmul_rn, __fadd_rn, __fdiv_rn): nvcc would otherwise
// contract a*b+c into one fused multiply-add, and a single rounding less
// can move a value across a bin edge.  The indices must be bit-exact with
// the JAX package's formula, which rounds after every operation.
#pragma once

#include <cstdint>

#include <cooperative_groups.h>
#include <cuda/atomic>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace repro {

// dtype codes shared with the Python wrappers (kernels/_build.py)
enum DType : int { kF32 = 0, kBF16 = 1, kF16 = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

// floor((clip(x, lo, hi) - lo) * scale + 0.5), every step rounded once.
// The result is >= 0, so floor(. + 0.5) is round-half-away-from-zero.
__device__ __forceinline__ float quant_level(float x, float lo, float hi,
                                             float scale) {
  float xc = fminf(fmaxf(x, lo), hi);
  return floorf(__fadd_rn(__fmul_rn(__fsub_rn(xc, lo), scale), 0.5f));
}

// Flat tile id of element i of a contiguous tensor seen as (outer, C,
// inner) around its channel axis: channel c = (i / inner) % C, position
// m = (i / (inner * C)) * inner + i % inner in the channel-major (C, M)
// view, tile = cgroup[c] * n_sblocks + sblock[m] (sblock == nullptr: one
// spatial block).  The TilePlan's own maps, so the tiled kernels read the
// tensor in place: no banded copy, no padding.
__device__ __forceinline__ int tile_of(unsigned i, unsigned C, unsigned inner,
                                       const int* __restrict__ cgroup,
                                       const int* __restrict__ sblock,
                                       int n_sblocks) {
  unsigned q = i / inner;
  int t = __ldg(&cgroup[q % C]) * n_sblocks;
  if (sblock != nullptr) t += __ldg(&sblock[(q / C) * inner + (i - q * inner)]);
  return t;
}

// PER consecutive values of T at p as float32: one to four 16-byte loads
// (or one 8- or 4-byte load) when `vec` (p aligned to their size), else
// one load a value.
template <typename T, int PER>
__device__ __forceinline__ void load_group(const T* p, bool vec,
                                           float out[PER]) {
  constexpr int kBytes = PER * (int)sizeof(T);
  if constexpr (kBytes >= 4) {
    if (vec) {
      uint32_t raw[kBytes / 4];
      if constexpr (kBytes >= 16) {
#pragma unroll
        for (int i = 0; i < kBytes / 16; ++i)
          reinterpret_cast<uint4*>(raw)[i] =
              __ldg(reinterpret_cast<const uint4*>(p) + i);
      } else if constexpr (kBytes == 8) {
        *reinterpret_cast<uint2*>(raw) =
            __ldg(reinterpret_cast<const uint2*>(p));
      } else {
        raw[0] = __ldg(reinterpret_cast<const unsigned*>(p));
      }
      const T* e = reinterpret_cast<const T*>(raw);
#pragma unroll
      for (int k = 0; k < PER; ++k) out[k] = to_f32(e[k]);
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < PER; ++k) out[k] = to_f32(p[k]);
}

// Division of n < 2^31 by an invariant d >= 1 as a high multiply, an add
// and a shift (Granlund and Montgomery, "Division by invariant integers
// using multiplication", 1994): with l = ceil(log2 d) and m = floor(2^32
// (2^l - d) / d) + 1, n / d == (umulhi(n, m) + n) >> l, and the sum fits
// 32 bits because umulhi(n, m) <= n < 2^31.
struct FastDiv {
  unsigned d, mul, shift;
};

inline FastDiv make_fast_div(unsigned d) {
  unsigned l = 0;
  while ((1ull << l) < d) ++l;
  return {d, (unsigned)(((1ull << 32) * ((1ull << l) - d)) / d + 1), l};
}

__device__ __forceinline__ unsigned fast_div(unsigned n, FastDiv f) {
  return (__umulhi(n, f.mul) + n) >> f.shift;
}

// -- counting quantizer levels in registers -----------------------------------
//
// The encode megakernel (#3), the per-tensor quantizers (#1, #7) and the
// index histogram (#4) count the same way.  A thread counts its levels in
// registers: levels < 4 into four 8-bit fields of one word (bin8), which
// it widens into 16-bit fields after each iteration (widen8); levels < 16
// straight into 16-bit fields, bins 2k and 2k + 1 in word k (count16).
// The lanes that share a histogram then sum each word with one
// __reduce_add_sync.  Wider level counts group a warp's equal keys with
// __match_any_sync, one shared atomic per distinct key (match_count).

constexpr int kHistWidth = 64;   // bins of one histogram row
constexpr int kCountWords = 8;   // 16-bit counter words: levels < 16

__device__ __forceinline__ uint32_t bin8(int q, bool on) {
  return on ? 1u << (q * 8) : 0u;
}

__device__ __forceinline__ void widen8(uint32_t c8,
                                       uint32_t (&cnt)[kCountWords]) {
  cnt[0] += (c8 & 0xFFu) | (c8 & 0xFF00u) << 8;
  cnt[1] += (c8 >> 16 & 0xFFu) | (c8 >> 24) << 16;
}

__device__ __forceinline__ void count16(int q, bool on,
                                        uint32_t (&cnt)[kCountWords]) {
#pragma unroll
  for (int w = 0; w < kCountWords; ++w)
    cnt[w] += on && (q >> 1) == w ? 1u << ((q & 1) * 16) : 0u;
}

// Every lane of the warp calls this together.
__device__ __forceinline__ void match_count(int* sh, bool on, unsigned key) {
  unsigned k = on ? key : 0xFFFFFFFFu;
  unsigned peers = __match_any_sync(0xFFFFFFFFu, k);
  if (on && (int)(threadIdx.x & 31) == __ffs(peers) - 1)
    atomicAdd(&sh[k], __popc(peers));
}

// What a per-tensor quantizer launch (#1, #7) counts: nothing, levels < 4
// (bin8), levels < 16 (count16), or wider levels (match_count).
enum QuantMode : int { kNoHist = 0, kCount8 = 1, kCount16 = 2, kMatch = 3 };

// Four values of T as one load: 8 bytes of bfloat16 or half, 16 of
// float32.  Their four indices are one 16-byte store, so a warp's index
// stores (and loads, and reconstruction stores) are contiguous.
template <typename T> struct Quad { using type = uint2; };
template <> struct Quad<float> { using type = uint4; };

// A quantizer's counting of PER levels (kNoHist counts nothing); levels
// outside [0, nl) are not counted.
template <int MODE, int PER>
__device__ __forceinline__ void count_levels(const int (&q)[PER],
                                             unsigned nl, int* sh,
                                             uint32_t (&cnt)[kCountWords]) {
  if constexpr (MODE == kCount8) {
    uint32_t c8 = 0;
#pragma unroll
    for (int k = 0; k < PER; ++k) c8 += bin8(q[k], (unsigned)q[k] < nl);
    widen8(c8, cnt);
  } else if constexpr (MODE == kCount16) {
#pragma unroll
    for (int k = 0; k < PER; ++k) count16(q[k], (unsigned)q[k] < nl, cnt);
  } else if constexpr (MODE == kMatch) {
#pragma unroll
    for (int k = 0; k < PER; ++k)
      match_count(sh, (unsigned)q[k] < nl, (unsigned)q[k]);
  }
}

// -- one histogram from a grid, with no pre-zeroed output ---------------------
//
// The block's warps sum their threads' 16-bit counter words with one
// __reduce_add_sync each; warp 0 sums the warps' words the same way (or,
// for the match path, reads the block's shared bins), so lane b holds bin
// b (block_bins).  Then one of three routes, chosen by the host
// (histogram_grid):
//   * one block: warp 0 stores the bins;
//   * a cluster of kClusterBlocks blocks (grids that small): each block's
//     warp 0 stores its bins into block 0's shared memory, and after one
//     cluster barrier block 0 sums them and stores the bins
//     (cluster_store).  Every thread arrives at the cluster barrier's
//     first phase as the kernel starts (cluster_start), so waiting on it
//     here (all blocks running, their shared memory live) costs little;
//   * more blocks: warp 0 stores the block's row into `rows` (n_levels
//     int32 a block, rows packed: scratch the caller takes uninitialised)
//     and lane 0 takes a ticket with one acquire-release atomic (a full
//     fence on each side of a relaxed atomic cost ~0.4 us more a launch on
//     the H100, PERF.md); the block that takes the last one sums all
//     rows -- each thread the entries of one bin, a warp's lanes of one
//     bin then together, one shared atomic per (warp, bin) -- and stores
//     the bins, then resets the ticket to 0 for the next launch.  The
//     ticket is a zeroed word the caller passes: one per (device, stream)
//     (kernels/_build.py), so launches on one stream take it in turn and
//     launches on two streams never share it.
// Every route stores the output bins with plain stores.
//
// A warp's sum of one 16-bit field must stay below 2^16, so a thread
// counts at most kCountsPerThread levels (the C entries size their grids
// for that).  blockDim.x is a multiple of 32, from 64 to 1024.

constexpr long long kCountsPerThread = 2000;
constexpr int kClusterBlocks = 8;

__device__ __forceinline__ void cluster_start(bool cluster) {
  if (cluster) asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

// The block's bins in warp 0: lane b holds bin b in a0 and bin b + 32 in
// a1 (other warps: 0).  Ends past a block barrier.
template <bool kMatch>
__device__ __forceinline__ void block_bins(const uint32_t (&cnt)[kCountWords],
                                           const int* sh_match, int n_levels,
                                           int& a0, int& a1) {
  constexpr unsigned kFull = 0xFFFFFFFFu;
  __shared__ uint32_t s_cnt[32][kCountWords];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int n_words = (n_levels + 1) / 2;
  if constexpr (!kMatch) {
#pragma unroll
    for (int w = 0; w < kCountWords; ++w) {
      if (w >= n_words) break;               // uniform across the block
      uint32_t r = __reduce_add_sync(kFull, cnt[w]);
      if (lane == 0) s_cnt[warp][w] = r;
    }
  }
  __syncthreads();
  a0 = a1 = 0;
  if (warp != 0) return;
  if constexpr (kMatch) {
    a0 = sh_match[lane];
    a1 = sh_match[lane + 32];
  } else {
#pragma unroll
    for (int w = 0; w < kCountWords; ++w) {
      if (w >= n_words) break;
      uint32_t x = lane < n_warps ? s_cnt[lane][w] : 0u;
      int lo = (int)__reduce_add_sync(kFull, x & 0xFFFFu);
      int hi = (int)__reduce_add_sync(kFull, x >> 16);
      if (lane == 2 * w) a0 = lo;
      if (lane == 2 * w + 1) a0 = hi;
    }
  }
}

// Every thread of the cluster calls this after block_bins: block 0 sums
// the kClusterBlocks blocks' bins and stores them to hist.
__device__ __forceinline__ void cluster_store(int a0, int a1, int n_levels,
                                              int* __restrict__ hist) {
  namespace cg = cooperative_groups;
  __shared__ int s_rows[kClusterBlocks][kHistWidth];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  cg::cluster_group cl = cg::this_cluster();
  const unsigned rank = cl.block_rank();
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  if (warp == 0) {
    int* dst = cl.map_shared_rank(&s_rows[rank][0], 0);
    if (lane < n_levels) dst[lane] = a0;
    if (lane + 32 < n_levels) dst[lane + 32] = a1;
  }
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
  if (rank == 0 && warp == 0) {
    int s0 = 0, s1 = 0;
#pragma unroll
    for (int r = 0; r < kClusterBlocks; ++r) {
      s0 += lane < n_levels ? s_rows[r][lane] : 0;
      s1 += lane + 32 < n_levels ? s_rows[r][lane + 32] : 0;
    }
    if (lane < n_levels) hist[lane] = s0;
    if (lane + 32 < n_levels) hist[lane + 32] = s1;
  }
}

template <bool kMatch>
__device__ __forceinline__ void store_histogram(
    const uint32_t (&cnt)[kCountWords], const int* sh_match, int n_levels,
    bool cluster, int* __restrict__ hist, int* __restrict__ rows,
    unsigned* __restrict__ ticket) {
  constexpr unsigned kFull = 0xFFFFFFFFu;
  __shared__ int s_bins[kHistWidth];
  __shared__ bool s_last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x < kHistWidth) s_bins[threadIdx.x] = 0;
  int a0, a1;
  block_bins<kMatch>(cnt, sh_match, n_levels, a0, a1);
  if (cluster) {
    cluster_store(a0, a1, n_levels, hist);
    return;
  }
  if (warp == 0) {
    int* out = gridDim.x == 1 ? hist : rows + (long long)blockIdx.x * n_levels;
    if (lane < n_levels) out[lane] = a0;
    if (lane + 32 < n_levels) out[lane + 32] = a1;
    if (gridDim.x > 1) {
      // the warp's row stores precede lane 0's release; its acquire, then
      // the block barrier, order the last block's reads after every row
      __syncwarp();
      if (lane == 0) {
        cuda::atomic_ref<unsigned, cuda::thread_scope_device> t(*ticket);
        s_last = t.fetch_add(1u, cuda::memory_order_acq_rel) ==
                 gridDim.x - 1;
      }
    }
  }
  if (gridDim.x == 1) return;
  __syncthreads();
  if (!s_last) return;
  // the last block: thread t < S sums the entries t, t + S, ... of bin
  // t % n_levels (S a multiple of n_levels), read from L2
  const int S = ((int)blockDim.x / n_levels) * n_levels;
  const long long total = (long long)gridDim.x * n_levels;
  const bool in = (int)threadIdx.x < S;
  int acc = 0;
  if (in) {
#pragma unroll 8
    for (long long p = threadIdx.x; p < total; p += S) acc += __ldcg(rows + p);
  }
  const int bin = in ? (int)threadIdx.x % n_levels : -1;
  unsigned peers = __match_any_sync(kFull, (unsigned)bin);
  int r = __reduce_add_sync(peers, (unsigned)acc);
  if (in && lane == __ffs(peers) - 1) atomicAdd(&s_bins[bin], r);
  __syncthreads();
  if ((int)threadIdx.x < n_levels) hist[threadIdx.x] = s_bins[threadIdx.x];
  if (threadIdx.x == 0)
    cuda::atomic_ref<unsigned, cuda::thread_scope_device>(*ticket).store(
        0u, cuda::memory_order_relaxed);
}

// The grid of a histogram of n levels counted `per` to a thread and
// iteration by blocks of `threads`: one block up to `one_block_max`; a
// cluster of kClusterBlocks while that many blocks cover n in one
// iteration; else one iteration a thread up to two blocks per SM (four
// were slower at 2^20 values, PERF.md), more only to keep each
// thread under kCountsPerThread.
struct HistGrid {
  long long blocks;
  bool cluster;
};

inline HistGrid histogram_grid(long long n, int threads, int per,
                               long long one_block_max, int sms) {
  if (n <= one_block_max) return {1, false};
  long long per_block = (long long)threads * per;
  long long want = (n + per_block - 1) / per_block;
  if (want <= kClusterBlocks) return {kClusterBlocks, true};
  long long floor_ = (n + threads * kCountsPerThread - 1) /
                     (threads * kCountsPerThread);
  long long b = want < 2LL * sms ? want : 2LL * sms;
  return {b > floor_ ? b : floor_, false};
}

// Launch `kernel` on `blocks` blocks of `threads` with `smem` bytes of
// dynamic shared memory, as clusters of `cluster` blocks (0: none).
template <typename... Params, typename... Args>
inline cudaError_t launch_grid_smem(void (*kernel)(Params...),
                                    long long blocks, int threads,
                                    size_t smem, int cluster,
                                    cudaStream_t s, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster > 0 ? cluster : 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 0 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// Launch `kernel` on `blocks` blocks of `threads`, as clusters of
// kClusterBlocks when `cluster` is set.
template <typename... Params, typename... Args>
inline cudaError_t launch_grid(void (*kernel)(Params...), long long blocks,
                               int threads, bool cluster, cudaStream_t s,
                               Args... args) {
  return launch_grid_smem(kernel, blocks, threads, 0,
                          cluster ? kClusterBlocks : 0, s, args...);
}

// Streaming multiprocessors of the current device (0 on an error).
inline int sm_count() {
  static int cache[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cache[dev] == 0 &&
      cudaDeviceGetAttribute(&cache[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    cache[dev] = 0;
  return cache[dev];
}

// -- the attention kernels' tiles ---------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// two float32 values rounded to bf16, lo in the low half
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

}  // namespace repro

// Launch a kernel templated on the element type named by a dtype code.
#define REPRO_DISPATCH_FLOAT(code, T, ...)                  \
  switch (code) {                                           \
    case repro::kF32: { using T = float; __VA_ARGS__; break; }          \
    case repro::kBF16: { using T = __nv_bfloat16; __VA_ARGS__; break; } \
    case repro::kF16: { using T = __half; __VA_ARGS__; break; }         \
    default: return (int)cudaErrorInvalidValue;             \
  }
