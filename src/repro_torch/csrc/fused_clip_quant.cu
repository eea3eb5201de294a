// Fused clip + uniform quantize kernels for Hopper (sm_90a).
//
// repro_clip_quant replaces the Pallas kernel fused_clip_quant._kernel
// (clip_quant_2d): per-tensor clip -> quantize -> dequantize.
// repro_clip_quant_tiles replaces fused_clip_quant._kernel_tiles
// (clip_quant_tiles_2d, clip_quant_rows_2d): the same with per-tile
// ranges under a TilePlan.
// repro_encode_tiles replaces fused_clip_quant._kernel_encode
// (encode_tiles_2d): clip -> quantize -> bit-pack -> per-(row, band)
// histogram in one pass.
//
// All three are bound by bytes: each element is read once and its outputs
// written once, with a handful of float operations in between.  The
// designs keep exactly one pass over device memory: clip_quant is a
// grid-stride elementwise loop; clip_quant_tiles is the same loop with
// each thread looking up its element's tile (repro::tile_of) and that
// tile's range, so the tensor is read in its own layout -- the Pallas
// kernel's banded, lane-padded copy existed only so a (rows, 1) range
// column could broadcast over a VMEM block.  encode_tiles keeps the int32
// index tensor out of device memory; its note below says what bounds it.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kHistWidth = 64;  // lanes per (row, band) histogram
constexpr int kThreads = 256;

template <typename T>
__global__ void clip_quant_kernel(const T* __restrict__ x, long long n,
                                  float lo, float hi, float scale,
                                  float inv_scale, int* __restrict__ idx,
                                  T* __restrict__ deq) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float q = repro::quant_level(repro::to_f32(x[i]), lo, hi, scale);
    idx[i] = (int)q;
    deq[i] = repro::from_f32<T>(__fadd_rn(lo, __fmul_rn(q, inv_scale)));
  }
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
    deq[i] = repro::from_f32<T>(
        __fadd_rn(l, __fmul_rn(q, __fdiv_rn(span, nm1))));
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
constexpr int kWords = 8;       // 16-bit counter words for N <= 16

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
      for (int k = 0; k < PER; ++k) out[k] = repro::to_f32(e[k]);
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < PER; ++k) out[k] = repro::to_f32(p[k]);
}

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
    load_group<T, E>(xb + (long long)threadIdx.x * E, vec, v);
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
      if (it > 0) load_group<T, E>(xb + (long long)lb * PER, vec, v);
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
        for (int e = 0; e < E; ++e)
          c8 += col + e < valid ? 1u << (q[e] * 8) : 0u;
        cnt[0] += (c8 & 0xFFu) | (c8 & 0xFF00u) << 8;
        cnt[1] += (c8 >> 16 & 0xFFu) | (c8 >> 24) << 16;
      } else if (act) {
#pragma unroll
        for (int e = 0; e < E; ++e)
          if (col + e < valid) {
#pragma unroll
            for (int w = 0; w < kWords; ++w)
              cnt[w] += (q[e] >> 1) == w ? 1u << ((q[e] & 1) * 16) : 0u;
          }
      }
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        bool counted = act && col + e < valid;
        unsigned key = counted ? (unsigned)(cl * kHistWidth + q[e])
                               : 0xFFFFFFFFu;
        unsigned peers = __match_any_sync(0xFFFFFFFFu, key);
        if (counted && lane == __ffs(peers) - 1)
          atomicAdd(&sh[key], __popc(peers));
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

extern "C" int repro_clip_quant(const void* x, int dtype, long long n,
                                float lo, float hi, float scale,
                                float inv_scale, void* idx, void* deq,
                                void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  long long want = (n + kThreads - 1) / kThreads;
  int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  cudaStream_t s = (cudaStream_t)stream;
  REPRO_DISPATCH_FLOAT(dtype, T,
      clip_quant_kernel<T><<<blocks, kThreads, 0, s>>>(
          (const T*)x, n, lo, hi, scale, inv_scale, (int*)idx, (T*)deq));
  return (int)cudaGetLastError();
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
  static int sms = 0;
  if (sms == 0 && cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                         0) != cudaSuccess)
    return (int)cudaGetLastError();
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
