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
    deq[i] = repro::from_f32<T>(s_lvl[q]);
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
    deq[i] = repro::from_f32<T>(__ldg(&lvl[(long long)t * n_levels + q]));
  }
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
