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

#include "common.cuh"

namespace {

constexpr int kHistWidth = 64;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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

}  // namespace

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
