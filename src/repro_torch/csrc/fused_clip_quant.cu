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
// column could broadcast over a VMEM block; encode_tiles gives one
// thread one packed output byte (per = 8 / bits adjacent inputs) and
// keeps the block's
// 64-bin histogram in shared memory, so the int32 index tensor never
// reaches device memory and only one atomic per bin leaves each block.

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

// One block covers up to kThreads packed bytes of one (row, band) cell.
template <typename T>
__global__ void encode_tiles_kernel(const T* __restrict__ x, int cols,
                                    int sb_cols, int n_sblocks,
                                    const float* __restrict__ lo,
                                    const float* __restrict__ hi,
                                    const int* __restrict__ band_valid,
                                    int n_levels, int bits, int per,
                                    int chunks,
                                    unsigned char* __restrict__ packed,
                                    int* __restrict__ hist) {
  __shared__ int sh[kHistWidth];
  long long cell = blockIdx.x;
  int chunk = (int)(cell % chunks);
  cell /= chunks;
  int band = (int)(cell % n_sblocks);
  long long row = cell / n_sblocks;
  for (int i = threadIdx.x; i < kHistWidth; i += blockDim.x) sh[i] = 0;
  __syncthreads();

  int bytes_per_band = sb_cols / per;
  int jb = chunk * blockDim.x + threadIdx.x;  // packed byte within the band
  if (jb < bytes_per_band) {
    long long rb = row * n_sblocks + band;
    float l = lo[rb], h = hi[rb];
    float span = fmaxf(__fsub_rn(h, l), 1e-12f);
    float scale = __fdiv_rn((float)(n_levels - 1), span);
    int limit = band_valid[band];
    int col = jb * per;  // first input column of this byte, within the band
    const T* xr = x + row * cols + (long long)band * sb_cols + col;
    unsigned acc = 0;
    for (int k = 0; k < per; ++k) {
      int q = (int)repro::quant_level(repro::to_f32(xr[k]), l, h, scale);
      acc |= (unsigned)q << (k * bits);
      if (col + k < limit) atomicAdd(&sh[q], 1);
    }
    packed[row * (cols / per) + (long long)band * bytes_per_band + jb] =
        (unsigned char)acc;
  }
  __syncthreads();
  int* out = hist + (row * n_sblocks + band) * kHistWidth;
  for (int i = threadIdx.x; i < n_levels; i += blockDim.x)
    if (sh[i]) atomicAdd(&out[i], sh[i]);
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
  int chunks = (sb_cols / per + kThreads - 1) / kThreads;
  long long blocks = (long long)rows * n_sblocks * chunks;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  REPRO_DISPATCH_FLOAT(dtype, T,
      encode_tiles_kernel<T><<<(unsigned)blocks, kThreads, 0, s>>>(
          (const T*)x, cols, sb_cols, n_sblocks, (const float*)lo,
          (const float*)hi, (const int*)band_valid, n_levels, bits, per,
          chunks, (unsigned char*)packed, (int*)hist));
  return (int)cudaGetLastError();
}
