// Shared device helpers for the hand-written Hopper kernels.
//
// Every float step of the quantizer is an explicitly rounded intrinsic
// (__fsub_rn, __fmul_rn, __fadd_rn, __fdiv_rn): nvcc would otherwise
// contract a*b+c into one fused multiply-add, and a single rounding less
// can move a value across a bin edge.  The indices must be bit-exact with
// the JAX package's formula, which rounds after every operation.
#pragma once

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

}  // namespace repro

// Launch a kernel templated on the element type named by a dtype code.
#define REPRO_DISPATCH_FLOAT(code, T, ...)                  \
  switch (code) {                                           \
    case repro::kF32: { using T = float; __VA_ARGS__; break; }          \
    case repro::kBF16: { using T = __nv_bfloat16; __VA_ARGS__; break; } \
    case repro::kF16: { using T = __half; __VA_ARGS__; break; }         \
    default: return (int)cudaErrorInvalidValue;             \
  }
