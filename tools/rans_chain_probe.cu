// Dependent-latency probe of one rANS step (kernel #6,
// src/repro_torch/csrc/rans_coder.cu), built and run by chip_smoke.py for
// the step loop's chain bound.
//
// One thread codes `iters` steps of one lane on register constants and
// reads clock64 around the loop, for two forms of the same step:
//   least   -- the shortest dependent chain known for the step: the
//              reciprocal multiply on the state before renormalisation,
//              p = x * mh + umulhi(x, ml) (IMAD.HI, IMAD.WIDE.U32), whose
//              product gives both quotients, x / f = p >> 31 and
//              (x >> 16) / f = (x / f) >> 16 = p >> 47 (SHF.R.U64); the
//              renormalise compare runs beside the multiply, and a select
//              of the quotient then the update IMAD close the step;
//   shipped -- the step as rans_coder.cu writes it: compare and select the
//              renormalised state, then divide it, then update.
// Both forms compute the same states; the caller checks that they agree.
// in[]: x0, thr0, thr1, mh0, ml0, mh1, ml1, f0, f1, bit pattern.

#include <cstdint>

#include <cuda_runtime.h>

#define TIMED_LOOP(slot, ...)                                         \
  {                                                                   \
    uint32_t x = x0;                                                  \
    long long t0 = clock64();                                         \
    _Pragma("unroll 32") for (int i = 0; i < iters; ++i) {            \
      bool one = (bits >> (i & 31)) & 1u;                             \
      uint32_t thr = one ? thr1 : thr0, mh = one ? mh1 : mh0,         \
               ml = one ? ml1 : ml0, g = one ? f0 : f1,               \
               c = one ? f0 : 0u;                                     \
      __VA_ARGS__                                                     \
    }                                                                 \
    cycles[slot] = clock64() - t0;                                    \
    states[slot] = x;                                                 \
  }

__global__ void chain_probe(const uint32_t* __restrict__ in,
                            long long* __restrict__ cycles,
                            uint32_t* __restrict__ states, int iters) {
  const uint32_t x0 = in[0], thr0 = in[1], thr1 = in[2], mh0 = in[3],
                 ml0 = in[4], mh1 = in[5], ml1 = in[6], f0 = in[7],
                 f1 = in[8], bits = in[9];
  TIMED_LOOP(0, {
    unsigned long long p = (unsigned long long)x * mh + __umulhi(x, ml);
    bool over = x >= thr;
    uint32_t q = over ? (uint32_t)(p >> 47) : (uint32_t)(p >> 31);
    uint32_t xr = over ? x >> 16 : x;
    x = xr + c + q * g;
  })
  TIMED_LOOP(1, {
    if (x >= thr) x >>= 16;
    uint32_t q = (uint32_t)(((unsigned long long)x * mh + __umulhi(x, ml))
                            >> 31);
    x += c + q * g;
  })
}

extern "C" int rans_chain_probe(const void* in, void* cycles, void* states,
                                int iters, void* stream) {
  chain_probe<<<1, 1, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)in, (long long*)cycles, (uint32_t*)states, iters);
  return (int)cudaGetLastError();
}
