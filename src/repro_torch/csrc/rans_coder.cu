// Reverse interleaved binary rANS step loop for Hopper (sm_90a).
//
// Replaces the Pallas kernel rans_coder._rans_step_kernel
// (_step_loop_pallas), which ran one grid step per coding step and
// carried the lane states in a revisited output block.  Here one thread
// owns one lane and runs the whole loop, from the last step down to
// step 0, with its state in a register; only the per-step overflow flag
// and raw low word go to device memory (the word compaction that
// follows is torch code on the device, as it sat outside the Pallas
// kernel too).
//
// Bound by the serial per-lane chain: every step depends on the
// previous state through a 32-bit integer division, and a stream has at
// most 4096 lanes, so only a few SMs have work.  The design keeps that
// chain as short as the format allows -- one load of the bit and the
// step's shared probability (a broadcast), the division, two stores --
// and codes every lane of a stream in one launch.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kProbBits = 14;
constexpr uint32_t kM = 1u << kProbBits;
constexpr uint32_t kStateLo = 1u << 16;
constexpr int kThreads = 128;

__global__ void rans_step_kernel(const uint8_t* __restrict__ bits,
                                 const int* __restrict__ f1_steps,
                                 int total_steps, int lanes,
                                 uint32_t* __restrict__ states,
                                 uint8_t* __restrict__ overflow,
                                 uint16_t* __restrict__ words) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  uint32_t x = kStateLo;
  for (int t = total_steps - 1; t >= 0; --t) {
    uint32_t f1 = (uint32_t)f1_steps[t];
    uint32_t f0 = kM - f1;
    long long at = (long long)t * lanes + lane;
    uint32_t b = bits[at];
    uint32_t f = b ? f1 : f0;
    bool over = x >= (f << (32 - kProbBits));
    words[at] = (uint16_t)(x & 0xFFFFu);
    overflow[at] = over;
    if (over) x >>= 16;
    uint32_t q = x / f;
    x = (q << kProbBits) + (x - q * f) + (b ? f0 : 0u);
  }
  states[lane] = x;
}

}  // namespace

extern "C" int repro_rans_step(const void* bits, const void* f1_steps,
                               int total_steps, int lanes, void* states,
                               void* overflow, void* words, void* stream) {
  if (total_steps <= 0 || lanes <= 0) return (int)cudaErrorInvalidValue;
  int blocks = (lanes + kThreads - 1) / kThreads;
  rans_step_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)bits, (const int*)f1_steps, total_steps, lanes,
      (uint32_t*)states, (uint8_t*)overflow, (uint16_t*)words);
  return (int)cudaGetLastError();
}
