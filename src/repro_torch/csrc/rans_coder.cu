// Reverse interleaved binary rANS step loop for Hopper (sm_90a).
//
// Replaces the Pallas kernel rans_coder._rans_step_kernel
// (_step_loop_pallas), which ran one grid step per coding step and
// carried the lane states in a revisited output block.  Here one launch
// codes a batch of independent streams -- every chunk of a tensor, or of
// a serving tick -- and one thread owns one lane of one stream: it runs
// the whole loop, from the stream's last step down to step 0, with its
// state in a register.  Only the per-step overflow flag and raw low word
// go to device memory (the word compaction that follows is torch code on
// the device, as it sat outside the Pallas kernel too).
//
// Inputs, all on the device:
//   bits   uint8, the streams' (steps, lanes) bit matrices concatenated;
//   segs   int32 (n_seg, 2): per probability segment of a stream, its
//          first step and its P(bit=1) f1 (a segment is one 256-step
//          chunk of a TU plane: the chunk-static probability table);
//   table  int64 (n_streams, 6): per stream, the offset of its matrices
//          (bits, overflow and words share one layout), the offset and
//          count of its segments, the offset of its states, its steps
//          and its lanes.
//
// What bounds it: the serial per-lane chain.  Each step's state depends
// on the previous one; a stream has at most 4096 lanes, and the format
// fixes the lane count, so the steps of one lane can never run in
// parallel.  The least time is steps x the latency of the step's least
// dependent chain: the reciprocal multiply on the state before
// renormalisation (IMAD.HI, IMAD.WIDE.U32, SHF.R.U64 -- one product gives
// both x / f and (x >> 16) / f), a select of the quotient, the update
// IMAD; chip_smoke.py measures it in each run (tools/rans_chain_probe.cu).
// The form below puts the renormalise compare and select (ISETP, SEL)
// before the divide, on the chain.  What the design does about it:
//   * loads are off the chain: a lane's bits for the next kWindow steps
//     are loaded into registers while the current window is coded, and a
//     segment's probability and its derived constants (f0, f1, the two
//     renormalisation thresholds, the two reciprocal multipliers) are
//     loaded and computed once per segment, not per step;
//   * no branch inside a window: the top window takes the odd steps, and
//     a window that stays inside one segment (15 in 16) codes its steps
//     with no segment or bound check between them;
//   * no hardware divide on the chain: floor(x / f) is an exact
//     reciprocal multiply, m = ceil(2^63 / f) split into 32-bit halves
//     (mh, ml), q = (x * mh + umulhi(x, ml)) >> 31 -- exact for every
//     32-bit x and every f in [1, 2^14), because x * (f - 1) < 2^63
//     (kernels/rans_coder.py recip_div is the same arithmetic, proven on
//     the CPU).  With x' the renormalised state, the update
//     (q << 14) + (x' - q f) + c becomes x' + q (2^14 - f) + c;
//   * many streams in one launch: the grid is (lane groups, streams), one
//     warp per block, so the 16 chunks of a prefill tensor (256 lanes
//     each) land on 128 SMs instead of 2.  Each warp is bound by its own
//     chain, so warps gain nothing from sharing an SM: 64 threads per
//     block measure the same, 128 are slower (PERF.md).  The
//     kernel uses no shared memory; ptxas gives it ~250 registers, no
//     spills (one warp per SM leaves them free).
// A step still costs ~80 cycles, against ~35 for the least chain and ~43
// for this form's own chain (PERF.md): the selects of the
// segment's constants, the window's loads and its stores share the
// warp's one issue slot per cycle with the chain.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kProbBits = 14;
constexpr uint32_t kM = 1u << kProbBits;
constexpr uint32_t kStateLo = 1u << 16;
constexpr int kThreads = 32;
constexpr int kWindow = 16;     // steps of bits prefetched ahead
constexpr int kTableCols = 6;

// Constants of one probability segment, for both bit values.
struct Segment {
  uint32_t thr0, thr1;          // renormalise when x >= f << 18
  uint32_t mh0, ml0, mh1, ml1;  // ceil(2^63 / f) as (hi, lo) 32-bit halves
  uint32_t f0, f1;

  __device__ __forceinline__ void set(uint32_t p1) {
    f1 = p1;
    f0 = kM - p1;
    thr0 = f0 << (32 - kProbBits);
    thr1 = f1 << (32 - kProbBits);
    unsigned long long m0 = 0x7FFFFFFFFFFFFFFFull / f0 + 1;
    unsigned long long m1 = 0x7FFFFFFFFFFFFFFFull / f1 + 1;
    mh0 = (uint32_t)(m0 >> 32);
    ml0 = (uint32_t)m0;
    mh1 = (uint32_t)(m1 >> 32);
    ml1 = (uint32_t)m1;
  }
};

// The lane's walk over its segments: step s codes with the segment
// holding it; segments are non-empty, so a step crosses at most one
// boundary, and the next segment is always loaded one segment ahead.
struct Walk {
  const int2* sg;
  int k, lo;                    // current segment and its first step
  int2 prev;                    // segment k - 1 (first step, f1)
  Segment p;

  __device__ __forceinline__ void at(int s) {
    if (__builtin_expect(s < lo, 0)) {
      --k;
      lo = prev.x;
      if ((uint32_t)prev.y != p.f1) p.set((uint32_t)prev.y);
      prev = k > 0 ? sg[k - 1] : make_int2(-1, 0);
    }
  }
};

// Code steps t, t-1, ..., t-n+1 with their bits in cur[0..n).  kWalk:
// the window may cross into earlier segments, so each step checks its
// segment; a window inside one segment (all but ~1 in 16) runs with no
// branch between its steps.  The states before each step and the renorm
// flags are stored after the window, off the chain.
template <bool kPartial, bool kWalk>
__device__ __forceinline__ void code_window(uint32_t& x, Walk& walk,
                                            const uint32_t (&cur)[kWindow],
                                            int t, int n, int lanes,
                                            uint16_t* __restrict__ w,
                                            uint8_t* __restrict__ ov) {
  uint32_t xs[kWindow];
  uint32_t flags = 0;
#pragma unroll
  for (int i = 0; i < kWindow; ++i) {
    if (kPartial && i >= n) break;
    if (kWalk) walk.at(t - i);
    const Segment& p = walk.p;
    bool one = cur[i] != 0u;
    uint32_t thr = one ? p.thr1 : p.thr0;
    uint32_t mh = one ? p.mh1 : p.mh0;
    uint32_t ml = one ? p.ml1 : p.ml0;
    uint32_t g = one ? p.f0 : p.f1;    // 2^14 - f
    uint32_t c = one ? p.f0 : 0u;
    xs[i] = x;
    bool over = x >= thr;
    flags |= (uint32_t)over << i;
    if (over) x >>= 16;
    uint32_t q = (uint32_t)(((unsigned long long)x * mh + __umulhi(x, ml))
                            >> 31);
    x += c + q * g;
  }
#pragma unroll
  for (int i = 0; i < kWindow; ++i) {
    if (kPartial && i >= n) break;
    long long at = (long long)(t - i) * lanes;
    w[at] = (uint16_t)xs[i];
    ov[at] = (uint8_t)((flags >> i) & 1u);
  }
}

__global__ void __launch_bounds__(kThreads)
rans_step_kernel(const uint8_t* __restrict__ bits,
                 const int2* __restrict__ segs,
                 const long long* __restrict__ table,
                 uint32_t* __restrict__ states,
                 uint8_t* __restrict__ overflow,
                 uint16_t* __restrict__ words) {
  const long long* row = table + (long long)blockIdx.y * kTableCols;
  const int lanes = (int)row[5];
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= lanes) return;
  const long long mat = row[0] + lane;
  const uint8_t* b = bits + mat;
  uint8_t* ov = overflow + mat;
  uint16_t* w = words + mat;
  const int steps = (int)row[4];

  Walk walk;
  walk.sg = segs + row[1];
  walk.k = (int)row[2] - 1;
  int2 seg = walk.sg[walk.k];
  walk.lo = seg.x;
  walk.prev = walk.k > 0 ? walk.sg[walk.k - 1] : make_int2(-1, 0);
  walk.p.set((uint32_t)seg.y);

  // the top window takes the steps % kWindow odd steps, so every later
  // window is full and needs no per-step bound check
  uint32_t x = kStateLo;
  uint32_t cur[kWindow];
  int t = steps - 1;
  int n = steps % kWindow;
  if (n) {
#pragma unroll
    for (int i = 0; i < kWindow; ++i)
      cur[i] = i < n ? __ldg(b + (long long)(t - i) * lanes) : 0u;
    code_window<true, true>(x, walk, cur, t, n, lanes, w, ov);
    t -= n;
  }
#pragma unroll
  for (int i = 0; i < kWindow; ++i)
    cur[i] = t - i >= 0 ? __ldg(b + (long long)(t - i) * lanes) : 0u;
  for (; t >= 0; t -= kWindow) {
    uint32_t nxt[kWindow];
#pragma unroll
    for (int i = 0; i < kWindow; ++i) {
      int s = t - kWindow - i;
      nxt[i] = s >= 0 ? __ldg(b + (long long)s * lanes) : 0u;
    }
    if (t - (kWindow - 1) >= walk.lo)
      code_window<false, false>(x, walk, cur, t, kWindow, lanes, w, ov);
    else
      code_window<false, true>(x, walk, cur, t, kWindow, lanes, w, ov);
#pragma unroll
    for (int i = 0; i < kWindow; ++i) cur[i] = nxt[i];
  }
  states[row[3] + lane] = x;
}

}  // namespace

extern "C" int repro_rans_step(const void* bits, const void* segs,
                               const void* table, int n_streams,
                               int max_lanes, void* states, void* overflow,
                               void* words, void* stream) {
  if (n_streams <= 0 || n_streams > 65535 || max_lanes <= 0)
    return (int)cudaErrorInvalidValue;
  dim3 grid((max_lanes + kThreads - 1) / kThreads, n_streams);
  rans_step_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)bits, (const int2*)segs, (const long long*)table,
      (uint32_t*)states, (uint8_t*)overflow, (uint16_t*)words);
  return (int)cudaGetLastError();
}
