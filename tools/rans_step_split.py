#!/usr/bin/env python3
"""Time design variants of the rANS step loop (kernel #6) on one card.

    python3 tools/rans_step_split.py [--out DIR]

The port ships one design of ``src/repro_torch/csrc/rans_coder.cu`` and
no switch; this script makes the variants by text substitution of that
source, builds each into its own library under ``build/``, and times
them in one process on the same inputs:

  shipped      bits prefetched a window ahead, reciprocal multiply
  hw_divide    the same with the hardware 32-bit divide kept
  stores_in_chain  the shipped kernel storing each step's word and flag
               as it codes the step, not after its window
  window8/32   the shipped kernel with an 8- or 32-step prefetch window
  threads64/128  the shipped kernel with 64 or 128 threads per block
  previous     the previous design: one stream per launch, each step
               loads its bit and its probability on the chain and
               divides in hardware (the 16 chunks launch back to back)

Inputs: the prefill boundary's 1,048,576 indices (a seeded (4, 64, 4096)
activation quantized to N=4) in 16 chunks of 65,536, coded in one launch
(the main path's batch), and its first chunk alone.  Every variant's
states, flags and words must equal the shipped kernel's.  Prints each
kernel's ``-Xptxas -v`` line, the card's name, power limit and SM
clocks, and writes the shipped kernel's SASS to ``<out>/rans_step.sass``.
The chain bound of ``chip_smoke.py`` does not come from here: that
script measures the step's least dependent chain in its own run
(``tools/rans_chain_probe.cu``).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))
from _variants import build, time_ms  # noqa: E402

RECIP = ("    uint32_t q = (uint32_t)(((unsigned long long)x * mh + "
         "__umulhi(x, ml))\n                            >> 31);\n")
STATE = "    xs[i] = x;\n"
STORES = ("    w[at] = (uint16_t)xs[i];\n"
          "    ov[at] = (uint8_t)((flags >> i) & 1u);\n")
PREVIOUS = r'''
#include <cstdint>
#include <cuda_runtime.h>
namespace {
constexpr uint32_t kM = 1u << 14;
__global__ void previous_kernel(const uint8_t* __restrict__ bits,
                            const int* __restrict__ f1_steps,
                            int total_steps, int lanes,
                            uint32_t* __restrict__ states,
                            uint8_t* __restrict__ overflow,
                            uint16_t* __restrict__ words) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  uint32_t x = 1u << 16;
  for (int t = total_steps - 1; t >= 0; --t) {
    uint32_t f1 = (uint32_t)f1_steps[t];
    uint32_t f0 = kM - f1;
    long long at = (long long)t * lanes + lane;
    uint32_t b = bits[at];
    uint32_t f = b ? f1 : f0;
    bool over = x >= (f << 18);
    words[at] = (uint16_t)(x & 0xFFFFu);
    overflow[at] = over;
    if (over) x >>= 16;
    uint32_t q = x / f;
    x = (q << 14) + (x - q * f) + (b ? f0 : 0u);
  }
  states[lane] = x;
}
}  // namespace
extern "C" int previous_rans_step(const void* bits, const void* f1_steps,
                              int total_steps, int lanes, void* states,
                              void* overflow, void* words, void* stream) {
  previous_kernel<<<(lanes + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)bits, (const int*)f1_steps, total_steps, lanes,
      (uint32_t*)states, (uint8_t*)overflow, (uint16_t*)words);
  return (int)cudaGetLastError();
}
'''


# Dependent-latency microbenchmark: one thread runs a chain of one
# instruction (or of the whole step) and reads clock64 around it.
MICRO = r"""
#include <cstdint>
#define LOOP(...)                                                  \
  t0 = clock64();                                                  \
  _Pragma("unroll 32") for (int i = 0; i < iters; ++i) { __VA_ARGS__; } \
  out[k++] = clock64() - t0;
extern "C" __global__ void micro(const uint32_t* in, long long* out,
                                 uint32_t* sink, int iters) {
  uint32_t x = in[0], a = in[1], b = in[2], thr0 = in[3], thr1 = in[4],
           mh0 = in[5], ml0 = in[6], mh1 = in[7], ml1 = in[8],
           f0 = in[9], f1 = in[10], bits = in[11];
  unsigned long long x64 = in[12];
  long long t0;
  int k = 0;
  LOOP(asm volatile("add.u32 %0, %0, %1;" : "+r"(x) : "r"(a)))
  LOOP(asm volatile("mad.lo.u32 %0, %0, %1, %2;" : "+r"(x) : "r"(a), "r"(b)))
  LOOP(asm volatile("mul.hi.u32 %0, %0, %1;" : "+r"(x) : "r"(a)))
  LOOP(asm volatile("{ .reg .u32 l; cvt.u32.u64 l, %0; "
                    "mad.wide.u32 %0, l, %1, %0; }" : "+l"(x64) : "r"(a)))
  LOOP(asm volatile("shf.r.wrap.b32 %0, %0, %1, 31;" : "+r"(x) : "r"(a)))
  LOOP(asm volatile("{ .reg .pred p; .reg .u32 s; setp.ge.u32 p, %0, %1; "
                    "shr.u32 s, %0, 16; selp.u32 %0, s, %0, p; }"
                    : "+r"(x) : "r"(a)))
  LOOP({
    bool one = (bits >> (i & 31)) & 1u;
    uint32_t thr = one ? thr1 : thr0, mh = one ? mh1 : mh0,
             ml = one ? ml1 : ml0, g = one ? f0 : f1, c = one ? f0 : 0u;
    if (x >= thr) x >>= 16;
    uint32_t q = (uint32_t)(((unsigned long long)x * mh + __umulhi(x, ml))
                            >> 31);
    x += c + q * g;
  })
  sink[0] = x + (uint32_t)x64;
}
"""
MICRO_NAMES = ("IADD3", "IMAD", "IMAD.HI", "IMAD.WIDE", "SHF", "ISETP+SEL",
               "whole step")


def micro(lib_path, dev) -> dict[str, float]:
    """Cycles per dependent instruction (per step for the last)."""
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.micro_launch
    fn.argtypes = (ctypes.c_void_p,) * 3 + (ctypes.c_int, ctypes.c_void_p)
    p1 = 4000
    p0 = (1 << 14) - p1
    m = [-(-(1 << 63) // f) for f in (p0, p1)]
    vals = [70001, 3, 5, p0 << 18, p1 << 18, m[0] >> 32, m[0] & 0xFFFFFFFF,
            m[1] >> 32, m[1] & 0xFFFFFFFF, p0, p1, 0x5A5A1234, 99]
    inp = torch.tensor([v if v < 1 << 31 else v - (1 << 32) for v in vals],
                       dtype=torch.int32, device=dev)
    out = torch.zeros(len(MICRO_NAMES), dtype=torch.int64, device=dev)
    sink = torch.zeros(1, dtype=torch.int32, device=dev)
    iters = 4096
    for _ in range(3):                        # the last call is warm
        assert fn(inp.data_ptr(), out.data_ptr(), sink.data_ptr(), iters,
                  torch.cuda.current_stream().cuda_stream) == 0
    torch.cuda.synchronize()
    return {k: v / iters for k, v in zip(MICRO_NAMES, out.tolist())}


def variants(src: str) -> dict[str, str]:
    assert all(k in src for k in (RECIP, STATE, STORES, "kThreads = 32;",
                                   "kWindow = 16;")), \
        "shipped source changed: update the substitutions"
    return {
        "shipped": src,
        "hw_divide": src.replace(RECIP, "    uint32_t q = x / (one ? p.f1 "
                                 ": p.f0);\n"),
        "stores_in_chain": src.replace(STORES, "").replace(
            STATE, "    { long long at = (long long)(t - i) * lanes;\n"
            "      w[at] = (uint16_t)x; ov[at] = (uint8_t)(x >= thr); }\n"),
        "window8": src.replace("kWindow = 16;", "kWindow = 8;"),
        "window32": src.replace("kWindow = 16;", "kWindow = 32;"),
        "threads64": src.replace("kThreads = 32;", "kThreads = 64;"),
        "threads128": src.replace("kThreads = 32;", "kThreads = 128;"),
        "previous": PREVIOUS,
        "micro": MICRO + """
extern "C" int micro_launch(const void* in, void* out, void* sink, int iters,
                            void* stream) {
  micro<<<1, 1, 0, (cudaStream_t)stream>>>((const uint32_t*)in,
                                           (long long*)out, (uint32_t*)sink,
                                           iters);
  return (int)cudaGetLastError();
}
""",
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="build/rans_step_split")
    ap.add_argument("--only", nargs="*", help="variants to build and time "
                    "(default: all; the shipped kernel and the latency "
                    "probe always run)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("rans_step_split: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build, ops, rans_coder
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
         "clocks.max.sm", "--format=csv,noheader"], capture_output=True,
        text=True, check=True).stdout.strip().splitlines()[0]
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")

    work = _build.BUILD_ROOT / "split"
    work.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "rans_coder.cu").read_text()
    nvcc = _build._nvcc()
    with ThreadPoolExecutor(8) as pool:
        futs = {k: pool.submit(build, k, v, work, nvcc, _build.NVCC_FLAGS)
                for k, v in variants(src).items()
                if k in ("shipped", "micro") or not args.only
                or k in args.only}
        libs = {k: f.result() for k, f in futs.items()}
    for k, (_, regs) in libs.items():
        print(f"ptxas {k}: " + " | ".join(r.split(": ", 1)[1] for r in regs))
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    sass = subprocess.run([str(Path(nvcc).parent / "cuobjdump"), "-sass",
                           str(libs["shipped"][0])], capture_output=True,
                          text=True, check=True).stdout
    (out / "rans_step.sass").write_text(sass)
    print(f"SASS of the shipped kernel: {out / 'rans_step.sass'} "
          f"({len(sass.splitlines())} lines)")

    gen = torch.Generator(device=dev).manual_seed(0)
    x = (torch.randn(4, 64, 4096, device=dev, generator=gen) * 1.3
         + 0.1).to(torch.bfloat16).float()
    coded = ops.clip_quantize(x.reshape(-1), cmin=-2.2, cmax=2.9,
                              n_levels=4)[0]
    batches = {"prefill 16 chunks": rans_coder._plane_batch(
                   coded, [1 << 16] * 16, 4),
               "one chunk": rans_coder._plane_batch(coded[:1 << 16],
                                                    [1 << 16], 4)}
    s = torch.cuda.current_stream().cuda_stream
    P, I = ctypes.c_void_p, ctypes.c_int
    rows = {}
    for bname, bt in batches.items():
        lay = bt.lay
        n_st, cells, ml = sum(lay.lanes), lay.n_cells, max(lay.lanes)
        steps = int(bt.table[:, 4].max())
        res = {}
        for k, (path, _) in libs.items():
            if k == "micro":
                continue
            lib = ctypes.CDLL(str(path))
            st = torch.empty(n_st, dtype=torch.int32, device=dev)
            ov = torch.empty(cells, dtype=torch.uint8, device=dev)
            w = torch.empty(cells, dtype=torch.int16, device=dev)
            if k == "previous":
                fn = lib.previous_rans_step
                fn.argtypes = (P, P, I, I, P, P, P, P)
                calls = []
                for mat, s0, ns, so, stp, ln in bt.table.tolist():
                    sg = bt.segs[s0:s0 + ns].long()
                    ends = torch.cat([sg[1:, 0], torch.tensor(
                        [stp], device=dev)])
                    f1 = torch.repeat_interleave(
                        sg[:, 1], ends - sg[:, 0]).int()
                    calls.append((bt.bits[mat:].data_ptr(), f1, stp, ln,
                                  st[so:].data_ptr(), ov[mat:].data_ptr(),
                                  w[mat:].data_ptr()))

                def run(fn=fn, calls=calls):
                    for b_, f1, stp, ln, st_, ov_, w_ in calls:
                        assert fn(b_, f1.data_ptr(), stp, ln, st_, ov_, w_,
                                  s) == 0
            else:
                fn = lib.repro_rans_step
                fn.argtypes = (P, P, P, I, I, P, P, P, P)

                def run(fn=fn, st=st, ov=ov, w=w):
                    assert fn(bt.bits.data_ptr(), bt.segs.data_ptr(),
                              bt.table.data_ptr(), bt.table.shape[0], ml,
                              st.data_ptr(), ov.data_ptr(), w.data_ptr(),
                              s) == 0
            run()
            torch.cuda.synchronize()
            res[k] = (time_ms(run), st, ov, w)
        ref = res["shipped"]
        for k, (ms, st, ov, w) in res.items():
            if not (torch.equal(st, ref[1]) and torch.equal(ov, ref[2])
                    and torch.equal(w, ref[3])):
                raise AssertionError(f"{k} differs from the shipped kernel "
                                     f"on {bname}")
        print(f"{bname}: {len(lay.lanes)} streams, lanes "
              f"{sorted(set(lay.lanes))}, {steps} steps (longest stream); "
              "all variants equal")
        for k, (ms, *_) in res.items():
            print(f"  {k:11s} {ms:.4f} ms  {ms * 1e6 / steps:.1f} ns per "
                  "step")
        rows[bname] = {k: v[0] for k, v in res.items()} | {"steps": steps}
    lat = micro(libs["micro"][0], dev)
    print("dependent latency, cycles: " + ", ".join(
        f"{k} {v:.1f}" for k, v in lat.items()))
    # the SM clock the kernels ran at: a spin of known cycles, timed
    cyc = int(2e7)
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    torch.cuda._sleep(cyc)
    b.record()
    torch.cuda.synchronize()
    mhz = cyc / (a.elapsed_time(b) * 1e3)
    print(f"SM clock under the spin: {mhz:.0f} MHz; per step at that "
          "clock: " + ", ".join(
              f"{k} {v * mhz * 1e3 / rows['one chunk']['steps']:.0f}"
              for k, v in rows["one chunk"].items() if k != "steps")
          + " cycles (one chunk)")
    print(json.dumps({"rans_step_split": rows, "nvidia_smi": smi,
                      "spin_mhz": mhz, "latency_cycles": lat}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
