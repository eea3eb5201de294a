#!/usr/bin/env python3
"""Time the two routes of the index histogram (#4) and of the per-tensor
quantizer's histogram variant (#1) on one card, to place their crossover.

    python3 tools/hist_crossover.py

Up to ``kOneBlockMax`` values both kernels run one block of 256 threads
that stores the bins itself; up to eight blocks' worth, a cluster of
eight blocks that reduce through block 0's shared memory; above that, up
to two blocks per SM that store partial rows, the last of which (an
atomic ticket) sums them.  The script builds ``csrc/rate_hist.cu`` and
``csrc/fused_clip_quant.cu`` once per variant, each with
``csrc/common.cuh`` inlined and changed by text substitution:
"shipped"; "one block" (every size in one block); "cluster" (no
one-block route); "ticket" (neither the one-block nor the cluster
route); "fenced" (the ticket route with a full fence, ``__threadfence``,
on each side of a relaxed ticket in place of one acquire-release
atomic); "cap x1" and "cap x4" (the many-block grid capped at one or
four blocks per SM, not two); "loads x2" (twice the loads a thread and
iteration: eight 16-byte vectors of indices for #4, not four; four
groups of four values for #1, not two); "threads x4" (blocks of 1,024
threads, not 256).  Diagnostics, outputs not checked: "diag rows" (the
ticket route storing its rows and stopping: no ticket, no merge), "diag
loop" (the counting loop alone, no block reduction), "empty" (the
shipped grid returning at once: the launch floor).  It times each, CUDA events over back-to-back
calls of the C entry, and reads each kernel's own duration from
``torch.profiler`` (the time it held the card, launch gaps excluded), at
sizes from 2,048 to 1,048,576 values: #4 on int32 indices at N = 4 and
N = 16, #1 on bfloat16 input at N = 4 with indices, reconstruction and
histogram.  Every result but the diagnostics'
must equal the plain version's.  Prints the times, the shipped crossover
and the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))
from _variants import build, time_ms  # noqa: E402

SHIPPED = re.compile(r"constexpr long long kOneBlockMax = (\d+);")
SH = "  __shared__ int sh[kHistWidth];                 // the match path's bins\n"
SIZES = [2048, 4096, 8192, 16384, 65536, 262144, 1048576]
CAP = "  long long b = want < 2LL * sms ? want : 2LL * sms;\n"
# the loads of a thread and iteration: vectors (#4) or groups of four (#1)
LOADS = re.compile(r"for \(int h = 0; h < (\d); \+\+h\)")
STEP = re.compile(r"([vg]) \+= (\d) \* stride")
PER = re.compile(r"constexpr int kPerIter = (\d+);")
CLUSTER = "  if (want <= kClusterBlocks) return {kClusterBlocks, true};\n"
TICKET = """      if (lane == 0) {
        cuda::atomic_ref<unsigned, cuda::thread_scope_device> t(*ticket);
        s_last = t.fetch_add(1u, cuda::memory_order_acq_rel) ==
                 gridDim.x - 1;
      }
"""
LAST = "  if (!s_last) return;\n"
FENCED = """      __threadfence();
      if (lane == 0) s_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
"""
THREADS = re.compile(r"constexpr int (kHistThreads|kThreads) = 256;")
STORE = re.compile(r"repro::store_histogram<MODE == kMatch>\([^;]*;", re.S)
KINDS = ("shipped", "one block", "cluster", "ticket", "fenced", "cap x1",
         "cap x4", "loads x2", "threads x4", "diag rows", "diag loop",
         "empty")
DIAG = ("diag rows", "diag loop", "empty")     # outputs not checked


def variants(src: str, common: str) -> dict[str, str]:
    """The kernel's source with common.cuh inlined, per variant."""
    assert SHIPPED.search(src) and SH in src and TICKET in common \
        and LAST in common and CLUSTER in common, \
        "shipped source changed: update the substitution"
    inl = src.replace('#include "common.cuh"', common)

    def one_block_max(text, v):
        return SHIPPED.sub(f"constexpr long long kOneBlockMax = {v};", text)

    ticket = one_block_max(inl, 0).replace(CLUSTER, "")
    assert CAP in common and LOADS.search(src) and STEP.search(src) \
        and PER.search(src) and THREADS.search(src) and STORE.search(src)
    double = PER.sub(lambda m: f"constexpr int kPerIter = "
                     f"{2 * int(m.group(1))};", inl)
    double = LOADS.sub(lambda m: f"for (int h = 0; h < "
                       f"{2 * int(m.group(1))}; ++h)", double)
    double = STEP.sub(lambda m: f"{m.group(1)} += {2 * int(m.group(2))} "
                      "* stride", double)
    return {"shipped": inl,
            "one block": one_block_max(inl, "1LL << 62"),
            "cluster": one_block_max(inl, 0),
            "ticket": ticket,
            # the ticket route with a full fence on each side of a relaxed
            # ticket (__threadfence), the first design
            "fenced": ticket.replace(TICKET, FENCED).replace(
                LAST, LAST + "  __threadfence();\n"),
            # the many-block grid capped at one or four blocks per SM
            "cap x1": inl.replace(CAP, CAP.replace("2LL", "1LL")),
            "cap x4": inl.replace(CAP, CAP.replace("2LL", "4LL")),
            # twice the loads a thread and iteration
            "loads x2": double,
            # blocks of 1,024 threads, not 256
            "threads x4": THREADS.sub(
                lambda m: f"constexpr int {m.group(1)} = 1024;", inl),
            # diagnostics: the ticket route storing its rows and stopping
            # (no ticket, no merge); the counting loop alone
            "diag rows": ticket.replace(TICKET, "").replace(
                LAST, "  return;\n"),
            "diag loop": STORE.sub(
                "if (cnt[0] + cnt[1] == 12345u) rows[0] = 1;", inl),
            "empty": inl.replace(SH, SH + "  if (n >= 0) return;\n")}


def kernel_us(fn, reps: int = 20) -> float:
    """Mean duration of the kernels ``fn`` launches, from the profiler's
    device records (us)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(ev) / max(len(ev), 1)


def main() -> int:
    if not torch.cuda.is_available():
        print("hist_crossover: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build, rate_hist
    from repro_torch.kernels import fused_clip_quant as fcq
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    work = _build.BUILD_ROOT / "hist_crossover"
    work.mkdir(parents=True, exist_ok=True)
    jobs = {}
    with ThreadPoolExecutor(6) as pool:
        common = (_build.CSRC / "common.cuh").read_text()
        for stem in ("rate_hist", "fused_clip_quant"):
            src = (_build.CSRC / f"{stem}.cu").read_text()
            for k, v in variants(src, common).items():
                tag = f"{stem}_{k.replace(' ', '_')}"
                jobs[(stem, k)] = pool.submit(build, tag, v, work,
                                              _build._nvcc(),
                                              _build.NVCC_FLAGS)
        libs = {}
        for (stem, k), f in jobs.items():
            path, regs = f.result()
            lib = ctypes.CDLL(str(path))
            sym = {"rate_hist": "repro_index_histogram",
                   "fused_clip_quant": "repro_clip_quant"}[stem]
            fn = getattr(lib, sym)
            fn.argtypes = _build._SIGNATURES[sym]
            libs[(stem, k)] = fn
            if k == "shipped":
                print(f"ptxas {stem}: " + " | ".join(
                    r for r in regs if "histogram_kernel" in r
                    or "clip_quant_kernel" in r))
    s = torch.cuda.current_stream().cuda_stream
    ticket = _build.hist_ticket(dev).data_ptr()    # this stream's word
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for n in SIZES:
        rows = _build.hist_rows(n, dev)
        cap = rows.shape[0]
        for n_levels in (4, 16):
            idx = torch.randint(0, n_levels, (n,), device=dev,
                                generator=gen, dtype=torch.int32)
            want = rate_hist.index_histogram_plain(idx, n_levels)
            case = f"index_histogram N={n_levels}"
            for k in KINDS:
                fn, hist = libs[("rate_hist", k)], torch.empty_like(want)

                def run(fn=fn, hist=hist, idx=idx, nl=n_levels):
                    assert fn(idx.data_ptr(), n, nl, hist.data_ptr(),
                              rows.data_ptr(), cap, ticket, s) == 0
                run()
                torch.cuda.synchronize()
                if k not in DIAG and not torch.equal(hist, want):
                    raise AssertionError(f"{case} {k} n={n} differs")
                out.setdefault(case, {}).setdefault(k, {})[n] = (
                    time_ms(run), kernel_us(run))
        x = (torch.randn(n, device=dev, generator=gen) * 1.3 + 0.1).to(
            torch.bfloat16)
        lo, hi, sc, inv = fcq.range_scalars(-2.2, 2.9, 4)
        pi, pd, ph = fcq.clip_quant_plain(x, -2.2, 2.9, 4, want_hist=True)
        case = "clip_quant +hist bf16 N=4"
        for k in KINDS:
            fn = libs[("fused_clip_quant", k)]
            idx, deq, hist = (torch.empty_like(pi), torch.empty_like(pd),
                              torch.empty_like(ph))

            def run(fn=fn, idx=idx, deq=deq, hist=hist):
                assert fn(x.data_ptr(), 1, n, float(lo), float(hi),
                          float(sc), float(inv), 4, idx.data_ptr(),
                          deq.data_ptr(), hist.data_ptr(), rows.data_ptr(),
                          cap, ticket, s) == 0
            run()
            torch.cuda.synchronize()
            if k not in DIAG and not (torch.equal(idx, pi)
                                     and torch.equal(deq, pd)
                                     and torch.equal(hist, ph)):
                raise AssertionError(f"{case} {k} n={n} differs")
            out.setdefault(case, {}).setdefault(k, {})[n] = (
                time_ms(run), kernel_us(run))
    for case, by in out.items():
        print(f"{case} (ms per call back to back [kernel duration, us]; "
              + " / ".join(KINDS) + "):")
        for n in SIZES:
            print(f"  {n:7d}: " + " / ".join(
                f"{by[k][n][0]:.4f} [{by[k][n][1]:.2f}]" for k in KINDS))
    shipped = SHIPPED.search((_build.CSRC / "rate_hist.cu").read_text())
    print(f"shipped crossover (kOneBlockMax): {shipped.group(1)} values; "
          f"nvidia-smi: {smi}")
    print(json.dumps({"nvidia_smi": smi, "ms": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
