#!/usr/bin/env python3
"""Time design variants of the per-tensor ECSQ quantizer (#7) on one card.

    python3 tools/ecsq_variants.py

The port ships one design in ``src/repro_torch/csrc/ecsq_assign.cu``;
this script builds that source once per variant (text substitutions of
the shipped source, ``common.cuh`` included as it is), all in parallel,
and times each through its C entry with CUDA events over back-to-back
calls on the serving paths' (4, 1, 4096) decode and (4, 64, 4096)
prefill boundaries in bfloat16, N = 4: indices and reconstruction,
indices alone, with the histogram ((e)'s stage), with it and no
reconstruction, and packed to 2 bits with the histogram ((n)'s stage).
Variants:

* "shipped": the whole table (63 + 64 floats) passed by value in the
  kernel's parameters and read from the constant bank, the C entry
  copying it from host memory;
* "device table": the same table in device memory (uploaded once), each
  thread loading it into registers beside its first loads of x;
* "empty": the shipped grids returning at once (a diagnostic).

Beside them, in the same process, the parent commit's stages: its #7
kernel (one element a thread, the table staged in shared memory behind
a barrier; its source is kept below), then the index histogram (#4) for
(e), and #4 and the pack (#9) for (n), both through the shipped library;
and ``torch.bucketize`` on a float32 copy (indices only).  Every result
but the diagnostic's must equal the plain version's.  Prints the times
with the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

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

N_LEVELS, LO, HI = 4, -2.2, 2.9
DIAG = ("empty",)

# the parent commit's #7 (7a3ac07, csrc/ecsq_assign.cu), renamed
PARENT = r'''
#include "common.cuh"
namespace {
template <typename T>
__global__ void parent_kernel(const T* __restrict__ x, unsigned n, float lo,
                              float hi, const float* __restrict__ thr,
                              const float* __restrict__ lvl, int n_levels,
                              int* __restrict__ idx, T* __restrict__ deq) {
  __shared__ float s_thr[64], s_lvl[64];
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
    if (deq != nullptr) deq[i] = repro::from_f32<T>(s_lvl[q]);
  }
}
}  // namespace
extern "C" int parent_ecsq_assign(const void* x, int dtype, int n, float lo,
                                  float hi, const void* thr, const void* lvl,
                                  int n_levels, void* idx, void* deq,
                                  void* stream) {
  int want = (n + 255) / 256;
  int blocks = want < 132 * 16 ? want : 132 * 16;
  cudaStream_t s = (cudaStream_t)stream;
  REPRO_DISPATCH_FLOAT(dtype, T,
      parent_kernel<T><<<blocks, 256, 0, s>>>(
          (const T*)x, (unsigned)n, lo, hi, (const float*)thr,
          (const float*)lvl, n_levels, (int*)idx, (T*)deq));
  return (int)cudaGetLastError();
}
'''

# "device table": (anchor, replacement, occurrences)
DEVICE_TABLE = [
    ("const __grid_constant__ EcsqTable tab,",
     "const EcsqTable* __restrict__ tabp,", 2),
    ("  using Q = typename repro::Quad<T>::type;\n",
     "  using Q = typename repro::Quad<T>::type;\n"
     "  const EcsqTable& tab = *tabp;\n", 2),
    ("const EcsqTable& tab, int n_levels,", "const EcsqTable* tab, int n_levels,",
     2),
    ("  const EcsqTable tab = host_table(thr, lvl, n_levels);\n",
     "  const EcsqTable* tab = static_cast<const EcsqTable*>(thr);\n", 2),
]
EMPTY = [
    ("  repro::cluster_start(cluster);\n"
     "  const unsigned nl = (unsigned)n_levels;\n"
     "  const long long lane = threadIdx.x & 31;\n"
     "  const long long stride = (long long)gridDim.x * blockDim.x;\n"
     "  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;\n"
     "  const long long n_",
     "  if (n > 0) return;\n"
     "  repro::cluster_start(cluster);\n"
     "  const unsigned nl = (unsigned)n_levels;\n"
     "  const long long lane = threadIdx.x & 31;\n"
     "  const long long stride = (long long)gridDim.x * blockDim.x;\n"
     "  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;\n"
     "  const long long n_", 2),
]


def substitute(src: str, subs) -> str:
    for old, new, count in subs:
        if src.count(old) != count:
            raise RuntimeError(f"substitution anchor found {src.count(old)} "
                               f"times, not {count}: {old!r}")
        src = src.replace(old, new)
    return src


def variants() -> dict[str, str]:
    shipped = (ROOT / "src/repro_torch/csrc/ecsq_assign.cu").read_text()
    return {"shipped": shipped,
            "device table": substitute(shipped, DEVICE_TABLE),
            "empty": substitute(shipped, EMPTY), "parent": PARENT}


def bind(lib: Path):
    from repro_torch.kernels import _build
    cdll = ctypes.CDLL(str(lib))
    sigs = dict(_build._SIGNATURES)
    p_, i_, f_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    sigs["parent_ecsq_assign"] = (p_, i_, i_, f_, f_, p_, p_, i_, p_, p_, p_)
    for name, argtypes in sigs.items():
        fn = getattr(cdll, name, None)
        if fn is not None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return cdll


def main() -> int:
    if not torch.cuda.is_available():
        print("ecsq_variants: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import ecsq_assign as ea
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    work = _build.BUILD_ROOT / "ecsq_variants"
    work.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    srcs = variants()
    with ThreadPoolExecutor(max_workers=4) as pool:
        futs = {v: pool.submit(build, v.replace(" ", "_"), src, work, nvcc,
                               _build.NVCC_FLAGS)
                for v, src in srcs.items()}
        libs = {v: bind(f.result()[0]) for v, f in futs.items()}
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    thr_h = torch.tensor([-0.95, 0.15, 1.25], dtype=torch.float32)
    lvl_h = torch.tensor([-1.7, -0.45, 0.8, 2.1], dtype=torch.float32)
    thr, lvl = thr_h.to(dev), lvl_h.to(dev)
    # the "device table" variant's EcsqTable: 63 thresholds (NaN past
    # N - 1), then 64 levels (0 past N)
    dtab = torch.cat([thr_h, torch.full((64 - N_LEVELS,), float("nan")),
                      lvl_h, torch.zeros(64 - N_LEVELS)]).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}
    for size, t in (("decode", 1), ("prefill", 64)):
        x = (torch.randn(4, t, 4096, device=dev, generator=gen) * 1.3
             + 0.1).to(torch.bfloat16)
        n = x.numel()
        pi, pd, ph = ea.ecsq_assign_plain(x, thr_h, lvl_h, LO, HI,
                                          want_hist=True)
        pp, _ = ea.ecsq_assign_pack_plain(x, thr_h, lvl_h, LO, HI, 2)
        idx = torch.empty(x.shape, dtype=torch.int32, device=dev)
        deq = torch.empty_like(x)
        hist = torch.empty_like(ph)
        packed = torch.empty_like(pp)
        rows = _build.hist_rows(n, dev)
        ticket = _build.hist_ticket(dev)
        code = _build.DTYPE_CODES[x.dtype]

        def call(lib, tables, want_deq, want_hist, bits=0):
            t_ptr, l_ptr = (a.data_ptr() for a in tables)
            if bits:
                return lambda: lib.repro_ecsq_assign_pack(
                    x.data_ptr(), code, n, LO, HI, t_ptr, l_ptr, N_LEVELS,
                    bits, packed.data_ptr(), hist.data_ptr(),
                    rows.data_ptr(), rows.shape[0], ticket.data_ptr(),
                    stream())
            return lambda: lib.repro_ecsq_assign(
                x.data_ptr(), code, n, LO, HI, t_ptr, l_ptr, N_LEVELS,
                idx.data_ptr(), deq.data_ptr() if want_deq else None,
                hist.data_ptr() if want_hist else None, rows.data_ptr(),
                rows.shape[0], ticket.data_ptr() if want_hist else None,
                stream())

        cases = {"idx+deq": (True, False, 0, lambda: torch.equal(idx, pi)
                             and torch.equal(deq, pd)),
                 "idx": (False, False, 0, lambda: torch.equal(idx, pi)),
                 "(e) idx+deq+hist": (True, True, 0,
                                      lambda: torch.equal(idx, pi)
                                      and torch.equal(deq, pd)
                                      and torch.equal(hist, ph)),
                 "idx+hist": (False, True, 0, lambda: torch.equal(idx, pi)
                              and torch.equal(hist, ph)),
                 "(n) pack2+hist": (False, True, 2,
                                    lambda: torch.equal(packed, pp)
                                    and torch.equal(hist, ph))}
        for case, (want_deq, want_hist, bits, exact) in cases.items():
            for variant in ("shipped", "device table", "empty"):
                tables = (dtab, dtab) if variant == "device table" \
                    else (thr_h, lvl_h)
                fn = call(libs[variant], tables, want_deq, want_hist, bits)
                for t_ in (idx, deq, hist, packed):
                    t_.zero_()
                if fn() != 0:
                    raise RuntimeError(f"{case} {variant}: launch failed")
                torch.cuda.synchronize()
                if variant not in DIAG and not exact():
                    raise AssertionError(f"{case} {variant} {size}: differs "
                                         "from the plain version")
                ms = time_ms(fn)
                results[f"{case} {variant} {size}"] = ms
                print(f"{case:18s} {variant:12s} {size:8s} {ms:.4f} ms",
                      flush=True)
        # the parent's stages: its #7, then the shipped #4 and #9
        plib = libs["parent"]

        def parent7(want_deq):
            return lambda: plib.parent_ecsq_assign(
                x.data_ptr(), code, n, LO, HI, thr.data_ptr(),
                lvl.data_ptr(), N_LEVELS, idx.data_ptr(),
                deq.data_ptr() if want_deq else None, stream())

        p_deq, p_idx = parent7(True), parent7(False)
        p_deq()
        torch.cuda.synchronize()
        if not (torch.equal(idx, pi) and torch.equal(deq, pd)):
            raise AssertionError(f"parent #7 {size}: differs from the plain "
                                 "version")
        xf = x.float()
        parent = {
            "parent #7 idx+deq": p_deq,
            "parent (e) #7 + #4": lambda: (
                p_deq(), ops.index_histogram(idx, n_levels=N_LEVELS)),
            "parent (n) #7 idx + #4 + #9": lambda: (
                p_idx(), ops.index_histogram(idx, n_levels=N_LEVELS),
                ops.pack_indices(idx, bits=2)),
            "torch.bucketize": lambda: torch.bucketize(xf, thr, right=True)}
        for case, fn in parent.items():
            ms = time_ms(fn)
            results[f"{case} {size}"] = ms
            print(f"{case:28s} {size:8s} {ms:.4f} ms", flush=True)
    print(smi)
    print(json.dumps({"nvidia_smi": smi, "ms": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
