#!/usr/bin/env python3
"""Time design variants of the fast route of the per-tile quantizer (#2)
and of the per-tile ECSQ quantizer (#8) on one card.

    python3 tools/tiles_fast_variants.py

The port ships one design of each in ``src/repro_torch/csrc``; this
script builds ``fused_clip_quant.cu`` and ``ecsq_assign.cu`` once per
variant (text substitutions of the shipped source, ``common.cuh``
included as it is), all in parallel, and times each through its C entry
with CUDA events over back-to-back calls on the serving paths' (4, 1,
4096) decode and (4, 64, 4096) prefill boundaries in bfloat16 under the
g=8 channel plan, N = 4: #2 with indices and reconstruction, with the
per-tile counts too ((c)'s stage), and packed to 2 bits with the counts
((l)'s stage); #8 with indices and reconstruction, and in coded order
((f)'s stage).  Variants:

* #2: "shipped"; "batch 2/8" (2 or 8 units' loads issued together, not
  4, so a tile's rows take more blocks sooner or later); "split 1" (a
  tile's rows in one block, never a cluster); "cols 2" (blocks at least
  2 unit columns wide, not 8); "rows 1" (a thread takes 1 unit down its
  column without counts, not 2); "empty" (the shipped grid returning at
  once);
* #8: "shipped"; "wide" (no narrowing of the blocks when the grid would
  leave SMs without one); "empty".

Beside them, in the same process, the parent's kernels for the same
stages: #2's and #8's element route (the shipped library's
``repro_clip_quant_tiles`` / ``repro_ecsq_assign_tiles``, which the
parent commit ran for every plan), then the tile histogram (#5) and the
pack (#9).  Every result but the diagnostics' must equal the plain
version's.  Prints the times with the card's name and power limit, then
one JSON line.
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

N_LEVELS, GROUP = 4, 8
ROWS = "constexpr int kRowsPerThread = 2;"
BATCH = "constexpr int kBatch = 4;"
SPLIT = "constexpr int kSplit = 8;"
COLS = "constexpr int kLogMinColumns = 3;"
Q_ENTRY = "  extern __shared__ int sh[];          // a row of bins a tile of the block\n"
E_NARROW = "  while (((g.units + (1LL << g.luw) - 1) >> g.luw) * nbr < sms &&"
E_ENTRY = "  const int uw = 1 << g.luw, rb = 1 << g.lrb;\n  const long long bu = blockIdx.x % g.nbu"
DIAG = ("empty",)
# #2's variants: substitutions of its constants, alone and together
QUANT = {"shipped": {},
         "batch 2": {BATCH: "4;2;"}, "batch 8": {BATCH: "4;8;"},
         "split 1": {SPLIT: "8;1;"},
         "cols 2": {COLS: "3;1;"}, "rows 1": {ROWS: "2;1;"}}


def variants() -> dict[str, dict[str, str]]:
    """{kernel: {variant: source}} by text substitution; each substitution
    is checked against the shipped source first."""
    csrc = ROOT / "src/repro_torch/csrc"
    quant = (csrc / "fused_clip_quant.cu").read_text()
    ecsq = (csrc / "ecsq_assign.cu").read_text()
    for src, old in ((quant, ROWS), (quant, BATCH), (quant, SPLIT),
                     (quant, COLS), (quant, Q_ENTRY), (ecsq, E_NARROW),
                     (ecsq, E_ENTRY)):
        if src.count(old) != 1:
            raise RuntimeError(f"substitution anchor not unique: {old!r}")
    out = {"quant": {}, "ecsq": {
        "shipped": ecsq,
        "wide": ecsq.replace(E_NARROW, "  while (false &&"),
        "empty": ecsq.replace(E_ENTRY, "  if (g.rows > 0) return;\n"
                              + E_ENTRY)}}
    for name, subs in QUANT.items():
        src = quant
        for anchor, swap in subs.items():
            old, new = swap.split(";")[:2]
            src = src.replace(anchor, anchor.replace(old + ";", new + ";"))
        out["quant"][name] = src
    out["quant"]["empty"] = quant.replace(
        Q_ENTRY, Q_ENTRY + "  if (g.rows > 0) return;\n")
    return out


def bind(lib: Path):
    from repro_torch.kernels import _build
    cdll = ctypes.CDLL(str(lib))
    for name, argtypes in _build._SIGNATURES.items():
        fn = getattr(cdll, name, None)
        if fn is not None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return cdll


def main() -> int:
    if not torch.cuda.is_available():
        print("tiles_fast_variants: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core.backend import QuantSpec, _coded_order_device
    from repro_torch.core.tiling import TilePlan
    from repro_torch.kernels import _build, ecsq_assign as ea, ops
    from repro_torch.kernels import fused_clip_quant as fcq, rate_hist
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    work = _build.BUILD_ROOT / "tiles_fast_variants"
    work.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    srcs = variants()
    with ThreadPoolExecutor(max_workers=8) as pool:
        futs = {(k, v): pool.submit(build, f"{k}_{v.replace(' ', '_')}",
                                    src, work, nvcc, _build.NVCC_FLAGS)
                for k, vs in srcs.items() for v, src in vs.items()}
        libs = {key: bind(f.result()[0]) for key, f in futs.items()}
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    plan = TilePlan(channel_axis=-1, channel_group_size=GROUP,
                    spatial_block_size=0, n_channels=4096)
    gen = torch.Generator(device=dev).manual_seed(0)
    lo = torch.rand(plan.n_cgroups, 1, device=dev, generator=gen) - 2.6
    hi = torch.rand(plan.n_cgroups, 1, device=dev, generator=gen) + 2.5
    u = torch.sort(torch.rand(plan.n_cgroups, 1, N_LEVELS - 2, device=dev,
                              generator=gen), -1).values
    lvl = torch.cat([lo[..., None], lo[..., None] + (hi - lo)[..., None] * u,
                     hi[..., None]], -1).contiguous()
    thr = ((lvl[..., 1:] + lvl[..., :-1]) / 2).contiguous()
    results = {}
    for size, t in (("decode", 1), ("prefill", 64)):
        x = (torch.randn(4, t, 4096, device=dev, generator=gen) * 1.3
             + 0.1).to(torch.bfloat16)
        n, rows = x.numel(), x.numel() // 4096
        maps = fcq.tile_maps(plan, x.shape, dev)
        pi, pd, ph = fcq.clip_quant_tiles_plain(x, lo, hi, N_LEVELS, maps,
                                                want_hist=True)
        pp, _ = fcq.clip_quant_tiles_pack_plain(x, lo, hi, N_LEVELS, maps,
                                                2)
        ei, ed = ea.ecsq_assign_tiles_plain(x, lo, hi, thr, lvl, maps)
        ec = ea.ecsq_assign_tiles_coded_plain(x, lo, hi, thr, lvl, maps)
        idx = torch.empty(x.shape, dtype=torch.int32, device=dev)
        deq = torch.empty_like(x)
        hist = torch.empty_like(ph)
        packed = torch.empty_like(pp)
        coded = torch.empty_like(ec)
        code = _build.DTYPE_CODES[x.dtype]

        def quant(lib, bits, want_hist, deq_out=True):
            return lambda: lib.repro_clip_quant_tiles_fast(
                x.data_ptr(), code, rows, 4096, GROUP, lo.data_ptr(),
                hi.data_ptr(), N_LEVELS, bits,
                idx.data_ptr() if bits == 0 else None,
                deq.data_ptr() if bits == 0 and deq_out else None,
                packed.data_ptr() if bits else None,
                hist.data_ptr() if want_hist else None, stream())

        def ecsq(lib, is_coded):
            return lambda: lib.repro_ecsq_assign_tiles_fast(
                x.data_ptr(), code, rows, 4096, GROUP, lo.data_ptr(),
                hi.data_ptr(), thr.data_ptr(), lvl.data_ptr(), N_LEVELS,
                (coded if is_coded else idx).data_ptr(),
                None if is_coded else deq.data_ptr(), int(is_coded),
                stream())

        cases = {"#2 idx+deq": ("quant", lambda lib: quant(lib, 0, False),
                                lambda: torch.equal(idx, pi)
                                and torch.equal(deq, pd)),
                 "#2 idx+deq+hist": ("quant",
                                     lambda lib: quant(lib, 0, True),
                                     lambda: torch.equal(idx, pi)
                                     and torch.equal(deq, pd)
                                     and torch.equal(hist, ph)),
                 "#2 pack2+hist": ("quant", lambda lib: quant(lib, 2, True),
                                   lambda: torch.equal(packed, pp)
                                   and torch.equal(hist, ph)),
                 "#8 idx+deq": ("ecsq", lambda lib: ecsq(lib, False),
                                lambda: torch.equal(idx, ei)
                                and torch.equal(deq, ed)),
                 "#8 coded": ("ecsq", lambda lib: ecsq(lib, True),
                              lambda: torch.equal(coded, ec))}
        for case, (kernel, make, exact) in cases.items():
            for variant in srcs[kernel]:
                fn = make(libs[(kernel, variant)])
                for t_ in (idx, deq, hist, packed, coded):
                    t_.zero_()
                if fn() != 0:
                    raise RuntimeError(f"{case} {variant}: launch failed")
                torch.cuda.synchronize()
                if variant not in DIAG and not exact():
                    raise AssertionError(f"{case} {variant} {size}: differs "
                                         "from the plain version")
                ms = time_ms(lambda: fn())
                results[f"{case} {variant} {size}"] = ms
                print(f"{case:16s} {variant:8s} {size:8s} {ms:.4f} ms",
                      flush=True)
        # the parent's stages, through the shipped library's element
        # routes, #5 and #9
        lib = libs[("quant", "shipped")]

        def elem2():
            lib.repro_clip_quant_tiles(
                x.data_ptr(), code, n, 4096, 1, maps.cgroup.data_ptr(), None,
                1, lo.data_ptr(), hi.data_ptr(), N_LEVELS, idx.data_ptr(),
                deq.data_ptr(), stream())

        elib = libs[("ecsq", "shipped")]

        def elem8():
            elib.repro_ecsq_assign_tiles(
                x.data_ptr(), code, n, 4096, 1, maps.cgroup.data_ptr(), None,
                1, lo.data_ptr(), hi.data_ptr(), thr.data_ptr(),
                lvl.data_ptr(), N_LEVELS, idx.data_ptr(), deq.data_ptr(),
                stream())

        spec = QuantSpec(None, None, N_LEVELS, plan=plan)
        parent = {
            "#2 element idx+deq": elem2,
            "(c) #2 element + #5": lambda: (elem2(),
                                            rate_hist.index_histogram_tiles(
                                                idx, N_LEVELS, plan)),
            "(l) #2 element + #5 + #9": lambda: (
                elem2(), rate_hist.index_histogram_tiles(idx, N_LEVELS,
                                                         plan),
                ops.pack_indices(idx, bits=2)),
            "#8 element idx+deq": elem8,
            "(f) #8 element + coded copy": lambda: (
                elem8(), _coded_order_device(idx, spec))}
        elem2()
        elem8()
        torch.cuda.synchronize()
        for case, fn in parent.items():
            ms = time_ms(fn)
            results[f"parent {case} {size}"] = ms
            print(f"parent {case:26s} {size:8s} {ms:.4f} ms", flush=True)
    print(smi)
    print(json.dumps({"nvidia_smi": smi, "ms": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
