#!/usr/bin/env python3
"""Time design variants of the bit-pack (#9), the tile histogram (#5) and
the per-tensor quantizer's packing variant (#1 +pack) on one card.

    python3 tools/pack_hist_variants.py [--parent CSRC_DIR]

The port ships one design of each in ``src/repro_torch/csrc``; this
script builds ``pack_bits.cu``, ``rate_hist.cu`` and
``fused_clip_quant.cu`` once per variant (text substitutions of the
shipped source, ``common.cuh`` included as it is), all in parallel, and
times each through its C entry with CUDA events over back-to-back calls
at the sizes the serving paths give it: #9 on 16,384 and 1,048,576 int32
indices at 2 bits; #5 on the (4, 1, 4096) decode and (4, 64, 4096)
prefill boundaries under the g=8 channel plan, N = 4; #1 +pack on the
same boundaries in bfloat16, N = 4, 2 bits.  Variants:

* #9: "shipped" (four bytes a thread from 16-byte loads); "one byte"
  (the scalar path for every byte: one byte a thread from scalar loads,
  the kernel's first design); "block 64" (blocks of 64 threads, not 256); "empty"
  (the shipped grid returning at once);
* #5: "shipped"; "batch 4" (four positions' loads at once, not eight);
  "elems 16" and "elems 4" (G sized for 16 or 4 indices a thread, not
  8); "warps 1" and "warps 8" (blocks of one or eight warps on the warp
  route, not four); "empty" (the shipped grid returning at once);
* #1 +pack: "shipped"; "empty".

With ``--parent`` (the ``csrc`` directory of another commit, e.g. of an
unpacked ``git archive``), that commit's ``pack_bits.cu`` and
``rate_hist.cu`` are timed as variant "parent" of #9 and #5, and its
two-launch packed crossing -- ``repro_clip_quant`` with the histogram
and no reconstruction, then ``repro_pack_bits`` -- as "parent" of #1
+pack.  Each parent source is built with its own ``common.cuh`` inlined.

Every result but the diagnostics' ("empty") must equal the plain
version's.  Prints the times with the card's name and power limit, then
one JSON line.
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

PACK_ENTRY = "  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;\n"
PACK_WORDS = "  const long long n_words = vec ? n / (4 * per) : 0;\n"
TILE_ENTRY = "  const int lane = threadIdx.x & 31;\n  int tile, j;\n"
TILE_BATCH = "constexpr int kBatch = 8;"
TILE_ELEMS = "constexpr int kTileElemsPerThread = 8;"
TILE_WARPS = "constexpr int kWarpBlock = 128;"
PACK_THREADS = "constexpr int kThreads = 256;"
QUANT_ENTRY = "  constexpr int UNITS = kPerIter / UV;           // units an iteration\n"
DIAG = ("empty",)


def parent_sources(parent: Path) -> dict[str, str]:
    """The other commit's pack_bits.cu, rate_hist.cu and
    fused_clip_quant.cu, each with that commit's common.cuh inlined."""
    common = (parent / "common.cuh").read_text()
    return {stem: (parent / f"{stem}.cu").read_text().replace(
        '#include "common.cuh"', common)
        for stem in ("pack_bits", "rate_hist", "fused_clip_quant")}


def variants() -> dict[str, dict[str, str]]:
    """{kernel: {variant: source}} by text substitution; each substitution
    is checked against the shipped source first."""
    csrc = ROOT / "src/repro_torch/csrc"
    pack = (csrc / "pack_bits.cu").read_text()
    hist = (csrc / "rate_hist.cu").read_text()
    quant = (csrc / "fused_clip_quant.cu").read_text()
    for src, text in ((pack, PACK_ENTRY), (pack, PACK_WORDS),
                      (hist, TILE_ENTRY), (hist, TILE_BATCH),
                      (hist, TILE_ELEMS), (hist, TILE_WARPS),
                      (pack, PACK_THREADS), (quant, QUANT_ENTRY)):
        assert text in src, f"shipped source changed: update {text!r}"
    return {
        "pack_bits": {
            "shipped": pack,
            "one byte": pack.replace(PACK_WORDS,
                                     "  const long long n_words = 0;\n"),
            "block 64": pack.replace(PACK_THREADS,
                                     "constexpr int kThreads = 64;"),
            "empty": pack.replace(PACK_ENTRY,
                                  PACK_ENTRY + "  if (n >= 0) return;\n"),
        },
        "index_histogram_tiles": {
            "shipped": hist,
            "batch 4": hist.replace(TILE_BATCH, "constexpr int kBatch = 4;"),
            "elems 16": hist.replace(
                TILE_ELEMS, "constexpr int kTileElemsPerThread = 16;"),
            "elems 4": hist.replace(
                TILE_ELEMS, "constexpr int kTileElemsPerThread = 4;"),
            "warps 1": hist.replace(TILE_WARPS,
                                    "constexpr int kWarpBlock = 32;"),
            "warps 8": hist.replace(TILE_WARPS,
                                    "constexpr int kWarpBlock = 256;"),
            "empty": hist.replace(TILE_ENTRY, TILE_ENTRY.replace(
                "int tile, j;\n", "int tile, j;\n  if (C > 0) return;\n")),
        },
        "clip_quant_pack": {
            "shipped": quant,
            "empty": quant.replace(QUANT_ENTRY,
                                   QUANT_ENTRY + "  if (n >= 0) return;\n"),
        },
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("pack_hist_variants: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core.tiling import TilePlan
    from repro_torch.kernels import _build, rate_hist
    from repro_torch.kernels import fused_clip_quant as fcq
    from repro_torch.kernels import pack_bits as pb
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    work = _build.BUILD_ROOT / "pack_hist_variants"
    work.mkdir(parents=True, exist_ok=True)
    symbol = {"pack_bits": "repro_pack_bits",
              "index_histogram_tiles": "repro_index_histogram_tiles",
              "clip_quant_pack": "repro_clip_quant_pack"}
    srcs = variants()
    if args.parent is not None:
        par = parent_sources(args.parent)
        srcs["pack_bits"]["parent"] = par["pack_bits"]
        srcs["index_histogram_tiles"]["parent"] = par["rate_hist"]
        srcs["parent_clip_quant"] = {"parent": par["fused_clip_quant"]}
    fns = {}
    with ThreadPoolExecutor(8) as pool:
        jobs = {(kern, k): pool.submit(build, f"{kern}_{k.replace(' ', '_')}",
                                       src, work, _build._nvcc(),
                                       _build.NVCC_FLAGS)
                for kern, by in srcs.items() for k, src in by.items()}
        for (kern, k), job in jobs.items():
            path, _ = job.result()
            lib = ctypes.CDLL(str(path))
            if kern == "parent_clip_quant":
                # the parent's entries: no ticket argument
                quant = lib.repro_clip_quant
                quant.argtypes = _build._SIGNATURES["repro_clip_quant"][:-2] \
                    + (ctypes.c_void_p,)
                pack = getattr(ctypes.CDLL(str(jobs[("pack_bits", "parent")]
                                               .result()[0])),
                               "repro_pack_bits")
                pack.argtypes = _build._SIGNATURES["repro_pack_bits"]
                fns[("parent_clip_quant", k)] = (quant, pack)
                continue
            fn = getattr(lib, symbol[kern])
            sig = _build._SIGNATURES[symbol[kern]]
            fn.argtypes = sig
            fns[(kern, k)] = fn
    s = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device=dev).manual_seed(0)
    lo, hi, n_levels, bits = -2.2, 2.9, 4, 2
    plan = TilePlan(channel_axis=-1, channel_group_size=8,
                    spatial_block_size=0, n_channels=4096)
    ticket = _build.hist_ticket(dev).data_ptr()
    out: dict = {}

    def record(kern, size, run, check):
        for (kk, k), fn in fns.items():
            if kk != kern:
                continue
            status = run(fn)
            torch.cuda.synchronize()
            if status != 0:
                raise RuntimeError(f"{kern} {k} {size}: CUDA error {status}")
            if k not in DIAG and not check():
                raise AssertionError(f"{kern} {k} {size} differs")
            out.setdefault(kern, {}).setdefault(k, {})[size] = time_ms(
                lambda fn=fn: run(fn))

    for size, t in (("decode", 1), ("prefill", 64)):
        n = 4 * t * 4096
        idx = torch.randint(0, 4, (n,), device=dev, generator=gen,
                            dtype=torch.int32)
        packed = torch.empty(n // 4, dtype=torch.uint8, device=dev)
        record("pack_bits", size,
               lambda fn: fn(idx.data_ptr(), n, bits, packed.data_ptr(), s),
               lambda: torch.equal(packed, pb.pack_bits_plain(idx, bits)))
        shape = (4, t, 4096)
        maps = fcq.tile_maps(plan, shape, dev)
        tidx = idx.view(shape)
        hist = torch.empty((plan.n_cgroups, 1, n_levels), dtype=torch.int32,
                           device=dev)
        record("index_histogram_tiles", size,
               lambda fn: fn(tidx.data_ptr(), maps.c, maps.inner,
                             maps.group_size, plan.n_tiles, maps.n_sblocks,
                             maps.bounds.data_ptr(), None, maps.max_tile,
                             n_levels, hist.data_ptr(), s),
               lambda: torch.equal(hist, rate_hist.index_histogram_tiles_plain(
                   tidx, n_levels, maps)))
        x = (torch.randn(shape, device=dev, generator=gen) * 1.3 + 0.1).to(
            torch.bfloat16)
        rows = _build.hist_rows(n, dev)
        qh = torch.empty(n_levels, dtype=torch.int32, device=dev)
        flo, fhi, scale, _ = fcq.range_scalars(lo, hi, n_levels)
        want = fcq.clip_quant_pack_plain(x, lo, hi, n_levels, bits)
        record("clip_quant_pack", size,
               lambda fn: fn(x.data_ptr(), 1, n, float(flo), float(fhi),
                             float(scale), n_levels, bits, packed.data_ptr(),
                             qh.data_ptr(), rows.data_ptr(), rows.shape[0],
                             ticket, s),
               lambda: torch.equal(packed, want[0])
               and torch.equal(qh, want[1]))
        if args.parent is not None:
            pidx = torch.empty(shape, dtype=torch.int32, device=dev)
            inv = fcq.range_scalars(lo, hi, n_levels)[3]

            def two_launches(fns_):
                quant, pack = fns_
                return quant(x.data_ptr(), 1, n, float(flo), float(fhi),
                             float(scale), float(inv), n_levels,
                             pidx.data_ptr(), None, qh.data_ptr(),
                             rows.data_ptr(), rows.shape[0], s) or pack(
                    pidx.data_ptr(), n, bits, packed.data_ptr(), s)
            record("parent_clip_quant", size, two_launches,
                   lambda: torch.equal(packed, want[0])
                   and torch.equal(qh, want[1]))
    for kern, by in out.items():
        print(f"{kern} (ms per call back to back, decode / prefill):")
        for k, t in by.items():
            print(f"  {k:10s} {t['decode']:.4f} / {t['prefill']:.4f}")
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"nvidia_smi": smi, "ms": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
