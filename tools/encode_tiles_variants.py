#!/usr/bin/env python3
"""Time design variants of the encode megakernel (kernel #3) on one card.

    python3 tools/encode_tiles_variants.py

The port ships one design of ``repro_encode_tiles`` in
``src/repro_torch/csrc/fused_clip_quant.cu``; this script makes variants
of it by text substitution (threads per block, ``kThreads``), builds
each into its own library under ``build/`` and times it, in one process,
on the four shapes the serving runs give it: the flat route's float32
(1024, 1024) prefill and (16, 1024) decode views, and the plan route's
banded (4096, 256) and (4096, 128) views of the g=8 per-channel plan
(N=4, 2 bits).  Every variant's packed bytes and histograms must equal
the plain version's.  Prints each kernel's ``-Xptxas -v`` line and the
card's name and power limit.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))
from _variants import build, time_ms  # noqa: E402

THREADS = "constexpr int kThreads = 256;"
FIRST = "    load_group<T, E>(xb + (long long)threadIdx.x * E, vec, v);\n"
HIST = "  const int n_groups = blockDim.x / group;\n"


def variants(src: str) -> dict[str, str]:
    assert THREADS in src, "shipped source changed: update the substitution"
    out = {"shipped": src}
    for k in (128, 512):
        out[f"threads{k}"] = src.replace(THREADS,
                                         f"constexpr int kThreads = {k};")
    # diagnostics (outputs incomplete, not checked): the same grid doing
    # nothing, only its loads (one byte stored per thread), and all but
    # the histogram rows
    assert FIRST in src and HIST in src
    first = "  const int n_bytes = k_cells * bpb;\n"
    out["diag_empty"] = src.replace(
        first, first + "  if (n_bytes > 0) return;\n", 1)
    out["diag_loads"] = src.replace(
        FIRST, FIRST + "  if (threadIdx.x < n_bytes) packed[cell0 * bpb + "
        "threadIdx.x] = (unsigned char)v[0];\n  return;\n")
    out["diag_no_hist"] = src.replace(HIST, "  return;\n" + HIST)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("encode_tiles_variants: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core.tiling import TilePlan
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import fused_clip_quant as fcq
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    work = _build.BUILD_ROOT / "encode_variants"
    work.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "fused_clip_quant.cu").read_text()
    with ThreadPoolExecutor(4) as pool:
        futs = {k: pool.submit(build, k, v, work, _build._nvcc(),
                               _build.NVCC_FLAGS)
                for k, v in variants(src).items()}
        libs = {k: f.result() for k, f in futs.items()}
    for k, (_, regs) in libs.items():
        print(f"ptxas {k}: " + " | ".join(
            r.split(": ", 1)[1] for r in regs if "encode_tiles" in r
            and "Li2E" in r))

    gen = torch.Generator(device=dev).manual_seed(0)
    lo, hi, n, bits = -2.2, 2.9, 4, 2
    plan = TilePlan(channel_axis=-1, channel_group_size=8,
                    spatial_block_size=0, n_channels=4096)
    cases = {}
    for size, t in (("prefill", 64), ("decode", 1)):
        x = torch.randn(4, t, 4096, device=dev, generator=gen) * 1.3 + 0.1
        x2d, _ = ops._to_2d(x.reshape(-1), lo)
        r, c = x2d.shape
        cases[f"flat {size}"] = (
            x2d, torch.full((r, 1), lo, device=dev),
            torch.full((r, 1), hi, device=dev), c, 1,
            fcq.band_valid_array(1, c, None, device=dev))
        lay = ops.banded_layout(tuple(x.shape), plan)
        xp, _ = ops._banded_view(x, lay, plan)
        t_lo = lo + torch.rand(512, 1, device=dev, generator=gen) * 0.4
        t_hi = hi - torch.rand(512, 1, device=dev, generator=gen) * 0.4
        lo_r, hi_r = ops._row_ranges(t_lo, t_hi, lay)
        cases[f"plan {size}"] = (
            xp, lo_r, hi_r, lay.sb_cols, lay.n_sblocks,
            fcq.band_valid_array(lay.n_sblocks, lay.bs, lay.bs_last,
                                 device=dev))
    s = torch.cuda.current_stream().cuda_stream
    P, I = ctypes.c_void_p, ctypes.c_int
    for name, (x2d, lo_r, hi_r, sb, nsb, valid) in cases.items():
        r, c = x2d.shape
        pp, ph = fcq.encode_tiles_plain(x2d, lo_r, hi_r, valid, n, bits, sb)
        line = []
        for k, (path, _) in libs.items():
            fn = ctypes.CDLL(str(path)).repro_encode_tiles
            fn.argtypes = (P, I, I, I, I, I, P, P, P, I, I, P, P, P)
            packed, hist = torch.empty_like(pp), torch.empty_like(ph)

            def run(fn=fn, packed=packed, hist=hist):
                assert fn(x2d.data_ptr(), 0, r, c, sb, nsb, lo_r.data_ptr(),
                          hi_r.data_ptr(), valid.data_ptr(), n, bits,
                          packed.data_ptr(), hist.data_ptr(), s) == 0
            run()
            torch.cuda.synchronize()
            if not k.startswith("diag") and not (
                    torch.equal(packed, pp) and torch.equal(hist, ph)):
                raise AssertionError(f"{k} differs from the plain version "
                                     f"on {name}")
            line.append(f"{k} {time_ms(run):.4f}")
        print(f"{name} ({r}, {c}): " + ", ".join(line)
              + " ms; all but the diagnostics exact")
    return 0


if __name__ == "__main__":
    sys.exit(main())
