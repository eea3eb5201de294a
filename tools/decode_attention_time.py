#!/usr/bin/env python3
"""Time the decode-attention kernel beside the plain decode path on one card.

    python3 tools/decode_attention_time.py [--out FILE]

Shapes: the benchmark cell's (48 rows x 8192 slots, 32 query and 4 KV
heads of 128, bfloat16) at positions 255, 2150 and 8191, and dbrx's
stage (32 rows x 4096 slots, 48 / 8 heads of 128) at 2150 and 4095.
For each:

* the kernel (``kernels.decode_attention``): CUDA events around
  back-to-back calls of the wrapper, rotating over four layers' caches so
  that the 50 MB L2 holds little of what a call reads;
* its byte bound, the prefix of K and V read once at 3.35 TB/s, and the
  kernel's share of it;
* the plain path: the masked float32 attention over the whole cache
  (``layers.multi_head_attention`` with slot positions), as a decode step
  ran it before the kernel, timed the same way;
* the library's call for the same function,
  ``F.scaled_dot_product_attention(..., enable_gqa=True)`` over the
  prefix, timed the same way (for comparison only; the port never calls
  it);
* the largest difference between the kernel's and the plain path's
  outputs.

Prints one JSON line, with the card's name and power limit, and writes it
to ``--out`` where one is given.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.kernels import decode_attention as DA  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

HBM_BYTES_PER_S = 3.35e12
LAYERS = 4
# name -> (B, S_cache, H, K, hd, positions)
SHAPES = {"cell": (48, 8192, 32, 4, 128, (255, 2150, 8191)),
          "dbrx": (32, 4096, 48, 8, 128, (2150, 4095))}


def smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def time_ms(fn, reps: int) -> float:
    """Mean device ms a call over ``reps`` calls (``fn(i)``), after a
    warm-up of LAYERS calls."""
    for i in range(LAYERS):
        fn(i)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for i in range(reps):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", help="also write the JSON line to this file")
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    rows = []
    for name, (b, s, h, kh, hd, positions) in SHAPES.items():
        g = torch.Generator(device=dev).manual_seed(0)
        q = torch.randn((b, 1, h, hd), device=dev, generator=g).to(
            torch.bfloat16)
        caches = [tuple(torch.randn((b, s, kh, hd), device=dev,
                                    generator=g).to(torch.bfloat16)
                        for _ in range(2)) for _ in range(LAYERS)]
        idx = torch.arange(s, dtype=torch.int32, device=dev)
        for pos in positions:
            n_valid = min(pos + 1, s)

            def kernel(i):
                k, v = caches[i % LAYERS]
                return DA.decode_attention(q[:, 0], k, v, n_valid)

            def plain(i):
                k, v = caches[i % LAYERS]
                return L.multi_head_attention(q, k, v, q_offset=pos,
                                              k_positions=idx)

            def library(i):
                k, v = caches[i % LAYERS]
                return F.scaled_dot_product_attention(
                    q.transpose(1, 2), k[:, :n_valid].transpose(1, 2),
                    v[:, :n_valid].transpose(1, 2), enable_gqa=True)

            diff = float((kernel(0).float() - plain(0).float()).abs().max())
            k_ms = time_ms(kernel, 200)
            p_ms = time_ms(plain, 10)
            lib_ms = time_ms(library, 200)
            # the prefix of K and V, bf16, read once
            bound_ms = 2 * b * n_valid * kh * hd * 2 / HBM_BYTES_PER_S * 1e3
            rows.append({
                "shape": name, "B": b, "S": s, "H": h, "K": kh, "hd": hd,
                "pos": pos, "split_plan": DA.split_plan(
                    b * kh, n_valid, hd, DA._sm_count(0)),
                "kernel_ms": k_ms, "bound_ms": bound_ms,
                "roofline_pct": 100.0 * bound_ms / k_ms,
                "plain_ms": p_ms, "library_ms": lib_ms,
                "max_abs_diff": diff})
        del caches
        torch.cuda.empty_cache()
    res = {"device": torch.cuda.get_device_name(0), "smi": smi(),
           "torch": torch.__version__, "rows": rows}
    line = json.dumps(res)
    print(line)
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(line + "\n")
    return res


if __name__ == "__main__":
    main()
