#!/usr/bin/env python3
"""Time the prefill-attention kernel beside the plain prefill path on one
card.

    python3 tools/prefill_attention_time.py [--out FILE]

Shapes: the benchmark cell's attention (32 query and 4 KV heads of 128,
bfloat16): a refill, one row at positions 2048, 2150, 2547 and 4096, and
the opening prefill, 48 rows of 2048.  For each:

* the kernel (``kernels.prefill_attention``): CUDA events around
  back-to-back calls of the wrapper, rotating over four layers' q, k, v;
* its bound, the causal FLOPs ``2 B H hd S (S + 1)`` (both products over
  the pairs ``t <= s``) at 989 TFLOP/s, and the kernel's share of it;
* the plain path (``layers.multi_head_attention(q, k, v, q_offset=0)``,
  float32 logits over the whole square), as a prefill ran it before the
  kernel, timed the same way with fewer calls;
* the library's call for the same function,
  ``F.scaled_dot_product_attention(..., is_causal=True,
  enable_gqa=True)``, timed the same way (for comparison only; the port
  never calls it);
* the largest difference between the kernel's and the plain path's
  outputs.

Prints one JSON line, with the card's name and power limit, and writes it
to ``--out`` where one is given.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from decode_attention_time import smi  # noqa: E402

from repro_torch.kernels import prefill_attention as PA  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

PEAK_BF16_FLOPS = 989e12
LAYERS = 4
H, KH, HD = 32, 4, 128
# name -> (B, S)
SHAPES = {"refill-2048": (1, 2048), "refill-2150": (1, 2150),
          "refill-2547": (1, 2547), "refill-4096": (1, 4096),
          "opening-48x2048": (48, 2048)}


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
    for name, (b, s) in SHAPES.items():
        g = torch.Generator(device=dev).manual_seed(0)
        layers = [tuple(torch.randn((b, s, n, HD), device=dev, generator=g)
                        .to(torch.bfloat16) for n in (H, KH, KH))
                  for _ in range(LAYERS)]

        def kernel(i):
            return PA.prefill_attention(*layers[i % LAYERS])

        def plain(i):
            return L.multi_head_attention(*layers[i % LAYERS], q_offset=0)

        def library(i):
            q, k, v = (t.transpose(1, 2) for t in layers[i % LAYERS])
            return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  enable_gqa=True)

        with torch.inference_mode():
            diff = float((kernel(0).float() - plain(0).float()).abs().max())
            k_ms = time_ms(kernel, 50)
            p_ms = time_ms(plain, 4 if b == 1 else 2)
            lib_ms = time_ms(library, 50)
        flops = 2 * b * H * HD * s * (s + 1)
        bound_ms = flops / PEAK_BF16_FLOPS * 1e3
        rows.append({"shape": name, "B": b, "S": s, "H": H, "K": KH,
                     "hd": HD, "kernel_ms": k_ms, "bound_ms": bound_ms,
                     "roofline_pct": 100.0 * bound_ms / k_ms,
                     "plain_ms": p_ms, "library_ms": lib_ms,
                     "library_roofline_pct": 100.0 * bound_ms / lib_ms,
                     "max_abs_diff": diff})
        print(json.dumps(rows[-1]), flush=True)
        del layers
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
