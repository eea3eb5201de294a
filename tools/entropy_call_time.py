#!/usr/bin/env python3
"""Time the device entropy call of one copy of the port on one card.

    python3 tools/entropy_call_time.py --src SRC_DIR [--label NAME]

Imports ``repro_torch`` from ``SRC_DIR`` (``src`` of this checkout, or of
an unpacked ``git archive`` of another commit), builds its kernels, and
times its whole ``kernels.rans_coder.encode_index_chunks_device`` call
-- size pre-pass, plane build, step loop, word compaction and fetch --
wall clock per call (the call ends in a host fetch), median over its
repetitions, with the device memory it allocates at its peak above what
was allocated before it (``torch.cuda.max_memory_allocated``).

Cases, from a seeded activation quantized in plain torch, range
(-2.2, 2.9): the serving paths' prefill boundary (1,048,576 indices in 16
chunks of 65,536) and decode boundary (16,384 indices, one chunk) at
N=4; the prefill boundary at N=16; and 2^24 indices at N=16 in 256
chunks, where the memory of the plane build shows.  Prints one JSON line
with each case's ms, peak MiB and a SHA-256 of its payloads, so that two
copies run in one call can be held to the same bytes.  To compare
commits, run each copy in its own process, in the order A, B, B, A.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch


def cases(dev):
    gen = torch.Generator(device=dev).manual_seed(0)

    def coded(shape, n_levels):
        x = (torch.randn(shape, device=dev, generator=gen) * 1.3 + 0.1)
        x = x.to(torch.bfloat16).float().reshape(-1)
        q = torch.round((x.clamp(-2.2, 2.9) + 2.2) / 5.1 * (n_levels - 1))
        return q.to(torch.int32)

    def chunks(n, size):
        return [(i, min(i + size, n)) for i in range(0, n, size)]

    pre4, dec4 = coded((4, 64, 4096), 4), coded((4, 1, 4096), 4)
    pre16, big16 = coded((4, 64, 4096), 16), coded((1 << 24,), 16)
    return {"prefill N=4": (pre4, 4, chunks(pre4.numel(), 1 << 16), 20),
            "decode N=4": (dec4, 4, chunks(dec4.numel(), 1 << 16), 20),
            "prefill N=16": (pre16, 16, chunks(pre16.numel(), 1 << 16), 10),
            "2^24 N=16": (big16, 16, chunks(big16.numel(), 1 << 16), 3)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", required=True)
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("entropy_call_time: no CUDA device", file=sys.stderr)
        return 2
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    from repro_torch.kernels import _build, rans_coder
    _build.library()
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    out = {}
    for name, (idx, n_levels, bounds, reps) in cases(dev).items():
        call = lambda: rans_coder.encode_index_chunks_device(  # noqa: E731
            idx, n_levels, bounds)
        blobs = call()                            # warm
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        blobs = call()
        peak = torch.cuda.max_memory_allocated() - base
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            call()
            times.append((time.perf_counter() - t0) * 1e3)
        out[name] = {"ms": statistics.median(times), "peak_mib": peak / 2**20,
                     "indices": idx.numel(), "chunks": len(bounds),
                     "sha256": hashlib.sha256(b"".join(blobs)).hexdigest()}
        print(f"{args.label or src}: {name}: {out[name]['ms']:.4f} ms per "
              f"call (median of {reps}), peak {out[name]['peak_mib']:.1f} "
              "MiB above its inputs", flush=True)
    print(json.dumps({"label": args.label or str(src), "nvidia_smi": smi,
                      "cases": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
