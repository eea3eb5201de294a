#!/usr/bin/env python3
"""Time the codec's in-graph rate path of one copy of the port on one card.

    python3 tools/codec_call_time.py --src SRC_DIR [--label NAME]

Imports ``repro_torch`` from ``SRC_DIR`` (``src`` of this checkout, or of
an unpacked ``git archive`` of another commit), builds its kernels, and
times two calls at the serving paths' decode (4, 1, 4096) and prefill
(4, 64, 4096) boundaries, bfloat16, seeded, with a per-tensor N=4 codec
clipping at (-2.2, 2.9):

* ``FeatureCodec.apply_with_rate`` -- the ``codec=`` serving hookup
  (quantize, reconstruction, rate estimate);
* the packed split runtime's crossing -- quantize, pack, move, unpack,
  dequantize and the rate -- taken from the closure of the step
  ``make_split_decode_step`` returns, so each copy runs its own.

Each is eager wall time per call from python (host clock around
back-to-back calls that end in a device sync, so the host's dispatch of
every launch counts), median over trials.  Each call's device
operations are counted with ``torch.profiler``, and a SHA-256 of its
outputs (reconstruction or dequantized input, rate bits) lets two copies
run in one call be held to the same results.  Prints one JSON line.  To
compare commits, run each copy in its own process, in the order A, B,
B, A.
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

REPS, TRIALS = 200, 7


def wall_ms(fn) -> float:
    """Median wall ms per call of ``fn`` over TRIALS runs of REPS calls,
    each run ending in a device sync."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(TRIALS):
        t0 = time.perf_counter()
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3 / REPS)
    return statistics.median(out)


def device_ops(fn) -> int:
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.device_type == torch.autograd.DeviceType.CUDA
               for e in prof.events())


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", required=True)
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("codec_call_time: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.compression import split_runtime as SR
    from repro_torch.configs import get_config
    from repro_torch.core import CodecConfig, calibrate
    from repro_torch.kernels import _build
    _build.library()
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    codec = calibrate(CodecConfig(n_levels=4, clip_mode="manual",
                                  manual_cmin=-2.2, manual_cmax=2.9,
                                  backend="cuda"))
    step = SR.make_split_decode_step(get_config("codeqwen1.5-7b"), codec,
                                     transport="packed", edge_device=dev,
                                     cloud_device=dev)
    cross = inspect.getclosurevars(inspect.unwrap(step)).nonlocals["cross"]
    gen = torch.Generator(device=dev).manual_seed(0)
    label = args.label or args.src
    out = {}
    for size, t in (("decode", 1), ("prefill", 64)):
        x = (torch.randn(4, t, 4096, device=dev, generator=gen) * 1.3
             + 0.1).to(torch.bfloat16)
        calls = {"apply_with_rate": lambda x=x: codec.apply_with_rate(x),
                 "split crossing": lambda x=x: cross(x)}
        for name, fn in calls.items():
            with torch.inference_mode():
                res = fn()
                ms = wall_ms(fn)
                n_ops = device_ops(fn)
            key = f"{name} {size}"
            out[key] = {"ms": ms, "device_ops": n_ops,
                        "rate": float(res[1]),
                        "sha256": digest(res[0], res[1].reshape(1))}
            print(f"{label}: {key}: {ms:.4f} ms per call (median of "
                  f"{TRIALS} x {REPS}), {n_ops} device operations, rate "
                  f"{float(res[1])!r}", flush=True)
    print(json.dumps({"label": label, "nvidia_smi": smi, "cases": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
