#!/usr/bin/env python3
"""Time the codec's in-graph rate path of one copy of the port on one card.

    python3 tools/codec_call_time.py --src SRC_DIR [--label NAME]

Imports ``repro_torch`` from ``SRC_DIR`` (``src`` of this checkout, or of
an unpacked ``git archive`` of another commit), builds its kernels, and
times codec calls at the serving paths' decode (4, 1, 4096) and prefill
(4, 64, 4096) boundaries, bfloat16, seeded.  With a per-tensor N=4 codec
clipping at (-2.2, 2.9) -- runs (a) and (h) -- and with a per-channel
g=8 N=4 codec calibrated by min/max on seeded samples -- runs (c) and
(l):

* ``FeatureCodec.apply_with_rate`` -- the ``codec=`` serving hookup
  (quantize, reconstruction, rate estimate);
* the packed split runtime's crossing -- quantize, pack, move, unpack,
  dequantize and the rate -- made of the copy's own split runtime
  (:func:`crossing`), so each copy runs its own.

With a per-channel ECSQ g=8 N=4 codec on the same samples -- run (f) --
``FeatureCodec.encode_stream(x, chunk_elems=65536,
device_entropy=True)``, the bitstream hookup's encode (quantize to coded
order, the device rANS stage, the payloads on the host), and its first
stage alone, ``coded_indices_device`` on the float32 boundary.

Each is eager wall time per call from python (host clock around
back-to-back calls that end in a device sync, so the host's dispatch of
every launch counts), median over trials.  Each call's device
operations are counted with ``torch.profiler``, and a SHA-256 of its
outputs (reconstruction or dequantized input and rate bits, or the
payloads) lets two copies run in one call be held to the same results.
Prints one JSON line.  To compare commits, run each copy in its own
process, in the order A, B, B, A.
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

import numpy as np
import torch

REPS, TRIALS = 200, 7


def crossing(SR, cfg, codec, dev):
    """``y -> (dequantized input, rate)``: the packed one-process split
    step's crossing in the copy ``SR`` (its split_runtime module) -- the
    ends of the crossing (``_boundary``) joined by the step's ``.to``,
    or, in a copy from before the step was cut into halves, the
    ``cross`` closure of the step."""
    if not hasattr(SR, "_boundary"):
        step = SR.make_split_decode_step(cfg, codec, transport="packed",
                                         edge_device=dev, cloud_device=dev)
        return inspect.getclosurevars(inspect.unwrap(step)).nonlocals["cross"]
    send, receive = SR._boundary(cfg, codec, "packed")

    def cross(y):
        wire, counts = send(y)
        rate = codec.rate_from_counts(counts, y.shape)
        return receive(wire.to(dev), y.shape), rate

    return cross


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
    rng = np.random.default_rng(0)
    samples = (rng.standard_normal((64, 4096)) * rng.uniform(0.5, 2, 4096)
               ).astype(np.float32)
    channel = dict(clip_mode="minmax", constrain_cmin_zero=False,
                   granularity="channel", channel_axis=-1,
                   channel_group_size=8, backend="cuda")
    codecs = {
        "tensor": calibrate(CodecConfig(n_levels=4, clip_mode="manual",
                                        manual_cmin=-2.2, manual_cmax=2.9,
                                        backend="cuda")),
        "channel": calibrate(CodecConfig(n_levels=4, **channel), samples),
        "ecsq channel": calibrate(CodecConfig(n_levels=4, use_ecsq=True,
                                              ecsq_lagrangian=0.05,
                                              **channel), samples)}
    crossings = {kind: crossing(SR, get_config("codeqwen1.5-7b"),
                                codecs[kind], dev)
                 for kind in ("tensor", "channel")}
    gen = torch.Generator(device=dev).manual_seed(0)
    label = args.label or args.src
    out = {}
    for size, t in (("decode", 1), ("prefill", 64)):
        x = (torch.randn(4, t, 4096, device=dev, generator=gen) * 1.3
             + 0.1).to(torch.bfloat16)
        ecsq = codecs["ecsq channel"]
        calls = {f"{kind} {name}": fn for kind in ("tensor", "channel")
                 for name, fn in (
                     ("apply_with_rate",
                      lambda x=x, c=codecs[kind]: c.apply_with_rate(x)),
                     ("split crossing",
                      lambda x=x, f=crossings[kind]: f(x)))}
        # the bitstream hookup hands encode_stream host float32 values;
        # its device stage starts from the coded-order indices
        calls["ecsq channel encode_stream"] = lambda xn=x.float().cpu() \
            .numpy(): list(ecsq.encode_stream(xn, chunk_elems=1 << 16,
                                              device_entropy=True))
        calls["ecsq channel coded_indices_device"] = \
            lambda xf=x.float(): ecsq.backend.coded_indices_device(
                xf, ecsq.spec(), ecsq.bits_per_index())
        for name, fn in calls.items():
            with torch.inference_mode():
                res = fn()
                ms = wall_ms(fn)
                n_ops = device_ops(fn)
            key = f"{name} {size}"
            if name.endswith("encode_stream"):
                rate = 8.0 * sum(map(len, res)) / x.numel()
                sha = hashlib.sha256(b"".join(res)).hexdigest()
            elif name.endswith("coded_indices_device"):
                rate = float("nan")
                sha = digest(res)
            else:
                rate = float(res[1])
                sha = digest(res[0], res[1].reshape(1))
            out[key] = {"ms": ms, "device_ops": n_ops, "rate": rate,
                        "sha256": sha}
            print(f"{label}: {key}: {ms:.4f} ms per call (median of "
                  f"{TRIALS} x {REPS}), {n_ops} device operations, rate "
                  f"{rate!r}", flush=True)
    print(json.dumps({"label": label, "nvidia_smi": smi, "cases": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
