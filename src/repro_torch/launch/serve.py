"""Serving launcher: `python -m repro_torch.launch.serve --arch <id> [...]`.

Runs the continuous-batching engine on a (reduced by default) config, with
the paper's codec applied at the split boundary, and prints tokens/s, the
measured split-link rate, and per-request latency.  The model runs on
``--device`` (default ``cuda``; there is no silent CPU fallback), with
random weights drawn from seed 0.

The codec is calibrated from a *warm-up batch of real split-layer
activations* (``--clip-mode model|empirical|minmax|aciq``, the paper's
calibration modes); ``--clip-mode manual`` keeps the fixed [-8, 8] range.
``--granularity channel`` (with ``--channel-group``) calibrates a
TilePlan codec with one range per group of d_model channels; on the CUDA
device it runs the per-tile quantize and histogram kernels.

``--transport loopback`` (the framed socket transport) is not ported yet
and raises.
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def warmup_samples(cfg, params, *, batches: int, seq_len: int,
                   device, split_after: int | None = None) -> np.ndarray:
    """Split-layer activations of ``batches`` warm-up batches (4 random
    sequences of ``seq_len`` tokens each) as float32 (tokens, d_model):
    the calibration samples of the serving codec.  ``split_after`` moves
    the boundary as in ``forward_head`` (the split runtime's boundary
    falls after half the layers)."""
    import torch

    from ..data import DataConfig, stream
    from ..models import forward_head

    dcfg = DataConfig(vocab_size=cfg.vocab_size, batch=4, seq_len=seq_len)
    chunks = []
    with torch.inference_mode():
        for _, batch in zip(range(batches), stream(dcfg)):
            x = forward_head(cfg, params, torch.as_tensor(batch["tokens"],
                                                          device=device),
                             split_after=split_after)
            chunks.append(x.to(torch.float32).cpu().numpy()
                          .reshape(-1, cfg.d_model))
    return np.concatenate(chunks, axis=0)


def _calibrate_warmup(cfg, params, args, device):
    """Calibrate the codec on a warm-up batch of split-layer activations.

    Tiled granularities keep the d_model channel axis in the calibration
    samples (reshaped to (tokens, d_model)), so per-channel-group ranges
    come from real per-feature statistics.
    """
    import torch

    from ..core import CodecConfig, calibrate

    backend = "cuda" if torch.device(device).type == "cuda" else "torch"
    if args.clip_mode == "manual":
        if args.granularity != "tensor":
            raise SystemExit("--clip-mode manual implies per-tensor "
                             "granularity")
        return calibrate(CodecConfig(n_levels=args.codec_levels,
                                     clip_mode="manual", manual_cmin=-8.0,
                                     manual_cmax=8.0, backend=backend))
    ccfg = CodecConfig(n_levels=args.codec_levels, clip_mode=args.clip_mode,
                       constrain_cmin_zero=False,
                       granularity=args.granularity, channel_axis=-1,
                       channel_group_size=args.channel_group,
                       backend=backend)
    samples = warmup_samples(
        cfg, params, batches=args.warmup_batches,
        seq_len=min(64, args.prompt_len + args.new_tokens), device=device)
    if args.granularity == "tensor":
        samples = samples.reshape(-1)
    codec = calibrate(ccfg, samples=samples)
    grain = args.granularity if args.granularity == "tensor" else \
        f"{args.granularity}(g={args.channel_group})"
    print(f"calibrated codec on {samples.size} warm-up activations: "
          f"clip_mode={args.clip_mode} granularity={grain} "
          f"range=[{float(np.min(codec.cmin)):.3f},"
          f" {float(np.max(codec.cmax)):.3f}]")
    return codec


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--codec-levels", type=int, default=0,
                    help="0 = no split codec; else N quantizer levels")
    ap.add_argument("--clip-mode", default="model",
                    choices=["model", "empirical", "minmax", "aciq",
                             "manual"],
                    help="codec calibration mode (warm-up activations; "
                         "'manual' keeps the fixed [-8, 8] range)")
    ap.add_argument("--warmup-batches", type=int, default=4)
    ap.add_argument("--granularity", default="tensor",
                    choices=["tensor", "channel"],
                    help="codec granularity at the split boundary: "
                         "'channel' calibrates one range per d_model "
                         "channel group (TilePlan, v3 streams)")
    ap.add_argument("--channel-group", type=int, default=1,
                    help="channels per range group for "
                         "--granularity channel")
    ap.add_argument("--transport", default="none",
                    choices=["none", "loopback"],
                    help="'loopback' (framed socket transport) is not "
                         "ported yet")
    ap.add_argument("--trace", metavar="PATH", default=None,
                    help="enable pipeline stage tracing and mirror the "
                         "JSON span log to PATH")
    ap.add_argument("--device", default="cuda",
                    help="torch device the model and codec run on")
    ap.add_argument("--full", action="store_true")
    return ap


def make_model(arch: str, full: bool, device):
    """(config, random params from seed 0 on ``device``) for ``arch``."""
    import torch

    from ..configs import get_config, reduced
    from ..models import init_params

    cfg = get_config(arch)
    if not full:
        cfg = reduced(cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    return cfg, init_params(cfg, gen, device=device)


def run(cfg, params, *, requests: int, prompt_len: int, new_tokens: int,
        device, codec=None, codec_host_fn=None):
    """Serve ``requests`` random prompts and print the reference's
    summary lines.  Returns (engine, requests, seconds)."""
    from ..serving import Request, ServeEngine

    eng = ServeEngine(cfg, params, slots=4,
                      max_seq=prompt_len + new_tokens + 8,
                      codec=codec, codec_host_fn=codec_host_fn,
                      device=device)
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size,
                                        size=prompt_len).astype(np.int32),
                    max_new_tokens=new_tokens)
            for _ in range(requests)]
    t0 = time.time()
    eng.generate(reqs)
    dt = time.time() - t0
    total = sum(len(r.out_tokens) for r in reqs)
    print(f"{total} tokens in {dt:.2f}s = {total / dt:.1f} tok/s "
          f"({requests} requests)")
    if eng.rate_log:
        print(f"split-link rate: {np.mean(eng.rate_log):.3f} bits/element "
              f"({16 / max(np.mean(eng.rate_log), 1e-9):.1f}x vs bf16)")
    if eng.latency_log:
        lat = [d["latency_s"] for d in eng.latency_log]
        print(f"request latency: mean={np.mean(lat):.3f}s "
              f"p50={np.percentile(lat, 50):.3f}s "
              f"max={np.max(lat):.3f}s")
    ec = eng.counters
    print(f"engine: {ec['steps']} steps, occupancy "
          f"{ec['batch_occupancy_avg']:.2f}, {ec['refills']} refills, "
          f"{ec['epochs']} epochs")
    return eng, reqs, dt


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.transport == "loopback":
        raise NotImplementedError(
            "--transport loopback waits for the transport/ + "
            "serving/batcher.py slice (ROADMAP.md)")
    if args.trace is not None:
        from ..obs import configure_tracing
        configure_tracing(enabled=True, event_log_path=args.trace)
        print(f"stage tracing on: span log -> {args.trace}")

    from ..serving.engine import resolve_device

    device = resolve_device(args.device)
    cfg, params = make_model(args.arch, args.full, device)
    codec = None
    if args.codec_levels:
        codec = _calibrate_warmup(cfg, params, args, device)
    run(cfg, params, requests=args.requests, prompt_len=args.prompt_len,
        new_tokens=args.new_tokens, device=device, codec=codec)


if __name__ == "__main__":
    main()
