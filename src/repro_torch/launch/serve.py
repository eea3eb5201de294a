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

``--transport loopback`` wires the split boundary through a real socket
pair: a CloudServer thread on localhost receives the streamed, framed
bitstream and echoes the reconstruction, and the engine round-trips
every boundary tensor through it at the split boundary of each step
(``ServeEngine(codec_host_fn=...)``).  The server dequantizes on the
codec's backend, so ``--device cpu`` runs the whole link on the CPU
reference and the default runs it on the card.
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

    from ..core import CodecConfig
    from ..transport import shared_bank

    backend = "cuda" if torch.device(device).type == "cuda" else "torch"
    if args.clip_mode == "manual":
        if args.granularity != "tensor":
            raise SystemExit("--clip-mode manual implies per-tensor "
                             "granularity")
        # manual ranges ignore samples; dummy samples let the bank cache
        # still dedupe repeated workers
        bank = shared_bank(
            CodecConfig(n_levels=args.codec_levels, clip_mode="manual",
                        manual_cmin=-8.0, manual_cmax=8.0, backend=backend),
            np.zeros(1, np.float32), ladder=(args.codec_levels,))
        return bank.get(args.codec_levels)
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
    # rung tables are immutable -- one worker-level bank serves every
    # session with this (config, warm-up samples) pair
    codec = shared_bank(ccfg, samples,
                        ladder=(args.codec_levels,)).get(args.codec_levels)
    grain = args.granularity if args.granularity == "tensor" else \
        f"{args.granularity}(g={args.channel_group})"
    print(f"calibrated codec on {samples.size} warm-up activations: "
          f"clip_mode={args.clip_mode} granularity={grain} "
          f"range=[{float(np.min(codec.cmin)):.3f},"
          f" {float(np.max(codec.cmax)):.3f}]")
    return codec


def _loopback_codec_fn(codec, chunk_elems: int, tick_ms: float = 0.0,
                       metrics_port: int | None = None,
                       workers: int = 1, max_queue: int | None = None,
                       tls_cert: str | None = None,
                       tls_key: str | None = None,
                       secret: str | None = None):
    """Split-boundary host hook that streams every tensor over localhost.

    Starts a CloudServer (echoing reconstructions, dequantized on the
    codec's backend) on a daemon thread's event loop and returns
    ``(host_roundtrip, cleanup)``: ``host_roundtrip`` is the *host*
    round-trip ``x -> (recon, bits_per_elem)`` for
    ``ServeEngine(codec_host_fn=...)``, which the engine calls at the
    split boundary of each step; the reported rate is the true wire
    bits/element (frames, headers and all).  ``cleanup`` closes the
    client, the server and the loop, in that order, prints the link's
    counters and returns them as a dict.

    The server always runs the cross-session tick drain (one batched
    entropy call per tick); ``tick_ms`` sets the tick window.  The
    engine keeps one tensor in flight per boundary crossing, so the
    default window is 0 (drain as soon as the loop is idle) and client-
    side encode coalescing only engages for ``tick_ms > 0``.

    ``workers > 1`` puts a session-affine :class:`Dispatcher` over a pool
    of in-process CloudServers (worker kill/restart tolerant; the client
    gets a retry policy so restarts replay transparently); ``max_queue``
    bounds in-flight sessions (BUSY shedding); ``tls_cert``/``tls_key``
    wrap the edge-facing socket in TLS; and ``secret`` requires the
    authenticated HELLO handshake.
    """
    import asyncio
    import ssl as ssl_mod
    import threading

    from ..serving import TickConfig
    from ..transport import (CloudServer, Dispatcher, RetryPolicy,
                             SyncEdgeClient)

    backend = codec.backend
    tick = TickConfig(max_wait_s=tick_ms / 1e3)
    server_ssl = client_ssl = None
    if tls_cert is not None:
        server_ssl = ssl_mod.SSLContext(ssl_mod.PROTOCOL_TLS_SERVER)
        server_ssl.load_cert_chain(tls_cert, tls_key or tls_cert)
        # self-signed deployments pin the cert itself as the CA; the
        # hostname check is skipped (loopback certs rarely carry SANs)
        client_ssl = ssl_mod.create_default_context(cafile=tls_cert)
        client_ssl.check_hostname = False

    retry = None
    if workers > 1:
        server = Dispatcher(
            workers=workers,
            worker_factory=lambda i: CloudServer(echo_features=True,
                                                 tick=tick, backend=backend),
            max_queue=max_queue, ssl=server_ssl, secret=secret)
        retry = RetryPolicy()      # worker restarts replay transparently
    else:
        server = CloudServer(echo_features=True, tick=tick,
                             backend=backend, metrics_port=metrics_port,
                             max_queue=max_queue, ssl=server_ssl,
                             secret=secret)
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, name="cloud-server",
                              daemon=True)
    thread.start()

    def stop_loop():
        loop.call_soon_threadsafe(loop.stop)
        thread.join(timeout=10)
        loop.close()

    try:
        asyncio.run_coroutine_threadsafe(server.start(), loop).result()
        client = SyncEdgeClient("127.0.0.1", server.port, codec=codec,
                                chunk_elems=chunk_elems,
                                tick=tick if tick_ms > 0 else None,
                                ssl=client_ssl, secret=secret, retry=retry)
    except BaseException:
        asyncio.run_coroutine_threadsafe(server.close(), loop).result()
        stop_loop()
        raise
    kind = (f"dispatcher x{workers} workers" if workers > 1
            else "cloud server")
    print(f"loopback transport: streaming split tensors via {kind} on "
          f"127.0.0.1:{server.port} (tick window {tick_ms:.1f}ms"
          f"{', TLS' if server_ssl is not None else ''}"
          f"{', authenticated' if secret is not None else ''})")
    if getattr(server, "metrics_port", None) is not None:
        print(f"metrics: http://127.0.0.1:{server.metrics_port}/metrics")

    def host_roundtrip(x):
        res = client.submit(np.asarray(x, np.float32))
        # a copy: the received array is a read-only view of the frame
        recon = np.array(res.arrays[0], np.float32).reshape(x.shape)
        return recon, float(res.bits_per_elem)

    def cleanup() -> dict:
        try:
            client.close()
        finally:
            asyncio.run_coroutine_threadsafe(server.close(), loop).result()
            stop_loop()
        if workers > 1:
            snap = server.metrics.snapshot()

            def val(name):
                s = snap.get(name, {}).get("series", [])
                return int(s[0]["value"]) if s else 0

            stats = {k: val(f"repro_dispatcher_{k}_total")
                     for k in ("routed_sessions", "worker_restarts",
                               "shed_sessions")}
            print(f"dispatcher: {stats['routed_sessions']} sessions routed, "
                  f"{stats['worker_restarts']} worker restarts, "
                  f"{stats['shed_sessions']} shed")
            return stats
        counters = server.counters
        print(f"cloud ticks: {counters.get('ticks', 0)} "
              f"(occupancy {counters.get('batch_occupancy_avg', 0.0):.2f}, "
              f"entropy calls {counters.get('entropy_calls', 0)}, "
              f"bpe {counters.get('bpe_avg', 0.0):.3f}, header cache "
              f"{counters.get('header_cache', {})})")
        return counters

    return host_roundtrip, cleanup


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
                    help="'loopback' streams every split tensor through "
                         "the framed transport over a localhost socket")
    ap.add_argument("--chunk-elems", type=int, default=1 << 16)
    ap.add_argument("--tick-ms", type=float, default=0.0,
                    help="cross-session batching tick window for the "
                         "loopback transport (0 = drain immediately; the "
                         "engine keeps one tensor in flight per boundary "
                         "crossing, so >0 only helps with several "
                         "engines sharing the worker)")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve Prometheus-text telemetry on this port "
                         "alongside the loopback CloudServer (0 = pick a "
                         "free one); needs --transport loopback")
    ap.add_argument("--workers", type=int, default=1,
                    help=">1 puts a session-affine Dispatcher over a "
                         "pool of in-process cloud workers (heartbeats, "
                         "crash restart, client-side retry); needs "
                         "--transport loopback")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="admission-control bound on concurrently open "
                         "sessions; saturated servers answer new streams "
                         "with a retryable BUSY error")
    ap.add_argument("--tls-cert", default=None, metavar="PEM",
                    help="serve the loopback transport over TLS with "
                         "this certificate (also pinned as the client "
                         "CA -- self-signed certs work)")
    ap.add_argument("--tls-key", default=None, metavar="PEM",
                    help="private key for --tls-cert (default: key is "
                         "in the cert PEM)")
    ap.add_argument("--secret", default=None,
                    help="require the authenticated HELLO handshake "
                         "with this shared secret")
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
    """Run the launcher; returns the loopback link's counters (the
    dispatcher's with ``--workers`` > 1), or None without the loopback
    transport."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.metrics_port is not None and args.transport != "loopback":
        ap.error("--metrics-port needs --transport loopback")
    if args.transport != "loopback":
        for flag, val in (("--workers", args.workers != 1),
                          ("--max-queue", args.max_queue is not None),
                          ("--tls-cert", args.tls_cert is not None),
                          ("--secret", args.secret is not None)):
            if val:
                ap.error(f"{flag} needs --transport loopback")
    elif not args.codec_levels:
        ap.error("--transport loopback needs --codec-levels")
    if args.workers < 1:
        ap.error("--workers must be >= 1")
    if args.tls_key is not None and args.tls_cert is None:
        ap.error("--tls-key needs --tls-cert")
    if args.workers > 1 and args.metrics_port is not None:
        ap.error("--metrics-port is per-worker; not supported with "
                 "--workers > 1 (scrape the dispatcher registry instead)")
    if args.trace is not None:
        from ..obs import configure_tracing
        configure_tracing(enabled=True, event_log_path=args.trace)
        print(f"stage tracing on: span log -> {args.trace}")

    from ..serving.engine import resolve_device

    device = resolve_device(args.device)
    cfg, params = make_model(args.arch, args.full, device)
    codec = codec_host_fn = cleanup = None
    if args.codec_levels:
        codec = _calibrate_warmup(cfg, params, args, device)
        if args.transport == "loopback":
            codec_host_fn, cleanup = _loopback_codec_fn(
                codec, args.chunk_elems, args.tick_ms,
                metrics_port=args.metrics_port,
                workers=args.workers, max_queue=args.max_queue,
                tls_cert=args.tls_cert, tls_key=args.tls_key,
                secret=args.secret)
            codec = None
    try:
        run(cfg, params, requests=args.requests, prompt_len=args.prompt_len,
            new_tokens=args.new_tokens, device=device, codec=codec,
            codec_host_fn=codec_host_fn)
        if args.codec_levels:
            from ..transport import bank_cache_stats
            print(f"codec bank cache: {bank_cache_stats()}")
    finally:
        link = cleanup() if cleanup is not None else None
    return link


if __name__ == "__main__":
    main()
