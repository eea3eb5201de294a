"""Two-process split inference over a real socket (the paper's system),
the port of the reference's ``examples/edge_cloud_demo.py``.

The *edge* process runs the front half of the network
(``forward_head``), compresses the split-layer activations with the
calibrated codec, and streams them -- framed, chunked, entropy-coded --
to the *cloud* process, which incrementally decodes each chunk as it
arrives, reconstructs the tensor, and runs the back half
(``forward_from_boundary``).  Both processes build identical parameters
from the same seed (an explicit ``torch.Generator``), standing in for a
deployed model copy.

Checks printed per session:

  * cloud-side reconstruction is **bit-exact** with the in-process
    ``codec.decode(codec.encode(x))`` round trip (the wire adds framing,
    not noise);
  * cloud logits match the edge running its own tail on that
    reconstruction (the two halves really compute the full network);
  * wire bits/element vs the 16-bit raw transfer.

Multiple sessions are submitted concurrently over one connection to
exercise the frame-level multiplexing.  On the card (``--device cuda``,
the default) the edge's stream encode runs on the device -- the encode
megakernel and the device rANS step loop (``REPRO_ENTROPY_DEVICE=1``
for the edge's run) -- and the cloud dequantizes there.

Run:  python -m repro_torch.examples.edge_cloud_demo [--smoke]
[--device cpu] (spawns the cloud half itself; or run --role cloud /
--role edge in two terminals with a fixed --port).  ``--tls [--secret
S]`` runs the link over TLS with a throwaway self-signed cert and the
authenticated HELLO handshake; split-role runs pass
``--tls-cert/--tls-key`` explicitly.
"""

import argparse
import asyncio
import contextlib
import dataclasses
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from . import codec_backend

# the directory holding the package, for the cloud child's import path
_SRC = str(Path(__file__).resolve().parents[2])


def build_model(args):
    """(config, params): reduced codeqwen1.5-7b at 4 layers, vocabulary
    256 and ``--d-model``, drawn on ``--device`` from ``--seed``."""
    from ..configs import get_config, reduced
    from ..models import init_params, resolve_device

    device = resolve_device(args.device)
    cfg = dataclasses.replace(reduced(get_config("codeqwen1.5-7b")),
                              num_layers=4, vocab_size=256,
                              d_model=args.d_model)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    return cfg, init_params(cfg, gen, device=device)


def _server_ssl(args):
    if not args.tls_cert:
        return None
    import ssl
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(args.tls_cert, args.tls_key or args.tls_cert)
    return ctx


def _client_ssl(args):
    if not args.tls_cert:
        return None
    import ssl
    # self-signed deployment: the cert itself is the pinned CA
    ctx = ssl.create_default_context(cafile=args.tls_cert)
    ctx.check_hostname = False
    return ctx


def _tail(cfg, params, recon: np.ndarray, device) -> np.ndarray:
    """The cloud half on a reconstruction: float32 logits on the host."""
    from ..models import forward_from_boundary

    with torch.inference_mode():
        logits = forward_from_boundary(
            cfg, params, torch.as_tensor(recon, device=device))
    return logits.to(torch.float32).cpu().numpy()


def run_cloud(args, model=None) -> None:
    """Cloud half: decode streamed features, run the tail, reply.
    ``model``: (cfg, params), by default :func:`build_model`'s."""
    from ..models import resolve_device
    from ..obs import configure_tracing, tracer
    from ..transport import CloudServer

    device = resolve_device(args.device)
    cfg, params = model if model is not None else build_model(args)
    if args.obs_events:
        configure_tracing(enabled=True)

    def tail_fn(feats):
        return [_tail(cfg, params, feats, device)]

    async def main():
        server = CloudServer(tail_fn=tail_fn, echo_features=True,
                             port=args.port, backend=codec_backend(device),
                             metrics_port=args.metrics_port,
                             ssl=_server_ssl(args), secret=args.secret)
        await server.start()
        hardened = "".join([" TLS" if args.tls_cert else "",
                            " auth" if args.secret else ""])
        print(f"[cloud] serving on 127.0.0.1:{server.port}"
              f"{' (' + hardened.strip() + ')' if hardened else ''}",
              flush=True)
        if server.metrics_port is not None:
            print(f"[cloud] metrics on "
                  f"http://127.0.0.1:{server.metrics_port}/metrics",
                  flush=True)
        # exit once every session is served AND the edge has disconnected
        # (its disconnect confirms it received all results)
        while True:
            await asyncio.sleep(0.2)
            if server.sessions_served >= args.sessions \
                    and server.open_connections == 0:
                break
        await server.close()
        print(f"[cloud] done: {server.sessions_served} sessions", flush=True)

    asyncio.run(main())
    if args.obs_events:
        path = args.obs_events + ".cloud.json"
        tracer().dump_events(path)
        print(f"[cloud] span log -> {path}", flush=True)


def run_edge(args, model=None) -> dict:
    """Edge half: model head + calibrated codec, streamed submission.
    ``model``: (cfg, params), by default :func:`build_model`'s.  Returns
    each session's wire bits/element and checks, and the wall time."""
    from ..core import CodecConfig, calibrate
    from ..models import forward_head, resolve_device
    from ..obs import configure_tracing, tracer
    from ..serving.batcher import device_entropy
    from ..transport import EdgeClient

    if args.obs_events:
        configure_tracing(enabled=True)

    device = resolve_device(args.device)
    cfg, params = model if model is not None else build_model(args)
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, cfg.vocab_size,
                            size=(args.batch, args.seq)).astype(np.int32)
               for _ in range(args.sessions)]
    with torch.inference_mode():
        feats = [forward_head(cfg, params, torch.as_tensor(b, device=device))
                 .to(torch.float32).cpu().numpy() for b in batches]

    # "tile2d": (row x column) tiles over the (batch, seq) grid of the
    # split tensor -- every session shares the shape, so the 2-D extent
    # pin holds and the stream ships the v4 header
    grain = "tile" if args.granularity == "tile2d" else args.granularity
    codec = calibrate(
        CodecConfig(n_levels=args.levels, clip_mode="empirical",
                    constrain_cmin_zero=False,
                    granularity=grain, channel_axis=-1,
                    channel_group_size=8,
                    spatial_block_hw=(1, 8)
                    if args.granularity == "tile2d" else None,
                    backend=codec_backend(device)),
        samples=feats[0])
    print(f"[edge] split tensor {feats[0].shape}, codec N={args.levels} "
          f"granularity={args.granularity}", flush=True)

    async def main():
        async with EdgeClient("127.0.0.1", args.port, codec=codec,
                              chunk_elems=args.chunk_elems,
                              ssl=_client_ssl(args),
                              secret=args.secret) as client:
            t0 = time.perf_counter()
            results = await asyncio.gather(
                *[client.submit(f) for f in feats])
            wall = time.perf_counter() - t0
            if args.metrics_port:
                await check_metrics(args, client)
        ok = True
        sessions = []
        for i, (f, res) in enumerate(zip(feats, results)):
            recon_cloud = np.asarray(res.arrays[0], np.float32) \
                .reshape(f.shape)
            recon_local = np.asarray(
                codec.decode(codec.encode(f), shape=f.shape), np.float32)
            bitexact = np.array_equal(recon_cloud, recon_local)
            logits_cloud = np.asarray(res.arrays[1], np.float32)
            logits_local = _tail(cfg, params, recon_local, device)
            logits_ok = np.allclose(logits_cloud, logits_local,
                                    rtol=1e-4, atol=1e-4)
            ok &= bitexact and logits_ok
            sessions.append({
                "bits_per_elem": float(res.bits_per_elem),
                "bitexact": bool(bitexact), "logits_match": bool(logits_ok),
                "logits_max_abs_diff": float(np.max(np.abs(
                    logits_cloud - logits_local)))})
            print(f"[edge] session {i}: bits/elem={res.bits_per_elem:.3f} "
                  f"(vs 16.0 raw) reconstruction bit-exact={bitexact} "
                  f"tail logits match={logits_ok}", flush=True)
        print(f"[edge] {len(results)} concurrent sessions in {wall:.2f}s",
              flush=True)
        if not ok:
            raise SystemExit("MISMATCH: streamed reconstruction or tail "
                             "diverged from the in-process path")
        print("[edge] OK: streamed cloud reconstruction is bit-exact with "
              "in-process encode/decode", flush=True)
        return {"sessions": sessions, "wall_s": wall}

    # the stream encode's device route on the card
    with device_entropy() if device.type == "cuda" \
            else contextlib.nullcontext():
        out = asyncio.run(main())
    if args.obs_events:
        tracer().dump_events(args.obs_events)
        print(f"[edge] span log -> {args.obs_events}", flush=True)
    return out


async def check_metrics(args, client):
    """Scrape the cloud's /metrics endpoint while the session is live and
    assert the exposition is parseable + carries the expected
    instruments; also exercise the in-band FT_METRICS snapshot."""
    import urllib.request

    from ..obs import parse_prometheus_text

    url = f"http://127.0.0.1:{args.metrics_port}/metrics"
    text = await asyncio.to_thread(
        lambda: urllib.request.urlopen(url, timeout=5).read().decode())
    families = parse_prometheus_text(text)   # raises on malformed lines
    required = [
        "repro_server_sessions_served_total",
        "repro_server_ticks_total",
        "repro_server_coded_bytes_total",
        "repro_server_measured_bpe",
        "repro_server_header_cache_hits_count",
        "repro_decode_entropy_calls_total",
        "repro_bank_cache_hits_total",
    ]
    missing = [n for n in required if n not in families]
    if missing:
        raise SystemExit(f"[edge] metrics scrape missing {missing}")
    snap = await client.fetch_cloud_metrics()
    served = snap["counters"]["sessions_served"]
    print(f"[edge] metrics scrape OK: {len(families)} families from {url}; "
          f"FT_METRICS snapshot says sessions_served={served}", flush=True)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--role", default="both",
                    choices=["both", "edge", "cloud"])
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--sessions", type=int, default=3)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--d-model", type=int, default=64)
    ap.add_argument("--levels", type=int, default=8)
    ap.add_argument("--granularity", default="channel",
                    choices=["tensor", "channel", "tile2d"],
                    help="'tile2d' codes (1, 8) row x column tiles over "
                         "the (batch, seq) grid -- v4 streams on the "
                         "wire")
    ap.add_argument("--chunk-elems", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="cloud serves Prometheus-text /metrics here and "
                         "the edge scrapes + validates it (0 with "
                         "--role both = pick a free port)")
    ap.add_argument("--obs-events", metavar="PATH", default=None,
                    help="enable stage tracing; dump the JSON span log "
                         "to PATH (edge) and PATH.cloud.json (cloud)")
    ap.add_argument("--tls", action="store_true",
                    help="--role both only: generate a throwaway "
                         "self-signed cert (openssl CLI) and run the "
                         "link over TLS")
    ap.add_argument("--tls-cert", default=None, metavar="PEM",
                    help="serve/dial TLS with this cert (the edge pins "
                         "it as the CA; use with split --role runs)")
    ap.add_argument("--tls-key", default=None, metavar="PEM",
                    help="private key for --tls-cert (default: key is "
                         "in the cert PEM)")
    ap.add_argument("--secret", default=None,
                    help="shared secret for the authenticated HELLO "
                         "handshake (both halves must agree)")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny sizes for CI")
    ap.add_argument("--device", default="cuda",
                    help="torch device both halves run on")
    return ap


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _self_signed_cert(args, cert_dir: str) -> None:
    args.tls_cert = f"{cert_dir}/cert.pem"
    args.tls_key = f"{cert_dir}/key.pem"
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048",
         "-nodes", "-keyout", args.tls_key, "-out", args.tls_cert,
         "-subj", "/CN=127.0.0.1",
         "-addext", "subjectAltName=IP:127.0.0.1", "-days", "2"],
        check=True, capture_output=True)
    print(f"[demo] generated self-signed cert: {args.tls_cert}", flush=True)


def wait_for_cloud(args, alive, timeout_s: float = 60.0) -> None:
    """Wait until the cloud listens on ``args.port`` (at most
    ``timeout_s``); ``alive()`` says whether its process still runs."""
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        try:
            probe = socket.create_connection(("127.0.0.1", args.port),
                                             timeout=0.2)
            if args.tls_cert:
                # complete a real handshake so the cloud's log stays
                # free of handshake-abort noise
                probe = _client_ssl(args).wrap_socket(probe)
            probe.close()
            return
        except OSError:
            if not alive():
                raise SystemExit("cloud process died during startup")
            time.sleep(0.3)


def run_both(args) -> int:
    """Both halves: the cloud as a child process, the edge here; the
    cloud's exit code."""
    if args.port == 0:
        args.port = _free_port()        # pick a free port for the pair
    if args.metrics_port == 0:
        # both halves need to agree on the scrape port up front
        args.metrics_port = _free_port()
    flags = [f"--port={args.port}", f"--sessions={args.sessions}",
             f"--batch={args.batch}", f"--seq={args.seq}",
             f"--d-model={args.d_model}", f"--levels={args.levels}",
             f"--granularity={args.granularity}",
             f"--chunk-elems={args.chunk_elems}",
             f"--seed={args.seed}", f"--device={args.device}"]
    if args.metrics_port is not None:
        flags.append(f"--metrics-port={args.metrics_port}")
    if args.obs_events:
        flags.append(f"--obs-events={args.obs_events}")
    if args.tls_cert:
        flags.append(f"--tls-cert={args.tls_cert}")
    if args.tls_key:
        flags.append(f"--tls-key={args.tls_key}")
    if args.secret:
        flags.append(f"--secret={args.secret}")
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONPATH=_SRC if not path
               else os.pathsep.join([_SRC, path]))
    cloud = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.examples.edge_cloud_demo",
         "--role=cloud"] + flags, env=env)
    try:
        wait_for_cloud(args, lambda: cloud.poll() is None)
        run_edge(args)
        cloud.wait(timeout=30)
    finally:
        if cloud.poll() is None:
            cloud.terminate()
            cloud.wait(10)
    return cloud.returncode


def main(argv=None) -> None:
    ap = build_parser()
    args = ap.parse_args(argv)
    cert_dir = None
    if args.tls:
        if args.role != "both":
            ap.error("--tls generates a per-run cert, so it needs "
                     "--role both; split roles pass --tls-cert/--tls-key")
        if args.tls_cert is None:
            cert_dir = tempfile.mkdtemp(prefix="edge_cloud_tls_")
            _self_signed_cert(args, cert_dir)
    if args.smoke:
        args.sessions, args.batch, args.seq, args.d_model = 2, 2, 16, 32
    try:
        if args.role == "cloud":
            run_cloud(args)
        elif args.role == "edge":
            run_edge(args)
        else:
            raise SystemExit(run_both(args))
    finally:
        if cert_dir is not None:
            shutil.rmtree(cert_dir, ignore_errors=True)


if __name__ == "__main__":
    main()
