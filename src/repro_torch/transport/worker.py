"""Standalone CloudServer worker process.

    python -m repro_torch.transport.worker [--backend cuda|torch] ...

The :class:`~repro_torch.transport.dispatcher.Dispatcher` spawns N of
these as subprocesses for real fault isolation (a worker SIGKILL cannot
take the front-end down).  The worker binds an ephemeral loopback
port, prints ``PORT <n>`` on stdout (the parent's only startup
handshake), then serves the ordinary frame protocol until killed.

``--tail module:attr`` resolves an importable callable to use as the
cloud-side ``tail_fn``; ``--echo`` echoes the reconstructed split-layer
tensor back (what the chaos tests use, since a closure can't cross a
process boundary).  ``--backend`` is the quantizer backend the worker
dequantizes on: ``cuda`` (the default; the worker raises at start where
no card exists) or ``torch`` (the CPU reference).
"""

from __future__ import annotations

import argparse
import asyncio
import importlib
import sys

from ..serving.batcher import TickConfig
from .server import CloudServer


def resolve_tail(spec: str):
    """``module:attr`` -> callable (the worker's ``tail_fn``)."""
    mod, _, attr = spec.partition(":")
    if not mod or not attr:
        raise SystemExit(f"--tail wants module:attr, got {spec!r}")
    fn = getattr(importlib.import_module(mod), attr)
    if not callable(fn):
        raise SystemExit(f"--tail target {spec!r} is not callable")
    return fn


def build_server(args: argparse.Namespace) -> CloudServer:
    return CloudServer(
        tail_fn=resolve_tail(args.tail) if args.tail else None,
        echo_features=args.echo,
        host=args.host, port=args.port, backend=args.backend,
        tick=None if args.no_tick else TickConfig(),
        max_queue=args.max_queue,
        secret=args.secret,
        resume_ttl_s=args.resume_ttl_s,
    )


async def amain(args: argparse.Namespace) -> None:
    server = await build_server(args).start()
    print(f"PORT {server.port}", flush=True)
    await server.wait_closed()


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0,
                   help="listen port (0 = ephemeral, printed on stdout)")
    p.add_argument("--backend", default="cuda", choices=["cuda", "torch"],
                   help="quantizer backend: cuda (the card) or torch "
                        "(the CPU reference)")
    p.add_argument("--echo", action="store_true",
                   help="echo the reconstructed tensor in RESULT")
    p.add_argument("--tail", default=None, metavar="MODULE:ATTR",
                   help="importable callable to run as the cloud tail")
    p.add_argument("--no-tick", action="store_true",
                   help="per-session decode instead of tick batching")
    p.add_argument("--max-queue", type=int, default=None,
                   help="admission bound (sessions in flight)")
    p.add_argument("--secret", default=None,
                   help="require an authenticated HELLO")
    p.add_argument("--resume-ttl-s", type=float, default=30.0,
                   help="how long disconnected sessions stay resumable")
    args = p.parse_args(argv)
    try:
        asyncio.run(amain(args))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main(sys.argv[1:])
