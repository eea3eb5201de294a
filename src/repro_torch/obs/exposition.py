"""Prometheus text-format exposition over a minimal asyncio HTTP server.

No web framework: the scrape protocol is one GET and one response.
Routes:

- ``GET /metrics``  -- Prometheus text format 0.0.4 rendering every
  registry handed to the exposition (duplicate families skipped).
- ``GET /events``   -- the tracer's structured JSON span log.
- ``GET /healthz``  -- liveness probe.

Also provides :func:`parse_prometheus_text`, a small parser that tests
use to assert the scrape is well-formed.
"""

from __future__ import annotations

import asyncio
import json
import re

from .metrics import render_registries
from .tracing import tracer as _default_tracer

__all__ = ["MetricsExposition", "parse_prometheus_text"]

_SAMPLE_RE = re.compile(
    r'^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)'
    r'(?:\{(?P<labels>[^}]*)\})?\s+(?P<value>\S+)\s*$')
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_prometheus_text(text: str) -> dict:
    """Parse exposition text into ``{family: {"type", "samples"}}``.

    Samples map ``(sample_name, frozenset(label items)) -> float``.
    Raises ValueError on a malformed line, so tests can assert the
    endpoint output is parseable.
    """
    families: dict[str, dict] = {}
    current = None
    for line in text.splitlines():
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            name = line.split(None, 3)[2]
            current = families.setdefault(
                name, {"type": "untyped", "samples": {}})
            continue
        if line.startswith("# TYPE "):
            parts = line.split()
            families.setdefault(
                parts[2], {"type": "untyped", "samples": {}})
            families[parts[2]]["type"] = parts[3]
            current = families[parts[2]]
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"malformed exposition line: {line!r}")
        labels = frozenset(_LABEL_RE.findall(m.group("labels") or ""))
        value = float(m.group("value").replace("+Inf", "inf")
                      .replace("-Inf", "-inf"))
        sample_name = m.group("name")
        family = sample_name
        for suffix in ("_bucket", "_sum", "_count"):
            base = sample_name[:-len(suffix)] \
                if sample_name.endswith(suffix) else None
            if base and base in families:
                family = base
                break
        fam = families.setdefault(
            family, {"type": "untyped", "samples": {}})
        fam["samples"][(sample_name, labels)] = value
        current = fam
    return families


class MetricsExposition:
    """Serve ``/metrics`` + ``/events`` for a set of registries."""

    def __init__(self, registries, tracer=None,
                 host: str = "127.0.0.1", port: int = 0,
                 collectors=()):
        self.registries = list(registries)
        self.tracer = tracer if tracer is not None else _default_tracer()
        self.host = host
        self.port = port
        # zero-arg callables run before each render: pull-style sources
        # (cache stats, queue depths) sync their gauges at scrape time
        self.collectors = list(collectors)
        self._server: asyncio.AbstractServer | None = None

    def render(self) -> str:
        for collect in self.collectors:
            collect()
        return render_registries(self.registries)

    async def start(self) -> "MetricsExposition":
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self

    async def close(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            request = await asyncio.wait_for(reader.readline(), timeout=5.0)
            parts = request.decode("latin-1", "replace").split()
            path = parts[1] if len(parts) >= 2 else "/"
            # drain (and ignore) the request headers
            while True:
                line = await asyncio.wait_for(reader.readline(), timeout=5.0)
                if line in (b"\r\n", b"\n", b""):
                    break
            if path.startswith("/metrics"):
                body = self.render().encode()
                ctype = "text/plain; version=0.0.4; charset=utf-8"
                status = "200 OK"
            elif path.startswith("/events"):
                body = json.dumps(
                    {"events": self.tracer.snapshot_events()}).encode()
                ctype = "application/json"
                status = "200 OK"
            elif path.startswith("/healthz"):
                body, ctype, status = b"ok\n", "text/plain", "200 OK"
            else:
                body, ctype, status = b"not found\n", "text/plain", \
                    "404 Not Found"
            writer.write((f"HTTP/1.1 {status}\r\n"
                          f"Content-Type: {ctype}\r\n"
                          f"Content-Length: {len(body)}\r\n"
                          "Connection: close\r\n\r\n").encode())
            writer.write(body)
            await writer.drain()
        except (asyncio.TimeoutError, ConnectionError):
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass
