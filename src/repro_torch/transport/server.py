"""Cloud-side streaming server (asyncio).

Accepts one or more edge connections, demultiplexes interleaved tensor
sessions, and reconstructs split-layer tensors for the cloud half
(``tail_fn``).  The result arrays go back in a RESULT frame; a FEEDBACK
frame carries receiver-measured link throughput and queue depth for the
edge-side rate controller.

Two receive disciplines:

* **tick mode** (default, ``tick=TickConfig()``): arriving chunk frames
  only accumulate (deferred-mode :class:`TensorAssembler`); a bounded
  tick window (``max_wait_s`` / ``max_chunks``) then drains every
  pending chunk of every session -- across connections -- through ONE
  batched entropy call (:class:`~repro_torch.serving.batcher.DecodeBatcher`),
  and completed tensors finish + run ``tail_fn`` together.  Stream
  headers are parsed once per distinct (shape, rung) via a shared
  :class:`~repro_torch.core.codec.HeaderCache`.  Per-tick metrics land in
  :attr:`counters`.
* **per-session mode** (``tick=None``): the original path -- chunks
  entropy-decode on arrival so decode overlaps the transfer, one entropy
  call per session stream.

Hardening (see DESIGN.md, "Hardened scale-out serving"):

* **Admission control**: with ``max_queue`` set, a new HEADER arriving
  while ``max_queue`` sessions are already in flight is answered with a
  structured retryable BUSY error instead of accepted work the server
  would time out on; a draining server sheds with SHUTDOWN the same way.
* **Resumable sessions**: a connection that presented a resume token in
  its HELLO gets its in-flight sessions *parked* (not forgotten) on
  disconnect; a reconnect with the same token revives them, the HELLO
  ack reports the per-session frame seqs already received, and replayed
  frames dedup by seq -- so a mid-stream reconnect finishes bit-exactly.
* **Authentication / TLS**: ``secret`` requires an HMAC-authenticated
  HELLO before the first tensor frame; ``ssl`` wraps the listener.
* **Fault injection**: the per-connection writer routes through
  :func:`~repro_torch.transport.faultinject.wrap_writer` (role ``server``).

Backpressure is the transport's: frames are processed in arrival order
per connection and the server only reads more bytes once the previous
batch is handled, so a slow cloud propagates to TCP flow control and
ultimately to the edge's bounded send path.

Decode and tail computation run via ``asyncio.to_thread`` so heartbeats
and other connections stay responsive while numpy/torch work runs.  A
reconstruction is dequantized on the server's backend and returned to
numpy on the thread that made it, so no device tensor crosses threads.
"""

from __future__ import annotations

import asyncio
import hashlib
import hmac
import json
import logging
import time
from typing import Callable

import numpy as np

from ..core.backend import get_backend
from ..core.codec import HeaderCache
from ..obs.exposition import MetricsExposition
from ..obs.metrics import MetricsRegistry, default_registry
from ..obs.tracing import span
from ..serving.batcher import DecodeBatcher, TickConfig
from .errors import (E_BUSY, E_SHUTDOWN, E_UNAUTHORIZED, encode_error,
                     error_for_exception)
from .faultinject import FaultPlan, wrap_writer
from .framing import (FT_CHUNK, FT_END, FT_ERROR, FT_HEADER, FT_HELLO,
                      FT_METRICS, FT_PING, FT_RESULT, FrameReader,
                      FramingError, encode_frame, pack_arrays)
from .stream_codec import Feedback, TensorAssembler

log = logging.getLogger(__name__)

_DEFAULT_TICK = TickConfig()


def hello_auth(secret: str, token: str) -> str:
    """The HELLO auth proof: HMAC-SHA256 of the resume token under the
    shared secret (both sides compute it; with TLS on top the token is
    never observable to a third party either)."""
    return hmac.new(secret.encode(), token.encode(),
                    hashlib.sha256).hexdigest()


class _Session:
    __slots__ = ("assembler", "t_first", "decode_s", "seq", "obs_key",
                 "seen_seqs")

    def __init__(self, assembler: TensorAssembler,
                 obs_key: str = "") -> None:
        self.assembler = assembler
        self.t_first = time.perf_counter()
        self.decode_s = 0.0
        self.seq = 0
        self.obs_key = obs_key      # per-session metrics label value
        self.seen_seqs: set[int] = set()   # replay/duplicate dedup

    def touch(self) -> None:
        """Reset the latency clock on resume so feedback stats describe
        the live connection, not the outage."""
        self.t_first = time.perf_counter()


class _ConnState:
    """Per-connection mutable state (sessions, auth, shed set)."""

    __slots__ = ("writer", "conn_id", "sessions", "shed", "token", "authed")

    def __init__(self, writer, conn_id: int) -> None:
        self.writer = writer
        self.conn_id = conn_id
        self.sessions: dict[int, _Session] = {}
        self.shed: set[int] = set()     # session ids answered BUSY/SHUTDOWN
        self.token: str | None = None   # resume token from HELLO
        self.authed = False


class _Unauthorized(Exception):
    pass


class CloudServer:
    """``async with CloudServer(tail_fn=...) as srv: await srv.wait_closed()``

    ``tail_fn``: reconstruction -> ndarray (or list of ndarrays), the
    cloud half of the split network.  None echoes nothing back beyond
    what ``echo_features`` selects.
    ``echo_features``: prepend the reconstructed split-layer tensor to
    the RESULT arrays (used by the tests for the bit-exactness check and
    by the loopback serving transport).
    ``backend``: the quantizer backend reconstructions dequantize on --
    a name (``None`` or ``"cuda"``: the CUDA backend, which raises here
    where no card exists; ``"torch"``: the CPU reference) or a backend
    object.
    ``tick``: cross-session batching bounds; ``None`` selects the
    per-session decode-on-arrival path.
    ``header_cache``: share a :class:`HeaderCache` across servers of one
    worker (a fresh one is made per server otherwise).
    ``max_queue``: admission bound -- new sessions beyond this many in
    flight are shed with a retryable BUSY error (None = accept all).
    ``secret``: require an HMAC-authenticated HELLO before the first
    tensor frame (see :func:`hello_auth`).
    ``ssl``: an ``ssl.SSLContext`` for the listener (TLS on the frame
    protocol; loopback worker pools skip it, edge-facing fronts use it).
    ``resume_ttl_s``: how long a disconnected connection's sessions stay
    parked awaiting a resume before being dropped.
    ``fault_plan``: explicit chaos plan for per-connection writers
    (tests); the ``REPRO_CHAOS`` env var reaches the same seam.
    ``metrics``: the :class:`MetricsRegistry` this server's
    ``repro_server_*`` / ``repro_decode_*`` instruments register in
    (fresh per server by default, so co-hosted servers and tests never
    share series).
    ``metrics_port``: when not None, :meth:`start` also serves a
    Prometheus-text ``GET /metrics`` endpoint (plus the tracer's JSON
    span log at ``/events``) on this port (0 = pick a free one; the
    bound port lands back in ``metrics_port``).
    """

    def __init__(self, *, tail_fn: Callable | None = None,
                 echo_features: bool = False, host: str = "127.0.0.1",
                 port: int = 0, backend=None,
                 tick: TickConfig | None = _DEFAULT_TICK,
                 header_cache: HeaderCache | None = None,
                 max_queue: int | None = None,
                 secret: str | None = None,
                 ssl=None,
                 resume_ttl_s: float = 30.0,
                 fault_plan: FaultPlan | None = None,
                 metrics: MetricsRegistry | None = None,
                 metrics_port: int | None = None) -> None:
        self.tail_fn = tail_fn
        self.echo_features = echo_features
        self.host = host
        self.port = port
        self._backend = get_backend(backend) \
            if backend is None or isinstance(backend, str) else backend
        self._server: asyncio.AbstractServer | None = None
        self.sessions_served = 0
        self.open_connections = 0
        self.tick = tick
        self.max_queue = max_queue
        self.secret = secret
        self.ssl_context = ssl
        self.resume_ttl_s = resume_ttl_s
        self._fault_plan = fault_plan
        self.draining = False
        self._idle = asyncio.Event()        # set whenever no work in flight
        self._idle.set()
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._batcher = DecodeBatcher(metrics=self.metrics)
        self._header_cache = (header_cache if header_cache is not None
                              else HeaderCache())
        # tensors whose END arrived, awaiting the tick drain:
        # (sess, session_id, writer, sessions-dict of their connection)
        self._ready: list[tuple] = []
        self._drain_lock = asyncio.Lock()
        self._drain_timer: asyncio.TimerHandle | None = None
        # decoder id -> (sessions-dict, session_id, writer): lets a drain
        # failure evict + notify exactly the offending session
        self._dec_owner: dict[int, tuple] = {}
        # resume token -> {"sessions": {sid: _Session}, "ready":
        # [(sess, sid)], "handle": expiry TimerHandle}
        self._parked: dict[str, dict] = {}
        self._inflight_sessions = 0
        self._conn_seq = 0
        self._conn_writers: set = set()
        self._aborted = False
        self.metrics_port = metrics_port
        self.metrics_exposition: MetricsExposition | None = None
        m = self.metrics
        self._m_sessions = m.counter("repro_server_sessions_served_total",
                                     "tensors fully served (tail + RESULT)")
        self._m_conns = m.gauge("repro_server_open_connections_count",
                                "currently connected edge clients")
        self._m_ticks = m.counter("repro_server_ticks_total",
                                  "cross-session tick drains")
        self._m_tick_sessions = m.counter(
            "repro_server_tick_sessions_total",
            "completed sessions summed over tick drains (occupancy "
            "numerator)")
        self._m_coded = m.counter("repro_server_coded_bytes_total",
                                  "entropy-coded payload bytes received")
        self._m_elems = m.counter("repro_server_decoded_elements_total",
                                  "tensor elements reconstructed")
        self._m_errors = m.counter(
            "repro_server_decode_errors_total",
            "sessions failed in decode/tail (or protocol errors)")
        self._m_queue = m.gauge(
            "repro_server_queue_depth_count",
            "sessions with pending work (undrained chunks + awaiting "
            "tail)")
        self._m_pending = m.gauge(
            "repro_server_session_pending_chunks_count",
            "entropy-undecoded chunks per in-flight session",
            labelnames=("session",))
        self._m_bpe = m.gauge(
            "repro_server_measured_bpe",
            "running wire bits/element over served tensors")
        self._m_hc_hits = m.gauge("repro_server_header_cache_hits_count",
                                  "header-cache hits")
        self._m_hc_misses = m.gauge(
            "repro_server_header_cache_misses_count",
            "header-cache misses (fresh header parses)")
        self._m_hc_entries = m.gauge(
            "repro_server_header_cache_entries_count",
            "distinct parsed headers cached")
        self._m_shed = m.counter(
            "repro_server_shed_sessions_total",
            "new sessions answered BUSY/SHUTDOWN by admission control")
        self._m_dups = m.counter(
            "repro_server_duplicate_frames_total",
            "replayed/duplicated frames dropped by per-session seq dedup")
        self._m_resumed = m.counter(
            "repro_server_resumed_sessions_total",
            "parked sessions revived by a resume HELLO")
        self._m_parked = m.gauge(
            "repro_server_parked_sessions_count",
            "sessions parked awaiting a resume reconnect")
        self._m_auth_fail = m.counter(
            "repro_server_auth_failures_total",
            "connections rejected at the HELLO auth check")

    def _sync_gauges(self) -> None:
        """Pull-style sources -> gauges (run per scrape / counters read)."""
        self._m_conns.set(self.open_connections)
        self._m_queue.set(self.queue_depth)
        self._m_parked.set(sum(
            len(p["sessions"]) + len(p["ready"])
            for p in self._parked.values()))
        hc = self._header_cache.stats
        self._m_hc_hits.set(hc["hits"])
        self._m_hc_misses.set(hc["misses"])
        self._m_hc_entries.set(hc["entries"])
        coded, elems = self._m_coded.value(), self._m_elems.value()
        self._m_bpe.set(8.0 * coded / max(elems, 1))

    async def start(self) -> "CloudServer":
        self._server = await asyncio.start_server(self._handle, self.host,
                                                  self.port,
                                                  ssl=self.ssl_context)
        self.port = self._server.sockets[0].getsockname()[1]
        log.info("cloud server listening on %s:%d%s", self.host, self.port,
                 " (TLS)" if self.ssl_context is not None else "")
        if self.metrics_port is not None:
            # the scrape sees this server's registry plus the worker-wide
            # default one (stage-latency histogram, bank cache)
            self.metrics_exposition = await MetricsExposition(
                [self.metrics, default_registry()],
                collectors=[self._sync_gauges], host=self.host,
                port=self.metrics_port).start()
            self.metrics_port = self.metrics_exposition.port
            log.info("metrics endpoint on %s:%d/metrics", self.host,
                     self.metrics_port)
        return self

    async def __aenter__(self) -> "CloudServer":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.close()

    async def close(self) -> None:
        if self._drain_timer is not None:
            self._drain_timer.cancel()
            self._drain_timer = None
        for token in list(self._parked):
            self._expire_parked(token)
        if self.metrics_exposition is not None:
            await self.metrics_exposition.close()
            self.metrics_exposition = None
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        for w in list(self._conn_writers):
            try:
                w.close()
            except Exception:                       # noqa: BLE001
                pass
        for _ in range(50):          # let handler tasks unwind before the
            if not self._conn_writers:      # caller tears down the loop
                break
            await asyncio.sleep(0.01)

    async def wait_closed(self) -> None:
        if self._server is not None:
            await self._server.serve_forever()

    def abort(self) -> None:
        """Hard-kill (chaos): drop every live connection and the
        listener with no ceremony -- the in-process equivalent of
        SIGKILLing a worker.  Parked sessions and timers die with it.
        Connections accepted by the OS whose handler task has not run
        yet are covered by the tombstone: ``_handle`` aborts them on
        entry, so nothing is served after the kill."""
        self._aborted = True
        for w in list(self._conn_writers):
            try:
                w.transport.abort()
            except Exception:                       # noqa: BLE001
                pass
        if self._drain_timer is not None:
            self._drain_timer.cancel()
            self._drain_timer = None
        for token in list(self._parked):
            self._expire_parked(token)
        if self.metrics_exposition is not None:
            exp, self.metrics_exposition = self.metrics_exposition, None
            try:
                loop = asyncio.get_running_loop()
                loop.create_task(exp.close())
            except RuntimeError:
                pass
        if self._server is not None:
            self._server.close()
            self._server = None

    # -- graceful drain --------------------------------------------------------

    @property
    def load(self) -> int:
        """Sessions with unfinished work: streaming, awaiting the tick
        drain, or parked for resume (the admission-control signal)."""
        return self._inflight_sessions

    @property
    def queue_depth(self) -> int:
        """Decode-stage backlog right now: sessions parked in the batcher
        plus drained-but-unfinished ones.  This is the tick-drain depth
        exported as ``repro_server_queue_depth_count`` -- the saturation
        signal a front-end (``transport.dispatcher``) polls to shed
        dynamically."""
        return self._batcher.pending_sessions + len(self._ready)

    async def drain(self, timeout_s: float = 10.0) -> bool:
        """Planned shutdown, phase 1: stop admitting new sessions (they
        get a retryable SHUTDOWN error) and wait for in-flight ones to
        finish.  Returns True when the server went idle inside the
        timeout.  Call :meth:`close` afterwards either way."""
        self.draining = True
        if self._inflight_sessions == 0:
            return True
        self._idle.clear()
        try:
            await asyncio.wait_for(self._idle.wait(), timeout_s)
            return True
        except asyncio.TimeoutError:
            return False

    def _session_opened(self) -> None:
        self._inflight_sessions += 1
        self._idle.clear()

    def _session_closed(self) -> None:
        self._inflight_sessions = max(0, self._inflight_sessions - 1)
        if self._inflight_sessions == 0:
            self._idle.set()

    @property
    def counters(self) -> dict:
        """Legacy dict view of the ``repro_server_*`` / ``repro_decode_*``
        registry instruments (the tick=None shape is pinned by
        tests/test_batcher.py; registry-only telemetry such as
        decode-error counts on the legacy path lives in
        :attr:`metrics`)."""
        self._sync_gauges()
        c = {"sessions_served": self.sessions_served,
             "open_connections": self.open_connections}
        if self.tick is None:
            return c
        b = self._batcher.counters
        ticks = int(self._m_ticks.value())
        c.update(
            ticks=ticks,
            batch_occupancy_avg=(self._m_tick_sessions.value()
                                 / max(ticks, 1)),
            queue_depth=int(self._m_queue.value()),
            entropy_calls=b["entropy_calls"],
            entropy_chunks=b["chunks"],
            entropy_melem_per_s=(b["elems"] / b["entropy_s"] / 1e6
                                 if b["entropy_s"] > 0 else 0.0),
            bpe_avg=self._m_bpe.value(),
            decode_errors=int(self._m_errors.value()),
            header_cache=self._header_cache.stats,
            shed_sessions=int(self._m_shed.value()),
            resumed_sessions=int(self._m_resumed.value()),
            duplicate_frames=int(self._m_dups.value()),
        )
        return c

    # -- connection handling --------------------------------------------------

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        if self._aborted:
            # connection accepted before abort() but handled after: a
            # SIGKILL'd worker would never have served it, so don't
            writer.transport.abort()
            return
        peer = writer.get_extra_info("peername")
        log.info("edge connected: %s", peer)
        self.open_connections += 1
        self._conn_seq += 1
        writer = wrap_writer(writer, "server", self._fault_plan)
        self._conn_writers.add(writer)
        conn = _ConnState(writer, self._conn_seq)
        frames = FrameReader()
        try:
            while True:
                data = await reader.read(1 << 16)
                if not data:
                    break
                frames.feed(data)
                for frame in frames:
                    if frame.ftype == FT_PING:
                        writer.write(encode_frame(FT_PING, frame.session,
                                                  frame.seq, frame.payload))
                        await writer.drain()
                    elif frame.ftype == FT_HELLO:
                        await self._on_hello(frame, conn)
                    elif frame.ftype in (FT_HEADER, FT_CHUNK, FT_END):
                        if self.secret is not None and not conn.authed:
                            raise _Unauthorized(
                                "tensor frame before authenticated HELLO")
                        await self._on_tensor_frame(frame, conn)
                    elif frame.ftype == FT_METRICS:
                        await self._send_metrics(writer, frame.session)
                    else:
                        raise FramingError(
                            f"unexpected frame type {frame.ftype} from edge")
        except _Unauthorized as e:
            self._m_auth_fail.inc()
            log.warning("unauthorized connection from %s: %s", peer, e)
            await self._send_error(writer, 0, e, code=E_UNAUTHORIZED,
                                   retryable=False)
            await self._linger(reader)
        except (FramingError, ValueError) as e:
            self._m_errors.inc()
            log.error("protocol error from %s: %s", peer, e)
            await self._send_error(writer, 0, e)
            await self._linger(reader)
        except ConnectionError:
            pass
        finally:
            self.open_connections -= 1
            self._conn_writers.discard(writer)
            if conn.token is not None and (conn.sessions or any(
                    e[2] is writer for e in self._ready)):
                self._park_connection(conn)
            else:
                self._forget_connection(conn.sessions, writer)
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, RuntimeError):
                pass    # loop already torn down during process shutdown
            log.info("edge disconnected: %s", peer)

    @staticmethod
    async def _linger(reader: asyncio.StreamReader,
                      timeout_s: float = 1.0) -> None:
        """After a terminal error frame, keep draining (and discarding)
        inbound bytes briefly instead of closing at once -- closing while
        the peer is still mid-write triggers a TCP RST that can flush the
        error frame out of the peer's receive buffer before it reads it.
        """
        async def drain() -> None:
            while await reader.read(1 << 16):
                pass

        try:
            await asyncio.wait_for(drain(), timeout_s)
        except (asyncio.TimeoutError, ConnectionError):
            pass

    # -- HELLO: auth + resume --------------------------------------------------

    async def _on_hello(self, frame, conn: _ConnState) -> None:
        try:
            hello = json.loads(frame.payload.decode())
            token = str(hello.get("token", ""))
        except (ValueError, UnicodeDecodeError) as e:
            raise _Unauthorized(f"malformed HELLO: {e}") from e
        if self.secret is not None:
            proof = str(hello.get("auth", ""))
            if not token or not hmac.compare_digest(
                    proof, hello_auth(self.secret, token)):
                raise _Unauthorized("HELLO auth rejected")
        conn.authed = True
        conn.token = token or None
        resumed: list[int] = []
        acked: dict[str, list[int]] = {}
        parked = self._parked.pop(token, None) if token else None
        if parked is not None:
            parked["handle"].cancel()
            for sid, sess in parked["sessions"].items():
                conn.sessions[sid] = sess
                sess.touch()
                resumed.append(sid)
                acked[str(sid)] = sorted(sess.seen_seqs)
                dec = sess.assembler.decoder
                if dec is not None:
                    self._dec_owner[id(dec)] = (conn.sessions, sid,
                                                conn.writer)
            for sess, sid in parked["ready"]:
                self._ready.append((sess, sid, conn.writer, conn.sessions))
                resumed.append(sid)
                acked[str(sid)] = sorted(sess.seen_seqs)
            self._m_resumed.inc(len(resumed))
            log.info("resumed %d parked session(s) for token %s...",
                     len(resumed), token[:8])
        ack = json.dumps({"ok": True, "resumed": sorted(resumed),
                          "acked": acked}).encode()
        try:
            conn.writer.write(encode_frame(FT_HELLO, frame.session,
                                           frame.seq, ack))
            await conn.writer.drain()
        except (ConnectionError, RuntimeError):
            return
        # a revived complete session may be the only pending work: make
        # sure a tick drain is scheduled even if every replayed frame
        # dedups away
        if self.tick is not None and parked is not None and self._ready:
            self._arm_drain_timer()

    # -- admission -------------------------------------------------------------

    async def _admit(self, frame, conn: _ConnState) -> bool:
        """Admission check for a new session's HEADER.  False = shed
        (a structured retryable error was sent)."""
        if self.draining:
            code, msg = E_SHUTDOWN, "server draining, not accepting sessions"
        elif self.max_queue is not None and self.load >= self.max_queue:
            code, msg = E_BUSY, (f"queue full ({self.load} sessions in "
                                 f"flight >= max_queue={self.max_queue})")
        else:
            return True
        conn.shed.add(frame.session)
        self._m_shed.inc()
        await self._send_error(conn.writer, frame.session, msg, code=code,
                               retryable=True)
        return False

    def _dedup(self, frame, sess: _Session) -> bool:
        """True when this frame was already processed (replay after a
        resume, or a fault-injected duplicate)."""
        if frame.seq in sess.seen_seqs:
            self._m_dups.inc()
            return True
        return False

    async def _on_tensor_frame(self, frame, conn: _ConnState) -> None:
        if frame.session in conn.shed:
            if frame.ftype == FT_END:
                conn.shed.discard(frame.session)   # stream over, forget it
            return
        if self.tick is None:
            await self._on_tensor_frame_immediate(frame, conn)
            return
        sessions, writer = conn.sessions, conn.writer
        sess = sessions.get(frame.session)
        if sess is None:
            if frame.ftype == FT_HEADER and not await self._admit(frame,
                                                                  conn):
                return
            sess = sessions[frame.session] = _Session(
                TensorAssembler(backend=self._backend, defer=True,
                                header_cache=self._header_cache),
                obs_key=f"{conn.conn_id}:{frame.session}")
            self._session_opened()
        if self._dedup(frame, sess):
            return
        t0 = time.perf_counter()
        # deferred mode: no entropy work here, just buffering -- cheap
        # enough to run on-loop
        sess.assembler.feed(frame)
        sess.seen_seqs.add(frame.seq)
        sess.decode_s += time.perf_counter() - t0
        dec = sess.assembler.decoder
        if dec is not None:
            self._batcher.note(dec)
            self._m_pending.set(dec.pending_chunks, session=sess.obs_key)
            if id(dec) not in self._dec_owner:
                self._dec_owner[id(dec)] = (sessions, frame.session, writer)
        if sess.assembler.ready:
            del sessions[frame.session]
            self._ready.append((sess, frame.session, writer, sessions))
        if (len(self._ready) >= self.tick.max_batch
                or self._batcher.pending_chunks >= self.tick.max_chunks
                # a session is complete and no entropy work is queued:
                # nothing could batch with it, so waiting out the tick
                # window would be pure latency (hit after a max_chunks
                # mid-stream drain already flushed the chunks)
                or (self._ready and self._batcher.pending_chunks == 0)):
            await self._drain_tick()
        elif self._ready or self._batcher.pending_sessions:
            self._arm_drain_timer()

    def _arm_drain_timer(self) -> None:
        if self._drain_timer is not None:
            return
        loop = asyncio.get_running_loop()
        self._drain_timer = loop.call_later(
            self.tick.max_wait_s,
            lambda: loop.create_task(self._drain_tick()))

    async def _drain_tick(self) -> None:
        async with self._drain_lock:
            if self._drain_timer is not None:
                self._drain_timer.cancel()
                self._drain_timer = None
            ready, self._ready = self._ready, []
            if not ready and not self._batcher.pending_sessions:
                return
            with span("tick_drain", sessions=len(ready)):
                # ONE batched entropy pass over every pending chunk of
                # every session, across connections
                failures = await asyncio.to_thread(self._batcher.drain)
                for dec, exc in failures:
                    await self._evict_decoder(dec, exc)
                    kept = []
                    for e in ready:
                        if e[0].assembler.decoder is dec:
                            self._m_pending.remove(session=e[0].obs_key)
                            self._session_closed()
                        else:
                            kept.append(e)
                    ready = kept
                outs = await asyncio.to_thread(self._finish_ready,
                                               [e[0] for e in ready])
                self._m_ticks.inc()
                self._m_tick_sessions.inc(len(ready))
                for (sess, session_id, writer, sessions), out \
                        in zip(ready, outs):
                    dec = sess.assembler.decoder
                    self._dec_owner.pop(id(dec), None)
                    self._m_pending.remove(session=sess.obs_key)
                    self._session_closed()
                    if isinstance(out, Exception):
                        self._m_errors.inc()
                        await self._send_error(writer, session_id, out)
                        continue
                    arrays, work_s = out
                    sess.decode_s += work_s
                    self.sessions_served += 1
                    self._m_sessions.inc()
                    self._m_coded.inc(sess.assembler.chunk_bytes)
                    self._m_elems.inc(sess.assembler.n_elems)
                    await self._send_result(sess, session_id, writer,
                                            sessions, arrays)
            self._m_queue.set(self._batcher.pending_sessions
                              + len(self._ready))

    def _finish_ready(self, sesses: list[_Session]) -> list:
        """Reconstruct + run ``tail_fn`` for each drained session (worker
        thread; entropy is already done, so finish() is dequantize +
        reshape).  A per-session exception is returned in place so one
        bad stream cannot sink its tickmates."""
        outs = []
        for sess in sesses:
            t0 = time.perf_counter()
            try:
                tensor = sess.assembler.finish()
                arrays = [tensor] if self.echo_features else []
                if self.tail_fn is not None:
                    with span("tail", session=sess.obs_key):
                        out = self.tail_fn(tensor)
                    arrays.extend(out if isinstance(out, (list, tuple))
                                  else [out])
                outs.append((arrays, time.perf_counter() - t0))
            except Exception as e:                  # noqa: BLE001
                outs.append(e)
        return outs

    async def _evict_decoder(self, dec, exc) -> None:
        """A decoder failed the batched drain: evict + notify exactly
        that session, leave its tickmates untouched."""
        self._m_errors.inc()
        self._batcher.discard(dec)
        owner = self._dec_owner.pop(id(dec), None)
        if owner is None:
            return
        sessions, session_id, writer = owner
        gone = sessions.pop(session_id, None)
        if gone is not None:
            self._m_pending.remove(session=gone.obs_key)
            self._session_closed()
        log.error("decode failed for session %d: %s", session_id, exc)
        await self._send_error(writer, session_id, exc)

    async def _send_metrics(self, writer, session_id: int) -> None:
        """On-demand telemetry snapshot over the frame protocol: the edge
        sends an empty METRICS frame, the cloud replies with a JSON
        payload (never tensor bytes -- codec streams are untouched)."""
        self._sync_gauges()
        payload = json.dumps({
            "counters": self.counters,
            "metrics": self.metrics.snapshot(),
        }).encode()
        try:
            writer.write(encode_frame(FT_METRICS, session_id, 0, payload))
            await writer.drain()
        except (ConnectionError, RuntimeError):
            pass

    async def _send_error(self, writer, session_id: int, exc,
                          code: int | None = None,
                          retryable: bool | None = None) -> None:
        if code is None:
            code, retryable = error_for_exception(
                exc if isinstance(exc, BaseException)
                else RuntimeError(str(exc)))
        payload = encode_error(code, str(exc), retryable=retryable)
        try:
            writer.write(encode_frame(FT_ERROR, session_id, 0, payload))
            await writer.drain()
        except (ConnectionError, RuntimeError):
            pass

    async def _send_result(self, sess: _Session, session_id: int, writer,
                           sessions, arrays) -> None:
        elapsed = max(time.perf_counter() - sess.t_first, 1e-9)
        fb = Feedback(
            recv_bytes_per_s=sess.assembler.chunk_bytes / elapsed,
            decode_s=sess.decode_s,
            queue_depth=len(sessions),
            active_sessions=len(sessions),
        )
        # FEEDBACK goes out *before* RESULT: the client resolves the
        # session on RESULT, so in-order delivery guarantees the submit
        # sees its own link stats
        try:
            with span("socket_write", session=sess.obs_key):
                writer.write(fb.encode(session_id, sess.seq))
                writer.write(encode_frame(FT_RESULT, session_id,
                                          sess.seq + 1,
                                          pack_arrays([np.asarray(a)
                                                       for a in arrays])))
                await writer.drain()
        except (ConnectionError, RuntimeError):
            pass

    # -- disconnect: park (resumable) or forget --------------------------------

    def _park_connection(self, conn: _ConnState) -> None:
        """Connection with a resume token died: keep its sessions for
        ``resume_ttl_s`` so a reconnect can finish them bit-exactly.
        In-flight decoders stay registered with the batcher (their chunks
        may drain while parked; dedup skips them on replay)."""
        ready_mine, kept = [], []
        for entry in self._ready:
            if entry[2] is conn.writer:
                ready_mine.append((entry[0], entry[1]))
            else:
                kept.append(entry)
        self._ready = kept
        for sess in conn.sessions.values():
            dec = sess.assembler.decoder
            if dec is not None:
                self._dec_owner.pop(id(dec), None)
        loop = asyncio.get_running_loop()
        token = conn.token
        self._parked[token] = {
            "sessions": dict(conn.sessions),
            "ready": ready_mine,
            "handle": loop.call_later(self.resume_ttl_s,
                                      self._expire_parked, token),
        }
        conn.sessions.clear()
        self._cancel_idle_drain_timer()
        log.info("parked %d session(s) for token %s... (ttl %.1fs)",
                 len(self._parked[token]["sessions"]) + len(ready_mine),
                 token[:8], self.resume_ttl_s)

    def _expire_parked(self, token: str) -> None:
        parked = self._parked.pop(token, None)
        if parked is None:
            return
        parked["handle"].cancel()
        for sess in parked["sessions"].values():
            self._forget_session(sess)
        for sess, _sid in parked["ready"]:
            self._forget_session(sess)
        log.info("resume ttl expired for token %s...: dropped %d "
                 "session(s)", token[:8],
                 len(parked["sessions"]) + len(parked["ready"]))

    def _forget_connection(self, sessions, writer) -> None:
        """Connection gone (no resume token): unregister its in-flight
        decoders from the batcher so the next drain only sees live
        sessions, release their obs series, and disarm a drain timer
        that no longer has work behind it."""
        for sess in sessions.values():
            self._forget_session(sess)
        sessions.clear()
        kept = []
        for entry in self._ready:
            if entry[2] is writer:
                self._forget_session(entry[0])
            else:
                kept.append(entry)
        self._ready = kept
        self._cancel_idle_drain_timer()

    def _cancel_idle_drain_timer(self) -> None:
        """Disarm the tick timer when the dying connection was the only
        work source -- otherwise it fires into an empty batcher after the
        server may already be closing."""
        if (self._drain_timer is not None and not self._ready
                and not self._batcher.pending_sessions):
            self._drain_timer.cancel()
            self._drain_timer = None

    def _forget_session(self, sess: _Session) -> None:
        dec = sess.assembler.decoder
        if dec is not None:
            self._batcher.discard(dec)
            self._dec_owner.pop(id(dec), None)
        if sess.obs_key:
            self._m_pending.remove(session=sess.obs_key)
        self._session_closed()

    # -- per-session (tick=None) path -----------------------------------------

    async def _on_tensor_frame_immediate(self, frame,
                                         conn: _ConnState) -> None:
        sessions, writer = conn.sessions, conn.writer
        sess = sessions.get(frame.session)
        if sess is None:
            if frame.ftype == FT_HEADER and not await self._admit(frame,
                                                                  conn):
                return
            sess = sessions[frame.session] = _Session(
                TensorAssembler(backend=self._backend,
                                header_cache=self._header_cache),
                obs_key=f"{conn.conn_id}:{frame.session}")
            self._session_opened()
        if self._dedup(frame, sess):
            return
        t0 = time.perf_counter()
        tensor = await asyncio.to_thread(sess.assembler.feed, frame)
        sess.seen_seqs.add(frame.seq)
        sess.decode_s += time.perf_counter() - t0
        if tensor is None:
            return
        del sessions[frame.session]
        self._session_closed()
        self.sessions_served += 1
        self._m_sessions.inc()
        self._m_coded.inc(sess.assembler.chunk_bytes)
        self._m_elems.inc(sess.assembler.n_elems)
        arrays = [tensor] if self.echo_features else []
        if self.tail_fn is not None:
            t0 = time.perf_counter()
            out = await asyncio.to_thread(self.tail_fn, tensor)
            sess.decode_s += time.perf_counter() - t0
            arrays.extend(out if isinstance(out, (list, tuple)) else [out])
        await self._send_result(sess, frame.session, writer, sessions,
                                arrays)
