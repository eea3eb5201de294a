"""Session-affine front-end over a pool of CloudServer workers.

The :class:`Dispatcher` owns the edge-facing listening socket (and its
TLS context + HELLO auth, so workers stay plain loopback) and routes
frames to N workers speaking the ordinary frame protocol:

* **Session affinity**: a session's HEADER picks the least-loaded
  healthy worker; every later frame of that session follows it.  Each
  edge connection gets its *own* upstream connection per worker, so
  worker-side session-id namespaces never collide across edges.
* **Health**: a per-worker heartbeat task sends FT_PING probes over a
  control connection; ``hb_misses`` consecutive misses (or a crashed
  subprocess) declare the worker dead, its in-flight sessions get a
  retryable ``WORKER_RESTART`` error (the client's retry path replays
  them onto a surviving worker), and the worker restarts with
  exponential backoff.
* **Admission**: with ``max_queue`` set, new sessions beyond that many
  in flight across the pool are shed with a retryable ``BUSY`` error;
  no healthy worker at all sheds the same way.  With ``shed_depth``
  set, admission additionally tracks the *decode-stage* saturation
  signal: the workers' tick-drain queue depth (the
  ``repro_server_queue_depth_count`` gauge, read live from in-process
  workers and polled over FT_METRICS for subprocesses).  When the
  pool-wide depth reaches ``shed_depth`` new sessions shed BUSY until
  it drains back below ``shed_resume_depth`` (hysteresis, so admission
  does not flap at the threshold).  ``max_queue`` stays as the static
  hard cap on in-flight sessions.
* **Resume**: the edge's HELLO is forwarded to every healthy worker and
  the acks merge, so sessions parked on any worker after an edge
  disconnect revive on reconnect, wherever they live.
* **Drain**: :meth:`drain` stops admitting (``SHUTDOWN`` errors, the
  client treats them as retryable) and waits for in-flight sessions to
  finish before :meth:`close`.

Workers are either **subprocesses** (``worker_cmd``, e.g.
``[sys.executable, "-m", "repro_torch.transport.worker", "--backend",
"torch", "--echo"]``, see :mod:`repro_torch.transport.worker`; real
SIGKILL isolation) or **in-process** CloudServers on loopback
ports (``worker_factory``; fast enough for tier-1 chaos tests).
:meth:`kill_worker` is the chaos hook either way.

Wire bytes through the dispatcher are byte-identical to a direct
connection: frames are re-emitted with the same type/session/seq/payload
and codec payloads are never touched.
"""

from __future__ import annotations

import asyncio
import hmac
import json
import logging
import signal
import subprocess
import time

from ..obs.metrics import MetricsRegistry
from .errors import (E_BUSY, E_PROTOCOL, E_SHUTDOWN, E_UNAUTHORIZED,
                     E_WORKER_RESTART, encode_error)
from .faultinject import FaultPlan, wrap_writer
from .framing import (FT_CHUNK, FT_END, FT_ERROR, FT_FEEDBACK, FT_HEADER,
                      FT_HELLO, FT_METRICS, FT_PING, FT_RESULT, FrameReader,
                      FramingError, encode_frame)
from .server import hello_auth

log = logging.getLogger(__name__)

_HELLO_MERGE_TIMEOUT_S = 3.0
_SPAWN_TIMEOUT_S = 60.0


class _Worker:
    __slots__ = ("idx", "port", "healthy", "misses", "restarts", "active",
                 "depth", "proc", "server", "hb_reader", "hb_writer",
                 "hb_frames", "hb_seq")

    def __init__(self, idx: int) -> None:
        self.idx = idx
        self.port: int | None = None
        self.healthy = False
        self.misses = 0
        self.restarts = 0          # lifetime restarts (drives backoff)
        self.active = 0            # sessions currently routed here
        self.depth = 0             # last observed decode-stage queue depth
        self.proc: subprocess.Popen | None = None
        self.server = None         # in-process CloudServer
        self.hb_reader = None
        self.hb_writer = None
        self.hb_frames: FrameReader | None = None
        self.hb_seq = 0


class _EdgeConn:
    """Per edge-connection routing state."""

    __slots__ = ("writer", "wlock", "session_worker", "upstreams", "pumps",
                 "hello_raw", "hello_waiters", "metrics_worker")

    def __init__(self, writer) -> None:
        self.writer = writer
        self.wlock = asyncio.Lock()
        self.session_worker: dict[int, int] = {}   # session id -> worker idx
        self.upstreams: dict[int, asyncio.StreamWriter] = {}
        self.pumps: dict[int, asyncio.Task] = {}
        self.hello_raw: bytes | None = None        # replayed on lazy opens
        self.hello_waiters: dict[int, asyncio.Future] = {}
        self.metrics_worker: int | None = None     # FT_METRICS affinity


class Dispatcher:
    """``async with Dispatcher(workers=4, worker_factory=...) as d: ...``

    Exactly one of ``worker_factory`` (``idx -> CloudServer``, unstarted,
    in-process) or ``worker_cmd`` (argv prefix for
    ``python -m repro_torch.transport.worker``-style subprocesses;
    ``--host`` / ``--port`` are appended) must be given.
    """

    def __init__(self, *, workers: int = 2,
                 worker_factory=None,
                 worker_cmd: list[str] | None = None,
                 host: str = "127.0.0.1", port: int = 0,
                 ssl=None, secret: str | None = None,
                 max_queue: int | None = None,
                 shed_depth: int | None = None,
                 shed_resume_depth: int | None = None,
                 hb_interval_s: float = 0.25,
                 hb_timeout_s: float = 1.0,
                 hb_misses: int = 3,
                 restart_backoff_s: float = 0.05,
                 restart_backoff_max_s: float = 2.0,
                 fault_plan_edge: FaultPlan | None = None,
                 fault_plan_upstream: FaultPlan | None = None,
                 metrics: MetricsRegistry | None = None) -> None:
        if (worker_factory is None) == (worker_cmd is None):
            raise ValueError("need exactly one of worker_factory or "
                             "worker_cmd")
        self._worker_factory = worker_factory
        self._worker_cmd = worker_cmd
        self.host, self.port = host, port
        self.ssl_context = ssl
        self.secret = secret
        self.max_queue = max_queue
        if shed_resume_depth is not None and shed_depth is not None \
                and shed_resume_depth >= shed_depth:
            raise ValueError("shed_resume_depth must be < shed_depth "
                             "(hysteresis band)")
        self.shed_depth = shed_depth
        self.shed_resume_depth = (shed_resume_depth
                                  if shed_resume_depth is not None
                                  else (max(0, shed_depth // 2)
                                        if shed_depth is not None else 0))
        self._shed_latched = False
        self.hb_interval_s = hb_interval_s
        self.hb_timeout_s = hb_timeout_s
        self.hb_misses = hb_misses
        self.restart_backoff_s = restart_backoff_s
        self.restart_backoff_max_s = restart_backoff_max_s
        self._fault_edge = fault_plan_edge
        self._fault_upstream = fault_plan_upstream
        self._workers = [_Worker(i) for i in range(workers)]
        self._server: asyncio.AbstractServer | None = None
        self._monitors: list[asyncio.Task] = []
        self._conns: set[_EdgeConn] = set()
        self._closing = False
        self.draining = False
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        m = self.metrics
        self._m_routed = m.counter("repro_dispatcher_routed_sessions_total",
                                   "sessions assigned to a worker")
        self._m_shed = m.counter(
            "repro_dispatcher_shed_sessions_total",
            "sessions answered BUSY/SHUTDOWN at the front-end")
        self._m_failed = m.counter(
            "repro_dispatcher_failed_sessions_total",
            "in-flight sessions failed by a worker death (sent a "
            "retryable WORKER_RESTART error)")
        self._m_restarts = m.counter("repro_dispatcher_worker_restarts_total",
                                     "worker processes/servers restarted")
        self._m_hb_miss = m.counter("repro_dispatcher_heartbeat_misses_total",
                                    "missed worker heartbeats")
        self._m_auth_fail = m.counter(
            "repro_dispatcher_auth_failures_total",
            "edge connections rejected at the HELLO auth check")
        self._m_active = m.gauge("repro_dispatcher_active_sessions_count",
                                 "sessions currently in flight via the pool")
        self._m_healthy = m.gauge("repro_dispatcher_healthy_workers_count",
                                  "workers currently passing heartbeats")
        self._m_depth = m.gauge(
            "repro_dispatcher_pool_queue_depth_count",
            "pool-wide decode-stage queue depth (sum of the workers' "
            "tick-drain backlog; drives the dynamic shed threshold)")
        self._m_shedding = m.gauge(
            "repro_dispatcher_shedding_count",
            "1 while the dynamic shed latch is engaged (depth crossed "
            "shed_depth and has not yet drained to shed_resume_depth)")

    # -- lifecycle -------------------------------------------------------------

    @property
    def active_sessions(self) -> int:
        return sum(w.active for w in self._workers)

    @property
    def healthy_workers(self) -> int:
        return sum(1 for w in self._workers if w.healthy)

    @property
    def pool_queue_depth(self) -> int:
        """Pool-wide decode-stage backlog.  In-process workers are read
        live (``CloudServer.queue_depth``); subprocess workers report the
        value the monitor last polled over FT_METRICS."""
        total = 0
        for w in self._workers:
            if not w.healthy:
                continue
            if w.server is not None:
                try:
                    w.depth = w.server.queue_depth
                except Exception:                   # noqa: BLE001
                    pass                            # mid-restart
            total += w.depth
        return total

    def _depth_shedding(self) -> bool:
        """Dynamic admission: latch BUSY when the decode stage saturates,
        release only once it drains below the resume threshold."""
        if self.shed_depth is None:
            return False
        depth = self.pool_queue_depth
        self._m_depth.set(depth)
        if self._shed_latched:
            if depth <= self.shed_resume_depth:
                self._shed_latched = False
        elif depth >= self.shed_depth:
            self._shed_latched = True
        self._m_shedding.set(1 if self._shed_latched else 0)
        return self._shed_latched

    def _sync_gauges(self) -> None:
        self._m_active.set(self.active_sessions)
        self._m_healthy.set(self.healthy_workers)

    async def start(self) -> "Dispatcher":
        await asyncio.gather(*(self._spawn(w) for w in self._workers))
        self._server = await asyncio.start_server(self._handle_edge,
                                                  self.host, self.port,
                                                  ssl=self.ssl_context)
        self.port = self._server.sockets[0].getsockname()[1]
        self._monitors = [asyncio.ensure_future(self._monitor(w))
                          for w in self._workers]
        log.info("dispatcher on %s:%d%s over %d worker(s): ports %s",
                 self.host, self.port,
                 " (TLS)" if self.ssl_context is not None else "",
                 len(self._workers), [w.port for w in self._workers])
        return self

    async def __aenter__(self) -> "Dispatcher":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.close()

    async def drain(self, timeout_s: float = 10.0) -> bool:
        """Planned shutdown: shed new sessions with SHUTDOWN (retryable),
        wait for in-flight ones.  True when the pool went idle in time."""
        self.draining = True
        deadline = time.monotonic() + timeout_s
        while self.active_sessions and time.monotonic() < deadline:
            await asyncio.sleep(0.02)
        return self.active_sessions == 0

    async def close(self) -> None:
        self._closing = True
        for t in self._monitors:
            t.cancel()
        for t in self._monitors:
            try:
                await t
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass
        self._monitors = []
        for conn in list(self._conns):
            await self._close_upstreams(conn)
        for w in self._workers:
            self._close_hb(w)
            await self._kill(w, graceful=True)
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    # -- worker lifecycle ------------------------------------------------------

    async def _spawn(self, w: _Worker) -> None:
        if self._worker_factory is not None:
            w.server = self._worker_factory(w.idx)
            await w.server.start()
            w.port = w.server.port
        else:
            cmd = list(self._worker_cmd) + ["--host", "127.0.0.1",
                                            "--port", "0"]
            w.proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.DEVNULL, text=True)
            line = await asyncio.wait_for(
                asyncio.to_thread(w.proc.stdout.readline), _SPAWN_TIMEOUT_S)
            if not line.startswith("PORT "):
                raise RuntimeError(f"worker {w.idx} failed to start "
                                   f"(got {line!r})")
            w.port = int(line.split()[1])
        w.healthy = True
        w.misses = 0
        w.depth = 0
        self._sync_gauges()
        log.info("worker %d up on port %d", w.idx, w.port)

    async def _kill(self, w: _Worker, graceful: bool = False) -> None:
        w.healthy = False
        self._close_hb(w)
        if w.proc is not None:
            try:
                w.proc.send_signal(signal.SIGTERM if graceful
                                   else signal.SIGKILL)
                await asyncio.to_thread(w.proc.wait, 10)
            except Exception:                       # noqa: BLE001
                pass
            w.proc = None
        if w.server is not None:
            if graceful:
                await w.server.close()
            else:
                w.server.abort()
            w.server = None
        self._sync_gauges()

    def kill_worker(self, idx: int) -> None:
        """Chaos hook: hard-kill worker ``idx`` (SIGKILL / abort).  The
        monitor restarts it with backoff; its in-flight sessions fail
        with retryable WORKER_RESTART errors as their pumps collapse."""
        w = self._workers[idx]
        w.healthy = False
        if w.proc is not None:
            try:
                w.proc.kill()
            except Exception:                       # noqa: BLE001
                pass
        if w.server is not None:
            w.server.abort()
            w.server = None
        self._close_hb(w)
        self._sync_gauges()
        log.info("worker %d killed (chaos)", idx)

    async def _monitor(self, w: _Worker) -> None:
        """Heartbeat + restart loop for one worker."""
        while not self._closing:
            try:
                if not w.healthy:
                    await self._respawn(w)
                elif w.proc is not None and w.proc.poll() is not None:
                    # subprocess died without us killing it
                    log.warning("worker %d exited (code %s)", w.idx,
                                w.proc.returncode)
                    await self._kill(w)
                else:
                    if await self._ping(w):
                        w.misses = 0
                        if w.server is None and self.shed_depth is not None:
                            await self._probe_depth(w)
                    else:
                        w.misses += 1
                        self._m_hb_miss.inc()
                        if w.misses >= self.hb_misses:
                            log.warning("worker %d missed %d heartbeats",
                                        w.idx, w.misses)
                            await self._kill(w)
            except asyncio.CancelledError:
                raise
            except Exception as e:                  # noqa: BLE001
                log.error("worker %d monitor error: %s", w.idx, e)
            await asyncio.sleep(self.hb_interval_s)

    async def _respawn(self, w: _Worker) -> None:
        backoff = min(self.restart_backoff_s * (2.0 ** min(w.restarts, 8)),
                      self.restart_backoff_max_s)
        w.restarts += 1
        await asyncio.sleep(backoff)
        if self._closing:
            return
        await self._kill(w)          # reap any half-dead remnant
        await self._spawn(w)
        self._m_restarts.inc()
        log.info("worker %d restarted (attempt %d, backoff %.3fs)",
                 w.idx, w.restarts, backoff)

    def _close_hb(self, w: _Worker) -> None:
        if w.hb_writer is not None:
            try:
                w.hb_writer.close()
            except Exception:                       # noqa: BLE001
                pass
        w.hb_reader = w.hb_writer = w.hb_frames = None

    async def _ping(self, w: _Worker) -> bool:
        try:
            if w.hb_writer is None:
                w.hb_reader, w.hb_writer = await asyncio.wait_for(
                    asyncio.open_connection("127.0.0.1", w.port),
                    self.hb_timeout_s)
                w.hb_frames = FrameReader()
            w.hb_seq += 1
            w.hb_writer.write(encode_frame(FT_PING, 0, w.hb_seq, b""))
            await w.hb_writer.drain()

            async def pong():
                while True:
                    data = await w.hb_reader.read(1 << 12)
                    if not data:
                        raise ConnectionError("worker closed control conn")
                    w.hb_frames.feed(data)
                    for f in w.hb_frames:
                        if f.ftype == FT_PING:
                            return True

            return await asyncio.wait_for(pong(), self.hb_timeout_s)
        except (OSError, asyncio.TimeoutError, FramingError,
                ConnectionError):
            self._close_hb(w)
            return False

    async def _probe_depth(self, w: _Worker) -> None:
        """Poll a subprocess worker's decode-stage queue depth over the
        control connection (in-band FT_METRICS snapshot; in-process
        workers are read directly and never need this).  A failed probe
        just keeps the previous sample -- health is the ping's job."""
        try:
            w.hb_writer.write(encode_frame(FT_METRICS, 0, 0, b""))
            await w.hb_writer.drain()

            async def snap():
                while True:
                    data = await w.hb_reader.read(1 << 16)
                    if not data:
                        raise ConnectionError("worker closed control conn")
                    w.hb_frames.feed(data)
                    for f in w.hb_frames:
                        if f.ftype == FT_METRICS:
                            return json.loads(f.payload.decode())

            payload = await asyncio.wait_for(snap(), self.hb_timeout_s)
            w.depth = int(payload.get("counters", {}).get("queue_depth", 0))
        except (OSError, asyncio.TimeoutError, FramingError,
                ConnectionError, ValueError):
            pass

    # -- edge connections ------------------------------------------------------

    async def _handle_edge(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        writer = wrap_writer(writer, "edge", self._fault_edge)
        conn = _EdgeConn(writer)
        self._conns.add(conn)
        frames = FrameReader()
        try:
            while True:
                data = await reader.read(1 << 16)
                if not data:
                    break
                frames.feed(data)
                for frame in frames:
                    await self._route(frame, conn)
        except (FramingError, ValueError) as e:
            await self._edge_error(conn, 0, E_PROTOCOL, str(e),
                                   retryable=False)
        except ConnectionError:
            pass
        finally:
            self._conns.discard(conn)
            await self._close_upstreams(conn)
            writer.close()
            try:
                await writer.wait_closed()
            except ConnectionError:
                pass

    async def _close_upstreams(self, conn: _EdgeConn) -> None:
        for t in conn.pumps.values():
            t.cancel()
        for t in list(conn.pumps.values()):
            try:
                await t
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass
        conn.pumps.clear()
        for up in conn.upstreams.values():
            up.close()
        conn.upstreams.clear()
        for sid in list(conn.session_worker):
            self._unmap(conn, sid)

    def _unmap(self, conn: _EdgeConn, sid: int) -> int | None:
        widx = conn.session_worker.pop(sid, None)
        if widx is not None:
            w = self._workers[widx]
            w.active = max(0, w.active - 1)
            self._sync_gauges()
        return widx

    async def _edge_error(self, conn: _EdgeConn, session: int, code: int,
                          msg: str, retryable: bool) -> None:
        try:
            async with conn.wlock:
                conn.writer.write(encode_frame(
                    FT_ERROR, session, 0,
                    encode_error(code, msg, retryable=retryable)))
                await conn.writer.drain()
        except (ConnectionError, RuntimeError):
            pass

    # -- routing ---------------------------------------------------------------

    async def _route(self, frame, conn: _EdgeConn) -> None:
        if frame.ftype == FT_PING:
            async with conn.wlock:
                conn.writer.write(encode_frame(FT_PING, frame.session,
                                               frame.seq, frame.payload))
                await conn.writer.drain()
        elif frame.ftype == FT_HELLO:
            await self._on_hello(frame, conn)
        elif frame.ftype in (FT_HEADER, FT_CHUNK, FT_END):
            await self._route_tensor(frame, conn)
        elif frame.ftype == FT_METRICS:
            # telemetry affinity: all snapshots of one edge conn come
            # from the same worker, so counters are comparable
            widx = conn.metrics_worker
            if widx is None or not self._workers[widx].healthy:
                widx = next((w.idx for w in self._workers if w.healthy),
                            None)
                conn.metrics_worker = widx
            if widx is None:
                await self._edge_error(conn, frame.session, E_BUSY,
                                       "no healthy worker", retryable=True)
                return
            await self._forward(frame, conn, widx, sid=None)
        else:
            raise FramingError(f"unexpected frame type {frame.ftype} "
                               "from edge")

    def _pick_worker(self) -> _Worker | None:
        live = [w for w in self._workers if w.healthy]
        if not live:
            return None
        return min(live, key=lambda w: (w.active, w.idx))

    async def _route_tensor(self, frame, conn: _EdgeConn) -> None:
        sid = frame.session
        widx = conn.session_worker.get(sid)
        if widx is None:
            if frame.ftype != FT_HEADER:
                # frames of a session we failed over: the client already
                # got its WORKER_RESTART error, drop the stragglers
                return
            if self.draining:
                self._m_shed.inc()
                await self._edge_error(conn, sid, E_SHUTDOWN,
                                       "dispatcher draining",
                                       retryable=True)
                return
            if self.max_queue is not None \
                    and self.active_sessions >= self.max_queue:
                self._m_shed.inc()
                await self._edge_error(
                    conn, sid, E_BUSY,
                    f"pool saturated ({self.active_sessions} >= "
                    f"max_queue={self.max_queue})", retryable=True)
                return
            if self._depth_shedding():
                self._m_shed.inc()
                await self._edge_error(
                    conn, sid, E_BUSY,
                    f"decode stage saturated (pool queue depth "
                    f"{int(self._m_depth.value())} >= "
                    f"shed_depth={self.shed_depth}; admitting again "
                    f"at <= {self.shed_resume_depth})", retryable=True)
                return
            w = self._pick_worker()
            if w is None:
                self._m_shed.inc()
                await self._edge_error(conn, sid, E_BUSY,
                                       "no healthy worker",
                                       retryable=True)
                return
            widx = w.idx
            conn.session_worker[sid] = widx
            w.active += 1
            self._m_routed.inc()
            self._sync_gauges()
        await self._forward(frame, conn, widx, sid=sid)

    async def _forward(self, frame, conn: _EdgeConn, widx: int,
                       sid: int | None) -> None:
        try:
            up = await self._upstream(conn, self._workers[widx])
            up.write(encode_frame(frame.ftype, frame.session, frame.seq,
                                  frame.payload))
            await up.drain()
        except (OSError, ConnectionError) as e:
            log.warning("forward to worker %d failed: %s", widx, e)
            self._drop_upstream(conn, widx)
            if sid is not None:
                self._unmap(conn, sid)
                self._m_failed.inc()
                await self._edge_error(
                    conn, sid, E_WORKER_RESTART,
                    f"worker {widx} unavailable mid-session",
                    retryable=True)

    async def _upstream(self, conn: _EdgeConn,
                        w: _Worker) -> asyncio.StreamWriter:
        up = conn.upstreams.get(w.idx)
        if up is not None:
            return up
        reader, up = await asyncio.open_connection("127.0.0.1", w.port)
        up = wrap_writer(up, "upstream", self._fault_upstream)
        conn.upstreams[w.idx] = up
        conn.pumps[w.idx] = asyncio.ensure_future(
            self._pump(conn, w.idx, reader))
        if conn.hello_raw is not None:
            # late-opened upstream: replay the edge's HELLO so this
            # worker sees the same resume token (its ack is swallowed by
            # the pump unless a merge is waiting)
            up.write(encode_frame(FT_HELLO, 0, 0, conn.hello_raw))
            await up.drain()
        return up

    def _drop_upstream(self, conn: _EdgeConn, widx: int) -> None:
        pump = conn.pumps.pop(widx, None)
        if pump is not None:
            pump.cancel()
        up = conn.upstreams.pop(widx, None)
        if up is not None:
            up.close()

    async def _pump(self, conn: _EdgeConn, widx: int,
                    up_reader: asyncio.StreamReader) -> None:
        """worker -> edge relay for one (edge conn, worker) pair."""
        frames = FrameReader()
        try:
            while True:
                data = await up_reader.read(1 << 16)
                if not data:
                    raise ConnectionError(f"worker {widx} closed")
                frames.feed(data)
                for f in frames:
                    if f.ftype == FT_HELLO:
                        fut = conn.hello_waiters.pop(widx, None)
                        if fut is not None and not fut.done():
                            fut.set_result(json.loads(f.payload.decode()))
                        continue
                    if f.ftype == FT_PING:
                        continue
                    if f.ftype in (FT_RESULT, FT_ERROR):
                        self._unmap(conn, f.session)
                    async with conn.wlock:
                        conn.writer.write(encode_frame(
                            f.ftype, f.session, f.seq, f.payload))
                        await conn.writer.drain()
        except asyncio.CancelledError:
            raise
        except (ConnectionError, OSError, FramingError) as e:
            # worker side died: fail this edge conn's sessions routed
            # there with a retryable error so clients replay elsewhere
            fut = conn.hello_waiters.pop(widx, None)
            if fut is not None and not fut.done():
                fut.set_exception(ConnectionError(str(e)))
            orphans = [sid for sid, wi in conn.session_worker.items()
                       if wi == widx]
            conn.pumps.pop(widx, None)
            up = conn.upstreams.pop(widx, None)
            if up is not None:
                up.close()
            for sid in orphans:
                self._unmap(conn, sid)
                self._m_failed.inc()
                await self._edge_error(
                    conn, sid, E_WORKER_RESTART,
                    f"worker {widx} died mid-session", retryable=True)

    # -- HELLO: front-end auth + fan-out resume --------------------------------

    async def _on_hello(self, frame, conn: _EdgeConn) -> None:
        try:
            hello = json.loads(frame.payload.decode())
            token = str(hello.get("token", ""))
        except (ValueError, UnicodeDecodeError):
            token, hello = "", None
        if self.secret is not None:
            proof = str(hello.get("auth", "")) if hello else ""
            if not token or not hmac.compare_digest(
                    proof, hello_auth(self.secret, token)):
                self._m_auth_fail.inc()
                await self._edge_error(conn, frame.session, E_UNAUTHORIZED,
                                       "HELLO auth rejected",
                                       retryable=False)
                raise ConnectionError("unauthorized edge")
        conn.hello_raw = frame.payload
        waiters: list[tuple[int, asyncio.Future]] = []
        loop = asyncio.get_running_loop()
        for w in self._workers:
            if not w.healthy:
                continue
            fut = loop.create_future()
            conn.hello_waiters[w.idx] = fut
            try:
                if w.idx in conn.upstreams:
                    up = conn.upstreams[w.idx]
                    up.write(encode_frame(FT_HELLO, 0, 0, frame.payload))
                    await up.drain()
                else:
                    await self._upstream(conn, w)   # sends hello_raw
            except (OSError, ConnectionError):
                conn.hello_waiters.pop(w.idx, None)
                continue
            waiters.append((w.idx, fut))
        resumed: set[int] = set()
        acked: dict[str, list[int]] = {}
        if waiters:
            await asyncio.wait([f for _, f in waiters],
                               timeout=_HELLO_MERGE_TIMEOUT_S)
            for widx, fut in waiters:
                if not fut.done() or fut.cancelled() \
                        or fut.exception() is not None:
                    continue
                ack = fut.result()
                for sid in ack.get("resumed", []):
                    resumed.add(sid)
                    # affinity: replayed frames of a revived session must
                    # land on the worker holding its parked state
                    if sid not in conn.session_worker:
                        conn.session_worker[sid] = widx
                        self._workers[widx].active += 1
                for sid, seqs in ack.get("acked", {}).items():
                    acked.setdefault(sid, []).extend(seqs)
            self._sync_gauges()
        reply = json.dumps({"ok": True, "resumed": sorted(resumed),
                            "acked": acked}).encode()
        async with conn.wlock:
            conn.writer.write(encode_frame(FT_HELLO, frame.session,
                                           frame.seq, reply))
            await conn.writer.drain()
