"""Edge-side streaming client (asyncio) + a synchronous wrapper.

:class:`EdgeClient` streams split-layer tensors to a
:class:`~repro_torch.transport.server.CloudServer` over one connection.  Any
number of :meth:`submit` coroutines may run concurrently: sessions are
multiplexed at frame granularity (a per-connection write lock keeps
frames atomic, ``await drain()`` after every frame bounds the send queue
and propagates TCP backpressure into the encoder).

Each chunk is entropy-coded in a worker thread while the previous frame
is on the wire (the encode/transfer overlap).  Every encode call returns
host bytes on the thread that ran it, so no device tensor crosses
threads.  With a :class:`RateController` + :class:`CodecBank`
attached, every submit re-picks the quantizer rung against the
bits/element budget and the link state fed back by the cloud.

Hardening (see DESIGN.md, "Hardened scale-out serving"):

* **Retry + reconnect**: with a :class:`RetryPolicy`, a submit that dies
  on a *retryable* failure (connection loss, BUSY shed, worker restart)
  reconnects with exponential backoff + jitter and replays the session
  -- same session id, SAME codec (rate control is *not* re-consulted on
  a replay, so the re-encoded bytes are identical) -- and the server
  dedups replayed frames by seq, yielding a bit-exact result.  Fatal
  errors (corrupt stream, auth) raise immediately.
* **Deadlines**: ``submit(..., deadline_s=...)`` bounds the whole
  attempt+retry loop; expiry raises a typed ``DEADLINE`` error, never a
  hang.
* **HELLO / resume / TLS**: when a shared ``secret`` or a retry policy
  is configured, connect() performs a HELLO handshake (resume token +
  HMAC auth proof, :func:`~repro_torch.transport.server.hello_auth`) before
  any tensor frame; ``ssl`` takes an ``ssl.SSLContext`` for TLS.

:class:`SyncEdgeClient` runs the event loop on a background thread so
blocking callers (the serving engine's loopback transport, scripts) get
a plain ``submit(x) -> arrays`` call.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import os
import random
import threading
import time

import numpy as np

from ..core.codec import FeatureCodec
from ..obs.metrics import MetricsRegistry
from ..obs.tracing import span
from ..serving.batcher import TickConfig, encode_tick
from .errors import E_DEADLINE, TransportError, decode_error
from .faultinject import FaultPlan, wrap_writer
from .framing import (FT_ERROR, FT_FEEDBACK, FT_HELLO, FT_METRICS,
                      FT_RESULT, FrameReader, encode_frame, unpack_arrays)
from .rate_control import CodecBank, RateController, rung_of_codec
from .stream_codec import (DEFAULT_CHUNK_ELEMS, Feedback, payloads_to_frames,
                           tensor_to_frames)

_HELLO_TIMEOUT_S = 10.0


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Backoff schedule for retryable submit failures.

    Delay before retry *k* (0-based) is
    ``min(base_delay_s * 2**k, max_delay_s)`` shrunk by up to ``jitter``
    (a uniform fraction), so a fleet of clients bounced by one worker
    restart doesn't reconnect in lockstep.
    """

    max_retries: int = 4
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    jitter: float = 0.5

    def delay_s(self, attempt: int, rng: random.Random) -> float:
        d = min(self.base_delay_s * (2.0 ** attempt), self.max_delay_s)
        return d * (1.0 - self.jitter * rng.random())


def _as_transport_error(e: BaseException) -> TransportError:
    """Classify a raw client-side failure.  Connection loss is retryable
    (reconnect + replay is exactly what the retry path is for); framing
    errors mean the inbound stream is corrupt -- fatal."""
    if isinstance(e, TransportError):
        return e
    if isinstance(e, (ConnectionError, asyncio.IncompleteReadError)):
        return TransportError(f"connection lost: {e}", retryable=True)
    return TransportError(str(e) or type(e).__name__, retryable=False)


@dataclasses.dataclass
class SubmitResult:
    arrays: list[np.ndarray]      # RESULT arrays from the cloud
    n_levels: int
    coded_bytes: int
    n_elems: int
    bits_per_elem: float
    send_s: float                 # time spent encoding+writing frames
    total_s: float                # submit round-trip time
    feedback: Feedback | None = None
    retries: int = 0              # attempts beyond the first


class EdgeClient:
    def __init__(self, host: str, port: int, *,
                 codec: FeatureCodec | None = None,
                 codec_bank: CodecBank | None = None,
                 rate_controller: RateController | None = None,
                 chunk_elems: int = DEFAULT_CHUNK_ELEMS,
                 coder_mode: str = "auto",
                 tick: TickConfig | None = None,
                 retry: RetryPolicy | None = None,
                 secret: str | None = None,
                 ssl=None,
                 resume_token: str | None = None,
                 fault_plan: FaultPlan | None = None,
                 metrics: MetricsRegistry | None = None) -> None:
        if codec is None and codec_bank is None:
            raise ValueError("need a codec or a codec_bank")
        if rate_controller is not None and codec_bank is None:
            raise ValueError("rate control needs a codec_bank (per-rung "
                             "calibrated codecs)")
        self.host, self.port = host, port
        self.codec = codec
        self.codec_bank = codec_bank
        self.rate_controller = rate_controller
        self.chunk_elems = chunk_elems
        self.coder_mode = coder_mode
        self.tick = tick
        self.retry = retry
        self.secret = secret
        self.ssl_context = ssl
        # the resume token identifies this client across reconnects; the
        # server parks a token'd connection's in-flight sessions on
        # disconnect instead of dropping them
        self.resume_token = (resume_token if resume_token is not None
                             else os.urandom(16).hex())
        self._fault_plan = fault_plan
        self._rng = random.Random()
        self._reader: asyncio.StreamReader | None = None
        self._writer: asyncio.StreamWriter | None = None
        self._write_lock = asyncio.Lock()
        self._conn_lock = asyncio.Lock()
        self._pending: dict[int, asyncio.Future] = {}
        self._feedback: dict[int, Feedback] = {}
        # session 0 is reserved for connection-scoped control frames
        # (HELLO, connection-level errors), so tensors start at 1
        self._next_session = 1
        self._reader_task: asyncio.Task | None = None
        self._dead: TransportError | None = None
        self._hello_fut: asyncio.Future | None = None
        # per-session frame seqs the server acked in the last resume
        # HELLO (replay skips these)
        self._acked: dict[int, set[int]] = {}
        # encode-tick coalescing state (tick is not None):
        # (codec, tensor, session, sent-bytes future) entries await one
        # shared encode_tick launch
        self._encode_queue: list[tuple] = []
        self._encode_timer: asyncio.TimerHandle | None = None
        self._encode_lock = asyncio.Lock()
        # awaiters of an on-demand cloud telemetry snapshot (FT_METRICS)
        self._metrics_waiters: list[asyncio.Future] = []
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        m = self.metrics
        self._m = {
            "ticks": m.counter("repro_client_encode_ticks_total",
                               "coalesced encode-tick launches"),
            "sessions": m.counter("repro_client_sessions_total",
                                  "tensors encoded"),
            "stacked_sessions": m.counter(
                "repro_client_stacked_sessions_total",
                "tensors that shared a stacked fused launch"),
            "fused_launches": m.counter(
                "repro_client_fused_launches_total",
                "fused quantize+pack kernel launches"),
            "entropy_calls": m.counter(
                "repro_client_entropy_calls_total",
                "batched entropy-coder invocations"),
            "elems": m.counter("repro_client_encoded_elements_total",
                               "tensor elements encoded"),
            "coded_bytes": m.counter("repro_client_coded_bytes_total",
                                     "entropy-coded payload bytes produced"),
        }
        self._m_encode_s = m.counter("repro_client_encode_seconds_total",
                                     "wall-clock spent inside encode ticks")
        self._m_submit = m.histogram(
            "repro_client_submit_latency_seconds",
            "submit round-trip latency (encode -> RESULT)")
        self._m_retries = m.counter(
            "repro_client_retries_total",
            "submit attempts retried after a retryable failure")
        self._m_reconnects = m.counter(
            "repro_client_reconnects_total",
            "connections re-established after a failure")
        self._m_resumed = m.counter(
            "repro_client_resumed_sessions_total",
            "sessions the server reported revived on reconnect")
        self._m_skipped = m.counter(
            "repro_client_replay_skipped_frames_total",
            "replay frames skipped because the server acked their seqs")
        self._m_deadlines = m.counter(
            "repro_client_deadline_expired_total",
            "submits failed by their deadline")
        if rate_controller is not None:
            rate_controller.bind_metrics(m)

    @property
    def encode_counters(self) -> dict:
        """Legacy dict view of the ``repro_client_*`` instruments (same
        keys the pre-registry counters dict had; hardening telemetry --
        retries, reconnects, resumes -- is registry-only)."""
        c = {k: int(v.value()) for k, v in self._m.items()}
        c["encode_s"] = self._m_encode_s.value()
        return c

    @property
    def _wants_hello(self) -> bool:
        return self.secret is not None or self.retry is not None

    async def connect(self) -> "EdgeClient":
        await self._open_connection()
        return self

    async def _open_connection(self) -> None:
        self._reader, writer = await asyncio.open_connection(
            self.host, self.port, ssl=self.ssl_context)
        self._writer = wrap_writer(writer, "client", self._fault_plan)
        self._dead = None
        self._reader_task = asyncio.ensure_future(self._read_loop())
        if self._wants_hello:
            await self._send_hello()

    async def _send_hello(self) -> None:
        """Resume-token + auth handshake; must complete before the first
        tensor frame when the server requires a secret.  The ack lists
        revived sessions and their server-seen frame seqs."""
        from .server import hello_auth   # local: avoid import cycle cost
        hello = {"token": self.resume_token}
        if self.secret is not None:
            hello["auth"] = hello_auth(self.secret, self.resume_token)
        self._hello_fut = asyncio.get_running_loop().create_future()
        async with self._write_lock:
            self._writer.write(encode_frame(FT_HELLO, 0, 0,
                                            json.dumps(hello).encode()))
            await self._writer.drain()
        ack = await asyncio.wait_for(self._hello_fut, _HELLO_TIMEOUT_S)
        self._hello_fut = None
        self._acked = {int(sid): set(seqs)
                       for sid, seqs in ack.get("acked", {}).items()}
        resumed = ack.get("resumed", [])
        if resumed:
            self._m_resumed.inc(len(resumed))

    async def _ensure_connected(self) -> None:
        """Reconnect (once) if the connection is dead; concurrent submits
        coalesce on the lock and reuse the first success."""
        async with self._conn_lock:
            if (self._dead is None and self._writer is not None
                    and not self._writer.is_closing()):
                return
            await self._teardown_connection()
            try:
                await self._open_connection()
            except (OSError, asyncio.TimeoutError) as e:
                self._dead = _as_transport_error(
                    e if isinstance(e, ConnectionError)
                    else ConnectionError(str(e) or type(e).__name__))
                raise self._dead from e
            self._m_reconnects.inc()

    async def _settle_reader(self, timeout_s: float = 1.0) -> None:
        """Wait briefly for the read loop to finish when the connection
        is going down, so any final typed FT_ERROR is classified before
        a retry decision."""
        task = self._reader_task
        if task is None or (self._dead is None and self._writer is not None
                            and not self._writer.is_closing()):
            return
        try:
            await asyncio.wait_for(asyncio.shield(task), timeout_s)
        except (asyncio.TimeoutError, asyncio.CancelledError,
                ConnectionError):
            pass

    async def _teardown_connection(self) -> None:
        if self._reader_task is not None:
            self._reader_task.cancel()
            try:
                await self._reader_task
            except (asyncio.CancelledError, ConnectionError):
                pass
            self._reader_task = None
        if self._writer is not None:
            self._writer.close()
            try:
                await self._writer.wait_closed()
            except ConnectionError:
                pass
            self._writer = None

    async def __aenter__(self) -> "EdgeClient":
        return await self.connect()

    async def __aexit__(self, *exc) -> None:
        await self.close()

    async def close(self) -> None:
        if self._encode_timer is not None:
            self._encode_timer.cancel()
            self._encode_timer = None
        queue, self._encode_queue = self._encode_queue, []
        for *_, sent in queue:
            if not sent.done():
                sent.set_exception(TransportError("client closed"))
        await self._teardown_connection()

    # -- receive path ---------------------------------------------------------

    async def _read_loop(self) -> None:
        frames = FrameReader()
        try:
            while True:
                data = await self._reader.read(1 << 16)
                if not data:
                    raise ConnectionError("cloud closed the connection")
                frames.feed(data)
                for frame in frames:
                    if frame.ftype == FT_RESULT:
                        fut = self._pending.pop(frame.session, None)
                        if fut is not None and not fut.done():
                            fut.set_result(unpack_arrays(frame.payload))
                    elif frame.ftype == FT_FEEDBACK:
                        fb = Feedback.decode(frame)
                        self._feedback[frame.session] = fb
                        if self.rate_controller is not None:
                            self.rate_controller.on_feedback(
                                fb.recv_bytes_per_s, fb.queue_depth)
                    elif frame.ftype == FT_METRICS:
                        snap = json.loads(frame.payload.decode())
                        waiters, self._metrics_waiters = \
                            self._metrics_waiters, []
                        for fut in waiters:
                            if not fut.done():
                                fut.set_result(snap)
                    elif frame.ftype == FT_HELLO:
                        if self._hello_fut is not None \
                                and not self._hello_fut.done():
                            self._hello_fut.set_result(
                                json.loads(frame.payload.decode()))
                    elif frame.ftype == FT_ERROR:
                        err = decode_error(frame.payload)
                        fut = self._pending.pop(frame.session, None)
                        if fut is not None:
                            # session-scoped failure (shed, decode error):
                            # fail exactly that submit, tickmates live on
                            if not fut.done():
                                fut.set_exception(err)
                        else:
                            # connection-scoped (session 0 / unknown):
                            # the whole connection is unusable
                            raise err
        except asyncio.CancelledError:
            self._fail_pending(TransportError("client closed"))
            raise
        except Exception as e:  # framing errors, connection loss, ...
            # fail in-flight AND future submits: a dead reader must never
            # leave a submit() awaiting a result that cannot arrive
            self._fail_pending(_as_transport_error(e))

    def _fail_pending(self, err: TransportError) -> None:
        self._dead = err
        for fut in self._pending.values():
            if not fut.done():
                fut.set_exception(err)
        self._pending.clear()
        if self._hello_fut is not None and not self._hello_fut.done():
            self._hello_fut.set_exception(err)
        waiters, self._metrics_waiters = self._metrics_waiters, []
        for fut in waiters:
            if not fut.done():
                fut.set_exception(err)

    async def fetch_cloud_metrics(self) -> dict:
        """Ask the cloud for a telemetry snapshot over the frame protocol
        (an empty METRICS frame; the reply is JSON with the server's
        ``counters`` dict and full registry ``metrics`` snapshot) -- lets
        an edge observe cloud health without a separate scrape port."""
        if self._writer is None:
            raise TransportError("not connected")
        if self._dead is not None:
            raise self._dead
        fut = asyncio.get_running_loop().create_future()
        self._metrics_waiters.append(fut)
        async with self._write_lock:
            self._writer.write(encode_frame(FT_METRICS, 0, 0, b""))
            await self._writer.drain()
        return await fut

    # -- send path ------------------------------------------------------------

    def _pick_codec(self) -> tuple[FeatureCodec, object]:
        if self.rate_controller is not None:
            rung = self.rate_controller.next_rung()
            return self.codec_bank.get(rung), rung
        if self.codec is not None:
            return self.codec, self.codec.config.n_levels
        rung = max(self.codec_bank.ladder)
        return self.codec_bank.get(rung), rung

    async def _submit_tick(self, codec: FeatureCodec, x: np.ndarray,
                           session: int) -> int:
        """Queue one tensor for the next encode tick; resolves with the
        wire byte count once its frames are on the socket."""
        loop = asyncio.get_running_loop()
        sent: asyncio.Future = loop.create_future()
        self._encode_queue.append((codec, x, session, sent))
        if len(self._encode_queue) >= self.tick.max_batch:
            await self._flush_encode()
        elif self._encode_timer is None:
            self._encode_timer = loop.call_later(
                self.tick.max_wait_s,
                lambda: loop.create_task(self._flush_encode()))
        return await sent

    async def _flush_encode(self) -> None:
        """Encode everything queued since the last tick in one
        ``encode_tick`` call (stacked fused launches + ONE entropy call),
        then write each session's frames."""
        async with self._encode_lock:
            if self._encode_timer is not None:
                self._encode_timer.cancel()
                self._encode_timer = None
            queue, self._encode_queue = self._encode_queue, []
            if not queue:
                return
            cfg = dataclasses.replace(self.tick,
                                      chunk_elems=self.chunk_elems,
                                      coder_mode=self.coder_mode)
            try:
                payload_lists, stats = await asyncio.to_thread(
                    encode_tick, [(c, x) for c, x, _, _ in queue], cfg)
            except Exception as e:                  # noqa: BLE001
                for *_, sent in queue:
                    if not sent.done():
                        sent.set_exception(e)
                return
            self._m["ticks"].inc()
            self._m["sessions"].inc(stats.sessions)
            self._m["stacked_sessions"].inc(stats.stacked_sessions)
            self._m["fused_launches"].inc(stats.fused_launches)
            self._m["entropy_calls"].inc(stats.entropy_calls)
            self._m["elems"].inc(stats.elems)
            self._m["coded_bytes"].inc(stats.coded_bytes)
            self._m_encode_s.inc(stats.encode_s)
            for (_, _, session, sent), payloads in zip(queue, payload_lists):
                frames = payloads_to_frames(payloads, session)
                acked = self._acked.get(session, ())
                try:
                    async with self._write_lock:
                        with span("socket_write", session=str(session),
                                  frames=len(frames)):
                            for seq, frame_bytes in enumerate(frames):
                                if seq in acked:
                                    self._m_skipped.inc()
                                    continue
                                self._writer.write(frame_bytes)
                            await self._writer.drain()
                except Exception as e:              # noqa: BLE001
                    if not sent.done():
                        sent.set_exception(e)
                    continue
                if not sent.done():
                    sent.set_result(sum(len(f) for f in frames))

    async def submit(self, x: np.ndarray,
                     codec: FeatureCodec | None = None,
                     deadline_s: float | None = None) -> SubmitResult:
        """Stream one tensor; resolves when the cloud's RESULT arrives.

        With a :class:`RetryPolicy` attached, retryable failures
        reconnect + replay the session (same id, same codec) until the
        policy or ``deadline_s`` runs out.  ``deadline_s`` bounds the
        whole call; expiry raises ``TransportError`` code ``DEADLINE``.
        """
        if self._writer is None:
            raise TransportError("not connected")
        if codec is None:
            codec, rung = self._pick_codec()
        else:
            # attribute the measurement to the codec's actual operating
            # point: the exact ladder rung when the codec came from the
            # bank (so 'base'-granularity rungs don't fragment into a
            # second EWMA key), else the codec's own config
            rung = (self.codec_bank.rung_for(codec)
                    if self.codec_bank is not None else None) \
                or rung_of_codec(codec)
        session = self._next_session
        self._next_session += 1
        x = np.asarray(x, np.float32)
        t0 = time.perf_counter()
        deadline = (time.monotonic() + deadline_s
                    if deadline_s is not None else None)
        attempt = 0
        while True:
            try:
                if attempt > 0 or self._dead is not None:
                    if self.retry is None and self._dead is not None:
                        raise self._dead
                    await self._ensure_connected()
                budget = (None if deadline is None
                          else deadline - time.monotonic())
                if budget is not None and budget <= 0:
                    raise TransportError(
                        f"submit deadline ({deadline_s}s) expired",
                        code=E_DEADLINE, retryable=False)
                return await asyncio.wait_for(
                    self._submit_once(codec, rung, x, session, t0, attempt),
                    budget)
            except asyncio.TimeoutError:
                self._pending.pop(session, None)
                self._m_deadlines.inc()
                raise TransportError(
                    f"submit deadline ({deadline_s}s) expired",
                    code=E_DEADLINE, retryable=False) from None
            except Exception as e:                  # noqa: BLE001
                stale = self._pending.pop(session, None)
                if stale is not None and stale.done() \
                        and not stale.cancelled():
                    stale.exception()   # mark observed (no warning noise)
                err = _as_transport_error(e)
                if err.retryable and self.retry is not None:
                    # a write failure can race the server's typed error
                    # frame: let the reader drain to EOF, then prefer the
                    # structured verdict (a fatal error must not be
                    # laundered into a retryable connection loss)
                    await self._settle_reader()
                    if self._dead is not None and not self._dead.retryable:
                        err = self._dead
                if (self.retry is None or not err.retryable
                        or attempt >= self.retry.max_retries):
                    raise err from e
                self._m_retries.inc()
                delay = self.retry.delay_s(attempt, self._rng)
                if deadline is not None \
                        and time.monotonic() + delay >= deadline:
                    self._m_deadlines.inc()
                    raise TransportError(
                        f"submit deadline ({deadline_s}s) expired "
                        f"(last error: {err})",
                        code=E_DEADLINE, retryable=False) from e
                attempt += 1
                await asyncio.sleep(delay)

    async def _submit_once(self, codec: FeatureCodec, rung,
                           x: np.ndarray, session: int, t0: float,
                           attempt: int) -> SubmitResult:
        fut = asyncio.get_running_loop().create_future()
        self._pending[session] = fut
        if self.tick is not None:
            coded = await self._submit_tick(codec, x, session)
        else:
            coded = 0
            acked = self._acked.get(session, ()) if attempt else ()
            gen = tensor_to_frames(codec, x, session,
                                   chunk_elems=self.chunk_elems,
                                   coder_mode=self.coder_mode)
            seq = 0
            while True:
                # chunk entropy-coding runs off-loop, overlapping the
                # socket
                frame_bytes = await asyncio.to_thread(next, gen, None)
                if frame_bytes is None:
                    break
                coded += len(frame_bytes)
                if seq in acked:
                    # server already holds this frame from before the
                    # reconnect: replay skips it (still costs the encode,
                    # which keeps the byte accounting identical)
                    self._m_skipped.inc()
                    seq += 1
                    continue
                seq += 1
                async with self._write_lock:
                    with span("socket_write", session=str(session)):
                        self._writer.write(frame_bytes)
                        await self._writer.drain()
                if self.rate_controller is not None:
                    buf = self._writer.transport.get_write_buffer_size()
                    self.rate_controller.on_queue_depth(buf // (1 << 16))
        send_s = time.perf_counter() - t0

        arrays = await fut
        total_s = time.perf_counter() - t0
        self._m_submit.observe(total_s)
        fb = self._feedback.pop(session, None)
        if self.rate_controller is not None:
            self.rate_controller.on_tensor(rung, coded, x.size,
                                           send_seconds=send_s)
        return SubmitResult(arrays=arrays, n_levels=codec.config.n_levels,
                            coded_bytes=coded, n_elems=int(x.size),
                            bits_per_elem=8.0 * coded / max(x.size, 1),
                            send_s=send_s, total_s=total_s, feedback=fb,
                            retries=attempt)


class SyncEdgeClient:
    """Blocking facade: owns an event loop on a daemon thread.

    Used by the serving launcher's ``--transport loopback`` path, where
    the engine calls its split-boundary host hook in the middle of a step
    and cannot await.
    """

    def __init__(self, *args, **kwargs) -> None:
        self._client = EdgeClient(*args, **kwargs)
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self._loop.run_forever,
                                        name="edge-client", daemon=True)
        self._thread.start()
        try:
            self._run(self._client.connect())
        except BaseException:
            self.close()        # no loop thread outlives a failed connect
            raise

    def _run(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self._loop).result()

    def submit(self, x: np.ndarray,
               codec: FeatureCodec | None = None,
               deadline_s: float | None = None) -> SubmitResult:
        return self._run(self._client.submit(x, codec=codec,
                                             deadline_s=deadline_s))

    def fetch_cloud_metrics(self) -> dict:
        return self._run(self._client.fetch_cloud_metrics())

    @property
    def metrics(self) -> MetricsRegistry:
        return self._client.metrics

    @property
    def encode_counters(self) -> dict:
        return self._client.encode_counters

    def close(self) -> None:
        self._run(self._client.close())
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(timeout=5)
        self._loop.close()
