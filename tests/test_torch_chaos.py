"""The port's hardened serving tier under injected faults.

The cases of ``tests/test_chaos.py`` run against ``repro_torch.transport``
with in-process workers and the CPU reference backend (``backend="torch"``
on every codec and server): a worker killed mid-stream either resumes
bit-exactly or fails clean with a typed error, admission control sheds
with retryable BUSY, a reconnect-with-backoff replay is byte-identical to
an uninterrupted session, fault-injected CRC corruption evicts one
session while its tickmates survive, and TLS plus the authenticated HELLO
round-trip.  All faults come from the deterministic ``FaultPlan`` seam
or the dispatcher's ``kill_worker`` hook.  Reconstructions are exact.
"""

import asyncio
import shutil
import ssl
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from repro_torch.core import CodecConfig, calibrate
from repro_torch.serving.batcher import TickConfig
from repro_torch.transport import CloudServer as _CloudServer
from repro_torch.transport import (ChaosWriter, Dispatcher, EdgeClient,
                                   FaultPlan, RetryPolicy, TransportError,
                                   decode_error, encode_error, encode_frame,
                                   wrap_writer)
from repro_torch.transport import errors as terr

TICK = TickConfig(max_wait_s=0.02, max_chunks=1 << 30)


@pytest.fixture(scope="module")
def features():
    rng = np.random.default_rng(7)
    mu = np.linspace(0.0, 6.0, 16).astype(np.float32)
    return (mu[None, :] + rng.exponential(1.0, (512, 16))).astype(np.float32)


def _codec(features, n_levels=4):
    cfg = CodecConfig(n_levels=n_levels, clip_mode="minmax",
                      constrain_cmin_zero=False, backend="torch")
    return calibrate(cfg, samples=features)


def CloudServer(**kw):
    """The port's server on the CPU reference backend."""
    return _CloudServer(backend="torch", **kw)


def _run(coro, timeout=30.0):
    """Every scenario runs under a hard timeout: a hang is a failure,
    not a stuck CI job."""
    async def bounded():
        return await asyncio.wait_for(coro, timeout)
    return asyncio.run(bounded())


# -- structured errors ---------------------------------------------------------

class TestErrorCodes:
    def test_roundtrip(self):
        for code in terr.CODE_NAMES:
            err = decode_error(encode_error(code, f"boom {code}"))
            assert err.code == code
            assert err.retryable == (code in terr.RETRYABLE_CODES)
            assert f"boom {code}" in str(err)

    def test_retryable_override(self):
        err = decode_error(encode_error(terr.E_DECODE, "x", retryable=True))
        assert err.retryable
        err = decode_error(encode_error(terr.E_BUSY, "x", retryable=False))
        assert not err.retryable

    def test_legacy_bare_text(self):
        err = decode_error(b"some old stringified exception")
        assert err.code == terr.E_UNSPECIFIED
        assert not err.retryable
        assert "stringified" in str(err)

    def test_code_names_in_str(self):
        e = TransportError("queue full", code=terr.E_BUSY)
        assert "[BUSY retryable]" in str(e)
        e = TransportError("bad crc", code=terr.E_CORRUPT_STREAM)
        assert "[CORRUPT_STREAM fatal]" in str(e)

    def test_exception_classification(self):
        from repro_torch.transport.framing import FramingError
        code, r = terr.error_for_exception(FramingError("CRC mismatch"))
        assert code == terr.E_CORRUPT_STREAM and not r
        code, r = terr.error_for_exception(RuntimeError("tail exploded"))
        assert code == terr.E_DECODE and not r
        code, r = terr.error_for_exception(
            TransportError("x", code=terr.E_BUSY))
        assert code == terr.E_BUSY and r


# -- fault plan ----------------------------------------------------------------

class TestFaultPlan:
    def test_from_env(self):
        env = ('{"client": {"drop_frames": [3], "reset_after": 7, '
               '"delay_frames": [[2, 0.5]]}}')
        plan = FaultPlan.from_env("client", env=env)
        assert plan.drop_frames == (3,)
        assert plan.reset_after == 7
        assert plan.delay_frames == ((2, 0.5),)
        assert FaultPlan.from_env("server", env=env) is None
        assert FaultPlan.from_env("client", env=None) is None

    def test_noop_unwrapped(self):
        class W:  # stand-in StreamWriter
            pass
        w = W()
        assert wrap_writer(w, "client", None) is w
        assert wrap_writer(w, "client", FaultPlan()) is w
        assert isinstance(wrap_writer(w, "client",
                                      FaultPlan(drop_frames=(0,))),
                          ChaosWriter)

    def test_deterministic_faults(self, features):
        """Same plan + same frames -> identical fault decisions."""
        codec = _codec(features)
        from repro_torch.transport import tensor_to_frames

        class Sink:
            def __init__(self):
                self.chunks = []

            def write(self, b):
                self.chunks.append(bytes(b))

        plan = FaultPlan(drop_rate=0.3, seed=42)
        outs = []
        for _ in range(2):
            sink = Sink()
            w = ChaosWriter(sink, plan)
            for fb in tensor_to_frames(codec, features, 1,
                                       chunk_elems=700):
                w.write(fb)
            outs.append((b"".join(sink.chunks), tuple(w.faults)))
        assert outs[0] == outs[1]
        assert any(k == "drop" for k, _ in outs[0][1])


# -- reconnect + resume --------------------------------------------------------

class TestReconnectResume:
    def test_replay_bit_exact(self, features):
        """Connection reset mid-stream; the client reconnects with
        backoff, the HELLO resume acks the server-held seqs, and the
        replayed session's result is byte-identical to an uninterrupted
        one."""
        codec = _codec(features)

        async def run():
            async with CloudServer(echo_features=True, tick=TICK,
                                   resume_ttl_s=5.0) as srv:
                # uninterrupted reference
                async with EdgeClient("127.0.0.1", srv.port, codec=codec,
                                      chunk_elems=3000) as clean:
                    ref = (await clean.submit(features)).arrays[0]
                # chaotic run: every connection dies after 3 frames, so
                # the stream (HELLO + header + 3 chunks + END) only
                # completes via resumed replays
                plan = FaultPlan(reset_after=3)
                client = EdgeClient(
                    "127.0.0.1", srv.port, codec=codec, chunk_elems=3000,
                    fault_plan=plan,
                    retry=RetryPolicy(max_retries=8, base_delay_s=0.01,
                                      max_delay_s=0.05))
                await client.connect()
                try:
                    res = await client.submit(features)
                finally:
                    await client.close()
                snap = srv.metrics.snapshot()
                return ref, res, snap

        ref, res, snap = _run(run())
        np.testing.assert_array_equal(res.arrays[0], ref)
        assert res.retries >= 1

        def val(name):
            s = snap[name]["series"]
            return s[0]["value"] if s else 0

        assert val("repro_server_resumed_sessions_total") >= 1
        assert val("repro_server_duplicate_frames_total") >= 0
        # nothing parked or leaked once the session completed
        assert snap["repro_server_session_pending_chunks_count"][
            "series"] == []

    def test_fatal_error_does_not_retry(self, features):
        """A corrupt inbound stream is fatal: retry must NOT mask it."""
        codec = _codec(features)

        async def run():
            async with CloudServer(echo_features=True, tick=TICK) as srv:
                client = EdgeClient(
                    "127.0.0.1", srv.port, codec=codec, chunk_elems=2000,
                    fault_plan=FaultPlan(corrupt_frames=(2,)),
                    retry=RetryPolicy(max_retries=3, base_delay_s=0.01))
                await client.connect()
                try:
                    with pytest.raises(TransportError) as ei:
                        await client.submit(features)
                finally:
                    await client.close()
                return ei.value

        err = _run(run())
        assert err.code == terr.E_CORRUPT_STREAM
        assert not err.retryable


# -- admission control ---------------------------------------------------------

class TestAdmission:
    def test_busy_shed_is_typed_and_retryable(self, features):
        codec = _codec(features)

        async def run():
            async with CloudServer(echo_features=True, tick=TICK,
                                   max_queue=0) as srv:
                async with EdgeClient("127.0.0.1", srv.port,
                                      codec=codec) as client:
                    with pytest.raises(TransportError) as ei:
                        await client.submit(features)
                return ei.value, dict(srv.counters)

        err, counters = _run(run())
        assert err.code == terr.E_BUSY
        assert err.retryable
        assert counters["shed_sessions"] >= 1
        assert counters["sessions_served"] == 0

    def test_busy_exhausts_retries(self, features):
        """A permanently saturated server fails a retrying client with
        the last BUSY error -- bounded, no hang."""
        codec = _codec(features)

        async def run():
            async with CloudServer(echo_features=True, tick=TICK,
                                   max_queue=0) as srv:
                client = EdgeClient(
                    "127.0.0.1", srv.port, codec=codec,
                    retry=RetryPolicy(max_retries=2, base_delay_s=0.01))
                await client.connect()
                try:
                    with pytest.raises(TransportError) as ei:
                        await client.submit(features)
                finally:
                    await client.close()
                return ei.value

        err = _run(run())
        assert err.code == terr.E_BUSY

    def test_graceful_drain_sheds_with_shutdown(self, features):
        codec = _codec(features)

        async def run():
            async with CloudServer(echo_features=True, tick=TICK) as srv:
                async with EdgeClient("127.0.0.1", srv.port,
                                      codec=codec) as client:
                    ok = (await client.submit(features)).arrays
                    assert len(ok) == 1
                    assert await srv.drain(timeout_s=2.0)
                    with pytest.raises(TransportError) as ei:
                        await client.submit(features)
                return ei.value

        err = _run(run())
        assert err.code == terr.E_SHUTDOWN
        assert err.retryable


# -- deadlines -----------------------------------------------------------------

class TestDeadline:
    def test_dropped_end_frame_hits_deadline(self, features):
        """A lost END frame would historically hang the submit; the
        per-submit deadline turns it into a typed DEADLINE failure."""
        codec = _codec(features)

        async def run():
            async with CloudServer(echo_features=True, tick=TICK) as srv:
                client = EdgeClient(
                    "127.0.0.1", srv.port, codec=codec,
                    chunk_elems=features.size,
                    fault_plan=FaultPlan(drop_frames=(2,)))  # the END
                await client.connect()
                t0 = time.monotonic()
                try:
                    with pytest.raises(TransportError) as ei:
                        await client.submit(features, deadline_s=0.4)
                finally:
                    await client.close()
                return ei.value, time.monotonic() - t0

        err, elapsed = _run(run())
        assert err.code == terr.E_DEADLINE
        assert not err.retryable
        assert elapsed < 3.0


# -- frame-level chaos against the server -------------------------------------

class TestFrameChaos:
    def test_crc_corruption_evicts_one_session_tickmates_survive(
            self, features):
        """Client A's chunk is corrupted on the wire (CRC fault); A's
        session dies with a typed CORRUPT_STREAM error while client B --
        same server, same tick -- completes bit-exactly, and no obs
        series leak."""
        codec = _codec(features)

        async def run():
            async with CloudServer(echo_features=True, tick=TICK) as srv:
                a = EdgeClient("127.0.0.1", srv.port, codec=codec,
                               chunk_elems=600,
                               fault_plan=FaultPlan(corrupt_frames=(4,)))
                b = EdgeClient("127.0.0.1", srv.port, codec=codec,
                               chunk_elems=600)
                await a.connect()
                await b.connect()
                try:
                    res_a, res_b = await asyncio.gather(
                        a.submit(features), b.submit(0.5 * features),
                        return_exceptions=True)
                finally:
                    await a.close()
                    await b.close()
                await asyncio.sleep(0.1)
                srv._sync_gauges()
                return res_a, res_b, srv.metrics.snapshot()

        res_a, res_b, snap = _run(run())
        assert isinstance(res_a, TransportError)
        assert res_a.code == terr.E_CORRUPT_STREAM
        assert not res_a.retryable
        assert not isinstance(res_b, Exception)
        np.testing.assert_array_equal(
            res_b.arrays[0],
            codec.decode_stream(codec.encode_stream(0.5 * features,
                                                    chunk_elems=600)))
        assert snap["repro_server_session_pending_chunks_count"][
            "series"] == []

    def test_duplicate_frames_dedup(self, features):
        """Injected duplicate frames are dropped by per-session seq
        dedup; the result stays bit-exact."""
        codec = _codec(features)

        async def run():
            async with CloudServer(echo_features=True, tick=TICK) as srv:
                client = EdgeClient(
                    "127.0.0.1", srv.port, codec=codec, chunk_elems=900,
                    fault_plan=FaultPlan(dup_frames=(1, 2, 3)),
                    retry=RetryPolicy())   # HELLO so dedup state arms
                await client.connect()
                try:
                    res = await client.submit(features)
                finally:
                    await client.close()
                return res, dict(srv.counters)

        res, counters = _run(run())
        np.testing.assert_array_equal(
            res.arrays[0],
            codec.decode_stream(codec.encode_stream(features,
                                                    chunk_elems=900)))
        assert counters["duplicate_frames"] >= 3


# -- dispatcher / worker pool --------------------------------------------------

def _pool(workers=2, **kw):
    return Dispatcher(
        workers=workers,
        worker_factory=lambda i: CloudServer(echo_features=True,
                                             tick=TICK),
        hb_interval_s=0.1, hb_timeout_s=0.5, hb_misses=2,
        restart_backoff_s=0.05, restart_backoff_max_s=0.2, **kw)


class TestDispatcher:
    def test_routes_and_balances(self, features):
        codec = _codec(features)

        async def run():
            async with _pool(workers=2) as disp:
                async with EdgeClient("127.0.0.1", disp.port,
                                      codec=codec) as client:
                    outs = await asyncio.gather(
                        *(client.submit(features * s)
                          for s in (1.0, 0.5, 0.25, 0.125)))
                return ([o.arrays[0] for o in outs],
                        disp.metrics.snapshot())

        arrays, snap = _run(run())
        for scale, arr in zip((1.0, 0.5, 0.25, 0.125), arrays):
            np.testing.assert_array_equal(
                arr, codec.decode_stream(
                    codec.encode_stream(features * scale)))
        routed = snap["repro_dispatcher_routed_sessions_total"][
            "series"][0]["value"]
        assert routed == 4

    def test_worker_kill_mid_stream_resumes_bit_exact(self, features):
        """THE acceptance scenario: a worker dies mid-stream; the client
        gets a retryable WORKER_RESTART, replays, and the result is
        bit-exact -- within the deadline, no hang, no corrupt tensor."""
        codec = _codec(features)

        async def run():
            async with _pool(workers=2) as disp:
                client = EdgeClient(
                    "127.0.0.1", disp.port, codec=codec, chunk_elems=600,
                    # stretch the stream so the kill lands mid-session
                    # (generous: the loop can stall under full-suite load)
                    fault_plan=FaultPlan(delay_frames=((3, 0.8),)),
                    retry=RetryPolicy(max_retries=4, base_delay_s=0.02))
                await client.connect()
                try:
                    task = asyncio.ensure_future(
                        client.submit(features, deadline_s=15.0))
                    # wait until the session is routed, then kill its
                    # worker while frames are still in flight
                    for _ in range(200):
                        victim = next((w.idx for w in disp._workers
                                       if w.active > 0), None)
                        if victim is not None:
                            break
                        await asyncio.sleep(0.005)
                    assert victim is not None
                    disp.kill_worker(victim)
                    res = await task
                finally:
                    await client.close()
                # the monitor restarts the victim with backoff
                for _ in range(100):
                    if disp.healthy_workers == 2:
                        break
                    await asyncio.sleep(0.05)
                return res, disp.healthy_workers, disp.metrics.snapshot()

        res, healthy, snap = _run(run())
        np.testing.assert_array_equal(
            res.arrays[0],
            codec.decode_stream(codec.encode_stream(features,
                                                    chunk_elems=600)))
        assert healthy == 2
        restarts = snap["repro_dispatcher_worker_restarts_total"][
            "series"][0]["value"]
        assert restarts >= 1

    def test_worker_kill_without_retry_fails_clean(self, features):
        """No retry policy: the same kill must fail the submit with a
        typed retryable WORKER_RESTART error -- promptly, not a hang."""
        codec = _codec(features)

        async def run():
            async with _pool(workers=1) as disp:
                # a long delay on frame 1 holds the stream open so the
                # kill below always lands mid-stream, even if the event
                # loop stalls between routing and the kill (the codec
                # encode runs synchronously under full-suite load)
                client = EdgeClient(
                    "127.0.0.1", disp.port, codec=codec, chunk_elems=600,
                    fault_plan=FaultPlan(delay_frames=((1, 1.0),)))
                await client.connect()
                try:
                    task = asyncio.ensure_future(client.submit(features))
                    for _ in range(400):
                        if disp.active_sessions or task.done():
                            break
                        await asyncio.sleep(0.005)
                    disp.kill_worker(0)
                    with pytest.raises(TransportError) as ei:
                        await asyncio.wait_for(task, 5.0)
                finally:
                    await client.close()
                return ei.value

        err = _run(run())
        assert err.code in (terr.E_WORKER_RESTART, terr.E_UNSPECIFIED)
        assert err.retryable

    def test_drain_sheds_and_waits(self, features):
        codec = _codec(features)

        async def run():
            async with _pool(workers=2) as disp:
                async with EdgeClient("127.0.0.1", disp.port,
                                      codec=codec) as client:
                    await client.submit(features)
                    assert await disp.drain(timeout_s=2.0)
                    with pytest.raises(TransportError) as ei:
                        await client.submit(features)
                return ei.value

        err = _run(run())
        assert err.code == terr.E_SHUTDOWN
        assert err.retryable

    def test_pool_max_queue_sheds_busy(self, features):
        codec = _codec(features)

        async def run():
            async with _pool(workers=1, max_queue=0) as disp:
                async with EdgeClient("127.0.0.1", disp.port,
                                      codec=codec) as client:
                    with pytest.raises(TransportError) as ei:
                        await client.submit(features)
                return ei.value

        err = _run(run())
        assert err.code == terr.E_BUSY
        assert err.retryable

    def test_shed_latch_hysteresis(self):
        """The dynamic latch engages at shed_depth and releases only at
        shed_resume_depth -- pure state machine, no sockets."""
        disp = _pool(workers=1, shed_depth=4, shed_resume_depth=1)
        w = disp._workers[0]
        w.healthy = True
        w.depth = 3
        assert not disp._depth_shedding()
        w.depth = 4
        assert disp._depth_shedding()
        w.depth = 2          # below shed_depth but above resume: latched
        assert disp._depth_shedding()
        w.depth = 1
        assert not disp._depth_shedding()
        w.depth = 3          # climbing again, under threshold: admits
        assert not disp._depth_shedding()

    def test_shed_band_validated(self):
        with pytest.raises(ValueError, match="hysteresis"):
            _pool(workers=1, shed_depth=2, shed_resume_depth=2)

    def test_dynamic_shed_tracks_decode_saturation(self, features):
        """ISSUE-10: a pool whose decode stage is saturated (tick drain
        blocked in the tail while finished sessions queue behind it)
        sheds new sessions with retryable BUSY, then admits again once
        the backlog drains -- BUSY tracks actual saturation, not just
        the static in-flight bound."""
        codec = _codec(features)
        entered = threading.Event()
        release = threading.Event()

        def slow_tail(_t):
            entered.set()
            release.wait(timeout=20.0)
            return []

        async def run():
            async with Dispatcher(
                    workers=1, shed_depth=1, shed_resume_depth=0,
                    worker_factory=lambda i: CloudServer(
                        echo_features=True, tick=TICK,
                        tail_fn=slow_tail),
                    hb_interval_s=0.1, hb_timeout_s=0.5,
                    hb_misses=2, restart_backoff_s=0.05) as disp:
                async with EdgeClient("127.0.0.1", disp.port,
                                      codec=codec) as client:
                    # s1 drains into the blocked tail ...
                    s1 = asyncio.ensure_future(
                        client.submit(features, deadline_s=30.0))
                    await asyncio.to_thread(entered.wait, 10.0)
                    # ... s2 completes its stream and queues behind the
                    # stuck drain, pushing the tick-drain depth to 1
                    s2 = asyncio.ensure_future(
                        client.submit(features * 0.5, deadline_s=30.0))
                    for _ in range(400):
                        if disp.pool_queue_depth >= 1:
                            break
                        await asyncio.sleep(0.005)
                    assert disp.pool_queue_depth >= 1
                    # saturated: a new session sheds with typed BUSY
                    with pytest.raises(TransportError) as ei:
                        await client.submit(features * 0.25)
                    assert ei.value.code == terr.E_BUSY
                    assert ei.value.retryable
                    # unblock the tail: the backlog drains, the latch
                    # releases, and the pool admits again
                    release.set()
                    r1, r2 = await asyncio.gather(s1, s2)
                    for _ in range(400):
                        if not disp._depth_shedding():
                            break
                        await asyncio.sleep(0.005)
                    r4 = await client.submit(features * 0.125,
                                             deadline_s=30.0)
                return r1, r2, r4, disp.metrics.snapshot()

        r1, r2, r4, snap = _run(run(), timeout=60.0)
        for scale, res in ((1.0, r1), (0.5, r2), (0.125, r4)):
            np.testing.assert_array_equal(
                res.arrays[0],
                codec.decode_stream(codec.encode_stream(features * scale)))
        shed = snap["repro_dispatcher_shed_sessions_total"][
            "series"][0]["value"]
        assert shed >= 1
        latched = snap["repro_dispatcher_shedding_count"][
            "series"][0]["value"]
        assert latched == 0


@pytest.mark.skipif(shutil.which("openssl") is None,
                    reason="openssl CLI not available")
class TestTlsAuth:
    @pytest.fixture(scope="class")
    def certs(self, tmp_path_factory):
        d = tmp_path_factory.mktemp("tls")
        cert, key = d / "cert.pem", d / "key.pem"
        subprocess.run(
            ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
             "-keyout", str(key), "-out", str(cert), "-days", "1",
             "-subj", "/CN=127.0.0.1",
             "-addext", "subjectAltName=IP:127.0.0.1"],
            check=True, capture_output=True)
        return str(cert), str(key)

    def _ctxs(self, certs):
        cert, key = certs
        sctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        sctx.load_cert_chain(cert, key)
        cctx = ssl.create_default_context(cafile=cert)
        return sctx, cctx

    def test_tls_and_secret_round_trip(self, features, certs):
        codec = _codec(features)
        sctx, cctx = self._ctxs(certs)

        async def run():
            async with CloudServer(echo_features=True, tick=TICK,
                                   ssl=sctx, secret="s3cr3t") as srv:
                client = EdgeClient("127.0.0.1", srv.port, codec=codec,
                                    ssl=cctx, secret="s3cr3t")
                await client.connect()
                try:
                    return (await client.submit(features)).arrays[0]
                finally:
                    await client.close()

        out = _run(run())
        np.testing.assert_array_equal(
            out, codec.decode_stream(codec.encode_stream(features)))

    def test_wrong_secret_rejected(self, features, certs):
        codec = _codec(features)
        sctx, cctx = self._ctxs(certs)

        async def run():
            async with CloudServer(echo_features=True, tick=TICK,
                                   ssl=sctx, secret="right") as srv:
                client = EdgeClient("127.0.0.1", srv.port, codec=codec,
                                    ssl=cctx, secret="wrong")
                try:
                    with pytest.raises(TransportError) as ei:
                        await client.connect()
                finally:
                    await client.close()
                srv._sync_gauges()
                return ei.value, srv.metrics.snapshot()

        err, snap = _run(run())
        assert err.code == terr.E_UNAUTHORIZED
        assert not err.retryable
        assert snap["repro_server_auth_failures_total"][
            "series"][0]["value"] >= 1

    def test_unauthenticated_tensor_frames_rejected(self, features):
        """No TLS needed: a client that skips HELLO entirely against a
        secret-requiring server gets UNAUTHORIZED on its first frame."""
        codec = _codec(features)

        async def run():
            async with CloudServer(echo_features=True, tick=TICK,
                                   secret="required") as srv:
                client = EdgeClient("127.0.0.1", srv.port, codec=codec)
                await client.connect()   # no secret, no retry -> no HELLO
                try:
                    with pytest.raises(TransportError) as ei:
                        await client.submit(features)
                finally:
                    await client.close()
                return ei.value

        err = _run(run())
        assert err.code == terr.E_UNAUTHORIZED


class TestResumeLifecycle:
    def test_parked_sessions_expire_clean(self, features):
        """A token'd connection that never comes back must not leak:
        parked sessions drop at TTL, series and gauges go to zero."""
        codec = _codec(features)

        async def run():
            import json

            from repro_torch.transport import FT_HELLO, tensor_to_frames
            async with CloudServer(echo_features=True, tick=TICK,
                                   resume_ttl_s=0.15) as srv:
                raw = list(tensor_to_frames(codec, features, session=1,
                                            chunk_elems=600))
                _, writer = await asyncio.open_connection("127.0.0.1",
                                                          srv.port)
                # HELLO with a token, half a stream, vanish
                writer.write(encode_frame(
                    FT_HELLO, 0, 0, json.dumps({"token": "tok-1"}).encode()))
                for fb in raw[:len(raw) // 2]:
                    writer.write(fb)
                await writer.drain()
                await asyncio.sleep(0.05)
                writer.close()
                await writer.wait_closed()
                await asyncio.sleep(0.05)
                srv._sync_gauges()
                parked_mid = srv.metrics.get(
                    "repro_server_parked_sessions_count").value()
                await asyncio.sleep(0.3)      # TTL fires
                srv._sync_gauges()
                return parked_mid, srv.metrics.snapshot(), srv.load

        parked_mid, snap, load = _run(run())
        assert parked_mid == 1

        def val(name):
            s = snap[name]["series"]
            return s[0]["value"] if s else 0

        assert val("repro_server_parked_sessions_count") == 0
        assert snap["repro_server_session_pending_chunks_count"][
            "series"] == []
        assert load == 0


# -- the subprocess worker ---------------------------------------------------

WORKER = [sys.executable, "-m", "repro_torch.transport.worker"]


class TestSubprocessWorker:
    def test_dispatcher_over_torch_workers(self, features):
        """Two ``python -m repro_torch.transport.worker --backend torch``
        processes behind the dispatcher serve concurrent sessions
        bit-exactly."""
        codec = _codec(features)

        async def run():
            async with Dispatcher(workers=2, worker_cmd=WORKER + [
                    "--backend", "torch", "--echo"]) as disp:
                async with EdgeClient("127.0.0.1", disp.port, codec=codec,
                                      chunk_elems=900) as client:
                    outs = await asyncio.gather(
                        *(client.submit(features * s) for s in (1.0, 0.5)))
                return [o.arrays[0] for o in outs]

        for scale, arr in zip((1.0, 0.5), _run(run(), timeout=120.0)):
            np.testing.assert_array_equal(
                arr, codec.decode_stream(
                    codec.encode_stream(features * scale)))

    def test_default_backend_needs_a_card(self):
        """The worker defaults to the CUDA backend: without a card it
        exits with the backend's error instead of serving on the CPU."""
        import torch
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        out = subprocess.run(WORKER + ["--echo"], capture_output=True,
                             text=True, timeout=120)
        assert out.returncode != 0
        assert "CUDA" in out.stderr
        with pytest.raises(RuntimeError, match="CUDA"):
            _CloudServer(echo_features=True)
