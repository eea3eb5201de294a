"""Port vs reference: the socket transport and the metrics exposition.

Frames, array packs, error payloads and ``tensor_to_frames`` streams of
``repro_torch.transport`` are byte-identical to the JAX package's; the
rate controller picks the same rungs (the ``prime_controller`` seeds,
which go through each package's own entropy estimate, within rel 1e-5);
``MetricsExposition`` text parses to equal dicts under both parsers; and
over 127.0.0.1 a reference client talks to a port server and a port
client to a reference server, with and without the encode tick and the
authenticated HELLO, with bit-exact reconstructions.  The reference's
codecs run its jnp backend, the port's ``backend="torch"``, calibrated
from the same samples.
"""

import asyncio
import contextlib
import dataclasses
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

import repro.obs as jobs
import repro.transport as J
import repro_torch.obs as tobs
import repro_torch.transport as T
from repro.core import CodecConfig as JCodecConfig
from repro.serving import TickConfig as JTickConfig
from repro_torch.core import CodecConfig
from repro_torch.serving import TickConfig
from test_torch_batcher import twins

FTYPES = ("FT_HEADER", "FT_CHUNK", "FT_END", "FT_RESULT", "FT_FEEDBACK",
          "FT_ERROR", "FT_METRICS", "FT_HELLO", "FT_PING")


@pytest.fixture(scope="module")
def features():
    rng = np.random.default_rng(7)
    mu = np.linspace(0.0, 6.0, 16).astype(np.float32)
    return (mu[None, :] + rng.exponential(1.0, (512, 16))).astype(np.float32)


def kind_twins(kind, features):
    """The codec kinds the wire tests cover, with their input."""
    if kind == "tensor":
        return twins(features.reshape(-1), n_levels=8, clip_mode="minmax",
                     constrain_cmin_zero=False), features
    if kind == "channel":
        return twins(features, n_levels=8, clip_mode="minmax",
                     constrain_cmin_zero=False, granularity="channel",
                     channel_axis=-1, channel_group_size=4), features
    if kind == "ecsq":
        return twins(n_levels=4, clip_mode="manual", manual_cmin=0.0,
                     manual_cmax=9.0,
                     ecsq_levels=[0.0, 1.0, 2.5, 5.0]), features
    conv = features[:128].reshape(1, 16, 8, 16)
    return twins(conv, n_levels=4, clip_mode="minmax",
                 constrain_cmin_zero=False, granularity="tile",
                 channel_axis=1, channel_group_size=2,
                 spatial_block_hw=(4, 3)), conv


# -- framing and errors -------------------------------------------------------

def test_constants_equal():
    for name in FTYPES + ("DEFAULT_CHUNK_ELEMS", "DEFAULT_LADDER",
                          "RETRYABLE_CODES", "CODE_NAMES"):
        assert getattr(T, name) == getattr(J, name), name
    assert T.__all__ == J.__all__


@pytest.mark.parametrize("ftype", FTYPES)
@pytest.mark.parametrize("size", [0, 1, 4099])
def test_frames_byte_identical(ftype, size):
    payload = np.random.default_rng(size).integers(
        0, 256, size, dtype=np.uint8).tobytes()
    code = getattr(T, ftype)
    wire = T.encode_frame(code, 7, 3 + size, payload)
    assert wire == J.encode_frame(code, 7, 3 + size, payload)
    # each reader takes the other's bytes, torn at every 1000th byte
    for reader in (T.FrameReader(), J.FrameReader()):
        for i in range(0, len(wire), 1000):
            reader.feed(wire[i:i + 1000])
        (frame,) = list(reader)
        assert (frame.ftype, frame.session, frame.seq, frame.payload) == (
            code, 7, 3 + size, payload)


def test_corrupt_frames_rejected_alike():
    wire = bytearray(T.encode_frame(T.FT_CHUNK, 1, 0, b"payload"))
    wire[-1] ^= 0xFF
    for mod in (T, J):
        reader = mod.FrameReader()
        reader.feed(bytes(wire))
        with pytest.raises(mod.FramingError, match="CRC"):
            list(reader)


def test_pack_arrays_identical():
    rng = np.random.default_rng(3)
    arrays = [rng.standard_normal((4, 5)).astype(np.float32),
              rng.integers(0, 9, (3,), dtype=np.int32),
              np.zeros((0, 2), np.float32),
              rng.integers(0, 255, (2, 3, 2), dtype=np.uint8)]
    wire = T.pack_arrays(arrays)
    assert wire == J.pack_arrays(arrays)
    for got in (T.unpack_arrays(wire), J.unpack_arrays(wire)):
        for a, b in zip(got, arrays):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    for mod in (T, J):
        with pytest.raises(mod.FramingError, match="unsupported dtype"):
            mod.pack_arrays([np.zeros(2, np.complex64)])


@pytest.mark.parametrize("code", sorted(J.CODE_NAMES))
@pytest.mark.parametrize("retryable", [None, True, False])
def test_error_payloads_identical(code, retryable):
    msg = f"boom {code}"
    wire = T.encode_error(code, msg, retryable=retryable)
    assert wire == J.encode_error(code, msg, retryable=retryable)
    t, j = T.decode_error(wire), J.decode_error(wire)
    assert (t.code, t.retryable, str(t)) == (j.code, j.retryable, str(j))


@pytest.mark.parametrize("kind", ["tensor", "channel", "ecsq", "tile2d"])
@pytest.mark.parametrize("coder_mode", ["rans", "auto"])
def test_tensor_to_frames_identical(features, kind, coder_mode):
    (ref, port), x = kind_twins(kind, features)
    got = list(T.tensor_to_frames(port, x, 5, chunk_elems=700,
                                  coder_mode=coder_mode))
    assert got == list(J.tensor_to_frames(ref, x, 5, chunk_elems=700,
                                          coder_mode=coder_mode))
    assert len(got) > 3
    payloads = list(port.encode_stream(x, chunk_elems=700,
                                       coder_mode=coder_mode))
    assert T.payloads_to_frames(payloads, 5) == got
    # the port's assembler reconstructs the reference's decode exactly
    asm = T.TensorAssembler(backend=port.backend)
    reader = T.FrameReader()
    reader.feed(b"".join(got))
    outs = [asm.feed(f) for f in reader]
    np.testing.assert_array_equal(outs[-1], np.asarray(
        ref.decode_stream(payloads)).reshape(x.shape))


def test_feedback_frames_identical():
    fb = dict(recv_bytes_per_s=1.5e6, decode_s=0.004, queue_depth=3,
              active_sessions=2)
    wire = T.Feedback(**fb).encode(4, 9)
    assert wire == J.Feedback(**fb).encode(4, 9)
    reader = T.FrameReader()
    reader.feed(wire)
    assert dataclasses.asdict(T.Feedback.decode(next(iter(reader)))) == fb


# -- rate control -------------------------------------------------------------

LADDER = (2, 4, 8, 16, J.Rung(4, "channel", 4), J.Rung(8, "channel", 4))


def _port_rung(r):
    return T.as_rung(r) if isinstance(r, int) else T.Rung(
        *dataclasses.astuple(r))


def _banks(features):
    base = dict(n_levels=4, clip_mode="minmax", constrain_cmin_zero=False,
                channel_axis=-1)
    ref = J.CodecBank(JCodecConfig(backend="jnp", **base), features,
                      ladder=LADDER)
    port = T.CodecBank(CodecConfig(backend="torch", **base), features,
                       ladder=tuple(_port_rung(r) for r in LADDER))
    return ref, port


def test_rung_tables_equal(features):
    ref, port = _banks(features)
    assert [dataclasses.astuple(r) for r in port.ladder] == \
        [dataclasses.astuple(r) for r in ref.ladder]
    for jr, tr in zip(ref.ladder, port.ladder):
        jc, tc = ref.get(jr), port.get(tr)
        np.testing.assert_array_equal(np.asarray(tc.cmin, np.float32),
                                      np.asarray(jc.cmin, np.float32))
        np.testing.assert_array_equal(np.asarray(tc.cmax, np.float32),
                                      np.asarray(jc.cmax, np.float32))
        assert dataclasses.astuple(T.rung_of_codec(tc)) == \
            dataclasses.astuple(J.rung_of_codec(jc))
        assert port.rung_for(tc) == tr


def test_prime_controller_seeds(features):
    ref, port = _banks(features)
    jrc = J.RateController(J.RateControlConfig(target_bpe=1.5,
                                               ladder=ref.ladder))
    trc = T.RateController(T.RateControlConfig(target_bpe=1.5,
                                               ladder=port.ladder))
    ref.prime_controller(jrc)
    port.prime_controller(trc)
    for jr, tr in zip(ref.ladder, port.ladder):
        assert trc.estimate_bpe(tr) == pytest.approx(jrc.estimate_bpe(jr),
                                                     rel=1e-5)
        assert trc.estimate_bpe(tr) > 0


def test_rung_sequence_on_a_scripted_trace(features):
    """Both controllers, primed from their banks, pick the same rung at
    every step of a scripted trace of coded sizes, link feedback and
    send-queue pressure."""
    ref, port = _banks(features)
    cfg = dict(target_bpe=1.2, queue_high=4, window_elems=1 << 16)
    jrc = J.RateController(J.RateControlConfig(ladder=ref.ladder, **cfg))
    trc = T.RateController(T.RateControlConfig(ladder=port.ladder, **cfg))
    ref.prime_controller(jrc)
    port.prime_controller(trc)
    rng = np.random.default_rng(5)
    seq = []
    for step in range(40):
        jr, tr = jrc.next_rung(), trc.next_rung()
        assert dataclasses.astuple(tr) == dataclasses.astuple(jr), step
        seq.append(str(tr))
        n = 8192
        bpe = float(np.log2(tr.n_levels)) * (0.45 + 0.3 * rng.random())
        coded = int(bpe * n / 8)
        for rc, r in ((jrc, jr), (trc, tr)):
            rc.on_tensor(r, coded, n, send_seconds=0.002 + 0.001 * step)
            rc.on_feedback(1e6 / (1 + step % 7), step % 6)
            rc.on_queue_depth(8 if 15 <= step < 20 else 0)
    assert len(set(seq)) > 2          # the trace walks the ladder
    assert trc.history == jrc.history


# -- exposition ---------------------------------------------------------------

def _registry(obs):
    reg = obs.MetricsRegistry()
    reg.counter("repro_t_events_total", "evts",
                labelnames=("kind",)).inc(3, kind='a"b\\c')
    reg.gauge("repro_t_level_count", "lvl").set(1.5)
    h = reg.histogram("repro_t_bpe", "bpe", buckets=obs.BPE_BUCKETS)
    for v in (0.1, 2.0, 7.5):
        h.observe(v)
    return reg


def test_exposition_parses_alike():
    port_text = tobs.MetricsExposition([_registry(tobs)]).render()
    ref_text = jobs.MetricsExposition([_registry(jobs)]).render()
    assert port_text == ref_text
    parsed = tobs.parse_prometheus_text(port_text)
    assert parsed == jobs.parse_prometheus_text(port_text)
    assert parsed["repro_t_bpe"]["type"] == "histogram"
    assert tobs.parse_prometheus_text(ref_text) == parsed
    with pytest.raises(ValueError):
        tobs.parse_prometheus_text("repro_t_x_total {broken\n")


def test_exposition_scrape_routes():
    reg = _registry(tobs)
    pulled = []

    async def run():
        exp = tobs.MetricsExposition([reg],
                                     collectors=[lambda: pulled.append(1)])
        await exp.start()
        url = f"http://127.0.0.1:{exp.port}"
        try:
            def get(path):
                with urllib.request.urlopen(url + path, timeout=5) as r:
                    return r.status, r.read().decode()
            out = {p: await asyncio.to_thread(get, p)
                   for p in ("/metrics", "/events", "/healthz")}
            with pytest.raises(urllib.error.HTTPError):
                await asyncio.to_thread(get, "/nope")
        finally:
            await exp.close()
        return out

    out = asyncio.run(run())
    assert jobs.parse_prometheus_text(out["/metrics"][1]) == \
        tobs.parse_prometheus_text(reg.render())
    assert pulled
    assert "events" in json.loads(out["/events"][1])
    assert out["/healthz"] == (200, "ok\n")


# -- across packages over 127.0.0.1 -------------------------------------------

@contextlib.contextmanager
def serving(server):
    """Run ``server`` on its own event-loop thread; close the server,
    then the loop, on exit."""
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()
    try:
        asyncio.run_coroutine_threadsafe(server.start(), loop).result(30)
        yield server
    finally:
        asyncio.run_coroutine_threadsafe(server.close(), loop).result(30)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(timeout=10)
        loop.close()
    assert not thread.is_alive()


@pytest.mark.parametrize("direction", ["ref_client_port_server",
                                       "port_client_ref_server"])
@pytest.mark.parametrize("tick", [False, True])
@pytest.mark.parametrize("secret", [None, "s3cr3t"])
@pytest.mark.parametrize("kind", ["tensor", "channel"])
def test_cross_package_sockets(features, direction, tick, secret, kind):
    (ref, port), x = kind_twins(kind, features)
    port_client = direction == "port_client_ref_server"
    if port_client:
        server = J.CloudServer(echo_features=True, secret=secret)
        client_mod, codec, tcfg = T, port, TickConfig
    else:
        server = T.CloudServer(echo_features=True, secret=secret,
                               backend="torch")
        client_mod, codec, tcfg = J, ref, JTickConfig
    tensors = [x, 0.5 * x, 2.0 * x]
    with serving(server):
        client = client_mod.SyncEdgeClient(
            "127.0.0.1", server.port, codec=codec, chunk_elems=900,
            tick=tcfg(max_wait_s=0.002) if tick else None, secret=secret)
        try:
            results = [client.submit(t) for t in tensors]
            counters = client.encode_counters
        finally:
            client.close()
    for t, res in zip(tensors, results):
        payloads = list(codec.encode_stream(t, chunk_elems=900))
        want = np.asarray(ref.decode_stream(payloads)).reshape(t.shape)
        np.testing.assert_array_equal(np.asarray(res.arrays[0]), want)
        np.testing.assert_array_equal(
            port.decode_stream(payloads).reshape(t.shape), want)
        assert res.coded_bytes == sum(len(f) for f in
                                      T.payloads_to_frames(payloads, 1))
    assert counters["sessions"] == (3 if tick else 0)


def test_wrong_secret_rejected_across_packages(features):
    (ref, port), x = kind_twins("tensor", features)
    for server, client_mod, codec in (
            (T.CloudServer(echo_features=True, secret="right",
                           backend="torch"), J, ref),
            (J.CloudServer(echo_features=True, secret="right"), T, port)):
        with serving(server):
            with pytest.raises(client_mod.TransportError) as ei:
                client_mod.SyncEdgeClient("127.0.0.1", server.port,
                                          codec=codec, secret="wrong")
        assert ei.value.code == T.E_UNAUTHORIZED
