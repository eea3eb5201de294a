"""Port vs reference: the cross-session tick batcher.

``repro_torch.serving.batcher.encode_tick`` against its own per-session
``encode_stream`` and against the JAX package's ``encode_tick`` on the
same inputs, for every plan case of ``tests/test_batcher.py``: payloads
byte-identical and ``TickStats`` equal (all but the wall time).  The
reference's codecs run its jnp backend, the port's ``backend="torch"``;
both are calibrated from the same samples.  The decode side
(``DecodeBatcher``) and the server and client tick loops are held
against the reference's reconstructions, bit-exact.
"""

import asyncio
import dataclasses
import time

import numpy as np
import pytest

import golden_cases as gc
from repro.core import CodecConfig as JCodecConfig
from repro.core import calibrate as jcalibrate
from repro.core.ecsq import ECSQQuantizer as JECSQQuantizer
from repro.serving import TickConfig as JTickConfig
from repro.serving import encode_tick as jencode_tick
from repro_torch.core import CodecConfig, calibrate
from repro_torch.core.codec import (ChunkStreamDecoder, HeaderCache,
                                    flush_decoders)
from repro_torch.core.ecsq import ECSQQuantizer
from repro_torch.serving import DecodeBatcher, TickConfig, encode_tick
from repro_torch.serving import batcher as batcher_mod
from repro_torch.transport import (DEFAULT_CHUNK_ELEMS, CloudServer,
                                   EdgeClient, bank_cache_stats,
                                   clear_bank_cache, shared_bank,
                                   tensor_to_frames)

_flat, _conv = gc._flat_input, gc._conv_input


def twins(samples=None, ecsq_levels=None, **kw):
    """(reference codec on jnp, port codec on torch) from one config and
    one set of calibration samples."""
    ref = jcalibrate(JCodecConfig(backend="jnp", **kw), samples=samples)
    port = calibrate(CodecConfig(backend="torch", **kw), samples=samples)
    if ecsq_levels is not None:
        levels = np.asarray(ecsq_levels, np.float32)
        ref.ecsq = JECSQQuantizer.from_levels(levels)
        port.ecsq = ECSQQuantizer.from_levels(levels)
    return ref, port


def uniform(n_levels=4):
    return twins(n_levels=n_levels, clip_mode="manual", manual_cmin=0.0,
                 manual_cmax=9.0)


def ecsq():
    return twins(n_levels=4, clip_mode="manual", manual_cmin=0.0,
                 manual_cmax=9.0, ecsq_levels=[0.0, 1.0, 2.5, 5.0])


def channel(x, n_levels=4, group=2):
    return twins(x, n_levels=n_levels, clip_mode="minmax",
                 constrain_cmin_zero=False, granularity="channel",
                 channel_axis=-1, channel_group_size=group)


def tile1d(x):
    return twins(x, n_levels=4, clip_mode="minmax",
                 constrain_cmin_zero=False, granularity="tile",
                 channel_axis=1, channel_group_size=2,
                 spatial_block_size=32)


def tile2d(x, use_ecsq=False, n_levels=4):
    return twins(x, n_levels=n_levels, clip_mode="minmax",
                 constrain_cmin_zero=False, granularity="tile",
                 channel_axis=1, channel_group_size=2,
                 spatial_block_hw=(4, 3), use_ecsq=use_ecsq)


# -- the plan cases: name -> () -> (items, TickConfig kwargs, stats) -----------
# items are ((reference codec, port codec), tensor); one twin pair is
# reused across items, as one codec object is on the wire


def _per_tensor(k):
    def case():
        codec = uniform(8)
        xs = [_flat(n=3000, seed=100 + i) * 0.9 for i in range(k)]
        return [(codec, x) for x in xs], dict(chunk_elems=700), dict(
            fused_launches=1)
    return case


def _mixed_shapes():
    codec = uniform()
    xs = [_flat(n=n) for n in (500, 3000, 1700)]
    return [(codec, x) for x in xs], dict(chunk_elems=1 << 12), dict(
        fused_launches=1, stacked_sessions=3)


def _channel():
    x0 = _flat(n=1024).reshape(128, 8)
    codec = channel(x0)
    xs = [x0, 0.5 * x0, x0[::-1].copy()]
    return [(codec, x) for x in xs], dict(chunk_elems=300), dict(
        fused_launches=1, stacked_sessions=3)


def _tile1d_stackable():
    x = _conv(shape=(1, 4, 8, 8))       # M = 64 divides the 32-blocks
    codec = tile1d(x)
    return [(codec, x), (codec, 2.0 * x)], dict(chunk_elems=1 << 10), dict(
        fused_launches=1, stacked_sessions=2)


def _tile1d_ragged():
    x = _conv()                         # M = 99 % 32 != 0
    codec = tile1d(x)
    return [(codec, x), (codec, 0.5 * x)], dict(chunk_elems=1 << 10), dict(
        fused_launches=2, stacked_sessions=0)


def _tile2d(use_ecsq):
    def case():
        x = _conv(shape=(1, 4, 8, 9))   # H = 8 divides bh = 4
        codec = tile2d(x, use_ecsq=use_ecsq)
        xs = [x, 0.25 * x, 4.0 * x]
        return [(codec, t) for t in xs], dict(chunk_elems=1 << 10), dict(
            fused_launches=1, stacked_sessions=3)
    return case


def _mixed_rungs():
    flat = _flat(n=2048)
    conv = _conv(shape=(1, 4, 8, 9))
    items = [(uniform(4), flat), (uniform(8), 0.5 * flat),
             (channel(flat.reshape(256, 8)), flat.reshape(256, 8)),
             (tile2d(conv), conv)]
    return items, dict(chunk_elems=600), dict(groups=4)


def _max_batch():
    codec = channel(_flat(n=1024).reshape(128, 8))
    xs = [_flat(n=1024, seed=i).reshape(128, 8) for i in range(5)]
    # ceil(5/2) = 3 launches: two stacked pairs + one singleton
    return [(codec, x) for x in xs], dict(chunk_elems=1 << 10,
                                          max_batch=2), dict(
        fused_launches=3, stacked_sessions=4)


def _golden(make, chunk=0):
    """A re-encodable conformance case of ``tests/golden_cases.py``, two
    sessions (the input and half of it)."""
    def case():
        x = GOLDEN_CASES[make[0]].make_input()
        codec = make[1](x)
        return [(codec, x), (codec, 0.5 * x)], dict(
            chunk_elems=chunk or DEFAULT_CHUNK_ELEMS), {}
    return case


GOLDEN_CASES = {c.name: c for c in gc.CASES}
GOLDEN = {"v2_uniform_rans": (lambda x: uniform(), 0),
          "v2_uniform_n8": (lambda x: uniform(8), 0),
          "v2_ecsq": (lambda x: ecsq(), 0),
          "v3_tile": (tile1d, 0), "v3_tile_stream": (tile1d, 128),
          "v4_tile2d": (tile2d, 0),
          "v4_tile2d_n8": (lambda x: tile2d(x, n_levels=8), 0),
          "v4_tile2d_ecsq": (lambda x: tile2d(x, use_ecsq=True), 0),
          "v4_tile2d_stream": (tile2d, 64)}

CASES = {"per_tensor_1": _per_tensor(1), "per_tensor_2": _per_tensor(2),
         "per_tensor_5": _per_tensor(5), "mixed_shapes": _mixed_shapes,
         "channel": _channel, "tile1d_stackable": _tile1d_stackable,
         "tile1d_ragged": _tile1d_ragged, "tile2d": _tile2d(False),
         "tile2d_ecsq": _tile2d(True), "mixed_rungs": _mixed_rungs,
         "max_batch": _max_batch}
CASES.update({f"golden_{name}": _golden((name, make), chunk)
              for name, (make, chunk) in GOLDEN.items()})


def _stats(s) -> dict:
    d = dataclasses.asdict(s)
    d.pop("encode_s")
    return d


def _ticks(case, **tick_kw):
    """Both packages' tick over one case: (port payloads, port stats,
    reference payloads, reference stats, port items, TickConfig)."""
    items, kw, expect = CASES[case]()
    cfg = TickConfig(coder_mode="rans", **kw, **tick_kw)
    tp, ts = encode_tick([(t, x) for (_, t), x in items], cfg)
    jp, js = jencode_tick([(r, x) for (r, _), x in items],
                          JTickConfig(coder_mode="rans", **kw, **tick_kw))
    for k, v in expect.items():
        assert getattr(ts, k) == v, k
    return tp, ts, jp, js, [(t, x) for (_, t), x in items], cfg


def test_default_chunk_elems_matches_transport():
    # the batcher keeps its own copy of the constant so serving does not
    # import the wire layer; the two must never drift apart
    assert batcher_mod.DEFAULT_CHUNK_ELEMS == DEFAULT_CHUNK_ELEMS


@pytest.mark.parametrize("case", sorted(CASES))
def test_encode_tick_matches_reference(case):
    tp, ts, jp, js, items, cfg = _ticks(case)
    assert tp == [list(codec.encode_stream(
        x, chunk_elems=cfg.chunk_elems, coder_mode="rans"))
        for codec, x in items]
    assert tp == jp
    assert _stats(ts) == _stats(js)
    assert ts.entropy_calls == 1
    assert ts.sessions == len(items)


@pytest.mark.parametrize("case", ["per_tensor_2", "mixed_shapes", "channel",
                                  "tile1d_ragged", "tile2d", "tile2d_ecsq",
                                  "mixed_rungs", "max_batch"])
def test_device_entropy_tick_matches_reference(case):
    """The ``device_entropy`` tick on the CPU (the plain step loop):
    coder-id-4 payloads equal the reference's and the port's own
    per-session ``encode_stream(device_entropy=True)``."""
    items, kw, _ = CASES[case]()
    cfg = TickConfig(device_entropy=True, **kw)
    tp, ts = encode_tick([(t, x) for (_, t), x in items], cfg)
    jp, js = jencode_tick([(r, x) for (r, _), x in items],
                          JTickConfig(device_entropy=True, **kw))
    assert tp == [list(t.encode_stream(x, chunk_elems=cfg.chunk_elems,
                                       device_entropy=True))
                  for (_, t), x in items]
    assert all(p[4] == 4 for pl in tp for p in pl[1:])
    assert tp == jp
    assert _stats(ts) == _stats(js)


def test_stack_group_geometry_matches_reference():
    """The stacked views and specs the tick launches on: the same arrays,
    tables and plans as the reference's ``stack_group``."""
    from repro.serving.batcher import stack_group as jstack_group
    x = _conv(shape=(1, 4, 8, 9))
    for ref, port in (tile2d(x, use_ecsq=True), tile1d(
            _conv(shape=(1, 4, 8, 8)))):
        xs = [x, 0.5 * x] if port.plan.is_2d else [
            _conv(shape=(1, 4, 8, 8)), 2.0 * _conv(shape=(1, 4, 8, 8))]
        (tx, ts), (jx, js) = (batcher_mod.stack_group(port, xs),
                              jstack_group(ref, xs))
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ts.cmin, js.cmin)
        np.testing.assert_array_equal(ts.cmax, js.cmax)
        assert dataclasses.asdict(ts.plan) == dataclasses.asdict(js.plan)
        if ts.ecsq is not None:
            np.testing.assert_array_equal(ts.ecsq.levels, js.ecsq.levels)
            np.testing.assert_array_equal(ts.ecsq.thresholds,
                                          js.ecsq.thresholds)


# -- decode side ---------------------------------------------------------------

def _streams(specs, chunk_elems=500):
    """[(twins, x)] -> (port decoders fed out of order, reference
    reconstructions of the same payloads)."""
    decs, refs = [], []
    for (ref, port), x in specs:
        payloads = list(port.encode_stream(x, chunk_elems=chunk_elems,
                                           coder_mode="rans"))
        dec = ChunkStreamDecoder(payloads[0], chunk_batch=0,
                                 backend=port.backend)
        for p in reversed(payloads[1:]):    # out-of-order arrival
            dec.add_chunk(p)
        decs.append(dec)
        refs.append(np.asarray(ref.decode_stream(payloads)).reshape(
            x.shape))
    return decs, refs


class TestDecodeBatcher:
    def test_cross_session_flush_bit_exact(self):
        flat = _flat(n=2600)
        conv = _conv(shape=(1, 4, 8, 9))
        part = flat[:2048].reshape(256, 8)
        specs = [(uniform(4), flat), (uniform(8), 0.7 * flat),
                 (channel(part), part),
                 (tile2d(conv, use_ecsq=True), conv)]
        decs, refs = _streams(specs)
        batcher = DecodeBatcher()
        for d in decs:
            batcher.note(d)
        assert batcher.pending_sessions == len(decs)
        assert batcher.drain() == []
        assert batcher.counters["entropy_calls"] == 1
        assert batcher.counters["sessions"] == len(decs)
        for d, (_, x), ref in zip(decs, specs, refs):
            np.testing.assert_array_equal(d.finish(x.shape), ref)

    def test_corrupt_session_isolated(self):
        flat = _flat(n=2600)
        specs = [(uniform(4), flat), (uniform(8), 0.7 * flat)]
        decs, refs = _streams(specs)
        # a third session whose chunk blob is truncated garbage
        payloads = list(uniform(4)[1].encode_stream(
            flat, chunk_elems=500, coder_mode="rans"))
        bad = ChunkStreamDecoder(payloads[0], chunk_batch=0,
                                 backend=specs[0][0][1].backend)
        bad.add_chunk(payloads[1][:5])
        _, _, failures = flush_decoders(decs + [bad])
        assert [d for d, _ in failures] == [bad]
        for d, (_, x), ref in zip(decs, specs, refs):
            np.testing.assert_array_equal(d.finish(x.shape), ref)

    def test_discard_leaves_others_intact(self):
        flat = _flat(n=2600)
        specs = [(uniform(4), flat), (uniform(8), 0.7 * flat)]
        decs, refs = _streams(specs)
        batcher = DecodeBatcher()
        for d in decs:
            batcher.note(d)
        batcher.discard(decs[0])
        assert batcher.pending_sessions == 1
        assert batcher.drain() == []
        np.testing.assert_array_equal(decs[1].finish(specs[1][1].shape),
                                      refs[1])


# -- the server's and the client's tick loops ----------------------------------

@pytest.fixture(scope="module")
def features():
    rng = np.random.default_rng(7)
    mu = np.linspace(0.0, 6.0, 16).astype(np.float32)
    return (mu[None, :] + rng.exponential(1.0, (512, 16))).astype(np.float32)


def _live(features, n_levels=8):
    return twins(features, n_levels=n_levels, clip_mode="minmax",
                 constrain_cmin_zero=False, granularity="channel",
                 channel_axis=-1, channel_group_size=4)


def _ref_recon(ref, t):
    return np.asarray(ref.decode(ref.encode(t), shape=t.shape))


class TestServerTick:
    def test_concurrent_sessions_tick_counters(self, features):
        ref, codec = _live(features)
        tensors = [features, 0.5 * features, 2.0 * features]

        async def run():
            async with CloudServer(echo_features=True,
                                   backend="torch") as srv:
                async with EdgeClient("127.0.0.1", srv.port, codec=codec,
                                      chunk_elems=600) as client:
                    res = await asyncio.gather(
                        *[client.submit(t) for t in tensors])
                    return res, srv.counters

        results, counters = asyncio.run(run())
        for t, res in zip(tensors, results):
            np.testing.assert_array_equal(np.asarray(res.arrays[0]),
                                          _ref_recon(ref, t))
        assert counters["sessions_served"] == 3
        assert counters["ticks"] >= 1
        assert counters["entropy_calls"] >= 1
        assert counters["queue_depth"] == 0
        assert counters["bpe_avg"] > 0
        # same codec + shape -> same header bytes: parsed once, shared
        assert counters["header_cache"]["hits"] >= 2
        assert counters["header_cache"]["misses"] >= 1

    def test_max_chunks_trigger_beats_long_window(self, features):
        # max_wait_s is effectively infinite; completion must come from
        # the max_chunks drain trigger + ready-with-nothing-pending rule
        ref, codec = _live(features)
        tick = TickConfig(max_wait_s=60.0, max_chunks=1)

        async def run():
            async with CloudServer(echo_features=True, tick=tick,
                                   backend="torch") as srv:
                async with EdgeClient("127.0.0.1", srv.port, codec=codec,
                                      chunk_elems=600) as client:
                    return await client.submit(features)

        t0 = time.perf_counter()
        res = asyncio.run(run())
        assert time.perf_counter() - t0 < 30.0
        np.testing.assert_array_equal(np.asarray(res.arrays[0]),
                                      _ref_recon(ref, features))

    def test_disconnect_mid_tick_leaves_others_intact(self, features):
        ref, codec = _live(features)
        tick = TickConfig(max_wait_s=0.05, max_chunks=1 << 30)

        async def run():
            async with CloudServer(echo_features=True, tick=tick,
                                   backend="torch") as srv:
                # connection A: half a tensor stream, then vanish
                frames = list(tensor_to_frames(codec, features, session=0,
                                               chunk_elems=600))
                _, writer_a = await asyncio.open_connection("127.0.0.1",
                                                            srv.port)
                for fb in frames[:max(2, len(frames) // 2)]:
                    writer_a.write(fb)
                await writer_a.drain()
                await asyncio.sleep(0.01)   # let the server buffer them
                writer_a.close()
                await writer_a.wait_closed()
                # connection B: a full submit, concurrently mid-tick
                async with EdgeClient("127.0.0.1", srv.port, codec=codec,
                                      chunk_elems=600) as client:
                    res = await client.submit(0.5 * features)
                await asyncio.sleep(0.2)    # tick drains, A forgotten
                return res, srv.counters

        res, counters = asyncio.run(run())
        np.testing.assert_array_equal(np.asarray(res.arrays[0]),
                                      _ref_recon(ref, 0.5 * features))
        assert counters["sessions_served"] == 1
        assert counters["queue_depth"] == 0     # A's decoder was purged
        assert counters["decode_errors"] == 0

    def test_per_session_path(self, features):
        ref, codec = _live(features)

        async def run():
            async with CloudServer(echo_features=True, tick=None,
                                   backend="torch") as srv:
                async with EdgeClient("127.0.0.1", srv.port, codec=codec,
                                      chunk_elems=600) as client:
                    res = await client.submit(features)
                    return res, srv.counters

        res, counters = asyncio.run(run())
        np.testing.assert_array_equal(np.asarray(res.arrays[0]),
                                      _ref_recon(ref, features))
        assert counters["sessions_served"] == 1
        assert set(counters) == {"sessions_served", "open_connections"}


class TestClientTick:
    @pytest.mark.parametrize("device_entropy", [False, True])
    def test_coalesced_submits_bit_exact(self, features, device_entropy):
        ref, codec = _live(features)
        tick = TickConfig(max_wait_s=0.01, max_batch=8,
                          device_entropy=device_entropy)
        tensors = [features, 0.5 * features, 2.0 * features]

        async def run():
            async with CloudServer(echo_features=True,
                                   backend="torch") as srv:
                async with EdgeClient("127.0.0.1", srv.port, codec=codec,
                                      chunk_elems=600,
                                      tick=tick) as client:
                    res = await asyncio.gather(
                        *[client.submit(t) for t in tensors])
                    return res, dict(client.encode_counters)

        results, counters = asyncio.run(run())
        for t, res in zip(tensors, results):
            np.testing.assert_array_equal(np.asarray(res.arrays[0]),
                                          _ref_recon(ref, t))
            assert res.coded_bytes > 0
        assert counters["sessions"] == 3
        assert counters["ticks"] >= 1
        assert counters["entropy_calls"] == counters["ticks"]


def test_shared_bank_hit_miss_and_identity(features):
    clear_bank_cache()
    cfg = CodecConfig(n_levels=8, clip_mode="minmax",
                      constrain_cmin_zero=False, backend="torch")
    try:
        b1 = shared_bank(cfg, features.reshape(-1))
        b2 = shared_bank(cfg, features.reshape(-1))
        assert b1 is b2
        assert bank_cache_stats() == {"hits": 1, "misses": 1, "entries": 1}
        # different samples -> different bank
        b3 = shared_bank(cfg, 2.0 * features.reshape(-1))
        assert b3 is not b1
        assert bank_cache_stats()["entries"] == 2
    finally:
        clear_bank_cache()


def test_header_cache_parses_once_per_distinct_header(features):
    _, codec = _live(features)
    hdr = list(codec.encode_stream(features, chunk_elems=600))[0]
    cache = HeaderCache(maxsize=4)
    dec1 = ChunkStreamDecoder(hdr, chunk_batch=0, header_cache=cache,
                              backend=codec.backend)
    dec2 = ChunkStreamDecoder(hdr, chunk_batch=0, header_cache=cache,
                              backend=codec.backend)
    assert dec1.header is dec2.header
    assert cache.stats == {"hits": 1, "misses": 1, "entries": 1}
    other = list(_live(features, n_levels=4)[1].encode_stream(
        features, chunk_elems=600))
    dec3 = ChunkStreamDecoder(other[0], chunk_batch=0, header_cache=cache,
                              backend=codec.backend)
    assert dec3.header is not dec1.header
    assert cache.stats == {"hits": 1, "misses": 2, "entries": 2}
