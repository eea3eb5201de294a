"""Port vs reference: the FeatureCodec bitstreams.

The frozen conformance vectors in ``tests/golden`` are rebuilt with the
port's codec (inputs as ``tests/golden_cases.py`` makes them), and random
streams cross between the packages.  The port runs its torch backend on
CPU tensors; the reference its jnp backend.  Tolerances: wire bytes and
decoded indices exact; reconstructions bit-exact (both decode through
the same dequantize formula) except where stated.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import golden_cases as gc
from repro.core import CodecConfig as JCodecConfig
from repro.core import calibrate as jcalibrate
from repro_torch.core import CodecConfig, calibrate
from repro_torch.core import cabac as tcabac
from repro_torch.core.codec import (_CHANNEL_EXT_FMT, _HEADER_FMT,
                                    FLAG_CHANNEL, FLAG_V2, parse_header)
from repro_torch.core.ecsq import ECSQQuantizer

GOLDEN = Path(__file__).parent / "golden"


def _uniform(n_levels=4):
    return calibrate(CodecConfig(n_levels=n_levels, clip_mode="manual",
                                 manual_cmin=0.0, manual_cmax=9.0,
                                 backend="torch"))


def _ecsq():
    codec = _uniform()
    codec.ecsq = ECSQQuantizer.from_levels(
        np.array([0.0, 1.0, 2.5, 5.0], np.float32))
    return codec


def _tile(x):
    return calibrate(CodecConfig(n_levels=4, clip_mode="minmax",
                                 constrain_cmin_zero=False,
                                 granularity="tile", channel_axis=1,
                                 channel_group_size=2,
                                 spatial_block_size=32, backend="torch"),
                     samples=x)


def _tile2d(x, use_ecsq=False, n_levels=4):
    return calibrate(CodecConfig(n_levels=n_levels, clip_mode="minmax",
                                 constrain_cmin_zero=False,
                                 granularity="tile", channel_axis=1,
                                 channel_group_size=2,
                                 spatial_block_hw=(4, 3),
                                 use_ecsq=use_ecsq, backend="torch"),
                     samples=x)


def _v1_stream(x):
    """The seed format, built with the port's quantizer and coder."""
    import struct
    idx = _uniform().quantize(torch.from_numpy(x)).numpy()
    return struct.pack(_HEADER_FMT, 0.0, 9.0, 4, 0, x.size) \
        + tcabac.encode_indices_serial(idx.ravel(), 4)


def _v2_channel_stream(x):
    import struct
    from repro_torch.core.backend import get_backend, spec_from_numpy
    lo, hi = x.min(axis=0), x.max(axis=0)
    spec = spec_from_numpy(lo, hi, 4, -1)
    idx = get_backend("torch").quantize(torch.from_numpy(x), spec).numpy()
    header = struct.pack(_HEADER_FMT, float(lo.min()), float(hi.max()), 4,
                         FLAG_V2 | FLAG_CHANNEL, x.size)
    header += struct.pack(_CHANNEL_EXT_FMT, x.ndim, x.ndim - 1, 1, lo.size)
    header += np.asarray(x.shape, "<u4").tobytes()
    header += np.stack([lo, hi], axis=-1).astype("<f4").tobytes()
    return header + tcabac.encode_indices(idx.ravel(), 4, mode="rans")


# case name -> (port codec factory, port builder for decode-only formats)
PORT_CASES = {
    "v1_seed_uniform": (lambda x: _uniform(), _v1_stream),
    "v2_uniform_serial": (lambda x: _uniform(), None),
    "v2_uniform_rans": (lambda x: _uniform(), None),
    "v2_uniform_n8": (lambda x: _uniform(8), None),
    "v2_ecsq": (lambda x: _ecsq(), None),
    "v2_channel_legacy": (lambda x: _uniform(), _v2_channel_stream),
    "v3_tile": (_tile, None),
    "v3_tile_stream": (_tile, None),
    "v4_tile2d": (_tile2d, None),
    "v4_tile2d_n8": (lambda x: _tile2d(x, n_levels=8), None),
    "v4_tile2d_ecsq": (lambda x: _tile2d(x, use_ecsq=True), None),
    "v4_tile2d_stream": (_tile2d, None),
}
CASES = {c.name: c for c in gc.CASES}


def test_every_golden_case_is_mirrored():
    assert set(PORT_CASES) == set(CASES)
    assert len(CASES) == 12


@pytest.mark.parametrize("name", sorted(CASES))
def test_golden_decode_bit_exact(name):
    case = CASES[name]
    make_codec, _ = PORT_CASES[name]
    x = case.make_input()
    stream = (GOLDEN / f"{name}.stream.bin").read_bytes()
    want = np.load(GOLDEN / f"{name}.decoded.npy")
    codec = make_codec(x)
    if case.streamed:
        got = codec.decode_stream(gc.unpack_payloads(stream))
    else:
        got = codec.decode(stream, shape=x.shape)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize("name", sorted(CASES))
def test_golden_encode_byte_exact(name):
    case = CASES[name]
    make_codec, builder = PORT_CASES[name]
    x = case.make_input()
    want = (GOLDEN / f"{name}.stream.bin").read_bytes()
    if case.decode_only:
        # legacy layouts: frozen by the same manual builders, port side
        assert builder(x) == want
        return
    codec = make_codec(x)
    if case.streamed:
        got = gc.pack_payloads(list(codec.encode_stream(
            x, chunk_elems=case.chunk_elems, coder_mode=case.coder_mode)))
    else:
        got = codec.encode(x, coder_mode=case.coder_mode)
    assert got == want


def _random_x(seed, shape=(4, 16, 32)):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * 1.5 + 0.4).astype(np.float32)


def _codec_pair(kind, x, n_levels=4):
    kw = dict(n_levels=n_levels, clip_mode="minmax",
              constrain_cmin_zero=False)
    if kind == "channel":
        kw.update(granularity="channel", channel_axis=-1,
                  channel_group_size=4)
    if kind == "ecsq":
        kw.update(use_ecsq=True, clip_mode="empirical")
    samples = x if kind == "channel" else x.ravel()
    return (jcalibrate(JCodecConfig(**kw), samples),
            calibrate(CodecConfig(backend="torch", **kw), samples))


@pytest.mark.parametrize("kind", ["tensor", "channel", "ecsq"])
@pytest.mark.parametrize("device_entropy", [False, True])
def test_streams_cross_decode(kind, device_entropy):
    x = _random_x(3)
    jc, tc = _codec_pair(kind, x)
    jp = list(jc.encode_stream(x, chunk_elems=700,
                               device_entropy=device_entropy))
    tp = list(tc.encode_stream(x, chunk_elems=700,
                               device_entropy=device_entropy))
    assert tp == jp
    np.testing.assert_array_equal(tc.decode_stream(jp), jc.decode_stream(tp))
    one_j, one_t = jc.encode(x), tc.encode(x)
    assert one_t == one_j
    np.testing.assert_array_equal(tc.decode(one_j, shape=x.shape),
                                  jc.decode(one_t, shape=x.shape))


def test_coder4_equals_host_coder2_past_id():
    x = _random_x(8, (64, 1024))
    _, tc = _codec_pair("tensor", x)
    dev = list(tc.encode_stream(x, chunk_elems=1 << 14,
                                device_entropy=True))
    coded = tc._fused_indices(x)[0]
    for c, payload in enumerate(dev[1:]):
        seg = coded[c * (1 << 14):(c + 1) * (1 << 14)]
        host = tcabac._encode_rans_sharded(seg, 4, 1)
        assert payload[4] == 4 and host[0] == 2
        assert payload[5:] == host[1:]


def test_apply_with_rate_matches_reference():
    x = _random_x(5)
    jc, tc = _codec_pair("tensor", x)
    jd, jr = jc.apply_with_rate(jnp.asarray(x))
    td, tr = tc.apply_with_rate(torch.from_numpy(x))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert float(tr) == pytest.approx(float(jr), rel=1e-5)


@pytest.mark.parametrize("n_levels", [2, 4, 16, 64, 65])
@pytest.mark.parametrize("kind", ["tensor", "channel", "ecsq"])
def test_quantize_with_histogram_matches_reference(kind, n_levels):
    """The torch backend's one-pass quantize + counts against the
    reference's quantize and histogram (interpreted Pallas kernels for
    the per-tensor codec, float32): the same indices and bins; the codecs
    whose quantizer does not count (per channel groups of 4, N > 64) give
    no counts.  The rate of ``quantize_with_rate`` equals the port's own
    two-pass rate exactly and the reference's within 1e-5 (torch and jnp
    take log2 and the sum in their own ways)."""
    from repro.core.backend import get_backend as jget_backend
    x = _random_x(11, (4, 8, 64))
    jc, tc = _codec_pair(kind, x, n_levels)
    jb = jget_backend("kernel_interpret" if kind == "tensor" else "jnp")
    jidx = jb.quantize(jnp.asarray(x), jc.spec())
    tx = torch.from_numpy(x)
    idx, deq, hist = tc.backend.quantize_with_histogram(tx, tc.spec(),
                                                        want_deq=False)
    assert deq is None and np.array_equal(idx.numpy(), np.asarray(jidx))
    counts = kind in ("tensor", "ecsq") and n_levels <= 64
    assert (hist is not None) == counts
    if counts:
        assert np.array_equal(hist.numpy(), np.asarray(
            jb.histogram(jidx, n_levels)))
    idx2, none, rate = tc.quantize_with_rate(tx)
    assert none is None and torch.equal(idx2, idx)
    assert float(rate) == float(tc.rate_from_indices(tc.quantize(tx),
                                                     x.shape))
    jrate = jc.rate_from_indices(jidx, x.shape)
    assert float(rate) == pytest.approx(float(jrate), rel=1e-5)


def test_header_parse_matches_reference():
    from repro.core.codec import parse_header as jparse
    x = gc._conv_input()
    for codec in (_tile(x), _tile2d(x, use_ecsq=True), _ecsq()):
        blob = codec.encode(x if codec.plan is not None else x.ravel(),
                            coder_mode="rans")
        a, b = parse_header(blob), jparse(blob)
        assert (a.cmin, a.cmax, a.n_levels, a.flags, a.n_elems, a.dims,
                a.payload_off) == (b.cmin, b.cmax, b.n_levels, b.flags,
                                   b.n_elems, b.dims, b.payload_off)
