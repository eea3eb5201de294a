"""Port vs reference: the device rANS entropy stage (coder id 4).

Inputs are made with numpy from a seed and coded by both packages; the
port runs its plain step loop on CPU tensors.  Tolerance: payload bytes
are exact.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import binarization as jbin
from repro.core import cabac as jcabac
from repro.core import rans as jrans
from repro.kernels import rans_coder as jrc
from repro_torch.core import cabac as tcabac
from repro_torch.kernels import _build
from repro_torch.kernels import rans_coder as trc

SIZES = (1, 5, 513, 70000)
LEVELS = (2, 3, 4, 16)


def _indices(n, n_levels, kind, seed=0):
    rng = np.random.default_rng([seed, n, n_levels, kind == "dense"])
    if kind == "sparse":          # mostly zeros, like a ReLU boundary
        idx = np.where(rng.random(n) < 0.9, 0,
                       rng.integers(0, n_levels, n))
    else:
        idx = rng.integers(0, n_levels, n)
    return idx.astype(np.int32)


def _host_payload(idx, n_levels):
    """The reference host coder's bytes inside the coder-4 container."""
    return jcabac.wrap_device_blob(
        jrans.encode_planes(jbin.index_to_context_bits(idx, n_levels))
        if idx.size else b"")


@pytest.mark.parametrize("kind", ["sparse", "dense"])
@pytest.mark.parametrize("n_levels", LEVELS)
@pytest.mark.parametrize("n", SIZES)
def test_payload_matches_reference_coder(n, n_levels, kind):
    idx = _indices(n, n_levels, kind)
    got = trc.encode_indices_device(torch.from_numpy(idx), n_levels)
    assert got == _host_payload(idx, n_levels)
    # the PR-8 contract: coder 4 == host coder 2 (one shard) past the id
    assert got[1:] == jcabac._encode_rans_sharded(idx, n_levels, 1)[1:]
    assert np.array_equal(jcabac.decode_indices(got, n, n_levels), idx)


@pytest.mark.parametrize("n,n_levels,kind", [
    (1, 2, "dense"), (5, 3, "sparse"), (513, 4, "dense"),
    (70000, 16, "sparse")])
def test_payload_matches_jax_pallas_interpret(n, n_levels, kind):
    idx = _indices(n, n_levels, kind)
    want = jrc.encode_indices_device(idx, n_levels, use_kernel=True,
                                     interpret=True)
    assert trc.encode_indices_device(torch.from_numpy(idx),
                                     n_levels) == want


@pytest.mark.parametrize("n,n_levels,kind", [
    (513, 3, "sparse"), (70000, 4, "dense")])
def test_chunk_payloads_match_jax_pallas_interpret(n, n_levels, kind):
    idx = _indices(n, n_levels, kind)
    bounds = [(0, n // 3), (n // 3, n // 3), (n // 3, n)]   # one empty
    want = jrc.encode_index_chunks_device(idx, n_levels, bounds,
                                          use_kernel=True, interpret=True)
    got = trc.encode_index_chunks_device(torch.from_numpy(idx), n_levels,
                                         bounds)
    assert got == want


def test_above_device_levels_host_codes_same_container():
    idx = _indices(3000, 40, "dense")
    assert not trc.device_supported(idx.size, 40)
    got = trc.encode_indices_device(torch.from_numpy(idx), 40)
    assert got == jrc.encode_indices_device(idx, 40)
    chunks = trc.encode_index_chunks_device(torch.from_numpy(idx), 40,
                                            [(0, 1000), (1000, 3000)])
    assert chunks == jrc.encode_index_chunks_device(
        idx, 40, [(0, 1000), (1000, 3000)])


def test_empty_stream():
    empty = torch.zeros(0, dtype=torch.int32)
    assert trc.encode_indices_device(empty, 4) == \
        jrc.encode_indices_device(np.zeros(0, np.int32), 4)
    assert tcabac.decode_indices(trc.encode_indices_device(empty, 4), 0,
                                 4).size == 0


@pytest.mark.parametrize("ones,size", [
    (0, 1), (1, 2), (3, 7), (65535, 65536), (1, 3 << 14), (5, 1 << 20),
    (12345, 65536), (1 << 19, 1 << 20)])
def test_round_half_even_div_is_exact_rint(ones, size):
    got = trc._round_half_even_div(torch.tensor([ones]), torch.tensor([size]))
    assert int(got[0]) == int(np.rint(ones / size * (1 << 14)))


def test_step_loop_plain_matches_reference_loop():
    """The plain step loop (int64 states) against the reference's numpy
    uint64 loop on the same step matrix."""
    rng = np.random.default_rng(3)
    lanes, steps = 64, 300
    bits = (rng.random((steps, lanes)) < 0.2).astype(np.uint8)
    f1 = rng.integers(1, (1 << 14) - 1, steps).astype(np.int32)
    x, ov, w = trc.rans_step_plain(torch.from_numpy(bits),
                                   torch.from_numpy(f1), lanes)
    blob = jrans._blob(lanes, np.zeros(0, np.uint16), x.numpy(),
                       w.numpy()[ov.numpy().astype(bool)])
    # the reference loop over the same setup (no probability table)
    xr = np.full(lanes, 1 << 16, np.uint64)
    words = []
    for t in range(steps - 1, -1, -1):
        ft1 = np.uint64(f1[t])
        ft0 = np.uint64(1 << 14) - ft1
        b = bits[t].astype(bool)
        f = np.where(b, ft1, ft0)
        over = xr >= (f << np.uint64(18))
        words.append((t, (xr & np.uint64(0xFFFF))[over]))
        xr = np.where(over, xr >> np.uint64(16), xr)
        q = xr // f
        xr = (q << np.uint64(14)) + (xr - q * f) + ft0 * b
    want_w = np.concatenate([w_ for _, w_ in sorted(words, key=lambda p: p[0])])
    assert blob == jrans._blob(lanes, np.zeros(0, np.uint16), xr, want_w)


def test_cpu_tensors_take_the_plain_step_loop():
    _build.reset_launches()
    idx = _indices(2000, 4, "dense")
    trc.encode_indices_device(torch.from_numpy(idx), 4)
    assert _build.LAUNCHES["rans_step"] == 0


# -- the step loop's exact reciprocal divide ----------------------------------

def _all_f():
    return torch.arange(1, 1 << 14, dtype=torch.int64)


@pytest.mark.parametrize("ks", [
    range(1, 65),                                  # small quotients
    range((1 << 18) - 64, (1 << 18) + 1),          # top of the step's range
    [1 << 9, 1 << 12, 1 << 15, 3 << 14, 12345, 99991, 200001],
])
def test_recip_div_exact_at_multiples(ks):
    """Every f in [1, 2^14) at x = k*f - 1 and x = k*f, where a floor
    division steps, up to x < f * 2^18 (the state after renormalisation)."""
    f = _all_f()[:, None]
    k = torch.tensor(list(ks), dtype=torch.int64)[None, :]
    for x in (k * f - 1, k * f):
        x, ff = torch.broadcast_tensors(x, f)
        keep = x < ff << 18
        x, ff = x[keep], ff[keep]
        assert torch.equal(trc.recip_div(x, ff), x // ff)


def test_recip_div_exact_just_under_range_top():
    """The largest states the step sees, x in [f * 2^18 - 4096, f * 2^18),
    for every f; and the 32-bit top for every f (the formula holds for
    every 32-bit x)."""
    f = _all_f()[:, None]
    x = (f << 18) - torch.arange(1, 4097, dtype=torch.int64)[None, :]
    x, ff = torch.broadcast_tensors(x, f)
    assert torch.equal(trc.recip_div(x, ff), x // ff)
    top = torch.full_like(f, (1 << 32) - 1)
    assert torch.equal(trc.recip_div(top, f), top // f)


@given(st.integers(1, (1 << 14) - 1), st.data())
@settings(max_examples=300, deadline=None)
def test_recip_div_property(f, data):
    x = data.draw(st.integers(0, (f << 18) - 1))
    assert int(trc.recip_div(torch.tensor([x]), torch.tensor([f]))[0]) \
        == x // f


def test_recip_params_halves():
    f = _all_f()
    mh, ml = trc.recip_params(f)
    m = [-(-(1 << 63) // int(v)) for v in f]
    assert [int(h) << 32 | int(lo) for h, lo in zip(mh, ml)] == m
    assert int(ml.max()) < 1 << 32 and int(mh.max()) <= 1 << 31


def test_recip_div_quotient_of_renormalised_state():
    """``(x >> 16) // f`` is the quotient of the state before
    renormalisation shifted by 16, the identity that lets the step's
    least chain (``tools/rans_chain_probe.cu``) start the divide before
    the renormalise compare: every f, at the states where the step
    renormalises (x >= f * 2^18) and the quotient steps, up to 2^32."""
    f = _all_f()[:, None]
    k = torch.tensor([4, 5, 7, 100, 1000, 65535, 1 << 18],
                     dtype=torch.int64)[None, :]
    for x in ((k * f << 16) - 1, k * f << 16, (f << 18) + 0 * k,
              torch.full_like(k * f, (1 << 32) - 1)):
        x, ff = torch.broadcast_tensors(x, f)
        keep = (x >= ff << 18) & (x < 1 << 32)
        x, ff = x[keep], ff[keep]
        assert torch.equal(trc.recip_div(x, ff) >> 16, (x >> 16) // ff)


# -- the batched dispatch -----------------------------------------------------

# ragged chunk bounds: a 5-element chunk, an empty one, and chunks whose
# bit counts give different lane counts (4 to 256 lanes)
RAGGED = [(0, 5), (5, 5), (5, 905), (905, 12905), (12905, 70000)]


@pytest.mark.parametrize("n_levels", LEVELS)
@pytest.mark.parametrize("kind", ["sparse", "dense"])
def test_batched_dispatch_matches_reference(n_levels, kind):
    idx = _indices(70000, n_levels, kind, seed=5)
    got = trc.encode_index_chunks_device(torch.from_numpy(idx), n_levels,
                                         RAGGED)
    lanes = {jrans.lane_count(int(jbin.index_to_context_bits(
        idx[s:e], n_levels)[0].size)) for s, e in RAGGED if e > s}
    assert len(lanes) >= 3
    for (s, e), payload in zip(RAGGED, got):
        assert payload == _host_payload(idx[s:e], n_levels)
    want = jrc.encode_index_chunks_device(idx, n_levels, RAGGED,
                                          use_kernel=True, interpret=True)
    assert got == want


def test_batched_dispatch_out_of_order_bounds():
    """Bounds that are not back to back (overlapping, out of order) are
    gathered into one batch all the same."""
    idx = _indices(4000, 3, "dense", seed=6)
    bounds = [(1000, 3000), (0, 1500), (3999, 4000), (2000, 2000)]
    got = trc.encode_index_chunks_device(torch.from_numpy(idx), 3, bounds)
    assert got == [_host_payload(idx[s:e], 3) for s, e in bounds]


def test_batched_dispatch_one_size_pass(monkeypatch):
    calls = []
    real = trc._plane_sizes_batch

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(trc, "_plane_sizes_batch", counted)
    idx = torch.from_numpy(_indices(70000, 4, "dense"))
    pending = trc.dispatch_index_chunks(idx, 4, RAGGED)
    assert len(calls) == 1
    assert len(trc.finalize_index_chunks(pending)) == len(RAGGED)


@pytest.mark.parametrize("n_levels", [3, 16])
def test_batched_dispatch_counts_thresholds_in_groups(monkeypatch, n_levels):
    """A stream too long for the size pre-pass's budget takes its
    thresholds a few at a time (here one or two) and codes the same
    bytes."""
    idx = _indices(70000, n_levels, "dense", seed=8)
    monkeypatch.setattr(trc, "_COUNT_ELEMS", 100000)
    got = trc.encode_index_chunks_device(torch.from_numpy(idx), n_levels,
                                         RAGGED)
    assert got == [_host_payload(idx[s:e], n_levels) for s, e in RAGGED]


def test_batched_stream_table_matches_single_streams():
    """The plain step loop over the batch's stream table equals each
    stream coded alone through the one-stream wrapper."""
    idx = torch.from_numpy(_indices(20000, 4, "dense", seed=7))
    lengths = [5, 900, 19095]
    batch = trc._plane_batch(idx, lengths, 4)
    lay = batch.lay
    x, ov, w = trc.rans_steps(batch.bits, batch.segs, batch.table,
                              sum(lay.lanes), lay.n_cells, max(lay.lanes))
    for s, (mat, s0, ns, st, steps, lanes) in enumerate(
            batch.table.tolist()):
        sg = batch.segs[s0:s0 + ns].long()
        ends = torch.cat([sg[1:, 0], torch.tensor([steps])])
        f1 = torch.repeat_interleave(sg[:, 1], ends - sg[:, 0])
        cells = slice(mat, mat + steps * lanes)
        x1, ov1, w1 = trc.rans_step(
            batch.bits[cells].reshape(steps, lanes), f1, lanes)
        assert torch.equal(x[st:st + lanes], x1)
        assert torch.equal(ov[cells], ov1.reshape(-1))
        assert torch.equal(w[cells], w1.reshape(-1))
