"""Port vs reference: the device rANS entropy stage (coder id 4).

Inputs are made with numpy from a seed and coded by both packages; the
port runs its plain step loop on CPU tensors.  Tolerance: payload bytes
are exact.
"""

import numpy as np
import pytest
import torch

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
