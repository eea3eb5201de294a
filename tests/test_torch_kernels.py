"""Port vs reference: the kernel modules' plain versions and wrappers.

Inputs are made with numpy from a seed.  The reference runs its Pallas
kernels in interpret mode; the port takes the plain torch version of
each kernel (CPU tensors).  Tolerances: indices, packed bytes and
histograms exact; dequantized values within 1 ulp of their dtype at the
clip range's scale (see ``_range_ulps``).
"""

import dataclasses

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import fused_clip_quant as jfcq
from repro.kernels import ops as jops
from repro_torch.kernels import _build
from repro_torch.kernels import fused_clip_quant as tfcq
from repro_torch.kernels import ops as tops
from repro_torch.kernels import rate_hist as trh

LEVELS = (2, 3, 4, 8, 16, 64)
DTYPES = {"float32": (np.float32, torch.float32),
          "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16)}


def _x(n, seed=0):
    rng = np.random.default_rng([seed, n])
    return (rng.standard_normal(n) * 2.0 + 0.5).astype(np.float32)


def _range_ulps(a, b, dtype, cmin: float, cmax: float) -> float:
    """Largest distance in units of the last place of ``dtype`` at the
    clip range's scale (the largest of |cmin|, |cmax| and the span).
    ``lo + q * delta`` is rounded twice here and may be fused into one
    rounding by the reference's compiler; the two differ by less than
    one such unit (near zero that is many ulps of the tiny result
    itself, so a per-value ulp is the wrong yardstick)."""
    scale = np.asarray(max(abs(cmin), abs(cmax), cmax - cmin),
                       np.float32).astype(dtype)
    unit = float(np.spacing(scale).astype(np.float32))
    diff = np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))
    return float(np.max(diff, initial=0.0)) / unit


def _to_torch(a: np.ndarray, tdtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(tdtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n_levels", LEVELS)
@pytest.mark.parametrize("n", [513, 4096])
def test_clip_quantize_matches_interpret(n, n_levels, dtype):
    npdt, tdt = DTYPES[dtype]
    x = _x(n).astype(npdt)
    cmin, cmax = -1.131127, 3.449994
    jidx, jdeq = jops.clip_quantize(jnp.asarray(x), cmin=cmin, cmax=cmax,
                                    n_levels=n_levels, interpret=True)
    tidx, tdeq = tops.clip_quantize(_to_torch(x, tdt), cmin=cmin,
                                    cmax=cmax, n_levels=n_levels)
    assert tidx.dtype == torch.int32 and tdeq.dtype == tdt
    assert np.array_equal(tidx.numpy(), np.asarray(jidx))
    assert _range_ulps(tdeq.float().numpy(), np.asarray(jdeq, np.float32),
                       npdt, cmin, cmax) <= 1


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n_levels", LEVELS)
@pytest.mark.parametrize("n", [513, 4096])
def test_clip_quant_with_histogram_matches_interpret(n, n_levels, dtype):
    """#1's plain version asked for the histogram of its indices (with and
    without the reconstruction): the reference's interpreted clip_quant_2d
    indices exactly and its reconstruction within 1 unit, and the bins of
    its interpreted index_histogram_2d exactly."""
    npdt, tdt = DTYPES[dtype]
    x = _x(n, seed=2).astype(npdt)
    cmin, cmax = -0.83, 2.61
    jidx, jdeq = jops.clip_quantize(jnp.asarray(x), cmin=cmin, cmax=cmax,
                                    n_levels=n_levels, interpret=True)
    jhist = np.asarray(jops.index_histogram(jidx, n_levels=n_levels,
                                            interpret=True))
    tx = _to_torch(x, tdt)
    ti, td, th = tfcq.clip_quant_plain(tx, cmin, cmax, n_levels,
                                       want_hist=True)
    assert np.array_equal(ti.numpy(), np.asarray(jidx))
    assert _range_ulps(td.float().numpy(), np.asarray(jdeq, np.float32),
                       npdt, cmin, cmax) <= 1
    assert th.dtype == torch.int32 and np.array_equal(th.numpy(), jhist)
    oi, od, oh = tops.clip_quantize(tx, cmin=cmin, cmax=cmax,
                                    n_levels=n_levels, want_deq=False,
                                    want_hist=True)
    assert od is None and torch.equal(oi, ti) and torch.equal(oh, th)
    assert len(tfcq.clip_quant_plain(tx, cmin, cmax, n_levels)) == 2


@pytest.mark.parametrize("bits_levels", [(1, 2), (2, 3), (2, 4), (3, 8),
                                         (4, 16), (6, 64)])
@pytest.mark.parametrize("n", [513, 3000])
def test_encode_fused_flat_matches_interpret(n, bits_levels):
    bits, n_levels = bits_levels
    x = _x(n, seed=1)
    jp, jh, jlay = jops.encode_fused(jnp.asarray(x), -0.7, 3.1,
                                     n_levels=n_levels, bits=bits,
                                     interpret=True)
    tp, th, tlay = tops.encode_fused(torch.from_numpy(x), -0.7, 3.1,
                                     n_levels=n_levels, bits=bits)
    assert dataclasses.astuple(tlay) == dataclasses.astuple(jlay)
    assert tp.dtype == torch.uint8
    assert np.array_equal(tp.numpy(), np.asarray(jp))
    assert np.array_equal(th.numpy(), np.asarray(jh))
    # the host-side unpack recovers the quantizer's indices exactly
    coded = tlay.unpack_indices(tops.unpack_bytes(tp.numpy(), bits))
    idx, _ = tops.clip_quantize(torch.from_numpy(x), cmin=-0.7, cmax=3.1,
                                n_levels=n_levels)
    assert np.array_equal(coded, idx.numpy())


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("bits_levels", [(2, 4), (4, 16), (6, 40)])
def test_encode_tiles_banded_ragged_matches_interpret(bits_levels, dtype):
    """n_sblocks > 1 with ragged per-band valid counts and per-(row, band)
    ranges, including a degenerate (lo == hi) band."""
    bits, n_levels = bits_levels
    npdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(7)
    rows, nb, sb_cols = 16, 3, 256
    x = (rng.standard_normal((rows, nb * sb_cols)) * 3).astype(npdt)
    lo = rng.uniform(-3, 0, (rows, nb)).astype(np.float32)
    hi = (lo + rng.uniform(0.5, 4, (rows, nb))).astype(np.float32)
    hi[2, 1] = lo[2, 1]
    valid = (256, 130, 7)
    jp, jh = jfcq.encode_tiles_2d(jnp.asarray(x), jnp.asarray(lo),
                                  jnp.asarray(hi), n_levels, bits,
                                  sb_cols=sb_cols, bs=256,
                                  band_valid=valid, block=(8, 128),
                                  interpret=True)
    tp, th = tfcq.encode_tiles_2d(_to_torch(x, tdt), torch.from_numpy(lo),
                                  torch.from_numpy(hi), n_levels, bits,
                                  sb_cols=sb_cols, bs=256, band_valid=valid)
    assert np.array_equal(tp.numpy(), np.asarray(jp).astype(np.uint8))
    assert np.array_equal(th.numpy(), np.asarray(jh))


@pytest.mark.parametrize("n_levels", LEVELS)
@pytest.mark.parametrize("n", [1, 513, 5000])
def test_index_histogram_matches_interpret(n, n_levels):
    rng = np.random.default_rng([n, n_levels])
    idx = rng.integers(0, n_levels, n).astype(np.int32)
    want = jops.index_histogram(jnp.asarray(idx), n_levels=n_levels,
                                interpret=True)
    got = tops.index_histogram(torch.from_numpy(idx), n_levels=n_levels)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_index_histogram_ignores_out_of_range():
    idx = torch.tensor([0, 1, 5, -1, 3, 3], dtype=torch.int32)
    assert trh.index_histogram_2d(idx, 4).tolist() == [1, 1, 0, 2]


@pytest.mark.parametrize("n", [1, 100, 128, 129, 513, 1024, 1025, 70000,
                               300000])
def test_flat_layout_matches_reference(n):
    assert dataclasses.astuple(tops.flat_layout(n)) == \
        dataclasses.astuple(jops.flat_layout(n))


def test_cpu_tensors_take_plain_versions():
    _build.reset_launches()
    x = torch.from_numpy(_x(2048))
    tops.clip_quantize(x, cmin=0.0, cmax=1.0, n_levels=4)
    tops.encode_fused(x, 0.0, 1.0, n_levels=4, bits=2)
    tops.index_histogram(torch.zeros(10, dtype=torch.int32), n_levels=4)
    assert all(v == 0 for v in _build.LAUNCHES.values())


def test_other_devices_are_refused():
    x = torch.zeros(8, device="meta")
    with pytest.raises(ValueError, match="device"):
        tfcq.clip_quant_2d(x, 0.0, 1.0, 4)
    with pytest.raises(ValueError, match="device"):
        trh.index_histogram_2d(torch.zeros(8, dtype=torch.int32,
                                           device="meta"), 4)


def test_launch_counts_are_exact_from_many_threads(monkeypatch):
    """``_build.launch`` counts under its lock: 8 threads launching
    through a stubbed library (no card needed) lose no count, with the
    interpreter switching threads every microsecond."""
    import sys
    import threading
    import types

    class Stream:
        cuda_stream = 0

    stub = types.SimpleNamespace(repro_pack_bits=lambda *args: 0)
    monkeypatch.setattr(_build, "library", lambda: stub)
    monkeypatch.setattr(_build.torch.cuda, "current_stream",
                        lambda *a: Stream())
    before = dict(_build.LAUNCHES)
    n_threads, per_thread = 8, 2000

    def work():
        for _ in range(per_thread):
            _build.launch("pack_bits", "repro_pack_bits", 0, 0, 0, 0)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert _build.LAUNCHES["pack_bits"] - before["pack_bits"] == \
        n_threads * per_thread
    assert {k: v for k, v in _build.LAUNCHES.items() if k != "pack_bits"} \
        == {k: v for k, v in before.items() if k != "pack_bits"}
