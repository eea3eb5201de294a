"""Port vs reference: the banded layout and the tiled and ECSQ wrappers.

Inputs are made with numpy from a seed.  The reference runs its Pallas
kernels in interpret mode; the port takes the plain torch version of
each kernel (CPU tensors).  Geometries are those of the reference's
``test_tileplan.py`` / ``test_tile2d.py`` (non-multiples on purpose),
per-channel plans at g=1 and g=8, and n=513.  Tolerances: layouts,
indices, packed bytes, histograms and ECSQ reconstructions exact.
Uniform reconstructions equal the reference's jnp formula (run eagerly:
``lo + q * (span / (N-1))``, a correctly rounded divide and two
roundings) exactly.  Its interpreted Pallas kernel is compiled by XLA to
``fma(q, span * fl(1/(N-1)), lo)``: the division by a constant becomes a
reciprocal multiply, which moves ``q * delta`` by at most 3 * 2**-24 of
the span (3 units of float32 at the range's scale), and the fused add
by at most half a unit.  So the reconstructions sit within 3.5 units of
their dtype at the range's scale (``_range_ulps``) of the kernel's; 2.5
is the largest seen here.
"""

import dataclasses

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core.backend import JnpBackend
from repro.core.backend import QuantSpec as JQuantSpec
from repro.core.tiling import TilePlan as JTilePlan
from repro.kernels import ops as jops
from repro_torch.core.tiling import TilePlan, spatial_grid
from repro_torch.kernels import _build
from repro_torch.kernels import ops as tops

LEVELS = (2, 3, 4, 8, 16, 64)
DTYPES = {"float32": (np.float32, torch.float32),
          "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16)}

# (shape, channel_axis, channel_group, spatial_block, block_hw)
GEOMETRIES = {
    "tile-300x12-g1-b64": ((300, 12), -1, 1, 64, None),
    "tile-300x12-g5-b100": ((300, 12), -1, 5, 100, None),
    "tile-7x33x10-g4-b17": ((7, 33, 10), 1, 4, 17, None),
    "chan-12x250-g3": ((12, 250), 0, 3, 0, None),
    "tile-1x130x6-g6-b130": ((1, 130, 6), -1, 6, 130, None),
    "chan-64x32-g1": ((64, 32), -1, 1, 0, None),
    "chan-64x32-g8": ((64, 32), -1, 8, 0, None),
    "chan-4x1x64-g8": ((4, 1, 64), -1, 8, 0, None),
    "chan-n513-g1": ((513, 3), -1, 1, 0, None),
    "tile-n513-g1-b100": ((513, 3), -1, 1, 100, None),
    "2d-1x5x13x11": ((1, 5, 13, 11), 1, 2, 0, (4, 3)),
    "2d-6x9x4": ((6, 9, 4), -1, 1, 0, (3, 3)),
    "2d-3x10x10": ((3, 10, 10), 0, 3, 0, (1, 1)),
    "2d-2x7x9": ((2, 7, 9), 0, 2, 0, (7, 9)),
    "2d-4x6x5": ((4, 6, 5), 0, 4, 0, (100, 100)),
    "2d-2x3x8x7": ((2, 3, 8, 7), -1, 7, 0, (5, 2)),
}
# one channel plan, one 1-D plan with a short last block, one ragged 2-D
KERNEL_GEOMETRIES = ["chan-64x32-g8", "tile-300x12-g5-b100",
                     "2d-1x5x13x11"]


def _plans(name):
    """The same plan in both packages."""
    shape, axis, gc, bs, bhw = GEOMETRIES[name]
    c = shape[axis]
    m = int(np.prod(shape)) // c
    kw = dict(channel_axis=axis, channel_group_size=gc, n_channels=c)
    if bhw is not None:
        kw.update(spatial_block_size=0, spatial_extent=m,
                  spatial_hw=spatial_grid(shape, axis),
                  spatial_block_hw=bhw)
    else:
        kw.update(spatial_block_size=bs, spatial_extent=m if bs else None)
    return shape, TilePlan(**kw), JTilePlan(**kw)


def _x(shape, seed=0):
    rng = np.random.default_rng([seed, *shape])
    return (rng.standard_normal(shape) * 2.0 + 0.3).astype(np.float32)


def _ranges(plan, seed=0):
    """Per-tile (lo, hi) tables, one tile degenerate (lo == hi)."""
    rng = np.random.default_rng([seed, plan.n_tiles])
    shape = (plan.n_cgroups, plan.n_sblocks)
    lo = rng.uniform(-3, 0, shape).astype(np.float32)
    hi = (lo + rng.uniform(0.5, 4, shape)).astype(np.float32)
    hi.flat[plan.n_tiles // 2] = lo.flat[plan.n_tiles // 2]
    return lo, hi


def _ecsq_tables(lo, hi, n_levels, seed=0):
    """Sorted float32 (thresholds (..., N-1), levels (..., N)) in each
    [lo, hi]: levels pinned to the clip range, thresholds between
    neighbours."""
    rng = np.random.default_rng([seed, n_levels, lo.size])
    lo = np.asarray(lo, np.float64)[..., None]
    hi = np.asarray(hi, np.float64)[..., None]
    u = np.sort(rng.uniform(0, 1, lo.shape[:-1] + (n_levels - 2,)), -1)
    levels = np.concatenate([lo, lo + (hi - lo) * u, hi], -1)
    thresholds = (levels[..., 1:] + levels[..., :-1]) / 2
    return thresholds.astype(np.float32), levels.astype(np.float32)


def _range_ulps(a, b, dtype, scale: float) -> float:
    """Largest distance in units of the last place of ``dtype`` at the
    range's scale."""
    unit = float(np.spacing(np.asarray(scale, np.float32).astype(dtype))
                 .astype(np.float32))
    diff = np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))
    return float(np.max(diff, initial=0.0)) / unit


def _t(a, tdtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(tdtype)


# -- layout -------------------------------------------------------------------

@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_banded_layout_matches_reference(name):
    shape, tplan, jplan = _plans(name)
    tlay = tops.banded_layout(shape, tplan)
    jlay = jops.banded_layout(shape, jplan)
    assert dataclasses.astuple(tlay) == dataclasses.astuple(jlay)
    assert np.array_equal(tops._padded_cols(tplan, tlay),
                          jops._padded_cols(jplan, jlay))


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_banded_view_unband_and_row_ranges_match_reference(name):
    shape, tplan, jplan = _plans(name)
    x = _x(shape)
    tlay = tops.banded_layout(shape, tplan)
    jlay = jops.banded_layout(shape, jplan)
    txp, tmoved = tops._banded_view(torch.from_numpy(x), tlay, tplan)
    jxp, jmoved = jops._banded_view(jnp.asarray(x), jlay, jplan)
    assert tmoved == tuple(jmoved)
    assert np.array_equal(txp.numpy(), np.asarray(jxp))
    axis = tplan.channel_axis % len(shape)
    back = tops._unband(txp, tlay, tmoved, axis, tplan)
    assert np.array_equal(back.numpy(), x)
    assert np.array_equal(back.numpy(), np.asarray(
        jops._unband(jxp, jlay, jmoved, axis, jplan)))
    lo, hi = _ranges(tplan)
    tr = tops._row_ranges(_t(lo), _t(hi), tlay)
    jr = jops._row_ranges(jnp.asarray(lo), jnp.asarray(hi), jlay)
    for a, b in zip(tr, jr):
        assert np.array_equal(a.numpy(), np.asarray(b))


# -- uniform per-tile quantizer (kernel #2) -----------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n_levels", LEVELS)
@pytest.mark.parametrize("name", KERNEL_GEOMETRIES)
def test_clip_quantize_tiled_matches_interpret(name, n_levels, dtype):
    npdt, tdt = DTYPES[dtype]
    shape, tplan, jplan = _plans(name)
    x = _x(shape, seed=1).astype(npdt)
    lo, hi = _ranges(tplan, seed=1)
    jidx, jdeq = jops.clip_quantize_tiled(
        jnp.asarray(x), jnp.asarray(lo), jnp.asarray(hi), n_levels=n_levels,
        plan=jplan, interpret=True)
    tidx, tdeq = tops.clip_quantize_tiled(_t(x, tdt), lo, hi,
                                          n_levels=n_levels, plan=tplan)
    assert tidx.dtype == torch.int32 and tdeq.dtype == tdt
    assert tuple(tidx.shape) == shape
    assert np.array_equal(tidx.numpy(), np.asarray(jidx))
    _, edeq = JnpBackend().quantize_dequantize(
        jnp.asarray(x), JQuantSpec(lo, hi, n_levels, plan=jplan))
    assert np.array_equal(tdeq.float().numpy(), np.asarray(edeq, np.float32))
    scale = float(max(np.abs(lo).max(), np.abs(hi).max(), (hi - lo).max()))
    assert _range_ulps(tdeq.float().numpy(), np.asarray(jdeq, np.float32),
                       npdt, scale) <= 3.5


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n_levels", LEVELS)
def test_clip_quantize_channels_matches_interpret(n_levels, dtype):
    npdt, tdt = DTYPES[dtype]
    x = _x((40, 6), seed=2).astype(npdt)
    rng = np.random.default_rng(n_levels)
    cmin = rng.uniform(-3, 0, 6).astype(np.float32)
    cmax = (cmin + rng.uniform(0.5, 4, 6)).astype(np.float32)
    jidx, jdeq = jops.clip_quantize_channels(
        jnp.asarray(x), jnp.asarray(cmin), jnp.asarray(cmax),
        n_levels=n_levels, channel_axis=-1, interpret=True)
    tidx, tdeq = tops.clip_quantize_channels(_t(x, tdt), cmin, cmax,
                                             n_levels=n_levels,
                                             channel_axis=-1)
    assert np.array_equal(tidx.numpy(), np.asarray(jidx))
    _, edeq = JnpBackend().quantize_dequantize(
        jnp.asarray(x), JQuantSpec(cmin, cmax, n_levels, channel_axis=-1))
    assert np.array_equal(tdeq.float().numpy(), np.asarray(edeq, np.float32))
    scale = float(max(np.abs(cmin).max(), np.abs(cmax).max(),
                      (cmax - cmin).max()))
    assert _range_ulps(tdeq.float().numpy(), np.asarray(jdeq, np.float32),
                       npdt, scale) <= 3.5


# -- per-tile histogram (kernel #5) -------------------------------------------

@pytest.mark.parametrize("n_levels", LEVELS)
@pytest.mark.parametrize("name", KERNEL_GEOMETRIES + ["chan-n513-g1",
                                                     "2d-2x3x8x7"])
def test_index_histogram_tiled_matches_interpret(name, n_levels):
    shape, tplan, jplan = _plans(name)
    rng = np.random.default_rng([n_levels, len(shape)])
    idx = rng.integers(0, n_levels, shape).astype(np.int32)
    want = jops.index_histogram_tiled(jnp.asarray(idx), n_levels=n_levels,
                                      plan=jplan, interpret=True)
    got = tops.index_histogram_tiled(torch.from_numpy(idx),
                                     n_levels=n_levels, plan=tplan)
    assert got.dtype == torch.int32
    assert tuple(got.shape) == (tplan.n_cgroups, tplan.n_sblocks, n_levels)
    assert np.array_equal(got.numpy(), np.asarray(want))


# -- ECSQ (kernels #7 and #8) -------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n_levels", LEVELS)
def test_ecsq_quantize_matches_interpret(n_levels, dtype):
    npdt, tdt = DTYPES[dtype]
    x = _x((33, 31), seed=3).astype(npdt)
    cmin, cmax = -1.7, 2.9
    thr, lvl = _ecsq_tables(np.float32(cmin), np.float32(cmax), n_levels)
    # an input exactly on a threshold goes to the upper bin
    k = (n_levels - 1) // 2
    thr[k] = np.float32(np.asarray(thr[k]).astype(npdt))
    x.flat[5] = thr[k]
    thr = np.sort(thr)
    jidx, jdeq = jops.ecsq_quantize(jnp.asarray(x), jnp.asarray(thr),
                                    jnp.asarray(lvl), cmin=cmin, cmax=cmax,
                                    interpret=True)
    tidx, tdeq = tops.ecsq_quantize(_t(x, tdt), thr, lvl, cmin=cmin,
                                    cmax=cmax)
    assert tidx.dtype == torch.int32 and tdeq.dtype == tdt
    assert np.array_equal(tidx.numpy(), np.asarray(jidx))
    assert np.array_equal(tdeq.float().numpy(), np.asarray(jdeq, np.float32))
    assert tidx.reshape(-1)[5] == np.searchsorted(
        thr, np.float32(x.flat[5]), side="right")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n_levels", LEVELS)
@pytest.mark.parametrize("name", KERNEL_GEOMETRIES)
def test_ecsq_quantize_tiled_matches_interpret(name, n_levels, dtype):
    npdt, tdt = DTYPES[dtype]
    shape, tplan, jplan = _plans(name)
    x = _x(shape, seed=4).astype(npdt)
    lo, hi = _ranges(tplan, seed=4)
    thr, lvl = _ecsq_tables(lo.reshape(-1), hi.reshape(-1), n_levels)
    # an input exactly on one of its tile's thresholds
    t0 = int(tplan.tile_ids(shape).flat[7])
    k = (n_levels - 1) // 2
    thr[t0, k] = np.float32(np.asarray(thr[t0, k]).astype(npdt))
    x.flat[7] = thr[t0, k]
    thr = np.sort(thr, axis=-1)
    jidx, jdeq = jops.ecsq_quantize_tiled(
        jnp.asarray(x), jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(thr),
        jnp.asarray(lvl), n_levels=n_levels, plan=jplan, interpret=True)
    tidx, tdeq = tops.ecsq_quantize_tiled(_t(x, tdt), lo, hi, thr, lvl,
                                          n_levels=n_levels, plan=tplan)
    assert tidx.dtype == torch.int32 and tdeq.dtype == tdt
    assert np.array_equal(tidx.numpy(), np.asarray(jidx))
    assert np.array_equal(tdeq.float().numpy(), np.asarray(jdeq, np.float32))


# -- encode megakernel over the banded view (kernel #3, plan route) -----------

@pytest.mark.parametrize("bits_levels", [(1, 2), (2, 4), (4, 16), (6, 64)])
@pytest.mark.parametrize("name", KERNEL_GEOMETRIES + ["chan-4x1x64-g8",
                                                     "chan-n513-g1"])
def test_encode_fused_plan_matches_interpret(name, bits_levels):
    bits, n_levels = bits_levels
    shape, tplan, jplan = _plans(name)
    x = _x(shape, seed=5)
    lo, hi = _ranges(tplan, seed=5)
    jp, jh, jlay = jops.encode_fused(jnp.asarray(x), lo, hi,
                                     n_levels=n_levels, bits=bits,
                                     plan=jplan, interpret=True)
    tp, th, tlay = tops.encode_fused(torch.from_numpy(x), lo, hi,
                                     n_levels=n_levels, bits=bits,
                                     plan=tplan)
    assert dataclasses.astuple(tlay) == dataclasses.astuple(jlay)
    assert tp.dtype == torch.uint8
    assert np.array_equal(tp.numpy(), np.asarray(jp))
    assert np.array_equal(th.numpy(), np.asarray(jh))
    # the wire's coded-order indices are the tiled quantizer's, and the
    # per-tile counts its histogram
    coded = tlay.unpack_indices(tops.unpack_bytes(tp.numpy(), bits))
    idx, _ = tops.clip_quantize_tiled(torch.from_numpy(x), lo, hi,
                                      n_levels=n_levels, plan=tplan)
    assert np.array_equal(coded, tplan.to_coded_order(idx.numpy()))
    assert np.array_equal(
        tlay.group_hists(th.numpy(), n_levels, 64),
        tops.index_histogram_tiled(idx, n_levels=n_levels,
                                   plan=tplan).numpy())


# -- dispatch -----------------------------------------------------------------

def test_tiled_wrappers_refuse_other_devices():
    _, tplan, _ = _plans("chan-64x32-g8")
    lo, hi = _ranges(tplan)
    x = torch.zeros(64, 32, device="meta")
    with pytest.raises(ValueError, match="device"):
        tops.clip_quantize_tiled(x, _t(lo).to("meta"), _t(hi).to("meta"),
                                 n_levels=4, plan=tplan)
    with pytest.raises(ValueError, match="device"):
        tops.index_histogram_tiled(torch.zeros(64, 32, dtype=torch.int32,
                                               device="meta"),
                                   n_levels=4, plan=tplan)


def test_tiled_wrappers_check_shapes():
    _, tplan, _ = _plans("chan-64x32-g8")
    lo, hi = _ranges(tplan)
    with pytest.raises(ValueError, match="channels"):
        tops.clip_quantize_tiled(torch.zeros(64, 16), lo, hi, n_levels=4,
                                 plan=tplan)
    thr, lvl = _ecsq_tables(lo.reshape(-1), hi.reshape(-1), 4)
    with pytest.raises(ValueError, match="thresholds"):
        tops.ecsq_quantize_tiled(torch.zeros(64, 32), lo, hi, thr, lvl[:, :3],
                                 n_levels=3, plan=tplan)
    with pytest.raises(ValueError, match="n_levels"):
        tops.index_histogram_tiled(torch.zeros(64, 32, dtype=torch.int32),
                                   n_levels=65, plan=tplan)


def test_cpu_launch_counts_stay_zero():
    _build.reset_launches()
    _, tplan, _ = _plans("tile-300x12-g5-b100")
    x = torch.from_numpy(_x((300, 12)))
    lo, hi = _ranges(tplan)
    idx, _ = tops.clip_quantize_tiled(x, lo, hi, n_levels=4, plan=tplan)
    tops.index_histogram_tiled(idx, n_levels=4, plan=tplan)
    thr, lvl = _ecsq_tables(lo.reshape(-1), hi.reshape(-1), 4)
    tops.ecsq_quantize_tiled(x, lo, hi, thr, lvl, n_levels=4, plan=tplan)
    tops.encode_fused(x, lo, hi, n_levels=4, bits=2, plan=tplan)
    assert all(v == 0 for v in _build.LAUNCHES.values())
