"""Port vs reference: the per-tile quantizer's (#2) index-only, counting
and packing variants, the per-tile ECSQ quantizer's (#8) index-only and
coded-order variants, and the codec rate paths that take them.

Inputs are made with numpy from a seed.  The reference runs its Pallas
kernels in interpret mode, as a chain: ``clip_quant_tiles_2d`` (through
``ops.clip_quantize_tiled``), then ``index_histogram_tiles_2d``
(``ops.index_histogram_tiled``) and ``pack_rows_2d``
(``ops.pack_indices``); for ECSQ ``ecsq_assign_tiles_2d``
(``ops.ecsq_quantize_tiled``), then ``TilePlan.to_coded_order``.  The
port takes the plain torch version of each kernel (CPU tensors), the
counting and packing variants one call.  Geometries: channel groups of
1, 8 and 64 (one of them with a short last group), channels last and
first, a ragged 1-D tile plan and a ragged 2-D plan; only channels last
with one spatial block and groups of 8-256 take the fast route, the only
one that counts and packs.  Tolerances: indices, bins, bytes and ECSQ
reconstructions exact; uniform reconstructions equal the reference's
eager jnp formula exactly (``tests/test_torch_tiled.py`` states why its
interpreted kernel sits within 3.5 units).  The codecs' rates equal the
port's two-pass rate exactly and the reference's within rel 1e-5 (torch
and jnp take log2 and the sum in their own ways).
"""

import functools

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import CodecConfig as JCodecConfig
from repro.core import calibrate as jcalibrate
from repro.core.backend import JnpBackend
from repro.core.backend import QuantSpec as JQuantSpec
from repro.core.tiling import TilePlan as JTilePlan
from repro.kernels import ops as jops
from repro_torch.core import CodecConfig, calibrate
from repro_torch.core.backend import QuantSpec, get_backend
from repro_torch.core.tiling import TileECSQ, TilePlan, spatial_grid
from repro_torch.kernels import _build
from repro_torch.kernels import ecsq_assign as ea
from repro_torch.kernels import fused_clip_quant as fcq
from repro_torch.kernels import ops as tops

LEVELS = (2, 4, 16)
PACKS = ((1, 2), (2, 4), (4, 16))          # (bits, n_levels)
DTYPES = {"float32": (np.float32, torch.float32),
          "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16)}

# (shape, channel_axis, channel_group, spatial_block, block_hw, fast)
GEOMETRIES = {
    "last-g8": ((3, 5, 64), -1, 8, 0, None, True),
    "last-g64": ((6, 128), -1, 64, 0, None, True),
    "last-g64-short": ((7, 96), -1, 64, 0, None, True),
    "last-g1": ((5, 24), -1, 1, 0, None, False),
    "first-g8": ((64, 7), 0, 8, 0, None, False),
    "ragged-1d-g8": ((250, 16), -1, 8, 100, None, False),
    "ragged-2d-g2": ((1, 5, 13, 11), 1, 2, 0, (4, 3), False),
}
FAST = [k for k, v in GEOMETRIES.items() if v[-1]]
SLOW = [k for k, v in GEOMETRIES.items() if not v[-1]]


def _plans(name):
    """The same plan in both packages."""
    shape, axis, gc, bs, bhw, _ = GEOMETRIES[name]
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


def _x(name, dtype):
    """Seeded values, about a tenth outside the tiles' ranges."""
    shape = GEOMETRIES[name][0]
    rng = np.random.default_rng([7, *shape])
    x = (rng.standard_normal(shape) * 2.0 + 0.3).astype(np.float32)
    return x.astype(DTYPES[dtype][0])


def _ranges(plan):
    """Per-tile (lo, hi) tables, one tile degenerate (lo == hi)."""
    rng = np.random.default_rng([8, plan.n_tiles])
    shape = (plan.n_cgroups, plan.n_sblocks)
    lo = rng.uniform(-3, 0, shape).astype(np.float32)
    hi = (lo + rng.uniform(0.5, 4, shape)).astype(np.float32)
    hi.flat[plan.n_tiles // 2] = lo.flat[plan.n_tiles // 2]
    return lo, hi


def _ecsq_tables(lo, hi, n_levels):
    """Sorted float32 (thresholds (..., N-1), levels (..., N)) in each
    tile's [lo, hi]."""
    rng = np.random.default_rng([9, n_levels, lo.size])
    lo = np.asarray(lo, np.float64).reshape(-1)[:, None]
    hi = np.asarray(hi, np.float64).reshape(-1)[:, None]
    u = np.sort(rng.uniform(0, 1, (lo.shape[0], n_levels - 2)), -1)
    levels = np.concatenate([lo, lo + (hi - lo) * u, hi], -1)
    thresholds = (levels[:, 1:] + levels[:, :-1]) / 2
    return thresholds.astype(np.float32), levels.astype(np.float32)


def _tx(x):
    t = torch.from_numpy(np.asarray(x, np.float32))
    return t.to(torch.bfloat16) if x.dtype == ml_dtypes.bfloat16 else t


@functools.lru_cache(maxsize=None)
def _uniform_reference(name, n_levels, dtype):
    """The reference chain on the uniform tile quantizer: interpreted
    indices, the eager jnp reconstruction and the interpreted per-tile
    histogram (numpy)."""
    shape, _, jplan = _plans(name)
    x = _x(name, dtype)
    lo, hi = _ranges(jplan)
    jidx, _ = jops.clip_quantize_tiled(jnp.asarray(x), jnp.asarray(lo),
                                       jnp.asarray(hi), n_levels=n_levels,
                                       plan=jplan, interpret=True)
    _, edeq = JnpBackend().quantize_dequantize(
        jnp.asarray(x), JQuantSpec(lo, hi, n_levels, plan=jplan))
    jhist = jops.index_histogram_tiled(jidx, n_levels=n_levels, plan=jplan,
                                       interpret=True)
    return (np.asarray(jidx), np.asarray(edeq, np.float32),
            np.asarray(jhist))


@functools.lru_cache(maxsize=None)
def _ecsq_reference(name, n_levels, dtype):
    """The reference's interpreted per-tile ECSQ: (indices,
    reconstruction as float32, coded-order indices)."""
    shape, _, jplan = _plans(name)
    x = _x(name, dtype)
    lo, hi = _ranges(jplan)
    thr, lvl = _ecsq_tables(lo, hi, n_levels)
    jidx, jdeq = jops.ecsq_quantize_tiled(
        jnp.asarray(x), jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(thr),
        jnp.asarray(lvl), n_levels=n_levels, plan=jplan, interpret=True)
    jidx = np.asarray(jidx)
    return jidx, np.asarray(jdeq, np.float32), jplan.to_coded_order(jidx)


def _port_tables(name):
    shape, tplan, _ = _plans(name)
    lo, hi = _ranges(tplan)
    return (tplan, tops._f32(lo, "cpu", lo.shape),
            tops._f32(hi, "cpu", hi.shape))


# -- the route -----------------------------------------------------------------

@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_fast_route_predicate(name):
    """The fast route takes channels last, one spatial block, groups of
    8-256 and a channel count divisible by 8; the plan-level predicate the
    backends decide by agrees with it."""
    shape, tplan, _ = _plans(name)
    maps = fcq.tile_maps(tplan, shape, "cpu")
    assert fcq.fast_route(maps) == GEOMETRIES[name][-1]
    assert fcq.plan_fast_route(tplan) == GEOMETRIES[name][-1]


# -- #2: index-only, counting and packing variants -------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n_levels", LEVELS)
@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_tiles_index_only_matches_interpret(name, n_levels, dtype):
    """Every plan: the indices alone, no reconstruction."""
    plan, lo, hi = _port_tables(name)
    jidx, _, _ = _uniform_reference(name, n_levels, dtype)
    idx, deq = fcq.clip_quant_tiles(_tx(_x(name, dtype)), lo, hi, n_levels,
                                    plan, want_deq=False)
    assert deq is None and idx.dtype == torch.int32
    assert np.array_equal(idx.numpy(), jidx)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n_levels", LEVELS)
@pytest.mark.parametrize("name", FAST)
def test_tiles_counting_matches_interpret(name, n_levels, dtype):
    """The fast route's counting variant, with and without the
    reconstruction: the reference's indices, its eager reconstruction and
    its per-tile histogram of the indices."""
    plan, lo, hi = _port_tables(name)
    jidx, edeq, jhist = _uniform_reference(name, n_levels, dtype)
    x = _tx(_x(name, dtype))
    idx, deq, hist = fcq.clip_quant_tiles(x, lo, hi, n_levels, plan,
                                          want_hist=True)
    assert np.array_equal(idx.numpy(), jidx)
    assert deq.dtype == x.dtype
    assert np.array_equal(deq.float().numpy(), edeq)
    assert hist.dtype == torch.int32
    assert hist.shape == (plan.n_cgroups, 1, n_levels)
    assert np.array_equal(hist.numpy(), jhist)
    idx2, none, hist2 = fcq.clip_quant_tiles(x, lo, hi, n_levels, plan,
                                             want_deq=False, want_hist=True)
    assert none is None and torch.equal(idx2, idx)
    assert torch.equal(hist2, hist)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("bits,n_levels", PACKS)
@pytest.mark.parametrize("name", FAST)
def test_tiles_pack_matches_interpret(name, bits, n_levels, dtype):
    """The fast route's packing variant: the bytes of the reference's
    interpreted pack of its indices, and its per-tile histogram."""
    plan, lo, hi = _port_tables(name)
    jidx, _, jhist = _uniform_reference(name, n_levels, dtype)
    want = np.asarray(jops.pack_indices(jnp.asarray(jidx), bits=bits,
                                        interpret=True))
    packed, hist = fcq.clip_quant_tiles_pack(_tx(_x(name, dtype)), lo, hi,
                                             n_levels, plan, bits)
    assert packed.dtype == torch.uint8
    assert np.array_equal(packed.numpy(), want)
    assert np.array_equal(hist.numpy(), jhist)


@pytest.mark.parametrize("name", SLOW)
def test_counting_and_packing_refused_off_the_fast_route(name):
    plan, lo, hi = _port_tables(name)
    x = _tx(_x(name, "float32"))
    with pytest.raises(ValueError, match="fast route"):
        fcq.clip_quant_tiles(x, lo, hi, 4, plan, want_hist=True)
    with pytest.raises(ValueError, match="fast route"):
        fcq.clip_quant_tiles_pack(x, lo, hi, 4, plan, 2)
    thr, lvl = _ecsq_tables(lo.numpy(), hi.numpy(), 4)
    shape = (plan.n_cgroups, plan.n_sblocks, -1)
    with pytest.raises(ValueError, match="fast route"):
        ea.ecsq_assign_tiles_coded(x, lo, hi,
                                   torch.from_numpy(thr).reshape(shape),
                                   torch.from_numpy(lvl).reshape(shape),
                                   plan)


def test_pack_refuses_what_does_not_fit():
    plan, lo, hi = _port_tables("last-g8")
    x = _tx(_x("last-g8", "float32"))
    with pytest.raises(ValueError, match="1/2/4"):
        fcq.clip_quant_tiles_pack(x, lo, hi, 4, plan, 3)
    with pytest.raises(ValueError, match="does not fit"):
        fcq.clip_quant_tiles_pack(x, lo, hi, 5, plan, 2)
    with pytest.raises(ValueError, match="n_levels"):
        fcq.clip_quant_tiles(x, lo, hi, 65, plan, want_hist=True)


# -- #8: index-only and coded-order variants -------------------------------------

def _ecsq_port(name, n_levels):
    plan, lo, hi = _port_tables(name)
    thr, lvl = _ecsq_tables(lo.numpy(), hi.numpy(), n_levels)
    shape = (plan.n_cgroups, plan.n_sblocks, -1)
    return plan, lo, hi, torch.from_numpy(thr).reshape(shape), \
        torch.from_numpy(lvl).reshape(shape)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n_levels", LEVELS)
@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_ecsq_tiles_index_only_matches_interpret(name, n_levels, dtype):
    plan, lo, hi, thr, lvl = _ecsq_port(name, n_levels)
    jidx, jdeq, _ = _ecsq_reference(name, n_levels, dtype)
    x = _tx(_x(name, dtype))
    idx, none = ea.ecsq_assign_tiles(x, lo, hi, thr, lvl, plan,
                                     want_deq=False)
    assert none is None and np.array_equal(idx.numpy(), jidx)
    idx, deq = ea.ecsq_assign_tiles(x, lo, hi, thr, lvl, plan)
    assert np.array_equal(idx.numpy(), jidx)
    assert np.array_equal(deq.float().numpy(), jdeq)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n_levels", LEVELS)
@pytest.mark.parametrize("name", FAST)
def test_ecsq_tiles_coded_matches_interpret(name, n_levels, dtype):
    """The coded-order variant: the reference's indices in its plan's
    coded order, flat."""
    plan, lo, hi, thr, lvl = _ecsq_port(name, n_levels)
    _, _, jcoded = _ecsq_reference(name, n_levels, dtype)
    coded = ea.ecsq_assign_tiles_coded(_tx(_x(name, dtype)), lo, hi, thr,
                                       lvl, plan)
    assert coded.dtype == torch.int32 and coded.dim() == 1
    assert np.array_equal(coded.numpy(), jcoded)


# -- the backends and the codec ----------------------------------------------------

def _codec_pair(group, n_levels, shape):
    """(reference codec, port codec on the torch backend), per channel
    group of ``group`` channels last, calibrated by min/max on seeded
    samples of ``shape``."""
    rng = np.random.default_rng([10, group, n_levels, *shape])
    samples = (rng.standard_normal(shape) * rng.uniform(0.5, 3, shape[-1])
               ).astype(np.float32)
    kw = dict(n_levels=n_levels, clip_mode="minmax",
              constrain_cmin_zero=False, granularity="channel",
              channel_axis=-1, channel_group_size=group)
    return (jcalibrate(JCodecConfig(**kw), samples),
            calibrate(CodecConfig(backend="torch", **kw), samples),
            samples)


@pytest.mark.parametrize("n_levels", LEVELS)
@pytest.mark.parametrize("group", [8, 64, 3])
def test_codec_rates_match_reference(group, n_levels):
    """``quantize_with_rate`` and, where the codec packs in its quantizer
    (groups of 8-256), ``quantize_packed_with_counts`` on a per-channel
    codec: the indices, counts and bytes of the reference's quantize,
    tile histogram and pack; the rate equal to the port's two-pass rate
    exactly and to the reference's within rel 1e-5."""
    shape = (4, 6, 128)
    jc, tc, x = _codec_pair(group, n_levels, shape)
    jb = JnpBackend()
    jidx = jb.quantize(jnp.asarray(x), jc.spec())
    tx = torch.from_numpy(x)
    idx, deq, hist = tc.backend.quantize_with_histogram(tx, tc.spec(),
                                                        want_deq=False)
    assert deq is None and np.array_equal(idx.numpy(), np.asarray(jidx))
    fast = group != 3
    assert (hist is not None) == fast
    if fast:
        assert np.array_equal(hist.numpy(), np.asarray(
            jb.tile_histogram(jidx, jc.spec())))
    _, _, rate = tc.quantize_with_rate(tx)
    two_pass = tc.rate_from_indices(tc.quantize(tx), shape)
    assert float(rate) == float(two_pass)
    jrate = jc.rate_from_indices(jidx, shape)
    assert float(rate) == pytest.approx(float(jrate), rel=1e-5)
    assert tc.packs_in_quantizer() == fast
    if fast:
        packed, counts = tc.quantize_packed_with_counts(tx)
        prate = tc.rate_from_counts(counts, shape)
        assert np.array_equal(packed.numpy(), np.asarray(
            jc.pack(jidx.reshape(-1))))
        assert float(prate) == float(two_pass)


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_torch_backend_counts_and_codes_like_the_kernels(name):
    """The torch backend (the CPU reference path) against the kernels'
    plain versions on the same plan specs: the same indices, counts and
    bytes where the quantizer counts and packs, and the same coded-order
    ECSQ indices (the coded-order variant's on the fast route)."""
    shape, plan, _ = _plans(name)
    lo, hi = _ranges(plan)
    x = torch.from_numpy(_x(name, "float32"))
    tb = get_backend("torch")
    spec = QuantSpec(lo, hi, 4, plan.channel_axis, plan=plan)
    idx, _, hist = tb.quantize_with_histogram(x, spec, want_deq=False)
    fast = GEOMETRIES[name][-1] and plan.channel_axis == -1
    assert (hist is not None) == fast
    plan_, tlo, thi = _port_tables(name)
    kidx, _ = fcq.clip_quant_tiles(x, tlo, thi, 4, plan_, want_deq=False)
    assert torch.equal(idx, kidx)
    if fast:
        assert torch.equal(hist, fcq.clip_quant_tiles(
            x, tlo, thi, 4, plan_, want_deq=False, want_hist=True)[2])
        packed, counts = tb.quantize_packed_with_histogram(x, spec, 2)
        kp, kh = fcq.clip_quant_tiles_pack(x, tlo, thi, 4, plan_, 2)
        assert torch.equal(packed, kp) and torch.equal(counts, kh)
    _, _, _, thr, lvl = _ecsq_port(name, 4)
    espec = QuantSpec(lo, hi, 4, plan.channel_axis,
                      TileECSQ(levels=lvl.reshape(plan.n_tiles, -1).numpy(),
                               thresholds=thr.reshape(plan.n_tiles,
                                                      -1).numpy()), plan)
    coded = tb.coded_indices_device(x, espec, 2)
    if GEOMETRIES[name][-1]:
        assert torch.equal(coded, ea.ecsq_assign_tiles_coded(
            x, tlo, thi, thr, lvl, plan_))
    kidx, _ = ea.ecsq_assign_tiles(x, tlo, thi, thr, lvl, plan_,
                                   want_deq=False)
    assert np.array_equal(coded.numpy(), plan.to_coded_order(kidx.numpy()))


def test_cpu_launch_counts_stay_zero():
    _build.reset_launches()
    plan, lo, hi = _port_tables("last-g8")
    x = _tx(_x("last-g8", "bfloat16"))
    fcq.clip_quant_tiles(x, lo, hi, 4, plan, want_deq=False, want_hist=True)
    fcq.clip_quant_tiles_pack(x, lo, hi, 4, plan, 2)
    _, lo, hi, thr, lvl = _ecsq_port("last-g8", 4)
    ea.ecsq_assign_tiles_coded(x, lo, hi, thr, lvl, plan)
    assert all(v == 0 for v in _build.LAUNCHES.values())


def test_host_tables_upload_once():
    """``ops._f32`` keeps a host table's copy by its content: a codec's
    range and ECSQ tables cross to the device once, not on every call."""
    lo = np.linspace(-2, -1, 24, dtype=np.float32).reshape(3, 8)
    a = tops._f32(lo, "cpu", (3, 8))
    assert tops._f32(lo.copy(), "cpu", (3, 8)) is a
    assert tops._f32(lo, "cpu", (24,)) is not a
    changed = lo.copy()
    changed[0, 0] += 1
    b = tops._f32(changed, "cpu", (3, 8))
    assert b is not a and float(b[0, 0]) == float(changed[0, 0])
    assert np.array_equal(a.numpy(), lo)
