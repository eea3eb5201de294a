"""Card-only checks of the hand-written CUDA kernels against their plain
torch versions (same module, same inputs).  Marked ``cuda``: they skip
where no CUDA device exists and run on the card with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

This file imports only torch and the port, so it runs where JAX is not
installed.  Tolerances: indices, packed bytes, histograms and rANS blobs
exact; reconstructions within 1 ulp of their dtype (the kernels and
their plain versions round the same steps, so the checks below hold them
bit-identical).
"""

import dataclasses
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.compression import split_runtime
from repro_torch.configs import get_config, reduced
from repro_torch.core import (CodecConfig, binarization, cabac, calibrate,
                              rans)
from repro_torch.core.backend import QuantSpec, get_backend
from repro_torch.core.ecsq import design_ecsq
from repro_torch.core.tiling import TileECSQ, TilePlan, spatial_grid
from repro_torch.kernels import _build, ecsq_assign, pack_bits
from repro_torch.kernels import fused_clip_quant as fcq
from repro_torch.kernels import ops, rans_coder, rate_hist
from repro_torch.models import decode_step, init_cache, init_params

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _x(dev, n, seed=0, dtype=torch.float32):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(n, device=dev, generator=g) * 2 + 0.3).to(dtype)


LEVELS = [2, 3, 4, 8, 16, 64]
# the three routes of #4 and of #1's histogram variant: one block (up to
# 4,096 values), a cluster of eight blocks (the decode boundary, 16,384),
# many blocks and the ticket (70,001 and the prefill boundary's 2^20)
HIST_SIZES = [1, 16384, 70001, 1 << 20]


def _device_ops(fn) -> list[str]:
    """Names of the device operations (kernels, copies, fills) ``fn``
    puts on the card, from ``torch.profiler``: the session padded by 20 ms
    of host time on each side of the call, and taken again (three in all)
    where it recorded no device event at all, as a short session on torch
    2.11 at times did."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(0.02)
            fn()
            torch.cuda.synchronize()
            time.sleep(0.02)
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            return names
    return []


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_levels", LEVELS)
def test_clip_quant_and_histogram(dev, n_levels, dtype):
    x = _x(dev, 70001, dtype=dtype)
    before = dict(_build.LAUNCHES)
    ki, kd = fcq.clip_quant_2d(x, -1.5, 2.75, n_levels)
    pi, pd = fcq.clip_quant_plain(x, -1.5, 2.75, n_levels)
    assert torch.equal(ki, pi)
    assert torch.equal(kd, pd)      # same rounding steps: bit-identical
    assert torch.equal(ops.index_histogram(ki, n_levels=n_levels),
                       rate_hist.index_histogram_plain(ki, n_levels))
    assert _advanced(before, clip_quant=1, index_histogram=1)
    # the same counts from the quantizer's own launch, no histogram launch
    before = dict(_build.LAUNCHES)
    fi, fd, fh = fcq.clip_quant_2d(x, -1.5, 2.75, n_levels, want_hist=True)
    assert torch.equal(fi, pi) and torch.equal(fd, pd)
    assert torch.equal(fh, rate_hist.index_histogram_plain(pi, n_levels))
    assert _advanced(before, clip_quant=1, index_histogram=0)


@pytest.mark.parametrize("n_levels", LEVELS)
@pytest.mark.parametrize("n", HIST_SIZES)
def test_index_histogram_routes(dev, n, n_levels):
    """#4 against its plain version on uniform indices, on indices with
    values outside [0, N), on an all-one-level input and on a view that
    is not 16-byte aligned (scalar loads).  The calls follow each other
    with no sync, so each finds the ticket its predecessor reset."""
    g = torch.Generator(device=dev).manual_seed(n * 64 + n_levels)
    cases = [
        torch.randint(0, n_levels, (n,), device=dev, generator=g,
                      dtype=torch.int32),
        torch.randint(-3, n_levels + 3, (n,), device=dev, generator=g,
                      dtype=torch.int32),
        torch.full((n,), n_levels - 1, device=dev, dtype=torch.int32),
        torch.randint(0, n_levels, (n + 1,), device=dev, generator=g,
                      dtype=torch.int32)[1:],
    ]
    before = dict(_build.LAUNCHES)
    got = [ops.index_histogram(c, n_levels=n_levels) for c in cases]
    assert _advanced(before, index_histogram=len(cases))
    for c, h in zip(cases, got):
        assert torch.equal(h, rate_hist.index_histogram_plain(c, n_levels))
    assert int(got[2][-1]) == n


@pytest.mark.parametrize("n", [16384, 70001, 1 << 20])
def test_index_histogram_is_one_device_operation(dev, n):
    """No fill, pad copy or clone around the kernel."""
    idx = torch.randint(0, 4, (4, n // 4), device=dev, dtype=torch.int32)
    before = dict(_build.LAUNCHES)
    names = _device_ops(lambda: ops.index_histogram(idx, n_levels=4))
    assert len(names) == 1 and "index_histogram" in names[0], names
    assert _advanced(before, index_histogram=2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_levels", LEVELS)
@pytest.mark.parametrize("n", HIST_SIZES)
def test_clip_quant_with_histogram(dev, n, n_levels, dtype):
    """#1 with its histogram and/or without its reconstruction, on both
    routes and on a view that is not 16-byte aligned: indices,
    reconstructions and bins bit-identical to the plain version."""
    x = _x(dev, n + 1, seed=n_levels, dtype=dtype)
    lo, hi = -1.5, 2.75
    before = dict(_build.LAUNCHES)
    both = fcq.clip_quant_2d(x[:n], lo, hi, n_levels, want_hist=True)
    idx_hist = fcq.clip_quant_2d(x[:n], lo, hi, n_levels, want_deq=False,
                                 want_hist=True)
    idx_only = fcq.clip_quant_2d(x[:n], lo, hi, n_levels, want_deq=False)
    shifted = fcq.clip_quant_2d(x[1:], lo, hi, n_levels, want_hist=True)
    top = fcq.clip_quant_2d(torch.full_like(x[:n], 10.0), lo, hi, n_levels,
                            want_deq=False, want_hist=True)
    assert _advanced(before, clip_quant=5, index_histogram=0)
    pi, pd, ph = fcq.clip_quant_plain(x[:n], lo, hi, n_levels,
                                      want_hist=True)
    assert all(torch.equal(a, b) for a, b in zip(both, (pi, pd, ph)))
    assert torch.equal(idx_hist[0], pi) and idx_hist[1] is None
    assert torch.equal(idx_hist[2], ph)
    assert torch.equal(idx_only[0], pi) and idx_only[1] is None
    assert len(idx_only) == 2
    want = fcq.clip_quant_plain(x[1:], lo, hi, n_levels, want_hist=True)
    assert all(torch.equal(a, b) for a, b in zip(shifted, want))
    assert int(top[2][-1]) == n and int(top[2].sum()) == n


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_levels,bits", [(2, 1), (3, 2), (4, 2), (16, 4),
                                           (2, 2), (4, 4)])
@pytest.mark.parametrize("n", [1, 7, 16384, 70001, 1 << 20])
def test_clip_quant_pack(dev, n, n_levels, bits, dtype):
    """#1's packing variant on every route of its histogram, on views that
    are not aligned (all scalar) and values outside the clip range: the
    plain version's bytes and bins, one launch of #1, no pack kernel, one
    device operation."""
    x = _x(dev, n + 1, seed=n_levels, dtype=dtype) * 1.5
    lo, hi = -1.5, 2.75
    before = dict(_build.LAUNCHES)
    got = fcq.clip_quant_pack(x[:n], lo, hi, n_levels, bits)
    shifted = fcq.clip_quant_pack(x[1:], lo, hi, n_levels, bits)
    assert _advanced(before, clip_quant=2, pack_bits=0, index_histogram=0)
    for out, xs in ((got, x[:n]), (shifted, x[1:])):
        want = fcq.clip_quant_pack_plain(xs, lo, hi, n_levels, bits)
        assert torch.equal(out[0], want[0]) and torch.equal(out[1], want[1])
        idx = fcq.clip_quant_plain(xs, lo, hi, n_levels)[0]
        assert torch.equal(out[0], pack_bits.pack_bits(idx, bits))
    names = _device_ops(lambda: fcq.clip_quant_pack(x[:n], lo, hi, n_levels,
                                                    bits))
    assert len(names) == 1 and "clip_quant_pack" in names[0], names


def test_clip_quant_pack_refuses_what_does_not_fit(dev):
    x = _x(dev, 64)
    with pytest.raises(ValueError, match="does not fit"):
        fcq.clip_quant_pack(x, -1.0, 1.0, 64, 4)        # 6-bit indices
    with pytest.raises(ValueError, match="1/2/4"):
        fcq.clip_quant_pack(x, -1.0, 1.0, 64, 8)
    codec = calibrate(CodecConfig(n_levels=64, clip_mode="manual",
                                  manual_cmin=-1.0, manual_cmax=1.0,
                                  backend="cuda"))
    assert not codec.packs_in_quantizer()
    with pytest.raises(ValueError, match="packs per-tensor specs"):
        codec.quantize_packed_with_rate(x)


def test_quantize_packed_with_rate_on_card(dev):
    """The codec's packing pass against the two-launch path on the same
    boundary tensors: the bytes of ``pack(quantize(x))`` and its rate,
    exactly."""
    for n_levels in (2, 3, 4, 16):
        codec = calibrate(CodecConfig(n_levels=n_levels, clip_mode="manual",
                                      manual_cmin=-2.0, manual_cmax=2.5,
                                      backend="cuda"))
        for shape in [(4, 1, 4096), (4, 64, 4096), (3, 5, 7)]:
            x = _x(dev, int(np.prod(shape)),
                   dtype=torch.bfloat16).reshape(shape)
            idx, _, rate2 = codec.quantize_with_rate(x)
            packed, rate = codec.quantize_packed_with_rate(x)
            assert torch.equal(packed, codec.pack(idx.reshape(-1)))
            assert float(rate) == float(rate2)


def test_histograms_on_two_streams(dev):
    """Interleaved launches of #4 (2^20 and 2^22 indices) and #1 with its
    histogram (2^20 values), 50 each on each of two side streams with no
    sync between them: every bin exact, so the streams' ticket words do
    not meet."""
    g = torch.Generator(device=dev).manual_seed(16)
    idx = [torch.randint(0, 16, (n,), device=dev, generator=g,
                         dtype=torch.int32) for n in (1 << 20, 1 << 22)]
    x = _x(dev, 1 << 20, seed=16, dtype=torch.bfloat16)
    want = [rate_hist.index_histogram_plain(i, 16) for i in idx]
    want_q = fcq.clip_quant_plain(x, -1.5, 2.75, 4, want_deq=False,
                                  want_hist=True)[2]
    streams = [torch.cuda.Stream(device=dev) for _ in range(2)]
    torch.cuda.synchronize()
    out = {s: [] for s in range(2)}
    for _ in range(50):
        for s, stream in enumerate(streams):
            with torch.cuda.stream(stream):
                out[s].append((
                    ops.index_histogram(idx[0], n_levels=16),
                    ops.index_histogram(idx[1], n_levels=16),
                    fcq.clip_quant_2d(x, -1.5, 2.75, 4, want_deq=False,
                                      want_hist=True)[2]))
    torch.cuda.synchronize()
    tickets = {(dev.index or 0, st.cuda_stream) for st in streams}
    assert tickets <= set(_build._TICKETS)
    for s in range(2):
        for h0, h1, hq in out[s]:
            assert torch.equal(h0, want[0]) and torch.equal(h1, want[1])
            assert torch.equal(hq, want_q)


def test_rate_paths_count_in_the_quantizer(dev):
    """``apply_with_rate`` and the split runtime's crossing launch the
    clip+quant kernel once and the index histogram never, and give the
    rate of the two-launch path (quantize, then histogram) exactly; the
    quantizer-and-histogram stage is one device operation."""
    codec = calibrate(CodecConfig(n_levels=4, clip_mode="manual",
                                  manual_cmin=-2.0, manual_cmax=2.5,
                                  backend="cuda"))
    for shape in [(4, 1, 4096), (4, 64, 4096)]:
        x = _x(dev, int(np.prod(shape)), dtype=torch.bfloat16).reshape(shape)
        two_launch = codec.rate_from_indices(codec.quantize(x), x.shape)
        before = dict(_build.LAUNCHES)
        deq, rate = codec.apply_with_rate(x)
        assert _advanced(before, clip_quant=1, index_histogram=0)
        assert torch.equal(deq, codec.backend.quantize_dequantize(
            x, codec.spec())[1])
        assert float(rate) == float(two_launch)
        before = dict(_build.LAUNCHES)
        idx, none, rate = codec.quantize_with_rate(x)
        assert _advanced(before, clip_quant=1, index_histogram=0)
        assert none is None and torch.equal(idx, codec.quantize(x))
        assert float(rate) == float(two_launch)
        names = _device_ops(lambda: codec.backend.quantize_with_histogram(
            x, codec.spec(), want_deq=True))
        assert len(names) == 1 and "clip_quant" in names[0], names


def test_quantize_with_histogram_backends_agree(dev):
    """CudaBackend on the card and TorchBackend on the CPU copy (float32,
    where their formulas agree): same indices, reconstructions and
    counts (per tile for the plan); specs whose quantizer does not count
    give no counts."""
    cb, tb = get_backend("cuda"), get_backend("torch")
    x_cpu = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (8, 33, 256)).astype(np.float32) * 2)
    x = x_cpu.to(dev)
    shape, plan = _plan("channel-g8")
    lo, hi = _ranges(plan)
    q = design_ecsq(x_cpu.numpy().reshape(-1)[::7], 4, 0.05, -2.5, 3.0)
    specs = {"tensor-4": QuantSpec(-2.5, 3.0, 4),
             "tensor-64": QuantSpec(-2.5, 3.0, 64),
             "tensor-65": QuantSpec(-2.5, 3.0, 65),
             "ecsq": QuantSpec(-2.5, 3.0, 4, ecsq=q),
             "channel-g8": QuantSpec(lo, hi, 4, plan.channel_axis,
                                     plan=plan)}
    for name, spec in specs.items():
        # per tensor, uniform or ECSQ, and the g=8 plan on the tile
        # quantizer's fast route
        counts = name in ("tensor-4", "tensor-64", "ecsq", "channel-g8")
        for want_deq in (True, False):
            ki, kd, kh = cb.quantize_with_histogram(x, spec, want_deq)
            ti, td, th = tb.quantize_with_histogram(x_cpu, spec, want_deq)
            assert torch.equal(ki.cpu(), ti), name
            assert (kd is None) == (td is None) == (not want_deq)
            if want_deq:
                assert torch.equal(kd.cpu(), td), name
            assert (kh is None) == (th is None) == (not counts), name
            if counts:
                assert torch.equal(kh.cpu(), th), name


@pytest.mark.parametrize("n_levels", [2, 4, 16, 64])
def test_encode_tiles_ragged_bands(dev, n_levels):
    bits = max(1, (n_levels - 1).bit_length())
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(24, 3 * 256, device=dev, generator=g) * 3
    lo = torch.rand(24, 3, device=dev, generator=g) * -3
    hi = lo + torch.rand(24, 3, device=dev, generator=g) * 4 + 0.5
    valid = (256, 131, 9)
    kp, kh = fcq.encode_tiles_2d(x, lo, hi, n_levels, bits, sb_cols=256,
                                 bs=256, band_valid=valid)
    pp, ph = fcq.encode_tiles_plain(
        x, lo, hi, fcq.band_valid_array(3, 256, None, valid, dev), n_levels,
        bits, 256)
    assert torch.equal(kp, pp) and torch.equal(kh, ph)


@pytest.mark.parametrize("n,n_levels", [(1, 2), (5, 3), (513, 4),
                                        (70000, 16)])
def test_rans_blob_byte_identical(dev, n, n_levels):
    g = torch.Generator(device=dev).manual_seed(n)
    idx = torch.randint(0, n_levels, (n,), device=dev, generator=g,
                        dtype=torch.int32)
    blob = rans_coder.encode_planes_device(idx, n_levels)
    assert blob == rans_coder.encode_planes_device(idx.cpu(), n_levels)
    assert blob == rans.encode_planes(binarization.index_to_context_bits(
        idx.cpu().numpy(), n_levels))


def test_wrappers_refuse_bad_arguments(dev):
    with pytest.raises(TypeError):
        rate_hist.index_histogram_2d(torch.zeros(8, device=dev), 4)
    with pytest.raises(ValueError, match="contiguous"):
        fcq.clip_quant_2d(torch.zeros(8, 8, device=dev).t(), 0.0, 1.0, 4)


# -- tiled and ECSQ kernels (#2, #5, #7, #8) ----------------------------------

# (shape, channel_axis, channel_group, spatial_block, block_hw)
PLANS = {
    "channel-g8": ((8, 33, 256), -1, 8, 0, None),
    "tile-short-last": ((1000, 64), -1, 4, 300, None),
    "2d-ragged-nchw": ((2, 16, 13, 11), 1, 3, 0, (4, 3)),
}


def _plan(name):
    shape, axis, gc, bs, bhw = PLANS[name]
    c = shape[axis]
    m = int(np.prod(shape)) // c
    kw = dict(channel_axis=axis, channel_group_size=gc, n_channels=c)
    if bhw is not None:
        kw.update(spatial_block_size=0, spatial_extent=m,
                  spatial_hw=spatial_grid(shape, axis),
                  spatial_block_hw=bhw)
    else:
        kw.update(spatial_block_size=bs, spatial_extent=m if bs else None)
    return shape, TilePlan(**kw)


def _ranges(plan, seed=0):
    """Per-tile float32 (lo, hi) tables, one tile degenerate."""
    rng = np.random.default_rng([seed, plan.n_tiles])
    shape = (plan.n_cgroups, plan.n_sblocks)
    lo = rng.uniform(-3, 0, shape).astype(np.float32)
    hi = (lo + rng.uniform(0.5, 4, shape)).astype(np.float32)
    hi.flat[plan.n_tiles // 2] = lo.flat[plan.n_tiles // 2]
    return lo, hi


def _ecsq_tables(lo, hi, n_levels, seed=0):
    """Sorted float32 (thresholds (..., N-1), levels (..., N))."""
    rng = np.random.default_rng([seed, n_levels])
    lo = np.asarray(lo, np.float64)[..., None]
    hi = np.asarray(hi, np.float64)[..., None]
    u = np.sort(rng.uniform(0, 1, lo.shape[:-1] + (n_levels - 2,)), -1)
    levels = np.concatenate([lo, lo + (hi - lo) * u, hi], -1)
    thresholds = (levels[..., 1:] + levels[..., :-1]) / 2
    return thresholds.astype(np.float32), levels.astype(np.float32)


def _advanced(before, **kernels):
    return all(_build.LAUNCHES[k] == before[k] + n for k, n in kernels.items())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_levels", [2, 4, 16, 64])
@pytest.mark.parametrize("name", list(PLANS))
def test_clip_quant_tiles_and_tile_histogram(dev, name, n_levels, dtype):
    shape, plan = _plan(name)
    g = torch.Generator(device=dev).manual_seed(n_levels)
    x = (torch.randn(shape, device=dev, generator=g) * 2 + 0.3).to(dtype)
    lo, hi = (torch.from_numpy(t).to(dev) for t in _ranges(plan))
    maps = fcq.tile_maps(plan, shape, dev)
    before = dict(_build.LAUNCHES)
    ki, kd = fcq.clip_quant_tiles(x, lo, hi, n_levels, plan)
    pi, pd = fcq.clip_quant_tiles_plain(x, lo, hi, n_levels, maps)
    assert torch.equal(ki, pi)
    assert torch.equal(kd, pd)
    kh = rate_hist.index_histogram_tiles(ki, n_levels, plan)
    assert torch.equal(kh, rate_hist.index_histogram_tiles_plain(
        ki, n_levels, maps))
    assert int(kh.sum()) == x.numel()
    assert _advanced(before, clip_quant_tiles=1, index_histogram_tiles=1)


# (shape, channel_axis, channel_group, spatial_block, block_hw): plans whose
# tiles take each route of #5 -- a warp (the decode boundary), a
# block (the prefill boundary), a cluster (the large tiles below) -- with
# channels innermost or not, 2-D plans through perm, ragged edge tiles
TILE_ROUTES = {
    "decode-g8": ((4, 1, 4096), -1, 8, 0, None),
    "prefill-g8": ((4, 64, 4096), -1, 8, 0, None),
    "g8-short-group": ((2, 9, 1001), -1, 8, 0, None),
    "g64-block": ((32, 128), -1, 64, 0, None),
    "conv-inner": ((2, 32, 28, 28), 1, 3, 0, None),
    "conv-inner-block": ((2, 16, 20, 20), 1, 2, 0, None),
    "conv-2d-perm": ((2, 32, 28, 28), 1, 3, 0, (5, 6)),
    "conv-2d-big": ((4, 8, 64, 64), 1, 8, 0, (40, 24)),
    "tile-1d": ((1000, 64), -1, 4, 300, None),
    "cluster": ((700, 128), -1, 64, 0, None),
}


def _route_plan(name):
    shape, axis, gc, bs, bhw = TILE_ROUTES[name]
    c = shape[axis]
    m = int(np.prod(shape)) // c
    kw = dict(channel_axis=axis, channel_group_size=gc, n_channels=c)
    if bhw is not None:
        kw.update(spatial_block_size=0, spatial_extent=m,
                  spatial_hw=spatial_grid(shape, axis),
                  spatial_block_hw=bhw)
    else:
        kw.update(spatial_block_size=bs, spatial_extent=m if bs else None)
    return shape, TilePlan(**kw)


@pytest.mark.parametrize("n_levels", [2, 3, 4, 16, 17, 64])
@pytest.mark.parametrize("name", list(TILE_ROUTES))
def test_tile_histogram_routes(dev, name, n_levels):
    """#5 against its plain version on every route, with values outside
    [0, N) and on a view that is not 16-byte aligned: one launch and one
    device operation a call, every tile's bins stored."""
    shape, plan = _route_plan(name)
    g = torch.Generator(device=dev).manual_seed(n_levels)
    n = int(np.prod(shape))
    flat = torch.randint(-2, n_levels + 2, (n + 1,), device=dev, generator=g,
                         dtype=torch.int32)
    maps = fcq.tile_maps(plan, shape, dev)
    for idx in (flat[:n].view(shape), flat[1:].view(shape)):
        before = dict(_build.LAUNCHES)
        got = rate_hist.index_histogram_tiles(idx, n_levels, plan)
        assert _advanced(before, index_histogram_tiles=1)
        assert torch.equal(got, rate_hist.index_histogram_tiles_plain(
            idx, n_levels, maps))
    names = _device_ops(lambda: rate_hist.index_histogram_tiles(
        flat[:n].view(shape), n_levels, plan))
    assert len(names) == 1 and "index_histogram_tiles" in names[0], names


def test_tile_histogram_of_large_tiles(dev):
    """Tiles larger than one block's part: a cluster a tile."""
    plan = TilePlan(channel_axis=-1, channel_group_size=64,
                    spatial_block_size=0, n_channels=128)
    g = torch.Generator(device=dev).manual_seed(5)
    idx = torch.randint(-1, 9, (3000, 128), device=dev, generator=g,
                        dtype=torch.int32)
    maps = fcq.tile_maps(plan, idx.shape, dev)       # 192,000 per tile
    assert torch.equal(rate_hist.index_histogram_tiles(idx, 8, plan),
                       rate_hist.index_histogram_tiles_plain(idx, 8, maps))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_levels", [2, 4, 16, 64])
def test_ecsq_assign(dev, n_levels, dtype):
    g = torch.Generator(device=dev).manual_seed(n_levels)
    x = (torch.randn(70001, device=dev, generator=g) * 2 + 0.3).to(dtype)
    cmin, cmax = -1.7, 2.9
    thr, lvl = _ecsq_tables(np.float32(cmin), np.float32(cmax), n_levels)
    x[3] = float(thr[(n_levels - 1) // 2])     # a tie: the upper bin
    thr[(n_levels - 1) // 2] = x[3].float().item()
    thr = np.sort(thr)
    # the kernel takes its table by value, from host memory
    t, lv = torch.from_numpy(thr), torch.from_numpy(lvl)
    before = dict(_build.LAUNCHES)
    ki, kd = ecsq_assign.ecsq_assign(x, t, lv, cmin, cmax)
    pi, pd = ecsq_assign.ecsq_assign_plain(x, t, lv, cmin, cmax)
    assert torch.equal(ki, pi) and torch.equal(kd, pd)
    assert _advanced(before, ecsq_assign=1)
    xc = x.float().clamp(np.float32(cmin), np.float32(cmax))
    assert torch.equal(ki, torch.bucketize(xc, t.to(dev), right=True).int())
    with pytest.raises(ValueError, match="host memory"):
        ecsq_assign.ecsq_assign(x, t.to(dev), lv, cmin, cmax)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_levels", [2, 4, 16, 64])
@pytest.mark.parametrize("name", list(PLANS))
def test_ecsq_assign_tiles(dev, name, n_levels, dtype):
    shape, plan = _plan(name)
    g = torch.Generator(device=dev).manual_seed(n_levels)
    x = (torch.randn(shape, device=dev, generator=g) * 2 + 0.3).to(dtype)
    lo, hi = _ranges(plan)
    thr, lvl = _ecsq_tables(lo, hi, n_levels)
    args = [torch.from_numpy(t).to(dev) for t in (lo, hi, thr, lvl)]
    maps = fcq.tile_maps(plan, shape, dev)
    before = dict(_build.LAUNCHES)
    ki, kd = ecsq_assign.ecsq_assign_tiles(x, *args, plan)
    pi, pd = ecsq_assign.ecsq_assign_tiles_plain(x, *args, maps)
    assert torch.equal(ki, pi) and torch.equal(kd, pd)
    assert _advanced(before, ecsq_assign_tiles=1)


def _backends_agree(spec, x_cpu, bits):
    """CudaBackend on the card and TorchBackend on the CPU copy give the
    same indices, reconstructions, histograms and coded orders."""
    cb, tb = get_backend("cuda"), get_backend("torch")
    x = x_cpu.to("cuda")
    ki, kd = cb.quantize_dequantize(x, spec)
    ti, td = tb.quantize_dequantize(x_cpu, spec)
    assert torch.equal(ki.cpu(), ti) and torch.equal(kd.cpu(), td)
    assert torch.equal(cb.tile_histogram(ki, spec).cpu(),
                       tb.tile_histogram(ti, spec))
    kc, kh = cb.encode_fused(x, spec, bits, want_hist=True)
    tc, th = tb.encode_fused(x_cpu, spec, bits, want_hist=True)
    assert np.array_equal(kc, tc) and np.array_equal(kh, th)
    assert torch.equal(cb.coded_indices_device(x, spec, bits).cpu(),
                       tb.coded_indices_device(x_cpu, spec, bits))


@pytest.mark.parametrize("name", list(PLANS))
def test_cuda_backend_matches_torch_backend_on_plans(dev, name):
    shape, plan = _plan(name)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(shape)
                         .astype(np.float32) * 2)
    lo, hi = _ranges(plan)
    before = dict(_build.LAUNCHES)
    _backends_agree(QuantSpec(lo, hi, 4, plan.channel_axis, plan=plan), x,
                    bits=2)
    # qdq + tile_histogram; encode_fused + coded_indices_device
    assert _advanced(before, clip_quant_tiles=1, index_histogram_tiles=1,
                     encode_tiles=2)


def test_cuda_backend_matches_torch_backend_on_ecsq(dev):
    rng = np.random.default_rng(1)
    x = torch.from_numpy((rng.standard_normal((8, 33, 256)) * 2)
                         .astype(np.float32))
    q = design_ecsq(x.numpy().reshape(-1)[::7], 4, 0.05, -2.5, 3.0)
    before = dict(_build.LAUNCHES)
    _backends_agree(QuantSpec(-2.5, 3.0, 4, ecsq=q), x, bits=2)
    assert _advanced(before, ecsq_assign=3, index_histogram=1)
    shape, plan = _plan("channel-g8")
    lo, hi = _ranges(plan)
    thr, lvl = _ecsq_tables(lo.reshape(-1), hi.reshape(-1), 4)
    spec = QuantSpec(lo, hi, 4, -1, TileECSQ(levels=lvl, thresholds=thr),
                     plan)
    before = dict(_build.LAUNCHES)
    _backends_agree(spec, x, bits=2)
    assert _advanced(before, ecsq_assign_tiles=3, index_histogram_tiles=1)


def test_tiled_wrappers_refuse_bad_arguments(dev):
    shape, plan = _plan("channel-g8")
    lo, hi = (torch.from_numpy(t).to(dev) for t in _ranges(plan))
    x = torch.zeros(shape, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        fcq.clip_quant_tiles(x.transpose(0, 1).contiguous().transpose(0, 1),
                             lo, hi, 4, plan)
    with pytest.raises(TypeError):
        fcq.clip_quant_tiles(x, lo.double(), hi.double(), 4, plan)
    with pytest.raises(TypeError):
        rate_hist.index_histogram_tiles(x, 4, plan)


# -- the batched rANS step loop (#6) ------------------------------------------

def _coded(dev, n, n_levels, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    p = torch.rand(n_levels, device=dev, generator=g) + 0.05
    return torch.multinomial(p / p.sum(), n, replacement=True,
                             generator=g).int()


@pytest.mark.parametrize("n_levels", [2, 3, 4, 16])
def test_batched_rans_kernel_matches_plain_per_stream(dev, n_levels):
    """One launch over a ragged batch (5 to 57,095 indices, 4 to 256
    lanes) equals the plain loop stream by stream: states, flags, words."""
    lengths = [5, 900, 12000, 57095]
    idx = _coded(dev, sum(lengths), n_levels, seed=n_levels)
    batch = rans_coder._plane_batch(idx, lengths, n_levels)
    lay = batch.lay
    assert len(set(lay.lanes)) >= 3
    args = (batch.bits, batch.segs, batch.table, sum(lay.lanes),
            lay.n_cells)
    before = dict(_build.LAUNCHES)
    kx, kov, kw = rans_coder.rans_steps(*args, max(lay.lanes))
    torch.cuda.synchronize()
    assert _advanced(before, rans_step=1)
    px, pov, pw = rans_coder.rans_steps_plain(*args)
    assert torch.equal(kx.long() & 0xFFFFFFFF, px)
    assert torch.equal(kov, pov)
    assert torch.equal(kw.long() & 0xFFFF, pw)


def test_prefill_chunks_in_one_launch(dev):
    """The prefill boundary's 16 chunks of 65,536 indices: one launch
    gives the blobs of 16 single-chunk launches and of the host coder."""
    idx = _coded(dev, 1 << 20, 4, seed=11)
    bounds = [(i << 16, (i + 1) << 16) for i in range(16)]
    before = dict(_build.LAUNCHES)
    blobs = rans_coder.encode_index_chunks_device(idx, 4, bounds)
    assert _advanced(before, rans_step=1)
    singles = [rans_coder.encode_index_chunks_device(idx, 4, [b])[0]
               for b in bounds]
    assert blobs == singles
    host = idx.cpu().numpy()
    for (s, e), blob in zip(bounds[::5], blobs[::5]):
        assert blob == cabac.wrap_device_blob(rans.encode_planes(
            binarization.index_to_context_bits(host[s:e], 4)))


# -- the encode megakernel (#3), flat and plan routes -------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_levels", [2, 3, 4, 8, 16, 64])
@pytest.mark.parametrize("shape", [(4, 64, 4096), (4, 1, 4096), (513,),
                                   (70001,)])
def test_encode_flat_route(dev, shape, n_levels, dtype):
    g = torch.Generator(device=dev).manual_seed(n_levels)
    x = (torch.randn(shape, device=dev, generator=g) * 1.3 + 0.1).to(dtype)
    bits = max(1, (n_levels - 1).bit_length())
    before = dict(_build.LAUNCHES)
    kp, kh, _ = ops.encode_fused(x, -2.2, 2.9, n_levels=n_levels, bits=bits)
    assert _advanced(before, encode_tiles=1)
    pp, ph, _ = ops.encode_fused(x.cpu(), -2.2, 2.9, n_levels=n_levels,
                                 bits=bits)
    assert torch.equal(kp.cpu(), pp) and torch.equal(kh.cpu(), ph)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_levels", [2, 3, 4, 8, 16, 64])
@pytest.mark.parametrize("name", list(PLANS) + ["serve-g8"])
def test_encode_plan_route(dev, name, n_levels, dtype):
    if name == "serve-g8":       # the (4, 64, 4096) boundary at g=8
        shape = (4, 64, 4096)
        plan = TilePlan(channel_axis=-1, channel_group_size=8,
                        spatial_block_size=0, n_channels=4096)
    else:
        shape, plan = _plan(name)
    g = torch.Generator(device=dev).manual_seed(n_levels)
    x = (torch.randn(shape, device=dev, generator=g) * 2 + 0.3).to(dtype)
    lo, hi = (torch.from_numpy(t).to(dev) for t in _ranges(plan))
    bits = max(1, (n_levels - 1).bit_length())
    kp, kh, _ = ops.encode_fused(x, lo, hi, n_levels=n_levels, bits=bits,
                                 plan=plan)
    pp, ph, _ = ops.encode_fused(x.cpu(), lo.cpu(), hi.cpu(),
                                 n_levels=n_levels, bits=bits, plan=plan)
    assert torch.equal(kp.cpu(), pp) and torch.equal(kh.cpu(), ph)


@pytest.mark.parametrize("sb_cols,bits", [(8, 1), (24, 2), (48, 4),
                                          (40, 3), (1024, 1), (2048, 2)])
def test_encode_tiles_odd_bands(dev, sb_cols, bits):
    """Bands of 1-3 bytes (many cells per block, the match path), 12-byte
    bands (no half-warp alignment), and bands longer than a block."""
    n_levels = 1 << bits
    g = torch.Generator(device=dev).manual_seed(sb_cols)
    x = torch.randn(37, 3 * sb_cols, device=dev, generator=g) * 3
    lo = torch.rand(37, 3, device=dev, generator=g) * -3
    hi = lo + torch.rand(37, 3, device=dev, generator=g) * 4 + 0.5
    valid = (sb_cols, sb_cols // 2, 1)
    kp, kh = fcq.encode_tiles_2d(x, lo, hi, n_levels, bits, sb_cols=sb_cols,
                                 bs=sb_cols, band_valid=valid)
    pp, ph = fcq.encode_tiles_plain(
        x, lo, hi, fcq.band_valid_array(3, sb_cols, None, valid, dev),
        n_levels, bits, sb_cols)
    assert torch.equal(kp, pp) and torch.equal(kh, ph)


# -- pack kernel (#9) and the split runtime -----------------------------------

@pytest.mark.parametrize("n", [1, 13, 16384, 16384 + 5, 70001, 1 << 20,
                               (1 << 20) + 7])
@pytest.mark.parametrize("bits", [1, 2, 4])
def test_pack_bits(dev, bits, n):
    """#9 on whole 32-bit words of 16-byte loads, the scalar tail past
    them (sizes not a multiple of 4 * 8 / bits) and views that are not
    16-byte aligned (all scalar): the plain version's bytes, one launch
    and one device operation a call."""
    g = torch.Generator(device=dev).manual_seed(n)
    idx = torch.randint(0, 1 << bits, (n + 3,), device=dev, generator=g,
                        dtype=torch.int32)
    before = dict(_build.LAUNCHES)
    got = pack_bits.pack_bits(idx[:n], bits)
    assert torch.equal(got, pack_bits.pack_bits_plain(idx[:n], bits))
    assert _advanced(before, pack_bits=1)
    for k in (1, 2, 3):                            # 4, 8, 12 bytes off
        assert torch.equal(pack_bits.pack_bits(idx[k:k + n], bits),
                           pack_bits.pack_bits_plain(idx[k:k + n], bits))
    wide = torch.randint(-40, 300, (n,), device=dev, generator=g,
                         dtype=torch.int32)
    assert torch.equal(pack_bits.pack_bits(wide, bits),
                       pack_bits.pack_bits_plain(wide, bits))
    names = _device_ops(lambda: pack_bits.pack_bits(idx[:n], bits))
    assert len(names) == 1 and "pack_bits" in names[0], names


def test_cuda_backend_pack_indices(dev):
    cb, tb = get_backend("cuda"), get_backend("torch")
    rng = np.random.default_rng(5)
    for bits in range(1, 9):
        idx = torch.from_numpy(rng.integers(0, 1 << bits, (4, 1, 4096),
                                            dtype=np.int32))
        before = dict(_build.LAUNCHES)
        got = cb.pack_indices(idx.to(dev), bits)
        assert torch.equal(got.cpu(), tb.pack_indices(idx, bits))
        assert _advanced(before, pack_bits=int(bits in (1, 2, 4)))
    with pytest.raises(ValueError, match="CUDA tensors"):
        cb.pack_indices(idx, 2)


def test_split_runtime_on_card(dev):
    """Reduced model, float32: 'packed' and 'quantized_f16' give identical
    logits (the pack is lossless), and 'raw' equals the unsplit decode
    step rounded through bfloat16 (the same layers in the same order)."""
    cfg = dataclasses.replace(reduced(get_config("codeqwen1.5-7b"),
                                      layers=5), vocab_size=64)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    sp = split_runtime.split_params(cfg, params, edge_device=dev,
                                    cloud_device=dev)
    codec = calibrate(CodecConfig(n_levels=4, clip_mode="manual",
                                  manual_cmin=-8.0, manual_cmax=8.0,
                                  backend="cuda"))
    tok0 = torch.arange(4, device=dev)

    def run(transport):
        step = split_runtime.make_split_decode_step(
            cfg, codec, transport=transport, edge_device=dev,
            cloud_device=dev)
        caches = split_runtime.init_split_cache(
            cfg, 4, 16, edge_device=dev, cloud_device=dev)
        out, tok = [], tok0
        for pos in range(3):
            logits, caches, rate = step(sp, tok, caches, pos)
            out.append(logits)
            tok = logits.argmax(-1)
        return torch.stack(out)

    before = dict(_build.LAUNCHES)
    packed = run("packed")
    # the crossing packs and counts its indices in the quantizer's launch
    assert _advanced(before, pack_bits=0, clip_quant=3, index_histogram=0)
    assert torch.equal(packed, run("quantized_f16"))
    cache, tok, unsplit = init_cache(cfg, 4, 16, device=dev), tok0, []
    for pos in range(3):
        logits, cache, _ = decode_step(cfg, params, tok, cache, pos)
        unsplit.append(logits.to(torch.bfloat16).to(torch.float32))
        tok = unsplit[-1].argmax(-1)
    assert torch.equal(run("raw"), torch.stack(unsplit))


# -- the fast routes of #2 and #8 -----------------------------------------------

# (shape, channel_group): channels last, one spatial block -- the fast
# route -- on each of #2's thread groups: a warp (the decode boundary, a
# row, 1 to 24 values), a block (the prefill boundary), kSplit blocks (a
# tile of 16,384 rows; groups of 256 at the prefill size), with short
# last groups, groups of 8-256, up to 2^20 values and, at 4.8 million, a
# tile whose threads count more than their register fields hold
FAST_PLANS = {
    "row-8": ((1, 8), 8),
    "rows-3x24-g16": ((3, 24), 16),
    "decode-g8": ((4, 1, 4096), 8),
    "prefill-g8": ((4, 64, 4096), 8),
    "prefill-g256": ((4, 64, 4096), 256),
    "short-g64": ((700, 96), 64),
    "narrow-g64": ((300, 16), 64),
    "g32-odd-rows": ((333, 4, 40), 32),
    "g128": ((5, 7, 1024), 128),
    "split-g8": ((16384, 8), 8),
    "split-2^20-g8": ((131072, 8), 8),
    "split-match-g8": ((600000, 8), 8),
}


def _fast_case(dev, name, dtype, seed):
    shape, group = FAST_PLANS[name]
    c = shape[-1]
    plan = TilePlan(channel_axis=-1, channel_group_size=group,
                    spatial_block_size=0, n_channels=c)
    n = int(np.prod(shape))
    flat = _x(dev, n + 8, seed=seed, dtype=dtype) * 1.5
    lo, hi = (torch.from_numpy(t).to(dev) for t in _ranges(plan, seed))
    return plan, lo, hi, {"aligned": flat[8:n + 8].view(shape),
                          "unaligned": flat[1:n + 1].view(shape)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_levels", [2, 3, 4, 16, 17, 64])
@pytest.mark.parametrize("name", list(FAST_PLANS))
def test_clip_quant_tiles_fast_route(dev, name, n_levels, dtype):
    """#2's fast route, every variant -- indices and reconstruction, the
    indices alone, either with the per-tile counts, and the packed bytes
    with the counts at every width that holds N -- against the plain
    version on aligned and unaligned views with values outside the
    ranges: indices, reconstructions, bins and bytes exact; one launch
    of #2 a call, no histogram or pack launch."""
    plan, lo, hi, views = _fast_case(dev, name, dtype, n_levels)
    for what, x in views.items():
        maps = fcq.tile_maps(plan, x.shape, dev)
        assert fcq.fast_route(maps)
        pi, pd, ph = fcq.clip_quant_tiles_plain(x, lo, hi, n_levels, maps,
                                                want_hist=True)
        before = dict(_build.LAUNCHES)
        ki, kd = fcq.clip_quant_tiles(x, lo, hi, n_levels, plan)
        gi, gd = fcq.clip_quant_tiles(x, lo, hi, n_levels, plan,
                                      want_deq=False)
        hi_, hd, hh = fcq.clip_quant_tiles(x, lo, hi, n_levels, plan,
                                           want_hist=True)
        ii, idn, ih = fcq.clip_quant_tiles(x, lo, hi, n_levels, plan,
                                           want_deq=False, want_hist=True)
        assert _advanced(before, clip_quant_tiles=4, index_histogram_tiles=0)
        assert torch.equal(ki, pi) and torch.equal(kd, pd), what
        assert gd is None and torch.equal(gi, pi), what
        assert torch.equal(hi_, pi) and torch.equal(hd, pd), what
        assert torch.equal(hh, ph) and int(hh.sum()) == x.numel(), what
        assert idn is None and torch.equal(ii, pi) and torch.equal(ih, ph)
        for bits in (1, 2, 4):
            if n_levels > 1 << bits:
                continue
            before = dict(_build.LAUNCHES)
            kp, kh = fcq.clip_quant_tiles_pack(x, lo, hi, n_levels, plan,
                                               bits)
            assert _advanced(before, clip_quant_tiles=1, pack_bits=0)
            pp, pph = fcq.clip_quant_tiles_pack_plain(x, lo, hi, n_levels,
                                                      maps, bits)
            assert torch.equal(kp, pp) and torch.equal(kh, pph), (what, bits)


@pytest.mark.parametrize("name", ["decode-g8", "prefill-g8", "split-g8"])
def test_clip_quant_tiles_variants_are_one_device_operation(dev, name):
    plan, lo, hi, views = _fast_case(dev, name, torch.bfloat16, 4)
    x = views["aligned"]
    calls = [lambda: fcq.clip_quant_tiles(x, lo, hi, 4, plan),
             lambda: fcq.clip_quant_tiles(x, lo, hi, 4, plan,
                                          want_deq=False),
             lambda: fcq.clip_quant_tiles(x, lo, hi, 4, plan,
                                          want_deq=False, want_hist=True),
             lambda: fcq.clip_quant_tiles(x, lo, hi, 4, plan,
                                          want_hist=True),
             lambda: fcq.clip_quant_tiles_pack(x, lo, hi, 4, plan, 2)]
    for call in calls:
        names = _device_ops(call)
        assert len(names) == 1 and "clip_quant_tiles" in names[0], names


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_levels", [2, 4, 5, 16, 17, 64])
@pytest.mark.parametrize("name", list(FAST_PLANS))
def test_ecsq_assign_tiles_fast_route(dev, name, n_levels, dtype):
    """#8's fast route -- indices and reconstruction, the indices alone,
    the indices in coded order -- with register tables (N <= 16) and
    shared ones (N > 16), against the plain version on aligned and
    unaligned views: exact; one launch of #8 and one device operation a
    call."""
    plan, lo, hi, views = _fast_case(dev, name, dtype, n_levels + 100)
    thr, lvl = (torch.from_numpy(t).to(dev).reshape(
        plan.n_cgroups, 1, -1) for t in _ecsq_tables(
            lo.cpu().numpy(), hi.cpu().numpy(), n_levels))
    for what, x in views.items():
        maps = fcq.tile_maps(plan, x.shape, dev)
        pi, pd = ecsq_assign.ecsq_assign_tiles_plain(x, lo, hi, thr, lvl,
                                                     maps)
        before = dict(_build.LAUNCHES)
        ki, kd = ecsq_assign.ecsq_assign_tiles(x, lo, hi, thr, lvl, plan)
        gi, gd = ecsq_assign.ecsq_assign_tiles(x, lo, hi, thr, lvl, plan,
                                               want_deq=False)
        kc = ecsq_assign.ecsq_assign_tiles_coded(x, lo, hi, thr, lvl, plan)
        assert _advanced(before, ecsq_assign_tiles=3)
        assert torch.equal(ki, pi) and torch.equal(kd, pd), what
        assert gd is None and torch.equal(gi, pi), what
        assert torch.equal(kc, ecsq_assign.ecsq_assign_tiles_coded_plain(
            x, lo, hi, thr, lvl, maps)), what
        assert torch.equal(kc, pi.reshape(-1, x.shape[-1]).t().reshape(-1))
    if n_levels != 4 or dtype != torch.bfloat16:
        return                          # the serving codecs' case below
    x = views["aligned"]
    for call in (lambda: ecsq_assign.ecsq_assign_tiles(x, lo, hi, thr, lvl,
                                                       plan),
                 lambda: ecsq_assign.ecsq_assign_tiles(x, lo, hi, thr, lvl,
                                                       plan, want_deq=False),
                 lambda: ecsq_assign.ecsq_assign_tiles_coded(x, lo, hi, thr,
                                                             lvl, plan)):
        names = _device_ops(call)
        assert len(names) == 1 and "ecsq_assign_tiles" in names[0], names


def test_index_only_routes_write_no_reconstruction(dev):
    """CudaBackend.quantize and quantize_with_histogram(want_deq=False)
    on plan and ECSQ specs: the indices of quantize_dequantize, from a
    call that allocates no reconstruction (the kernels take a null
    pointer); the coded indices of a fast-route ECSQ plan in one launch
    and one device operation."""
    cb = get_backend("cuda")
    shape, plan = _plan("channel-g8")
    lo, hi = _ranges(plan)
    x = _x(dev, int(np.prod(shape)), dtype=torch.bfloat16).reshape(shape)
    thr, lvl = _ecsq_tables(lo.reshape(-1), hi.reshape(-1), 4)
    q = design_ecsq(x.float().cpu().numpy().reshape(-1)[::7], 4, 0.05,
                    -2.5, 3.0)
    shape2, plan2 = _plan("2d-ragged-nchw")
    lo2, hi2 = _ranges(plan2)
    x2 = _x(dev, int(np.prod(shape2))).reshape(shape2)
    thr2, lvl2 = _ecsq_tables(lo2.reshape(-1), hi2.reshape(-1), 4)
    specs = [
        (x, QuantSpec(lo, hi, 4, -1, plan=plan)),
        (x, QuantSpec(lo, hi, 4, -1, TileECSQ(levels=lvl, thresholds=thr),
                      plan)),
        (x, QuantSpec(-2.5, 3.0, 4, ecsq=q)),
        (x2, QuantSpec(lo2, hi2, 4, 1, plan=plan2)),
        (x2, QuantSpec(lo2, hi2, 4, 1, TileECSQ(levels=lvl2,
                                                 thresholds=thr2), plan2)),
    ]
    for xs, spec in specs:
        want = cb.quantize_dequantize(xs, spec)[0]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        got = cb.quantize(xs, spec)
        peak = torch.cuda.max_memory_allocated() - base
        assert torch.equal(got, want)
        assert peak <= got.numel() * 4 + (1 << 16), peak
        got2, none, _ = cb.quantize_with_histogram(xs, spec, want_deq=False)
        assert none is None and torch.equal(got2, want)
    spec = specs[1][1]
    before = dict(_build.LAUNCHES)
    coded = cb.coded_indices_device(x, spec, 2)
    assert _advanced(before, ecsq_assign_tiles=1)
    assert torch.equal(coded.cpu(), torch.from_numpy(
        plan.to_coded_order(cb.quantize(x, spec).cpu().numpy())))
    names = _device_ops(lambda: cb.coded_indices_device(x, spec, 2))
    assert len(names) == 1 and "ecsq_assign_tiles" in names[0], names


@pytest.mark.parametrize("shape", [(4, 1, 4096), (4, 64, 4096), (3, 5, 64)])
def test_plan_codec_rate_paths_count_in_the_quantizer(dev, shape):
    """A per-channel g=8 codec: ``quantize_with_rate`` and
    ``apply_with_rate`` launch #2 once and #5 never, and
    ``quantize_packed_with_rate`` launches #2 once and #9 and #5 never;
    their rates equal the two-launch path's (quantize, then the tile
    histogram) exactly and the packed bytes are those of quantize, then
    pack; each quantizer stage is one device operation."""
    c = shape[-1]
    samples = _x(dev, 64 * c, seed=3).reshape(64, c).cpu().numpy()
    codec = calibrate(CodecConfig(n_levels=4, clip_mode="minmax",
                                  constrain_cmin_zero=False,
                                  granularity="channel", channel_axis=-1,
                                  channel_group_size=8, backend="cuda"),
                      samples)
    assert codec.packs_in_quantizer()
    x = _x(dev, int(np.prod(shape)), dtype=torch.bfloat16).reshape(shape)
    two_launch = codec.rate_from_indices(codec.quantize(x), x.shape)
    before = dict(_build.LAUNCHES)
    deq, rate = codec.apply_with_rate(x)
    idx, none, rate2 = codec.quantize_with_rate(x)
    packed, rate3 = codec.quantize_packed_with_rate(x)
    assert _advanced(before, clip_quant_tiles=3, index_histogram_tiles=0,
                     pack_bits=0)
    assert torch.equal(deq, codec.apply(x)) and none is None
    assert torch.equal(idx, codec.quantize(x))
    assert torch.equal(packed, codec.pack(idx.reshape(-1)))
    assert float(rate) == float(rate2) == float(rate3) == float(two_launch)
    spec, bits = codec.spec(), codec.bits_per_index()
    for fn in (lambda: codec.backend.quantize_with_histogram(x, spec),
               lambda: codec.backend.quantize_packed_with_histogram(
                   x, spec, bits)):
        names = _device_ops(fn)
        assert len(names) == 1 and "clip_quant_tiles" in names[0], names


# -- the per-tensor ECSQ quantizer's counting and packing variants (#7) --------

# one block (up to 4,096 values), a cluster (the decode boundary), the
# ticket (70,001 and the prefill boundary's 2^20), ragged tails, and more
# than the no-histogram grid's one group a thread
ECSQ_SIZES = [1, 7, 4095, 4097, 16384, 70001, 1 << 20, 4_800_003]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_levels", [2, 4, 16, 64])
@pytest.mark.parametrize("n", ECSQ_SIZES)
def test_ecsq_assign_variants(dev, n, n_levels, dtype):
    """Every variant of #7 against its plain version on aligned views and
    views that are not (scalar loads), values outside the clip range:
    indices, reconstructions, bins and bytes exact, one launch a call and
    no histogram or pack launch."""
    cmin, cmax = -1.7, 2.9
    thr, lvl = (torch.from_numpy(t) for t in _ecsq_tables(
        np.float32(cmin), np.float32(cmax), n_levels, seed=7))
    x0 = _x(dev, n + 1, seed=n, dtype=dtype)
    for x in (x0[:n], x0[1:]):
        for kw in (dict(), dict(want_deq=False), dict(want_hist=True),
                   dict(want_deq=False, want_hist=True)):
            before = dict(_build.LAUNCHES)
            got = ecsq_assign.ecsq_assign(x, thr, lvl, cmin, cmax, **kw)
            assert _advanced(before, ecsq_assign=1, index_histogram=0)
            want = ecsq_assign.ecsq_assign_plain(x, thr, lvl, cmin, cmax,
                                                 **kw)
            for a, b in zip(got, want):
                assert (a is None and b is None) or torch.equal(a, b), kw
        for bits in (1, 2, 4):
            if n_levels <= 1 << bits:
                before = dict(_build.LAUNCHES)
                kp, kh = ecsq_assign.ecsq_assign_pack(x, thr, lvl, cmin,
                                                      cmax, bits)
                assert _advanced(before, ecsq_assign=1, pack_bits=0,
                                 index_histogram=0)
                pp, ph = ecsq_assign.ecsq_assign_pack_plain(
                    x, thr, lvl, cmin, cmax, bits)
                assert torch.equal(kp, pp) and torch.equal(kh, ph), bits


def test_ecsq_assign_variants_are_one_device_operation(dev):
    thr, lvl = (torch.from_numpy(t) for t in _ecsq_tables(
        np.float32(-2.0), np.float32(2.5), 4))
    for shape in [(4, 1, 4096), (4, 64, 4096)]:
        x = _x(dev, int(np.prod(shape)), dtype=torch.bfloat16).reshape(shape)
        for call in (lambda: ecsq_assign.ecsq_assign(x, thr, lvl, -2.0, 2.5,
                                                     want_hist=True),
                     lambda: ecsq_assign.ecsq_assign_pack(x, thr, lvl, -2.0,
                                                          2.5, 2)):
            names = _device_ops(call)
            assert len(names) == 1 and "ecsq_assign" in names[0], names


def test_ecsq_histograms_on_two_streams(dev):
    """#7's counting variant at 2^20 values, 50 launches on each of two
    side streams interleaved with no sync: every bin exact."""
    x = _x(dev, 1 << 20, seed=17, dtype=torch.bfloat16)
    thr, lvl = (torch.from_numpy(t) for t in _ecsq_tables(
        np.float32(-1.5), np.float32(2.75), 4))
    want = ecsq_assign.ecsq_assign_plain(x, thr, lvl, -1.5, 2.75,
                                         want_deq=False, want_hist=True)[2]
    streams = [torch.cuda.Stream(device=dev) for _ in range(2)]
    torch.cuda.synchronize()
    out = []
    for _ in range(50):
        for stream in streams:
            with torch.cuda.stream(stream):
                out.append(ecsq_assign.ecsq_assign(
                    x, thr, lvl, -1.5, 2.75, want_deq=False,
                    want_hist=True)[2])
    torch.cuda.synchronize()
    assert all(torch.equal(h, want) for h in out)


@pytest.mark.parametrize("shape", [(4, 1, 4096), (4, 64, 4096), (3, 5, 7)])
def test_ecsq_codec_rate_paths_count_in_the_quantizer(dev, shape):
    """A per-tensor ECSQ N=4 codec: ``apply_with_rate``,
    ``quantize_with_rate`` and ``quantize_packed_with_rate`` launch #7
    once each and #4 and #9 never; their rates equal the two-launch
    path's (quantize, then the index histogram) exactly, the packed bytes
    those of quantize, then pack."""
    samples = _x(dev, 1 << 14, seed=5).cpu().numpy()
    codec = calibrate(CodecConfig(n_levels=4, use_ecsq=True,
                                  clip_mode="empirical",
                                  constrain_cmin_zero=False,
                                  backend="cuda"), samples)
    assert codec.packs_in_quantizer()
    x = _x(dev, int(np.prod(shape)), dtype=torch.bfloat16).reshape(shape)
    two_launch = codec.rate_from_indices(codec.quantize(x), x.shape)
    before = dict(_build.LAUNCHES)
    deq, rate = codec.apply_with_rate(x)
    idx, none, rate2 = codec.quantize_with_rate(x)
    packed, rate3 = codec.quantize_packed_with_rate(x)
    assert _advanced(before, ecsq_assign=3, index_histogram=0, pack_bits=0)
    assert torch.equal(deq, codec.apply(x)) and none is None
    assert torch.equal(idx, codec.quantize(x))
    assert torch.equal(packed, codec.pack(idx.reshape(-1)))
    assert float(rate) == float(rate2) == float(rate3) == float(two_launch)


# -- the accuracy harness and the model families ----------------------------------

def test_run_scenario_kernels_match_the_torch_backend(dev):
    """``transformer-tensor`` on the card with the CUDA kernels (#1 at
    N=256, #3 at 16 and 4) against ``backend="torch"`` on the same
    weights: identical coded bytes and degradation, the logit rmse
    within 1e-6 (reconstructions may part by 1 ulp)."""
    from repro_torch.eval import SCENARIOS, run_scenario
    sc = SCENARIOS["transformer-tensor"]
    _build.reset_launches()
    kern = run_scenario(sc, device=dev)
    launched = dict(_build.LAUNCHES)
    plain = run_scenario(sc, backend="torch", device=dev)
    assert launched["clip_quant"] > 0 and launched["encode_tiles"] > 0
    assert len(kern.cases) == len(plain.cases) == 6
    for k, p in zip(kern.cases, plain.cases):
        assert (k.rung, k.clip_mode, k.coded_bytes, k.degradation,
                k.raw_degradation) == (p.rung, p.clip_mode, p.coded_bytes,
                                       p.degradation, p.raw_degradation)
        np.testing.assert_allclose(k.logit_rmse, p.logit_rmse, rtol=1e-6)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["dbrx-132b", "rwkv6-3b",
                                  "recurrentgemma-2b"])
def test_family_forward_on_the_card_matches_the_cpu(dev, arch, dtype):
    """The MoE, RWKV-6 and RG-LRU models (reduced, two periods) on the
    card against the CPU on the same weights and tokens: float32 logits
    within rtol/atol 1e-4 (reduction order), bfloat16 logits within 2e-2
    of the CPU's relative L2 norm (each side rounds every op to
    bfloat16)."""
    from repro_torch.models import forward
    base = get_config(arch)
    cfg = dataclasses.replace(reduced(base, layers=2 * base.period),
                              dtype=dtype)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 24)).astype(np.int32))
    with torch.inference_mode():
        want = forward(cfg, params, toks)[0]
        got = forward(cfg, _to(params, dev), toks.to(dev))[0].cpu()
    assert torch.isfinite(got).all()
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                                   atol=1e-4)
    else:
        rel = float(torch.linalg.norm(got - want) / torch.linalg.norm(want))
        assert rel <= 2e-2, rel
