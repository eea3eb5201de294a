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
        codec.quantize_packed_with_counts(x)


def test_quantize_packed_with_rate_on_card(dev):
    """The codec's packing pass (``quantize_packed_with_counts``, the
    rate from its counts) against the two-launch path on the same
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
            packed, counts = codec.quantize_packed_with_counts(x)
            rate = codec.rate_from_counts(counts, shape)
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
    ``quantize_packed_with_counts`` launches #2 once and #9 and #5 never;
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
    packed, counts = codec.quantize_packed_with_counts(x)
    rate3 = codec.rate_from_counts(counts, x.shape)
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
    ``quantize_with_rate`` and ``quantize_packed_with_counts`` launch #7
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
    packed, counts = codec.quantize_packed_with_counts(x)
    rate3 = codec.rate_from_counts(counts, x.shape)
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


# -- the transport slice: the encode tick and the socket link on the card -----

def _tick_twins(kind):
    """(CUDA-backend codec, torch twin, items) for a tick case: the
    codecs calibrated alike from one seeded set of samples."""
    from repro_torch.core.codec import CodecConfig as C
    rng = np.random.default_rng(11)
    last = (rng.standard_normal((4, 64, 256)) * 1.3 + 0.1).astype(np.float32)
    conv = (rng.exponential(1.0, (1, 16, 8, 9))
            + np.linspace(0, 5, 16)[None, :, None, None]).astype(np.float32)
    base = dict(n_levels=4, clip_mode="minmax", constrain_cmin_zero=False)
    kinds = {
        "tensor": (dict(base), last.reshape(-1),
                   [last, 0.5 * last, last[:, :1]]),
        "channel_g8": (dict(base, granularity="channel", channel_axis=-1,
                            channel_group_size=8), last.reshape(-1, 256),
                       [last, 0.5 * last, 2.0 * last]),
        "tile1d": (dict(base, granularity="tile", channel_axis=1,
                        channel_group_size=2, spatial_block_size=24),
                   conv, [conv, 2.0 * conv]),
        "tile2d": (dict(base, granularity="tile", channel_axis=1,
                        channel_group_size=2, spatial_block_hw=(4, 3)),
                   conv, [conv, 0.25 * conv, 4.0 * conv]),
        "tile2d_ecsq": (dict(base, granularity="tile", channel_axis=1,
                             channel_group_size=2, spatial_block_hw=(4, 3),
                             use_ecsq=True), conv, [conv, 0.5 * conv]),
    }
    kw, samples, xs = kinds[kind]
    cuda = calibrate(C(backend="cuda", **kw), samples=samples)
    cpu = calibrate(C(backend="torch", **kw), samples=samples)
    return cuda, cpu, xs


@pytest.mark.parametrize("device_entropy", [False, True])
@pytest.mark.parametrize("kind", ["tensor", "channel_g8", "tile1d",
                                  "tile2d", "tile2d_ecsq"])
def test_encode_tick_matches_the_torch_backend(dev, kind, device_entropy):
    """A stacked tick on the CUDA backend writes the torch backend's
    payloads and its own per-session ``encode_stream``'s, and launches
    the encode megakernel once per stacked group (the ECSQ plan: its
    tile kernel) and, with ``device_entropy``, the step loop once per
    session."""
    from repro_torch.serving import TickConfig, encode_tick
    cuda, cpu, xs = _tick_twins(kind)
    cfg = TickConfig(chunk_elems=4096, device_entropy=device_entropy)
    before = dict(_build.LAUNCHES)
    got, stats = encode_tick([(cuda, x) for x in xs], cfg)
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in _build.LAUNCHES.items()}
    want, cstats = encode_tick([(cpu, x) for x in xs], cfg)
    assert got == want
    assert dataclasses.replace(stats, encode_s=0) == \
        dataclasses.replace(cstats, encode_s=0)
    assert got == [list(cuda.encode_stream(x, chunk_elems=4096,
                                           device_entropy=device_entropy))
                   for x in xs]
    assert stats.stacked_sessions == len(xs)
    quantizer = "ecsq_assign_tiles" if kind == "tile2d_ecsq" \
        else "encode_tiles"
    assert launched[quantizer] == stats.fused_launches == 1
    assert launched["rans_step"] == (len(xs) if device_entropy else 0)


def test_sockets_on_the_card(dev):
    """A port client and server on the card over 127.0.0.1: 8 concurrent
    sessions through the client's encode tick (stacked launch, device
    entropy stage) and the server's decode tick; every reconstruction
    equals ``decode_stream`` of the session's payloads, and the launch
    counts taken from the pool threads are exact."""
    import asyncio

    from repro_torch.serving import TickConfig
    from repro_torch.transport import CloudServer, EdgeClient
    cuda, _, _ = _tick_twins("tensor")
    rng = np.random.default_rng(3)
    xs = [(rng.standard_normal((4, 1, 256)) * (1 + i / 8)).astype(np.float32)
          for i in range(8)]
    tick = TickConfig(max_wait_s=0.05, max_batch=8, device_entropy=True)

    async def run():
        async with CloudServer(echo_features=True) as srv:
            async with EdgeClient("127.0.0.1", srv.port, codec=cuda,
                                  chunk_elems=512, tick=tick) as client:
                res = await asyncio.gather(*(client.submit(x) for x in xs))
                return res, dict(client.encode_counters), srv.counters

    before = dict(_build.LAUNCHES)
    results, enc, counters = asyncio.run(asyncio.wait_for(run(), 120))
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in _build.LAUNCHES.items()}
    for x, res in zip(xs, results):
        payloads = list(cuda.encode_stream(x, chunk_elems=512,
                                           device_entropy=True))
        np.testing.assert_array_equal(
            np.asarray(res.arrays[0]),
            cuda.decode_stream(payloads).reshape(x.shape))
    assert counters["sessions_served"] == 8
    assert enc["sessions"] == 8 and enc["stacked_sessions"] > 0
    assert launched["encode_tiles"] == enc["fused_launches"]
    assert launched["rans_step"] == 8


# -- training ----------------------------------------------------------------------

def _train_cfg(dtype="float32"):
    return dataclasses.replace(
        reduced(get_config("codeqwen1.5-7b")), vocab_size=128, d_model=32,
        d_ff=64, num_heads=2, num_kv_heads=2, head_dim=16, dtype=dtype)


def test_train_step_on_the_card_matches_the_cpu(dev):
    """One float32 ``make_train_step`` step (remat, two microbatches) on
    the card and on the CPU from the same weights: loss rtol 1e-5,
    parameters and moments rtol 1e-5, atol 1e-6."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import init_opt_state
    from repro_torch.tree import leaves, tree_map
    cfg = _train_cfg()
    cpu = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    card = tree_map(lambda t: t.to(dev), cpu)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 16)).astype(np.int32))
    step = make_train_step(cfg, microbatches=2)
    out_c = step(card, init_opt_state(card), {"tokens": toks.to(dev)})
    out_h = step(cpu, init_opt_state(cpu), {"tokens": toks})
    assert float(out_c[2]["loss"]) == pytest.approx(float(out_h[2]["loss"]),
                                                    rel=1e-5)
    for got, want in ((out_c[0], out_h[0]), (out_c[1]["mu"], out_h[1]["mu"]),
                      (out_c[1]["nu"], out_h[1]["nu"])):
        for (path, a), (_, b) in zip(leaves(got), leaves(want), strict=True):
            assert a.device.type == "cuda"
            np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=str(path))


def test_codec_in_the_loop_training_launches_clip_quant_once(dev):
    """``codec_fn=codec.apply_with_rate`` on the card: one per-tensor
    quantizer launch (#1, with its histogram) a step, zero gradients
    before the boundary, and the loss of the torch backend's codec."""
    from repro_torch.models import build_groups, loss_and_grads
    from repro_torch.tree import leaves, tree_map
    cfg = _train_cfg("bfloat16")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    kw = dict(n_levels=4, clip_mode="manual", manual_cmin=-1.5,
              manual_cmax=1.5)
    cuda = calibrate(CodecConfig(**kw, backend="cuda"))
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32)).to(dev)
    before = dict(_build.LAUNCHES)
    (loss, aux), grads = loss_and_grads(cfg, params, toks,
                                        codec_fn=cuda.apply_with_rate)
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in _build.LAUNCHES.items()}
    assert launched["clip_quant"] == 1 and sum(launched.values()) == 1
    groups, _ = build_groups(cfg, split=True)
    n_head = groups[0].n_periods * len(groups[0].specs)
    for path, g in leaves(grads):
        if path[0] == "layers":
            assert g.any() == (path[1] >= n_head), path
    cpu = calibrate(CodecConfig(**kw, backend="torch"))
    (loss_h, aux_h), _ = loss_and_grads(
        dataclasses.replace(cfg, dtype="float32"),
        tree_map(lambda t: t.float().cpu(), params), toks.cpu(),
        codec_fn=cpu.apply_with_rate)
    assert float(loss) == pytest.approx(float(loss_h), rel=2e-2)
    assert 0 < float(aux["codec_rate_bits"]) < 3


def test_prefetching_loader_copies_pinned_batches_to_the_card(dev):
    from repro_torch.data import DataConfig, PrefetchingLoader, stream
    cfg = DataConfig(vocab_size=50, batch=2, seq_len=8)
    loader = PrefetchingLoader(cfg, device=dev, start_step=2)
    try:
        for (_, want), got in zip(zip(range(3), stream(cfg, 2)), loader):
            assert got["tokens"].device.type == "cuda"
            np.testing.assert_array_equal(got["tokens"].cpu().numpy(),
                                          want["tokens"])
    finally:
        loader.close()
    assert not loader._thread.is_alive()


def test_checkpoint_keeps_bfloat16_bits_on_the_card(dev, tmp_path):
    """bfloat16 tensors on the card are saved as '<V2' arrays with their
    bits and restored onto the card unchanged."""
    from repro_torch.train import checkpoint as ckpt
    g = torch.Generator(device=dev).manual_seed(5)
    tree = {"w": torch.randn(33, 7, device=dev, generator=g)
            .to(torch.bfloat16), "m": [torch.randn(5, device=dev,
                                                   generator=g)],
            "step": torch.tensor(3, dtype=torch.int32, device=dev)}
    ckpt.save(str(tmp_path), 3, tree)
    with np.load(tmp_path / "step_00000003" / "arrays.npz") as data:
        assert data["w"].dtype == np.dtype("V2")
        assert data["w"].tobytes() == \
            tree["w"].view(torch.int16).cpu().numpy().tobytes()
    back = ckpt.restore(str(tmp_path), 3, tree)
    assert back["w"].device.type == "cuda"
    assert torch.equal(back["w"], tree["w"])
    assert torch.equal(back["m"][0], tree["m"][0])
    assert torch.equal(back["step"], tree["step"])


# -- the dry run: the meta pass against the card ---------------------------------

@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
@pytest.mark.parametrize("arch", ["codeqwen1.5-7b", "gemma3-1b", "dbrx-132b",
                                  "rwkv6-3b", "recurrentgemma-2b"])
def test_dry_run_counts_what_the_card_step_does(dev, arch, kind):
    """A reduced cell's ``run_cell`` on the one-card mesh: the same step
    on the card (weights from seed 0) holds exactly the predicted
    argument bytes, and ``FlopCounterMode`` around it counts exactly the
    meta pass's FLOPs."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import InputShape
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_smoke_mesh
    shape = InputShape(kind, 16, 2, kind)
    cfg = reduced(get_config(arch))
    rec = dryrun.run_cell(arch, shape, mesh=make_smoke_mesh(1),
                          overrides={f.name: getattr(cfg, f.name)
                                     for f in dataclasses.fields(cfg)},
                          microbatches=1, save_ops=False)
    assert rec["status"] == "ok", rec.get("traceback")
    step, args = dryrun.cell_step(
        cfg, shape, 1, device=dev,
        generator=torch.Generator(device=dev).manual_seed(0))
    held = sum(t.numel() * t.element_size() for t in _flat(args)
               if isinstance(t, torch.Tensor))
    assert held == rec["memory"]["argument_bytes"]
    with FlopCounterMode(display=False) as fc:
        step(*args)
    torch.cuda.synchronize()
    assert fc.get_total_flops() == rec["ops"]["flops"]


def _flat(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _flat(v)]
    return [tree]


# -- expert parallelism on the card ---------------------------------------------------

def _ep_card_rank(rank, out_dir):
    """One of two ranks on cuda:0 (gloo: NCCL refuses two ranks on one
    card): reduced qwen3-moe at capacity factor 0.5 (assignments
    dropped), this rank's 4 of 8 experts."""
    from repro_torch.launch.mesh import Mesh, device_mesh
    from repro_torch.models import DistContext
    from repro_torch.models import context as C
    from repro_torch.models import moe as MOE
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    ctx = DistContext(device_mesh(Mesh((1, 2), ("data", "model")), "cuda"))
    cfg = dataclasses.replace(reduced(get_config("qwen3-moe-235b-a22b")),
                              capacity_factor=0.5)
    whole = MOE.init_moe(torch.Generator(device=dev).manual_seed(0), cfg,
                         torch.float32, dev)
    sl = C.expert_slice(ctx, cfg.num_experts)
    mine = {k: (v if k == "router" else v[sl].clone()).requires_grad_()
            for k, v in whole.items()}
    gen = torch.Generator(device=dev).manual_seed(1)
    res = {}
    for s in (8, 1):
        x = torch.randn((32, s, cfg.d_model), generator=gen, device=dev) \
            .requires_grad_()
        r = torch.randn(x.shape, generator=gen, device=dev)
        out = MOE.moe_apply(x, mine, cfg, ctx)
        gx, gw1 = torch.autograd.grad((out * r).sum(), [x, mine["w1"]])
        # moe_local over what the path dispatches at once: this rank's
        # chunk of the sequence, or every token
        m = s // 2 if s == 8 else s
        lo = ctx.tp_rank * m if s == 8 else 0
        xl = x.detach()[:, lo:lo + m].requires_grad_()
        ref = MOE.moe_local(xl.reshape(-1, cfg.d_model), whole, cfg
                            ).reshape(xl.shape)
        res[f"S{s}/out"] = (out[:, lo:lo + m] - ref).abs().max().item()
        if s == 1:
            want = torch.autograd.grad((ref * r).sum(), xl)[0]
            res["S1/g_x"] = (gx - want).abs().max().item()
        res[f"S{s}/g_w1_finite"] = bool(torch.isfinite(gw1).all())
    np.save(out_dir / f"card{rank}.npy", res, allow_pickle=True)


@pytest.mark.timeout(300)
def test_expert_parallel_on_two_ranks_on_the_card(dev, tmp_path):
    """moe_apply under a two-rank context on the card: each rank's chunk of
    the sequence path and the decode path's output within 1e-5 of
    ``moe_local`` (float32) over what the path dispatches at once, the
    decode path's input gradient within 1e-4 of ``moe_local``'s."""
    from test_torch_context import spawn
    spawn(_ep_card_rank, 2, tmp_path, tmp_path)
    for rank in range(2):
        res = np.load(tmp_path / f"card{rank}.npy", allow_pickle=True).item()
        assert res["S8/out"] <= 1e-5 and res["S1/out"] <= 1e-5, res
        assert res["S1/g_x"] <= 1e-4, res
        assert res["S8/g_w1_finite"] and res["S1/g_w1_finite"]


# -- the split runtime across ranks on the card ---------------------------------------

def _split_card_rank(rank, out_dir):
    """One of two ranks on cuda:0 over gloo (NCCL refuses two ranks on one
    card) in a (pod, data, model) = (2, 1, 1) mesh: reduced codeqwen1.5-7b
    (float32, 4 layers), the split step across ranks against the
    one-process runtime on the card, ``raw`` and ``packed`` N=4."""
    from repro_torch.launch.mesh import Mesh, device_mesh
    from repro_torch.models import DistContext
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    ctx = DistContext(device_mesh(Mesh((2, 1, 1), ("pod", "data", "model")),
                                  "cuda"), ("data",))
    cfg = dataclasses.replace(reduced(get_config("codeqwen1.5-7b"), layers=4),
                              vocab_size=64)
    codec = calibrate(CodecConfig(n_levels=4, clip_mode="manual",
                                  manual_cmin=-8.0, manual_cmax=8.0,
                                  backend="cuda"))
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, 64, (4, 4)), device=dev)
    kw = dict(edge_device=dev, cloud_device=dev)
    res = {}
    for transport in ("raw", "packed"):
        c = None if transport == "raw" else codec
        runs = {}
        for name, ctx_ in (("ranks", ctx), ("one", None)):
            step = split_runtime.make_split_decode_step(
                cfg, c, transport=transport, ctx=ctx_, **kw)
            sp = split_runtime.split_params(cfg, params, ctx=ctx_, **kw)
            caches = split_runtime.init_split_cache(cfg, 4, 8, ctx=ctx_, **kw)
            _build.reset_launches()
            out = [step(sp, tokens[pos], caches, pos) for pos in range(4)]
            torch.cuda.synchronize()
            runs[name] = ([o[0].cpu() for o in out],
                          [float(o[2]) for o in out], dict(_build.LAUNCHES))
        res[f"{transport}/logits_equal"] = all(
            torch.equal(a, b) for a, b in zip(runs["ranks"][0],
                                              runs["one"][0]))
        res[f"{transport}/rates_equal"] = runs["ranks"][1] == runs["one"][1]
        res[f"{transport}/launches"] = {k: v for k, v in
                                        runs["ranks"][2].items() if v}
    res["stage"] = "edge" if ctx.pod_rank == 0 else "cloud"
    np.save(out_dir / f"split{rank}.npy", res, allow_pickle=True)


@pytest.mark.timeout(300)
def test_split_across_ranks_on_the_card(dev, tmp_path):
    """The (2, 1, 1) split step across two ranks on the card: logits and
    rates identical in every bit to the one-process runtime's on the
    card; the edge rank launches the per-tensor quantizer (packing in its
    launch) once a packed step, the cloud rank no kernel."""
    from test_torch_context import spawn
    spawn(_split_card_rank, 2, tmp_path, tmp_path)
    for rank in range(2):
        res = np.load(tmp_path / f"split{rank}.npy", allow_pickle=True).item()
        for transport in ("raw", "packed"):
            assert res[f"{transport}/logits_equal"], (rank, transport)
            assert res[f"{transport}/rates_equal"], (rank, transport)
        assert res["raw/launches"] == {}
        assert res["packed/launches"] == (
            {"clip_quant": 4} if res["stage"] == "edge" else {}), res


def _tiles_card_rank(rank, out_dir):
    """One of four ranks on cuda:0 over gloo in a (pod, data, model) =
    (2, 2, 1) mesh: reduced codeqwen1.5-7b (float32, 4 layers), the packed
    split step across ranks with a tiled codec whose tiles span rows (the
    edge ranks gather their rows) against the one-process runtime on the
    card."""
    from repro_torch.launch.mesh import Mesh, device_mesh
    from repro_torch.models import DistContext
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    ctx = DistContext(device_mesh(Mesh((2, 2, 1), ("pod", "data", "model")),
                                  "cuda"), ("data",))
    cfg = dataclasses.replace(reduced(get_config("codeqwen1.5-7b"), layers=4),
                              vocab_size=64)
    codec = calibrate(CodecConfig(
        n_levels=4, granularity="tile", channel_axis=-1, channel_group_size=8,
        spatial_block_size=2, clip_mode="minmax", backend="cuda"),
        samples=np.random.default_rng(0).standard_normal(
            (4, 1, cfg.d_model)).astype(np.float32))
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, 64, (4, 4)), device=dev)
    kw = dict(edge_device=dev, cloud_device=dev)
    runs = {}
    for name, ctx_ in (("ranks", ctx), ("one", None)):
        step = split_runtime.make_split_decode_step(
            cfg, codec, transport="packed", ctx=ctx_, **kw)
        sp = split_runtime.split_params(cfg, params, ctx=ctx_, **kw)
        caches = split_runtime.init_split_cache(cfg, 4, 8, ctx=ctx_, **kw)
        _build.reset_launches()
        out = [step(sp, tokens[pos], caches, pos) for pos in range(4)]
        torch.cuda.synchronize()
        runs[name] = ([o[0].cpu() for o in out], [float(o[2]) for o in out],
                      {k: v for k, v in _build.LAUNCHES.items() if v})
    res = {"logits_equal": all(torch.equal(a, b) for a, b in
                               zip(runs["ranks"][0], runs["one"][0])),
           "rates_equal": runs["ranks"][1] == runs["one"][1],
           "launches": runs["ranks"][2], "one_launches": runs["one"][2],
           "stage": "edge" if ctx.pod_rank == 0 else "cloud"}
    np.save(out_dir / f"tiles{rank}.npy", res, allow_pickle=True)


@pytest.mark.timeout(300)
def test_split_across_ranks_tiles_spanning_rows_on_the_card(dev, tmp_path):
    """(2, 2, 1) with a tiled codec whose tiles span rows: the edge ranks
    gather their rows and quantize the whole batch's tiles; every rank's
    logits and rates identical in every bit to the one-process runtime's
    on the card; each edge rank launches what the one-process run
    launched, each cloud rank nothing."""
    from test_torch_context import spawn
    spawn(_tiles_card_rank, 4, tmp_path, tmp_path)
    for rank in range(4):
        res = np.load(tmp_path / f"tiles{rank}.npy", allow_pickle=True).item()
        assert res["logits_equal"] and res["rates_equal"], (rank, res)
        assert res["launches"] == (res["one_launches"]
                                   if res["stage"] == "edge" else {}), res
        assert res["stage"] == ("edge" if rank < 2 else "cloud")


def _engine_card_rank(rank, out_dir):
    """One of two ranks on cuda:0 over gloo, a (data, model) = (2, 1)
    mesh: the engine's cases of ``tests/test_torch_context.py`` with
    their codecs on the card."""
    import pickle

    from test_torch_context import ENGINE_CASES, _engine_run

    from repro_torch.launch.mesh import Mesh, device_mesh
    from repro_torch.models import DistContext
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    ctx = DistContext(device_mesh(Mesh((2, 1), ("data", "model")), "cuda"),
                      ("data",))
    res = {case: _engine_run(case, ctx, "cuda") for case in ENGINE_CASES}
    (out_dir / f"engine{rank}.pkl").write_bytes(pickle.dumps(res))


@pytest.mark.timeout(300)
def test_engine_on_dp_ranks_on_the_card(dev, tmp_path):
    """``ServeEngine(ctx=)`` on two dp ranks on the card, its codecs on
    the CUDA backend: tokens, ``rate_log``, counters and retirements equal
    the one-rank engine's on the card, logits within the CPU test's
    tolerance."""
    import pickle

    from test_torch_context import (ENGINE_ATOL, ENGINE_CASES, ENGINE_RTOL,
                                    _engine_run, spawn)
    spawn(_engine_card_rank, 2, tmp_path, tmp_path)
    for case in ENGINE_CASES:
        want = _engine_run(case, None, "cuda")
        for rank in range(2):
            got = pickle.loads((tmp_path / f"engine{rank}.pkl")
                               .read_bytes())[case]
            for key in ("tokens", "rate_log", "counters", "retired"):
                assert got[key] == want[key], (case, rank, key)
            for a, b in zip(got["logits"], want["logits"], strict=True):
                np.testing.assert_allclose(a, b, rtol=ENGINE_RTOL,
                                           atol=ENGINE_ATOL)


@pytest.mark.timeout(300)
def test_examples_on_the_card(dev, tmp_path):
    """``python -m repro_torch.examples.quickstart`` prints on the card
    what it prints with ``--device cpu``; ``edge_cloud_demo --smoke``
    runs its two processes on the card and prints its OK line."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, PYTHONPATH=src)

    def run(*args):
        out = subprocess.run([sys.executable, "-m"] + list(args),
                             capture_output=True, text=True, timeout=240,
                             env=env, cwd=tmp_path)
        assert out.returncode == 0, out.stdout + out.stderr
        return out.stdout

    card = run("repro_torch.examples.quickstart")
    assert card == run("repro_torch.examples.quickstart", "--device", "cpu")
    demo = run("repro_torch.examples.edge_cloud_demo", "--smoke")
    assert "[edge] OK: streamed cloud reconstruction is bit-exact" in demo


@pytest.mark.timeout(300)
def test_train_with_compression_resumes_exactly_on_the_card(dev, tmp_path):
    """``train_with_compression`` on the card at 6 steps, a checkpoint
    every 2 and a failure at step 3: the resumed run's losses are the
    uninterrupted run's, bit for bit."""
    from repro_torch.examples import train_with_compression as TW

    res = TW.run("cuda", ckpt_dir=str(tmp_path / "ckpt"), steps=6,
                 ckpt_every=2, fail_at=3, batch=2, seq_len=16)
    assert res["resumed_from"] == 2
    assert res["resumed"] == res["base"][2:]
    assert res["compressed"] != res["base"]


# -- decode attention over the written prefix ----------------------------------

# name -> (B, S_cache, H, K, hd, window, softcap, positions), bf16: the
# benchmark cell's shape, dbrx's 48/8 heads on its 32 x 4096 cache, and a
# ring of S = window slots with a soft cap at hd 256 before and after it
# wraps
DECODE_ATTENTION = {
    "cell": (48, 8192, 32, 4, 128, None, 0.0,
             (0, 1, 255, 256, 2047, 2150, 8191)),
    "dbrx": (32, 4096, 48, 8, 128, None, 0.0, (0, 1000, 4095)),
    "ring-softcap-hd256": (4, 512, 16, 8, 256, 512, 50.0,
                           (300, 511, 512, 1300)),
}


def _decode_attention_inputs(dev, name, pos):
    """q, k, v of a DECODE_ATTENTION case, with the slots past the written
    prefix holding large values, so that reading one would show."""
    b, s, h, kh, hd, *_ = DECODE_ATTENTION[name]
    g = torch.Generator(device=dev).manual_seed(pos)
    q = torch.randn((b, 1, h, hd), device=dev, generator=g).to(torch.bfloat16)
    k, v = (torch.randn((b, s, kh, hd), device=dev, generator=g).to(
        torch.bfloat16) for _ in range(2))
    n_valid = min(pos + 1, s)
    k[:, n_valid:] = 1e4
    v[:, n_valid:] = -1e4
    return q, k, v, n_valid


def _exact_attention(q, k, v, n_valid, softcap):
    """Float64 attention of q (B, 1, H, hd) over slots [0, n_valid) of k,
    v: the value both paths round towards."""
    b, _, h, hd = q.shape
    kh = k.shape[2]
    logits = torch.einsum("bkgh,btkh->bkgt",
                          q.double().reshape(b, kh, h // kh, hd),
                          k[:, :n_valid].double()) / hd ** 0.5
    if softcap > 0.0:
        logits = softcap * torch.tanh(logits / softcap)
    out = torch.einsum("bkgt,btkh->bkgh", torch.softmax(logits, dim=-1),
                       v[:, :n_valid].double())
    return out.reshape(b, 1, h, hd)


@pytest.mark.parametrize("name,pos", [(n, p) for n, c in
                                      DECODE_ATTENTION.items() for p in c[-1]])
def test_decode_attention_matches_the_plain_path(dev, name, pos):
    """The kernel against the plain decode path (the masked attention over
    the whole cache) on the same inputs, within rtol 1.6e-2, atol 1e-2;
    and against float64 attention over the prefix, no further off than
    twice the plain path's largest error there and 2^-12: the kernel
    rounds exp(s - m_tile) to bf16 where the plain path rounds the
    normalised probabilities, each an error of a bf16 unit a term, so a
    split left out of the combine or weighted wrongly, a few thousandths
    at the longer prefixes, would show."""
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.models import layers as L

    _, s, _, _, _, window, softcap, _ = DECODE_ATTENTION[name]
    q, k, v, n_valid = _decode_attention_inputs(dev, name, pos)
    idx = torch.arange(s, dtype=torch.int32, device=dev)
    k_pos = pos - (pos - idx) % s if window else idx
    want = L.multi_head_attention(q, k, v, q_offset=pos, k_positions=k_pos,
                                  window=window, softcap=softcap)
    before = dict(_build.LAUNCHES)
    got = DA.decode_attention(q[:, 0], k, v, n_valid, softcap)
    torch.cuda.synchronize()
    assert _advanced(before, decode_attention=1)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), rtol=1.6e-2,
                               atol=1e-2)
    exact = _exact_attention(q, k, v, n_valid, softcap)
    err_got = float((got.double() - exact).abs().max())
    err_plain = float((want.double() - exact).abs().max())
    assert err_got <= 2 * err_plain + 2.0 ** -12, (err_got, err_plain)


@pytest.mark.parametrize("name,pos", [("cell", 2150), ("cell", 8191),
                                      ("dbrx", 4095),
                                      ("ring-softcap-hd256", 1300)])
def test_decode_attention_combines_splits(dev, name, pos, monkeypatch):
    """The split plan's several splits, combined by the second launch,
    against the same kernel run as one split over the whole prefix (no
    combine): the two differ only in where exp(s - m) is rounded and in
    the order of float32 sums, a bf16 unit of the output or so."""
    from repro_torch.kernels import decode_attention as DA

    b, _, _, kh, hd, _, softcap, _ = DECODE_ATTENTION[name]
    q, k, v, n_valid = _decode_attention_inputs(dev, name, pos)
    _, n_splits = DA.split_plan(b * kh, n_valid, hd, DA._sm_count(dev.index
                                                                  or 0))
    assert n_splits > 1
    split = DA.decode_attention(q[:, 0], k, v, n_valid, softcap)
    tk = DA.tile_slots(hd)
    monkeypatch.setattr(DA, "split_plan",
                        lambda bk, n, hd_, sms: (-(-n // tk) * tk, 1))
    whole = DA.decode_attention(q[:, 0], k, v, n_valid, softcap)
    torch.cuda.synchronize()
    torch.testing.assert_close(split.float(), whole.float(), rtol=1e-2,
                               atol=1e-3)


@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_decode_step_keeps_other_caches_on_the_plain_path(dev, dtype):
    """A float32 or fp16 cache on the card takes the plain path: a decode
    step launches no decode attention, and the wrapper refuses such
    tensors on the card."""
    from repro_torch.kernels import decode_attention as DA

    cfg = dataclasses.replace(reduced(get_config("codeqwen1.5-7b")),
                              head_dim=128, num_heads=8, num_kv_heads=2,
                              dtype=dtype)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    cache = init_cache(cfg, 2, 16, device=dev)
    tok = torch.tensor([3, 7], dtype=torch.int32, device=dev)
    before = dict(_build.LAUNCHES)
    logits, _, _ = decode_step(cfg, params, tok, cache, 5)
    torch.cuda.synchronize()
    assert torch.isfinite(logits.float()).all()
    assert _advanced(before, decode_attention=0)
    q = torch.zeros((2, 8, 128), dtype=getattr(torch, dtype), device=dev)
    k = cache[0][0]["k"]
    with pytest.raises(ValueError):
        DA.decode_attention(q, k, k, 6)


@pytest.mark.parametrize("arch,hd", [("codeqwen1.5-7b", 128),
                                     ("gemma2-9b", 256)])
def test_decode_step_routes_attention_through_the_kernel(dev, arch, hd,
                                                         monkeypatch):
    """A bfloat16 decode step of a small config at a head size the kernel
    takes launches it once an attention layer, and its logits match the
    same step on the plain path (the kernel's route switched off) from
    the same cache.  gemma2's window layer is a ring of 64 slots that the
    steps wrap, with its soft cap; logits within 2% of their largest
    magnitude."""
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.models import prefill

    base = reduced(get_config(arch))
    cfg = dataclasses.replace(base, head_dim=hd, num_heads=8,
                              num_kv_heads=2, dtype="bfloat16")
    n_attn = sum(spec.kind == "attn" for spec in cfg.layer_specs())
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 60)).astype(np.int32)).to(dev)
    cache = init_cache(cfg, 2, 96, device=dev)
    logits, cache = prefill(cfg, params, toks, cache)
    tok = logits.argmax(-1)
    for pos in range(60, 68):
        plain_cache = [[{n: t.clone() for n, t in c.items()} for c in grp]
                       for grp in cache]
        before = dict(_build.LAUNCHES)
        got, cache, _ = decode_step(cfg, params, tok, cache, pos)
        torch.cuda.synchronize()
        assert _advanced(before, decode_attention=n_attn)
        with monkeypatch.context() as m:
            m.setattr(DA, "takes", lambda q, k: False)
            want, _, _ = decode_step(cfg, params, tok, plain_cache, pos)
        assert _advanced(before, decode_attention=n_attn)
        scale = float(want.float().abs().max())
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                                   atol=2e-2 * scale)
        tok = got.argmax(-1)


# -- prefill attention (#11) -------------------------------------------------------

# query heads a KV head -> (query heads, KV heads): one query head a KV
# head, dbrx's 48 / 8 and the benchmark cell's 32 / 4
PREFILL_GROUPS = {1: (4, 4), 6: (48, 8), 8: (32, 4)}


def _prefill_inputs(dev, b, s, g, hd, seed=0):
    """q (B, S, H, hd), k, v (B, S, K, hd), bf16; q doubled, so the
    softmax is peakier than the projections' unit scale gives."""
    h, kh = PREFILL_GROUPS[g]
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = (2 * torch.randn((b, s, h, hd), device=dev, generator=gen)).to(
        torch.bfloat16)
    k, v = (torch.randn((b, s, kh, hd), device=dev, generator=gen).to(
        torch.bfloat16) for _ in range(2))
    return q, k, v


def _exact_prefill(q, k, v):
    """Float64 causal attention of q (B, S, H, hd) over k, v (B, S, K,
    hd), a row at a time: the value both paths round towards."""
    b, s, h, hd = q.shape
    kh = k.shape[2]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    out = []
    for i in range(b):
        qi = q[i].double().reshape(s, kh, h // kh, hd)
        logits = torch.einsum("skgh,tkh->kgst", qi, k[i].double()) / hd ** 0.5
        logits = logits.masked_fill(~mask, float("-inf"))
        out.append(torch.einsum("kgst,tkh->skgh", torch.softmax(logits, -1),
                                v[i].double()).reshape(s, h, hd))
    return torch.stack(out)


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("g", list(PREFILL_GROUPS))
@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("s", [1, 15, 64, 65, 511, 512, 2150])
def test_prefill_attention_matches_the_plain_path(dev, s, b, g, hd):
    """The kernel against the plain prefill path
    (``multi_head_attention(q, k, v, q_offset=0)``) on the same inputs,
    within rtol 1.6e-2, atol 1e-2; and against float64 causal attention,
    no further off than twice the plain path's largest error there and
    2^-12: the kernel rounds exp(s - m_tile) to bf16 where the plain path
    rounds the normalised probabilities, each an error of a bf16 unit a
    term, so a tile skipped or masked wrongly would show.  S covers one
    row, part of a tile, whole and ragged key tiles and query tiles, and
    the benchmark's refill length."""
    from repro_torch.kernels import prefill_attention as PA
    from repro_torch.models import layers as L

    q, k, v = _prefill_inputs(dev, b, s, g, hd, seed=s)
    with torch.inference_mode():
        assert PA.takes(q, k, None, 0.0)
        want = L.multi_head_attention(q, k, v, q_offset=0)
        before = dict(_build.LAUNCHES)
        got = PA.prefill_attention(q, k, v)
        torch.cuda.synchronize()
    assert _advanced(before, prefill_attention=1)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert got.is_contiguous()
    torch.testing.assert_close(got.float(), want.float(), rtol=1.6e-2,
                               atol=1e-2)
    exact = _exact_prefill(q, k, v)
    err_got = float((got.double() - exact).abs().max())
    err_plain = float((want.double() - exact).abs().max())
    assert err_got <= 2 * err_plain + 2.0 ** -12, (err_got, err_plain)


def test_prefill_attention_reads_strided_values_in_place(dev):
    """A v laid out heads-outer (a permuted view, 16-byte aligned strides)
    is read in place and gives the contiguous v's output bit for bit; a
    v whose rows are not 16-byte aligned is copied first, to the same
    output."""
    from repro_torch.kernels import prefill_attention as PA

    q, k, v = _prefill_inputs(dev, 2, 300, 8, 128)
    heads_outer = v.transpose(1, 2).contiguous().transpose(1, 2)
    padded = torch.zeros((2, 300, 4 * 128 + 1), dtype=torch.bfloat16,
                         device=dev)
    padded[..., :512] = v.reshape(2, 300, 512)
    odd = padded[..., :512].unflatten(-1, (4, 128))
    assert not heads_outer.is_contiguous() and torch.equal(heads_outer, v)
    assert PA.kernel_view(heads_outer) is heads_outer
    assert PA.kernel_view(odd).data_ptr() != odd.data_ptr()
    with torch.inference_mode():
        want = PA.prefill_attention(q, k, v)
        for other in (heads_outer, odd):
            assert torch.equal(PA.prefill_attention(q, k, other), want)


@pytest.mark.parametrize("case", ["float32", "softcap", "window", "hd256",
                                  "group32", "grad"])
def test_prefill_attention_keeps_other_calls_on_the_plain_path(dev, case):
    """The predicate on the card: float32, soft-capped, windowed calls,
    head sizes and groups the kernel is not built for, and calls that
    autograd records keep ``multi_head_attention``; the same bf16 call
    without them takes the kernel."""
    from repro_torch.kernels import prefill_attention as PA

    h, kh, hd = {"hd256": (8, 2, 256), "group32": (64, 2, 128)}.get(
        case, (32, 4, 128))
    dtype = torch.float32 if case == "float32" else torch.bfloat16
    q = torch.zeros((1, 16, h, hd), dtype=dtype, device=dev,
                    requires_grad=case == "grad")
    k = torch.zeros((1, 16, kh, hd), dtype=dtype, device=dev)
    window = 8 if case == "window" else None
    softcap = 50.0 if case == "softcap" else 0.0
    assert not PA.takes(q, k, window, softcap)
    if case == "grad":
        with torch.no_grad():
            assert PA.takes(q, k, window, softcap)
        with pytest.raises(ValueError):
            PA.prefill_attention(q, k, k)


@pytest.mark.parametrize("arch", ["codeqwen1.5-7b", "gemma2-9b"])
def test_prefill_fills_the_cache_as_the_plain_path(dev, arch, monkeypatch):
    """A prefill of a small seeded bf16 model (head size 128, 8 / 2
    heads) on the card, through the kernel and through the plain path
    (the predicate switched off) from the same weights and tokens: layer
    0's K and V, which no attention output reaches, equal bit for bit;
    the later layers' and the logits within 2% of their largest
    magnitude.  The kernel launches once an attention layer a prefill and
    never in the decode steps after it; gemma2's soft-capped layers never
    launch it."""
    from repro_torch.kernels import prefill_attention as PA
    from repro_torch.models import prefill

    cfg = dataclasses.replace(reduced(get_config(arch)), head_dim=128,
                              num_heads=8, num_kv_heads=2, num_layers=3,
                              dtype="bfloat16")
    routed = sum(spec.kind == "attn" for spec in cfg.layer_specs()) \
        if cfg.attn_logit_softcap == 0 else 0
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 100)).astype(np.int32)).to(dev)
    with torch.inference_mode():
        before = dict(_build.LAUNCHES)
        with monkeypatch.context() as m:
            m.setattr(PA, "takes", lambda q, k, window, softcap: False)
            want, plain = prefill(cfg, params, toks,
                                  init_cache(cfg, 2, 112, device=dev))
        assert _advanced(before, prefill_attention=0)
        got, cache = prefill(cfg, params, toks,
                             init_cache(cfg, 2, 112, device=dev))
        torch.cuda.synchronize()
        assert _advanced(before, prefill_attention=routed)
    layers = [(g, c) for g, group in enumerate(plain) for c in range(
        len(group)) if "k" in group[c]]
    for n, (g, c) in enumerate(layers):
        for name in ("k", "v"):
            a, b = cache[g][c][name][:, :100], plain[g][c][name][:, :100]
            if n == 0 or not routed:
                assert torch.equal(a, b), (g, c, name)
            else:
                scale = float(b.float().abs().max())
                torch.testing.assert_close(a.float(), b.float(), rtol=2e-2,
                                           atol=2e-2 * scale)
    scale = float(want.float().abs().max())
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2 * scale)
    with torch.inference_mode():
        tok = got.argmax(-1)
        for pos in range(100, 104):
            logits, cache, _ = decode_step(cfg, params, tok, cache, pos)
            tok = logits.argmax(-1)
        torch.cuda.synchronize()
    assert _advanced(before, prefill_attention=routed)


@pytest.mark.parametrize("hookup", ["codec_fn", "codec_host_fn"])
def test_engine_prefills_launch_prefill_attention_once_a_layer(dev, hookup):
    """The serving engine on the card with a small bf16 model (head size
    128, 8 / 2 heads): every prefill -- each epoch's opening prefill and
    each batch-1 refill, with or without the host round trip
    ``codec_host_fn`` at the boundary -- launches #11 once an attention
    layer, and every decode step launches #10 once an attention layer
    and #11 never."""
    from repro_torch.serving import Request, ServeEngine

    cfg = dataclasses.replace(reduced(get_config("codeqwen1.5-7b"),
                                      layers=4),
                              head_dim=128, num_heads=8, num_kv_heads=2,
                              dtype="bfloat16")
    n_attn = sum(spec.kind == "attn" for spec in cfg.layer_specs())
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    hook = {} if hookup == "codec_fn" else {
        "codec_host_fn": lambda x: (x, 16.0)}
    eng = ServeEngine(cfg, params, slots=2, max_seq=64, refill_align=1,
                      device=dev, **hook)
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, p).astype(
        np.int32), max_new_tokens=n)
        for p, n in [(5, 6), (9, 3), (4, 8), (7, 2), (6, 5)]]
    _build.reset_launches()
    eng.generate(reqs)
    torch.cuda.synchronize()
    c = eng.counters
    assert c["refills"] > 0 and c["prefills"] == c["epochs"] + c["refills"]
    assert _build.LAUNCHES["prefill_attention"] == n_attn * c["prefills"]
    assert _build.LAUNCHES["decode_attention"] == n_attn * c["steps"]
    assert all(len(r.out_tokens) == r.max_new_tokens for r in reqs)
