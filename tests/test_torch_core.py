"""Port vs reference: the numeric core (copies and torch ports), the
backend seam, and the package's import isolation.

Inputs are made with numpy from a seed and run through the JAX package
(``jnp`` backend) and the port (``torch`` backend, CPU tensors).
Tolerances: indices, histograms and entropy payloads exact; calibrated
ranges exact (the host math is the same numpy code); reconstructions
within 1 ulp; rate estimates rtol 1e-5 (float32 log2 may differ in the
last place between the two libraries).
"""

import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import CodecConfig as JCodecConfig
from repro.core import calibrate as jcalibrate
from repro.core import cabac as jcabac
from repro.core import rate_model as jrate
from repro.core import uniform as juniform
from repro.core.backend import QuantSpec as JQuantSpec
from repro.core.backend import get_backend as jget_backend
from repro.core.stats import RunningStats as JRunningStats
from repro.core.tiling import TileECSQ as JTileECSQ
from repro.core.tiling import TilePlan as JTilePlan
from repro_torch.core import CodecConfig, calibrate
from repro_torch.core import cabac as tcabac
from repro_torch.core import rate_model as trate
from repro_torch.core import uniform as tuniform
from repro_torch.core.backend import QuantSpec, get_backend
from repro_torch.core.stats import RunningStats
from repro_torch.core.tiling import TileECSQ, TilePlan

JNP = jget_backend("jnp")
TORCH = get_backend("torch")


def _ulps32(a, b) -> int:
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    sp = np.spacing(np.maximum(np.abs(a), np.abs(b)))
    return int(np.max(np.abs(a - b) / sp, initial=0.0))


def test_import_isolation():
    """Importing every port module loads neither jax nor the reference."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import repro_torch
        for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
            importlib.import_module(m.name)
        bad = sorted(k for k in sys.modules
                     if k == "jax" or k.startswith("jax.")
                     or k == "repro" or k.startswith("repro."))
        print("LEAKS", bad)
        assert not bad
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_default_backend_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        get_backend()
    with pytest.raises(RuntimeError, match="CUDA"):
        calibrate(CodecConfig(clip_mode="manual")).backend
    assert get_backend("torch").device.type == "cpu"


# -- copied host coders --------------------------------------------------------

@pytest.mark.parametrize("mode", ["serial", "rans", "rans_sharded"])
@pytest.mark.parametrize("n_levels", [2, 4, 7, 64])
def test_entropy_payloads_identical(mode, n_levels):
    rng = np.random.default_rng(n_levels)
    idx = np.minimum(rng.geometric(0.4, 3000) - 1, n_levels - 1) \
        .astype(np.int32)
    if mode == "rans_sharded":
        want = jcabac._encode_rans_sharded(idx, n_levels, 3)
        got = tcabac._encode_rans_sharded(idx, n_levels, 3)
    else:
        want = jcabac.encode_indices(idx, n_levels, mode=mode)
        got = tcabac.encode_indices(idx, n_levels, mode=mode)
    assert got == want
    assert np.array_equal(tcabac.decode_indices(want, idx.size, n_levels),
                          idx)


def test_batched_entropy_matches_reference():
    rng = np.random.default_rng(5)
    segs = [rng.integers(0, 4, n).astype(np.int32)
            for n in (70000, 70000, 100)]
    want = jcabac.encode_indices_batch(segs, 4)
    assert tcabac.encode_indices_batch(segs, 4) == want
    dec = tcabac.decode_indices_batch(want, [s.size for s in segs], 4)
    assert all(np.array_equal(d, s) for d, s in zip(dec, segs))


# -- uniform quantizer, rate model, stats ----------------------------------------

@pytest.mark.parametrize("n_levels", [2, 3, 4, 16, 255])
def test_uniform_matches_reference(n_levels):
    x = np.random.default_rng(n_levels).normal(0, 3, 5000) \
        .astype(np.float32)
    cmin, cmax = -2.25, 4.1
    jq = np.asarray(juniform.quantize(jnp.asarray(x), cmin, cmax, n_levels))
    tq = tuniform.quantize(torch.from_numpy(x), cmin, cmax, n_levels)
    assert np.array_equal(tq.numpy(), jq)
    jd = juniform.dequantize(jnp.asarray(jq), cmin, cmax, n_levels)
    td = tuniform.dequantize(tq, cmin, cmax, n_levels)
    assert _ulps32(td.numpy(), jd) <= 1


@pytest.mark.parametrize("n_levels", [2, 4, 16, 64])
def test_rate_model_matches_reference(n_levels):
    rng = np.random.default_rng(n_levels)
    idx = np.minimum(rng.geometric(0.35, 20000) - 1, n_levels - 1) \
        .astype(np.int32)
    jh = np.asarray(jrate.index_histogram(jnp.asarray(idx), n_levels))
    th = trate.index_histogram(torch.from_numpy(idx), n_levels)
    assert np.array_equal(th.numpy(), jh)
    want = float(jrate.estimated_bits_from_hist(jnp.asarray(jh), n_levels))
    got = float(trate.estimated_bits_from_hist(th, n_levels))
    assert got == pytest.approx(want, rel=1e-5)
    hists = rng.integers(0, 50, (3, 2, n_levels)).astype(np.int32)
    jt = np.asarray(jrate.estimated_bits_from_tile_hists(
        jnp.asarray(hists), n_levels, per_tile=True))
    tt = trate.estimated_bits_from_tile_hists(torch.from_numpy(hists),
                                              n_levels, per_tile=True)
    np.testing.assert_allclose(tt.numpy(), jt, rtol=1e-5)


def test_running_stats_identical():
    x = np.random.default_rng(1).normal(size=(7, 300))
    a, b = JRunningStats(), RunningStats()
    for row in x:
        a.update(row)
        b.update(row)
    assert (a.mean, a.var) == (b.mean, b.var)


@pytest.mark.parametrize("mode", ["model", "empirical", "aciq", "minmax"])
@pytest.mark.parametrize("n_levels", [2, 4, 8])
def test_calibration_identical(mode, n_levels):
    x = np.maximum(np.random.default_rng(n_levels).normal(0.3, 1.0, 4000),
                   0).astype(np.float32) - 0.05
    j = jcalibrate(JCodecConfig(n_levels=n_levels, clip_mode=mode), x)
    t = calibrate(CodecConfig(n_levels=n_levels, clip_mode=mode,
                              backend="torch"), x)
    assert (t.cmin, t.cmax) == (j.cmin, j.cmax)


def test_calibration_degenerate_inputs_still_raise():
    with pytest.raises(ValueError, match="empty"):
        calibrate(CodecConfig(clip_mode="minmax"), np.zeros(0, np.float32))
    with pytest.raises(ValueError, match="non-finite"):
        calibrate(CodecConfig(clip_mode="minmax"),
                  np.array([1.0, np.nan], np.float32))


def test_ecsq_design_identical():
    x = np.random.default_rng(2).exponential(1.0, 5000).astype(np.float32)
    cfg = dict(n_levels=4, clip_mode="empirical", use_ecsq=True)
    j = jcalibrate(JCodecConfig(**cfg), x)
    t = calibrate(CodecConfig(backend="torch", **cfg), x)
    np.testing.assert_array_equal(t.ecsq.levels, j.ecsq.levels)
    np.testing.assert_array_equal(t.ecsq.thresholds, j.ecsq.thresholds)


# -- backend seam -------------------------------------------------------------------

def _plans(shape):
    """(reference plan, port plan) pairs over ``shape`` (channel axis 1)."""
    c, m = shape[1], int(np.prod(shape)) // shape[1]
    kw = [dict(channel_group_size=1, spatial_block_size=0, n_channels=c),
          dict(channel_group_size=2, spatial_block_size=7, n_channels=c,
               spatial_extent=m),
          dict(channel_group_size=2, spatial_block_size=0, n_channels=c,
               spatial_extent=m, spatial_hw=(shape[0] * shape[2], shape[3]),
               spatial_block_hw=(4, 3))]
    return [(JTilePlan(channel_axis=1, **k), TilePlan(channel_axis=1, **k))
            for k in kw]


@pytest.mark.parametrize("plan_i", [0, 1, 2])
@pytest.mark.parametrize("n_levels", [2, 5, 16, 256])
def test_tiled_quantize_matches_jnp(plan_i, n_levels):
    shape = (2, 6, 11, 9)
    rng = np.random.default_rng([plan_i, n_levels])
    x = rng.normal(1.0, 2.0, shape).astype(np.float32)
    jplan, tplan = _plans(shape)[plan_i]
    lo = rng.uniform(-2, 0, (tplan.n_cgroups, tplan.n_sblocks)) \
        .astype(np.float32)
    hi = (lo + rng.uniform(0.5, 5, lo.shape)).astype(np.float32)
    hi[0, 0] = lo[0, 0]                   # degenerate tile
    jspec = JQuantSpec(lo, hi, n_levels, 1, None, jplan)
    tspec = QuantSpec(lo, hi, n_levels, 1, None, tplan)
    ji, jd = JNP.quantize_dequantize(jnp.asarray(x), jspec)
    ti, td = TORCH.quantize_dequantize(torch.from_numpy(x), tspec)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert _ulps32(td.numpy(), jd) <= 1
    assert _ulps32(TORCH.dequantize(ti, tspec).numpy(),
                   JNP.dequantize(ji, jspec)) <= 1
    assert np.array_equal(TORCH.tile_histogram(ti, tspec).numpy(),
                          np.asarray(JNP.tile_histogram(ji, jspec)))
    jc, jh = JNP.encode_fused(jnp.asarray(x), jspec, 8, want_hist=True)
    tc, th = TORCH.encode_fused(torch.from_numpy(x), tspec, 8,
                                want_hist=True)
    assert np.array_equal(tc, jc) and np.array_equal(th, jh)


def test_tiled_ecsq_matches_jnp():
    shape = (1, 6, 11, 9)
    rng = np.random.default_rng(9)
    x = rng.exponential(1.0, shape).astype(np.float32)
    jplan, tplan = _plans(shape)[2]
    lo = np.zeros((tplan.n_cgroups, tplan.n_sblocks), np.float32)
    hi = np.full_like(lo, 3.0)
    lv = np.sort(rng.uniform(0, 3, (tplan.n_tiles, 4)), 1).astype(np.float32)
    thr = ((lv[:, 1:] + lv[:, :-1]) / 2).astype(np.float32)
    jspec = JQuantSpec(lo, hi, 4, 1, JTileECSQ(lv, thr), jplan)
    tspec = QuantSpec(lo, hi, 4, 1, TileECSQ(lv, thr), tplan)
    ji, jd = JNP.quantize_dequantize(jnp.asarray(x), jspec)
    ti, td = TORCH.quantize_dequantize(torch.from_numpy(x), tspec)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert np.array_equal(td.numpy(), np.asarray(jd))


def test_roadmap_divide_case_pinned_at_195():
    """N=256, x=3.8885908, range [-1.131127, 5.449994]: a reciprocal
    multiply in place of the divide gives 194; the reference gives 195."""
    x = np.array([[3.8885908]], np.float32)
    lo = np.array([-1.131127], np.float32)
    hi = np.array([5.449994], np.float32)
    jidx = JNP.quantize(jnp.asarray(x), JQuantSpec(lo, hi, 256, 1))
    tidx = TORCH.quantize(torch.from_numpy(x), QuantSpec(lo, hi, 256, 1))
    assert int(np.asarray(jidx)[0, 0]) == 195
    assert int(tidx[0, 0]) == 195
    # the megakernel's plain formula (the kernel itself stops at N=64)
    from repro_torch.kernels.fused_clip_quant import quantize_rows
    q = quantize_rows(torch.from_numpy(x), torch.from_numpy(lo)[:, None],
                      torch.from_numpy(hi)[:, None], 256)
    assert int(q[0, 0]) == 195


def test_per_tensor_ecsq_and_pack_match_jnp():
    x = np.random.default_rng(4).exponential(1.0, 999).astype(np.float32)
    from repro.core.ecsq import ECSQQuantizer as JQ
    from repro_torch.core.ecsq import ECSQQuantizer as TQ
    lv = np.array([0.0, 0.7, 1.9, 4.0], np.float32)
    jspec = JQuantSpec(0.0, 4.0, 4, None, JQ.from_levels(lv))
    tspec = QuantSpec(0.0, 4.0, 4, None, TQ.from_levels(lv))
    ji, jd = JNP.quantize_dequantize(jnp.asarray(x), jspec)
    ti, td = TORCH.quantize_dequantize(torch.from_numpy(x), tspec)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert np.array_equal(td.numpy(), np.asarray(jd))
    for bits in (1, 2, 4, 3):
        want = np.asarray(JNP.pack_indices(ji % (1 << bits), bits))
        got = TORCH.pack_indices(ti % (1 << bits), bits).numpy()
        assert np.array_equal(got, want)


def test_torch_backend_refuses_other_devices():
    with pytest.raises(ValueError, match="CPU"):
        TORCH.quantize(torch.zeros(4, device="meta"),
                       QuantSpec(0.0, 1.0, 4))
