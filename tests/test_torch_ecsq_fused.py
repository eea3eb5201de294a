"""Port vs reference: the per-tensor ECSQ quantizer's (#7) index-only,
counting and packing variants, the codec rate paths that take them, and
a packed ECSQ split step.

Inputs are made with numpy from a seed, about a tenth of them outside the
clip range.  The reference runs its Pallas kernels in interpret mode, as
a chain: ``ecsq_assign_2d`` (through ``ops.ecsq_quantize``), then
``index_histogram_2d`` (``ops.index_histogram``) and ``pack_rows_2d``
(``ops.pack_indices``).  The port takes the plain torch version of each
variant (CPU tensors), the counting and packing variants one call.
Cases: N in {2, 4, 16, 64}, packing at 1/2/4 bits with N <= 2^bits,
float32 and bfloat16, sizes 1, 7, 4,095, 4,097 and 65,539.  Tolerances:
indices, bins, bytes and reconstructions exact.  The codecs' rates equal
the port's two-pass rate (quantize, then ``rate_from_indices``) exactly
and the reference's within rel 1e-5 (torch and jnp take log2 and the sum
in their own ways).  The split step's payloads equal the reference split
runtime's byte for byte.
"""

import dataclasses
import functools
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import CodecConfig as JCodecConfig
from repro.core import calibrate as jcalibrate
from repro.kernels import ops as jops
from repro_torch.compression import split_runtime
from repro_torch.core import CodecConfig, calibrate
from repro_torch.core.backend import get_backend
from repro_torch.kernels import _build
from repro_torch.kernels import ecsq_assign as ea
from repro_torch.models import split_params_from_numpy
from test_torch_compression import (RecordingCodec, _cfg, _samples,
                                    _tree)

LEVELS = (2, 4, 16, 64)
PACKS = [(bits, n) for bits in (1, 2, 4) for n in LEVELS if n <= 1 << bits]
SIZES = (1, 7, 4095, 4097, 65539)
DTYPES = {"float32": (np.float32, torch.float32),
          "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16)}
CLIP = (-1.75, 2.25)


def _x(n, dtype):
    rng = np.random.default_rng([18, n])
    x = (rng.standard_normal(n) * 1.2 + 0.2).astype(np.float32)
    return x.astype(DTYPES[dtype][0])


def _tables(n_levels):
    """Sorted float32 (thresholds (N-1,), levels (N,)) in the clip range,
    levels pinned to its ends."""
    rng = np.random.default_rng([19, n_levels])
    lo, hi = CLIP
    u = np.sort(rng.uniform(0, 1, n_levels - 2))
    levels = np.concatenate([[lo], lo + (hi - lo) * u, [hi]])
    thresholds = (levels[1:] + levels[:-1]) / 2
    return thresholds.astype(np.float32), levels.astype(np.float32)


def _tx(x):
    t = torch.from_numpy(np.asarray(x, np.float32))
    return t.to(torch.bfloat16) if x.dtype == ml_dtypes.bfloat16 else t


@functools.lru_cache(maxsize=None)
def _reference(n, n_levels, dtype):
    """The reference chain, interpreted: (indices, reconstruction as
    float32, histogram)."""
    thr, lvl = _tables(n_levels)
    jidx, jdeq = jops.ecsq_quantize(jnp.asarray(_x(n, dtype)),
                                    jnp.asarray(thr), jnp.asarray(lvl),
                                    cmin=CLIP[0], cmax=CLIP[1],
                                    interpret=True)
    jhist = jops.index_histogram(jidx, n_levels=n_levels, interpret=True)
    return (np.asarray(jidx), np.asarray(jdeq, np.float32),
            np.asarray(jhist))


def _port_tables(n_levels):
    return tuple(torch.from_numpy(t) for t in _tables(n_levels))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n_levels", LEVELS)
@pytest.mark.parametrize("n", SIZES)
def test_ecsq_variants_match_interpret(n, n_levels, dtype):
    """Indices and reconstruction, indices alone, and either with the
    histogram: the reference's indices, reconstruction and bins."""
    jidx, jdeq, jhist = _reference(n, n_levels, dtype)
    thr, lvl = _port_tables(n_levels)
    x = _tx(_x(n, dtype))
    idx, deq = ea.ecsq_assign(x, thr, lvl, *CLIP)
    assert idx.dtype == torch.int32 and deq.dtype == x.dtype
    assert np.array_equal(idx.numpy(), jidx)
    assert np.array_equal(deq.float().numpy(), jdeq)
    idx2, none = ea.ecsq_assign(x, thr, lvl, *CLIP, want_deq=False)
    assert none is None and torch.equal(idx2, idx)
    for want_deq in (True, False):
        i3, d3, hist = ea.ecsq_assign(x, thr, lvl, *CLIP, want_deq=want_deq,
                                      want_hist=True)
        assert torch.equal(i3, idx)
        assert (d3 is None) == (not want_deq)
        if want_deq:
            assert torch.equal(d3, deq)
        assert hist.dtype == torch.int32 and hist.shape == (n_levels,)
        assert np.array_equal(hist.numpy(), jhist)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("bits,n_levels", PACKS)
@pytest.mark.parametrize("n", SIZES)
def test_ecsq_pack_matches_interpret(n, bits, n_levels, dtype):
    """The packing variant: the bytes of the reference's interpreted pack
    of its indices, and its bins."""
    jidx, _, jhist = _reference(n, n_levels, dtype)
    want = np.asarray(jops.pack_indices(jnp.asarray(jidx), bits=bits,
                                        interpret=True))
    thr, lvl = _port_tables(n_levels)
    packed, hist = ea.ecsq_assign_pack(_tx(_x(n, dtype)), thr, lvl, *CLIP,
                                       bits)
    assert packed.dtype == torch.uint8 and packed.shape == want.shape
    assert np.array_equal(packed.numpy(), want)
    assert np.array_equal(hist.numpy(), jhist)


def test_ecsq_pack_refuses_what_does_not_fit():
    thr, lvl = _port_tables(16)
    x = torch.zeros(8)
    for bits in (0, 3, 8):
        with pytest.raises(ValueError, match="1/2/4"):
            ea.ecsq_assign_pack(x, thr, lvl, *CLIP, bits)
    for bits in (1, 2):
        with pytest.raises(ValueError, match="does not fit"):
            ea.ecsq_assign_pack(x, thr, lvl, *CLIP, bits)
    with pytest.raises(ValueError, match="thresholds for"):
        ea.ecsq_assign(x, thr[:3], lvl, *CLIP, want_hist=True)
    with pytest.raises(ValueError, match="device"):
        ea.ecsq_assign_pack(torch.zeros(8, device="meta"), thr, lvl, *CLIP,
                            4)
    packed, hist = ea.ecsq_assign_pack(torch.zeros(0), thr, lvl, *CLIP, 4)
    assert packed.shape == (0,) and hist.tolist() == [0] * 16


def test_cpu_launch_counts_stay_zero():
    _build.reset_launches()
    thr, lvl = _port_tables(4)
    x = _tx(_x(4097, "bfloat16"))
    ea.ecsq_assign(x, thr, lvl, *CLIP, want_deq=False, want_hist=True)
    ea.ecsq_assign_pack(x, thr, lvl, *CLIP, 2)
    assert all(v == 0 for v in _build.LAUNCHES.values())


# -- the codec ---------------------------------------------------------------------

def _codec_pair(n_levels, samples):
    """(reference codec, port codec on the torch backend): per-tensor ECSQ
    designed from the same samples."""
    kw = dict(n_levels=n_levels, use_ecsq=True, clip_mode="empirical",
              constrain_cmin_zero=False)
    return (jcalibrate(JCodecConfig(**kw), samples),
            calibrate(CodecConfig(backend="torch", **kw), samples))


@pytest.mark.parametrize("n_levels", LEVELS)
def test_codec_rates_match_reference(n_levels):
    """``quantize_with_rate``, ``apply_with_rate`` and, at a 1/2/4-bit
    width, ``quantize_packed_with_counts`` of a per-tensor ECSQ codec count
    in the quantizer's pass: the reference's indices, reconstruction,
    bins and bytes; the rate equal to ``rate_from_indices`` exactly and to
    the reference's within rel 1e-5."""
    rng = np.random.default_rng([20, n_levels])
    x = (rng.standard_normal((4, 6, 128)) * 1.5).astype(np.float32)
    jc, tc = _codec_pair(n_levels, x.ravel())
    assert np.array_equal(tc.ecsq.thresholds, jc.ecsq.thresholds)
    assert np.array_equal(tc.ecsq.levels, jc.ecsq.levels)
    tx = torch.from_numpy(x)
    jidx = jc.quantize(jnp.asarray(x))
    idx, deq, hist = tc.backend.quantize_with_histogram(tx, tc.spec(),
                                                        want_deq=True)
    assert np.array_equal(idx.numpy(), np.asarray(jidx))
    assert np.array_equal(deq.numpy(), np.asarray(jc.apply(jnp.asarray(x))))
    assert hist is not None
    assert np.array_equal(hist.numpy(), np.asarray(
        get_backend("torch").histogram(idx, n_levels)))
    two_pass = float(tc.rate_from_indices(tc.quantize(tx), x.shape))
    jrate = float(jc.rate_from_indices(jidx, x.shape))
    _, none, rate = tc.quantize_with_rate(tx)
    d2, rate2 = tc.apply_with_rate(tx)
    assert none is None and torch.equal(d2, deq)
    assert float(rate) == float(rate2) == two_pass
    assert float(rate) == pytest.approx(jrate, rel=1e-5)
    assert tc.packs_in_quantizer() == (n_levels <= 16)
    if n_levels <= 16:
        packed, counts = tc.quantize_packed_with_counts(tx)
        rate3 = tc.rate_from_counts(counts, x.shape)
        assert np.array_equal(packed.numpy(),
                              np.asarray(jc.pack(jidx.reshape(-1))))
        assert float(rate3) == two_pass


# -- the packed split runtime -----------------------------------------------------

LAYERS, VOCAB, BATCH, MAX_SEQ, STEPS = 4, 64, 4, 16, 3
ECSQ_KW = dict(n_levels=4, use_ecsq=True, clip_mode="empirical",
               constrain_cmin_zero=False)

_SCRIPT = textwrap.dedent("""
    import ast
    import dataclasses
    import os
    import sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import numpy as np
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType
    from repro.compression import split_runtime as SR
    from repro.configs import get_config, reduced
    from repro.core import CodecConfig, calibrate
    from repro.models import transformer as T

    out_path, spec = sys.argv[1], ast.literal_eval(sys.argv[2])
    mesh = jax.make_mesh((2, 1, 1), ("pod", "data", "model"),
                         axis_types=(AxisType.Auto,) * 3)
    b, v, steps = spec["batch"], spec["vocab"], spec["steps"]
    samples = np.load(spec["samples"])
    cfg = dataclasses.replace(reduced(get_config("codeqwen1.5-7b"),
                                      layers=spec["layers"]), vocab_size=v)
    sp = SR.init_split_params(cfg, jax.random.PRNGKey(0))
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(sp)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        out[f"L{spec['layers']}/params/{key}"] = np.asarray(leaf)
    codec = calibrate(CodecConfig(backend="kernel_interpret",
                                  **spec["codec"]), samples=samples.ravel())

    @jax.jit
    def edge(sp, tok, cache, pos):
        # the reference's own edge stage, outside the shard_map
        x = T._embed_in(cfg, sp, tok[:, None], pos0=pos)
        layers0 = jax.tree.map(lambda a: a[0], sp["stages"])
        return SR._stage_apply(cfg, layers0, x, cache, pos,
                               jnp.full((1,), pos, dtype=jnp.int32), None)

    step = jax.jit(SR.make_split_decode_step(cfg, mesh, codec,
                                             transport="packed"))
    caches = SR.init_split_cache(cfg, b, spec["max_seq"])
    edge_cache = jax.tree.map(lambda a: a[0], caches[0])
    tok = jnp.arange(b, dtype=jnp.int32) * 7 % v
    rec = {"tokens": [], "rate": [], "y": [], "payload": []}
    for pos in range(steps):
        rec["tokens"].append(np.asarray(tok))
        logits, caches, rate = step(sp, tok, caches, jnp.int32(pos))
        rec["rate"].append(np.asarray(rate))
        y, edge_cache = edge(sp, tok, edge_cache, jnp.int32(pos))
        rec["y"].append(np.asarray(y))
        rec["payload"].append(np.asarray(codec.pack(
            codec.quantize(y).reshape(-1))))
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
    for k, vals in rec.items():
        out[f"ecsq/{k}"] = np.stack(vals)
    out["ecsq/thresholds"] = np.asarray(codec.ecsq.thresholds)
    np.savez(out_path, **out)
    print("REFERENCE_SPLIT_OK")
""")


@pytest.fixture(scope="module")
def split_reference(tmp_path_factory):
    """One subprocess run of the reference split runtime with a packed
    per-tensor ECSQ N=4 codec (``tests/test_torch_compression.py`` says
    why a subprocess and an Auto-axis mesh)."""
    tmp = tmp_path_factory.mktemp("split_ecsq")
    np.save(tmp / "samples.npy", _samples())
    path = tmp / "reference.npz"
    spec = dict(layers=LAYERS, vocab=VOCAB, batch=BATCH, max_seq=MAX_SEQ,
                steps=STEPS, samples=str(tmp / "samples.npy"),
                codec=ECSQ_KW)
    out = subprocess.run([sys.executable, "-c", _SCRIPT, str(path),
                          repr(spec)], capture_output=True, text=True,
                         timeout=600)
    assert "REFERENCE_SPLIT_OK" in out.stdout, out.stdout + out.stderr
    return dict(np.load(path))


def test_packed_ecsq_split_step_matches_reference(split_reference):
    """The port's packed split step with the same ECSQ codec and weights:
    the quantizer packs and counts in one pass, each step's payload is
    the reference's bytes (the boundary values agree within 1e-5 and sit
    away from every threshold), and the rate is the two-pass rate and the
    reference's within 1e-6."""
    ref = split_reference
    cfg = _cfg(LAYERS)
    base = calibrate(CodecConfig(backend="torch", **ECSQ_KW),
                     samples=_samples().ravel())
    assert np.array_equal(base.ecsq.thresholds, ref["ecsq/thresholds"])
    codec = RecordingCodec(**{f.name: getattr(base, f.name)
                              for f in dataclasses.fields(base)})
    assert codec.packs_in_quantizer()
    params = split_params_from_numpy(cfg, _tree(ref, f"L{LAYERS}"),
                                     edge_device="cpu", cloud_device="cpu")
    step = split_runtime.make_split_decode_step(
        cfg, codec, transport="packed", edge_device="cpu",
        cloud_device="cpu")
    caches = split_runtime.init_split_cache(
        cfg, BATCH, MAX_SEQ, edge_device="cpu", cloud_device="cpu")
    thr = np.asarray(ref["ecsq/thresholds"], np.float64)
    for pos in range(STEPS):
        _, caches, rate = step(params, torch.from_numpy(
            ref["ecsq/tokens"][pos]), caches, pos)
        sent = codec.sent[pos]
        assert sent["fused"]
        y_ref = ref["ecsq/y"][pos]
        np.testing.assert_allclose(sent["y"], y_ref, rtol=0, atol=1e-5)
        assert np.abs(y_ref.reshape(-1, 1).astype(np.float64)
                      - thr[None, :]).min() > 1e-5
        assert np.array_equal(sent["payload"], ref["ecsq/payload"][pos])
        assert abs(float(rate) - float(ref["ecsq/rate"][pos])) <= 1e-6
        y = torch.from_numpy(sent["y"])
        assert float(rate) == float(codec.rate_from_indices(
            codec.quantize(y), y.shape))
