"""Port vs reference: the wire bit-pack (kernel #9's plain version, the
``ops.pack_indices`` wrapper, the backends' ``pack_indices`` and the
codec's pack/unpack), and the per-tensor quantizer that packs its own
indices (kernel #1's packing variant: ``fused_clip_quant.clip_quant_pack``,
the backends' ``quantize_packed_with_histogram`` and the codec's
``quantize_packed_with_counts``).

The reference's quantizer and pack run their Pallas kernels in interpret
mode.  Inputs come from numpy with a seed; bytes, indices and bins are
compared exactly; the estimated rate equals the port's two-pass rate
exactly and the reference's within rel 1e-5 (torch and jnp take log2
and the sum in their own ways).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import CodecConfig as JCodecConfig
from repro.core import calibrate as jcalibrate
from repro.core.backend import JnpBackend
from repro.core.backend import get_backend as jget_backend
from repro.kernels import ops as jops
from repro_torch.core import CodecConfig, calibrate
from repro_torch.core.backend import get_backend
from repro_torch.kernels import fused_clip_quant as fcq
from repro_torch.kernels import ops
from repro_torch.kernels.pack_bits import pack_bits, pack_bits_plain

SIZES = [1, 7, 13, 4096, 65537]


def _indices(n: int, bits: int, seed: int = 0, lo: int = 0,
             hi: int | None = None) -> np.ndarray:
    rng = np.random.default_rng([seed, n, bits])
    return rng.integers(lo, (1 << bits) if hi is None else hi, n,
                        dtype=np.int32)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("bits", [1, 2, 4])
def test_pack_matches_interpreted_kernel(bits, n):
    idx = _indices(n, bits)
    want = np.asarray(jops.pack_indices(jnp.asarray(idx), bits=bits,
                                        interpret=True))
    assert want.dtype == np.uint8 and want.shape == (-(-n // (8 // bits)),)
    got_plain = pack_bits_plain(torch.from_numpy(idx), bits)
    got_ops = ops.pack_indices(torch.from_numpy(idx.reshape(1, -1)),
                               bits=bits)
    assert got_plain.dtype == got_ops.dtype == torch.uint8
    assert np.array_equal(got_plain.numpy(), want)
    assert np.array_equal(got_ops.numpy(), want)


@pytest.mark.parametrize("bits", [1, 2, 4])
def test_pack_out_of_range_indices_match_interpreted_kernel(bits):
    """Indices outside [0, 2**bits): lanes are summed in int32 and the low
    byte kept, so the bytes still equal the reference kernel's."""
    idx = _indices(999, bits, seed=1, lo=-40, hi=300)
    want = np.asarray(jops.pack_indices(jnp.asarray(idx), bits=bits,
                                        interpret=True))
    assert np.array_equal(pack_bits_plain(torch.from_numpy(idx),
                                          bits).numpy(), want)


@pytest.mark.parametrize("bits", range(1, 9))
def test_torch_backend_pack_matches_jnp_backend(bits):
    idx = _indices(3 * 5 * 7, bits, seed=2).reshape(3, 5, 7)
    want = np.asarray(JnpBackend().pack_indices(jnp.asarray(idx), bits))
    got = get_backend("torch").pack_indices(torch.from_numpy(idx), bits)
    assert got.dtype == torch.uint8
    assert got.shape == want.shape      # per == 1 (3, 5..8 bits) keeps it
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("n_levels", [2, 4, 8, 16, 256])
def test_codec_pack_crosses_packages(n_levels):
    """Port bytes decode with the reference's unpack, and the reverse."""
    kw = dict(n_levels=n_levels, clip_mode="manual", manual_cmin=-1.0,
              manual_cmax=1.0)
    tc = calibrate(CodecConfig(backend="torch", **kw))
    jc = jcalibrate(JCodecConfig(backend="jnp", **kw))
    assert tc.bits_per_index() == jc.bits_per_index()
    idx = _indices(1001, tc.bits_per_index(), seed=3) % n_levels
    t_bytes = tc.pack(torch.from_numpy(idx))
    j_bytes = jc.pack(jnp.asarray(idx))
    assert np.array_equal(t_bytes.numpy(), np.asarray(j_bytes))
    assert np.array_equal(
        np.asarray(jc.unpack(jnp.asarray(t_bytes.numpy()), idx.size)), idx)
    assert np.array_equal(
        tc.unpack(torch.tensor(np.asarray(j_bytes)), idx.size).numpy(),
        idx)


def test_pack_refuses_bad_arguments():
    x = torch.zeros(8, dtype=torch.int32)
    for bits in (0, 3, 8):
        with pytest.raises(ValueError, match="1/2/4"):
            ops.pack_indices(x, bits=bits)
        with pytest.raises(ValueError, match="1/2/4"):
            pack_bits(x, bits)
    with pytest.raises(ValueError, match="device"):
        pack_bits(torch.zeros(8, dtype=torch.int32, device="meta"), 2)
    with pytest.raises(ValueError, match="CPU"):
        get_backend("torch").pack_indices(
            torch.zeros(8, dtype=torch.int32, device="meta"), 2)
    assert pack_bits(torch.zeros(0, dtype=torch.int32), 4).shape == (0,)


# -- the quantizer that packs its own indices ------------------------------------

FUSED_SIZES = [1, 7, 4099, 16384]
CLIP = (-2.0, 2.5)


def _fused_pair(n_levels: int, **kw):
    """(reference codec on the interpreted Pallas kernels, port codec on
    the torch backend), clipping at CLIP unless ``kw`` says otherwise."""
    kw = {"n_levels": n_levels, "clip_mode": "manual",
          "manual_cmin": CLIP[0], "manual_cmax": CLIP[1], **kw}
    return (jcalibrate(JCodecConfig(backend="kernel_interpret", **kw)),
            calibrate(CodecConfig(backend="torch", **kw)))


def _boundary(n: int, seed: int) -> np.ndarray:
    """Seeded float32 values, about a tenth outside the clip range."""
    rng = np.random.default_rng([seed, n])
    return (rng.standard_normal(n) * 1.5 + 0.2).astype(np.float32)


@pytest.mark.parametrize("n", FUSED_SIZES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_levels", [2, 3, 4, 16])
def test_quantize_packed_with_rate_matches_reference(n_levels, dtype, n):
    """Each port path against its counterpart: the kernel wrapper's plain
    version (float32 arithmetic, as the kernels) against the reference's
    interpreted Pallas quantizer and pack; the torch backend, the CPU
    mirror of the reference's jnp backend, against that backend's
    quantizer (which rounds in the input's dtype: on bfloat16 it parts
    from the kernels at bin edges) and the interpreted pack."""
    jc, tc = _fused_pair(n_levels)
    bits = tc.bits_per_index()
    x = _boundary(n, n_levels)
    jx = jnp.asarray(x, dtype=getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jk = jget_backend("kernel_interpret")
    jidx = jk.quantize(jx, jc.spec())
    want = np.asarray(jc.pack(jidx))
    assert want.shape == (-(-n // (8 // bits)),)
    kp, kh = fcq.clip_quant_pack(tx, *CLIP, n_levels, bits)
    assert kp.dtype == torch.uint8 and np.array_equal(kp.numpy(), want)
    assert np.array_equal(kh.numpy(), np.asarray(jk.histogram(jidx,
                                                              n_levels)))
    jidx_jnp = jget_backend("jnp").quantize(jx, jc.spec())
    if dtype == "float32":
        assert np.array_equal(np.asarray(jidx_jnp), np.asarray(jidx))
    assert tc.packs_in_quantizer()
    packed, counts = tc.quantize_packed_with_counts(tx)
    rate = tc.rate_from_counts(counts, tx.shape)
    assert packed.dtype == torch.uint8
    assert np.array_equal(packed.numpy(), np.asarray(jc.pack(jidx_jnp)))
    _, _, two_pass = tc.quantize_with_rate(tx)
    assert float(rate) == float(two_pass)
    jrate = jc.rate_from_indices(jidx_jnp, x.shape)
    assert float(rate) == pytest.approx(float(jrate), rel=1e-5)


def _unpacking_codec(kind: str):
    """A port codec whose quantizer does not pack its indices."""
    x = _boundary(4 * 64, 9).reshape(4, 64)
    kw = {"tensor-8": {"n_levels": 8},               # 3-bit width
          "tensor-65": {"n_levels": 65},             # above 64 bins
          "tensor-256": {"n_levels": 256},           # 8-bit width
          # groups of 3 channels: the per-tile quantizer's element route
          "channel": {"n_levels": 4, "granularity": "channel",
                      "channel_axis": -1, "channel_group_size": 3,
                      "clip_mode": "minmax"},
          # per-tensor ECSQ at 8 levels: a 3-bit width
          "ecsq": {"n_levels": 8, "use_ecsq": True,
                   "clip_mode": "empirical"},
          # per-channel ECSQ (TileECSQ tables)
          "ecsq-channel": {"n_levels": 4, "use_ecsq": True,
                           "granularity": "channel", "channel_axis": -1,
                           "channel_group_size": 8, "clip_mode": "minmax"}
          }[kind]
    samples = x if kind in ("channel", "ecsq-channel") else x.ravel()
    base = {"clip_mode": "manual", "manual_cmin": CLIP[0],
            "manual_cmax": CLIP[1], "constrain_cmin_zero": False}
    return calibrate(CodecConfig(backend="torch", **{**base, **kw}),
                     samples), torch.from_numpy(x)


@pytest.mark.parametrize("kind", ["tensor-8", "tensor-65", "tensor-256",
                                  "channel", "ecsq", "ecsq-channel"])
def test_quantize_packed_refuses_other_codecs(kind):
    codec, x = _unpacking_codec(kind)
    assert not codec.packs_in_quantizer()
    with pytest.raises(ValueError, match="packs per-tensor specs"):
        codec.quantize_packed_with_counts(x)
    with pytest.raises(ValueError, match="packs per-tensor specs"):
        codec.backend.quantize_packed_with_histogram(x, codec.spec(), 2)


def test_clip_quant_pack_refuses_bad_arguments():
    x = torch.zeros(8)
    for bits in (0, 3, 8):
        with pytest.raises(ValueError, match="1/2/4"):
            fcq.clip_quant_pack(x, -1.0, 1.0, 4, bits)
    for n_levels, bits in ((5, 2), (3, 1), (17, 4), (1, 1)):
        with pytest.raises(ValueError, match="does not fit"):
            fcq.clip_quant_pack(x, -1.0, 1.0, n_levels, bits)
    with pytest.raises(ValueError, match="device"):
        fcq.clip_quant_pack(torch.zeros(8, device="meta"), -1.0, 1.0, 4, 2)
    packed, hist = fcq.clip_quant_pack(torch.zeros(0), -1.0, 1.0, 4, 2)
    assert packed.shape == (0,) and hist.tolist() == [0, 0, 0, 0]
