"""Port vs reference: the wire bit-pack (kernel #9's plain version, the
``ops.pack_indices`` wrapper, the backends' ``pack_indices`` and the
codec's pack/unpack).

The reference's pack runs its Pallas kernel in interpret mode.  Inputs
come from numpy with a seed; every comparison is exact (bytes and
indices are integers).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import CodecConfig as JCodecConfig
from repro.core import calibrate as jcalibrate
from repro.core.backend import JnpBackend
from repro.kernels import ops as jops
from repro_torch.core import CodecConfig, calibrate
from repro_torch.core.backend import get_backend
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
