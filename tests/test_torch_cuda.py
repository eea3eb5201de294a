"""Card-only checks of the hand-written CUDA kernels against their plain
torch versions (same module, same inputs).  Marked ``cuda``: they skip
where no CUDA device exists and run on the card with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

This file imports only torch and the port, so it runs where JAX is not
installed.  Tolerances: indices, packed bytes, histograms and rANS blobs
exact; reconstructions within 1 ulp of their dtype.
"""

import pytest
import torch

from repro_torch.core import binarization, rans
from repro_torch.kernels import _build
from repro_torch.kernels import fused_clip_quant as fcq
from repro_torch.kernels import ops, rans_coder, rate_hist

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _x(dev, n, seed=0, dtype=torch.float32):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(n, device=dev, generator=g) * 2 + 0.3).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_levels", [2, 3, 4, 8, 16, 64])
def test_clip_quant_and_histogram(dev, n_levels, dtype):
    x = _x(dev, 70001, dtype=dtype)
    before = dict(_build.LAUNCHES)
    ki, kd = fcq.clip_quant_2d(x, -1.5, 2.75, n_levels)
    pi, pd = fcq.clip_quant_plain(x, -1.5, 2.75, n_levels)
    assert torch.equal(ki, pi)
    assert torch.equal(kd, pd)      # same rounding steps: bit-identical
    assert torch.equal(ops.index_histogram(ki, n_levels=n_levels),
                       rate_hist.index_histogram_plain(ki, n_levels))
    assert _build.LAUNCHES["clip_quant"] == before["clip_quant"] + 1
    assert _build.LAUNCHES["index_histogram"] == \
        before["index_histogram"] + 1


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
