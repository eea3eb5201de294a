"""The decode-attention kernel's rules, on the CPU (the kernel itself runs
only on the card: ``tests/test_torch_cuda.py``).

* The valid-prefix rule the kernel rests on: attention over the first
  ``min(pos + 1, S_cache)`` slots equals the masked attention over the
  whole cache, for linear and ring caches, soft cap on and off.  Inputs
  are float32, so the plain path's rounding of the probabilities to the
  value dtype is exact; the two sides differ only in the order of their
  sums (default float32 tolerances).
* The routing rule: on the CPU, with a quantized or float32 cache or at a
  head size the kernel is not built for, the plain path runs and nothing
  launches.
* The wrapper's argument checks, which raise before anything launches.
* The split plan the wrapper hands the kernel.
"""

import dataclasses

import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.kernels import _build
from repro_torch.kernels import decode_attention as DA
from repro_torch.models import decode_step, init_cache, init_params
from repro_torch.models import layers as L

# (name, S_cache, window, positions): a linear cache, and a ring of S <=
# window slots before and after it wraps
CACHES = [("linear", 64, None, (0, 1, 17, 63)),
          ("ring", 16, 16, (0, 5, 15, 16, 40)),
          ("ring-short", 16, 24, (3, 15, 16, 33))]


def _qkv(b, s, h, kh, hd, seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((b, 1, h, hd), generator=g).to(dtype)
    k = torch.randn((b, s, kh, hd), generator=g).to(dtype)
    v = torch.randn((b, s, kh, hd), generator=g).to(dtype)
    return q, k, v


def _masked(q, k, v, pos, window, softcap):
    """The plain decode path over the whole cache (``_attention``)."""
    s = k.shape[1]
    idx = torch.arange(s, dtype=torch.int32)
    k_pos = pos - (pos - idx) % s if window else idx
    return L.multi_head_attention(q, k, v, q_offset=pos, k_positions=k_pos,
                                  window=window, softcap=softcap)


@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("name,s,window,positions", CACHES)
def test_valid_prefix_equals_the_masked_cache(name, s, window, positions,
                                              softcap):
    q, k, v = _qkv(3, s, 8, 2, 32, seed=s)
    for pos in positions:
        n_valid = min(pos + 1, s)
        want = _masked(q, k, v, pos, window, softcap)
        prefix = L.multi_head_attention(q, k[:, :n_valid], v[:, :n_valid],
                                        q_offset=n_valid - 1,
                                        softcap=softcap)
        torch.testing.assert_close(prefix, want)
        torch.testing.assert_close(
            DA.decode_attention(q[:, 0], k, v, n_valid, softcap), want)


def _step_launches(cfg):
    """Kernel launches of one CPU decode step of ``cfg`` at position 5."""
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    cache = init_cache(cfg, 2, 16, device="cpu")
    tok = torch.tensor([[3], [7]], dtype=torch.int32)
    _build.reset_launches()
    logits, _ = decode_step(cfg, params, tok, cache, 5)[:2]
    assert torch.isfinite(logits.to(torch.float32)).all()
    return _build.LAUNCHES["decode_attention"]


BASE = dataclasses.replace(reduced(get_config("codeqwen1.5-7b"), layers=2),
                           dtype="bfloat16")
ROUTES = {
    "cpu-hd128": dataclasses.replace(BASE, head_dim=128),
    "kv-quant-hd128": dataclasses.replace(BASE, head_dim=128,
                                          kv_quant_bits=8),
    "float32-hd128": dataclasses.replace(BASE, head_dim=128,
                                         dtype="float32"),
    "hd16": BASE,
}


@pytest.mark.parametrize("name", list(ROUTES))
def test_routing_keeps_the_plain_path_off_the_card(name):
    cfg = ROUTES[name]
    assert _step_launches(cfg) == 0
    cache = init_cache(cfg, 2, 16, device="cpu")[0][0]["k"]
    q = torch.zeros((2, 1, cfg.num_heads, cfg.head_dim),
                    dtype=getattr(torch, cfg.dtype))
    assert not DA.takes(q, cache)            # the CPU never launches
    assert DA.fits(q.dtype, cache.dtype, cfg.num_heads, cfg.num_kv_heads,
                   cfg.head_dim) == (name == "cpu-hd128")


@pytest.mark.parametrize("dtype,cache_dtype,h,kh,hd,want", [
    (torch.bfloat16, torch.bfloat16, 32, 4, 128, True),
    (torch.float16, torch.float16, 48, 8, 128, False),    # fp16 cache
    (torch.float32, torch.float32, 16, 8, 256, False),    # float32 cache
    (torch.bfloat16, torch.bfloat16, 8, 8, 64, True),
    (torch.bfloat16, torch.uint8, 32, 4, 128, False),     # quantized cache
    (torch.bfloat16, torch.float32, 32, 4, 128, False),   # mixed dtypes
    (torch.bfloat16, torch.bfloat16, 32, 4, 96, False),   # head size
    (torch.bfloat16, torch.bfloat16, 64, 2, 128, False),  # G = 32 > 16
    (torch.bfloat16, torch.bfloat16, 12, 5, 128, False),  # K does not divide H
])
def test_fits(dtype, cache_dtype, h, kh, hd, want):
    assert DA.fits(dtype, cache_dtype, h, kh, hd) is want


def _bad_args():
    q, k, v = _qkv(2, 16, 8, 2, 64)
    q = q[:, 0]
    return {
        "q-not-contiguous": (q.transpose(0, 1).contiguous().transpose(0, 1),
                             k, v, 4, ValueError),
        "k-not-contiguous": (q, k.transpose(1, 2).contiguous().transpose(1, 2),
                             v, 4, ValueError),
        "q-rank": (q[:, None], k, v, 4, ValueError),
        "v-shape": (q, k, v[:, :8], 4, ValueError),
        "batch": (q[:1].contiguous(), k, v, 4, ValueError),
        "head-dim": (q[..., :32].contiguous(), k, v, 4, ValueError),
        "heads": (q[:, :7].contiguous(), k, v, 4, ValueError),
        "dtype": (q.to(torch.bfloat16), k, v, 4, TypeError),
        "n-valid-zero": (q, k, v, 0, ValueError),
        "n-valid-past-cache": (q, k, v, 17, ValueError),
    }


@pytest.mark.parametrize("case", list(_bad_args()))
def test_wrapper_refuses_bad_arguments(case):
    q, k, v, n_valid, err = _bad_args()[case]
    before = dict(_build.LAUNCHES)
    with pytest.raises(err):
        DA.decode_attention(q, k, v, n_valid)
    assert _build.LAUNCHES == before


@pytest.mark.parametrize("bk,n_valid,hd,sms,want", [
    (192, 2151, 128, 132, (256, 9)),    # the benchmark cell at pos 2150
    (192, 1, 128, 132, (64, 1)),
    (4, 8192, 128, 132, (64, 128)),     # one row: short splits fill the card
    (384, 4096, 128, 132, (768, 6)),    # dbrx's stage, 48 rows x 8 heads
    (16, 512, 256, 132, (32, 16)),
    (192, 8192, 64, 132, (768, 11)),
])
def test_split_plan(bk, n_valid, hd, sms, want):
    split_len, n_splits = DA.split_plan(bk, n_valid, hd, sms)
    assert (split_len, n_splits) == want
    assert split_len % DA.tile_slots(hd) == 0
    assert (n_splits - 1) * split_len < n_valid <= n_splits * split_len
