"""The prefill-attention kernel's rules, on the CPU (the kernel itself runs
only on the card: ``tests/test_torch_cuda.py``).

* The routing rule, case by case: bf16, no window, no soft cap, a head
  size the kernel is built for, at most 16 query heads a KV head, no
  autograd recording, and a CUDA tensor; the CPU never launches.
* A CPU prefill through ``_attention`` is the plain path bit for bit, and
  launches nothing.
* Only a prefill into a cache routes: a pass without a cache (forward,
  ``forward_head``, ``forward_from_boundary``) never asks.
* The wrapper's argument checks, which raise before anything launches,
  and the strides it hands the kernel as they are.
"""

import dataclasses

import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.kernels import _build
from repro_torch.kernels import prefill_attention as PA
from repro_torch.models import (forward, forward_from_boundary, forward_head,
                                init_cache, init_params, prefill)
from repro_torch.models import layers as L
from repro_torch.models import transformer as TF

BF16 = torch.bfloat16


@pytest.mark.parametrize("dtype,h,kh,hd,window,softcap,want", [
    (BF16, 32, 4, 128, None, 0.0, True),       # the benchmark cell
    (BF16, 48, 8, 128, None, 0.0, True),       # dbrx, G = 6
    (BF16, 8, 8, 64, None, 0.0, True),         # G = 1
    (BF16, 64, 4, 128, None, 0.0, True),       # G = 16
    (torch.float32, 32, 4, 128, None, 0.0, False),
    (torch.float16, 32, 4, 128, None, 0.0, False),
    (BF16, 32, 4, 128, 4096, 0.0, False),      # sliding window
    (BF16, 32, 4, 128, None, 50.0, False),     # soft cap
    (BF16, 32, 4, 256, None, 0.0, False),      # head sizes
    (BF16, 32, 4, 96, None, 0.0, False),
    (BF16, 32, 4, 16, None, 0.0, False),
    (BF16, 64, 2, 128, None, 0.0, False),      # G = 32 > 16
    (BF16, 12, 5, 128, None, 0.0, False),      # K does not divide H
])
def test_fits(dtype, h, kh, hd, window, softcap, want):
    assert PA.fits(dtype, h, kh, hd, window, softcap) is want


@pytest.mark.parametrize("grad_mode,requires_grad,want", [
    (True, False, False), (True, True, True), (False, True, False),
    (False, False, False)])
def test_records_grad(grad_mode, requires_grad, want):
    q = torch.zeros((1, 4, 2, 64), requires_grad=requires_grad)
    k = torch.zeros((1, 4, 2, 64))
    with torch.set_grad_enabled(grad_mode):
        assert PA.records_grad(q, k) is want
        with torch.inference_mode():
            assert not PA.records_grad(q, k)


def test_takes_nothing_on_the_cpu():
    q = torch.zeros((1, 8, 32, 128), dtype=BF16)
    k = torch.zeros((1, 8, 4, 128), dtype=BF16)
    assert PA.fits(q.dtype, 32, 4, 128, None, 0.0)
    with torch.inference_mode():
        assert not PA.takes(q, k, None, 0.0)


# a bf16 codeqwen at the kernel's head size, on the CPU
CFG = dataclasses.replace(reduced(get_config("codeqwen1.5-7b"), layers=2),
                          head_dim=64, num_heads=8, num_kv_heads=2,
                          dtype="bfloat16")


def _tokens(b, s, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, CFG.vocab_size, (b, s), generator=g,
                         dtype=torch.int32)


@pytest.mark.parametrize("s", [1, 15, 64])
def test_cpu_prefill_attention_is_the_plain_path(s):
    """``_attention``'s prefill branch on the CPU returns exactly
    ``multi_head_attention(q, k, v, q_offset=0)`` and fills the cache with
    the fresh K and V; the wrapper's CPU path is the same call."""
    params = init_params(CFG, torch.Generator().manual_seed(0), device="cpu")
    p = params["layers"][0]["attn"]
    spec = CFG.layer_specs()[0]
    h = torch.randn((2, s, CFG.d_model), generator=torch.Generator()
                    .manual_seed(s)).to(BF16)
    positions = torch.arange(s, dtype=torch.int32)
    cache = init_cache(CFG, 2, 80, device="cpu")[0][0]
    _build.reset_launches()
    with torch.inference_mode():
        got = TF._attention(h, p, spec, CFG, pos=0, cache=cache,
                            positions=positions)
        q, k, v = L.attention_qkv(h, p, CFG, positions)
        want = L.multi_head_attention(q, k, v, q_offset=0)
        assert torch.equal(PA.prefill_attention(q, k, v), want)
    assert got.dtype == BF16 and torch.equal(got, want)
    assert torch.equal(cache["k"][:, :s], k) and torch.equal(
        cache["v"][:, :s], v)
    assert _build.LAUNCHES["prefill_attention"] == 0


def test_only_a_prefill_into_a_cache_routes(monkeypatch):
    """With the predicate forced true, a prefill into a cache asks it and
    calls the kernel's wrapper once an attention layer; forward,
    ``forward_head`` and ``forward_from_boundary`` (no cache) never ask.
    Nothing launches on the CPU."""
    asked, called = [], []

    def takes(q, k, window, softcap):
        asked.append(q.shape)
        return True

    def wrapper(q, k, v):
        called.append(q.shape)
        return L.multi_head_attention(q, k, v, q_offset=0)

    monkeypatch.setattr(PA, "takes", takes)
    monkeypatch.setattr(PA, "prefill_attention", wrapper)
    cfg = dataclasses.replace(CFG, num_layers=4)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = _tokens(2, 12)
    _build.reset_launches()
    with torch.inference_mode():
        forward(cfg, params, toks)
        x = forward_head(cfg, params, toks, split_after=2)
        forward_from_boundary(cfg, params, x, split_after=2)
        assert asked == [] and called == []
        prefill(cfg, params, toks, init_cache(cfg, 2, 16, device="cpu"))
    n_attn = sum(s.kind == "attn" for s in cfg.layer_specs())
    assert len(asked) == len(called) == n_attn
    assert _build.LAUNCHES["prefill_attention"] == 0


def test_cpu_prefill_launches_nothing():
    """A bf16 prefill and the decode steps after it on the CPU: the plain
    paths, no launch of either attention kernel."""
    from repro_torch.models import decode_step
    params = init_params(CFG, torch.Generator().manual_seed(0), device="cpu")
    cache = init_cache(CFG, 2, 24, device="cpu")
    _build.reset_launches()
    with torch.inference_mode():
        logits, cache = prefill(CFG, params, _tokens(2, 16), cache)
        tok = logits.argmax(-1).to(torch.int32)
        for pos in range(16, 19):
            logits, cache, _ = decode_step(CFG, params, tok, cache, pos)
            tok = logits.argmax(-1).to(torch.int32)
    assert torch.isfinite(logits).all()
    assert _build.LAUNCHES["prefill_attention"] == 0
    assert _build.LAUNCHES["decode_attention"] == 0


def _qkv(b=2, s=16, h=8, kh=2, hd=64, dtype=torch.float32):
    g = torch.Generator().manual_seed(0)
    return tuple(torch.randn((b, s, n, hd), generator=g).to(dtype)
                 for n in (h, kh, kh))


def _bad_args():
    q, k, v = _qkv()
    return {
        "q-rank": (q[0], k, v, ValueError),
        "k-rank": (q, k[0], v, ValueError),
        "v-shape": (q, k, v[:, :8], ValueError),
        "batch": (q[:1], k, v, ValueError),
        "length": (q[:, :8], k, v, ValueError),
        "head-dim": (q[..., :32], k, v, ValueError),
        "heads": (q[:, :, :7], k, v, ValueError),
        "empty": (q[:, :0], k[:, :0], v[:, :0], ValueError),
        "dtype": (q.to(BF16), k, v, TypeError),
        "v-dtype": (q, k, v.to(BF16), TypeError),
    }


@pytest.mark.parametrize("case", list(_bad_args()))
def test_wrapper_refuses_bad_arguments(case):
    q, k, v, err = _bad_args()[case]
    before = dict(_build.LAUNCHES)
    with pytest.raises(err):
        PA.prefill_attention(q, k, v)
    assert _build.LAUNCHES == before


def _strided(kind):
    """A (2, 16, 2, 64) bf16 tensor laid out as ``kind``."""
    base = torch.randn((2, 2, 16, 64)).to(BF16)
    return {"contiguous": base.transpose(1, 2).contiguous(),
            "heads-outer": base.transpose(1, 2),
            "sliced-heads": torch.randn((2, 16, 4, 64)).to(BF16)[:, :, 1:3],
            "inner-stride": torch.randn((2, 16, 2, 128)).to(BF16)[..., ::2],
            "odd-row": torch.randn((2, 16, 2 * 64 + 1)).to(BF16)
            [..., :128].unflatten(-1, (2, 64))}[kind]


@pytest.mark.parametrize("kind,in_place", [
    ("contiguous", True), ("heads-outer", True), ("sliced-heads", True),
    ("inner-stride", False), ("odd-row", False)])
def test_kernel_view_keeps_aligned_strides(kind, in_place):
    """The wrapper hands the kernel a tensor as it lies where its last
    dimension is contiguous and every other stride is a multiple of 16
    bytes (a permuted or sliced v), else a contiguous copy."""
    t = _strided(kind)
    got = PA.kernel_view(t)
    assert torch.equal(got, t)
    assert (got.data_ptr() == t.data_ptr()) is in_place
    assert got.stride(-1) == 1 and all(st % 8 == 0
                                       for st in got.stride()[:-1])
