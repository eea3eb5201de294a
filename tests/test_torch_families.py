"""Port vs reference: the MoE, RWKV-6 and RG-LRU layers and the models
built from them, at the default scenarios' reduced sizes (dbrx-132b,
rwkv6-3b and recurrentgemma-2b, d_model 64, float32, on the CPU).

The reference's random parameters are carried over with
``params_from_numpy``; inputs are drawn from seeded numpy generators.

Tolerances, measured on these inputs (largest abs difference):
- MoE routing: expert ids, dispatch slots, kept flags, token order
  exact; router weights and outputs atol/rtol 1e-5 (~1e-6 measured; the
  two libraries sum matrix products and the scatter-add in different
  orders).
- Layers and whole models: rtol 1e-5, atol 1e-5 on outputs, logits
  and boundaries (~1e-6 to 7e-6 measured).  RG-LRU's log-depth scan
  multiplies its decays in another order than ``lax.associative_scan``,
  which stays within the same bound.
- Cache leaves after prefill and three decode steps: rtol 1e-5 and an
  atol of 1e-5 times the leaf's largest magnitude (at least 1).  The
  RWKV state sums a rank-1 update per token and reaches ~4.5 here; its
  largest difference was 1.05e-5, float32 rounding of those sums taken
  in another order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jm
from repro.eval import SCENARIOS as JSCENARIOS
from repro.models import moe as JMOE
from repro.models import rglru as JRG
from repro.models import rwkv6 as JRW
from repro_torch import models as tm
from repro_torch.eval import SCENARIOS
from repro_torch.models import moe as MOE
from repro_torch.models import rglru as RG
from repro_torch.models import rwkv6 as RW
from repro_torch.models.convert import FLOAT32_LEAVES
from repro_torch.serving import Request, ServeEngine

TOL = dict(rtol=1e-5, atol=1e-5)
FAMILIES = {"moe-expert": "dbrx-132b", "rwkv-state": "rwkv6-3b",
            "rglru-state": "recurrentgemma-2b"}


def _cfgs(scenario: str):
    return JSCENARIOS[scenario].model_config(), \
        SCENARIOS[scenario].model_config()


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _tree_t(tree):
    """A reference parameter dict (jax leaves) as float32 tensors."""
    return {k: _tree_t(v) if isinstance(v, dict) else _t(v)
            for k, v in tree.items()}


def _close(port, ref, **tol):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref),
                               **(tol or TOL))


@pytest.fixture(scope="module")
def models():
    """name -> (jcfg, jparams, tcfg, tparams) for the three families."""
    out = {}
    for sc, arch in FAMILIES.items():
        jcfg, tcfg = _cfgs(sc)
        assert repr(jcfg) == repr(tcfg)
        jparams = jm.init_params(jcfg, jax.random.PRNGKey(0))
        out[arch] = (jcfg, jparams, tcfg, tm.params_from_numpy(
            tcfg, jax.tree.map(np.asarray, jparams), device="cpu"))
    return out


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


# -- MoE -----------------------------------------------------------------------

@pytest.fixture(scope="module")
def moe():
    jcfg, tcfg = _cfgs("moe-expert")
    jp = JMOE.init_moe(jax.random.PRNGKey(0), jcfg, jnp.float32)
    x = np.random.default_rng(0).standard_normal(
        (64, jcfg.d_model)).astype(np.float32)
    return jcfg, jp, tcfg, _tree_t(jp), x


@pytest.mark.parametrize("cap", [None, 4])
def test_moe_routing_and_dispatch_match(moe, cap):
    """Same experts, and the same capacity slots, kept flags and token
    order -- cap 4 drops assignments (the default capacity drops none)."""
    jcfg, jp, tcfg, tp, x = moe
    k, e = jcfg.experts_per_token, jcfg.num_experts
    jw, ji = JMOE._route(jnp.asarray(x), jp["router"], k)
    tw, ti = MOE._route(torch.from_numpy(x), tp["router"], k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(tw, jw)
    default = MOE._capacity(x.shape[0], k, e, tcfg.capacity_factor)
    assert default == JMOE._capacity(x.shape[0], k, e, jcfg.capacity_factor)
    cap = cap or default
    ref = JMOE._dispatch_indices(ji, k, e, cap)
    port = MOE._dispatch_indices(ti, k, e, cap)
    for p, r in zip(port, ref):
        np.testing.assert_array_equal(p.numpy(), np.asarray(r))
    assert (not bool(np.asarray(ref[1]).all())) == (cap == 4)


@pytest.mark.parametrize("cap", [None, 4, 128])
def test_moe_local_matches_reference(moe, cap):
    jcfg, jp, tcfg, tp, x = moe
    ref = JMOE.moe_local(jnp.asarray(x), jp, jcfg, cap=cap)
    port = MOE.moe_local(torch.from_numpy(x), tp, tcfg, cap=cap)
    _close(port, ref)


def test_moe_dense_oracle_matches_reference_and_local(moe):
    jcfg, jp, tcfg, tp, x = moe
    dense = MOE._moe_dense_ref(torch.from_numpy(x), tp, tcfg)
    _close(dense, JMOE._moe_dense_ref(jnp.asarray(x), jp, jcfg))
    # drop-free capacity: the dispatch computes the oracle's function
    _close(MOE.moe_local(torch.from_numpy(x), tp, tcfg,
                         cap=x.shape[0] * tcfg.experts_per_token), dense,
           rtol=2e-5, atol=2e-5)


# -- RWKV-6 and RG-LRU layers ----------------------------------------------------

def _layer_case(kind):
    """(reference fn, port fn, jparams, tparams, jcache, tcache) of one
    layer kind, with a nonzero cache drawn from a seeded generator."""
    sc = "rglru-state" if kind == "rglru" else "rwkv-state"
    jcfg, tcfg = _cfgs(sc)
    key = jax.random.PRNGKey(3)
    rng = np.random.default_rng(4)
    b = 2
    if kind == "tmix":
        jp = JRW.init_rwkv(key, jcfg, jnp.float32)
        # a nonzero first-token bonus exercises u
        jp["u"] = jnp.asarray(rng.standard_normal(jp["u"].shape) * 0.5,
                              jnp.float32)
        cache = {"state": rng.standard_normal(
            (b, tcfg.num_heads, tcfg.rwkv_head_dim, tcfg.rwkv_head_dim)),
            "shift": rng.standard_normal((b, tcfg.d_model))}
        jfn = lambda x, p, c: JRW.time_mix_apply(x, p, jcfg, c)  # noqa: E731
        tfn = lambda x, p, c: RW.time_mix_apply(x, p, tcfg, c)  # noqa: E731
    elif kind == "cmix":
        jp = JRW.init_channel_mix(key, jcfg, jnp.float32)
        cache = {"shift": rng.standard_normal((b, tcfg.d_model))}
        jfn = JRW.channel_mix_apply
        tfn = RW.channel_mix_apply
    else:
        jp = JRG.init_rglru(key, jcfg, jnp.float32)
        cache = {"h": rng.standard_normal((b, tcfg.rnn_dim)),
                 "conv": rng.standard_normal(
                     (b, tcfg.conv_width - 1, tcfg.rnn_dim))}
        jfn = lambda x, p, c: JRG.rglru_block_apply(x, p, jcfg, c)  # noqa
        tfn = lambda x, p, c: RG.rglru_block_apply(x, p, tcfg, c)  # noqa
    cache = {k: v.astype(np.float32) for k, v in cache.items()}
    return jfn, tfn, jp, _tree_t(jp), cache, tcfg.d_model


@pytest.mark.parametrize("seq", [20, 1])
@pytest.mark.parametrize("cached", [False, True])
@pytest.mark.parametrize("kind", ["tmix", "cmix", "rglru"])
def test_recurrent_layers_match(kind, cached, seq):
    """Each layer on a sequence (20 steps: one whole chunk of 16 and a
    padded one for RWKV) and on one step, with and without a cache."""
    jfn, tfn, jp, tp, cache, d = _layer_case(kind)
    x = np.random.default_rng(5).standard_normal((2, seq, d)) \
        .astype(np.float32)
    jc = {k: jnp.asarray(v) for k, v in cache.items()} if cached else None
    tc = {k: torch.from_numpy(v.copy()) for k, v in cache.items()} \
        if cached else None
    jout, jnew = jfn(jnp.asarray(x), jp, jc)
    tout, tnew = tfn(torch.from_numpy(x), tp, tc)
    _close(tout, jout)
    assert (tnew is None) == (not cached)
    if cached:
        assert sorted(tnew) == sorted(jnew)
        for name in jnew:
            _close(tnew[name], jnew[name])


def test_rglru_scan_folds_h0_like_reference():
    jfn, tfn, jp, tp, cache, d = _layer_case("rglru")
    x = np.random.default_rng(6).standard_normal((2, 33, d)) \
        .astype(np.float32)
    jh, jlast = JRG.rglru_scan(jnp.asarray(x), jp, jnp.asarray(cache["h"]))
    th, tlast = RG.rglru_scan(torch.from_numpy(x), tp,
                              torch.from_numpy(cache["h"]))
    _close(th, jh)
    _close(tlast, jlast)


# -- whole models ----------------------------------------------------------------

def test_params_keep_the_reference_leaf_dtypes():
    """A bfloat16 config's float32 leaves (router, w0, u, lam) stay
    float32; every other leaf takes the model's dtype."""
    for sc, arch in FAMILIES.items():
        jcfg = dataclasses.replace(JSCENARIOS[sc].model_config(),
                                   dtype="bfloat16")
        tcfg = dataclasses.replace(SCENARIOS[sc].model_config(),
                                   dtype="bfloat16")
        # the reference's leaves as zeros of its shapes and dtypes
        jparams = jax.tree.map(
            lambda a: np.zeros(a.shape, a.dtype),
            jax.eval_shape(lambda: jm.init_params(
                jcfg, jax.random.PRNGKey(0))))
        tparams = tm.params_from_numpy(tcfg, jparams, device="cpu")
        gen = torch.Generator().manual_seed(0)
        fresh = tm.init_params(tcfg, gen, device="cpu")
        layer = jax.tree.map(lambda a: a.dtype,
                             jparams["groups"][0]["layers"][0])
        for block, leaves in tparams["layers"][0].items():
            for name, t in leaves.items():
                want = (torch.float32 if (block, name) in FLOAT32_LEAVES
                        else torch.bfloat16)
                assert t.dtype == want, (arch, block, name)
                assert str(layer[block][name]) == str(want).split(".")[1]
                assert fresh["layers"][0][block][name].dtype == want
                assert tuple(fresh["layers"][0][block][name].shape) == \
                    tuple(t.shape)


@pytest.mark.parametrize("arch", list(FAMILIES.values()))
def test_forward_and_split_halves_match(models, arch):
    jcfg, jparams, tcfg, tparams = models[arch]
    toks = _tokens(tcfg, 2, 24, seed=7)
    jl, _ = jm.forward(jcfg, jparams, jnp.asarray(toks))
    tl, _ = tm.forward(tcfg, tparams, torch.from_numpy(toks))
    _close(tl, jl)
    jx = jm.forward_head(jcfg, jparams, jnp.asarray(toks), split_after=1)
    tx = tm.forward_head(tcfg, tparams, torch.from_numpy(toks),
                         split_after=1)
    _close(tx, jx)
    _close(tm.forward_from_boundary(tcfg, tparams, tx, split_after=1),
           jm.forward_from_boundary(jcfg, jparams, jx, split_after=1))


def _port_layer_caches(tcache, jcache, cfg):
    """(port leaf, reference leaf, name) pairs of every cache leaf: the
    reference stacks a group's periods on a leading axis per pattern
    position, the port keeps one dict per layer in run order."""
    def leaves(t, j, path):
        if isinstance(t, dict):
            for k in t:
                yield from leaves(t[k], j[k], path + (k,))
        else:
            yield t, j, path

    for gi, group in enumerate(tcache):
        for li, layer in enumerate(group):
            p, pos = divmod(li, cfg.period)
            ref = jax.tree.map(lambda a, p=p: a[p], jcache[gi][pos])
            yield from leaves(layer, ref, (gi, li))


@pytest.mark.parametrize("arch", list(FAMILIES.values()))
def test_prefill_then_decode_match(models, arch):
    """Prefill, then three decode steps: logits and every cache leaf."""
    jcfg, jparams, tcfg, tparams = models[arch]
    toks = _tokens(tcfg, 2, 9, seed=8)
    jc = jm.init_cache(jcfg, 2, 16)
    tc = tm.init_cache(tcfg, 2, 16, device="cpu")
    jl, jc = jm.prefill(jcfg, jparams, jnp.asarray(toks), jc)
    tl, tc = tm.prefill(tcfg, tparams, torch.from_numpy(toks), tc)
    _close(tl, jl)
    cur = np.argmax(np.asarray(jl), -1).astype(np.int32)
    for pos in (9, 10, 11):
        jl, jc, _ = jm.decode_step(jcfg, jparams, jnp.asarray(cur), jc,
                                   jnp.int32(pos))
        tl, tc, _ = tm.decode_step(tcfg, tparams, torch.from_numpy(cur),
                                   tc, pos)
        _close(tl, jl)
        cur = np.argmax(np.asarray(jl), -1).astype(np.int32)
    n = 0
    for t, j, path in _port_layer_caches(tc, jc, tcfg):
        assert t.dtype == torch.float32, path
        ref = np.asarray(j, np.float32)
        _close(t.numpy(), ref, rtol=1e-5,
               atol=1e-5 * max(1.0, float(np.abs(ref).max())))
        n += 1
    assert n == sum(len(group) for group in tc) * (
        3 if arch == "rwkv6-3b" else 2)


def test_engine_refills_recurrent_caches(models):
    """The port's engine on the reduced rwkv6 model, two slots and three
    requests (one refill): each request's tokens equal a one-request
    greedy decode of its padded prompt (the prefill the engine ran)."""
    _, _, cfg, params = models["rwkv6-3b"]
    rng = np.random.default_rng(9)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, p)
                    .astype(np.int32), max_new_tokens=n)
            for p, n in ((6, 2), (8, 6), (4, 3))]
    eng = ServeEngine(cfg, params, slots=2, max_seq=24, device="cpu")
    prompts = []
    prefill = eng._prefill

    def recording(p, toks, cache):
        prompts.extend(toks.numpy())
        return prefill(p, toks, cache)

    eng._prefill = recording
    eng.generate(reqs)
    assert eng.counters["refills"] == 1
    # the epoch's two padded prompts, then the refill's
    assert [len(p) for p in prompts] == [8, 8, prompts[2].size]
    for r, prompt in zip(reqs, prompts):
        cache = tm.init_cache(cfg, 1, 24, device="cpu")
        with torch.inference_mode():
            lg, cache = tm.prefill(cfg, params,
                                   torch.from_numpy(prompt[None]), cache)
            want = [int(torch.argmax(lg[0]))]
            for pos in range(prompt.size, prompt.size + r.max_new_tokens
                             - 1):
                lg, cache, _ = tm.decode_step(
                    cfg, params, torch.tensor([want[-1]]), cache, pos)
                want.append(int(torch.argmax(lg[0])))
        assert r.out_tokens == want
