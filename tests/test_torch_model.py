"""Port vs reference: the dense split model on reduced codeqwen1.5-7b.

The reference's random parameters are carried over with
``params_from_numpy``; both packages run float32 on the CPU.  Tolerance:
logits and boundary tensors rtol 1e-5, atol 1e-5 (the two libraries sum
matrix products in different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jm
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro_torch import models as tm
from repro_torch.configs import get_config, reduced

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def pair():
    jcfg = jreduced(jget_config("codeqwen1.5-7b"), layers=4)
    tcfg = reduced(get_config("codeqwen1.5-7b"), layers=4)
    jparams = jm.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = tm.params_from_numpy(
        tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, tcfg, tparams


def _tokens(cfg, b=2, s=12, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def test_configs_identical():
    for name in ("codeqwen1.5-7b", "gemma3-1b", "dbrx-132b"):
        assert repr(get_config(name)) == repr(jget_config(name))
        assert repr(reduced(get_config(name))) == \
            repr(jreduced(jget_config(name)))


@pytest.mark.parametrize("split_after", [None, 1, 3])
def test_build_groups_identical(split_after):
    cfg = get_config("codeqwen1.5-7b")
    jg, jb = jm.build_groups(jget_config("codeqwen1.5-7b"), True,
                             split_after=split_after)
    tg, tb = tm.build_groups(cfg, True, split_after=split_after)
    assert tb == jb
    assert [(repr(g.specs), g.n_periods) for g in tg] == \
        [(repr(g.specs), g.n_periods) for g in jg]
    with pytest.raises(ValueError, match="out of range"):
        tm.build_groups(cfg, True, split_after=cfg.n_full_periods)


def test_forward_and_split_halves_match(pair):
    jcfg, jparams, tcfg, tparams = pair
    toks = _tokens(tcfg)
    jl, _ = jm.forward(jcfg, jparams, jnp.asarray(toks))
    tl, _ = tm.forward(tcfg, tparams, torch.from_numpy(toks))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    jx = jm.forward_head(jcfg, jparams, jnp.asarray(toks))
    tx = tm.forward_head(tcfg, tparams, torch.from_numpy(toks))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL)
    jl2 = jm.forward_from_boundary(jcfg, jparams, jx)
    tl2 = tm.forward_from_boundary(tcfg, tparams, tx)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), **TOL)


def test_prefill_decode_split_match(pair):
    jcfg, jparams, tcfg, tparams = pair
    toks = _tokens(tcfg, b=2, s=9, seed=1)
    jc = jm.init_cache(jcfg, 2, 16, split=True)
    tc = tm.init_cache(tcfg, 2, 16, split=True)
    jx, jpre = jm.prefill_to_boundary(jcfg, jparams, jnp.asarray(toks), jc)
    tx, tpre = tm.prefill_to_boundary(tcfg, tparams,
                                      torch.from_numpy(toks), tc)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL)
    jl, jpost = jm.prefill_from_boundary(jcfg, jparams, jx, jc)
    tl, tpost = tm.prefill_from_boundary(tcfg, tparams, tx, tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    jc = list(jpre) + list(jpost)
    # the port's caches hold (B, S, K, hd) per layer, the reference's
    # stack the group's layers on a leading axis
    for gi, group in enumerate(tc):
        for li, layer in enumerate(group):
            np.testing.assert_allclose(layer["k"].numpy(),
                                       np.asarray(jc[gi][0]["k"][li]), **TOL)
    cur = np.argmax(np.asarray(jl), -1).astype(np.int32)
    for pos in (9, 10):
        jx, jpre = jm.decode_to_boundary(jcfg, jparams, jnp.asarray(cur), jc,
                                         jnp.int32(pos))
        tx, _ = tm.decode_to_boundary(tcfg, tparams, torch.from_numpy(cur),
                                      tc, pos)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL)
        jl, jpost = jm.decode_from_boundary(jcfg, jparams, jx, jc,
                                            jnp.int32(pos))
        tl, _ = tm.decode_from_boundary(tcfg, tparams, tx, tc, pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        jc = list(jpre) + list(jpost)
        cur = np.argmax(np.asarray(jl), -1).astype(np.int32)


def test_unsplit_prefill_and_decode_step_match(pair):
    jcfg, jparams, tcfg, tparams = pair
    toks = _tokens(tcfg, b=3, s=7, seed=2)
    jc = jm.init_cache(jcfg, 3, 12)
    tc = tm.init_cache(tcfg, 3, 12)
    jl, jc = jm.prefill(jcfg, jparams, jnp.asarray(toks), jc)
    tl, tc = tm.prefill(tcfg, tparams, torch.from_numpy(toks), tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    cur = np.argmax(np.asarray(jl), -1).astype(np.int32)
    jl, jc, _ = jm.decode_step(jcfg, jparams, jnp.asarray(cur), jc,
                               jnp.int32(7))
    tl, tc, _ = tm.decode_step(tcfg, tparams, torch.from_numpy(cur), tc, 7)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


def test_sliding_window_and_softcap_layers_match():
    """gemma2's local/global pattern with logit softcaps (dense, so the
    port runs it): windowed ring caches and tanh caps agree too."""
    jcfg = jreduced(jget_config("gemma2-9b"), layers=4)
    tcfg = reduced(get_config("gemma2-9b"), layers=4)
    jparams = jm.init_params(jcfg, jax.random.PRNGKey(1))
    tparams = tm.params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams),
                                   device="cpu")
    toks = _tokens(tcfg, b=1, s=70, seed=3)
    jl, _ = jm.forward(jcfg, jparams, jnp.asarray(toks))
    tl, _ = tm.forward(tcfg, tparams, torch.from_numpy(toks))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


def test_init_params_shapes_and_dense_only():
    cfg = reduced(get_config("codeqwen1.5-7b"))
    gen = torch.Generator().manual_seed(0)
    p = tm.init_params(cfg, gen, device="cpu")
    j = jax.eval_shape(lambda: jm.init_params(
        jreduced(jget_config("codeqwen1.5-7b")), jax.random.PRNGKey(0)))
    assert tuple(p["embed"]["table"].shape) == j["embed"]["table"].shape
    assert len(p["layers"]) == cfg.num_layers
    assert tuple(p["layers"][0]["attn"]["wq"].shape) == \
        j["groups"][0]["layers"][0]["attn"]["wq"].shape[1:]
    # MoE, rwkv6 and rglru layers are ported: their shapes match too
    for name in ("dbrx-132b", "rwkv6-3b", "recurrentgemma-2b"):
        cfg = reduced(get_config(name))
        p = tm.init_params(cfg, gen, device="cpu")
        j = jax.eval_shape(lambda n=name: jm.init_params(
            jreduced(jget_config(n)), jax.random.PRNGKey(0)))
        for li, layer in enumerate(p["layers"][:cfg.period]):
            shapes = jax.tree.map(lambda a: a.shape[1:],
                                  j["groups"][0]["layers"][li])
            assert jax.tree.map(lambda t: tuple(t.shape), layer) == shapes
        assert sum(map(len, tm.init_cache(cfg, 1, 8, device="cpu"))) == \
            cfg.num_layers
    # the split runtime's tree stays dense-only (its MoE path is the
    # multi-chip one)
    with pytest.raises(NotImplementedError, match="dense"):
        tm.split_params_from_numpy(reduced(get_config("dbrx-132b")), {},
                                   edge_device="cpu", cloud_device="cpu")


def test_model_entry_points_default_to_the_card():
    """Like every entry point of the port, the model's run on the card
    unless the CPU is asked for, and raise where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = reduced(get_config("codeqwen1.5-7b"))
    with pytest.raises(RuntimeError, match="CUDA"):
        tm.init_params(cfg, torch.Generator().manual_seed(0))
    jparams = jm.init_params(jreduced(jget_config("codeqwen1.5-7b")),
                             jax.random.PRNGKey(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        tm.params_from_numpy(cfg, jax.tree.map(np.asarray, jparams))
