"""Port vs reference: the optimizer (``repro_torch.optim``).

Same inputs, made from a seed with numpy, through the JAX package's
``repro.optim`` and the port's, on a tiny float32 config in the
reference's stacked layout and, converted, in the port's per-layer one.
Tolerances: the schedule's warmup exact, its cosine part within one
float32 ulp of ``cos`` carried through the formula (torch's and XLA's
``cos`` part by one ulp at some steps); AdamW parameters and moments
rtol 1e-6, atol 1e-9 after three steps (the global norm sums its leaves
in another grouping, so the clip factor and every update can move in
the last bit); the global norm rtol 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro.configs import ARCHS, reduced as jreduced
from repro.models import init_params as jinit
from repro_torch import optim as topt
from repro_torch.configs import get_config, reduced
from repro_torch.models import params_from_numpy, train_state_from_numpy
from repro_torch.optim.adamw import reference_rank
from repro_torch.tree import leaves

TINY = dict(vocab_size=128, d_model=32, d_ff=64, num_heads=2, num_kv_heads=2,
            head_dim=16)
STATE_TOL = dict(rtol=1e-6, atol=1e-9)


@pytest.fixture(scope="module")
def cfgs():
    return (dataclasses.replace(jreduced(ARCHS["codeqwen1.5-7b"]), **TINY),
            dataclasses.replace(reduced(get_config("codeqwen1.5-7b")), **TINY))


@pytest.fixture(scope="module")
def jparams(cfgs):
    return jinit(cfgs[0], jax.random.PRNGKey(0))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _grads(params, seed, scale):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: (rng.standard_normal(p.shape) * scale)
                        .astype(np.float32), _np(params))


@pytest.mark.parametrize("warmup,total,min_ratio",
                         [(2, 8, 0.1), (5, 20, 0.0), (0, 1, 0.25)])
def test_warmup_cosine_within_one_ulp(warmup, total, min_ratio):
    for step in range(21):
        want = np.float32(jopt.warmup_cosine(
            step, warmup_steps=warmup, total_steps=total, min_ratio=min_ratio))
        got = topt.warmup_cosine(step, warmup_steps=warmup, total_steps=total,
                                 min_ratio=min_ratio)
        assert got.dtype == torch.float32 and got.dim() == 0
        got = np.float32(got.item())
        if step < warmup:          # the linear warmup: no cosine, exact
            assert got == want, (step, got, want)
            continue
        # torch's and XLA's float32 cos may part by one ulp; carried
        # through min_ratio + (1 - min_ratio) * 0.5 * (1 + cos), whose
        # 1 + cos may cancel, plus the result's own rounding
        t = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
        cos_ulp = np.spacing(np.float32(abs(np.cos(np.pi * t))))
        tol = (1 - min_ratio) * 0.5 * cos_ulp + np.spacing(abs(want))
        assert abs(got - want) <= tol, (step, got, want)


def test_warmup_cosine_on_a_step_tensor_keeps_its_device():
    got = topt.warmup_cosine(torch.tensor(3), warmup_steps=2, total_steps=8)
    assert got.device.type == "cpu" and got.dtype == torch.float32


def test_global_norm_matches_reference(cfgs, jparams):
    jcfg, tcfg = cfgs
    g = _grads(jparams, 1, 0.3)
    want = float(jopt.global_norm(jax.tree.map(jnp.asarray, g)))
    got = float(topt.global_norm(params_from_numpy(tcfg, g, device="cpu")))
    assert got == pytest.approx(want, rel=1e-6)


def test_init_opt_state_layout(cfgs, jparams):
    _, tcfg = cfgs
    p = params_from_numpy(tcfg, _np(jparams), device="cpu")
    st = topt.init_opt_state(p)
    assert st["step"].dtype == torch.int32 and int(st["step"]) == 0
    for (path, a), (_, m) in zip(leaves(p), leaves(st["mu"])):
        assert m.dtype == torch.float32 and m.shape == a.shape
        assert not m.any()


@pytest.mark.parametrize("scale,lr_scales", [
    (0.01, [1.0, 1.0, 1.0]),        # no clipping
    (10.0, [0.25, 0.5, 1.0]),       # clipped by the global norm, warmup
])
def test_adamw_three_steps_match_reference(cfgs, jparams, scale, lr_scales):
    jcfg, tcfg = cfgs
    ocfg = jopt.AdamWConfig()
    jp, js = jparams, jopt.init_opt_state(jparams)
    tp = params_from_numpy(tcfg, _np(jparams), device="cpu")
    ts = topt.init_opt_state(tp)
    for i, lr_scale in enumerate(lr_scales):
        g = _grads(jparams, 10 + i, scale)
        jp, js, jm = jopt.adamw_update(ocfg, jp, jax.tree.map(jnp.asarray, g),
                                       js, lr_scale)
        tp, ts, tm = topt.adamw_update(
            topt.AdamWConfig(), tp, params_from_numpy(tcfg, g, device="cpu"),
            ts, torch.tensor(lr_scale))
        assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                       rel=1e-6)
        assert float(tm["lr"]) == np.float32(jm["lr"])
    want = train_state_from_numpy(
        tcfg, {"params": _np(jp), "opt": _np(js),
               "ef": _np(jax.tree.map(jnp.zeros_like, jp))}, device="cpu")
    assert int(ts["step"]) == 3 and ts["step"].dtype == torch.int32
    for got, ref in ((tp, want["params"]), (ts["mu"], want["opt"]["mu"]),
                     (ts["nu"], want["opt"]["nu"])):
        for (path, a), (_, b) in zip(leaves(got), leaves(ref), strict=True):
            assert a.dtype == b.dtype
            np.testing.assert_allclose(a.numpy(), b.numpy(), **STATE_TOL,
                                       err_msg=str(path))


def test_decay_follows_the_reference_stacked_rank(cfgs, jparams):
    """With zero gradients a step is decay alone: the reference decays
    every layer leaf (rank >= 2 once stacked, norm scales included) and
    not ``final_norm/scale``.  A rule on the port's own ranks would leave
    the layers' norm scales undecayed."""
    jcfg, tcfg = cfgs
    zeros = jax.tree.map(jnp.zeros_like, jparams)
    jp, _, _ = jopt.adamw_update(jopt.AdamWConfig(), jparams, zeros,
                                 jopt.init_opt_state(jparams))
    tp0 = params_from_numpy(tcfg, _np(jparams), device="cpu")
    tp, _, _ = topt.adamw_update(
        topt.AdamWConfig(), tp0, params_from_numpy(tcfg, _np(zeros),
                                                   device="cpu"),
        topt.init_opt_state(tp0))
    want = params_from_numpy(tcfg, _np(jp), device="cpu")
    for (path, a), (_, b), (_, a0) in zip(leaves(tp), leaves(want),
                                         leaves(tp0)):
        assert torch.equal(a, b), path
        decayed = not torch.equal(a, a0)
        assert decayed == (path != ("final_norm", "scale")), path
    norm = tp0["layers"][0]["norm1"]["scale"]
    assert norm.dim() == 1
    assert reference_rank(("layers", 0, "norm1", "scale"), norm) == 2
    assert reference_rank(("final_norm", "scale"),
                          tp0["final_norm"]["scale"]) == 1
