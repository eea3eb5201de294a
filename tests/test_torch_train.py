"""Port vs reference: training -- ``loss_fn`` with remat, the trainer
and checkpoints across the two packages -- and ports of
``tests/test_substrates.py``'s data, checkpoint, trainer and
gradient-compression cases (the loader, the ``make_*_step`` functions
and the CLI are in ``tests/test_torch_launch_train.py``).

Tiny float32 configs on the CPU; the reference's weights and training
state are carried over with ``params_from_numpy`` and
``train_state_from_numpy``.  Tolerances: losses rtol 1e-5 and gradients
rtol 1e-4, atol 1e-6 (the two libraries sum matrix products in other
orders); a 4-step trainer run's losses rtol 1e-6, its final state rtol
1e-5, atol 1e-6; a bfloat16 run resumed from the reference's checkpoint
within rtol 1e-2 of the reference's losses (bf16 products); checkpoint
arrays and remat against no remat exact.
"""

import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jm
from repro.compression import GradCompressionConfig as JGradCfg
from repro.configs import ARCHS, reduced as jreduced
from repro.core import CodecConfig as JCodecConfig
from repro.core import calibrate as jcalibrate
from repro.data import DataConfig as JDataConfig
from repro.optim import init_opt_state as jinit_opt
from repro.train import Trainer as JTrainer
from repro.train import TrainerConfig as JTrainerConfig
from repro.train import checkpoint as jckpt
from repro_torch import models as tm
from repro_torch.compression import (GradCompressionConfig, compress_grads,
                                     init_error_feedback)
from repro_torch.configs import get_config, reduced
from repro_torch.core import CodecConfig, calibrate
from repro_torch.data import DataConfig, stream
from repro_torch.models import convert
from repro_torch.models import transformer as tt
from repro_torch import optim as topt
from repro_torch.optim import init_opt_state
from repro_torch.train import Trainer, TrainerConfig
from repro_torch.train import checkpoint as ckpt
from repro_torch.tree import leaves

TINY = dict(vocab_size=128, d_model=32, d_ff=64, num_heads=2, num_kv_heads=2,
            head_dim=16)
LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def _cfgs(arch="codeqwen1.5-7b", **kw):
    kw = kw or TINY
    return (dataclasses.replace(jreduced(ARCHS[arch]), **kw),
            dataclasses.replace(reduced(get_config(arch)), **kw))


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = _cfgs()
    jp = jm.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jp, tcfg, tm.params_from_numpy(
        tcfg, jax.tree.map(np.asarray, jp), device="cpu")


def _tokens(cfg, b=2, s=16, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _jgrads(jcfg, jp, toks, **kw):
    (loss, aux), g = jax.jit(jax.value_and_grad(
        lambda p: jm.loss_fn(jcfg, p, jnp.asarray(toks), **kw),
        has_aux=True))(jp)
    return float(loss), aux, g


def _same_grads(tcfg, tgrads, jgrads):
    want = tm.params_from_numpy(tcfg, jax.tree.map(np.asarray, jgrads),
                                device="cpu")
    for (path, a), (_, b) in zip(leaves(tgrads), leaves(want), strict=True):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **GRAD_TOL,
                                   err_msg=str(path))


# -- loss_fn and remat -------------------------------------------------------------

@pytest.mark.parametrize("remat", [False, True])
def test_loss_fn_and_grads_match_reference(pair, remat):
    jcfg, jp, tcfg, tp = pair
    toks = _tokens(tcfg)
    jloss, _, jg = _jgrads(jcfg, jp, toks, remat=remat)
    (tloss, aux), tg = tm.loss_and_grads(tcfg, tp, torch.from_numpy(toks),
                                         remat=remat)
    assert aux == {}
    assert float(tloss) == pytest.approx(jloss, rel=LOSS_RTOL)
    _same_grads(tcfg, tg, jg)


@pytest.mark.parametrize("arch", ["gemma3-1b", "gemma2-9b"])
def test_sharded_xent_tied_and_softcapped_match_reference(arch):
    """gemma3-1b ties the head to the embedding; gemma2-9b caps its
    logits (``final_logit_softcap``) in float32 and casts back."""
    jcfg, tcfg = _cfgs(arch, vocab_size=96)
    jp = jm.init_params(jcfg, jax.random.PRNGKey(1))
    tp = tm.params_from_numpy(tcfg, jax.tree.map(np.asarray, jp),
                              device="cpu")
    toks = _tokens(tcfg, s=12, seed=2)
    jloss, _, jg = _jgrads(jcfg, jp, toks, remat=False)
    (tloss, _), tg = tm.loss_and_grads(tcfg, tp, torch.from_numpy(toks),
                                       remat=False)
    assert float(tloss) == pytest.approx(jloss, rel=LOSS_RTOL)
    _same_grads(tcfg, tg, jg)


def test_loss_fn_with_the_codec_in_the_loop(pair):
    """``codec_fn=codec.apply_with_rate``: the rate comes back in aux,
    and every leaf before the boundary has a zero gradient in both
    packages (the quantizer carries none): the port's autograd returns
    None there, which becomes zeros."""
    jcfg, jp, tcfg, tp = pair
    toks = _tokens(tcfg, seed=3)
    kw = dict(n_levels=4, clip_mode="manual", manual_cmin=-1.5,
              manual_cmax=1.5)
    jcodec = jcalibrate(JCodecConfig(**kw))
    tcodec = calibrate(CodecConfig(**kw, backend="torch"))
    jloss, jaux, jg = _jgrads(jcfg, jp, toks, remat=False,
                              codec_fn=jcodec.apply_with_rate)
    (tloss, taux), tg = tm.loss_and_grads(
        tcfg, tp, torch.from_numpy(toks), remat=False,
        codec_fn=tcodec.apply_with_rate)
    assert float(tloss) == pytest.approx(jloss, rel=LOSS_RTOL)
    assert float(taux["codec_rate_bits"]) == pytest.approx(
        float(jaux["codec_rate_bits"]), rel=1e-5)
    groups, boundary = tt.build_groups(tcfg, split=True)
    assert boundary == 1
    n_head = groups[0].n_periods * len(groups[0].specs)
    for path, g in leaves(tg):
        if path[0] == "layers":
            assert g.any() == (path[1] >= n_head), path
    _same_grads(tcfg, tg, jg)
    # the zero gradients still take the update: weight decay alone
    ocfg = topt.AdamWConfig()
    new, _, _ = topt.adamw_update(ocfg, tp, tg, topt.init_opt_state(tp))
    lr = torch.tensor(ocfg.lr)
    for (path, a), (_, b) in zip(leaves(tp), leaves(new), strict=True):
        if path[0] == "layers" and path[1] < n_head:
            assert torch.equal(b, a - lr * (ocfg.weight_decay * a)), path
            assert not torch.equal(b, a), path


def test_remat_group_size_matches_reference():
    for n in range(1, 200):
        assert tt._remat_group_size(n) == jm.transformer._remat_group_size(n)


def test_remat_at_64_periods_equals_no_remat():
    """64 periods: the reference checkpoints super-steps of
    ``_remat_group_size(64)`` = 8 periods; values do not change."""
    tcfg = reduced(get_config("codeqwen1.5-7b"), layers=64, d_model=16)
    jcfg = jreduced(ARCHS["codeqwen1.5-7b"], layers=64, d_model=16)
    assert tcfg.n_full_periods == 64 and tt._remat_group_size(64) == 8
    jp = jm.init_params(jcfg, jax.random.PRNGKey(2))
    tp = tm.params_from_numpy(tcfg, jax.tree.map(np.asarray, jp),
                              device="cpu")
    toks = torch.from_numpy(_tokens(tcfg, s=8, seed=4))
    (l0, _), g0 = tm.loss_and_grads(tcfg, tp, toks, remat=False)
    (l1, _), g1 = tm.loss_and_grads(tcfg, tp, toks, remat=True)
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(leaves(g0),
                                                           leaves(g1)))
    jl, _ = jax.jit(lambda p: jm.loss_fn(jcfg, p, jnp.asarray(toks.numpy()),
                                         remat=True))(jp)
    assert float(l1) == pytest.approx(float(jl), rel=LOSS_RTOL)


def test_forward_with_remat_equals_forward(pair):
    _, _, tcfg, tp = pair
    toks = torch.from_numpy(_tokens(tcfg, seed=5))
    a, _ = tm.forward(tcfg, tp, toks)
    b, _ = tm.forward(tcfg, tp, toks, remat=True)
    assert torch.equal(a, b)


# -- the training state across packages ---------------------------------------------

def _jstate(jcfg, seed=0):
    jp = jm.init_params(jcfg, jax.random.PRNGKey(seed))
    return {"params": jp, "opt": jinit_opt(jp),
            "ef": jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), jp)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_state_roundtrip(dtype):
    jcfg, tcfg = _cfgs()
    jcfg = dataclasses.replace(jcfg, dtype=dtype)
    tcfg = dataclasses.replace(tcfg, dtype=dtype)
    host = jax.tree.map(np.asarray, _jstate(jcfg))
    st = tm.train_state_from_numpy(tcfg, host, device="cpu")
    assert st["opt"]["step"].dtype == torch.int32
    assert st["params"]["layers"][0]["attn"]["wq"].dtype == \
        tt.torch_dtype(tcfg)
    assert st["opt"]["mu"]["layers"][0]["attn"]["wq"].dtype == torch.float32
    back = tm.train_state_to_numpy(tcfg, st)
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_flatten_with_path(host)[0],
                                jax.tree_util.tree_flatten_with_path(back)[0],
                                strict=True):
        assert jax.tree_util.keystr(pa) == jax.tree_util.keystr(pb)
        assert a.shape == b.shape and a.tobytes() == b.tobytes()
        if dtype == "bfloat16" and a.dtype.itemsize == 2:
            assert b.dtype == np.dtype("V2")


def test_stack_layers_is_the_reference_layout(pair):
    jcfg, jp, tcfg, tp = pair
    st = convert.stack_layers(tcfg, tp)
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_flatten_with_path(jp)[0],
                                jax.tree_util.tree_flatten_with_path(st)[0],
                                strict=True):
        assert jax.tree_util.keystr(pa) == jax.tree_util.keystr(pb)
        assert np.array_equal(np.asarray(a), b.numpy())
    back = convert.unstack_layers(tcfg, st)
    assert all(torch.equal(a, b) for (_, a), (_, b)
               in zip(leaves(tp, sort_keys=True),
                      leaves(back, sort_keys=True), strict=True))


def _trainers(jcfg, tcfg, d, steps, **kw):
    jt = JTrainer(jcfg, JTrainerConfig(steps=steps, ckpt_every=4,
                                       ckpt_dir=str(d / "ref"),
                                       warmup_steps=2),
                  JDataConfig(vocab_size=jcfg.vocab_size, batch=2,
                              seq_len=16))
    tr = Trainer(tcfg, TrainerConfig(steps=steps, ckpt_every=4,
                                     ckpt_dir=str(d / "port"),
                                     warmup_steps=2),
                 DataConfig(vocab_size=tcfg.vocab_size, batch=2, seq_len=16),
                 device="cpu", **kw)
    return jt, tr


def test_trainer_matches_reference_from_its_initial_state(tmp_path):
    """The reference's initial state, saved by the reference at step 0,
    is what the port's trainer resumes from; four steps later the losses
    and the state agree."""
    jcfg, tcfg = _cfgs()
    jt, tr = _trainers(jcfg, tcfg, tmp_path, 4)
    jckpt.save(str(tmp_path / "port"), 0, jt.init_state())
    jstate = jt.run(resume=False)
    state = tr.run(resume=True)
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose([m[key] for m in tr.metrics_log],
                                   [m[key] for m in jt.metrics_log],
                                   rtol=1e-6 if key != "grad_norm" else 1e-5)
    want = jax.tree.map(np.asarray, jstate)
    got = tm.train_state_to_numpy(tcfg, state)
    for (path, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                                 jax.tree_util.tree_flatten_with_path(got)[0],
                                 strict=True):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))


def test_bf16_reference_checkpoint_resumes_in_the_port(tmp_path):
    """The reference writes bfloat16 leaves as '<V2' arrays; the port
    resumes its step-4 checkpoint with the same bits and trains on as the
    reference did.  (The reference's own ``restore`` cannot cast '<V2'
    back to bfloat16.)"""
    jcfg, tcfg = (dataclasses.replace(c, dtype="bfloat16") for c in _cfgs())
    jt, tr = _trainers(jcfg, tcfg, tmp_path, 8)
    jt.tcfg.ckpt_dir = str(tmp_path / "port")
    jt.run(resume=False)
    shutil.rmtree(tmp_path / "port" / "step_00000008")
    raw = ckpt.load_tree(str(tmp_path / "port"), 4)
    assert raw["params"]["embed"]["table"].dtype == np.dtype("V2")
    with pytest.raises(ValueError, match="cast"):
        jckpt.restore(str(tmp_path / "port"), 4, jt.init_state())
    restored = tr._restore(4, tr.init_state())
    back = tm.train_state_to_numpy(tcfg, restored)
    flat_raw = jax.tree_util.tree_flatten_with_path(raw)[0]
    flat_back = jax.tree_util.tree_flatten_with_path(back)[0]
    for (pa, a), (_, b) in zip(flat_raw, flat_back, strict=True):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), pa
    tr.run(resume=True)
    assert [m["step"] for m in tr.metrics_log] == [4, 5, 6, 7]
    np.testing.assert_allclose([m["loss"] for m in tr.metrics_log],
                               [m["loss"] for m in jt.metrics_log[4:]],
                               rtol=1e-2)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    """The port's state, converted to the reference's layout and saved by
    the port, is restored by the reference's ``checkpoint.restore`` with
    every array equal; bfloat16 leaves are saved as the reference saves
    them (the same '<V2' bytes)."""
    jcfg, tcfg = _cfgs()
    tr = Trainer(tcfg, TrainerConfig(steps=2, ckpt_every=10,
                                     ckpt_dir=str(tmp_path / "a")),
                 DataConfig(vocab_size=tcfg.vocab_size, batch=2, seq_len=16),
                 device="cpu")
    host = tm.train_state_to_numpy(tcfg, tr.run(resume=False))
    ckpt.save(str(tmp_path / "b"), 2, host)
    got = jckpt.restore(str(tmp_path / "b"), 2, _jstate(jcfg))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(host), strict=True):
        assert np.asarray(a).dtype == b.dtype
        assert np.array_equal(np.asarray(a), b)
    # bfloat16: the reference's save and the port's save of one state
    jb = dataclasses.replace(jcfg, dtype="bfloat16")
    tb = dataclasses.replace(tcfg, dtype="bfloat16")
    jstate = _jstate(jb, seed=3)
    jckpt.save(str(tmp_path / "ref16"), 1, jstate)
    port = tm.train_state_from_numpy(tb, jax.tree.map(np.asarray, jstate),
                                     device="cpu")
    ckpt.save(str(tmp_path / "port16"), 1, tm.train_state_to_numpy(tb, port))
    with np.load(tmp_path / "ref16" / "step_00000001" / "arrays.npz") as r, \
            np.load(tmp_path / "port16" / "step_00000001" / "arrays.npz") as p:
        assert r.files == p.files
        for k in r.files:
            assert r[k].dtype == p[k].dtype and \
                r[k].tobytes() == p[k].tobytes(), k


# -- ports of tests/test_substrates.py ------------------------------------------------

@pytest.fixture()
def tiny_cfg():
    return _cfgs()[1]


class TestData:
    def test_deterministic_replay(self):
        cfg = DataConfig(vocab_size=100, batch=4, seq_len=16)
        a = list(zip(range(5), stream(cfg)))
        b = list(zip(range(5), stream(cfg)))
        for (_, x), (_, y) in zip(a, b):
            np.testing.assert_array_equal(x["tokens"], y["tokens"])

    def test_resume_mid_stream(self):
        cfg = DataConfig(vocab_size=100, batch=2, seq_len=8)
        full = [b["tokens"] for _, b in zip(range(6), stream(cfg))]
        resumed = [b["tokens"] for _, b in zip(range(3), stream(cfg, 3))]
        for x, y in zip(full[3:], resumed):
            np.testing.assert_array_equal(x, y)

    def test_tokens_in_range(self):
        cfg = DataConfig(vocab_size=37, batch=2, seq_len=64)
        b = next(stream(cfg))
        assert b["tokens"].min() >= 0 and b["tokens"].max() < 37


class TestCheckpoint:
    def test_roundtrip(self, tmp_path, tiny_cfg):
        params = tm.init_params(tiny_cfg, torch.Generator().manual_seed(0),
                                device="cpu")
        ckpt.save(str(tmp_path), 7, {"params": params})
        assert ckpt.latest_step(str(tmp_path)) == 7
        restored = ckpt.restore(str(tmp_path), 7, {"params": params})
        for (_, a), (_, b) in zip(leaves(params),
                                  leaves(restored["params"]), strict=True):
            assert torch.equal(a, b)

    def test_gc_keeps_latest(self, tmp_path, tiny_cfg):
        params = {"w": torch.ones((4,))}
        for s in (1, 2, 3, 4, 5):
            ckpt.save(str(tmp_path), s, params, keep=2)
        steps = sorted(os.listdir(tmp_path))
        assert steps == ["step_00000004", "step_00000005"]

    def test_atomic_no_tmp_left(self, tmp_path):
        ckpt.save(str(tmp_path), 1, {"w": torch.ones((4,))})
        assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))


class TestTrainer:
    def _mk(self, tiny_cfg, tmp_path, **kw):
        tcfg = TrainerConfig(steps=8, ckpt_every=4, ckpt_dir=str(tmp_path),
                             warmup_steps=2, **kw)
        dcfg = DataConfig(vocab_size=tiny_cfg.vocab_size, batch=2, seq_len=16)
        return Trainer(tiny_cfg, tcfg, dcfg, device="cpu")

    def test_loss_decreases(self, tiny_cfg, tmp_path):
        tr = self._mk(tiny_cfg, tmp_path)
        tr.run(resume=False)
        losses = [m["loss"] for m in tr.metrics_log]
        assert losses[-1] < losses[0]
        assert np.isfinite(losses).all()

    def test_failure_injection_and_bitexact_resume(self, tiny_cfg, tmp_path):
        full = self._mk(tiny_cfg, tmp_path)
        state_full = full.run(resume=False)
        shutil.rmtree(tmp_path)
        crash = self._mk(tiny_cfg, tmp_path)
        crash.fail_at_step = 5  # after the step-4 checkpoint
        with pytest.raises(RuntimeError, match="injected failure"):
            crash.run(resume=False)
        assert ckpt.latest_step(str(tmp_path)) == 4
        resumed = self._mk(tiny_cfg, tmp_path)
        state_res = resumed.run(resume=True)  # restarts from step 4
        for (_, a), (_, b) in zip(leaves(state_full["params"]),
                                  leaves(state_res["params"])):
            np.testing.assert_allclose(a.double().numpy(),
                                       b.double().numpy(),
                                       rtol=1e-6, atol=1e-6)

    def test_grad_compression_training_still_converges(self, tiny_cfg,
                                                       tmp_path):
        tr = self._mk(tiny_cfg, tmp_path,
                      grad_compression=GradCompressionConfig(n_levels=16))
        tr.run(resume=False)
        losses = [m["loss"] for m in tr.metrics_log]
        assert losses[-1] < losses[0]


class TestGradCompression:
    def test_error_feedback_preserves_mean_update(self):
        """EF: sum of compressed grads ~= sum of raw grads over time."""
        cfg = GradCompressionConfig(n_levels=4)
        rng = np.random.default_rng(0)
        g_raw = [{"w": torch.from_numpy(
            rng.normal(size=(64,)).astype(np.float32))} for _ in range(30)]
        ef = init_error_feedback(g_raw[0])
        total_c = torch.zeros((64,))
        for g in g_raw:
            cg, ef, _ = compress_grads(cfg, g, ef)
            total_c = total_c + cg["w"]
        total_raw = sum(g["w"] for g in g_raw)
        resid = float((total_c - total_raw).abs().max())
        per_step_q = float(ef["w"].std(correction=0)) + 1e-9
        # residual stays bounded by one step's quantization error, not O(T)
        assert resid < 10 * per_step_q

    def test_disabled_passthrough(self):
        cfg = GradCompressionConfig(enabled=False)
        g = {"w": torch.arange(8.0)}
        ef = init_error_feedback(g)
        cg, _, _ = compress_grads(cfg, g, ef)
        assert torch.equal(cg["w"], g["w"])

    def test_bf16_residual_accounts_for_cast(self):
        """EF invariant under low-precision grads: cg + new_e == gf up to
        the float32 rounding of the residual itself."""
        cfg = GradCompressionConfig(n_levels=4)
        rng = np.random.default_rng(7)
        g = {"w": torch.from_numpy(rng.normal(size=(256,)).astype(
            np.float32)).to(torch.bfloat16)}
        ef = init_error_feedback(g)
        for _ in range(3):
            gf = g["w"].float() + ef["w"]
            cg, ef, _ = compress_grads(cfg, g, ef)
            assert cg["w"].dtype == torch.bfloat16
            recon = cg["w"].float() + ef["w"]
            np.testing.assert_allclose(recon.numpy(), gf.numpy(), rtol=0,
                                       atol=1e-6)


def test_trainer_compresses_in_the_reference_layout(pair):
    """The trainer's compression sees the reference's stacked leaves: on
    the same gradients and buffers, its output is the reference's
    ``compress_grads`` output (one clip range per stacked leaf), within
    float32 units of the range (the standard deviation sums in another
    order)."""
    from repro.compression import compress_grads as jcompress
    from repro.compression import init_error_feedback as jinit_ef
    jcfg, jp, tcfg, tp = pair
    _, _, jg = _jgrads(jcfg, jp, _tokens(tcfg, seed=6), remat=False)
    jcg, jne, jmet = jcompress(JGradCfg(n_levels=16), jg, jinit_ef(jp))
    tg = tm.params_from_numpy(tcfg, jax.tree.map(np.asarray, jg),
                              device="cpu")
    cg, ne, met = compress_grads(GradCompressionConfig(n_levels=16),
                                 convert.stack_layers(tcfg, tg),
                                 convert.stack_layers(
                                     tcfg, init_error_feedback(tg)))
    for a, b in zip(jax.tree.leaves(jcg), jax.tree.leaves(
            jax.tree.map(lambda t: t.numpy(), cg)), strict=True):
        a = np.asarray(a)
        np.testing.assert_allclose(b, a, rtol=0,
                                   atol=1e-5 * float(np.abs(a).max()))
    assert float(met["grad_compress_mse"]) == pytest.approx(
        float(jmet["grad_compress_mse"]), rel=1e-5)
