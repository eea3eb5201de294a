"""Port vs reference: the prefetching loader, the ``make_*_step``
functions (``launch/steps.py``) and the training CLI (``launch/train.py``).

Tiny float32 configs on the CPU, the reference's weights converted with
``params_from_numpy``.  Tolerances: losses rtol 1e-5; a microbatched
step's parameters rtol 1e-5, atol 1e-6 and its gradient norm rtol 1e-4
(the two libraries sum matrix products in other orders); next tokens
exact.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jm
from repro.launch import steps as jsteps
from repro.optim import init_opt_state as jinit_opt
from repro_torch import models as tm
from repro_torch.core import CodecConfig, calibrate
from repro_torch.data import DataConfig, PrefetchingLoader, stream
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as tlaunch
from repro_torch.optim import init_opt_state
from repro_torch.train import checkpoint as ckpt
from repro_torch.tree import leaves
from test_torch_train import LOSS_RTOL, _tokens, pair  # noqa: F401


@pytest.mark.parametrize("device", [None, "cpu"])
def test_prefetching_loader_yields_the_stream(device):
    cfg = DataConfig(vocab_size=50, batch=2, seq_len=8, embed_dim=4)
    loader = PrefetchingLoader(cfg, device=device, start_step=3, depth=2)
    try:
        for (_, want), got in zip(zip(range(4), stream(cfg, 3)), loader):
            for k in ("tokens", "inputs"):
                if device is None:
                    assert isinstance(got[k], np.ndarray)
                    np.testing.assert_array_equal(got[k], want[k])
                else:
                    assert got[k].device.type == "cpu"
                    np.testing.assert_array_equal(got[k].numpy(), want[k])
    finally:
        loader.close()
    assert not loader._thread.is_alive()


def test_prefetching_loader_close_stops_a_blocked_thread():
    loader = PrefetchingLoader(DataConfig(vocab_size=10, batch=1, seq_len=4),
                               depth=1)
    for _ in range(50):             # let the queue fill and the thread block
        if loader._q.full():
            break
        threading.Event().wait(0.01)
    loader.close()
    assert not loader._thread.is_alive()


def test_make_train_step_microbatches_match_reference(pair):
    jcfg, jp, tcfg, tp = pair
    toks = _tokens(tcfg, b=4, seed=7)
    jstep = jsteps.make_train_step(jcfg, microbatches=2, remat=False)
    jnp_, jopt, jmet = jstep(jp, jinit_opt(jp), {"tokens": jnp.asarray(toks)})
    tstep = tsteps.make_train_step(tcfg, microbatches=2, remat=False)
    tnp, topt, tmet = tstep(tp, init_opt_state(tp),
                            {"tokens": torch.from_numpy(toks)})
    assert float(tmet["loss"]) == pytest.approx(float(jmet["loss"]),
                                                rel=LOSS_RTOL)
    assert float(tmet["grad_norm"]) == pytest.approx(
        float(jmet["grad_norm"]), rel=1e-4)
    want = tm.params_from_numpy(tcfg, jax.tree.map(np.asarray, jnp_),
                                device="cpu")
    for (path, a), (_, b) in zip(leaves(tnp), leaves(want), strict=True):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=str(path))


def test_make_train_step_reports_the_codec_rate(pair):
    jcfg, jp, tcfg, tp = pair
    codec = calibrate(CodecConfig(n_levels=4, clip_mode="manual",
                                  manual_cmin=-1.5, manual_cmax=1.5,
                                  backend="torch"))
    step = tsteps.make_train_step(tcfg, codec_fn=codec.apply_with_rate)
    _, opt, met = step(tp, init_opt_state(tp),
                       {"tokens": torch.from_numpy(_tokens(tcfg, seed=8))})
    assert 0 < float(met["codec_rate_bits"]) < 3 and int(opt["step"]) == 1


def test_prefill_and_decode_steps_match_reference(pair):
    jcfg, jp, tcfg, tp = pair
    toks = _tokens(tcfg, b=2, s=6, seed=9)
    jc = jm.init_cache(jcfg, 2, 16)
    tc = tm.init_cache(tcfg, 2, 16, device="cpu")
    jtok, jc = jsteps.make_prefill_step(jcfg)(jp, {"tokens":
                                                   jnp.asarray(toks)}, jc)
    ttok, tc = tsteps.make_prefill_step(tcfg)(tp, {"tokens":
                                                   torch.from_numpy(toks)},
                                              tc)
    assert ttok.dtype == torch.int32
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    jtok2, _ = jsteps.make_decode_step(jcfg)(jp, jtok, jc, 6)
    ttok2, _ = tsteps.make_decode_step(tcfg)(tp, ttok, tc, 6)
    np.testing.assert_array_equal(ttok2.numpy(), np.asarray(jtok2))


def test_train_cli_on_the_cpu(tmp_path, capsys):
    tr = tlaunch.main(["--arch", "gemma3-1b", "--steps", "3",
                       "--grad-compress-bits", "4", "--batch", "2",
                       "--seq-len", "16", "--ckpt-dir", str(tmp_path),
                       "--device", "cpu"])
    out = capsys.readouterr().out
    assert "final loss:" in out and len(tr.metrics_log) == 3
    assert ckpt.latest_step(str(tmp_path)) == 3


def test_train_cli_needs_a_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tlaunch.main(["--arch", "gemma3-1b", "--steps", "1",
                      "--ckpt-dir", str(tmp_path)])
