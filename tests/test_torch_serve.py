"""Port vs reference: the serving engine with both split hookups.

The reference's random weights are carried over with
``params_from_numpy``, both codecs get the same calibration (a fixed
range, or one shared array of the reference model's split-layer
activations), and the two engines serve the same requests on the CPU
(reduced codeqwen1.5-7b, float32).  Tolerance: generated tokens
identical; the per-step rate estimates rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import models as jm
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.core import CodecConfig as JCodecConfig
from repro.core import calibrate as jcalibrate
from repro.serving import Request as JRequest
from repro.serving import ServeEngine as JServeEngine
from repro_torch import models as tm
from repro_torch.configs import get_config, reduced
from repro_torch.core import CodecConfig, calibrate
from repro_torch.launch import serve as tserve
from repro_torch.serving import Request, ServeEngine

CODEC = dict(n_levels=4, clip_mode="manual", manual_cmin=-2.0,
             manual_cmax=2.0)
_CALIBRATED = dict(n_levels=4, clip_mode="model", constrain_cmin_zero=False)
_CHANNEL = dict(granularity="channel", channel_axis=-1, channel_group_size=2)
_ECSQ = dict(use_ecsq=True, ecsq_lagrangian=0.05)
CODECS = {"manual": CODEC,
          "channel_g2": dict(_CALIBRATED, **_CHANNEL),
          "ecsq_tensor": dict(_CALIBRATED, **_ECSQ),
          "ecsq_channel": dict(_CALIBRATED, **_CHANNEL, **_ECSQ)}
# (hookup, codec kind); the manual codec's cases keep their plain ids
ENGINE_CASES = [("codec", "manual"), ("codec_host_fn", "manual")] + [
    (h, k) for k in ("channel_g2", "ecsq_tensor", "ecsq_channel")
    for h in ("codec", "codec_host_fn")]


@pytest.fixture(scope="module")
def models():
    jcfg = jreduced(jget_config("codeqwen1.5-7b"), layers=4)
    tcfg = reduced(get_config("codeqwen1.5-7b"), layers=4)
    jparams = jm.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = tm.params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams),
                                   device="cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module")
def samples(models):
    """Split-layer activations of the reference model, (tokens, d_model)
    float32: the one calibration array both packages use."""
    jcfg, jparams, _, _ = models
    probe = {}

    def probe_fn(x):
        probe["x"] = x
        return x, 0.0

    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (4, 12))
    jm.forward(jcfg, jparams, jnp.asarray(toks, jnp.int32),
               codec_fn=probe_fn)
    return np.asarray(probe["x"], np.float32).reshape(-1, jcfg.d_model)


def _calibrated_pair(kind, samples):
    """(reference codec, port codec) of ``kind``, calibrated alike."""
    cfg = CODECS[kind]
    if cfg["clip_mode"] == "manual":
        data = None
    elif cfg.get("granularity", "tensor") == "tensor":
        data = samples.reshape(-1)
    else:
        data = samples
    return (jcalibrate(JCodecConfig(**cfg), samples=data),
            calibrate(CodecConfig(backend="torch", **cfg), samples=data))


def _requests(cls, vocab):
    """More requests than slots, ragged lengths: epochs and refills."""
    rng = np.random.default_rng(0)
    spec = [(5, 4), (7, 2), (3, 6), (6, 3), (4, 5), (2, 2)]
    return [cls(prompt=rng.integers(0, vocab, p).astype(np.int32),
                max_new_tokens=n) for p, n in spec]


def _host_fn(codec):
    def roundtrip(x):
        payloads = list(codec.encode_stream(x, chunk_elems=96,
                                            device_entropy=True))
        recon = codec.decode_stream(payloads).reshape(x.shape)
        return recon, 8.0 * sum(map(len, payloads)) / x.size
    return roundtrip


@pytest.mark.parametrize(
    "hookup,kind", ENGINE_CASES,
    ids=[h if k == "manual" else f"{h}-{k}" for h, k in ENGINE_CASES])
def test_engine_tokens_match_reference(models, samples, hookup, kind):
    jcfg, jparams, tcfg, tparams = models
    jcodec, tcodec = _calibrated_pair(kind, samples)
    if hookup == "codec":
        jkw, tkw = dict(codec=jcodec), dict(codec=tcodec)
    else:
        jkw = dict(codec_host_fn=_host_fn(jcodec))
        tkw = dict(codec_host_fn=_host_fn(tcodec))
    jeng = JServeEngine(jcfg, jparams, slots=4, max_seq=16, **jkw)
    teng = ServeEngine(tcfg, tparams, slots=4, max_seq=16, device="cpu",
                       **tkw)
    jreqs = jeng.generate(_requests(JRequest, jcfg.vocab_size))
    treqs = teng.generate(_requests(Request, tcfg.vocab_size))
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    assert all(r.done and len(r.out_tokens) == r.max_new_tokens
               for r in treqs)
    np.testing.assert_allclose(list(teng.rate_log), list(jeng.rate_log),
                               rtol=1e-5)
    jc, tc = jeng.counters, teng.counters
    for key in ("steps", "slot_steps", "active_slot_steps", "prefills",
                "refills", "epochs", "requests_done"):
        assert tc[key] == jc[key], key
    assert tc["refills"] > 0 and len(teng.latency_log) == len(treqs)


def test_engine_without_codec_matches_reference(models):
    jcfg, jparams, tcfg, tparams = models
    jreqs = JServeEngine(jcfg, jparams, slots=2, max_seq=16).generate(
        _requests(JRequest, jcfg.vocab_size)[:3])
    treqs = ServeEngine(tcfg, tparams, slots=2, max_seq=16,
                        device="cpu").generate(
        _requests(Request, tcfg.vocab_size)[:3])
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]


def test_entry_points_need_cuda_unless_cpu_is_asked(models):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, _, tcfg, tparams = models
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(tcfg, tparams)
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.main(["--arch", "codeqwen1.5-7b"])


def test_serve_cli_on_cpu(capsys):
    tserve.main(["--arch", "codeqwen1.5-7b", "--device", "cpu",
                 "--requests", "3", "--prompt-len", "5", "--new-tokens",
                 "3", "--codec-levels", "4", "--warmup-batches", "1"])
    out = capsys.readouterr().out
    assert "calibrated codec on" in out
    assert "9 tokens in" in out and "split-link rate:" in out
    assert "engine:" in out and "request latency:" in out


def test_serve_cli_channel_granularity_on_cpu(capsys):
    tserve.main(["--arch", "codeqwen1.5-7b", "--device", "cpu",
                 "--requests", "2", "--prompt-len", "5", "--new-tokens",
                 "3", "--codec-levels", "4", "--warmup-batches", "1",
                 "--granularity", "channel", "--channel-group", "8"])
    out = capsys.readouterr().out
    assert "granularity=channel(g=8)" in out
    assert "6 tokens in" in out and "split-link rate:" in out


LOOPBACK_ARGS = ["--arch", "codeqwen1.5-7b", "--device", "cpu",
                 "--requests", "2", "--prompt-len", "5", "--new-tokens", "3",
                 "--codec-levels", "4", "--warmup-batches", "1",
                 "--transport", "loopback"]


@pytest.mark.parametrize("workers", [1, 2])
def test_serve_cli_loopback_on_cpu(monkeypatch, capsys, workers):
    """``--transport loopback --device cpu`` streams every boundary
    tensor through a localhost CloudServer (or a dispatcher over two
    in-process workers): its tokens equal the engine's with the
    in-process round trip ``decode_stream(encode_stream(x))`` on the
    same weights and codec, every crossing is one session, none shed."""
    runs, crossings, codecs = [], [], []
    real_run, real_fn = tserve.run, tserve._loopback_codec_fn
    real_cal = tserve._calibrate_warmup

    def run(*a, **kw):
        out = real_run(*a, **kw)
        runs.append((a, kw, out))
        return out

    def loopback_fn(codec, *a, **kw):
        host_fn, cleanup = real_fn(codec, *a, **kw)

        def counted(x):
            crossings.append(x.shape)
            return host_fn(x)
        return counted, cleanup

    def calibrate_warmup(*a, **kw):
        codecs.append(real_cal(*a, **kw))
        return codecs[-1]

    monkeypatch.setattr(tserve, "run", run)
    monkeypatch.setattr(tserve, "_loopback_codec_fn", loopback_fn)
    monkeypatch.setattr(tserve, "_calibrate_warmup", calibrate_warmup)
    link = tserve.main(LOOPBACK_ARGS + ["--workers", str(workers),
                                        "--tick-ms", "1"])
    out = capsys.readouterr().out
    assert "loopback transport: streaming split tensors via" in out
    assert "codec bank cache:" in out and "split-link rate:" in out
    (a, kw, (_, reqs, _)), = runs
    assert kw.pop("codec") is None and kw.pop("codec_host_fn") is not None
    (codec,) = codecs

    def inproc(x):
        payloads = list(codec.encode_stream(x, chunk_elems=1 << 16))
        return (codec.decode_stream(payloads).reshape(x.shape),
                8.0 * sum(map(len, payloads)) / x.size)

    _, twin, _ = real_run(*a, codec_host_fn=inproc, **kw)
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in twin]
    assert crossings
    if workers == 1:
        assert "cloud ticks:" in out
        assert link["sessions_served"] == len(crossings)
    else:
        assert "dispatcher: " in out
        assert link["routed_sessions"] == len(crossings)
        assert link["shed_sessions"] == 0
        assert link["worker_restarts"] == 0


def test_serve_cli_loopback_needs_the_card_or_the_cpu():
    """Without ``--device cpu`` the launcher runs on the card: with none
    it raises rather than serve the link on the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    args = [a for a in LOOPBACK_ARGS if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.main(args)


@pytest.mark.parametrize("extra", [
    ["--transport", "none", "--workers", "2"],
    ["--transport", "none", "--secret", "x"],
    ["--metrics-port", "0", "--transport", "none"],
    ["--tls-key", "k.pem"],
    ["--workers", "0"],
    ["--workers", "2", "--metrics-port", "0"]])
def test_serve_cli_loopback_argument_checks(extra):
    args = [a for a in LOOPBACK_ARGS if a not in ("--transport",
                                                  "loopback")]
    with pytest.raises(SystemExit):
        tserve.main(args + (extra if "--transport" in extra else
                            extra + ["--transport", "loopback"]))
