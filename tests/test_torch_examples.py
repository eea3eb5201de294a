"""Port vs reference: the four examples (``repro_torch.examples``) on the
CPU at small sizes.

* ``quickstart``: the port's stdout equals the reference script's line
  for line (both run as subprocesses, the reference with
  ``JAX_PLATFORMS=cpu``).
* ``split_inference`` on the reference's weights (converted with
  ``params_from_numpy``; no training), 2 prompts of 6 tokens, 4 new
  tokens: each row's bits/element within rel 1e-5 of the reference
  ``ServeEngine``'s with the reference's codec calibrated from the
  reference model's activations, and its token agreement equal.
* ``train_with_compression`` at 6 steps, a checkpoint every 2 and a
  failure at step 3: the resumed run's losses are the uninterrupted
  run's exactly, and the gradient wire ratio is the reference's.
* ``edge_cloud_demo`` as two processes on free ports (``--smoke
  --device cpu``; with ``--tls --secret``; with ``--metrics-port 0
  --granularity tile2d --obs-events``): exit 0 and the OK line.

No fixed path is written: checkpoints and the demo's span logs go
under the tests' ``tmp_path``, the demo's TLS certificate to a fresh
temporary directory it removes, and the demo binds free ports.
"""

import dataclasses
import importlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytestmark = pytest.mark.timeout(300)

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ("quickstart", "split_inference", "train_with_compression",
            "edge_cloud_demo")
RATE_RTOL = 1e-5


def _env() -> dict:
    path = os.environ.get("PYTHONPATH")
    src = str(ROOT / "src")
    return dict(os.environ, JAX_PLATFORMS="cpu",
                PYTHONPATH=src if not path else os.pathsep.join([src, path]))


def _python(args, tmp_path, timeout=240):
    out = subprocess.run([sys.executable] + args, capture_output=True,
                         text=True, timeout=timeout, env=_env(), cwd=tmp_path)
    assert out.returncode == 0, out.stdout + out.stderr
    return out.stdout


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_import_runs_nothing(name, capsys):
    """Importing an example prints nothing and starts no work; each has
    a ``main(argv)`` taking ``--device``."""
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    assert callable(mod.main)
    assert capsys.readouterr().out == ""


def test_quickstart_prints_the_reference_lines(tmp_path):
    port = _python(["-m", "repro_torch.examples.quickstart", "--device",
                    "cpu"], tmp_path)
    ref = _python([str(ROOT / "examples" / "quickstart.py")], tmp_path)
    assert port.splitlines() == ref.splitlines()
    assert "N=2: 0.716 bits/elem" in port


def _reference_table(jcfg, jparams, dcfg, prompts, new_tokens):
    """The reference example's calibration and serving loop at a small
    size: {(granularity, N): (bits/element, token agreement)}."""
    import jax.numpy as jnp

    from repro.core import CodecConfig as JCodecConfig
    from repro.core import calibrate as jcalibrate
    from repro.core.stats import RunningStats as JRunningStats
    from repro.data import stream as jstream
    from repro.models import forward as jforward
    from repro.serving import Request as JRequest
    from repro.serving import ServeEngine as JServeEngine

    stats, probe, parts = JRunningStats(), {}, []

    def probe_fn(x):
        probe["x"] = x
        return x, 0.0

    for _, batch in zip(range(2), jstream(dcfg)):
        jforward(jcfg, jparams, jnp.asarray(batch["tokens"]),
                 codec_fn=probe_fn)
        arr = np.asarray(probe["x"], np.float32)
        stats.update(arr)
        parts.append(arr.reshape(-1, arr.shape[-1]))
    samples = np.concatenate(parts)

    def run_engine(codec=None):
        eng = JServeEngine(jcfg, jparams, slots=3, max_seq=64, codec=codec)
        reqs = [JRequest(prompt=p.copy(), max_new_tokens=new_tokens)
                for p in prompts]
        eng.generate(reqs)
        return [r.out_tokens for r in reqs], eng.rate_log

    ref_tokens, _ = run_engine()
    table = {}
    for granularity in ("tensor", "channel"):
        for n in (2, 3, 4, 8):
            ccfg = JCodecConfig(n_levels=n, clip_mode="model",
                                constrain_cmin_zero=False,
                                granularity=granularity, channel_axis=-1,
                                channel_group_size=8)
            if granularity == "tensor":
                codec = jcalibrate(ccfg, sample_mean=stats.mean,
                                   sample_var=stats.var)
            else:
                codec = jcalibrate(ccfg, samples=samples)
            toks, rates = run_engine(codec)
            agree = np.mean([np.mean(np.array(a) == np.array(b))
                             for a, b in zip(toks, ref_tokens)])
            table[granularity, n] = (float(np.mean(rates)), float(agree))
    return table


def test_split_inference_matches_the_reference_engine(capsys):
    import jax

    from repro import models as jm
    from repro.configs import ARCHS as JARCHS
    from repro.configs import reduced as jreduced
    from repro_torch.examples import split_inference as SI
    from repro_torch.models import params_from_numpy

    jcfg = dataclasses.replace(jreduced(JARCHS["codeqwen1.5-7b"]),
                               num_layers=4, vocab_size=256)
    jparams = jm.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = SI.model_config()
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                               device="cpu")
    dcfg = SI.data_config(cfg, batch=2, seq_len=16)
    stats, samples = SI.split_activations(cfg, params, dcfg, "cpu",
                                          batches=2)
    rows = SI.serve(cfg, params, stats, samples, "cpu", n_prompts=2,
                    prompt_len=6, new_tokens=4)
    out = capsys.readouterr().out
    assert "split serving: accuracy vs rate" in out
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=6).astype(np.int32)
               for _ in range(2)]
    want = _reference_table(jcfg, jparams, dcfg, prompts, 4)
    assert [(r["granularity"], r["n_levels"]) for r in rows] == list(want)
    for r in rows:
        bpe, agree = want[r["granularity"], r["n_levels"]]
        assert r["bits_per_elem"] == pytest.approx(bpe, rel=RATE_RTOL), r
        assert r["agreement"] == agree, r


def test_train_with_compression_resumes_exactly(tmp_path, capsys):
    from repro.compression import GradCompressionConfig as JGradCfg
    from repro.compression import wire_bytes_ratio as jwire_bytes_ratio
    from repro_torch.examples import train_with_compression as TW

    res = TW.run("cpu", ckpt_dir=str(tmp_path / "ckpt"), steps=6,
                 ckpt_every=2, fail_at=3, batch=2, seq_len=16)
    out = capsys.readouterr().out
    assert "injected failure at step 3 (checkpoint at step 2 survives)" \
        in out
    assert res["resumed_from"] == 2
    assert res["resumed"] == res["base"][2:]
    assert len(res["base"]) == len(res["compressed"]) == 6
    assert res["compressed"] != res["base"]
    assert res["wire_bytes_ratio"] == jwire_bytes_ratio(JGradCfg(n_levels=16))
    assert "gradient wire bytes: 0.125 of f32 (8x reduction)" in out


@pytest.mark.parametrize("flags", [
    [], ["--tls", "--secret", "s"],
    ["--metrics-port", "0", "--granularity", "tile2d", "--obs-events",
     "EVENTS"]], ids=["smoke", "tls", "metrics-tile2d"])
def test_edge_cloud_demo_two_processes(flags, tmp_path):
    flags = [str(tmp_path / "events.json") if f == "EVENTS" else f
             for f in flags]
    out = _python(["-m", "repro_torch.examples.edge_cloud_demo", "--smoke",
                   "--device", "cpu"] + flags, tmp_path)
    assert "[edge] OK: streamed cloud reconstruction is bit-exact" in out
    assert out.count("reconstruction bit-exact=True tail logits "
                     "match=True") == 2
    assert "[cloud] done: 2 sessions" in out
    if "--tls" in flags:
        assert "(TLS auth)" in out
    if "--metrics-port" in flags:
        assert "[edge] metrics scrape OK" in out
        assert (tmp_path / "events.json").exists()
        assert (tmp_path / "events.json.cloud.json").exists()
