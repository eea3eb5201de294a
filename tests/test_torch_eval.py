"""Port vs reference: the accuracy harness, its scenarios, the split-point
selector and the CLI, on the CPU.

The port's model takes the reference's random weights (its harness's
``init_params`` patched to ``params_from_numpy`` of the reference's
tree); the port's codec runs the torch backend, the reference's the jnp
backend, both on the same float32 boundaries.

Tolerances:
- Given the reference's boundary tensors: every payload byte-identical,
  so ``bits_per_elem`` identical.
- End to end from the tokens (the two models' boundaries agree to
  ~1e-6, so a calibrated range can move an index at a bin edge):
  ``degradation`` and ``raw_degradation`` within one token of the
  scored count (measured: equal); ``bits_per_elem`` and ``logit_rmse``
  rtol 2e-3 (measured: at most 1e-3 and 6e-4, both at the 256-level
  rung, where a moved index changes the coded bytes and the small
  rmse most).
- ``head_flops``: equal.
"""

import dataclasses
import json
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro import eval as jeval
from repro import models as jm
from repro.core import calibrate as jcalibrate
from repro.eval import harness as jharness
from repro_torch import eval as teval
from repro_torch import models as tm
from repro_torch.core import calibrate
from repro_torch.eval import harness as tharness
from repro_torch.eval import selector as tselector

DEFAULT = list(jeval.DEFAULT_MATRIX)
BYTE_CASES = [(name, clip, rung)
              for name in ("transformer-tensor", "transformer-channel",
                           "transformer-tile2d")
              for clip in jeval.SCENARIOS[name].clip_modes
              for rung in jeval.SCENARIOS[name].rungs]


@pytest.fixture
def reference_weights(monkeypatch):
    """Patch the port harness's ``init_params`` to the reference's
    weights of the same config and seed (the generator's)."""
    configs = {repr(s.model_config()): s.model_config()
               for s in jeval.SCENARIOS.values()}
    trees = {}

    def init_params(cfg, generator, *, device):
        key = (repr(cfg), generator.initial_seed())
        if key not in trees:
            trees[key] = jax.tree.map(np.asarray, jm.init_params(
                configs[key[0]], jax.random.PRNGKey(key[1])))
        return tm.params_from_numpy(cfg, trees[key], device=device)

    monkeypatch.setattr(tharness.models, "init_params", init_params)


# -- scenarios -----------------------------------------------------------------

def _blobs():
    """Scenario dicts both packages are given: every registered scenario,
    and variants each check of the schema should accept or refuse."""
    base = json.loads(jeval.SCENARIOS["transformer-tensor"].to_json())
    out = [json.loads(s.to_json()) for s in jeval.SCENARIOS.values()]
    edits = [
        {"name": ""}, {"arch": "no-such-arch"}, {"arch": "musicgen-large"},
        {"n_periods": 1}, {"split_after": 4}, {"split_after": 2},
        {"seq_len": 0}, {"rungs": []}, {"rungs": [256, 1]},
        {"rungs": [16, 16]}, {"rungs": [4, 16]}, {"clip_modes": []},
        {"clip_modes": ["minmax", "bogus"]}, {"clip_modes": ["aciq"]},
        {"granularity": "bogus"}, {"granularity": "tile2d"},
        {"granularity": "tile2d", "spatial_block_hw": [2, 8],
         "channel_group_size": 8},
        {"spatial_block_hw": [2, 8]}, {"transport": "udp"},
        {"calib_sample_cap": -1}, {"calib_sample_cap": 64},
        {"use_ecsq": True}, {"bogus_field": 1}, {"decisive_margin": 0.2},
    ]
    return out + [dict(base, **e) for e in edits]


@pytest.mark.parametrize("blob", _blobs(), ids=lambda b: json.dumps(b)[:60])
def test_from_json_accepts_what_the_reference_accepts(blob):
    def load(mod):
        try:
            return mod.Scenario.from_json(json.dumps(blob)).to_json(), None
        except (ValueError, KeyError) as e:
            return None, (type(e), str(e))

    assert load(teval) == load(jeval)


def test_scenario_schema_and_registry_match():
    assert [(f.name, f.default) for f in dataclasses.fields(teval.Scenario)] \
        == [(f.name, f.default) for f in dataclasses.fields(jeval.Scenario)]
    for name in ("CLIP_MODES", "DEFAULT_MATRIX", "GRANULARITIES",
                 "TRANSPORTS"):
        assert getattr(teval, name) == getattr(jeval, name)
    assert sorted(teval.__all__) == sorted(jeval.__all__)
    for spec in ("default", "all", "rwkv-state, moe-expert"):
        assert [s.to_json() for s in teval.load_matrix(spec)] == \
            [s.to_json() for s in jeval.load_matrix(spec)]
    for name, sc in teval.SCENARIOS.items():
        assert repr(sc.model_config()) == \
            repr(jeval.SCENARIOS[name].model_config())
        assert sc.split_points == jeval.SCENARIOS[name].split_points


def test_codec_config_for_maps_every_scenario_alike():
    for name, sc in teval.SCENARIOS.items():
        for clip in sc.clip_modes:
            for rung in sc.rungs:
                assert dataclasses.asdict(teval.codec_config_for(
                    sc, rung, clip, backend="torch")) == \
                    dataclasses.asdict(jeval.codec_config_for(
                        jeval.SCENARIOS[name], rung, clip,
                        backend="torch")), (name, clip, rung)


# -- the round trip on the reference's boundaries --------------------------------

@pytest.fixture(scope="module")
def reference_boundaries():
    """name -> (eval boundaries, calibration boundary) of the reference
    model, float32 numpy, as the reference harness makes them."""
    out = {}
    for name in {c[0] for c in BYTE_CASES}:
        sc = jeval.SCENARIOS[name]
        cfg = sc.model_config()
        params = jm.init_params(cfg, jax.random.PRNGKey(sc.seed))
        ev, cal = jharness._token_batches(sc, cfg.vocab_size)
        head = jax.jit(lambda p, t, cfg=cfg: jm.forward_head(cfg, p, t))
        out[name] = ([np.asarray(head(params, t), np.float32) for t in ev],
                     np.asarray(head(params, cal), np.float32))
    return out


@pytest.mark.parametrize("name,clip,rung", BYTE_CASES)
def test_coded_bytes_identical_on_reference_boundaries(reference_boundaries,
                                                       name, clip, rung):
    boundaries, cal = reference_boundaries[name]
    jcodec = jcalibrate(jeval.codec_config_for(
        jeval.SCENARIOS[name], rung, clip, backend="jnp"), cal)
    tcodec = calibrate(teval.codec_config_for(
        teval.SCENARIOS[name], rung, clip, backend="torch"), cal)
    for b in boundaries:
        jpay = list(jcodec.encode_stream(b))
        tpay = list(tcodec.encode_stream(b))
        assert tpay == jpay
        jrec, jbytes = jharness._roundtrip_inproc(jcodec, b)
        trec, tbytes = tharness._roundtrip_inproc(tcodec, b)
        assert tbytes == jbytes == sum(map(len, jpay))
        np.testing.assert_array_equal(trec.reshape(b.shape),
                                      np.asarray(jrec).reshape(b.shape))


# -- end to end ------------------------------------------------------------------

@pytest.mark.parametrize("name", DEFAULT)
def test_run_scenario_matches_reference(reference_weights, name):
    ref = jeval.run_scenario(jeval.SCENARIOS[name], backend="jnp")
    rep = teval.run_scenario(teval.SCENARIOS[name], backend="torch",
                             device="cpu")
    assert (rep.split_after, rep.n_tokens) == (ref.split_after, ref.n_tokens)
    assert len(rep.cases) == len(ref.cases) == 6
    for c, r in zip(rep.cases, ref.cases):
        assert (c.rung, c.clip_mode, c.n_elems, c.n_decisive) == \
            (r.rung, r.clip_mode, r.n_elems, r.n_decisive)
        assert abs(c.degradation - r.degradation) <= 1.0 / r.n_decisive
        assert abs(c.raw_degradation - r.raw_degradation) \
            <= 1.0 / ref.n_tokens
        np.testing.assert_allclose(c.bits_per_elem, r.bits_per_elem,
                                   rtol=2e-3)
        np.testing.assert_allclose(c.logit_rmse, r.logit_rmse, rtol=2e-3)
        assert c.bits_per_elem == c.coded_bytes * 8.0 / c.n_elems
    assert json.loads(json.dumps(rep.to_dict()))["cases"][0]["scenario"] \
        == name


@pytest.mark.parametrize("name", DEFAULT)
def test_head_flops_equal_reference(name):
    sc = teval.SCENARIOS[name]
    port = [tselector.head_flops(sc, sa, device="cpu")
            for sa in sc.split_points]
    ref = [jeval.head_flops(jeval.SCENARIOS[name], sa)
           for sa in sc.split_points]
    assert port == ref


def test_select_split_point_picks_the_reference_tap(reference_weights):
    """At the paper's 1% budget no tap of the smoke model qualifies (its
    worst case, N=4, degrades 0.77-0.86), so both select with a budget of
    0.82, which admits taps 2 and 3 of the reference and not tap 1."""
    sc = "transformer-tensor"
    ref = jeval.select_split_point(jeval.SCENARIOS[sc], budget=0.82,
                                   backend="jnp")
    sel = teval.select_split_point(teval.SCENARIOS[sc], budget=0.82,
                                   backend="torch", device="cpu")
    assert [c.meets_budget for c in ref.candidates] == [False, True, True]
    assert sel.chosen.split_after == ref.chosen.split_after == 2
    for c, r in zip(sel.candidates, ref.candidates):
        assert (c.split_after, c.head_flops, c.meets_budget) == \
            (r.split_after, r.head_flops, r.meets_budget)
        assert abs(c.worst_degradation - r.worst_degradation) <= \
            1.0 / r.report.cases[0].n_decisive


def test_loopback_scenario_not_ported_yet():
    with pytest.raises(NotImplementedError, match="A2"):
        teval.run_scenario(teval.SCENARIOS["transformer-loopback"],
                           backend="torch", device="cpu")
    from repro_torch.launch import eval_accuracy
    with pytest.raises(NotImplementedError, match="loopback"):
        eval_accuracy.main(["--matrix", "transformer-loopback",
                            "--backend", "torch", "--device", "cpu"])


def test_harness_runs_on_the_card_unless_the_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    sc = teval.SCENARIOS["transformer-tensor"]
    with pytest.raises(RuntimeError, match="CUDA"):
        teval.run_scenario(sc, backend="torch")
    with pytest.raises(RuntimeError, match="CUDA"):
        tselector.head_flops(sc, 1)
    # the CPU model with the default (CUDA) quantizer backend raises too
    with pytest.raises(RuntimeError, match="CUDA"):
        teval.run_scenario(sc, device="cpu")


def test_cli_on_cpu(tmp_path):
    out = tmp_path / "report.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.eval_accuracy",
         "--matrix", "transformer-tensor", "--backend", "torch",
         "--device", "cpu", "--out", str(out)],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "scenario=transformer-tensor split_after=1" in proc.stdout
    rep = json.loads(out.read_text())
    assert rep["matrix"] == ["transformer-tensor"]
    cases = rep["reports"]["transformer-tensor"]["cases"]
    assert [(c["clip_mode"], c["rung"]) for c in cases] == [
        (m, r) for m in ("minmax", "empirical") for r in (256, 16, 4)]
    assert all(np.isfinite(c["logit_rmse"]) for c in cases)
