"""The port's tracer in the serving engine and the model step (CPU).

With tracing off the engine records no span and opens no profiler
range; with tracing on it records a ``decode`` span a step and a
``refill`` span a refill around that refill's ``prefill``; under a
``torch.profiler`` session every span is a ``repro.<stage>`` range and
the model and codec mark ``repro.attention``, ``repro.ffn`` and
``repro.codec`` ranges inside them.
"""

import inspect
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import models as tm
from repro_torch.configs import get_config, reduced
from repro_torch.core import CodecConfig, calibrate
from repro_torch.obs import tracing
from repro_torch.obs.tracing import (_NULL_SPAN, Tracer, configure_tracing,
                                     tracer)
from repro_torch.serving import Request, ServeEngine

LAYERS = 4
# (prompt length, new tokens): two open the epoch at position 4; the
# first retires after two tokens and the third is refilled at position 5
REQUESTS = [(4, 2), (4, 5), (3, 3)]


@pytest.fixture(scope="module")
def model():
    cfg = reduced(get_config("codeqwen1.5-7b"), layers=LAYERS)
    params = tm.init_params(cfg, torch.Generator("cpu").manual_seed(0),
                            device="cpu")
    codec = calibrate(CodecConfig(backend="torch", n_levels=4,
                                  clip_mode="manual", manual_cmin=-2.0,
                                  manual_cmax=2.0))
    return cfg, params, codec


@pytest.fixture
def tr():
    """The process tracer, emptied, and put back as it was after."""
    t = tracer()
    saved = (t.enabled, t.sync)
    t.reset()
    yield t
    t.configure(enabled=saved[0], sync=saved[1])
    t.reset()


class _Counter:
    def __init__(self):
        self.n = 0

    def __call__(self, *args, **kwargs):
        self.n += 1


class _FakeRange:
    """Stands in for ``record_function``: logs entries and exits."""

    log: list = []

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.log.append(("enter", self.name))
        return self

    def __exit__(self, *exc):
        self.log.append(("exit", self.name))
        return False


def _serve(model, **kw):
    cfg, params, codec = model
    eng = ServeEngine(cfg, params, slots=2, max_seq=16, codec=codec,
                      device="cpu", **kw)
    rng = np.random.default_rng(0)
    reqs = [Request(rng.integers(0, cfg.vocab_size, p).astype(np.int32),
                    max_new_tokens=n) for p, n in REQUESTS]
    eng.generate(reqs)
    assert all(r.done for r in reqs)
    return eng, reqs


def _fake_profiler(monkeypatch):
    """Make every profiler check read "recording" and log the ranges."""
    _FakeRange.log = []
    monkeypatch.setattr(torch.autograd, "_profiler_enabled", lambda: True)
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        _FakeRange)


def test_tracing_off_records_nothing_and_opens_no_range(model, tr,
                                                        monkeypatch):
    sync = _Counter()
    tr.configure(enabled=False, sync=sync)
    _fake_profiler(monkeypatch)
    eng, _ = _serve(model)
    assert eng.counters["steps"] > 0 and eng.counters["refills"] == 1
    assert tr.snapshot_events() == []
    assert _FakeRange.log == [] and sync.n == 0


def test_spans_of_the_engine_without_a_profiler(model, tr, monkeypatch):
    sync = _Counter()
    tr.configure(enabled=True, sync=sync)
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        _FakeRange)
    _FakeRange.log = []
    eng, reqs = _serve(model)
    events = tr.snapshot_events()
    by_stage: dict = {}
    for e in events:
        by_stage.setdefault(e["stage"], []).append(e)
    c = eng.counters
    assert len(by_stage["decode"]) == c["steps"]
    assert len(by_stage["refill"]) == c["refills"] == 1
    assert len(by_stage["prefill"]) == c["prefills"] == 2
    refill = by_stage["refill"][0]
    inner = [e for e in by_stage["prefill"]
             if e["parent_id"] == refill["span_id"]]
    assert len(inner) == 1 and inner[0]["refill"]
    assert inner[0]["prompt"] == len(reqs[2].prompt) == 3
    # the refill left-pads to the shared position, the next step's
    assert inner[0]["padded"] == 5
    after = min((e for e in by_stage["decode"]
                 if e["t_start"] > refill["t_start"]),
                key=lambda e: e["t_start"])
    assert after["pos"] == inner[0]["padded"]
    assert [e["pos"] for e in by_stage["decode"]] \
        == sorted(e["pos"] for e in by_stage["decode"])
    assert all(1 <= e["active"] <= 2 for e in by_stage["decode"])
    epoch = [e for e in by_stage["prefill"] if not e.get("refill")][0]
    assert (epoch["padded"], epoch["prompt"]) == (2 * 4, 8)
    # two syncs a span, none from the model's and codec's annotations,
    # and no range without a profiler
    assert sync.n == 2 * len(events)
    assert _FakeRange.log == []


def _ranges(path) -> list:
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    return sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                  if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                  and e["name"].startswith("repro."))


def _within(ranges, outer, name):
    a, b, _ = outer
    return [r for r in ranges if r[2] == name and a <= r[0] and r[1] <= b]


def test_ranges_in_the_profilers_trace(model, tr, tmp_path):
    tr.configure(enabled=True, sync=None)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng, _ = _serve(model)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    ranges = _ranges(tmp_path / "trace.json")
    names = {r[2] for r in ranges}
    assert {"repro.decode", "repro.refill", "repro.prefill",
            "repro.attention", "repro.ffn", "repro.codec"} <= names
    c = eng.counters
    decodes = [r for r in ranges if r[2] == "repro.decode"]
    prefills = [r for r in ranges if r[2] == "repro.prefill"]
    refills = [r for r in ranges if r[2] == "repro.refill"]
    assert (len(decodes), len(refills), len(prefills)) \
        == (c["steps"], c["refills"], c["prefills"])
    assert len(_within(ranges, refills[0], "repro.prefill")) == 1
    for step in decodes + prefills:
        assert len(_within(ranges, step, "repro.attention")) == LAYERS
        assert len(_within(ranges, step, "repro.ffn")) == LAYERS
        # one boundary a step: the codec's pass
        assert len(_within(ranges, step, "repro.codec")) == 1
    # every annotation lies in a step
    steps = decodes + prefills
    for r in ranges:
        if r[2] in ("repro.attention", "repro.ffn", "repro.codec"):
            assert any(a <= r[0] and r[1] <= b for a, b, _ in steps)


def test_annotate_is_the_null_span_without_a_profiler(tr, monkeypatch):
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        _FakeRange)
    _FakeRange.log = []
    tr.configure(enabled=False)
    assert tr.annotate("repro.x") is _NULL_SPAN
    tr.configure(enabled=True)
    assert not torch.autograd._profiler_enabled()
    assert tr.annotate("repro.x") is _NULL_SPAN
    with tr.span("quiet"):
        pass
    assert _FakeRange.log == []


def test_a_spans_range_holds_its_closing_sync(tr, monkeypatch):
    _fake_profiler(monkeypatch)
    tr.configure(enabled=True,
                 sync=lambda: _FakeRange.log.append(("sync", None)))
    with tr.span("step"):
        with tr.annotate("repro.inner"):
            pass
    assert _FakeRange.log == [("sync", None), ("enter", "repro.step"),
                              ("enter", "repro.inner"),
                              ("exit", "repro.inner"),
                              ("sync", None), ("exit", "repro.step")]


def test_annotate_records_under_the_profiler(tr, tmp_path):
    tr.configure(enabled=True, sync=None)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.annotate("repro.marked"):
            torch.ones(4).sum()
    tr.configure(enabled=False)
    with profile(activities=[ProfilerActivity.CPU]) as off:
        with tr.annotate("repro.unmarked"):
            torch.ones(4).sum()
    prof.export_chrome_trace(str(tmp_path / "on.json"))
    off.export_chrome_trace(str(tmp_path / "off.json"))
    assert [r[2] for r in _ranges(tmp_path / "on.json")] == ["repro.marked"]
    assert _ranges(tmp_path / "off.json") == []
    assert tr.snapshot_events() == []


def test_the_profiler_flag_is_gone():
    assert not hasattr(Tracer(), "profiler_trace")
    with pytest.raises(TypeError):
        configure_tracing(profiler_trace=True)
    assert "REPRO_OBS_PROFILER_TRACE" not in inspect.getsource(tracing)


def test_engine_keeps_no_latency_percentile_gauges(model):
    eng, _ = _serve(model)
    assert not any("latency_p" in k for k in eng.counters)
    text = eng.metrics.render()
    assert "repro_engine_request_latency_p50_seconds" not in text
    assert "repro_engine_request_latency_p99_seconds" not in text
    assert "repro_engine_request_latency_seconds_count 3" in text
