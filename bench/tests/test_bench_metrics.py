"""Each per-layer metric's reader on synthetic spans and
profiler events."""

import types

import pytest

from bench import roofline as RL
from bench import spec
from bench import trace as TR


def _events():
    """A Chrome trace: three decode ranges at 0, 100 and 200 us; four
    launches, three of them inside a range; their kernels; host ops."""
    ev = []
    for t in (0.0, 100.0, 200.0):
        ev.append({"ph": "X", "cat": "user_annotation",
                   "name": "bench.codec.decode", "ts": t, "dur": 10.0})
    for ts, corr in ((2.0, 1), (5.0, 2), (50.0, 3), (103.0, 4)):
        ev.append({"ph": "X", "cat": "cuda_runtime",
                   "name": "cudaLaunchKernel", "ts": ts, "dur": 1.0,
                   "args": {"correlation": corr}})
    for name, ts, dur, corr in (("quant", 20.0, 3.0, 1),
                                ("rate", 24.0, 4.0, 2),
                                ("gemm", 110.0, 50.0, 3),
                                ("quant", 170.0, 5.0, 4)):
        ev.append({"ph": "X", "cat": "kernel", "name": name, "ts": ts,
                   "dur": dur, "args": {"correlation": corr}})
    ev.append({"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 150.0,
               "dur": 40.0, "tid": 1})
    ev.append({"ph": "X", "cat": "cpu_op", "name": "aten::copy_",
               "ts": 160.0, "dur": 20.0, "tid": 1})
    ev.append({"ph": "i", "cat": "cpu_op", "name": "marker", "ts": 1.0})
    return ev


def _ctx(trace=None, window_s=2.0):
    rec = types.SimpleNamespace(
        decode_values=32 * 4096, flops=lambda model: 989e12)
    spans = [{"stage": "prefill", "dur_s": 0.25},
             {"stage": "prefill", "dur_s": 0.25},
             {"stage": "edge_stage", "dur_s": 9.0}]
    return types.SimpleNamespace(
        rec=rec, model={"dtype": "bfloat16"}, spans=spans, trace=trace,
        window_s=window_s,
        trace_window=TR.window(trace) if trace is not None else None)


def _read(name, ctx):
    return spec.metric_reader(name)(ctx)


def test_parse_sorts_the_event_kinds():
    tr = TR.parse(_events())
    assert [d[0] for d in tr.device] == ["quant", "rate", "gemm", "quant"]
    assert len(tr.launches) == 4 and len(tr.ranges) == 3
    assert [h[0] for h in tr.host] == ["aten::mm", "aten::copy_"]


def test_prefill_share_sums_the_prefill_spans():
    assert _read("prefill_share", _ctx()) == pytest.approx(25.0)
    assert _read("prefill_share", _ctx(window_s=5.0)) == pytest.approx(10.0)


def test_codec_device_time_counts_what_the_ranges_launched():
    # kernels of correlations 1, 2 and 4 (3 + 4 + 5 us) over 3 ranges
    ctx = _ctx(TR.parse(_events()))
    assert _read("codec_device_ms", ctx) == pytest.approx(12e-3 / 3)


def test_codec_roofline_is_the_byte_bound_over_that_time():
    ctx = _ctx(TR.parse(_events()))
    least = RL.codec_bytes(32 * 4096, {"dtype": "bfloat16"}) / 3.35e12
    assert _read("codec_roofline", ctx) \
        == pytest.approx(100 * least / 4e-6)


def test_step_mfu_is_the_count_over_the_peak():
    # 989e12 operations in a 2 s window: half the peak
    assert _read("step_mfu", _ctx()) == pytest.approx(50.0)


def test_device_idle_share_over_the_traced_window():
    # window 100..200 us (second to last range); busy: gemm 110-160,
    # quant 170-175
    ctx = _ctx(TR.parse(_events()))
    assert ctx.trace_window == (100.0, 200.0)
    assert _read("device_idle_share", ctx) == pytest.approx(45.0)


def test_readers_give_nothing_without_a_trace():
    ctx = _ctx()
    for name in ("codec_device_ms", "codec_roofline", "device_idle_share"):
        assert _read(name, ctx) is None
    empty = _ctx()
    empty.spans = []
    assert _read("prefill_share", empty) is None


def test_breakdown_of_the_traced_window():
    tr = TR.parse(_events())
    ops = dict(TR.top_device_ops(tr, 100.0, 200.0))
    assert ops == pytest.approx({"gemm": 50e-6, "quant": 5e-6})
    # gaps 100-110, 160-170 (inside aten::copy_, itself in aten::mm),
    # 175-200 (inside aten::mm until 190)
    gaps = dict(TR.idle_gaps(tr, 100.0, 200.0))
    assert gaps == pytest.approx({"host: no operation": 10e-6,
                                  "aten::copy_": 10e-6,
                                  "aten::mm": 25e-6})
