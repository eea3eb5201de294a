"""The readers of the program's own spans and ``repro.*`` ranges on
synthetic spans and profiler events."""

import time
import types

import pytest

from bench import harness, spec
from bench import program as PG
from bench import trace as TR
from tiny_cells import tiny_cell

NEW = ("decode_step_ms", "attention_device_ms", "ffn_device_ms",
       "codec_launched_ms", "dispatch_idle_share", "refill_pad_share",
       "decode_attention_roofline")


def _x(cat, name, ts, dur, **kw):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": 1, **kw}


def _events():
    """Decode boundaries at 10, 120, 200, 270 and 330 us (the window
    is 120..330); decode steps 0-40, 100-150 and 310-360 (outside or
    straddling the window) and 170-230, 240-300 (inside); a refill
    between them whose prefill holds an attention range; launches and
    their kernels."""
    ev = [_x("user_annotation", "bench.codec.decode", t, 14.0)
          for t in (10.0, 120.0, 200.0, 270.0, 330.0)]
    for a, b in ((0, 40), (100, 150), (170, 230), (240, 300), (310, 360)):
        ev.append(_x("user_annotation", "repro.decode", a, b - a))
    for name, a, b in (("repro.attention", 102, 110),
                       ("repro.attention", 172, 180),
                       ("repro.ffn", 181, 189),
                       ("repro.attention", 190, 198),
                       ("repro.ffn", 199, 205),
                       ("repro.codec", 206, 212),
                       ("repro.refill", 231, 239),
                       ("repro.prefill", 232, 238),
                       ("repro.attention", 233, 236),
                       ("repro.attention", 242, 250),
                       ("repro.ffn", 251, 258),
                       ("repro.codec", 272, 278)):
        ev.append(_x("user_annotation", name, a, b - a))
    ev.append(_x("cpu_op", "aten::mm", 173.0, 6.0))
    # (launch time, correlation, kernel start, kernel length)
    for t, corr, ks, kd in ((104, 10, 104, 5), (171, 11, 171, 1),
                            (173, 1, 175, 10), (182, 3, 186, 4),
                            (191, 2, 192, 6), (200, 4, 200, 3),
                            (207, 5, 214, 2), (234, 9, 234, 3),
                            (243, 6, 244, 20), (252, 7, 265, 5),
                            (273, 8, 280, 4)):
        ev.append({"ph": "X", "cat": "cuda_runtime",
                   "name": "cudaLaunchKernel", "ts": t, "dur": 0.5,
                   "args": {"correlation": corr}})
        ev.append({"ph": "X", "cat": "kernel", "name": f"k{corr}",
                   "ts": ks, "dur": kd, "args": {"correlation": corr}})
    return ev


def _spans():
    return [{"span_id": 1, "parent_id": None, "stage": "prefill",
             "dur_s": 1.0, "batch": 48, "padded": 48_000, "prompt": 100},
            {"span_id": 2, "parent_id": None, "stage": "decode",
             "dur_s": 0.2, "active": 48, "pos": 1000},
            {"span_id": 3, "parent_id": None, "stage": "refill",
             "dur_s": 0.3},
            {"span_id": 4, "parent_id": 3, "stage": "prefill",
             "dur_s": 0.25, "batch": 1, "refill": True, "padded": 2000,
             "prompt": 1000},
            {"span_id": 5, "parent_id": None, "stage": "decode",
             "dur_s": 0.25, "active": 48, "pos": 1001},
            {"span_id": 6, "parent_id": None, "stage": "prefill",
             "dur_s": 0.25, "batch": 1, "refill": True, "padded": 2000,
             "prompt": 500},
            {"span_id": 7, "parent_id": None, "stage": "decode",
             "dur_s": 0.3, "active": 47, "pos": 1002},
            {"span_id": 8, "parent_id": None, "stage": "decode",
             "dur_s": 5.0, "active": 47, "pos": 1003,
             "error": "WindowClosed"}]


def _ctx(trace=None, spans=(), traced=(), model=None, rec=None):
    return types.SimpleNamespace(
        rec=rec, model=model or {"dtype": "bfloat16"}, spans=list(spans),
        traced_spans=list(traced), trace=trace, window_s=2.0,
        trace_window=TR.window(trace) if trace is not None else None)


def _read(name, ctx):
    return spec.metric_reader(name)(ctx)


def test_the_window_holds_two_whole_decode_steps():
    ctx = _ctx(TR.parse(_events()))
    assert ctx.trace_window == (120.0, 330.0)
    assert PG.decode_steps(ctx) == [(170.0, 230.0), (240.0, 300.0)]


def test_decode_step_ms_is_the_median_span():
    # the span the window's close cut short is left out
    assert _read("decode_step_ms", _ctx(spans=_spans())) \
        == pytest.approx(250.0)


def test_attention_counts_what_the_decode_steps_launched():
    # kernels 1, 2 and 6 (10 + 6 + 20 us) over two steps; not kernel 10
    # (a step straddling the window's start) nor 9 (inside a prefill)
    ctx = _ctx(TR.parse(_events()))
    assert _read("attention_device_ms", ctx) == pytest.approx(18e-3)


def test_ffn_counts_what_the_decode_steps_launched():
    ctx = _ctx(TR.parse(_events()))
    assert _read("ffn_device_ms", ctx) == pytest.approx((4 + 3 + 5) / 2e3)


def test_codec_launched_ms_is_per_boundary():
    ctx = _ctx(TR.parse(_events()))
    assert _read("codec_launched_ms", ctx) == pytest.approx((2 + 4) / 2e3)


def test_dispatch_idle_share_inside_the_decode_steps():
    # 170-230 busy 26 of 60 us (kernels 11, 1, 3, 2, 4, 5), 240-300
    # busy 29 of 60 (6, 7, 8)
    ctx = _ctx(TR.parse(_events()))
    assert _read("dispatch_idle_share", ctx) \
        == pytest.approx(100 * 65 / 120)


def test_refill_pad_share_over_the_refill_prefills():
    # 1500 prompt tokens of 4000 positions; the epoch's prefill is not
    # a refill
    assert _read("refill_pad_share", _ctx(spans=_spans())) \
        == pytest.approx(62.5)


def _roofline_ctx(n_spans=6):
    """``_events`` with kernel 1 (in the step 170-230) a
    ``decode_attn_mma``, kernel 6 (in the step 240-300) a
    ``combine_splits`` and kernel 10 (in the step 100-150, before the
    window) a ``decode_attn_mma``; the profiled part's decode spans at
    positions 100.. pair with the five decode ranges, the last cut by
    the window's close; two attention layers of one KV head of 4, in
    bf16; a decode boundary of 3 rows."""
    names = {"k1": "void decode_attn_mma<128>(bf16 const*)",
             "k6": "combine_splits(Sink, bf16*)",
             "k10": "void decode_attn_mma<128>(bf16 const*)"}
    events = [dict(e, name=names.get(e["name"], e["name"]))
              for e in _events()]
    spans = [{"stage": "decode", "t_start": 100.0 + i, "dur_s": 0.1,
              "active": 3, "pos": 100 + i} for i in range(n_spans)]
    spans[-1]["error"] = "WindowClosed"
    model = {"num_layers": 2, "d_model": 8, "num_heads": 2,
             "num_kv_heads": 1, "head_dim": 4, "dtype": "bfloat16"}
    return _ctx(TR.parse(events), traced=spans, model=model,
                rec=types.SimpleNamespace(decode_values=3 * 8))


def test_decode_attention_roofline_over_the_windows_steps():
    # steps at positions 102 and 103: K and V of 103 and 104 slots of 3
    # rows, 4 values of 2 bytes, in two layers, over kernels 1 and 6
    ctx = _roofline_ctx()
    assert PG.decode_positions(ctx)[(170.0, 230.0)] == 102
    read = 2 * 2 * 3 * (103 + 104) * 4 * 2
    assert _read("decode_attention_roofline", ctx) \
        == pytest.approx(100 * read / 3.35e12 / 30e-6)


@pytest.mark.parametrize("n_spans", [4, 7])
def test_decode_attention_roofline_needs_a_span_a_step(n_spans):
    # spans that do not pair with the trace's decode ranges
    assert _read("decode_attention_roofline", _roofline_ctx(n_spans)) \
        is None


def test_readers_give_nothing_without_a_trace_or_spans():
    for name in NEW:
        assert _read(name, _ctx()) is None
    # a trace and spans from a program without these spans and ranges
    bare = [e for e in _events() if not e["name"].startswith("repro.")]
    old = [{k: v for k, v in e.items() if k not in ("padded", "prompt")}
           for e in _spans() if e["stage"] == "prefill"]
    ctx = _ctx(TR.parse(bare), old)
    for name in NEW:
        assert _read(name, ctx) is None


def test_program_ranges_stay_with_the_host_operations():
    tr = TR.parse(_events())
    assert len(tr.ranges) == 5
    assert PG.ranges(tr, "codec") == [(206.0, 212.0), (272.0, 278.0)]
    assert PG.inside(PG.ranges(tr, "attention"), PG.decode_steps(
        _ctx(tr))) == [(172.0, 180.0), (190.0, 198.0), (242.0, 250.0)]


def test_idle_gaps_are_named_by_the_innermost_program_range():
    # the gaps of the step 170-230: 170-171 and 216-230 in the step
    # alone, 172-175 in aten::mm, 185-186 and 198-200 in an FFN range,
    # 190-192 in an attention range, 203-214 in the codec's
    tr = TR.parse(_events())
    gaps = dict(TR.idle_gaps(tr, 170.0, 230.0))
    assert gaps == pytest.approx({"repro.decode": 15e-6,
                                  "aten::mm": 3e-6,
                                  "repro.ffn": 3e-6,
                                  "repro.attention": 2e-6,
                                  "repro.codec": 11e-6})


def test_traced_cpu_run_reads_the_program_spans():
    # no card: what the profiler's trace gives has nothing to read; the
    # engine's spans do
    res = harness.run_cell(tiny_cell("codeqwen1.5-7b.long-decode"), 5, 0.5,
                           True, "cpu", time.perf_counter())
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(m) == {"prefill_share", "step_mfu", "decode_step_ms",
                      "refill_pad_share"}
    assert m["decode_step_ms"] > 0
    assert 0 <= m["refill_pad_share"] < 100
