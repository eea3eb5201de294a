"""The program's own ranges in the traced window.

While a ``torch.profiler`` session records, each of the port's tracing
spans is also a ``repro.<stage>`` range of the profiler's trace
(``decode``, ``refill``, ``prefill`` in the engine), and the model and
codec mark ``repro.attention``, ``repro.ffn`` and ``repro.codec``
ranges (``repro_torch.obs.tracing``).  ``trace.parse`` files them with
the host operations; the readers here pick them out by name.  A range
is a (start, end) pair in microseconds on the trace's clock.
"""

from __future__ import annotations

import bisect

from . import trace as TR


def ranges(trace: TR.Trace, name: str) -> list:
    """The ``repro.<name>`` ranges, by start."""
    full = "repro." + name
    return sorted((s, s + d) for n, s, d, _ in trace.host if n == full)


def inside(inner: list, outer: list) -> list:
    """The ranges of ``inner`` that lie wholly inside one of ``outer``
    (both by start; ranges of one name do not overlap)."""
    starts = [a for a, _ in outer]
    out = []
    for a, b in inner:
        i = bisect.bisect_right(starts, a) - 1
        if i >= 0 and b <= outer[i][1]:
            out.append((a, b))
    return out


def decode_steps(ctx) -> list:
    """The ``repro.decode`` ranges wholly inside the traced window."""
    if ctx.trace is None or ctx.trace_window is None:
        return []
    t0, t1 = ctx.trace_window
    return inside(ranges(ctx.trace, "decode"), [(t0, t1)])


def launched_us(trace: TR.Trace, spans: list, names=()) -> float:
    """Device microseconds of the operations launched inside ``spans``
    (by start, not overlapping), matched by correlation; with ``names``,
    of those whose name holds one of them."""
    starts = [a for a, _ in spans]
    corr = set()
    for t, c in trace.launches:
        i = bisect.bisect_right(starts, t) - 1
        if c is not None and i >= 0 and t <= spans[i][1]:
            corr.add(c)
    return sum(d for n, _, d, c in trace.device if c in corr
               and (not names or any(k in n for k in names)))


def decode_positions(ctx) -> dict:
    """The position of each ``repro.decode`` range of the trace, from
    the engine's ``decode`` span of the same step.  A span is a range
    only where the profiler recorded at its start, so the profiled
    part's spans and the trace's ranges, each in order, begin at the
    same step; the last span may have no range (the profiler stopped
    inside it).  Empty where the two do not pair so."""
    if ctx.trace is None:
        return {}
    steps = ranges(ctx.trace, "decode")
    spans = sorted((e for e in ctx.traced_spans if e["stage"] == "decode"),
                   key=lambda e: e["t_start"])
    if not len(steps) <= len(spans) <= len(steps) + 1:
        return {}
    return {r: e["pos"] for r, e in zip(steps, spans)}


def per_step_ms(ctx, name: str, per_range: bool = False):
    """Device ms launched inside the ``repro.<name>`` ranges of the
    window's decode steps, per step (per range with ``per_range``);
    None where the window holds no such range."""
    steps = decode_steps(ctx)
    if not steps:
        return None
    spans = inside(ranges(ctx.trace, name), steps)
    if not spans:
        return None
    return launched_us(ctx.trace, spans) / len(
        spans if per_range else steps) / 1e3
