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


def launched_us(trace: TR.Trace, spans: list) -> float:
    """Device microseconds of the operations launched inside ``spans``
    (by start, not overlapping), matched by correlation."""
    starts = [a for a, _ in spans]
    corr = set()
    for t, c in trace.launches:
        i = bisect.bisect_right(starts, t) - 1
        if c is not None and i >= 0 and t <= spans[i][1]:
            corr.add(c)
    return sum(d for _, _, d, c in trace.device if c in corr)


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
