"""Share of the traced window, in %, in which no device operation ran:
1 minus the union of the profiler's kernel, copy and fill intervals,
from the first to the last decode boundary traced."""

from bench import trace as TR


def read(ctx):
    if ctx.trace_window is None:
        return None
    t0, t1 = ctx.trace_window
    return 100.0 * (1.0 - TR.busy_us(ctx.trace, t0, t1) / (t1 - t0))
