"""Median length, in ms, of the engine's ``decode`` spans in the window:
one batched decode step, from the token upload through the next tokens
on the host, traced with a device sync at each end (where the step
waits anyway).  A step that carries a refill counts without it."""

import statistics


def read(ctx):
    spans = [e["dur_s"] for e in ctx.spans
             if e["stage"] == "decode" and "error" not in e]
    if not spans:
        return None
    return 1e3 * statistics.median(spans)
