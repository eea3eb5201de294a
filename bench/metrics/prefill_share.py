"""Share of the window, in %, inside the engine's own ``prefill`` spans
(the opening and refill prefills; traced with a device synchronisation
at each end, so a span holds its prefill's device work)."""


def read(ctx):
    spans = [e["dur_s"] for e in ctx.spans if e["stage"] == "prefill"]
    if not spans:
        return None
    return 100.0 * sum(spans) / ctx.window_s
