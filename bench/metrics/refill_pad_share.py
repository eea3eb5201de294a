"""Share, in %, of the positions the window's refill prefills computed
that were left padding: 1 minus the real prompt tokens over the
positions computed, summed over the engine's refill ``prefill`` spans
(their ``prompt`` and ``padded`` attributes)."""


def read(ctx):
    spans = [e for e in ctx.spans if e["stage"] == "prefill"
             and e.get("refill") and "padded" in e and "prompt" in e]
    padded = sum(e["padded"] for e in spans)
    if padded <= 0:
        return None
    return 100.0 * (1.0 - sum(e["prompt"] for e in spans) / padded)
