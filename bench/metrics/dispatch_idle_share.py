"""Share, in %, of the time inside the engine's ``repro.decode`` ranges
of the traced window in which no device operation ran: the model
step's own dispatch.  The rest of ``device_idle_share`` falls between
steps (scheduling, refill bookkeeping)."""

from bench import program as PG
from bench import trace as TR


def read(ctx):
    steps = PG.decode_steps(ctx)
    total = sum(b - a for a, b in steps)
    if total <= 0:
        return None
    busy = sum(TR.busy_us(ctx.trace, a, b) for a, b in steps)
    return 100.0 * (1.0 - busy / total)
