"""Device time, in ms per decode boundary, of the operations launched
inside the harness's ``bench.codec.decode`` ranges around the codec
hook (the quantizer's launch and the rate's arithmetic)."""

from bench import trace as TR


def read(ctx):
    if ctx.trace is None:
        return None
    dev_us, calls = TR.launched_in(ctx.trace, "bench.codec.decode")
    if calls == 0 or dev_us <= 0:
        return None
    return dev_us / calls / 1e3
