"""Device time, in ms per decode step, of the operations launched inside
the model's ``repro.ffn`` ranges (every layer's MLP, expert layer or
channel mix) within the engine's ``repro.decode`` ranges of the traced
window."""

from bench import program as PG


def read(ctx):
    return PG.per_step_ms(ctx, "ffn")
