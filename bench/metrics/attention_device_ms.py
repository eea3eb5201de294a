"""Device time, in ms per decode step, of the operations launched inside
the model's ``repro.attention`` ranges (every layer's attention mixer
and its output projection) within the engine's ``repro.decode`` ranges
of the traced window."""

from bench import program as PG


def read(ctx):
    return PG.per_step_ms(ctx, "attention")
