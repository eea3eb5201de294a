"""Device time, in ms per decode boundary, of the operations launched
inside the codec's own ``repro.codec`` ranges (the pass of
``FeatureCodec.quantize_with_rate``) within the engine's
``repro.decode`` ranges of the traced window: the program-side twin of
``codec_device_ms``, which reads the harness's range around the hook."""

from bench import program as PG


def read(ctx):
    return PG.per_step_ms(ctx, "codec", per_range=True)
