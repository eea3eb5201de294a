"""The codec's share of its roofline at a decode boundary, in %: the
frozen byte count of one call at the boundary's size
(``bench.roofline.codec_bytes``) over the H100's HBM bandwidth, divided
by the device time ``codec_device_ms`` reads."""

from bench import roofline as RL

from . import codec_device_ms


def read(ctx):
    ms = codec_device_ms.read(ctx)
    if ms is None:
        return None
    least_s = RL.codec_bytes(ctx.rec.decode_values, ctx.model) \
        / RL.PEAK_HBM_BYTES_PER_S
    return 100.0 * least_s / (ms / 1e3)
