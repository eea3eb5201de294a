"""The decode-attention kernel's share of its roofline in the window's
decode steps, in %: the frozen bytes of its calls (``attn.decode_bytes``:
the K and V of every row's valid cache slots, read once, in each
attention layer, at each step's position from the engine's ``decode``
span) over the H100's HBM bandwidth, divided by the device time of the
``decode_attn_mma`` and ``combine_splits`` kernels launched inside the
engine's ``repro.decode`` ranges of the traced window."""

from bench import layers as L
from bench import program as PG
from bench import roofline as RL

KERNELS = ("decode_attn_mma", "combine_splits")


def read(ctx):
    steps = PG.decode_steps(ctx)
    pos = PG.decode_positions(ctx)
    if not steps or any(s not in pos for s in steps):
        return None
    dev_us = PG.launched_us(ctx.trace, steps, KERNELS)
    if dev_us <= 0:
        return None
    attn = L.module("attn")
    specs = [s for s in L.layer_specs(ctx.model) if s["kind"] == "attn"]
    # the decode boundary is (rows, 1, d_model)
    rows = ctx.rec.decode_values // ctx.model["d_model"]
    read_bytes = sum(attn.decode_bytes(ctx.model, s, rows, pos[step])
                     for step in steps for s in specs)
    return 100.0 * read_bytes / RL.PEAK_HBM_BYTES_PER_S / (dev_us * 1e-6)
