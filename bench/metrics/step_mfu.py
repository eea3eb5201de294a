"""The model steps' share of the H100's bf16 peak over the window, in
%: the frozen count of the window's useful operations
(``Recorder.flops``: active parameters, attention over each request's
real context) over the window's host seconds times 989 TFLOP/s."""

from bench import roofline as RL


def read(ctx):
    flops = ctx.rec.flops(ctx.model)
    if flops <= 0:
        return None
    return 100.0 * flops / (ctx.window_s * RL.PEAK_BF16_FLOPS)
