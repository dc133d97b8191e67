"""The distill step's model operations (the teacher's forward, the
student's forward and backward; ``lib/flops.py``) over the window's time,
as a share of the chip's bf16 peak."""


def read(ctx):
    return 100.0 * ctx.flops / (ctx.window_s * ctx.peak_flops)
