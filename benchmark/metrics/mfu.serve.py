"""The served model's forward operations on the clips' valid lengths
(``lib/flops.py``) over the window's time, as a share of the chip's bf16
peak."""


def read(ctx):
    return 100.0 * ctx.flops / (ctx.window_s * ctx.peak_flops)
