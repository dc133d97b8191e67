"""The elementwise and reduction kernels' share of the card's busy time
(the encoder layers' eager LayerNorm, GELU, dropout and casts), in ms per
audio second of the window."""


def read(ctx):
    return 1e3 * ctx.trace.family_busy_s("elementwise", "reductions") / ctx.audio_s
