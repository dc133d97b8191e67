"""The convolutions' share of the card's busy time (the feature extractor
and the positional conv, cuDNN), in ms per audio second of the window."""


def read(ctx):
    return 1e3 * ctx.trace.family_busy_s("conv") / ctx.audio_s
