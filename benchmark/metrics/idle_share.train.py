"""The share of the window in which no operation ran on the card."""


def read(ctx):
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.window_s)
