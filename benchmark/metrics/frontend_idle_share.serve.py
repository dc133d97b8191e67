"""The part of ``idle_share.serve`` that the serving host path's own work
causes: the share of the window in which one of the Predictor's
``predictor.pad``, ``.h2d``, ``.forward`` and ``.unpad`` spans is open and
no operation runs on the card."""

from benchmark.lib.spans import FRONTEND, idle_while


def read(ctx):
    idle = idle_while(ctx.trace, FRONTEND)
    return None if idle is None else 100.0 * idle / ctx.window_s
