"""The part of ``idle_share.train`` spent in the distill dispatch's host
path: the share of the window in which one of ``feed.h2d``, ``step.plan``,
``step.stage``, ``step.replay`` or ``step.capture`` is open and no
operation runs on the card."""

from benchmark.lib.spans import DISPATCH, idle_while


def read(ctx):
    idle = idle_while(ctx.trace, DISPATCH)
    return None if idle is None else 100.0 * idle / ctx.window_s
