"""The serving host path's own busy time: the union of the Predictor's
``predictor.pad``, ``.h2d``, ``.forward`` (the enqueue) and ``.unpad``
spans, the readback's wait for the card left out, in ms per audio second
of the window."""

from benchmark.lib.spans import FRONTEND, opened
from benchmark.lib.trace import union


def read(ctx):
    spans = opened(ctx.trace, FRONTEND)
    return None if spans is None else 1e3 * union(spans) / ctx.audio_s
