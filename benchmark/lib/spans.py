"""The program's own host ranges in a traced window
(``dphubert_torch.utils.profiling.span``): how long a set of them was open,
and how long the card was idle while one of them was.

A program without these spans (a commit before them) has none in the
trace: ``opened`` then returns None, and so do the metrics that read it.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

from .trace import gaps

# the serving host path's own work: the readback, which waits for the
# card, left out
FRONTEND = ("predictor.pad", "predictor.h2d", "predictor.forward", "predictor.unpad")
# one K-step dispatch's host path: the feed's copies, the plan, the staging
# copies, the replay's launch and a new key's capture
DISPATCH = ("feed.h2d", "step.plan", "step.stage", "step.replay", "step.capture")

Interval = Tuple[float, float]


def opened(trace, names: Iterable[str]) -> Optional[List[Interval]]:
    """The host ranges named ``names``, clipped to the window; None if the
    trace holds no range of those names."""
    names = set(names)
    found = [(s, e) for n, s, e in trace.host if n in names]
    if not found:
        return None
    return [(max(s, trace.start), min(e, trace.end)) for s, e in found
            if e > trace.start and s < trace.end]


def merged(intervals: Iterable[Interval]) -> List[Interval]:
    """The union of intervals as sorted, disjoint intervals."""
    out: List[Interval] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        elif e > s:
            out.append((s, e))
    return out


def overlap(a: List[Interval], b: List[Interval]) -> float:
    """The length of the intersection of two sorted, disjoint lists."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_while(trace, names: Iterable[str]) -> Optional[float]:
    """Seconds of the window in which a range of ``names`` is open and no
    operation runs on the card; None if the trace has no such range."""
    spans = opened(trace, names)
    if spans is None:
        return None
    idle = gaps([(s, e) for _, s, e in trace.ops], trace.start, trace.end)
    return overlap(merged(spans), idle)
