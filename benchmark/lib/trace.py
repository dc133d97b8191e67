"""Reading the device's time from a ``torch.profiler`` trace of the window.

The busy time is the union of the intervals in which an operation ran on the
card (kernels, copies, sets); time that operations share is split equally
among them (``busy_shares``), so each family's share of the busy time sums
to it.  Kernels are put in families by a name's substrings, the convolution
markers checked before the matmul ones: cuDNN's implicit-GEMM convolutions
(``*fprop_implicit_gemm*``) and its cutlass kernels are convolutions.  The
arithmetic is a frozen copy of the program's profiling helpers, with that
order corrected.

Events come from the profiler's raw results, not its event tree, and no
trace file is written.
"""

from __future__ import annotations

import contextlib
import heapq
import re
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Iterable, List, Tuple

import torch

WINDOW = "bench.window"  # the record_function range around the measured window

FAMILIES = (
    ("attention", ("attention_fwd_", "attention_bwd_", "wavlm_")),
    ("conv", ("cudnn", "fprop", "dgrad", "wgrad", "implicit", "conv")),
    ("matmul", ("gemm", "nvjet", "cublas", "cutlass")),
    ("random", ("distribution", "philox", "random", "bernoulli")),
    ("optimizer", ("multi_tensor", "foreach")),
    ("reductions", ("reduce", "norm")),
    ("memcpy", ("memcpy", "memset")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "loops", "copy")),
)
_CONV_FALSE = re.compile(r"convert")


def family(name: str) -> str:
    """The family of a device operation's name, or "other"."""
    low = _CONV_FALSE.sub("", name.lower())
    for label, keys in FAMILIES:
        if any(k in low for k in keys):
            return label
    return "other"


def union(intervals: Iterable[Tuple[float, float]]) -> float:
    """The length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def busy_shares(intervals: List[Tuple[float, float]]) -> List[float]:
    """Each interval's share of the union: every stretch of time is split
    equally among the intervals that cover it, so the shares sum to
    ``union``."""
    points = sorted((t, d, i) for i, (s, e) in enumerate(intervals) if e > s
                    for t, d in ((s, 1), (e, -1)))  # an end sorts before a start
    shares, active, last = [0.0] * len(intervals), set(), 0.0
    for t, d, i in points:
        if active and t > last:
            for a in active:
                shares[a] += (t - last) / len(active)
        last = t
        if d > 0:
            active.add(i)
        else:
            active.discard(i)
    return shares


def gaps(intervals: List[Tuple[float, float]], start: float, end: float
         ) -> List[Tuple[float, float]]:
    """The stretches of [start, end] that no interval covers."""
    out, at = [], start
    for s, e in sorted(intervals):
        if s > at:
            out.append((at, min(s, end)))
        at = max(at, e)
        if at >= end:
            break
    if at < end:
        out.append((at, end))
    return [(s, e) for s, e in out if e > s]


@dataclass
class Trace:
    """The device operations of the window (name, start, end in seconds)
    and the host's ranges (name, start, end), with the window's bounds."""

    ops: List[Tuple[str, float, float]]
    host: List[Tuple[str, float, float]]
    start: float
    end: float
    shares: List[float] = field(default_factory=list)

    def __post_init__(self):
        self.shares = busy_shares([(s, e) for _, s, e in self.ops])

    @property
    def window_s(self) -> float:
        return self.end - self.start

    @property
    def busy_s(self) -> float:
        return union((s, e) for _, s, e in self.ops)

    def family_busy_s(self, *names: str) -> float:
        return sum(sh for (n, _, _), sh in zip(self.ops, self.shares) if family(n) in names)

    def family_kernel_s(self, *names: str) -> float:
        return sum(e - s for n, s, e in self.ops if family(n) in names)

    def count(self, *names: str) -> int:
        return sum(1 for n, _, _ in self.ops if family(n) in names)

    def top_ops(self, n: int = 10) -> List[list]:
        """The device operations that took most time: [name, seconds]."""
        by = defaultdict(float)
        for name, s, e in self.ops:
            by[name] += e - s
        return [[k[:200], v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The device's idle time in the window by what the host was doing:
        each gap is charged to the innermost host range open at its middle;
        [name, seconds] of the largest sums."""
        idle = gaps([(s, e) for _, s, e in self.ops], self.start, self.end)
        host = sorted(self.host, key=lambda h: h[1])
        by = defaultdict(float)
        heap: list = []
        i = 0
        for s, e in sorted(idle):
            mid = 0.5 * (s + e)
            while i < len(host) and host[i][1] <= mid:
                heapq.heappush(heap, (-host[i][1], host[i][2], host[i][0]))
                i += 1
            while heap and heap[0][1] < mid:
                heapq.heappop(heap)
            by[heap[0][2] if heap else "(no host range)"] += e - s
        return [[k[:200], v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


@contextlib.contextmanager
def recording(enabled: bool):
    """Profile the block (the CPU's and the card's activity) when
    ``enabled``; yields a one-element list that holds the ``Trace`` after
    the block.  The window inside must be a ``record_function(WINDOW)``
    range."""
    box: list = []
    if not enabled:
        yield box
        return
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    try:
        yield box
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
    box.append(parse(prof.profiler.kineto_results.events()))


def parse(events) -> Trace:
    from torch.autograd import DeviceType

    ops, host, window = [], [], None
    for e in events:
        s, d = e.start_ns() * 1e-9, e.duration_ns() * 1e-9
        if e.device_type() == DeviceType.CUDA:
            # a record_function range is mirrored on the card's timeline as
            # an annotation: no operation ran in it
            if not (e.is_user_annotation() or e.name().startswith("bench.")):
                ops.append((e.name(), s, s + d))
        elif e.name() == WINDOW:
            window = (s, s + d)
        else:
            host.append((e.name(), s, s + d))
    if window is None:
        raise RuntimeError(f"the trace has no {WINDOW} range")
    lo, hi = window
    ops = [(n, max(s, lo), min(e, hi)) for n, s, e in ops if e > lo and s < hi]
    if not ops:
        raise RuntimeError("the profiler recorded no device activity in the window")
    return Trace(ops, host, lo, hi)
