"""Tracing and profiling (the TPU package's ``utils/profiling.py``).

``trace`` records a ``torch.profiler`` trace around a block of steps and
writes it where TensorBoard's profiler plugin and ``chrome://tracing``
read it; ``span`` names a phase of the program's host path in such a
trace; ``device_breakdown`` reads a finished profile's device time: the
card's busy time (the union of its kernels' intervals), the time of each
kernel family (``FAMILIES``) and the top kernels by name.
"""

from __future__ import annotations

import contextlib
import os
import pathlib
import socket
import time
from collections import defaultdict
from typing import Iterable, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

# kernel family by a substring of the kernel's name (lower case, "convert"
# left out), first match wins: the convolution markers come before the
# matmul ones, since cuDNN's implicit-GEMM and cutlass kernels are
# convolutions
FAMILIES = (
    ("attention (this repo's kernels)", ("attention_fwd_", "attention_bwd_", "wavlm_")),
    ("convolution (cuDNN)", ("conv", "cudnn", "fprop", "dgrad", "wgrad", "implicit")),
    ("matmul (cuBLAS)", ("gemm", "nvjet", "cublas", "cutlass")),
    ("random numbers", ("distribution", "philox", "random", "bernoulli")),
    ("optimizer (foreach)", ("multi_tensor", "foreach")),
    ("reductions", ("reduce", "norm")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "loops", "copy")),
)

_OFF = contextlib.nullcontext()


def family(name: str) -> str:
    """The ``FAMILIES`` label of a kernel's name, or "other"."""
    low = name.lower().replace("convert", "")
    for label, keys in FAMILIES:
        if any(k in low for k in keys):
            return label
    return "other"


def span(name: str):
    """A ``record_function`` range named ``name`` while a profiler runs,
    else one shared do-nothing context, so a phase costs a flag read when
    nothing records it:

        with profiling.span("predictor.pad"):
            batch, lengths = pad_batch(...)

    The range lands in the profiler's trace on the clock of the card's
    operations, beside those it enqueues."""
    if _autograd_profiler._is_profiler_enabled:
        return record_function(name)
    return _OFF


def union_us(intervals: Iterable[Tuple[float, float]]) -> float:
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


@contextlib.contextmanager
def trace(logdir):
    """Record the block with ``torch.profiler`` and write its trace where
    TensorBoard's profiler plugin lists it, as
    ``torch.profiler.tensorboard_trace_handler`` names it:
    ``logdir/<host>_<pid>.<ms>.pt.trace.json`` (``logdir`` created if
    missing):

        with profiling.trace("exp/profile") as prof:
            run_some_steps()

    Activities are the CPU's and, with a card present, the card's.  Yields
    the profile, which ``device_breakdown`` reads after the block;
    ``prof.trace_path`` is then the file written."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    logdir = pathlib.Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    path = logdir / f"{socket.gethostname()}_{os.getpid()}.{int(time.time() * 1000)}.pt.trace.json"
    prof.export_chrome_trace(str(path))
    prof.trace_path = path


def _busy_shares(intervals) -> list:
    """Each interval's share of the union: every stretch of time is split
    equally among the intervals that cover it, so the shares sum to
    ``union_us``."""
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


def device_breakdown(prof, steps: int = 1, top: int = 25) -> dict:
    """The card's time in a finished profile, per step of ``steps``, in
    ms: ``busy_ms`` (the union of the kernels' intervals), ``kernel_ms``
    (their sum: more than ``busy_ms`` where kernels run at once),
    ``launches``, by kernel family (``family``, largest first) each
    family's kernel time ``families_ms`` and its share of the busy time
    ``families_busy_ms`` (time that kernels share is split equally among
    them, so these sum to ``busy_ms``), and the ``top`` kernels by time
    (``name``, ``ms``, ``busy_ms``, ``calls``).  Raises if the profile holds
    no device activity."""
    # the card's timeline also holds the ranges (``span``, record_function)
    # as annotations, which are no device work
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        raise RuntimeError("the profiler recorded no device activity")
    intervals = [(e.time_range.start, e.time_range.end) for e in kernels]
    by_name = defaultdict(lambda: [0.0, 0.0, 0])
    by_family = defaultdict(lambda: [0.0, 0.0])
    for e, share in zip(kernels, _busy_shares(intervals)):
        us = e.time_range.elapsed_us()
        row = by_name[e.name]
        row[0] += us
        row[1] += share
        row[2] += 1
        fam = by_family[family(e.name)]
        fam[0] += us
        fam[1] += share
    per = 1e3 * steps
    families = sorted(by_family.items(), key=lambda kv: -kv[1][0])
    return {
        "busy_ms": union_us(intervals) / per,
        "kernel_ms": sum(t for t, _ in by_family.values()) / per,
        "launches": len(kernels) / steps,
        "families_ms": {k: t / per for k, (t, _) in families},
        "families_busy_ms": {k: b / per for k, (_, b) in families},
        "top": [{"name": n, "ms": t / per, "busy_ms": b / per, "calls": c / steps}
                for n, (t, b, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]],
    }
