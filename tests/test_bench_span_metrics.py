"""The benchmark's readers of the program's spans (``benchmark/metrics/``
``frontend_host_ms.serve``, ``frontend_idle_share.serve``,
``dispatch_idle_share.train``, over ``benchmark/lib/spans.py``) on
synthetic traces, against values worked out by hand; on a trace without
the program's spans (a commit before them) each reads nothing."""

import pathlib
from types import SimpleNamespace

import pytest

from benchmark import run
from benchmark.lib.trace import Trace

ROOT = pathlib.Path(__file__).resolve().parents[1]

# A request window of 10 s.  The card runs 0-1, 3-4, 6-9 and 9.5-10, so it
# is idle over 1-3, 4-6 and 9-9.5.  The pad at -0.5-0.5 and the h2d at
# 9.8-10.7 run past the window and are clipped to it; a second pad inside
# the unpad counts once.  Front end (pad, h2d, forward, unpad): 0-2.5,
# 5-5.5, 8.5-10 = 4.5 s; idle inside it: 1-2.5, 5-5.5, 9-9.5 = 2.5 s.  The
# readback (2.5-5) and the request's range are not front end; nor are the
# aten ranges nested in the spans.
SERVE = Trace(
    [("conv", 0.0, 1.0), ("Memcpy DtoH (Device -> Pageable)", 3.0, 4.0), ("conv", 6.0, 9.0),
     ("gemm", 9.5, 10.0)],
    [("bench.extract", -1.0, 10.6), ("predictor.extract", -0.9, 10.5),
     ("predictor.pad", -0.5, 0.5), ("aten::zeros", -0.4, 0.2),
     ("predictor.h2d", 0.5, 2.0), ("aten::copy_", 0.6, 1.9),
     ("predictor.forward", 2.0, 2.5), ("cudaLaunchKernel", 2.1, 2.2),
     ("predictor.readback", 2.5, 5.0), ("cudaMemcpyAsync", 2.6, 4.9),
     ("predictor.unpad", 5.0, 5.5), ("predictor.pad", 5.25, 5.5),
     ("predictor.pad", 8.5, 9.8), ("predictor.h2d", 9.8, 10.7)],
    0.0, 10.0)
# A distill window of 4 s.  Idle: 1.0-1.2, 2.0-2.1, 2.2-2.5.  Inside the
# dispatch spans: feed.h2d 1.0-1.1, step.plan 1.15-1.2, step.replay
# 2.0-2.05, step.capture (clipped to 4.0) 2.3-2.5 = 0.4 s; the gap 2.05-2.1
# falls in no span, the feed.h2d before the window on a busy card.
TRAIN = Trace(
    [("dgrad_engine", 0.0, 1.0), ("gemm", 1.2, 2.0), ("Memcpy HtoD (Pinned -> Device)", 2.1, 2.2),
     ("gemm", 2.5, 4.0)],
    [("feed.h2d", -0.5, 0.1), ("bench.feed", 0.9, 1.15), ("feed.h2d", 0.95, 1.1),
     ("cudaMemcpyAsync", 1.0, 1.05), ("bench.dispatch", 1.15, 2.6), ("step.plan", 1.15, 1.25),
     ("step.stage", 1.25, 1.3), ("step.replay", 1.3, 2.05), ("cudaGraphLaunch", 1.3, 2.04),
     ("step.capture", 2.3, 4.5)],
    0.0, 4.0)


def without_spans(tr):
    return Trace(tr.ops, [h for h in tr.host if not h[0].startswith(("predictor.", "feed.",
                                                                      "step."))],
                 tr.start, tr.end)


def ctx(tr, audio_s):
    return SimpleNamespace(trace=tr, window_s=tr.window_s, audio_s=audio_s)


@pytest.mark.parametrize("metric,trace,audio_s,want", [
    ("frontend_host_ms.serve", SERVE, 90.0, 1e3 * 4.5 / 90.0),
    ("frontend_idle_share.serve", SERVE, 90.0, 100.0 * 2.5 / 10.0),
    ("dispatch_idle_share.train", TRAIN, 1.0, 100.0 * 0.4 / 4.0),
    ("frontend_host_ms.serve", without_spans(SERVE), 90.0, None),
    ("frontend_idle_share.serve", without_spans(SERVE), 90.0, None),
    ("dispatch_idle_share.train", without_spans(TRAIN), 1.0, None),
])
def test_span_metrics_on_synthetic_traces(metric, trace, audio_s, want):
    got = run.read_metric(ROOT, metric, ctx(trace, audio_s))
    assert got == (None if want is None else pytest.approx(want, rel=1e-12, abs=1e-12))
