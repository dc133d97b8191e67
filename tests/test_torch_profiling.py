"""``dphubert_torch.utils.profiling`` on the CPU: ``Throughput`` against the
TPU package's class on one sequence of events (the clock patched for
both), ``trace`` writing a Chrome trace of a CPU block, and the device-time
reading (``family``, ``union_us``, ``device_breakdown``) on synthetic
kernels.  The card's profile is read by ``chip_smoke.py``'s phase
"profile"."""

import json
import time
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

from dphubert_torch import utils as t_utils
from dphubert_torch.utils import profiling as t_prof
from dphubert_tpu.utils import profiling as j_prof


def test_throughput_matches_the_tpu_packages(monkeypatch):
    """The same (time, audio seconds) events through both classes, past
    the window so the oldest fall out: every property equal after each."""
    clock = [10.0, 10.5, 11.25, 11.5, 13.0, 13.1, 14.7, 15.0]
    now = [0.0]
    monkeypatch.setattr(time, "perf_counter", lambda: now[0])
    ours, theirs = t_prof.Throughput(window=4), j_prof.Throughput(window=4)
    assert ours.steps_per_sec is ours.audio_sec_per_sec is ours.per_chip(2) is None
    for i, audio in enumerate([0.0, 16.0, 8.0, 12.5, 16.0, 3.0, 9.0, 7.5]):
        now[0] = clock[i]
        ours.step(audio)
        theirs.step(audio)
        for read in (lambda t: t.steps_per_sec, lambda t: t.audio_sec_per_sec,
                     lambda t: t.per_chip(4)):
            assert read(ours) == read(theirs), i
    # the window's first event marks its start: its audio is not counted
    assert ours.audio_sec_per_sec == pytest.approx((3.0 + 9.0 + 7.5) / (15.0 - 13.0))
    assert ours.steps_per_sec == pytest.approx(3 / 2.0)
    # no time passed: no rate
    still = t_prof.Throughput()
    still.step(1.0)
    still.step(1.0)
    assert still.steps_per_sec is None and still.audio_sec_per_sec is None


def test_trace_writes_a_chrome_trace_of_the_block(tmp_path):
    logdir = tmp_path / "profile" / "run"  # created by trace
    with t_utils.trace(logdir) as prof:
        a = torch.randn(32, 32)
        (a @ a).relu().sum()
    path = prof.trace_path
    assert path.parent == logdir and path.name.endswith(".pt.trace.json")
    assert list(logdir.iterdir()) == [path]
    events = json.loads(path.read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert {"aten::randn", "aten::relu", "aten::sum"} <= names
    assert any(n in names for n in ("aten::matmul", "aten::mm"))


def test_family_and_union_us():
    assert t_prof.family("attention_fwd_wgmma_kernel<64>") == "attention (this repo's kernels)"
    assert t_prof.family("wavlm_bwd_dq_wgmma_kernel") == "attention (this repo's kernels)"
    assert t_prof.family("sm90_xmma_gemm_bf16bf16") == "matmul (cuBLAS)"
    assert t_prof.family("cudnn::dgrad_engine") == "convolution (cuDNN)"
    assert t_prof.family("at::native::distribution_elementwise_grid_stride_kernel") == \
        "random numbers"
    assert t_prof.family("multi_tensor_apply_kernel") == "optimizer (foreach)"
    assert t_prof.family("reduce_kernel<512>") == "reductions"
    assert t_prof.family("vectorized_elementwise_kernel") == "elementwise"
    assert t_prof.family("Memcpy HtoD") == "other"
    assert t_prof.union_us([]) == 0.0
    # overlapping, nested, touching and disjoint intervals, out of order
    assert t_prof.union_us([(5, 8), (0, 2), (1, 3), (6, 7), (8, 9), (20, 21)]) == 3 + 4 + 1
    assert t_prof.union_us([(0, 10), (2, 3)]) == 10
    # each interval's share of the union: shared time split among its holders
    assert t_prof._busy_shares([(5, 8), (0, 2), (1, 3), (6, 7), (8, 9), (20, 21)]) == [
        2.5, 1.5, 1.5, 0.5, 1.0, 1.0]


def _kernel(name, start, end, device=DeviceType.CUDA):
    rng = SimpleNamespace(start=start, end=end, elapsed_us=lambda: end - start)
    return SimpleNamespace(name=name, device_type=device, time_range=rng)


def test_device_breakdown_reads_busy_time_families_and_top_kernels():
    events = [
        _kernel("aten::mm", 0, 50, DeviceType.CPU),  # host events are not the card's
        _kernel("attention_fwd_wgmma_kernel", 0, 300),
        _kernel("gemm_bf16", 300, 500),
        _kernel("attention_fwd_wgmma_kernel", 1000, 1300),
        _kernel("Memcpy HtoD", 1250, 1400),  # overlaps: counted once in busy time
        _kernel("Memset", 1400, 1400),  # no duration
    ]
    out = t_prof.device_breakdown(SimpleNamespace(events=lambda: events), steps=2, top=2)
    assert out["busy_ms"] == pytest.approx((500 + 400) / 1e3 / 2)
    assert out["kernel_ms"] == pytest.approx((300 + 200 + 300 + 150) / 1e3 / 2)
    assert out["launches"] == 2.5
    attention, matmul = "attention (this repo's kernels)", "matmul (cuBLAS)"
    assert list(out["families_ms"]) == [attention, matmul, "other"]
    assert out["families_ms"][attention] == pytest.approx(0.3)
    # the 50 us both run split between them: the shares sum to the busy time
    assert out["families_busy_ms"] == {attention: pytest.approx((300 + 275) / 2e3),
                                       matmul: pytest.approx(0.1),
                                       "other": pytest.approx(125 / 2e3)}
    assert sum(out["families_busy_ms"].values()) == pytest.approx(out["busy_ms"])
    assert out["top"] == [{"name": "attention_fwd_wgmma_kernel", "ms": pytest.approx(0.3),
                           "busy_ms": pytest.approx(0.2875), "calls": 1.0},
                          {"name": "gemm_bf16", "ms": pytest.approx(0.1),
                           "busy_ms": pytest.approx(0.1), "calls": 0.5}]
    with pytest.raises(RuntimeError, match="no device activity"):
        t_prof.device_breakdown(SimpleNamespace(events=lambda: events[:1]))
