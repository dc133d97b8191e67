"""``dphubert_torch.utils.profiling`` on the CPU: ``span`` with the
profiler off (a shared no-op that never reaches the profiler's ops) and on
(ranges in the profiler's results), ``trace`` writing a Chrome trace of a
CPU block, and the device-time reading (``family``, ``union_us``,
``device_breakdown``) on synthetic kernels.  The card's profile is read by
``chip_smoke.py``'s phase "profile"."""

import contextlib
import json
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from dphubert_torch import utils as t_utils
from dphubert_torch.utils import profiling as t_prof

from tests.test_torch_dispatch import host_ranges


def test_span_is_a_shared_no_op_while_no_profiler_runs(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a span reached the profiler with no profiler running")

    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new", refuse)
    with pytest.raises(AssertionError, match="no profiler running"):
        with torch.profiler.record_function("unguarded"):
            pass
    off = t_prof.span("predictor.pad")
    assert isinstance(off, contextlib.nullcontext)
    assert t_prof.span("step.replay") is off is t_utils.span("feed.h2d")
    with t_prof.span("predictor.extract"), t_prof.span("predictor.pad"):
        torch.ones(3).add_(1)


def test_span_records_nested_ranges_under_the_profiler():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with t_prof.span("outer.a"):
            with t_prof.span("outer.b"):
                torch.ones(3).add_(1)
        with t_prof.span("outer.c"):
            pass
    (a, a0, a1), (b, b0, b1), (c, c0, c1) = host_ranges(prof, ("outer.",))
    assert (a, b, c) == ("outer.a", "outer.b", "outer.c")
    assert a0 <= b0 <= b1 <= a1 <= c0 <= c1
    assert isinstance(t_prof.span("outer.a"), contextlib.nullcontext)  # off again


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
    # cuDNN's convolutions whose names carry a matmul marker too
    assert t_prof.family(
        "void cutlass__5x_cudnn::Kernel<cutlass_tensorop_bf16_s16816fprop_analytic_bf16_128x64_"
        "64x3_nhwc_align8>(cutlass_tensorop_bf16_s16816fprop_analytic_bf16_128x64_64x3_nhwc_"
        "align8::Params)") == "convolution (cuDNN)"
    assert t_prof.family(
        "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x128x64_"
        "warpgroupsize1x1x1_g1_execute_segment_k_off_kernel__5x_cudnn") == "convolution (cuDNN)"
    # a cast is no convolution
    assert t_prof.family("void at::native::vectorized_elementwise_kernel<4, "
                         "at::native::convert_float_bf16>") == "elementwise"
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


def _kernel(name, start, end, device=DeviceType.CUDA, annotation=False):
    rng = SimpleNamespace(start=start, end=end, elapsed_us=lambda: end - start)
    return SimpleNamespace(name=name, device_type=device, time_range=rng,
                           is_user_annotation=annotation)


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


def test_device_breakdown_leaves_out_the_ranges_annotations():
    """A range (``span``, ``record_function``) shows on the card's timeline
    as a user annotation that spans its kernels: it is no device work, so
    busy time, kernel time, launches and families read the kernels alone."""
    kernels = [_kernel("norm_fwd_rows_warp", 100, 200), _kernel("gemm_bf16", 300, 350)]
    ranges = [_kernel("norm.fwd", 90, 210, annotation=True),
              _kernel("step.replay", 0, 1000, annotation=True)]
    alone = t_prof.device_breakdown(SimpleNamespace(events=lambda: kernels))
    out = t_prof.device_breakdown(SimpleNamespace(events=lambda: kernels + ranges))
    assert out == alone
    assert out["busy_ms"] == pytest.approx(0.15) and out["launches"] == 2
    assert [row["name"] for row in out["top"]] == ["norm_fwd_rows_warp", "gemm_bf16"]
    with pytest.raises(RuntimeError, match="no device activity"):
        t_prof.device_breakdown(SimpleNamespace(events=lambda: ranges))
