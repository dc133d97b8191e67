"""The operation counts behind ``mfu.*`` and ``attn_roofline.*``, held
against hand counts; the readers on synthetic traces."""

import importlib.util
import json
import pathlib

import pytest

from benchmark.lib import flops as FL
from benchmark.lib import trace as TR
from benchmark.run import Context

BENCH = pathlib.Path(__file__).resolve().parents[1]
HUBERT = json.loads((BENCH / "configs" / "hubert_base.json").read_text())


def reader(name):
    spec = importlib.util.spec_from_file_location(name, BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_hubert_base_forward_against_a_hand_count():
    # one clip of 1 s: the conv stack gives 3199, 1599, 799, 399, 199, 99, 49 frames
    conv0 = 2 * 512 * 1 * 10 * 3199
    rest = 2 * 512 * 512 * 3 * (1599 + 799 + 399 + 199) + 2 * 512 * 512 * 2 * (99 + 49)
    per_frame = (2 * 512 * 768 + 2 * 768 * 48 * 128
                 + 12 * (2 * 768 * 3 * 768 + 2 * 768 * 768 + 4 * 768 * 3072))
    attn = 12 * 4 * 12 * 64 * 49 * 49
    got = FL.forward_flops(HUBERT["teacher"], [16000])
    assert got == {"conv": conv0, "conv_rest": rest, "dense": per_frame * 49, "attn": attn}
    # about 15.4 GFLOP an audio second at 15 s clips
    per_s = sum(FL.forward_flops(HUBERT["teacher"], [240000]).values()) / 15
    assert 15.0e9 < per_s < 15.8e9


def test_train_step_counts_teacher_forward_student_forward_and_backward():
    t = FL.forward_flops(HUBERT["teacher"], [32000] * 2)
    s = FL.forward_flops(HUBERT["student"], [32000] * 2)
    want = sum(t.values()) + 3 * sum(s.values()) - s["conv"]  # no input gradient of conv 0
    assert FL.train_step_flops(HUBERT["teacher"], HUBERT["student"], 2, 32000) == want


def test_packed_forward_bound_of_the_stage1_shape():
    op = FL.AttentionOp(12, 64, (749,) * 16, backward=False, wavlm=False)
    assert op.flops() == 4 * 16 * 12 * 64 * 749 * 749
    assert op.bound_s() == pytest.approx(27.87e-6, rel=1e-3)  # bound by its operations
    bwd = FL.AttentionOp(12, 64, (749,) * 16, backward=True, wavlm=False)
    assert bwd.flops() == 2 * op.flops()
    wav = FL.AttentionOp(12, 64, (749,) * 16, backward=False, wavlm=True)
    assert wav.bytes() == op.bytes() + 4 * (12 * 749 * 749 + 12 * 749 * 16)


def ctx_for(ops, kernels, window=1.0, flops=0.0, audio=1.0):
    tr = TR.Trace(kernels, [], 0.0, window)
    return Context("c", "train", tr, window, audio, flops, FL.PEAK_FLOPS["bfloat16"], ops)


@pytest.mark.parametrize("split", [1, 2])
def test_attention_roofline_counts_ops_not_kernels(split):
    ops = [FL.AttentionOp(12, 64, (749,) * 16, backward=True, wavlm=False)]
    t = 10 * ops[0].bound_s()
    if split == 1:
        kernels = [("attention_bwd_fused_kernel", 0.0, t)]
    else:
        kernels = [("attention_bwd_dq_wgmma_kernel", 0.0, t / 2),
                   ("attention_bwd_dkv_wgmma_kernel", t / 2, t)]
    assert reader("attn_roofline.train")(ctx_for(ops, kernels)) == pytest.approx(10.0)


def test_shares_of_a_synthetic_trace_stay_at_or_under_100():
    ops = [FL.AttentionOp(12, 64, (100,) * 4, backward=False, wavlm=False)]
    b = ops[0].bound_s()
    exact = ctx_for(ops, [("attention_fwd_wgmma_kernel", 0.0, b), ("gemm", b, 0.5)])
    assert reader("attn_roofline.train")(exact) == pytest.approx(100.0)
    busy = ctx_for(ops, [("attention_fwd_wgmma_kernel", 0.0, 2 * b), ("gemm", 0.1, 0.9)],
                   flops=0.5 * FL.PEAK_FLOPS["bfloat16"])
    assert reader("attn_roofline.serve")(busy) == pytest.approx(50.0)
    assert reader("mfu.train")(busy) == pytest.approx(50.0)
    assert 0.0 <= reader("idle_share.train")(busy) <= 100.0
    assert reader("idle_share.serve")(busy) == pytest.approx(100 * (1 - (0.8 + 2 * b)))
    none = ctx_for([], [("gemm", 0.1, 0.9)])
    assert reader("attn_roofline.serve")(none) is None  # nothing to read, never 0
