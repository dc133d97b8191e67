"""``chip_smoke.py``'s step check with the L1 term: ``AbsInputs`` records
the L1 residuals of a pass and hands their signs to another pass's
gradient, keeps a float64 model in float64 for the witness pass, and
``l1_flips`` lists the residuals whose sign differs.  On the CPU with tiny
HuBERT-like and WavLM-like teachers and gated students (this module imports
no JAX)."""

import copy
import dataclasses

import numpy as np
import pytest
import torch

import dphubert_torch as pt
from chip_smoke import PRUNE_FLAGS, AbsInputs, _SignedAbs, gate_draws, l1_flips
from dphubert_torch.train import DistillConfig, init_train_state, make_grad_fn


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny(family, **over):
    """3 layers, 64 wide (4 heads x 16), on a conv stack of the real
    320-sample stride, dropout off; ``family`` "wavlm" adds WavLM's gated
    relative position bias."""
    cfg = dict(
        extractor_mode="group_norm",
        extractor_conv_layer_config=[[32, 10, 5]] + [[32, 3, 2]] * 4 + [[32, 2, 2]] * 2,
        extractor_conv_bias=False, encoder_embed_dim=64, encoder_projection_dropout=0.0,
        encoder_pos_conv_kernel=16, encoder_pos_conv_groups=4, encoder_num_layers=3,
        encoder_use_attention=[True] * 3, encoder_use_feed_forward=[True] * 3,
        encoder_num_heads=[4] * 3, encoder_head_dim=16, encoder_attention_dropout=0.0,
        encoder_ff_interm_features=[128] * 3, encoder_ff_interm_dropout=0.0,
        encoder_dropout=0.0, encoder_layer_norm_first=False, encoder_layer_drop=0.0,
        aux_num_out=None, normalize_waveform=False,
    )
    if family == "wavlm":
        cfg.update(encoder_num_buckets=32, encoder_max_distance=100,
                   encoder_total_num_heads=[4] * 3,
                   encoder_remaining_heads=[list(range(4))] * 3)
    cfg.update(over)
    return cfg


def step(family):
    """(teacher, student, cfg, batch, gate draws) of a tiny stage-1 step
    with the recipe's L1 term, over layers 1 and 3."""
    teacher = pt.wav2vec2_model(device="cpu", generator=torch.Generator().manual_seed(0),
                                **tiny(family))
    student = pt.wav2vec2_model(device="cpu", generator=torch.Generator().manual_seed(1),
                                **tiny(family, **PRUNE_FLAGS))
    wave = (0.1 * np.random.default_rng(4).standard_normal((2, 8000))).astype(np.float32)
    cfg = DistillConfig(distill_layer_groups=((1, 3),))
    return (teacher, student, cfg, (wave, np.array([8000, 6400], np.int32)),
            gate_draws(student.spec, student, seed=3))


def grads_of(teacher, student, cfg, batch, u, mode):
    state, _ = init_train_state(student=student, cfg=cfg, teacher_embed_dim=64, device="cpu")
    with mode:
        metrics, grads = make_grad_fn(teacher, cfg)(state, batch, gate_u=u)
    return metrics, grads


def test_signed_abs_takes_the_given_sign_in_its_gradient():
    x = torch.tensor([-2.0, -1e-9, 0.0, 3.0], requires_grad=True)
    sign = torch.tensor([-1.0, 1.0, 1.0, 1.0])
    y = _SignedAbs.apply(x, sign)
    assert torch.equal(y, x.detach().abs())
    (g,) = torch.autograd.grad(y, x, torch.full((4,), 0.5))
    assert torch.equal(g, 0.5 * sign)


@pytest.mark.parametrize("family", ["hubert", "wavlm"])
def test_pinned_signs_move_only_the_flipped_residual_s_gradient(family):
    """The step's abs calls are its L1 terms (one a distilled layer).
    Pinned to its own signs a pass gives its gradients bit for bit; with one
    residual's sign flipped the loss holds and the gradients move, as the
    card's did when one residual flipped against the CPU's."""
    teacher, student, cfg, batch, u = step(family)
    record = AbsInputs()
    metrics, grads = grads_of(teacher, student, cfg, batch, u, record)
    assert len(record.inputs) == 2 and all(r.dtype == torch.float32 for r in record.inputs)

    same = AbsInputs(signs_of=record.inputs)
    metrics_same, grads_same = grads_of(teacher, student, cfg, batch, u, same)
    assert all(torch.equal(grads[k], grads_same[k]) for k in grads)
    assert all(torch.equal(a, b) for a, b in zip(record.inputs, same.inputs))

    flipped = [r.clone() for r in record.inputs]
    flat = flipped[1].view(-1)
    flat[7] = -flat[7]
    metrics_flip, grads_flip = grads_of(teacher, student, cfg, batch, u,
                                        AbsInputs(signs_of=flipped))
    assert metrics_flip["loss"].item() == metrics["loss"].item()
    assert any(not torch.equal(grads[k], grads_flip[k]) for k in grads)
    assert l1_flips(record.inputs, flipped)["flipped"] == 1


@pytest.mark.parametrize("family", ["hubert", "wavlm"])
def test_float64_witness_pass_stays_float64(family):
    """The witness pass: the step's models in float64 with ``float64=True``
    give float64 residuals within float32 rounding of the float32 pass's."""
    teacher, student, cfg, batch, u = step(family)
    record = AbsInputs()
    grads_of(teacher, student, cfg, batch, u, record)
    cfg64 = dataclasses.replace(cfg, compute_dtype="float64")
    witness = AbsInputs(float64=True)
    grads_of(copy.deepcopy(teacher).to(torch.float64),
             copy.deepcopy(student).to(torch.float64), cfg64, batch, u, witness)
    assert [w.dtype for w in witness.inputs] == [torch.float64] * 2
    for r, w in zip(record.inputs, witness.inputs):
        assert (r.double() - w).abs().max().item() <= 1e-5 * w.abs().max().item()


def test_l1_flips_lists_the_residuals_of_another_sign():
    cpu = [torch.tensor([[1.0, -2e-6, 3.0]]), torch.tensor([5e-7, -1.0])]
    card = [torch.tensor([[1.0, 1e-6, 3.0]]), torch.tensor([-4e-7, -1.0])]
    witness = [torch.tensor([[1.0, -5e-7, 3.0]], dtype=torch.float64),
               torch.tensor([1e-7, -1.0], dtype=torch.float64)]
    row = l1_flips(cpu, card, witness, listed=1)
    assert row["residuals"] == 5 and row["flipped"] == 2
    assert row["cpu_card_gap_max"] == pytest.approx(3e-6)
    assert row["fp32_fp64_gap_max"] == pytest.approx(1.5e-6)
    assert row["listed"] == [{"term": 0, "index": [0, 1], "cpu": pytest.approx(-2e-6),
                              "card": pytest.approx(1e-6), "fp64": pytest.approx(-5e-7)}]
    assert l1_flips(cpu, cpu)["flipped"] == 0
