"""Per-layer activation checkpointing of the student (``DistillConfig.remat``,
``components.remat_layer``) on the CPU.

* Against the step without it, with dropout and gates on: every gradient
  within 1e-6 of its norm and the generator's state afterwards identical,
  on a tiny wav2vec 2.0 student and a tiny WavLM student (the position
  bias threaded from layer 0 through every checkpointed layer).  The
  recompute must draw the forward's dropout masks and kernel seeds from
  the explicit generator, which ``torch.utils.checkpoint`` does not replay:
  a checkpoint that ignores it moves gradients by O(1), and the test shows
  that it would.
* Against the TPU package's remat step (``jax.checkpoint`` per layer),
  dropout off and the same gate draws injected, under
  ``tests/test_torch_train.py``'s trajectory bounds.
* A run with remat stopped and resumed from ``last.pt`` equals the
  uninterrupted run bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dphubert_torch as pt
from dphubert_torch.models import components
from dphubert_torch.models.gates import has_gates
from dphubert_torch.train import DistillConfig, init_train_state, make_grad_fn, make_train_step, train

from tests.test_forward_parity import _tiny_w2v2_config, _tiny_wavlm_config
from tests.test_torch_gates import PRUNE_FLAGS, jax_gate_draws, one_torch_thread  # noqa: F401
from tests.test_torch_train import _setup

DROPOUT = dict(encoder_projection_dropout=0.1, encoder_attention_dropout=0.1,
               encoder_ff_interm_dropout=0.1, encoder_dropout=0.1)
CONFIGS = {"wav2vec2": _tiny_w2v2_config, "wavlm": _tiny_wavlm_config}


def _grads(teacher, student, cfg, batch):
    """(metrics, gradients, generator state after the step, encoder layer
    calls) of one step from a fresh state (the same seed every call)."""
    state, _ = init_train_state(student=student, cfg=cfg, teacher_embed_dim=64, device="cpu")
    calls = [0]
    real = components.EncoderLayer.forward

    def counting(self, *args, **kw):
        calls[0] += 1
        return real(self, *args, **kw)

    components.EncoderLayer.forward = counting
    try:
        metrics, grads = make_grad_fn(teacher, cfg)(state, batch)
    finally:
        components.EncoderLayer.forward = real
    return metrics, grads, state.generator.get_state(), calls[0]


def _naive_remat(layer, x, lengths, gates, generator, position_bias):
    """Checkpointing that leaves the explicit generator alone."""
    return torch.utils.checkpoint.checkpoint(
        lambda x, bias: layer(x, lengths, gates, generator, bias), x, position_bias,
        use_reentrant=False, preserve_rng_state=False)


@pytest.mark.parametrize("family", ["wav2vec2", "wavlm"])
def test_remat_gradients_equal_plain_with_dropout_and_gates(family, monkeypatch):
    make_cfg = CONFIGS[family]
    teacher = pt.wav2vec2_model(device="cpu", **make_cfg())
    student = pt.wav2vec2_model(device="cpu", generator=torch.Generator().manual_seed(1),
                                **make_cfg(**PRUNE_FLAGS, **DROPOUT))
    assert student.spec.is_wavlm == (family == "wavlm") and has_gates(student.spec)
    rng = np.random.default_rng(0)
    batch = (rng.standard_normal((2, 8000)).astype(np.float32), np.array([8000, 6000], np.int32))
    plain = DistillConfig(distill_layer_groups=((0,), (1, 3)))
    remat = DistillConfig(distill_layer_groups=((0,), (1, 3)), remat=True)
    m0, g0, gen0, calls0 = _grads(teacher, student, plain, batch)
    m1, g1, gen1, calls1 = _grads(teacher, student, remat, batch)
    n = student.spec.num_layers
    assert calls0 == 2 * n and calls1 == 3 * n  # the student's layers ran again
    assert torch.equal(gen0, gen1)
    for k in m0:
        assert torch.equal(m0[k], m1[k]), k
    for k, g in g0.items():
        assert (g1[k] - g).norm() <= 1e-6 * g.norm(), k
    if family == "wavlm":
        table = "student.encoder.transformer.layers.0.attention.rel_attn_embed.weight"
        assert g0[table].norm() > 0

    # without replaying the generator the recompute draws other masks
    monkeypatch.setattr(components, "remat_layer", _naive_remat)
    _, g2, gen2, _ = _grads(teacher, student, remat, batch)
    assert not torch.equal(gen0, gen2)
    assert max(((g2[k] - g).norm() / g.norm()).item() for k, g in g0.items() if g.norm() > 0) > 0.1


def test_remat_trajectory_matches_the_jax_remat_step():
    """Twelve steps with remat in both packages (dropout off, the TPU step's
    gate draws injected): every metric at every step within 1e-5 relative
    (+1e-6) and every parameter within 2e-5 absolute, as
    ``test_distill_trajectory_matches``."""
    (jt, js, tp, j_state, j_step, dcfg), (teacher, state, tx, cfg) = _setup(True, 1, remat=True)
    assert dcfg.remat and cfg.remat
    step = make_train_step(teacher, cfg, tx)
    spec = state.student.spec
    wave = np.random.default_rng(0).standard_normal((2, 4000)).astype(np.float32)
    for i in range(12):
        _, gate_key, _ = jax.random.split(j_state.rng, 3)
        gate_u = jax_gate_draws(spec, j_state.params["student"], gate_key)
        j_state, want = j_step(j_state, tp, (jnp.asarray(wave), None))
        state, got = step(state, (wave, None), gate_u=gate_u)
        for k in want:
            np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5, atol=1e-6,
                                       err_msg=f"step {i}: {k}")
    want_params = pt.train_params_from_jax(jax.tree.map(np.asarray, j_state.params))
    for k, p in state.named_params().items():
        np.testing.assert_allclose(p.detach().numpy(), want_params[k].numpy(), rtol=0, atol=2e-5,
                                   err_msg=k)


class _Batches:
    """5 batches an epoch of 2 x 6,400 samples, the same every epoch."""

    def epoch(self, e, skip=0):
        rng = np.random.default_rng(0)
        batches = [(0.1 * rng.standard_normal((2, 6400))).astype(np.float32) for _ in range(5)]
        for wave in batches[skip:]:
            yield wave, None


def test_remat_resume_is_bit_exact(tmp_path):
    """Stage 1 with remat, gates and dropout: stopped after step 3 and
    resumed from ``last.pt`` to step 7 (across an epoch end), it equals the
    uninterrupted run bit for bit: parameters, moments and generator."""
    cfg = DistillConfig(distill_layer_groups=((0,), (1, 3)), warmup_updates=2, max_updates=7,
                        sparsity_warmup_updates=2, target_sparsity=0.5, learning_rate=2e-3,
                        remat=True)

    def run(exp, **kw):
        teacher = pt.wav2vec2_model(device="cpu", **_tiny_w2v2_config())
        student = pt.wav2vec2_model(device="cpu", generator=torch.Generator().manual_seed(1),
                                    **_tiny_w2v2_config(**PRUNE_FLAGS, **DROPOUT))
        return train(teacher=teacher, student=student, cfg=cfg, loader=_Batches(), exp_dir=exp,
                     log_interval=100, device="cpu", **kw)

    full = run(tmp_path / "full")
    part = run(tmp_path / "part", stop_at_step=3)
    assert part.step == 3
    resumed = run(tmp_path / "part", resume=tmp_path / "part" / "ckpts" / "last.pt")
    assert resumed.step == full.step == 7
    for (k, a), (_, b) in zip(full.named_params().items(), resumed.named_params().items()):
        assert torch.equal(a, b), k
    for k in full.opt_state.mu:
        assert torch.equal(full.opt_state.mu[k], resumed.opt_state.mu[k]), k
        assert torch.equal(full.opt_state.nu[k], resumed.opt_state.nu[k]), k
    assert torch.equal(full.generator.get_state(), resumed.generator.get_state())
