"""The port's distill step against the TPU package's on the CPU: schedules,
projections, the distill loss, the three-group optimizer and whole
trajectories of ``make_train_step``.

Both packages start from identical weights (``train_params_from_jax``).
Trajectories run with every dropout rate at 0 and the gates' uniform draws
of the TPU package's step injected (``gate_u``), since torch's generators
cannot reproduce ``jax.random``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import dphubert_torch as pt
from dphubert_torch.models.gates import has_gates
from dphubert_torch.params import unflatten_params
from dphubert_torch.train import (
    DistillConfig,
    DistillOptimizer,
    distill_loss_unstacked,
    init_projections,
    init_train_state,
    linear_decay_factor,
    make_eval_step,
    make_train_step,
    parse_layer_groups,
    projections_from_state_dict,
    projections_to_state_dict,
    tri_stage_factor,
)
from dphubert_torch.train.distill_module import _target_sparsity, update_count
from dphubert_tpu import wav2vec2_model as j_wav2vec2_model
from dphubert_tpu.models.gates import compile_gates as j_compile_gates
from dphubert_tpu.train import distill_module as j_dm
from dphubert_tpu.train import losses as j_losses
from dphubert_tpu.train import optim as j_optim
from dphubert_tpu.train import projections as j_proj
from dphubert_tpu.train import schedules as j_sched

from tests.test_forward_parity import _tiny_w2v2_config
from tests.test_torch_gates import PRUNE_FLAGS, jax_gate_draws, one_torch_thread  # noqa: F401


def test_schedules_match():
    """Both factors at every count around their boundaries, float32."""
    for c in range(0, 60):
        assert linear_decay_factor(c, 10, 50) == float(j_sched.linear_decay_factor(c, 10, 50))
        assert tri_stage_factor(c, 8, 10, 20) == pytest.approx(
            float(j_sched.tri_stage_factor(c, 8, 10, 20)), rel=1e-6)
    assert linear_decay_factor(0, 0, 5) == float(j_sched.linear_decay_factor(0, 0, 5))


def test_projections_match_and_round_trip():
    groups = parse_layer_groups("0.4,8,12")
    assert groups == j_proj.parse_layer_groups("0.4,8,12") == ((0,), (4, 8, 12))
    for s_dim, t_dim in ((8, 8), (6, 10), (10, 6)):
        got = init_projections("layer2layer", groups, s_dim, t_dim)
        want = j_proj.init_projections("layer2layer", groups, s_dim, t_dim, jax.random.key(0))
        for gi in ("0", "1"):
            for k in ("weight", "bias"):
                np.testing.assert_array_equal(got["groups"][gi][k].numpy(),
                                              np.asarray(want["groups"][gi][k]))
    for mode in ("layer2layer", "predlayer"):
        projs = init_projections(mode, groups, 8, 12, torch.Generator().manual_seed(0))
        sd = projections_to_state_dict(projs, mode, groups)
        j_back = j_proj.projections_from_state_dict(sd, mode, groups)
        assert j_proj.projections_to_state_dict(j_back, mode, groups).keys() == sd.keys()
        back = projections_from_state_dict(sd, mode, groups)
        for k, v in pt.flatten_params(back).items():
            np.testing.assert_array_equal(v.numpy(), pt.flatten_params(projs)[k].numpy())
    bound = 1.0 / np.sqrt(8)
    w = init_projections("predlayer", groups, 8, 12, torch.Generator().manual_seed(1))
    assert all(float(t.abs().max()) <= bound for t in pt.flatten_params(w).values())


@pytest.mark.parametrize("mode", ["layer2layer", "predlayer"])
@pytest.mark.parametrize("cos_type", ["raw", "log_sig"])
def test_distill_loss_and_grads_match(mode, cos_type):
    """Value, terms and gradients (projections and student hidden states)
    against jax.value_and_grad; fp32, bound 1e-5 relative."""
    groups = ((0,), (1, 3))
    flat = (0, 1, 3)
    B, L, ds, dt = 2, 9, 16, 24
    rng = np.random.default_rng(0)
    hiddens = [rng.standard_normal((B, L, ds)).astype(np.float32) for _ in range(4)]
    teacher = [rng.standard_normal((B, L, dt)).astype(np.float32) for _ in range(4)]
    projs = j_proj.init_projections(mode, groups, ds, dt, jax.random.key(3))
    kw = dict(l2_weight=0.5, l1_weight=1.0, cos_weight=1.0, cos_type=cos_type)

    def j_loss(p, h):
        total, terms = j_losses.distill_loss_unstacked(
            p, mode, groups, h, [jnp.asarray(t) for t in teacher], flat, **kw)
        return total, terms

    (want, want_terms), want_g = jax.value_and_grad(j_loss, argnums=(0, 1), has_aux=True)(
        projs, [jnp.asarray(h) for h in hiddens])
    t_projs = unflatten_params({k: torch.from_numpy(np.array(v)).requires_grad_()
                                for k, v in pt.flatten_params(projs).items()})
    t_h = [torch.from_numpy(h).requires_grad_() for h in hiddens]
    got, got_terms = distill_loss_unstacked(
        t_projs, mode, groups, t_h, [torch.from_numpy(t) for t in teacher], flat, **kw)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    for g, w in zip(got_terms, want_terms):
        np.testing.assert_allclose(g.item(), float(w), rtol=1e-5, atol=1e-7)
    got.backward()
    for k, w in pt.flatten_params(jax.tree.map(np.asarray, want_g[0])).items():
        np.testing.assert_allclose(pt.flatten_params(t_projs)[k].grad.numpy(), w,
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    for i, w in enumerate(want_g[1]):
        grad = np.zeros_like(hiddens[i]) if t_h[i].grad is None else t_h[i].grad.numpy()
        np.testing.assert_allclose(grad, np.asarray(w), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_optimizer_matches_build_optimizer(weight_decay):
    """Nine updates of the three groups against optax's chain: clipping
    active (gradients of norm ~50 against clip 10) and inactive, across the
    warmup boundary (3) into the decay, λ ascending.  fp32, bound 1e-6
    absolute on parameters of order 1 (Adam normalises every step to ~lr)."""
    rng = np.random.default_rng(0)
    params = {
        "student": {"w": rng.standard_normal((5, 4)).astype(np.float32),
                    "hc": {"log_alpha": rng.standard_normal(6).astype(np.float32)}},
        "projs": {"groups": {"0": {"weight": rng.standard_normal((3, 3)).astype(np.float32)}}},
        "lambdas": {"lambda1": np.float32(0.0), "lambda2": np.float32(0.0)},
    }
    kw = dict(learning_rate=2e-3, weight_decay=weight_decay, warmup_updates=3,
              max_updates=12, clip_norm=10.0, use_reg=True, reg_learning_rate=0.02)
    tx = j_optim.build_optimizer(**kw)
    j_params = jax.tree.map(jnp.asarray, params)
    j_state = tx.init(j_params)
    t_params = {k: torch.from_numpy(np.array(v, dtype=np.float32))
                for k, v in pt.flatten_params(params).items()}
    opt = DistillOptimizer(**kw)
    state = opt.init(t_params)
    for step in range(9):
        scale = 20.0 if step % 2 == 0 else 0.1  # clipped on even steps
        grads = {k: (scale * rng.standard_normal(np.shape(v))).astype(np.float32)
                 for k, v in pt.flatten_params(params).items()}
        updates, j_state = tx.update(jax.tree.map(jnp.asarray, unflatten_params(grads)),
                                     j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        assert opt.step({k: torch.from_numpy(np.asarray(g)) for k, g in grads.items()},
                        state, t_params)
        for k, w in pt.flatten_params(jax.tree.map(np.asarray, j_params)).items():
            np.testing.assert_allclose(t_params[k].numpy(), w, rtol=0, atol=1e-6,
                                       err_msg=f"step {step}: {k}")
    assert state.count == 9
    assert float(t_params["lambdas.lambda1"]) != 0.0


def _setup(use_reg: bool, accum_grad: int):
    """Teacher and student in both packages, each package holding the same
    weights.  The student has weights of its own: with the teacher's (as the
    TPU package's tests/test_train.py sets it up) many L1 residuals sit at
    rounding noise around 0, and their gradient is the sign of that noise in
    either package."""
    cfg_t = _tiny_w2v2_config()
    cfg_s = _tiny_w2v2_config(**(PRUNE_FLAGS if use_reg else {}))
    jt, js = j_wav2vec2_model(**cfg_t), j_wav2vec2_model(**cfg_s)
    tp = jt.init(jax.random.key(0))
    sp = js.init(jax.random.key(1))
    dcfg = j_dm.DistillConfig(
        distill_layer_groups=((0,), (1, 3)), warmup_updates=4, max_updates=20,
        sparsity_warmup_updates=5, target_sparsity=0.5, use_reg=use_reg,
        accum_grad=accum_grad,
    )
    j_state, j_tx = j_dm.init_train_state(student=js, student_params=sp, cfg=dcfg,
                                          teacher_embed_dim=64, rng=jax.random.key(42))
    j_step = j_dm.make_train_step(jt, js, dcfg, j_tx, donate=False)

    teacher = pt.wav2vec2_model(device="cpu", **cfg_t)
    teacher.load_state_dict(pt.state_dict_from_jax(tp))
    cfg = DistillConfig(**{k: getattr(dcfg, k) for k in DistillConfig.__dataclass_fields__})
    state, tx = init_train_state(student=pt.wav2vec2_model(device="cpu", **cfg_s), cfg=cfg,
                                 teacher_embed_dim=64, device="cpu")
    state.load_params(pt.train_params_from_jax(jax.tree.map(np.asarray, j_state.params)))
    return (jt, js, tp, j_state, j_step, dcfg), (teacher, state, tx, cfg)


@pytest.mark.parametrize("use_reg,accum_grad", [(True, 1), (True, 2), (False, 1)])
def test_distill_trajectory_matches(use_reg, accum_grad):
    """Twelve micro-steps of the port's step against make_train_step, on
    one batch: every metric at every step within 1e-5 relative (+1e-6
    absolute), and every parameter after the last step within 2e-5 absolute
    (fp32 on the CPU: the two autodiffs sum in different orders, and Adam
    turns a difference in a gradient near 0 into at most a fraction of lr,
    2e-4, per step)."""
    (jt, js, tp, j_state, j_step, dcfg), (teacher, state, tx, cfg) = _setup(use_reg, accum_grad)
    step = make_train_step(teacher, cfg, tx)
    spec = state.student.spec
    wave = np.random.default_rng(0).standard_normal((2, 4000)).astype(np.float32)
    for i in range(12):
        gate_u = None
        if has_gates(spec):
            # the TPU step's gate key: the middle of split(state.rng, 3)
            _, gate_key, _ = jax.random.split(j_state.rng, 3)
            gate_u = jax_gate_draws(spec, j_state.params["student"], gate_key)
        j_state, want = j_step(j_state, tp, (jnp.asarray(wave), None))
        state, got = step(state, (wave, None), gate_u=gate_u)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5, atol=1e-6,
                                       err_msg=f"step {i}: {k}")
    assert state.step == int(j_state.step) == 12
    if accum_grad > 1:
        assert state.opt_state.count == int(j_state.opt_state.gradient_step) == 6
    if use_reg:
        assert state.lambdas["lambda1"].item() < 0.0  # dual ascent while s < t
    want_params = pt.train_params_from_jax(jax.tree.map(np.asarray, j_state.params))
    for k, p in state.named_params().items():
        np.testing.assert_allclose(p.detach().numpy(), want_params[k].numpy(),
                                   rtol=0, atol=2e-5, err_msg=k)


def test_eval_step_matches():
    """make_eval_step with the compiled eval gates: dropout off, metrics of
    the TPU package's eval step within 1e-5 relative."""
    (jt, js, tp, j_state, _, dcfg), (teacher, state, _, cfg) = _setup(True, 1)
    wave = np.random.default_rng(1).standard_normal((2, 4000)).astype(np.float32)
    lengths = np.array([4000, 3000], np.int32)
    j_gates = j_compile_gates(js.spec, j_state.params["student"])
    want = j_dm.make_eval_step(jt, js, dcfg)(j_state, tp, (jnp.asarray(wave), jnp.asarray(lengths)),
                                            j_gates)
    from dphubert_torch.models.gates import compile_gates

    gates = compile_gates(state.student.spec,
                          unflatten_params(dict(state.student.named_parameters())))
    got = make_eval_step(teacher, cfg)(state, (wave, lengths), gates)
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5, atol=1e-6, err_msg=k)
    # the eval step leaves no gradient behind and moves nothing
    assert all(p.grad is None for p in state.student.parameters())


def test_update_count_and_target_sparsity():
    for accum in (1, 3):
        cfg = DistillConfig(accum_grad=accum, sparsity_warmup_updates=10, target_sparsity=0.6)
        jcfg = j_dm.DistillConfig(accum_grad=accum, sparsity_warmup_updates=10,
                                  target_sparsity=0.6)
        for s in (0, 1, 2, 3, 9, 10, 29, 30, 31, 100):
            assert update_count(cfg, s) == int(j_dm.update_count(jcfg, jnp.asarray(s)))
            assert _target_sparsity(cfg, s) == float(j_dm._target_sparsity(jcfg, jnp.asarray(s)))


def test_entry_points_need_cuda_or_cpu_and_refuse_unported_options():
    cfg = DistillConfig()
    student = pt.wav2vec2_model(device="cpu", **_tiny_w2v2_config(**PRUNE_FLAGS))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            init_train_state(student=student, cfg=cfg, teacher_embed_dim=64)
    state, tx = init_train_state(student=student, cfg=cfg, teacher_embed_dim=64, device="cpu")
    assert state.student is not student  # a copy: the caller's module is left alone
    assert state.lambdas["lambda1"].item() == state.lambdas["lambda2"].item() == 0.0
    teacher = pt.wav2vec2_model(device="cpu", **_tiny_w2v2_config())
    for option in ("remat", "scan_layers", "steps_per_call"):  # not ported: no such field
        with pytest.raises(TypeError, match=option):
            make_train_step(teacher, DistillConfig(**{option: True}), tx)
    # use_reg=False has no optimizer group for HardConcrete parameters
    with pytest.raises(ValueError, match="log_alpha"):
        init_train_state(student=student, cfg=DistillConfig(use_reg=False),
                         teacher_embed_dim=64, device="cpu")
