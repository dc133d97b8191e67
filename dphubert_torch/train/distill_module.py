"""The joint distillation + pruning train step (the TPU package's
``train/distill_module.py``; reference ``lightning.py:142-305``).

One step =
  teacher ``extract_features`` (frozen: under ``torch.no_grad()``, no
  dropout)
  + student ``extract_features`` (dropout on, HardConcrete gates sampled
  from the state's generator)
  + per-layer projections -> distill loss (L1 + cosine by default)
  + Lagrangian sparsity loss  λ1·(s−t) + λ2·(s−t)²  where
      s = 1 − expected_model_size / teacher_size (differentiable through the
      gates' l0 norms) and t warms linearly to the target
  + one update of the three-group AdamW (``optim.py``), in place.

Entry points: ``init_train_state``, ``make_train_step`` and
``make_eval_step`` (and ``make_grad_fn``, the step without its update).
The state's student is a copy of the given module, and every one of its
parameters trains, ``dummy_weight`` included, as every leaf of the TPU
package's parameter tree does (ROADMAP queue 3).  ``remat`` checkpoints
each of the student's encoder layers (``components.remat_layer``); the
teacher runs under ``no_grad`` and keeps nothing to checkpoint.  The TPU
package's ``scan_layers`` shrank its compiled program and has no
counterpart in eager PyTorch; its ``steps_per_call`` is not ported yet
(ROADMAP queue 1).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..models.gates import has_gates, sample_gates
from ..models.model import Wav2Vec2Model, resolve_device
from ..models.size import model_size
from ..params import flatten_params, unflatten_params
from .losses import distill_loss_unstacked
from .optim import DistillOptimizer, OptState, global_norm
from .projections import flatten_groups, init_projections


@dataclass(frozen=True)
class DistillConfig:
    """Static training configuration (a copy of the TPU package's)."""

    distill_mode: str = "layer2layer"
    distill_layer_groups: Tuple[Tuple[int, ...], ...] = ((0,), (4, 8, 12))
    l2_weight: float = 0.0
    l1_weight: float = 1.0
    cos_weight: float = 1.0
    cos_type: str = "raw"
    learning_rate: float = 2e-4
    weight_decay: float = 0.0
    warmup_updates: int = 15000
    max_updates: int = 50000
    clip_norm: float = 10.0
    use_reg: bool = True
    reg_learning_rate: float = 0.02
    target_sparsity: float = 0.75
    sparsity_warmup_updates: int = 5000
    compute_dtype: str = "float32"  # "bfloat16" on the card
    remat: bool = False  # per-layer activation checkpointing for the student
    accum_grad: int = 1  # micro-batch accumulation (reference --accum_grad)


@dataclass
class TrainState:
    """Everything a step reads and updates in place: the student module,
    the projection and λ parameters, the optimizer state, the micro-step
    counter and the generator of the gates and dropout (on the device)."""

    student: Wav2Vec2Model
    projs: dict
    lambdas: Optional[dict]
    opt_state: OptState
    step: int
    generator: torch.Generator

    def named_params(self) -> Dict[str, torch.Tensor]:
        """Training parameters by dotted name: ``student.<state-dict key>``,
        ``projs.groups.<g>.weight``, ``lambdas.lambda1``."""
        out = {f"student.{k}": p for k, p in self.student.named_parameters()}
        out.update(flatten_params(self.projs, prefix="projs."))
        if self.lambdas is not None:
            out.update(flatten_params(self.lambdas, prefix="lambdas."))
        return out

    @torch.no_grad()
    def load_params(self, flat: Dict[str, torch.Tensor]) -> None:
        """Copy parameters in, by the names of ``named_params`` (all of
        them: e.g. ``params.train_params_from_jax``)."""
        own = self.named_params()
        if set(own) != set(flat):
            raise KeyError(f"parameter names differ: {sorted(set(own) ^ set(flat))[:8]}")
        for name, p in own.items():
            p.copy_(torch.as_tensor(flat[name]).to(p.device, p.dtype))


def init_train_state(
    *,
    student: Wav2Vec2Model,
    cfg: DistillConfig,
    teacher_embed_dim: int,
    seed: int = 0,
    device="cuda",
) -> Tuple[TrainState, DistillOptimizer]:
    """A fresh state on ``device`` and its optimizer.

    The student is copied (the caller's module, which may share weights
    with the teacher, is left alone); λ1 = λ2 = 0; the projections are
    initialised from ``seed`` (the identity for layer2layer), and the
    state's generator on the device is seeded from the same seed."""
    device = resolve_device(device)
    host_gen = torch.Generator().manual_seed(seed)
    student = copy.deepcopy(student).to(device)
    for p in student.parameters():
        p.requires_grad_(True)
    projs = init_projections(
        cfg.distill_mode, cfg.distill_layer_groups, student.spec.embed_dim,
        teacher_embed_dim, generator=host_gen, device=device,
    )
    for p in flatten_params(projs).values():
        p.requires_grad_(True)
    lambdas = None
    if cfg.use_reg:
        lambdas = {name: torch.zeros((), device=device, requires_grad=True)
                   for name in ("lambda1", "lambda2")}
    generator = torch.Generator(device=device).manual_seed(
        int(torch.randint(0, 2**62, (1,), generator=host_gen))
    )
    tx = DistillOptimizer(
        learning_rate=cfg.learning_rate,
        weight_decay=cfg.weight_decay,
        warmup_updates=cfg.warmup_updates,
        max_updates=cfg.max_updates,
        clip_norm=cfg.clip_norm,
        use_reg=cfg.use_reg,
        reg_learning_rate=cfg.reg_learning_rate,
        accum_grad=cfg.accum_grad,
    )
    state = TrainState(student, projs, lambdas, None, 0, generator)
    state.opt_state = tx.init(state.named_params())
    return state, tx


def update_count(cfg: DistillConfig, step: int) -> int:
    """Optimizer-update count for a micro-step counter: with
    ``accum_grad > 1`` one update every ``accum_grad`` micro-steps, and
    every schedule runs on updates (the reference counts optimizer steps)."""
    return step // max(cfg.accum_grad, 1)


def _target_sparsity(cfg: DistillConfig, step: int) -> float:
    """Linear warmup of the sparsity target over optimizer updates, in
    float32 as the TPU package."""
    frac = min(np.float32(update_count(cfg, step)) / np.float32(max(cfg.sparsity_warmup_updates, 1)),
               np.float32(1.0))
    return float(np.float32(cfg.target_sparsity) * frac)


def _teacher_numel(teacher: Wav2Vec2Model) -> int:
    """Teacher size = raw parameter count, ``dummy_weight`` included
    (reference ``lightning.py:170``)."""
    return sum(p.numel() for p in teacher.parameters())


def _batch(batch, dtype: torch.dtype, device):
    waveforms, lengths = batch
    wave = torch.as_tensor(waveforms).to(device)
    if wave.dtype == torch.int16:
        # int16 PCM feed: exactly the float32 the decoder would produce
        wave = wave.float() / 32768.0
    wave = wave.to(dtype)
    if lengths is not None:
        lengths = torch.as_tensor(lengths).to(device=device, dtype=torch.int32)
    return wave, lengths


def _distill_forward(teacher, student, cfg, original, params, batch, step, generator,
                     training, gates):
    """Shared forward for train and eval: returns (loss, metrics)."""
    wave, lengths = _batch(batch, getattr(torch, cfg.compute_dtype),
                           student.feature_extractor.dummy_weight.device)
    with torch.no_grad():
        teacher_hiddens, _ = teacher.extract_features(wave, lengths)
    student_hiddens, _ = student.extract_features(
        wave, lengths, gates=gates, training=training, generator=generator, remat=cfg.remat,
    )
    loss_d, (l_mse, l_l1, l_cos) = distill_loss_unstacked(
        params["projs"], cfg.distill_mode, cfg.distill_layer_groups,
        student_hiddens, teacher_hiddens, flatten_groups(cfg.distill_layer_groups),
        l2_weight=cfg.l2_weight, l1_weight=cfg.l1_weight, cos_weight=cfg.cos_weight,
        cos_type=cfg.cos_type,
    )
    metrics = {"loss_distill": loss_d, "loss_mse": l_mse, "loss_l1": l_l1, "loss_cos": l_cos}
    if cfg.use_reg:
        cur_size = model_size(params["student"], student.spec)
        s = 1.0 - cur_size / original
        t = torch.tensor(_target_sparsity(cfg, step), device=loss_d.device)
        lam1, lam2 = params["lambdas"]["lambda1"], params["lambdas"]["lambda2"]
        loss_reg = lam1 * (s - t) + lam2 * (s - t).square()
        metrics.update(loss_reg=loss_reg, sparsity_expected=s, sparsity_target=t,
                       lambda1=lam1, lambda2=lam2)
        loss = loss_d + loss_reg
    else:
        loss = loss_d
    metrics["loss"] = loss
    return loss, metrics


def _param_tree(state: TrainState) -> dict:
    return {"student": unflatten_params(dict(state.student.named_parameters())),
            "projs": state.projs, "lambdas": state.lambdas}


def make_grad_fn(teacher: Wav2Vec2Model, cfg: DistillConfig):
    """``grad_fn(state, batch, *, gate_u=None) -> (metrics, grads)``: the
    loss, its metrics and the gradient of every training parameter (by the
    names of ``TrainState.named_params``), without touching the state: the
    step's forward and backward, the gradient of the TPU package's
    ``loss_fn``.

    ``batch`` is ``(waveforms (B, T), lengths (B,) or None)``, float or
    int16 PCM, numpy or tensors.  Metrics are 0-dim tensors on the device
    (no host sync): the distill terms, the sparsity terms and the λs, the
    loss and the gradient's global norm ``grad_norm``.  ``gate_u`` injects
    the gates' uniform draws, a tree of the gates' layout (the tests hand
    the TPU package's draws in); otherwise they come from the state's
    generator.  Gates stay differentiable in ``log_alpha``."""
    original = float(_teacher_numel(teacher))

    def grad_fn(state: TrainState, batch, *, gate_u: Optional[dict] = None):
        student = state.student
        params = _param_tree(state)
        gates = None
        if has_gates(student.spec):
            gates = sample_gates(student.spec, params["student"], state.generator, u=gate_u)
        loss, metrics = _distill_forward(
            teacher, student, cfg, original, params, batch, state.step, state.generator,
            True, gates,
        )
        named = state.named_params()
        grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
        grads = {n: torch.zeros_like(p) if g is None else g
                 for (n, p), g in zip(named.items(), grads)}
        metrics = {k: v.detach().clone() for k, v in metrics.items()}
        metrics["grad_norm"] = global_norm(list(grads.values()))
        return metrics, grads

    return grad_fn


def make_train_step(teacher: Wav2Vec2Model, cfg: DistillConfig, tx: DistillOptimizer):
    """The train step ``step(state, batch, *, gate_u=None) -> (state,
    metrics)``: ``make_grad_fn``'s gradients, then one micro-step of ``tx``
    (an update every ``accum_grad`` micro-steps), in place.  Metrics hold
    the λs from before the update."""
    grad_fn = make_grad_fn(teacher, cfg)

    def step(state: TrainState, batch, *, gate_u: Optional[dict] = None):
        metrics, grads = grad_fn(state, batch, gate_u=gate_u)
        tx.step(grads, state.opt_state, state.named_params())
        state.step += 1
        return state, metrics

    return step


def make_eval_step(teacher: Wav2Vec2Model, cfg: DistillConfig):
    """Validation step ``eval_step(state, batch, gates) -> metrics``: dropout
    off, the compiled eval gates (``compile_gates``) passed in."""
    original = float(_teacher_numel(teacher))

    @torch.no_grad()
    def eval_step(state: TrainState, batch, gates):
        _, metrics = _distill_forward(
            teacher, state.student, cfg, original, _param_tree(state), batch, state.step,
            None, False, gates,
        )
        return metrics

    return eval_step
