"""Three-group AdamW with Lagrangian dual ascent (the TPU package's
``train/optim.py``), written out in tensor ops.

Parameter groups over the training parameters, keyed by dotted name
(``student.<state-dict key>``, ``projs.groups.<g>.weight``,
``lambdas.lambda1``):

  * ``main``      student parameters (minus ``log_alpha``) and projections:
                  AdamW at ``learning_rate`` with decoupled weight decay;
  * ``log_alpha`` HardConcrete parameters: Adam at ``reg_learning_rate``;
  * ``lambda``    the two Lagrange multipliers: Adam at ``reg_learning_rate``
                  with the step's sign flipped, i.e. gradient *ascent* (dual
                  ascent; the reference feeds torch.optim.AdamW
                  ``lr=-reg_lr``, which torch's own AdamW refuses, so the
                  update is written out here).  The moments see the raw
                  gradients.

One update, as optax's chain in the TPU package:
  1. clip all gradients jointly by their global norm: scaled by
     ``clip_norm / norm`` only when ``norm >= clip_norm``;
  2. Adam moments (b1 0.9, b2 0.999, eps 1e-8) with bias correction at the
     update count + 1;
  3. ``+ weight_decay * param`` where the group decays;
  4. times ``sign * base_lr * linear_decay_factor(count)``, one schedule
     factor for every group.

``accum_grad > 1`` is optax's ``MultiSteps``: micro-step gradients are
averaged (the running-mean form) and one update is applied every
``accum_grad`` calls; the schedules run on the update count.  Updates are
in place; the moments are fp32 tensors beside the parameters.

The per-update scalars (the bias corrections, the schedule factor and each
group's step size, ``scalars``) are computed on the host in float32 as
before and read by the update from a small tensor on the parameters'
device, never as Python numbers baked into the launch: a CUDA graph of
several steps (``distill_module.make_train_step``) then replays with each
step's own values, and an eager step does the same arithmetic.  Only the
update count and the accumulation phase stay host integers (``tick``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from .schedules import linear_decay_factor

B1, B2, EPS = 0.9, 0.999, 1e-8
GROUPS = ("main", "log_alpha", "lambda")
# the layout of ``DistillOptimizer.scalars``: then one step size per group
SCALARS = ("bc1", "bc2", "lr_factor") + tuple(f"step_size_{g}" for g in GROUPS)


def param_label(name: str) -> str:
    """The optimizer group of a dotted parameter name."""
    parts = name.split(".")
    if parts[0] == "lambdas":
        return "lambda"
    if "log_alpha" in parts:
        return "log_alpha"
    return "main"


def _norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


def global_norm(tensors: List[torch.Tensor], over: Optional[List[tuple]] = None) -> torch.Tensor:
    """sqrt(sum of squares) over all tensors, as a 0-dim fp32 tensor.

    On a mesh (``over``: for each tensor the process groups that split it,
    empty for a whole one): a block's squares are summed over the groups
    that split it (the model group for a tensor-parallel leaf, the data
    group for an FSDP one, both for HSDP) and a whole tensor is counted
    once, so every rank gets the one-card norm."""
    if over is None or not any(over):
        return _norm(tensors)
    from ..parallel.comm import sum_over

    classes: Dict[tuple, List[torch.Tensor]] = {}
    for t, groups in zip(tensors, over):
        classes.setdefault(tuple(groups), []).append(t)
    sq = None
    for groups, part in classes.items():
        s = _norm(part).square()
        for group in groups:
            s = sum_over(s, group)
        sq = s if sq is None else sq + s
    return sq.sqrt()


@dataclass
class OptState:
    """Adam moments per parameter name, the update count, and the gradient
    accumulator of ``accum_grad > 1`` (``mini_step`` micro-steps in it)."""

    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    count: int = 0
    mini_step: int = 0
    acc: Optional[Dict[str, torch.Tensor]] = None


class DistillOptimizer:
    """``build_optimizer`` of the TPU package; ``init`` makes the state and
    ``step`` applies one micro-step's gradients in place."""

    def __init__(
        self, *, learning_rate: float, weight_decay: float, warmup_updates: int,
        max_updates: int, clip_norm: float, use_reg: bool,
        reg_learning_rate: float = 0.0, accum_grad: int = 1,
    ):
        self.base_lr = {"main": learning_rate}
        self.weight_decay = {"main": weight_decay}
        self.sign = {"main": -1.0}
        if use_reg:
            self.base_lr.update(log_alpha=reg_learning_rate, **{"lambda": reg_learning_rate})
            self.weight_decay.update(log_alpha=0.0, **{"lambda": 0.0})
            self.sign.update(log_alpha=-1.0, **{"lambda": +1.0})  # dual ascent
        self.warmup_updates = warmup_updates
        self.max_updates = max_updates
        self.clip_norm = clip_norm
        self.accum_grad = max(int(accum_grad), 1)
        self.norm_groups: Dict[str, tuple] = {}

    def shard_norm(self, groups: Dict[str, tuple]) -> None:
        """The clip's norm over a state on a mesh: ``groups`` gives, by
        parameter name, the process groups whose ranks hold the blocks of
        that parameter (``global_norm``); a name it lacks is whole."""
        self.norm_groups = dict(groups)

    def norm(self, names: List[str], tensors: List[torch.Tensor]) -> torch.Tensor:
        """The global norm of the tensors of parameters ``names``."""
        over = [self.norm_groups.get(n, ()) for n in names] if self.norm_groups else None
        return global_norm(tensors, over)

    def init(self, params: Dict[str, torch.Tensor]) -> OptState:
        missing = sorted({param_label(n) for n in params} - set(self.base_lr))
        if missing:
            raise ValueError(
                f"parameters labelled {missing} have no optimizer group "
                "(use_reg=False takes a student without HardConcrete gates)"
            )
        zeros = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()}
        return OptState(
            mu=zeros,
            nu={n: torch.zeros_like(t) for n, t in zeros.items()},
            acc=({n: torch.zeros_like(t) for n, t in zeros.items()}
                 if self.accum_grad > 1 else None),
        )

    def scalars(self, count: int) -> np.ndarray:
        """The update's scalars at update count ``count`` (0 at the first
        update), float32 in the order of ``SCALARS``: the bias corrections
        1 - b ** (count + 1) (as optax computes decay ** count), the
        schedule factor and sign x base_lr x factor per group (0 for a
        group this optimizer does not have)."""
        count_inc = np.float32(count + 1)
        bc1 = float(1 - np.float32(B1) ** count_inc)
        bc2 = float(1 - np.float32(B2) ** count_inc)
        factor = linear_decay_factor(count, self.warmup_updates, self.max_updates)
        sizes = [float(np.float32(self.sign[g] * self.base_lr[g] * factor))
                 if g in self.base_lr else 0.0 for g in GROUPS]
        return np.array([bc1, bc2, factor, *sizes], np.float32)

    def tick(self, state: OptState) -> bool:
        """The host half of one micro-step: the accumulation phase and the
        update count move on; True when this micro-step applies an
        update."""
        if self.accum_grad > 1:
            state.mini_step += 1
            if state.mini_step < self.accum_grad:
                return False
            state.mini_step = 0
        state.count += 1
        return True

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor], state: OptState,
             params: Dict[str, torch.Tensor],
             scalars: Optional[torch.Tensor] = None) -> bool:
        """One micro-step; returns True when it applied an update.
        ``scalars`` is ``self.scalars(state.count)`` as a float32 tensor on
        the parameters' device (made here when not given)."""
        if scalars is None:
            device = next(iter(params.values())).device
            scalars = torch.from_numpy(self.scalars(state.count)).to(device, non_blocking=True)
        phase = state.mini_step
        applies = self.tick(state)
        if self.accum_grad > 1:
            names = list(grads)
            acc = [state.acc[n] for n in names]
            # acc + (g - acc) / (n + 1): optax MultiSteps' running mean
            delta = torch._foreach_sub([grads[n] for n in names], acc)
            torch._foreach_div_(delta, float(phase + 1))
            torch._foreach_add_(acc, delta)
            if not applies:
                return False
            grads = {n: a.clone() for n, a in zip(names, acc)}
            for a in acc:
                a.zero_()
        self._update(grads, state, params, scalars)
        return True

    def _update(self, grads, state: OptState, params, scalars: torch.Tensor) -> None:
        names = list(grads)
        g_all = [grads[n].float() for n in names]
        if self.clip_norm and self.clip_norm > 0:
            norm = self.norm(names, g_all)
            scale = torch.where(norm < self.clip_norm, torch.ones_like(norm),
                                self.clip_norm / norm)
            torch._foreach_mul_(g_all, scale)
        bc1, bc2 = scalars[0], scalars[1]
        by_group: Dict[str, List[int]] = {}
        for i, n in enumerate(names):
            by_group.setdefault(param_label(n), []).append(i)
        for group, idx in by_group.items():
            g = [g_all[i] for i in idx]
            mu = [state.mu[names[i]] for i in idx]
            nu = [state.nu[names[i]] for i in idx]
            p = [params[names[i]] for i in idx]
            torch._foreach_mul_(mu, B1)
            torch._foreach_add_(mu, g, alpha=1 - B1)
            torch._foreach_mul_(nu, B2)
            torch._foreach_addcmul_(nu, g, g, value=1 - B2)
            denom = torch._foreach_div(nu, bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, EPS)
            upd = torch._foreach_div(mu, bc1)
            torch._foreach_div_(upd, denom)
            if self.weight_decay[group]:
                torch._foreach_add_(upd, p, alpha=self.weight_decay[group])
            torch._foreach_mul_(upd, scalars[SCALARS.index(f"step_size_{group}")])
            torch._foreach_add_(p, upd)
