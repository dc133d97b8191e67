"""Plain reference of one DPHuBERT stage-1 step (DPHuBERT, Peng et al.
2023; its ``lightning.py``): the frozen teacher's hidden states, the gated
student with dropout, the layer-to-layer distillation loss (L1 + cosine
through one linear projection per group of layers), the Lagrangian sparsity
term lambda1 (s - t) + lambda2 (s - t)^2 on the expected model size, and one
update of the three-group AdamW (main parameters at the learning rate, the
HardConcrete log-alphas and the multipliers at the regularisation rate, the
multipliers by gradient ascent), after clipping by the global norm.

Parameters are named as the step names them: ``student.<state-dict key>``,
``projs.groups.<g>.weight`` / ``.bias``, ``lambdas.lambda1`` / ``lambda2``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from . import model as M

BETA, LIMIT_L, LIMIT_R, HC_EPS = 2.0 / 3.0, -0.1, 1.1, 1e-6
HC_BIAS = -BETA * math.log(-LIMIT_L / LIMIT_R)
B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8


@dataclass(frozen=True)
class Recipe:
    """The stage-1 recipe's settings (a configuration file's ``recipe``)."""

    groups: Tuple[Tuple[int, ...], ...]
    l1_weight: float
    cos_weight: float
    learning_rate: float
    reg_learning_rate: float
    warmup_updates: int
    max_updates: int
    clip_norm: float
    target_sparsity: float
    sparsity_warmup_updates: int

    @staticmethod
    def of(d: dict) -> "Recipe":
        d = dict(d)
        d["groups"] = tuple(tuple(g) for g in d["groups"])
        return Recipe(**d)


# ---------------------------------------------------------------------------
# HardConcrete gates and the expected size
# ---------------------------------------------------------------------------


def gate_keys(config: dict) -> List[Tuple[Tuple[str, ...], str]]:
    """(gate tree path, its log_alpha's key) for every gate, in draw order:
    the conv layers, then per encoder layer heads, attention layer, FFN
    units, FFN layer."""
    a = M.arch(config)
    conv_gate, heads_gate, att_gate, interm_gate, ff_gate = a.prune
    out = []
    if conv_gate:
        for i in range(len(a.conv)):
            out.append((("conv_layers", str(i)),
                        f"feature_extractor.conv_layers.{i}.hard_concrete.log_alpha"))
    for i, layer in enumerate(a.layers):
        p = f"encoder.transformer.layers.{i}."
        if layer.heads:
            if heads_gate:
                out.append((("layers", str(i), "attention", "heads"),
                            p + "attention.hard_concrete_for_heads.log_alpha"))
            if att_gate:
                out.append((("layers", str(i), "attention", "layer"),
                            p + "attention.hard_concrete_for_layer.log_alpha"))
        if layer.ffn:
            if interm_gate:
                out.append((("layers", str(i), "feed_forward", "intermediate"),
                            p + "feed_forward.hard_concrete_for_intermediate.log_alpha"))
            if ff_gate:
                out.append((("layers", str(i), "feed_forward", "layer"),
                            p + "feed_forward.hard_concrete_for_layer.log_alpha"))
    return out


def sample_gates(config: dict, P: Dict[str, torch.Tensor], draws: M.Draws) -> Optional[dict]:
    """Training masks: u ~ U(eps, 1 - eps), s = sigmoid((logit u + log_alpha)
    / beta), stretched to [-0.1, 1.1] and clamped to [0, 1]."""
    keys = gate_keys(config)
    if not keys:
        return None
    tree: dict = {}
    for path, key in keys:
        la = P[key]
        u = draws.uniform(la.shape) * (1.0 - 2 * HC_EPS) + HC_EPS
        s = torch.sigmoid((torch.log(u / (1.0 - u)) + la) / BETA)
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = torch.clamp(s * (LIMIT_R - LIMIT_L) + LIMIT_L, 0.0, 1.0)
    return tree


def l0(la: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(la + HC_BIAS).sum()


def expected_size(config: dict, P: Dict[str, torch.Tensor]):
    """The model's parameter count with every gated dimension replaced by
    its gate's expected L0 norm (DPHuBERT's size accounting: conv, the
    feature projection, the positional conv, attention and FFN blocks)."""
    a = M.arch(config)
    total, cin = 0, 1
    for i, (c, k, _) in enumerate(a.conv):
        la = P.get(f"feature_extractor.conv_layers.{i}.hard_concrete.log_alpha")
        cout = l0(la) if la is not None else c
        n = cin * cout * k
        if a.conv_bias:
            n = n + cout
        if (a.group_norm and i == 0) or not a.group_norm:
            n = n + 2 * cout
        total = total + n
        cin = cout
    total = total + cin  # the dummy weight
    e, kk, g = a.embed, a.pos_kernel, a.pos_groups
    total = total + cin * 2 + (cin + 1) * e + (kk + e * (e // g) * kk + e) + 2 * e
    for i, layer in enumerate(a.layers):
        p = f"encoder.transformer.layers.{i}."
        n = 4 * e
        if layer.heads:
            la = P.get(p + "attention.hard_concrete_for_heads.log_alpha")
            nh = l0(la) if la is not None else layer.heads
            d = a.head_dim
            att = (e + 1) * nh * d * 3 + (nh * d + 1) * e
            la = P.get(p + "attention.hard_concrete_for_layer.log_alpha")
            n = n + (att * l0(la) if la is not None else att)
        if layer.ffn:
            la = P.get(p + "feed_forward.hard_concrete_for_intermediate.log_alpha")
            f = l0(la) if la is not None else layer.ffn
            ff = (e + 1) * f + (f + 1) * e
            la = P.get(p + "feed_forward.hard_concrete_for_layer.log_alpha")
            n = n + (ff * l0(la) if la is not None else ff)
        total = total + n
    return total


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def _cos(a, b, eps=1e-8):
    return (a * b).sum(-1) / (a.norm(dim=-1).clamp_min(eps) * b.norm(dim=-1).clamp_min(eps))


def distill_loss(projs, student_h, teacher_h, recipe: Recipe, prec=M.FP32):
    """Mean over the distilled layers of l1 * mean|s - t| - cos * mean cos(s, t),
    s the student layer through its group's projection."""
    l1 = cos = 0.0
    n = 0
    for gi, g in enumerate(recipe.groups):
        w, b = projs[f"groups.{gi}.weight"], projs[f"groups.{gi}.bias"]
        for layer in g:
            s = M.linear(student_h[layer], w, b, prec)
            t = teacher_h[layer]
            l1 = l1 + (s - t).abs().mean()
            cos = cos - _cos(s, t).mean()
            n += 1
    l1, cos = l1 / n, cos / n
    return recipe.l1_weight * l1 + recipe.cos_weight * cos


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------


def target_sparsity(recipe: Recipe, count: int) -> float:
    return recipe.target_sparsity * min(count / max(recipe.sparsity_warmup_updates, 1), 1.0)


def lr_factor(recipe: Recipe, count: int) -> float:
    """Linear warmup to the base rate, then linear decay to 0 at max_updates
    (the step count t = count + 1)."""
    t = count + 1
    if t >= recipe.max_updates:
        return 0.0
    if t <= recipe.warmup_updates:
        return t / recipe.warmup_updates
    return (recipe.max_updates - t) / (recipe.max_updates - recipe.warmup_updates)


def group_of(name: str) -> str:
    if name.startswith("lambdas."):
        return "lambda"
    return "log_alpha" if name.endswith("log_alpha") else "main"


class Trainer:
    """The student, projections, multipliers and AdamW state, updated in
    place by ``step``; ``teacher`` is the teacher's parameter dict."""

    def __init__(self, teacher_cfg: dict, teacher: Dict[str, torch.Tensor], student_cfg: dict,
                 student: Dict[str, torch.Tensor], recipe: Recipe, prec=M.FP32):
        self.tcfg, self.scfg, self.recipe, self.prec = teacher_cfg, student_cfg, recipe, prec
        self.teacher = teacher
        self.original = float(sum(t.numel() for t in teacher.values()))
        dev = next(iter(student.values())).device
        e_s, e_t = M.arch(student_cfg).embed, M.arch(teacher_cfg).embed
        self.params: Dict[str, torch.Tensor] = {
            f"student.{k}": v.detach().clone().requires_grad_(True) for k, v in student.items()}
        for gi in range(len(recipe.groups)):
            w = torch.zeros(e_t, e_s, device=dev)
            n = min(e_t, e_s)
            w[:n, :n] = torch.eye(n, device=dev)
            self.params[f"projs.groups.{gi}.weight"] = w.requires_grad_(True)
            self.params[f"projs.groups.{gi}.bias"] = torch.zeros(e_t, device=dev,
                                                                 requires_grad=True)
        for k in ("lambda1", "lambda2"):
            self.params[f"lambdas.{k}"] = torch.zeros((), device=dev, requires_grad=True)
        self.mu = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.count = 0

    def loss_and_grads(self, wave: torch.Tensor, draws: M.Draws, grads: bool = True):
        """(loss, {name: gradient}) of one step on a float batch (B, T);
        with ``grads`` false, (loss, None), drawing the same numbers."""
        if not grads:
            with torch.no_grad():
                return self._loss(wave, draws).detach(), None
        loss = self._loss(wave, draws)
        P = self.params
        names = list(P)
        got = torch.autograd.grad(loss, [P[n] for n in names], allow_unused=True)
        return loss.detach(), {n: (torch.zeros_like(P[n]) if g is None else g)
                               for n, g in zip(names, got)}

    def _loss(self, wave: torch.Tensor, draws: M.Draws) -> torch.Tensor:
        recipe, P = self.recipe, self.params
        student = {k[len("student."):]: v for k, v in P.items() if k.startswith("student.")}
        gates = sample_gates(self.scfg, student, draws)
        with torch.no_grad():
            teacher_h, _ = M.extract_features(self.teacher, self.tcfg, wave, prec=self.prec)
        student_h, _ = M.extract_features(student, self.scfg, wave, gates=gates, draws=draws,
                                          prec=self.prec)
        projs = {k[len("projs."):]: v for k, v in P.items() if k.startswith("projs.")}
        loss = distill_loss(projs, student_h, teacher_h, recipe, self.prec)
        s = 1.0 - expected_size(self.scfg, student) / self.original
        t = target_sparsity(recipe, self.count)
        return loss + P["lambdas.lambda1"] * (s - t) + P["lambdas.lambda2"] * (s - t) ** 2

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Clip, then one AdamW update in place; returns the clipped
        gradients (what the optimizer's moments take in)."""
        recipe = self.recipe
        norm = torch.sqrt(sum(g.double().square().sum() for g in grads.values()))
        scale = 1.0 if norm < recipe.clip_norm else recipe.clip_norm / float(norm)
        clipped = {n: g * scale for n, g in grads.items()}
        c = self.count + 1
        bc1, bc2 = 1 - B1 ** c, 1 - B2 ** c
        f = lr_factor(recipe, self.count)
        size = {"main": -recipe.learning_rate * f, "log_alpha": -recipe.reg_learning_rate * f,
                "lambda": recipe.reg_learning_rate * f}
        for n, g in clipped.items():
            self.mu[n].mul_(B1).add_(g, alpha=1 - B1)
            self.nu[n].mul_(B2).addcmul_(g, g, value=1 - B2)
            upd = (self.mu[n] / bc1) / ((self.nu[n] / bc2).sqrt() + ADAM_EPS)
            self.params[n].add_(upd * size[group_of(n)])
        self.count += 1
        return clipped

    def step(self, wave: torch.Tensor, draws: M.Draws):
        loss, grads = self.loss_and_grads(wave, draws)
        return loss, self.update(grads)


def pcm_to_float(pcm: torch.Tensor) -> torch.Tensor:
    """int16 PCM to float32 in [-1, 1)."""
    return pcm.float() / 32768.0
