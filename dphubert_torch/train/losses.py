"""Distillation loss (the TPU package's ``train/losses.py``).

MSE + L1 + cosine over the feature axis in fp32 (``raw`` is
``-mean(cos)``, ``log_sig`` is ``-mean(log sigmoid(cos))``), in two forms:
``distill_loss`` over stacked (batch, layer, time, feature) tensors, the
reference's own (``apply_projections`` stacks the student's side), and
``distill_loss_unstacked``, which projects and reduces layer by layer and
averages the per-layer terms; since every layer has the same shape the two
are equal.  The distill step runs the unstacked form, which never holds
the stacked copies.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F


def cosine_similarity(a, b, dim: int = -1, eps: float = 1e-8):
    """torch.nn.CosineSimilarity semantics as the TPU package writes them:
    each norm clamped at eps, in fp32."""
    a32, b32 = a.float(), b.float()
    na = torch.linalg.vector_norm(a32, dim=dim).clamp_min(eps)
    nb = torch.linalg.vector_norm(b32, dim=dim).clamp_min(eps)
    return (a32 * b32).sum(dim=dim) / (na * nb)


def _cos_term(cos: torch.Tensor, cos_type: str) -> torch.Tensor:
    if cos_type == "raw":
        return -cos.mean()
    return -torch.log(torch.sigmoid(cos)).mean()


def distill_loss(
    student: torch.Tensor,
    teacher: torch.Tensor,
    *,
    l2_weight: float,
    l1_weight: float,
    cos_weight: float,
    cos_type: str = "raw",
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Returns (total, (mse, l1, cos)) over stacked ``student`` and
    ``teacher`` (batch, n_layers, time, dim) tensors, reduced in fp32; a
    term whose weight is 0 is 0."""
    if cos_type not in ("raw", "log_sig"):
        raise ValueError(cos_type)
    s32, t32 = student.float(), teacher.float()
    zero = torch.zeros((), dtype=torch.float32, device=s32.device)
    loss_mse = (s32 - t32).square().mean() if l2_weight != 0 else zero
    loss_l1 = (s32 - t32).abs().mean() if l1_weight != 0 else zero
    loss_cos = _cos_term(cosine_similarity(s32, t32), cos_type) if cos_weight != 0 else zero
    total = l2_weight * loss_mse + l1_weight * loss_l1 + cos_weight * loss_cos
    return total, (loss_mse, loss_l1, loss_cos)


def distill_loss_unstacked(
    proj_params: dict,
    mode: str,
    groups: Sequence[Sequence[int]],
    student_hiddens,
    teacher_hiddens,
    distill_layers: Sequence[int],
    *,
    l2_weight: float,
    l1_weight: float,
    cos_weight: float,
    cos_type: str = "raw",
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Returns (total, (mse, l1, cos)); the teacher's hidden states are
    constants (detached)."""
    if cos_type not in ("raw", "log_sig"):
        raise ValueError(cos_type)
    pairs = []  # (projection params, student layer index) per stacked slot
    if mode == "layer2layer":
        for gi, g in enumerate(groups):
            for layer_idx in g:
                pairs.append((proj_params["groups"][str(gi)], layer_idx))
    elif mode == "predlayer":
        for li in range(sum(len(g) for g in groups)):
            pairs.append((proj_params["groups"][str(li)], None))
    else:
        raise ValueError(f"Invalid distill mode: {mode}")

    device = student_hiddens[0].device
    zero = torch.zeros((), dtype=torch.float32, device=device)
    acc_mse, acc_l1, acc_cos = zero, zero, zero
    for slot, (p, layer_idx) in enumerate(pairs):
        h = student_hiddens[layer_idx] if mode == "layer2layer" else student_hiddens[-1]
        s = F.linear(h, p["weight"].to(h.dtype), p["bias"].to(h.dtype))
        if mode == "predlayer":
            s = F.gelu(s)
        t = teacher_hiddens[distill_layers[slot]].detach()
        s32, t32 = s.float(), t.float()
        if l2_weight != 0:
            acc_mse = acc_mse + (s32 - t32).square().mean()
        if l1_weight != 0:
            acc_l1 = acc_l1 + (s32 - t32).abs().mean()
        if cos_weight != 0:
            acc_cos = acc_cos + _cos_term(cosine_similarity(s32, t32), cos_type)
    n = float(len(pairs))
    loss_mse, loss_l1, loss_cos = acc_mse / n, acc_l1 / n, acc_cos / n
    total = l2_weight * loss_mse + l1_weight * loss_l1 + cos_weight * loss_cos
    return total, (loss_mse, loss_l1, loss_cos)
