"""Distillation loss (the TPU package's ``train/losses.py``, its per-layer
``distill_loss_unstacked`` form).

Per selected layer: project the student's hidden state to the teacher's
width, then MSE + L1 + cosine over the feature axis in fp32 (``raw`` is
``-mean(cos)``, ``log_sig`` is ``-mean(log sigmoid(cos))``); the total
averages the per-layer terms, which equals the reference's mean over the
stacked (batch, layer, time, feature) tensors since every layer has the
same shape.
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
            cos = cosine_similarity(s32, t32)
            if cos_type == "raw":
                acc_cos = acc_cos - cos.mean()
            else:
                acc_cos = acc_cos - torch.log(torch.sigmoid(cos)).mean()
    n = float(len(pairs))
    loss_mse, loss_l1, loss_cos = acc_mse / n, acc_l1 / n, acc_cos / n
    total = l2_weight * loss_mse + l1_weight * loss_l1 + cos_weight * loss_cos
    return total, (loss_mse, loss_l1, loss_cos)
