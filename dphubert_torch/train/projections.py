"""Distillation projection heads (the TPU package's ``train/projections.py``).

Two modes:
  * ``layer2layer``: layers in the same group share one Linear,
    identity-initialised; one set of weights per group.
  * ``predlayer``: DistilHuBERT style, an independent Linear+GELU per distill
    layer, applied to the student's last layer.

Parameters are a nested dict ``{"groups": {str(g): {"weight", "bias"}}}`` of
float32 tensors.  State-dict interop duplicates a group's shared weights
into per-slot keys (``{i}.weight``, predlayer ``{i}.0.weight``) on export
and reads slot 0 of each group on import, as the reference's checkpoints.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


def parse_layer_groups(distill_layers: str) -> Tuple[Tuple[int, ...], ...]:
    """Periods separate groups, commas separate layers within a group
    ("0.4,8,12" -> ((0,), (4, 8, 12)))."""
    return tuple(
        tuple(int(l) for l in g.split(",")) for g in distill_layers.split(".")
    )


def flatten_groups(groups: Sequence[Sequence[int]]) -> Tuple[int, ...]:
    out: List[int] = []
    for g in groups:
        out.extend(g)
    return tuple(out)


def init_projections(
    mode: str,
    groups: Sequence[Sequence[int]],
    student_dim: int,
    teacher_dim: int,
    generator: Optional[torch.Generator] = None,
    device="cpu",
) -> dict:
    """Projection parameters; predlayer draws U(-1/sqrt(in), 1/sqrt(in))
    from ``generator`` (a CPU generator), layer2layer is the identity."""
    if mode == "layer2layer":
        gp = {}
        for gi in range(len(groups)):
            w = torch.zeros(teacher_dim, student_dim)
            n = min(teacher_dim, student_dim)
            w[:n, :n] = torch.eye(n)
            gp[str(gi)] = {"weight": w.to(device), "bias": torch.zeros(teacher_dim, device=device)}
        return {"groups": gp}
    if mode == "predlayer":
        bound = 1.0 / math.sqrt(student_dim)
        gp = {}
        for li in range(len(flatten_groups(groups))):
            w = torch.empty(teacher_dim, student_dim).uniform_(-bound, bound, generator=generator)
            b = torch.empty(teacher_dim).uniform_(-bound, bound, generator=generator)
            gp[str(li)] = {"weight": w.to(device), "bias": b.to(device)}
        return {"groups": gp}
    raise ValueError(f"Invalid distill mode: {mode}")


def projections_to_state_dict(
    proj_params: dict, mode: str, groups: Sequence[Sequence[int]]
) -> Dict[str, np.ndarray]:
    """Duplicate shared group weights into per-slot keys like the reference
    (``{i}.weight`` / predlayer ``{i}.0.weight``)."""
    def host(t):
        return t.detach().cpu().numpy().copy()

    out = {}
    slot = 0
    if mode == "layer2layer":
        for gi, g in enumerate(groups):
            p = proj_params["groups"][str(gi)]
            for _ in g:
                out[f"{slot}.weight"] = host(p["weight"])
                out[f"{slot}.bias"] = host(p["bias"])
                slot += 1
    else:
        for li in range(len(flatten_groups(groups))):
            p = proj_params["groups"][str(li)]
            out[f"{li}.0.weight"] = host(p["weight"])
            out[f"{li}.0.bias"] = host(p["bias"])
    return out


def projections_from_state_dict(
    sd: Dict[str, np.ndarray], mode: str, groups: Sequence[Sequence[int]], device="cpu",
) -> dict:
    """Inverse of :func:`projections_to_state_dict` (slot 0 of each group
    carries the shared weights)."""
    def dev(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32)).to(device)

    gp = {}
    if mode == "layer2layer":
        slot = 0
        for gi, g in enumerate(groups):
            gp[str(gi)] = {"weight": dev(sd[f"{slot}.weight"]), "bias": dev(sd[f"{slot}.bias"])}
            slot += len(g)
    else:
        for li in range(len(flatten_groups(groups))):
            gp[str(li)] = {"weight": dev(sd[f"{li}.0.weight"]), "bias": dev(sd[f"{li}.0.bias"])}
    return {"groups": gp}
