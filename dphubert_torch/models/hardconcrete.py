"""Hard Concrete distribution for L0 regularisation, as functions of
``log_alpha`` tensors (the TPU package's ``models/hardconcrete.py``).

Constants:
  beta (temperature)   = 2/3
  stretch              = 0.1   => support stretched to [-0.1, 1.1]
  bias                 = -beta * log(-l/r) = -beta * log(0.1/1.1)
  eps                  = 1e-6
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

BETA = 2.0 / 3.0
LIMIT_L = -0.1
LIMIT_R = 1.1
BIAS = -BETA * math.log(-LIMIT_L / LIMIT_R)
EPS = 1e-6


def l0_norm(log_alpha: torch.Tensor) -> torch.Tensor:
    """Differentiable expected number of alive units:
    ``sum(sigmoid(log_alpha + bias))``."""
    return torch.sigmoid(log_alpha + BIAS).sum()


def sample_mask(
    log_alpha: torch.Tensor, generator: Optional[torch.Generator] = None,
    u: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Training-mode stochastic mask, differentiable in ``log_alpha``:
    u ~ U(eps, 1-eps); s = sigmoid((logit(u) + log_alpha)/beta); stretch to
    [-0.1, 1.1]; clamp to [0, 1].

    ``u`` injects the uniform draw (the tests hand both packages the same
    one); otherwise it is drawn from ``generator`` on log_alpha's device."""
    if u is None:
        u = torch.rand(log_alpha.shape, generator=generator, dtype=log_alpha.dtype,
                       device=log_alpha.device) * (1.0 - 2 * EPS) + EPS
    else:
        if not isinstance(u, torch.Tensor):
            u = torch.from_numpy(np.array(u))  # a copy: numpy draws may be read-only
        u = u.to(dtype=log_alpha.dtype, device=log_alpha.device)
    s = torch.sigmoid((torch.log(u / (1.0 - u)) + log_alpha) / BETA)
    s = s * (LIMIT_R - LIMIT_L) + LIMIT_L
    return torch.clamp(s, 0.0, 1.0)


def eval_mask(log_alpha) -> np.ndarray:
    """Eval-mode deterministic mask, on the host in numpy (a copy of the TPU
    package's): soft = sigmoid(log_alpha / beta * 0.8) with the
    ``round(n - l0_norm)`` smallest entries zeroed."""
    if isinstance(log_alpha, torch.Tensor):
        log_alpha = log_alpha.detach().cpu().numpy()
    log_alpha = np.asarray(log_alpha, dtype=np.float64)
    n = log_alpha.shape[0]
    expected_num_zeros = n - float(
        np.sum(1.0 / (1.0 + np.exp(-(log_alpha + BIAS))))
    )
    # python round() (banker's rounding), as the reference
    num_zeros = int(round(expected_num_zeros))
    soft = 1.0 / (1.0 + np.exp(-(log_alpha / BETA * 0.8)))
    if num_zeros > 0:
        order = np.argsort(soft, kind="stable")
        soft[order[:num_zeros]] = 0.0
    return soft.astype(np.float32)
