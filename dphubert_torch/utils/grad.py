"""Gradient utilities.

``grad_multiply`` is the reference's ``GradMultiply`` autograd function
(``components.py:1401-1411``, fairseq-style feature-extractor gradient
scaling; the TPU package's ``utils/grad.py``): identity forward, cotangent
times ``scale`` backward.
"""

from __future__ import annotations

import torch


class _GradMultiply(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.scale, None


def grad_multiply(x: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """``x`` unchanged; its gradient is multiplied by ``scale``."""
    return _GradMultiply.apply(x, scale)
