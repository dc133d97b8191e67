"""Mask surgery: a gated model and its log_alphas -> a smaller dense model."""

from .surgery import prune_model

__all__ = ["prune_model"]
