"""What the attention kernels and their plain versions share: the mask
constant and the checks a wrapper makes before it hands pointers to a
kernel."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

# finite mask value of the TPU kernels: exp(NEG_INF - m) is exactly 0 for
# any real row max m, and a fully masked row still has a finite max
NEG_INF = -0.7 * float(np.finfo(np.float32).max)

# dtype codes of the C interface in csrc/attention_fwd.cu
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# head widths the kernel is instantiated for: the presets' 64 and 80
HEAD_DIMS = (64, 80)


def _ceil_to(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def check_kernel_inputs(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    lengths: Optional[torch.Tensor], head_dim: int,
) -> None:
    """Raise unless q, k, v and lengths are what the CUDA kernel takes:
    CUDA tensors of one supported dtype, one shape and one set of strides,
    unit stride along the head dimension, no autograd, and int32 lengths of
    shape (B,) on the same card."""
    if q.device.type != "cuda":
        raise ValueError(f"attention kernel needs CUDA tensors, got {q.device}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype or t.shape != q.shape:
            raise ValueError(
                f"{name} must match q in device, dtype and shape: "
                f"{t.device}/{t.dtype}/{tuple(t.shape)} vs "
                f"{q.device}/{q.dtype}/{tuple(q.shape)}"
            )
        if t.stride() != q.stride():
            raise ValueError(f"{name} strides {t.stride()} != q strides {q.stride()}")
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"attention kernel takes float32 or bfloat16, got {q.dtype}")
    if q.stride(-1) != 1:
        raise ValueError("attention kernel needs unit stride in the last dimension")
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"head_dim {head_dim} not in {HEAD_DIMS}")
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise NotImplementedError(
            "attention kernels are forward-only: the backward kernels come "
            "with the training slice (ROADMAP queue 2); run under "
            "torch.no_grad() or torch.inference_mode()"
        )
    if lengths is not None:
        if (lengths.device != q.device or lengths.dtype != torch.int32
                or lengths.shape != (q.shape[0],) or not lengths.is_contiguous()):
            raise ValueError(
                "lengths must be a contiguous (B,) int32 tensor on the card, "
                f"got {lengths.device}/{lengths.dtype}/{tuple(lengths.shape)}"
            )
