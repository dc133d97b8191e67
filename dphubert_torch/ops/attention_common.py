"""What the attention kernels and their plain versions share: the mask
constant, the dropout hash's plain version and threshold, and the checks a
wrapper makes before it hands pointers to a kernel."""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

# finite mask value of the TPU kernels: exp(NEG_INF - m) is exactly 0 for
# any real row max m, and a fully masked row still has a finite max
NEG_INF = -0.7 * float(np.finfo(np.float32).max)

# dtype codes of the C interface in csrc/attention_*.cu
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# head widths the kernels are instantiated for: the presets' 64 and 80
HEAD_DIMS = (64, 80)

_U32 = 0xFFFFFFFF
_SEED_B = 0x9E3779B1
_SEED_H = 0x85EBCA77
_ROW = 0x27D4EB2F
_COL = 0x165667B1
_MIX1 = 0x7FEB352D
_MIX2 = 0x846CA68B


def _ceil_to(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def dropout_threshold(keep: float) -> int:
    """The hash's keep threshold: ``uint32(min(keep, 1) * 4294967295.0)``,
    truncated from a double as the TPU package computes it (0.9 gives
    3865470565, the product being ...565.5)."""
    return int(np.uint32(min(keep, 1.0) * 4294967295.0))


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32): split c in 16-bit halves
    so no int64 product overflows."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def dropout_keep_mask(
    shape: Sequence[int], keep: float, seed: int,
    b: Union[int, torch.Tensor], h: Union[int, torch.Tensor],
    q_off: int = 0, kv_off: int = 0, device=None,
) -> torch.Tensor:
    """Plain version of the kernels' dropout mask, bit for bit the TPU
    package's ``_dropout_keep_mask``: a murmur3-finalizer hash of (seed +
    b*0x9E3779B1 + h*0x85EBCA77, absolute row, absolute column), kept where
    the hash is <= ``dropout_threshold(keep)``.

    ``shape`` is (rows, cols); ``seed`` an int32 value (reinterpreted as
    uint32); ``b`` and ``h`` ints or int64 tensors that broadcast against
    (..., rows, cols), e.g. shapes (B, 1, 1, 1) and (1, H, 1, 1) for a (B, H,
    rows, cols) mask.  uint32 arithmetic is done in int64 with a mask after
    every product and sum."""
    rows, cols = shape
    b = torch.as_tensor(b, dtype=torch.int64, device=device)
    h = torch.as_tensor(h, dtype=torch.int64, device=device)
    s = ((int(seed) & _U32) + _mul32(b & _U32, _SEED_B) + _mul32(h & _U32, _SEED_H)) & _U32
    r = (torch.arange(rows, dtype=torch.int64, device=device) + q_off) & _U32
    c = (torch.arange(cols, dtype=torch.int64, device=device) + kv_off) & _U32
    x = _mul32(r, _ROW)[:, None] ^ _mul32(c, _COL)[None, :] ^ s
    x = x ^ (x >> 16)
    x = _mul32(x, _MIX1)
    x = x ^ (x >> 15)
    x = _mul32(x, _MIX2)
    x = x ^ (x >> 16)
    return x <= dropout_threshold(keep)


def check_kernel_inputs(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    lengths: Optional[torch.Tensor], head_dim: int,
) -> None:
    """Raise unless q, k, v and lengths are what the CUDA kernels take:
    CUDA tensors of one supported dtype, one shape and one set of strides,
    unit stride along the head dimension, and int32 lengths of shape (B,) on
    the same card."""
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
    if lengths is not None:
        if (lengths.device != q.device or lengths.dtype != torch.int32
                or lengths.shape != (q.shape[0],) or not lengths.is_contiguous()):
            raise ValueError(
                "lengths must be a contiguous (B,) int32 tensor on the card, "
                f"got {lengths.device}/{lengths.dtype}/{tuple(lengths.shape)}"
            )


def check_seed(seed: Optional[torch.Tensor], dropout_rate: float, device) -> None:
    """A kernel with dropout reads its seed from one int32 on the card."""
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {dropout_rate}")
    if dropout_rate > 0.0 and (
        seed is None or seed.device != device or seed.dtype != torch.int32
        or seed.numel() != 1
    ):
        raise ValueError("dropout needs seed: a one-element int32 tensor on the card")


def dropout_args(dropout_rate: float, seed: Optional[torch.Tensor]):
    """(seed pointer, threshold, 1/keep) of the C interface; a null seed
    turns dropout off."""
    if dropout_rate <= 0.0:
        return None, 0, 1.0
    keep = 1.0 - dropout_rate
    return seed.data_ptr(), dropout_threshold(keep), 1.0 / keep


def forward_only(name: str, *tensors: torch.Tensor) -> None:
    """Raise if autograd would need a gradient through a forward-only call."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name} is forward-only; the differentiable packed attention is "
            "PackedAttentionFn (ops/packed_attention.py), and the flash "
            "backward kernels are not ported yet (ROADMAP queue 2, item 2)"
        )
