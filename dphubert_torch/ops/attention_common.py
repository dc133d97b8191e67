"""What the attention kernels and their plain versions share: the mask
constant, the dropout hash's plain version and threshold, the plain scores
(with WavLM's gated bias where given), softmax and backward on the (B, H, L,
D) layout, and the checks a wrapper makes before it hands pointers to a
kernel."""

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


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """fp32 for fp32 and bf16 inputs (the kernels' accumulation type);
    float64 stays float64 so gradcheck can run the plain versions."""
    return torch.promote_types(dtype, torch.float32)


def keep_mask(seed: torch.Tensor, dropout_rate: float, B: int, H: int, L: int, device):
    """The (B, H, L, L) keep mask of every (batch, head, row, column) for
    the one-element int32 ``seed``."""
    b = torch.arange(B, device=device).view(B, 1, 1, 1)
    h = torch.arange(H, device=device).view(1, H, 1, 1)
    return dropout_keep_mask((L, L), 1.0 - dropout_rate, int(seed.reshape(-1)[0]), b, h,
                             device=device)


def scores(q: torch.Tensor, k: torch.Tensor, lengths: Optional[torch.Tensor], scale: float,
           bias: Optional[torch.Tensor] = None, gate: Optional[torch.Tensor] = None):
    """(B, H, L, L) scores of (B, H, L, D) q and k in ``acc_dtype``:
    scale * q k^T, plus gate[b, h, i] * bias[h, i, j] where a WavLM bias is
    given ((H, L, L) bias, (B, H, L) gate), with the key columns at or past
    ``lengths[b]`` masked with NEG_INF as the kernels mask them."""
    acc = acc_dtype(q.dtype)
    L = q.shape[2]
    s = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) * scale
    if bias is not None:
        s = s + gate.to(acc)[..., None] * bias.to(acc)[None]
    if lengths is not None:
        valid = torch.arange(L, device=q.device)[None, :] < lengths.to(q.device)[:, None]
        s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    return s


def softmax_parts(q: torch.Tensor, k: torch.Tensor, lengths: Optional[torch.Tensor],
                  scale: float, bias: Optional[torch.Tensor] = None,
                  gate: Optional[torch.Tensor] = None):
    """The ``scores`` softmax as the kernels take it: the unnormalised p =
    exp(s - m), the (B, H, L, 1) row max m, sum l and 1/l (taken as 1 where
    l is 0)."""
    s = scores(q, k, lengths, scale, bias, gate)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    l_inv = torch.where(l == 0.0, torch.ones_like(l), 1.0 / l)
    return p, m, l, l_inv


def attention_bwd_plain(q, k, v, out, dout, lengths, scale: float, dropout_rate: float,
                        seed: Optional[torch.Tensor], bias: Optional[torch.Tensor] = None,
                        gate: Optional[torch.Tensor] = None, round_operands: bool = False):
    """(dq, dk, dv) of (B, H, L, D) tensors in ``acc_dtype``, by the formulas
    of the TPU backward kernels (flash ``_bwd_dq_kernel`` /
    ``_bwd_dkv_kernel``, packed ``_heads_loop_bwd_dq`` / ``_dkv``, WavLM
    ``_bwd_*_kernel``): p recomputed and normalised; dp = dout v^T, dropped
    and scaled; di = rowsum(out * dout); ds = p (dp - di); dq = scale ds k,
    dk = scale ds^T q, dv = p~^T dout with p~ the dropped, scaled p.  With a
    WavLM bias also (dbias, dgate): dbias[h, i, j] = sum_b gate ds and
    dgate[b, h, i] = sum_j ds bias, from the unscaled ds.

    ``round_operands`` rounds p~ and scale * ds to q's dtype before the
    three products, as the tensor-core kernels of ``csrc/attention_bwd.cu``
    and ``csrc/wavlm_attention.cu`` do with bf16 inputs (their A operands);
    dbias and dgate keep the unrounded ds.  For fp32 and float64 inputs the
    rounding is the identity."""
    acc = acc_dtype(q.dtype)
    p, _, _, l_inv = softmax_parts(q, k, lengths, scale, bias, gate)
    p = p * l_inv
    do = dout.to(acc)
    dp = torch.matmul(do, v.to(acc).transpose(-1, -2))
    if dropout_rate > 0.0:
        B, H, L, _ = q.shape
        keep = keep_mask(seed, dropout_rate, B, H, L, q.device)
        inv_keep = 1.0 / (1.0 - dropout_rate)
        p_used = torch.where(keep, p * inv_keep, 0.0)
        dp = torch.where(keep, dp * inv_keep, 0.0)
    else:
        p_used = p
    di = (out.to(acc) * do).sum(dim=-1, keepdim=True)
    ds = p * (dp - di)
    ds_scaled = ds * scale
    if round_operands:
        ds_scaled = ds_scaled.to(q.dtype).to(acc)
        p_used = p_used.to(q.dtype).to(acc)
    dq = torch.matmul(ds_scaled, k.to(acc))
    dk = torch.matmul(ds_scaled.transpose(-1, -2), q.to(acc))
    dv = torch.matmul(p_used.transpose(-1, -2), do)
    if bias is None:
        return dq, dk, dv
    dbias = (gate.to(acc)[..., None] * ds).sum(dim=0)
    dgate = (ds * bias.to(acc)[None]).sum(dim=-1)
    return dq, dk, dv, dbias, dgate


def kernel_body(dtype: torch.dtype, head_dim: int) -> str:
    """Which body the packed and flash entries of ``csrc/attention_fwd.cu``
    and ``csrc/attention_bwd.cu`` run: "wgmma" (tensor cores) for bf16 at
    head_dim 64, "fma" (fp32 on the CUDA cores) otherwise."""
    return "wgmma" if dtype == torch.bfloat16 and head_dim == 64 else "fma"


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
            f"{name} is forward-only; the differentiable forms are "
            "PackedAttentionFn (ops/packed_attention.py), FlashAttentionFn "
            "(ops/flash_attention.py) and WavLMAttentionFn (ops/wavlm_attention.py)"
        )


def stream(t: torch.Tensor) -> int:
    """The current CUDA stream of t's card, as the C interface takes it."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check_rows(name: str, t: torch.Tensor, like: torch.Tensor, shape, dtype) -> None:
    """Raise unless t is a contiguous ``dtype`` tensor of ``shape`` on
    like's device."""
    if t.device != like.device or t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name} must be {dtype} of shape {tuple(shape)} on {like.device}, "
            f"got {t.dtype}/{tuple(t.shape)}/{t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
