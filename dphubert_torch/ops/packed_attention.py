"""Attention on the packed (B, L, H*D) layout: forward, backward, autograd.

Three kernel wrappers, each beside its plain version:

* ``packed_attention`` launches ``packed_attention_fwd`` of
  ``csrc/attention_fwd.cu`` (plain version ``packed_attention_reference``);
* ``packed_attention_bwd_dq`` and ``packed_attention_bwd_dkv`` launch the
  kernels of the same names in ``csrc/attention_bwd.cu`` (plain version
  ``packed_attention_bwd_reference``).

Each wrapper runs its plain version on CPU tensors and launches its kernel
on CUDA tensors or raises; each counts its kernel's launches in a
``launches`` attribute.  ``PackedAttentionFn`` pairs the forward with the
two backward kernels for autograd: it takes the fused QKV projection output
(B, L, 3*H*D) whole, reads q, k and v as strided views of it, and writes dq,
dk and dv into one gradient buffer of the same shape.  It saves the QKV
tensor, the output and the forward's row statistics (m, l), never p or the
dropout mask, which the backward kernels regenerate from the seed.

Dropout on the attention probabilities is the TPU package's counter hash
(``attention_common.dropout_keep_mask``), seeded by one int32 on the
tensors' device, so on the card no seed passes through the host.

``packed_num_groups`` is the TPU package's routing rule, copied as it is:
on the TPU it split the heads into groups that fit scoped VMEM.  The CUDA
kernels need no group split, but the model keeps the rule to choose between
these kernels and ``flash_attention``, so that the port routes each shape as
the TPU package does.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from ._build import bind
from .attention_common import (
    DTYPE_CODES,
    _ceil_to,
    acc_dtype,
    attention_bwd_plain,
    check_kernel_inputs,
    check_rows,
    check_seed,
    dropout_args,
    forward_only,
    keep_mask,
    softmax_parts,
    stream,
)

LANES = 128
MAX_PACKED_KV = 1024
_SINGLE_GROUP_KV = 768
_SINGLE_GROUP_WIDTH = 768
_GROUP_WIDTH_CAP = 512


def packed_num_groups(L: int, num_heads: int, head_dim: int) -> int:
    """Head-group count of the TPU packed kernel for a shape, or 0 if that
    kernel could not run it (the caller then takes ``flash_attention``)."""
    HD = num_heads * head_dim
    block_q = min(256, _ceil_to(L, LANES))
    Lp = _ceil_to(L, block_q)
    if Lp > MAX_PACKED_KV:
        return 0
    if Lp <= _SINGLE_GROUP_KV and HD <= _SINGLE_GROUP_WIDTH:
        return 1
    for n_g in range(2, num_heads + 1):
        if num_heads % n_g:
            continue
        gw = (num_heads // n_g) * head_dim
        if gw % LANES == 0 and gw <= _GROUP_WIDTH_CAP:
            return n_g
    return 0


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, L, H*D) -> (B, H, L, D) view."""
    B, L, HD = x.shape
    return x.reshape(B, L, num_heads, HD // num_heads).transpose(1, 2)


def _packed(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(B, H, L, D) -> (B, L, H*D) in ``dtype``."""
    B, H, L, D = x.shape
    return x.transpose(1, 2).reshape(B, L, H * D).to(dtype)


def packed_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    lengths: Optional[torch.Tensor] = None, *, num_heads: int,
    scale: Optional[float] = None, dropout_rate: float = 0.0,
    seed: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version of the forward: matmul, masked softmax, dropout,
    matmul, in fp32 (float64 for float64 inputs).

    Key columns at or past ``lengths[b]`` are masked with NEG_INF; padded
    query rows still attend to the valid keys.  With dropout, p is zeroed
    where the hash drops it and 1/l is divided by (1 - rate), as
    ``_heads_loop_fwd``.  The normalised p is rounded to v's dtype before the
    PV product, as the TPU packed kernel does."""
    B, L, HD = q.shape
    D = HD // num_heads
    if scale is None:
        scale = D ** -0.5
    p, _, _, l_inv = softmax_parts(_heads(q, num_heads), _heads(k, num_heads), lengths, scale)
    if dropout_rate > 0.0:
        p = torch.where(keep_mask(seed, dropout_rate, B, num_heads, L, q.device), p, 0.0)
        l_inv = l_inv / (1.0 - dropout_rate)
    out = torch.matmul((p * l_inv).to(v.dtype).to(p.dtype), _heads(v, num_heads).to(p.dtype))
    return _packed(out, q.dtype)


def packed_attention_bwd_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    dout: torch.Tensor, lengths: Optional[torch.Tensor] = None, *,
    num_heads: int, scale: Optional[float] = None, dropout_rate: float = 0.0,
    seed: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward pair, (dq, dk, dv) in q's dtype from
    the formulas of ``_heads_loop_bwd_dq`` / ``_heads_loop_bwd_dkv`` in fp32
    (float64 for float64 inputs): p recomputed; dp = dout v^T, dropped and
    scaled; di = rowsum(out * dout); ds = p (dp - di) scale; dq = ds k,
    dk = ds^T q, dv = p~^T dout with p~ the dropped, scaled p.  For bf16
    inputs p~ and ds are rounded to bf16 before the products, as the
    kernels' tensor-core operands are."""
    D = q.shape[-1] // num_heads
    if scale is None:
        scale = D ** -0.5
    grads = attention_bwd_plain(*(_heads(t, num_heads) for t in (q, k, v, out, dout)),
                                lengths, scale, dropout_rate, seed, round_operands=True)
    return tuple(_packed(g, q.dtype) for g in grads)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


_P, _I, _U, _F, _LL = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                       ctypes.c_float, ctypes.c_longlong)


@functools.lru_cache(maxsize=None)
def _fwd_kernel():
    return bind("attention_fwd", "packed_attention_fwd", [
        _P, _P, _P, _P, _P, _P, _P, _P, _U, _F, _I, _I, _I, _I, _LL, _LL, _F,
        _I, _P,
    ])


@functools.lru_cache(maxsize=None)
def _dq_kernel():
    return bind("attention_bwd", "packed_attention_bwd_dq", [
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _U, _F, _I, _I, _I, _I,
        _LL, _LL, _LL, _LL, _F, _I, _P,
    ])


@functools.lru_cache(maxsize=None)
def _dkv_kernel():
    return bind("attention_bwd", "packed_attention_bwd_dkv", [
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _U, _F, _I, _I, _I, _I,
        _LL, _LL, _LL, _LL, _F, _I, _P,
    ])


def _head_dim(q: torch.Tensor, num_heads: int) -> int:
    HD = q.shape[-1]
    if HD % num_heads:
        raise ValueError(f"width {HD} is not num_heads={num_heads} x head_dim")
    return HD // num_heads


def _check_grad_views(views, q: torch.Tensor) -> None:
    for t in views:
        if (t.device != q.device or t.dtype != q.dtype or t.shape != q.shape
                or t.stride(-1) != 1 or t.stride() != views[0].stride()):
            raise ValueError("gradient views must match q in device, dtype and "
                             "shape, with one set of strides and unit last stride")


def _launch_fwd(q, k, v, lengths, seed, num_heads, scale, dropout_rate, stats):
    B, L, HD = q.shape
    D = _head_dim(q, num_heads)
    check_kernel_inputs(q, k, v, lengths, D)
    check_seed(seed, dropout_rate, q.device)
    out = torch.empty((B, L, HD), dtype=q.dtype, device=q.device)
    m = l = None
    if stats:
        m = torch.empty((B, num_heads, L), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
    seed_ptr, threshold, inv_keep = dropout_args(dropout_rate, seed)
    rc = _fwd_kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if m is None else m.data_ptr(), None if l is None else l.data_ptr(),
        None if lengths is None else lengths.data_ptr(), seed_ptr, threshold,
        inv_keep, B, L, num_heads, D, q.stride(0), q.stride(1), float(scale),
        DTYPE_CODES[q.dtype], stream(q),
    )
    if rc != 0:
        raise RuntimeError(f"packed_attention_fwd launch failed: cudaError {rc}")
    packed_attention.launches += 1
    return out, m, l


def packed_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    lengths: Optional[torch.Tensor] = None, *, num_heads: int,
    scale: Optional[float] = None, dropout_rate: float = 0.0,
    seed: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """softmax(scale * q k^T + key mask) v on (B, L, num_heads*head_dim),
    forward only (``PackedAttentionFn`` is the differentiable form).

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise.  q, k and v may be strided views (unit stride in the last
    dimension, one set of strides for all three); lengths is an int32 (B,)
    tensor of valid key counts or None; with ``dropout_rate`` > 0, ``seed``
    is a one-element int32 tensor on the same device."""
    D = _head_dim(q, num_heads)
    if scale is None:
        scale = D ** -0.5
    forward_only("packed_attention", q, k, v)
    if q.device.type == "cpu":
        return packed_attention_reference(
            q, k, v, lengths, num_heads=num_heads, scale=scale,
            dropout_rate=dropout_rate, seed=seed,
        )
    out, _, _ = _launch_fwd(q, k, v, lengths, seed, num_heads, scale, dropout_rate,
                            stats=False)
    return out


packed_attention.launches = 0


def packed_attention_bwd_dq(
    q, k, v, out, dout, m, l, lengths=None, *, num_heads: int, scale: float,
    dropout_rate: float = 0.0, seed: Optional[torch.Tensor] = None,
    dq: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """dq and di = rowsum(out * dout) per head, (B, H, L) fp32.

    q, k, v as for ``packed_attention``; out and dout contiguous (B, L, H*D);
    m and l the forward's (B, H, L) fp32 statistics.  ``dq`` may be a view
    to write into (e.g. a slice of a (B, L, 3*H*D) gradient buffer).  CPU
    tensors take the plain version (m and l unused there)."""
    B, L, HD = q.shape
    D = _head_dim(q, num_heads)
    if q.device.type == "cpu":
        acc = acc_dtype(q.dtype)
        got, _, _ = packed_attention_bwd_reference(
            q, k, v, out, dout, lengths, num_heads=num_heads, scale=scale,
            dropout_rate=dropout_rate, seed=seed,
        )
        di = (out.to(acc) * dout.to(acc)).reshape(B, L, num_heads, D).sum(-1)
        if dq is not None:
            dq.copy_(got)
            got = dq
        return got, di.transpose(1, 2).contiguous()
    check_kernel_inputs(q, k, v, lengths, D)
    check_seed(seed, dropout_rate, q.device)
    for name, t in (("out", out), ("dout", dout)):
        check_rows(name, t, q, (B, L, HD), q.dtype)
    for name, t in (("m", m), ("l", l)):
        check_rows(name, t, q, (B, num_heads, L), torch.float32)
    if dq is None:
        dq = torch.empty((B, L, HD), dtype=q.dtype, device=q.device)
    _check_grad_views([dq], q)
    di = torch.empty((B, num_heads, L), dtype=torch.float32, device=q.device)
    seed_ptr, threshold, inv_keep = dropout_args(dropout_rate, seed)
    rc = _dq_kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
        m.data_ptr(), l.data_ptr(), di.data_ptr(), dq.data_ptr(),
        None if lengths is None else lengths.data_ptr(), seed_ptr, threshold,
        inv_keep, B, L, num_heads, D, q.stride(0), q.stride(1), dq.stride(0),
        dq.stride(1), float(scale), DTYPE_CODES[q.dtype], stream(q),
    )
    if rc != 0:
        raise RuntimeError(f"packed_attention_bwd_dq launch failed: cudaError {rc}")
    packed_attention_bwd_dq.launches += 1
    return dq, di


packed_attention_bwd_dq.launches = 0


def packed_attention_bwd_dkv(
    q, k, v, out, dout, m, l, di, lengths=None, *, num_heads: int, scale: float,
    dropout_rate: float = 0.0, seed: Optional[torch.Tensor] = None,
    dk: Optional[torch.Tensor] = None, dv: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """dk and dv, reading the di that ``packed_attention_bwd_dq`` wrote.

    Arguments as for ``packed_attention_bwd_dq``; ``dk`` and ``dv`` may be
    views to write into.  CPU tensors take the plain version (out feeds its
    di there; m, l and di are unused)."""
    B, L, HD = q.shape
    D = _head_dim(q, num_heads)
    if q.device.type == "cpu":
        _, gk, gv = packed_attention_bwd_reference(
            q, k, v, out, dout, lengths, num_heads=num_heads, scale=scale,
            dropout_rate=dropout_rate, seed=seed,
        )
        if dk is not None:
            gk = dk.copy_(gk)
        if dv is not None:
            gv = dv.copy_(gv)
        return gk, gv
    check_kernel_inputs(q, k, v, lengths, D)
    check_seed(seed, dropout_rate, q.device)
    check_rows("dout", dout, q, (B, L, HD), q.dtype)
    for name, t in (("m", m), ("l", l), ("di", di)):
        check_rows(name, t, q, (B, num_heads, L), torch.float32)
    if dk is None:
        dk = torch.empty((B, L, HD), dtype=q.dtype, device=q.device)
    if dv is None:
        dv = torch.empty((B, L, HD), dtype=q.dtype, device=q.device)
    _check_grad_views([dk, dv], q)
    seed_ptr, threshold, inv_keep = dropout_args(dropout_rate, seed)
    rc = _dkv_kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), m.data_ptr(),
        l.data_ptr(), di.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        None if lengths is None else lengths.data_ptr(), seed_ptr, threshold,
        inv_keep, B, L, num_heads, D, q.stride(0), q.stride(1), dk.stride(0),
        dk.stride(1), float(scale), DTYPE_CODES[q.dtype], stream(q),
    )
    if rc != 0:
        raise RuntimeError(f"packed_attention_bwd_dkv launch failed: cudaError {rc}")
    packed_attention_bwd_dkv.launches += 1
    return dk, dv


packed_attention_bwd_dkv.launches = 0


# ---------------------------------------------------------------------------
# Autograd
# ---------------------------------------------------------------------------


class PackedAttentionFn(torch.autograd.Function):
    """Differentiable packed attention on the fused QKV output.

    ``apply(qkv, lengths, seed, num_heads, scale, dropout_rate)``: qkv is
    (B, L, 3*H*D) with q, k, v in that order along the last dimension;
    returns (B, L, H*D).  The gradient is one (B, L, 3*H*D) tensor."""

    @staticmethod
    def forward(ctx, qkv, lengths, seed, num_heads, scale, dropout_rate):
        HD = qkv.shape[-1] // 3
        q, k, v = qkv.split(HD, dim=-1)
        if qkv.device.type == "cpu":
            out = packed_attention_reference(
                q, k, v, lengths, num_heads=num_heads, scale=scale,
                dropout_rate=dropout_rate, seed=seed,
            )
            m = l = None
        else:
            out, m, l = _launch_fwd(q, k, v, lengths, seed, num_heads, scale,
                                    dropout_rate, stats=True)
        ctx.save_for_backward(qkv, out, m, l, lengths, seed)
        ctx.attn = (num_heads, scale, dropout_rate)
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, out, m, l, lengths, seed = ctx.saved_tensors
        num_heads, scale, dropout_rate = ctx.attn
        B, L, W = qkv.shape
        HD = W // 3
        q, k, v = qkv.split(HD, dim=-1)
        dout = dout.contiguous()
        kw = dict(num_heads=num_heads, scale=scale, dropout_rate=dropout_rate, seed=seed)
        if qkv.device.type == "cpu":
            dqkv = torch.cat(packed_attention_bwd_reference(q, k, v, out, dout, lengths, **kw),
                             dim=-1)
        else:
            dqkv = torch.empty((B, L, W), dtype=qkv.dtype, device=qkv.device)
            dq, dk, dv = dqkv.split(HD, dim=-1)
            _, di = packed_attention_bwd_dq(q, k, v, out, dout, m, l, lengths, dq=dq, **kw)
            packed_attention_bwd_dkv(q, k, v, out, dout, m, l, di, lengths, dk=dk, dv=dv, **kw)
        return dqkv, None, None, None, None, None


def packed_attention_qkv(
    qkv: torch.Tensor, lengths: Optional[torch.Tensor] = None, *,
    num_heads: int, scale: Optional[float] = None, dropout_rate: float = 0.0,
    seed: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The model's entry: attention of the fused QKV output (B, L, 3*H*D),
    through ``PackedAttentionFn`` when autograd needs its gradient and
    through the forward-only ``packed_attention`` otherwise."""
    HD = qkv.shape[-1] // 3
    if scale is None:
        scale = _head_dim(qkv[..., :HD], num_heads) ** -0.5
    if torch.is_grad_enabled() and qkv.requires_grad:
        return PackedAttentionFn.apply(qkv, lengths, seed, num_heads, float(scale),
                                       float(dropout_rate))
    q, k, v = qkv.split(HD, dim=-1)
    return packed_attention(q, k, v, lengths, num_heads=num_heads, scale=scale,
                            dropout_rate=dropout_rate, seed=seed)
