"""Attention on the (B, H, L, D) layout: forward, backward, autograd.

Three kernel wrappers, each beside its plain version:

* ``flash_attention`` launches ``flash_attention_fwd`` of
  ``csrc/attention_fwd.cu`` (plain version ``flash_attention_reference``);
  besides ``out`` it returns the row max ``m`` and the row sum ``l`` as
  (B, H, L) fp32 tensors, which the backward kernels read;
* ``flash_attention_bwd_dq`` and ``flash_attention_bwd_dkv`` launch the
  kernels of the same names in ``csrc/attention_bwd.cu`` (plain version
  ``flash_attention_bwd_reference``).

Each wrapper runs its plain version on CPU tensors and launches its kernel
on CUDA tensors or raises; each counts its kernel's launches in a
``launches`` attribute.  ``FlashAttentionFn`` pairs the forward with the two
backward kernels for autograd, as the TPU package's ``_flash`` custom VJP
does; it saves q, k, v, the output and (m, l), never p or the dropout mask,
which the backward kernels regenerate from the seed.  Dropout is the TPU
package's counter hash at absolute (b, h, row, col), seeded by one int32 on
the tensors' device.

The model takes this route for the shapes ``packed_num_groups`` refuses:
padded lengths past 1024 frames (clips longer than 20 s), and head counts
whose width the TPU packed kernel could not group (11 or 9 heads of 64 at
the 780 frames of a 15.6 s clip: the stage-3 final distill of a pruned
student).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from ._build import bind
from .attention_common import (
    DTYPE_CODES,
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


def flash_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    lengths: Optional[torch.Tensor] = None, *, scale: Optional[float] = None,
    dropout_rate: float = 0.0, seed: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version: matmul, masked softmax, dropout, matmul, in fp32
    (float64 for float64 inputs).

    As the TPU flash kernel: the unnormalised p = exp(s - m) is zeroed where
    the hash drops it and rounded to v's dtype before the PV product; l is
    the undropped sum, and the sum is divided by l and by (1 - rate)
    afterwards.  Returns (out, m, l) with m and l of shape (B, H, L)."""
    B, H, L, D = q.shape
    if scale is None:
        scale = D ** -0.5
    p, m, l, l_inv = softmax_parts(q, k, lengths, scale)
    if dropout_rate > 0.0:
        p = torch.where(keep_mask(seed, dropout_rate, B, H, L, q.device), p, 0.0)
        l_inv = l_inv / (1.0 - dropout_rate)
    out = torch.matmul(p.to(v.dtype).to(p.dtype), v.to(p.dtype)) * l_inv
    return out.to(q.dtype), m[..., 0], l[..., 0]


def flash_attention_bwd_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    dout: torch.Tensor, lengths: Optional[torch.Tensor] = None, *,
    scale: Optional[float] = None, dropout_rate: float = 0.0,
    seed: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward pair: (dq, dk, dv) in q's dtype by the
    formulas of ``_bwd_dq_kernel`` / ``_bwd_dkv_kernel``
    (``attention_common.attention_bwd_plain``)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    grads = attention_bwd_plain(q, k, v, out, dout, lengths, scale, dropout_rate, seed)
    return tuple(g.to(q.dtype) for g in grads)


_P, _I, _U, _F, _LL = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                       ctypes.c_float, ctypes.c_longlong)


@functools.lru_cache(maxsize=None)
def _fwd_kernel():
    return bind("attention_fwd", "flash_attention_fwd", [
        _P, _P, _P, _P, _P, _P, _P, _P, _U, _F, _I, _I, _I, _I, _LL, _LL, _LL,
        _F, _I, _P,
    ])


@functools.lru_cache(maxsize=None)
def _dq_kernel():
    return bind("attention_bwd", "flash_attention_bwd_dq", [
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _U, _F, _I, _I, _I, _I,
        _LL, _LL, _LL, _F, _I, _P,
    ])


@functools.lru_cache(maxsize=None)
def _dkv_kernel():
    return bind("attention_bwd", "flash_attention_bwd_dkv", [
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _U, _F, _I, _I, _I, _I,
        _LL, _LL, _LL, _F, _I, _P,
    ])


def _launch_fwd(q, k, v, lengths, seed, scale, dropout_rate):
    B, H, L, D = q.shape
    check_kernel_inputs(q, k, v, lengths, D)
    check_seed(seed, dropout_rate, q.device)
    out = torch.empty((B, H, L, D), dtype=q.dtype, device=q.device)
    m = torch.empty((B, H, L), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    seed_ptr, threshold, inv_keep = dropout_args(dropout_rate, seed)
    rc = _fwd_kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), m.data_ptr(),
        l.data_ptr(), None if lengths is None else lengths.data_ptr(), seed_ptr,
        threshold, inv_keep, B, H, L, D, q.stride(0), q.stride(1), q.stride(2),
        float(scale), DTYPE_CODES[q.dtype], stream(q),
    )
    if rc != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: cudaError {rc}")
    flash_attention.launches += 1
    return out, m, l


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    lengths: Optional[torch.Tensor] = None, *, scale: Optional[float] = None,
    dropout_rate: float = 0.0, seed: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """softmax(scale * q k^T + key mask) v on (B, H, L, D) -> (out, m, l),
    forward only (``FlashAttentionFn`` is the differentiable form).

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise.  q, k and v may be strided views (unit stride in the last
    dimension, one set of strides for all three); out is contiguous.
    lengths is an int32 (B,) tensor of valid key counts or None; with
    ``dropout_rate`` > 0, ``seed`` is a one-element int32 tensor on the same
    device."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    forward_only("flash_attention", q, k, v)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, lengths, scale=scale,
                                         dropout_rate=dropout_rate, seed=seed)
    return _launch_fwd(q, k, v, lengths, seed, scale, dropout_rate)


flash_attention.launches = 0


def _check_stats(q, out, dout, stats):
    B, H, L, D = q.shape
    for name, t in (("out", out), ("dout", dout)):
        if t is not None:
            check_rows(name, t, q, (B, H, L, D), q.dtype)
    for name, t in stats:
        check_rows(name, t, q, (B, H, L), torch.float32)


def flash_attention_bwd_dq(
    q, k, v, out, dout, m, l, lengths=None, *, scale: float,
    dropout_rate: float = 0.0, seed: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """dq (B, H, L, D) and di = rowsum(out * dout), (B, H, L) fp32.

    q, k, v as for ``flash_attention``; out and dout contiguous (B, H, L,
    D); m and l the forward's statistics.  CPU tensors take the plain
    version (m and l unused there)."""
    if q.device.type == "cpu":
        dq, _, _ = flash_attention_bwd_reference(q, k, v, out, dout, lengths, scale=scale,
                                                 dropout_rate=dropout_rate, seed=seed)
        acc = acc_dtype(q.dtype)
        return dq, (out.to(acc) * dout.to(acc)).sum(-1)
    B, H, L, D = q.shape
    check_kernel_inputs(q, k, v, lengths, D)
    check_seed(seed, dropout_rate, q.device)
    _check_stats(q, out, dout, (("m", m), ("l", l)))
    dq = torch.empty((B, H, L, D), dtype=q.dtype, device=q.device)
    di = torch.empty((B, H, L), dtype=torch.float32, device=q.device)
    seed_ptr, threshold, inv_keep = dropout_args(dropout_rate, seed)
    rc = _dq_kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
        m.data_ptr(), l.data_ptr(), di.data_ptr(), dq.data_ptr(),
        None if lengths is None else lengths.data_ptr(), seed_ptr, threshold, inv_keep,
        B, H, L, D, q.stride(0), q.stride(1), q.stride(2), float(scale),
        DTYPE_CODES[q.dtype], stream(q),
    )
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd_dq launch failed: cudaError {rc}")
    flash_attention_bwd_dq.launches += 1
    return dq, di


flash_attention_bwd_dq.launches = 0


def flash_attention_bwd_dkv(
    q, k, v, out, dout, m, l, di, lengths=None, *, scale: float,
    dropout_rate: float = 0.0, seed: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """dk and dv (B, H, L, D), reading the di that ``flash_attention_bwd_dq``
    wrote.  Arguments as for ``flash_attention_bwd_dq``; CPU tensors take
    the plain version (out feeds its di there; m, l and di are unused)."""
    if q.device.type == "cpu":
        _, dk, dv = flash_attention_bwd_reference(q, k, v, out, dout, lengths, scale=scale,
                                                  dropout_rate=dropout_rate, seed=seed)
        return dk, dv
    B, H, L, D = q.shape
    check_kernel_inputs(q, k, v, lengths, D)
    check_seed(seed, dropout_rate, q.device)
    _check_stats(q, None, dout, (("m", m), ("l", l), ("di", di)))
    dk = torch.empty((B, H, L, D), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    seed_ptr, threshold, inv_keep = dropout_args(dropout_rate, seed)
    rc = _dkv_kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), m.data_ptr(),
        l.data_ptr(), di.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        None if lengths is None else lengths.data_ptr(), seed_ptr, threshold, inv_keep,
        B, H, L, D, q.stride(0), q.stride(1), q.stride(2), float(scale),
        DTYPE_CODES[q.dtype], stream(q),
    )
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd_dkv launch failed: cudaError {rc}")
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_bwd_dkv.launches = 0


class FlashAttentionFn(torch.autograd.Function):
    """Differentiable attention on (B, H, L, D):
    ``apply(q, k, v, lengths, seed, scale, dropout_rate) -> out``, with the
    gradients of q, k and v as contiguous (B, H, L, D) tensors."""

    @staticmethod
    def forward(ctx, q, k, v, lengths, seed, scale, dropout_rate):
        if q.device.type == "cpu":
            out, _, _ = flash_attention_reference(q, k, v, lengths, scale=scale,
                                                  dropout_rate=dropout_rate, seed=seed)
            m = l = None
        else:
            out, m, l = _launch_fwd(q, k, v, lengths, seed, scale, dropout_rate)
        ctx.save_for_backward(q, k, v, out, m, l, lengths, seed)
        ctx.attn = (scale, dropout_rate)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, m, l, lengths, seed = ctx.saved_tensors
        scale, dropout_rate = ctx.attn
        dout = dout.contiguous()
        kw = dict(scale=scale, dropout_rate=dropout_rate, seed=seed)
        if q.device.type == "cpu":
            dq, dk, dv = flash_attention_bwd_reference(q, k, v, out, dout, lengths, **kw)
        else:
            dq, di = flash_attention_bwd_dq(q, k, v, out, dout, m, l, lengths, **kw)
            dk, dv = flash_attention_bwd_dkv(q, k, v, out, dout, m, l, di, lengths, **kw)
        return dq, dk, dv, None, None, None, None


def flash_attention_qkv(
    qkv: torch.Tensor, lengths: Optional[torch.Tensor] = None, *,
    num_heads: int, scale: Optional[float] = None, dropout_rate: float = 0.0,
    seed: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The model's entry: attention of the fused QKV output (B, L, 3*H*D) ->
    (B, L, H*D), through ``FlashAttentionFn`` when autograd needs its
    gradient and through the forward-only ``flash_attention`` otherwise.
    q, k and v are (B, H, L, D) views of qkv, read in place."""
    B, L, W = qkv.shape
    HD = W // 3
    D = HD // num_heads
    if scale is None:
        scale = D ** -0.5
    q, k, v = (t.view(B, L, num_heads, D).transpose(1, 2) for t in qkv.split(HD, dim=-1))
    if torch.is_grad_enabled() and qkv.requires_grad:
        out = FlashAttentionFn.apply(q, k, v, lengths, seed, float(scale), float(dropout_rate))
    else:
        out, _, _ = flash_attention(q, k, v, lengths, scale=scale,
                                    dropout_rate=dropout_rate, seed=seed)
    return out.transpose(1, 2).reshape(B, L, HD)
