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

from ._build import load_library
from .attention_common import (
    DTYPE_CODES,
    NEG_INF,
    _ceil_to,
    check_kernel_inputs,
    check_seed,
    dropout_args,
    dropout_keep_mask,
    forward_only,
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


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """fp32 for fp32 and bf16 inputs (the kernels' accumulation type);
    float64 stays float64 so gradcheck can run the plain versions."""
    return torch.promote_types(dtype, torch.float32)


def _keep_mask(seed: torch.Tensor, dropout_rate: float, B: int, H: int, L: int, device):
    b = torch.arange(B, device=device).view(B, 1, 1, 1)
    h = torch.arange(H, device=device).view(1, H, 1, 1)
    return dropout_keep_mask((L, L), 1.0 - dropout_rate, int(seed.reshape(-1)[0]), b, h,
                             device=device)


def _softmax_parts(q, k, lengths, num_heads, scale):
    """(B, H, L, L) normalised p and the (B, H, L, 1) row sums' inverse,
    from scores masked as the kernels mask them."""
    B, L, HD = q.shape
    D = HD // num_heads
    acc = _acc_dtype(q.dtype)

    def heads(x):  # (B, L, H*D) -> (B, H, L, D)
        return x.reshape(B, L, num_heads, D).transpose(1, 2).to(acc)

    s = torch.matmul(heads(q), heads(k).transpose(-1, -2)) * scale
    if lengths is not None:
        valid = torch.arange(L, device=q.device)[None, :] < lengths.to(q.device)[:, None]
        s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    l_inv = torch.where(l == 0.0, torch.ones_like(l), 1.0 / l)
    return p, l_inv, heads


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
    p, l_inv, heads = _softmax_parts(q, k, lengths, num_heads, scale)
    if dropout_rate > 0.0:
        p = torch.where(_keep_mask(seed, dropout_rate, B, num_heads, L, q.device), p, 0.0)
        l_inv = l_inv / (1.0 - dropout_rate)
    out = torch.matmul((p * l_inv).to(v.dtype).to(p.dtype), heads(v))
    return out.transpose(1, 2).reshape(B, L, HD).to(q.dtype)


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
    dk = ds^T q, dv = p~^T dout with p~ the dropped, scaled p."""
    B, L, HD = q.shape
    D = HD // num_heads
    if scale is None:
        scale = D ** -0.5
    p, l_inv, heads = _softmax_parts(q, k, lengths, num_heads, scale)
    p = p * l_inv
    do = heads(dout)
    dp = torch.matmul(do, heads(v).transpose(-1, -2))
    if dropout_rate > 0.0:
        keep = _keep_mask(seed, dropout_rate, B, num_heads, L, q.device)
        inv_keep = 1.0 / (1.0 - dropout_rate)
        p_used = torch.where(keep, p * inv_keep, 0.0)
        dp = torch.where(keep, dp * inv_keep, 0.0)
    else:
        p_used = p
    di = (heads(out) * do).sum(dim=-1, keepdim=True)
    ds = p * (dp - di) * scale
    dq = torch.matmul(ds, heads(k))
    dk = torch.matmul(ds.transpose(-1, -2), heads(q))
    dv = torch.matmul(p_used.transpose(-1, -2), do)

    def packed(x):  # (B, H, L, D) -> (B, L, H*D)
        return x.transpose(1, 2).reshape(B, L, HD).to(q.dtype)

    return packed(dq), packed(dk), packed(dv)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _bind(name: str, argtypes):
    lib = "attention_fwd" if name == "packed_attention_fwd" else "attention_bwd"
    fn = getattr(load_library(lib), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


_P, _I, _U, _F, _LL = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                       ctypes.c_float, ctypes.c_longlong)


@functools.lru_cache(maxsize=None)
def _fwd_kernel():
    return _bind("packed_attention_fwd", [
        _P, _P, _P, _P, _P, _P, _P, _P, _U, _F, _I, _I, _I, _I, _LL, _LL, _F,
        _I, _P,
    ])


@functools.lru_cache(maxsize=None)
def _dq_kernel():
    return _bind("packed_attention_bwd_dq", [
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _U, _F, _I, _I, _I, _I,
        _LL, _LL, _LL, _LL, _F, _I, _P,
    ])


@functools.lru_cache(maxsize=None)
def _dkv_kernel():
    return _bind("packed_attention_bwd_dkv", [
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _U, _F, _I, _I, _I, _I,
        _LL, _LL, _LL, _LL, _F, _I, _P,
    ])


def _head_dim(q: torch.Tensor, num_heads: int) -> int:
    HD = q.shape[-1]
    if HD % num_heads:
        raise ValueError(f"width {HD} is not num_heads={num_heads} x head_dim")
    return HD // num_heads


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_rows(name: str, t: torch.Tensor, like: torch.Tensor, shape, dtype) -> None:
    if t.device != like.device or t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name} must be {dtype} of shape {tuple(shape)} on {like.device}, "
            f"got {t.dtype}/{tuple(t.shape)}/{t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


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
        DTYPE_CODES[q.dtype], _stream(q),
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
        acc = _acc_dtype(q.dtype)
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
        _check_rows(name, t, q, (B, L, HD), q.dtype)
    for name, t in (("m", m), ("l", l)):
        _check_rows(name, t, q, (B, num_heads, L), torch.float32)
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
        dq.stride(1), float(scale), DTYPE_CODES[q.dtype], _stream(q),
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
    _check_rows("dout", dout, q, (B, L, HD), q.dtype)
    for name, t in (("m", m), ("l", l), ("di", di)):
        _check_rows(name, t, q, (B, num_heads, L), torch.float32)
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
        dk.stride(1), float(scale), DTYPE_CODES[q.dtype], _stream(q),
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
