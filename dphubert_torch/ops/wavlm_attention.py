"""WavLM attention on the (B, H, L, D) layout: attention whose scores carry
the gated relative-position bias, kept factored,

    s[b, h, i, j] = scale * q_i . k_j + gate[b, h, i] * bias[h, i, j],

with the key mask from ``lengths`` and attention-probability dropout.  bias
is (H, L, L) (the bucketed table of the selected heads, shared across the
batch) and gate (B, H, L) (the GRU-style gate of each query row); both stay
fp32 and nothing of size B*H*L*L is built on the kernel path.

Seven kernel wrappers, each beside its plain version, launch the entries of
``csrc/wavlm_attention.cu``:

* the single-KV-block route (the model's; the TPU package's
  ``_fwd_single``/``_bwd_single``): ``wavlm_attention_fwd``,
  ``wavlm_attention_bwd_fused`` (dq, dgate and dbias in one pass) and
  ``wavlm_attention_bwd_dkv``;
* the general route (an explicit ``block_kv`` smaller than the padded
  length): ``wavlm_attention_fwd_general``, ``wavlm_attention_bwd_dq`` (dq
  and dgate), ``wavlm_attention_bwd_dbias`` and
  ``wavlm_attention_bwd_dkv_general``.

For bf16 at head_dim 64 all seven entries run on the tensor cores
(``csrc/wavlm_attention_wgmma.cuh``), or raise on views their 16-byte
copies cannot read: both forward entries one body (blocks in another
order), the general route's dq, dbias and dkv entries the single route's
backward launches taken apart (the same bits).  fp32 and head_dim 80 run
on the CUDA cores (``wavlm_kernel_body`` names the body an entry runs).

The plain versions are ``wavlm_attention_reference`` and
``wavlm_attention_bwd_reference``.  Each wrapper runs the plain version on
CPU tensors and launches its kernel on CUDA tensors or raises; each counts
its kernel's launches in a ``launches`` attribute.  ``WavLMAttentionFn``
pairs a forward with its route's backward kernels for autograd and returns
the gradients of q, k, v, bias and gate; it saves q, k, v, the output and
(m, l), never p, the mask or a (B, H, L, L) tensor.  ``wavlm_route`` keeps
the TPU package's routing rule (``wavlm_flash_attention``: block_q = min(256,
ceil128(L)), Lp = ceil(L, block_q), block_kv = Lp unless given, single when
one KV block covers Lp and ``DPHUBERT_WAVLM_SINGLE_BLOCK`` is not "0"), so
each call takes the route the TPU package would take.
"""

from __future__ import annotations

import ctypes
import functools
import os
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
    kernel_body,
    softmax_parts,
    stream,
)

LANES = 128
# the fused backward's CUDA-core body keeps a (32 x ceil64(L)) fp32 strip of
# dbias in shared memory beside its tiles (csrc/wavlm_attention.cu:
# q_smem_floats); the H100's 227 KB per block hold it up to these lengths
_SMEM_FLOATS = 232448 // 4


def wavlm_kernel_body(name: str, dtype: torch.dtype, head_dim: int) -> str:
    """Which body the WavLM entry ``name`` of ``csrc/wavlm_attention.cu``
    runs: "wgmma" (tensor cores, ``wavlm_attention_wgmma.cuh``) for every
    entry in bf16 at head_dim 64, "fma" (fp32 on the CUDA cores) in fp32
    or at head_dim 80."""
    if name not in _POINTERS:
        raise ValueError(f"no WavLM entry named {name!r}")
    return kernel_body(dtype, head_dim)


def fused_max_len(head_dim: int) -> int:
    """The longest L whose dbias strip fits the shared memory of the fused
    backward's CUDA-core body on an H100 (1344 frames for head_dim 64, 1216
    for 80); its tensor-core body (bf16 at head_dim 64) has no limit."""
    tiles = 2 * 32 * (head_dim + 1) + 2 * 64 * (head_dim + 1) + 32 * 65 + 4 * 32
    width = (_SMEM_FLOATS - tiles) // 32 - 8
    return width // 64 * 64


def wavlm_route(L: int, block_q: int = 256, block_kv: Optional[int] = None) -> str:
    """"single" or "general": the TPU package's ``wavlm_flash_attention``
    blocking for a sequence of L frames, and its ``_single_block_enabled``
    escape hatch (read at call time)."""
    block_q = min(block_q, _ceil_to(L, LANES))
    Lp = _ceil_to(L, block_q)
    block_kv = Lp if block_kv is None else min(block_kv, Lp)
    if Lp % block_kv:
        Lp = _ceil_to(Lp, block_kv)
    single_ok = os.environ.get("DPHUBERT_WAVLM_SINGLE_BLOCK", "1") != "0"
    return "single" if Lp // block_kv == 1 and single_ok else "general"


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def wavlm_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
    gate: torch.Tensor, lengths: Optional[torch.Tensor] = None, *,
    scale: Optional[float] = None, dropout_rate: float = 0.0,
    seed: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the forward: (out, m, l) with m and l (B, H, L).

    As the TPU kernels: the unnormalised p = exp(s - m) is zeroed where the
    hash drops it and rounded to v's dtype before the PV product; l is the
    undropped sum, and the sum is divided by l and by (1 - rate)
    afterwards."""
    B, H, L, D = q.shape
    if scale is None:
        scale = D ** -0.5
    p, m, l, l_inv = softmax_parts(q, k, lengths, scale, bias, gate)
    if dropout_rate > 0.0:
        p = torch.where(keep_mask(seed, dropout_rate, B, H, L, q.device), p, 0.0)
        l_inv = l_inv / (1.0 - dropout_rate)
    out = torch.matmul(p.to(v.dtype).to(p.dtype), v.to(p.dtype)) * l_inv
    return out.to(q.dtype), m[..., 0], l[..., 0]


def wavlm_attention_bwd_reference(
    q, k, v, bias, gate, out, dout, lengths=None, *, scale: Optional[float] = None,
    dropout_rate: float = 0.0, seed: Optional[torch.Tensor] = None,
):
    """Plain version of the backward: (dq, dk, dv) in q's dtype and (dbias,
    dgate) in fp32 (``attention_common.attention_bwd_plain``).  For bf16
    inputs p~ and scale * ds are rounded to bf16 before the dV, dK and dQ
    products, as the tensor-core kernels' A operands are; dgate and dbias
    come from the unrounded ds."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    dq, dk, dv, dbias, dgate = attention_bwd_plain(q, k, v, out, dout, lengths, scale,
                                                   dropout_rate, seed, bias, gate,
                                                   round_operands=True)
    acc = acc_dtype(bias.dtype)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype), dbias.to(acc), dgate.to(acc)


def _di(out, dout):
    acc = acc_dtype(out.dtype)
    return (out.to(acc) * dout.to(acc)).sum(-1)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_P, _I, _U, _F, _LL = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                       ctypes.c_float, ctypes.c_longlong)
_TAIL = [_P, _P, _U, _F, _I, _I, _I, _I, _LL, _LL, _LL, _F, _I, _P]


# pointer arguments before the common tail, by entry
_POINTERS = {
    "wavlm_attention_fwd": 8, "wavlm_attention_fwd_general": 8,
    "wavlm_attention_bwd_dkv": 11, "wavlm_attention_bwd_dkv_general": 11,
    "wavlm_attention_bwd_fused": 13, "wavlm_attention_bwd_dq": 13,
    "wavlm_attention_bwd_dbias": 13,
}


@functools.lru_cache(maxsize=None)
def _kernel(name: str):
    return bind("wavlm_attention", name, [_P] * _POINTERS[name] + _TAIL)


def _check(q, k, v, bias, gate, lengths, seed, dropout_rate):
    B, H, L, D = q.shape
    check_kernel_inputs(q, k, v, lengths, D)
    check_seed(seed, dropout_rate, q.device)
    check_rows("bias", bias, q, (H, L, L), torch.float32)
    check_rows("gate", gate, q, (B, H, L), torch.float32)


def _tail(q, lengths, seed, scale, dropout_rate):
    B, H, L, D = q.shape
    seed_ptr, threshold, inv_keep = dropout_args(dropout_rate, seed)
    return (None if lengths is None else lengths.data_ptr(), seed_ptr, threshold, inv_keep,
            B, H, L, D, q.stride(0), q.stride(1), q.stride(2), float(scale),
            DTYPE_CODES[q.dtype], stream(q))


def _run(name: str, *args) -> None:
    rc = _kernel(name)(*args)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


def _fwd(name, q, k, v, bias, gate, lengths, seed, scale, dropout_rate):
    _check(q, k, v, bias, gate, lengths, seed, dropout_rate)
    B, H, L, D = q.shape
    out = torch.empty((B, H, L, D), dtype=q.dtype, device=q.device)
    m = torch.empty((B, H, L), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    _run(name, q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), gate.data_ptr(),
         out.data_ptr(), m.data_ptr(), l.data_ptr(),
         *_tail(q, lengths, seed, scale, dropout_rate))
    return out, m, l


def _check_stats(q, out, dout, stats):
    B, H, L, D = q.shape
    for name, t in (("out", out), ("dout", dout)):
        if t is not None:
            check_rows(name, t, q, (B, H, L, D), q.dtype)
    for name, t in stats:
        check_rows(name, t, q, (B, H, L), torch.float32)


def wavlm_attention_fwd(q, k, v, bias, gate, lengths=None, *, scale: Optional[float] = None,
                        dropout_rate: float = 0.0, seed: Optional[torch.Tensor] = None):
    """The single route's forward -> (out, m, l), forward only.  q, k, v:
    (B, H, L, D) views (unit stride in the last dimension, one set of
    strides); bias (H, L, L) and gate (B, H, L) contiguous fp32; lengths an
    int32 (B,) tensor or None; seed a one-element int32 tensor with
    dropout.  In bf16 at head_dim 64 (the tensor-core body) q, k and v must
    be 16-byte aligned with strides a multiple of 8, or the launch raises
    (cudaError 716).  CPU tensors take the plain version."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    forward_only("wavlm_attention_fwd", q, k, v, bias, gate)
    if q.device.type == "cpu":
        return wavlm_attention_reference(q, k, v, bias, gate, lengths, scale=scale,
                                         dropout_rate=dropout_rate, seed=seed)
    result = _fwd("wavlm_attention_fwd", q, k, v, bias, gate, lengths, seed, scale,
                  dropout_rate)
    wavlm_attention_fwd.launches += 1
    return result


wavlm_attention_fwd.launches = 0


def wavlm_attention_fwd_general(q, k, v, bias, gate, lengths=None, *,
                                scale: Optional[float] = None, dropout_rate: float = 0.0,
                                seed: Optional[torch.Tensor] = None):
    """The general route's forward: ``wavlm_attention_fwd``'s function,
    blocks ordered batch-outermost."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    forward_only("wavlm_attention_fwd_general", q, k, v, bias, gate)
    if q.device.type == "cpu":
        return wavlm_attention_reference(q, k, v, bias, gate, lengths, scale=scale,
                                         dropout_rate=dropout_rate, seed=seed)
    result = _fwd("wavlm_attention_fwd_general", q, k, v, bias, gate, lengths, seed, scale,
                  dropout_rate)
    wavlm_attention_fwd_general.launches += 1
    return result


wavlm_attention_fwd_general.launches = 0


def _dkv(name, q, k, v, bias, gate, out, dout, m, l, di, lengths, scale, dropout_rate, seed):
    if q.device.type == "cpu":
        _, dk, dv, _, _ = wavlm_attention_bwd_reference(
            q, k, v, bias, gate, out, dout, lengths, scale=scale, dropout_rate=dropout_rate,
            seed=seed)
        return (dk, dv), False
    _check(q, k, v, bias, gate, lengths, seed, dropout_rate)
    _check_stats(q, None, dout, (("m", m), ("l", l), ("di", di)))
    dk = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    _run(name, q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), gate.data_ptr(),
         dout.data_ptr(), m.data_ptr(), l.data_ptr(), di.data_ptr(), dk.data_ptr(),
         dv.data_ptr(), *_tail(q, lengths, seed, scale, dropout_rate))
    return (dk, dv), True


def wavlm_attention_bwd_dkv(q, k, v, bias, gate, out, dout, m, l, di, lengths=None, *,
                            scale: float, dropout_rate: float = 0.0,
                            seed: Optional[torch.Tensor] = None):
    """The single route's dk and dv (B, H, L, D), reading the di a dq-side
    entry wrote.  out and dout contiguous (B, H, L, D); m, l, di (B, H, L)
    fp32.  CPU tensors take the plain version (out feeds its di there; m,
    l and di are unused)."""
    result, launched = _dkv("wavlm_attention_bwd_dkv", q, k, v, bias, gate, out, dout, m, l,
                            di, lengths, scale, dropout_rate, seed)
    wavlm_attention_bwd_dkv.launches += int(launched)
    return result


wavlm_attention_bwd_dkv.launches = 0


def wavlm_attention_bwd_dkv_general(q, k, v, bias, gate, out, dout, m, l, di, lengths=None, *,
                                    scale: float, dropout_rate: float = 0.0,
                                    seed: Optional[torch.Tensor] = None):
    """The general route's dk and dv: ``wavlm_attention_bwd_dkv``'s
    function, blocks ordered batch-outermost."""
    result, launched = _dkv("wavlm_attention_bwd_dkv_general", q, k, v, bias, gate, out, dout,
                            m, l, di, lengths, scale, dropout_rate, seed)
    wavlm_attention_bwd_dkv_general.launches += int(launched)
    return result


wavlm_attention_bwd_dkv_general.launches = 0


def _q_side(name, q, k, v, bias, gate, out, dout, m, l, di, lengths, scale, dropout_rate,
            seed, want_dq: bool, want_dbias: bool):
    """(dq, dgate, dbias, di), None where the entry does not compute it;
    ``di`` is the dbias entry's input (None for the entries that write it)."""
    if q.device.type == "cpu":
        dq, _, _, dbias, dgate = wavlm_attention_bwd_reference(
            q, k, v, bias, gate, out, dout, lengths, scale=scale, dropout_rate=dropout_rate,
            seed=seed)
        if not want_dq:
            return (None, None, dbias, None), False
        return (dq, dgate, dbias if want_dbias else None, _di(out, dout)), False
    _check(q, k, v, bias, gate, lengths, seed, dropout_rate)
    if not want_dq and di is None:
        raise ValueError(f"{name} reads the di that wavlm_attention_bwd_dq wrote: pass it")
    _check_stats(q, out, dout, (("m", m), ("l", l)) + (() if want_dq else (("di", di),)))
    B, H, L, D = q.shape
    if (want_dq and want_dbias and L > fused_max_len(D)
            and wavlm_kernel_body(name, q.dtype, D) == "fma"):
        raise ValueError(
            f"the fused WavLM backward's CUDA-core body ({q.dtype}, head_dim {D}) holds a "
            f"32 x {_ceil_to(L, 64)} dbias strip in shared memory; L = {L} exceeds its "
            f"{fused_max_len(D)} frames (pass block_kv to take the general route, whose "
            "CUDA-core entries hold no such strip)"
        )
    empty = lambda shape: torch.empty(shape, dtype=torch.float32, device=q.device)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device) if want_dq else None
    dgate = empty((B, H, L)) if want_dq else None
    if want_dq:
        di = empty((B, H, L))
    dbias = empty((H, L, L)) if want_dbias else None
    ptr = lambda t: None if t is None else t.data_ptr()
    _run(name, q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), gate.data_ptr(),
         out.data_ptr(), dout.data_ptr(), m.data_ptr(), l.data_ptr(), ptr(di), ptr(dq),
         ptr(dgate), ptr(dbias), *_tail(q, lengths, seed, scale, dropout_rate))
    return (dq, dgate, dbias, di), True


def wavlm_attention_bwd_fused(q, k, v, bias, gate, out, dout, m, l, lengths=None, *,
                              scale: float, dropout_rate: float = 0.0,
                              seed: Optional[torch.Tensor] = None):
    """The single route's dq-side pass -> (dq, dgate, dbias, di): dq (B, H,
    L, D) in q's dtype, dgate (B, H, L), dbias (H, L, L) and di = rowsum(out
    * dout) (B, H, L) in fp32.  Arguments as for ``wavlm_attention_bwd_dkv``
    (without di); CPU tensors take the plain version."""
    result, launched = _q_side("wavlm_attention_bwd_fused", q, k, v, bias, gate, out, dout, m,
                               l, None, lengths, scale, dropout_rate, seed, True, True)
    wavlm_attention_bwd_fused.launches += int(launched)
    return result


wavlm_attention_bwd_fused.launches = 0


def wavlm_attention_bwd_dq(q, k, v, bias, gate, out, dout, m, l, lengths=None, *,
                           scale: float, dropout_rate: float = 0.0,
                           seed: Optional[torch.Tensor] = None):
    """The general route's dq and dgate -> (dq, dgate, di), as
    ``wavlm_attention_bwd_fused`` without dbias."""
    (dq, dgate, _, di), launched = _q_side(
        "wavlm_attention_bwd_dq", q, k, v, bias, gate, out, dout, m, l, None, lengths, scale,
        dropout_rate, seed, True, False)
    wavlm_attention_bwd_dq.launches += int(launched)
    return dq, dgate, di


wavlm_attention_bwd_dq.launches = 0


def wavlm_attention_bwd_dbias(q, k, v, bias, gate, out, dout, m, l, di, lengths=None, *,
                              scale: float, dropout_rate: float = 0.0,
                              seed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The general route's dbias (H, L, L) fp32: sum over the batch of
    gate * ds, reading the di (B, H, L) fp32 that ``wavlm_attention_bwd_dq``
    wrote (call it first), as the TPU package's ``_bwd_dbias_kernel`` reads
    ``di_ref``; every body reads it and none reads out.  CPU tensors take
    the plain version (out feeds its di there; m, l and di are unused)."""
    (_, _, dbias, _), launched = _q_side(
        "wavlm_attention_bwd_dbias", q, k, v, bias, gate, out, dout, m, l, di, lengths, scale,
        dropout_rate, seed, False, True)
    wavlm_attention_bwd_dbias.launches += int(launched)
    return dbias


wavlm_attention_bwd_dbias.launches = 0


# ---------------------------------------------------------------------------
# Routing and autograd
# ---------------------------------------------------------------------------


def wavlm_attention(q, k, v, bias, gate, lengths=None, *, scale: Optional[float] = None,
                    dropout_rate: float = 0.0, seed: Optional[torch.Tensor] = None,
                    block_kv: Optional[int] = None):
    """Forward only, on the route ``wavlm_route`` picks -> (out, m, l)."""
    fwd = (wavlm_attention_fwd if wavlm_route(q.shape[2], block_kv=block_kv) == "single"
           else wavlm_attention_fwd_general)
    return fwd(q, k, v, bias, gate, lengths, scale=scale, dropout_rate=dropout_rate, seed=seed)


class WavLMAttentionFn(torch.autograd.Function):
    """Differentiable WavLM attention on (B, H, L, D):
    ``apply(q, k, v, bias, gate, lengths, seed, scale, dropout_rate, route)
    -> out``, with the gradients of q, k and v (contiguous (B, H, L, D)),
    bias and gate (in their dtypes).  bias and gate are taken as fp32 by the
    kernels; ``route`` is ``wavlm_route``'s answer, fixed at the forward so
    the backward takes the same route."""

    @staticmethod
    def forward(ctx, q, k, v, bias, gate, lengths, seed, scale, dropout_rate, route):
        bias32 = bias.to(acc_dtype(bias.dtype)).contiguous()  # float64 stays (gradcheck)
        gate32 = gate.to(acc_dtype(gate.dtype)).contiguous()
        fwd = wavlm_attention_fwd if route == "single" else wavlm_attention_fwd_general
        out, m, l = fwd(q, k, v, bias32, gate32, lengths, scale=scale,
                        dropout_rate=dropout_rate, seed=seed)
        if q.device.type == "cpu":
            m = l = None
        ctx.save_for_backward(q, k, v, bias32, gate32, out, m, l, lengths, seed)
        ctx.attn = (scale, dropout_rate, route, bias.dtype, gate.dtype)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias, gate, out, m, l, lengths, seed = ctx.saved_tensors
        scale, dropout_rate, route, bias_dtype, gate_dtype = ctx.attn
        dout = dout.contiguous()
        kw = dict(scale=scale, dropout_rate=dropout_rate, seed=seed)
        if q.device.type == "cpu":
            dq, dk, dv, dbias, dgate = wavlm_attention_bwd_reference(
                q, k, v, bias, gate, out, dout, lengths, **kw)
        elif route == "single":
            dq, dgate, dbias, di = wavlm_attention_bwd_fused(
                q, k, v, bias, gate, out, dout, m, l, lengths, **kw)
            dk, dv = wavlm_attention_bwd_dkv(q, k, v, bias, gate, out, dout, m, l, di,
                                             lengths, **kw)
        else:
            dq, dgate, di = wavlm_attention_bwd_dq(q, k, v, bias, gate, out, dout, m, l,
                                                   lengths, **kw)
            dbias = wavlm_attention_bwd_dbias(q, k, v, bias, gate, out, dout, m, l, di,
                                              lengths, **kw)
            dk, dv = wavlm_attention_bwd_dkv_general(q, k, v, bias, gate, out, dout, m, l,
                                                     di, lengths, **kw)
        return (dq, dk, dv, dbias.to(bias_dtype), dgate.to(gate_dtype),
                None, None, None, None, None)


def wavlm_attention_qkv(
    qkv: torch.Tensor, bias: torch.Tensor, gate: torch.Tensor,
    lengths: Optional[torch.Tensor] = None, *, num_heads: int,
    scale: Optional[float] = None, dropout_rate: float = 0.0,
    seed: Optional[torch.Tensor] = None, block_kv: Optional[int] = None,
) -> torch.Tensor:
    """The model's entry: WavLM attention of the fused QKV output (B, L,
    3*H*D) with the selected heads' bias (H, L, L) and gate (B, H, L) ->
    (B, L, H*D), through ``WavLMAttentionFn`` when autograd needs a
    gradient and through the forward-only wrappers otherwise.  q, k and v
    are (B, H, L, D) views of qkv, read in place."""
    B, L, W = qkv.shape
    HD = W // 3
    D = HD // num_heads
    if scale is None:
        scale = D ** -0.5
    q, k, v = (t.view(B, L, num_heads, D).transpose(1, 2) for t in qkv.split(HD, dim=-1))
    if torch.is_grad_enabled() and (qkv.requires_grad or bias.requires_grad
                                    or gate.requires_grad):
        out = WavLMAttentionFn.apply(q, k, v, bias, gate, lengths, seed, float(scale),
                                     float(dropout_rate), wavlm_route(L, block_kv=block_kv))
    else:
        out, _, _ = wavlm_attention(q, k, v, bias.float().contiguous(),
                                    gate.float().contiguous(), lengths, scale=scale,
                                    dropout_rate=dropout_rate, seed=seed, block_kv=block_kv)
    return out.transpose(1, 2).reshape(B, L, HD)
