"""Attention forward on the (B, H, L, D) layout, with softmax statistics.

``flash_attention`` launches ``flash_attention_fwd`` of
``csrc/attention_fwd.cu`` on CUDA tensors and runs
``flash_attention_reference`` on CPU tensors.  Besides ``out`` it returns
the row max ``m`` and the row sum ``l`` as (B, H, L) fp32 tensors, which its
backward kernels will read once they are ported (ROADMAP queue 2, item 2);
until then it is forward-only and takes no dropout, on the CPU as on the
card.  The model takes this kernel for the shapes ``packed_num_groups``
refuses: padded lengths past 1024 frames (clips longer than 20 s) and head
counts whose width the TPU kernel could not group.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from ._build import load_library
from .attention_common import DTYPE_CODES, NEG_INF, check_kernel_inputs, forward_only


def flash_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    lengths: Optional[torch.Tensor] = None, *, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version: matmul, masked softmax, matmul, in fp32.

    As the TPU flash kernel: the unnormalised p = exp(s - m) is rounded to
    v's dtype before the PV product and the sum is divided by l afterwards.
    Returns (out, m, l) with m and l of shape (B, H, L) in fp32."""
    B, H, L, D = q.shape
    if scale is None:
        scale = D ** -0.5
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if lengths is not None:
        valid = torch.arange(L, device=q.device)[None, :] < lengths.to(q.device)[:, None]
        s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    l_inv = torch.where(l == 0.0, torch.ones_like(l), 1.0 / l)
    out = torch.matmul(p.to(v.dtype).float(), v.float()) * l_inv
    return out.to(q.dtype), m[..., 0], l[..., 0]


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = load_library("attention_fwd").flash_attention_fwd
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    lengths: Optional[torch.Tensor] = None, *, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """softmax(scale * q k^T + key mask) v on (B, H, L, D) -> (out, m, l).

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise.  q, k and v may be strided views (unit stride in the last
    dimension, one set of strides for all three); out is contiguous."""
    B, H, L, D = q.shape
    if scale is None:
        scale = D ** -0.5
    forward_only("flash_attention", q, k, v)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, lengths, scale=scale)
    check_kernel_inputs(q, k, v, lengths, D)
    out = torch.empty((B, H, L, D), dtype=q.dtype, device=q.device)
    m = torch.empty((B, H, L), dtype=torch.float32, device=q.device)
    l = torch.empty((B, H, L), dtype=torch.float32, device=q.device)
    rc = _kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        m.data_ptr(), l.data_ptr(),
        None if lengths is None else lengths.data_ptr(),
        B, H, L, D, q.stride(0), q.stride(1), q.stride(2), float(scale),
        DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: cudaError {rc}")
    flash_attention.launches += 1
    return out, m, l


flash_attention.launches = 0
