"""Attention forward on the packed (B, L, H*D) layout.

``packed_attention`` launches ``packed_attention_fwd`` of
``csrc/attention_fwd.cu`` on CUDA tensors and runs
``packed_attention_reference`` on CPU tensors; it takes q, k and v as
strided views of the fused QKV projection output, so nothing is copied
apart, and writes (B, L, H*D) for ``out_proj`` to read directly.

``packed_num_groups`` is the TPU package's routing rule, copied as it is:
on the TPU it split the heads into groups that fit scoped VMEM.  The CUDA
kernel needs no group split, but the model keeps the rule to choose between
this kernel and ``flash_attention``, so that the port routes each shape as
the TPU package does.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ._build import load_library
from .attention_common import DTYPE_CODES, NEG_INF, _ceil_to, check_kernel_inputs

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


def packed_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    lengths: Optional[torch.Tensor] = None, *, num_heads: int,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain version: matmul, masked softmax, matmul, in fp32.

    Key columns at or past ``lengths[b]`` are masked with NEG_INF; padded
    query rows still attend to the valid keys.  The normalised p is rounded
    to v's dtype before the PV product, as the TPU packed kernel does."""
    B, L, HD = q.shape
    D = HD // num_heads
    if scale is None:
        scale = D ** -0.5

    def heads(x):  # (B, L, H*D) -> (B, H, L, D) in fp32
        return x.reshape(B, L, num_heads, D).transpose(1, 2).float()

    s = torch.matmul(heads(q), heads(k).transpose(-1, -2)) * scale
    if lengths is not None:
        valid = torch.arange(L, device=q.device)[None, :] < lengths.to(q.device)[:, None]
        s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    l_inv = torch.where(l == 0.0, torch.ones_like(l), 1.0 / l)
    out = torch.matmul((p * l_inv).to(v.dtype).float(), heads(v))
    return out.transpose(1, 2).reshape(B, L, HD).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = load_library("attention_fwd").packed_attention_fwd
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_float,
        ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def packed_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    lengths: Optional[torch.Tensor] = None, *, num_heads: int,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """softmax(scale * q k^T + key mask) v on (B, L, num_heads*head_dim).

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise.  q, k and v may be strided views (unit stride in the last
    dimension, one set of strides for all three); lengths is an int32 (B,)
    tensor of valid key counts or None."""
    B, L, HD = q.shape
    D = HD // num_heads
    if scale is None:
        scale = D ** -0.5
    if q.device.type == "cpu":
        return packed_attention_reference(
            q, k, v, lengths, num_heads=num_heads, scale=scale
        )
    if num_heads * D != HD:
        raise ValueError(f"width {HD} is not num_heads={num_heads} x head_dim")
    check_kernel_inputs(q, k, v, lengths, D)
    out = torch.empty((B, L, HD), dtype=q.dtype, device=q.device)
    rc = _kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lengths is None else lengths.data_ptr(),
        B, L, num_heads, D, q.stride(0), q.stride(1), float(scale),
        DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"packed_attention_fwd launch failed: cudaError {rc}")
    packed_attention.launches += 1
    return out


packed_attention.launches = 0
