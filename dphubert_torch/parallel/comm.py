"""The collectives of the parallel step.

* ``copy_to_model`` (Megatron's *f*): the identity forward, an all-reduce of
  the gradient over the model group backward.  It stands before every
  column-parallel product (the input of the sharded q/k/v and
  ``intermediate_dense``) and on a replicated gate before its slice is
  taken, so that the replicated tensor's gradient sums every model rank's
  part;
* ``reduce_from_model`` (*g*): an all-reduce over the model group forward,
  the identity backward: the row-parallel product (``out_proj``,
  ``output_dense``) sums its partial outputs; the bias is added after;
* ``all_reduce_grads``: the data-parallel gradient average, one flat
  buffer per dtype and one collective each, between the backward and the
  optimizer.  It is also what lets a K-step CUDA graph capture the
  collective (NCCL's can be captured; DDP's reducer hooks fire on
  ``.grad`` accumulation, which ``autograd.grad`` never does).

Over gloo, CUDA tensors go to gloo as they are (the card's gloo takes them:
``chip_smoke.py`` phase "parallel_card").
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist


def all_gather_cat(t: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """The ``n`` ranks' equal shards of ``t`` along ``dim``, concatenated in
    rank order."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """*f*: ``x`` forward; its gradient all-reduced over ``group``."""
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """*g*: the sum of every model rank's ``x``; the gradient passes as is."""
    return _ReduceFromModel.apply(x, group)


ALIGN_BYTES = 64  # where each tensor starts in a flat buffer


def all_reduce_grads(tensors: Dict[str, torch.Tensor], group,
                     n_average: int) -> Dict[str, torch.Tensor]:
    """The mean of every tensor over the ``n_average`` ranks of ``group``:
    one flat buffer per dtype (the tensors concatenated in order, each
    starting at a multiple of 64 bytes, so that vectorised kernels read the
    views as they read separate tensors), one all-reduce of it, a division
    by ``n_average`` (none for 1, so one rank gives its tensors back bit for
    bit), and the tensors back as views of the buffer, by name."""
    by_dtype: Dict[torch.dtype, list] = {}
    for name, t in tensors.items():
        by_dtype.setdefault(t.dtype, []).append(name)
    out: Dict[str, torch.Tensor] = {}
    for dtype, names in by_dtype.items():
        first = tensors[names[0]]
        align = max(ALIGN_BYTES // first.element_size(), 1)
        zeros = torch.zeros(align, dtype=dtype, device=first.device)
        parts, offsets, offset = [], [], 0
        for n in names:
            t = tensors[n].reshape(-1)
            parts.append(t)
            offsets.append(offset)
            offset += t.numel()
            pad = -offset % align
            if pad:
                parts.append(zeros[:pad])
                offset += pad
        flat = torch.cat(parts)
        dist.all_reduce(flat, group=group)
        if n_average > 1:
            flat.div_(n_average)
        for n, start in zip(names, offsets):
            t = tensors[n]
            out[n] = flat[start:start + t.numel()].view(t.shape)
    return {n: out[n] for n in tensors}


def sum_over(value: torch.Tensor, group) -> torch.Tensor:
    """A 0-dim tensor summed over ``group`` (out of place)."""
    value = value.reshape(1).clone()
    dist.all_reduce(value, group=group)
    return value.reshape(())
