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
  ``.grad`` accumulation, which ``autograd.grad`` never does);
* ``full`` (FSDP, ``fsdp.py``): a parameter that holds only this data
  rank's block (``p.fsdp``, a ``DataShard``) is all-gathered over the data
  group where a module reads it; backward, its gradient is reduce-scattered
  over the same group and divided by the group's size, so ``autograd.grad``
  returns the block of the data-averaged gradient (the mean that
  ``all_reduce_grads`` takes of a whole one).  A parameter without
  ``fsdp`` passes as it is.  Both collectives are captured in a K-step CUDA
  graph over NCCL as the all-reduce is.

Over gloo, CUDA tensors go to gloo as they are (the card's gloo takes them:
``chip_smoke.py`` phase "parallel_card").
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

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


@dataclass(frozen=True)
class DataShard:
    """Where an FSDP parameter's block lies: ``n`` equal blocks along
    ``dim`` over the data ``group``, this rank's in rank order."""

    dim: int
    n: int
    group: Any = None

    def __deepcopy__(self, memo):
        return self  # holds a process group, a handle


class _GatherFromData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, ds: DataShard):
        ctx.ds = ds
        shard = shard.contiguous()
        flat = shard.new_empty(ds.n * shard.numel())  # flat: gloo takes no other shape
        dist.all_gather_into_tensor(flat, shard.view(-1), group=ds.group)
        # (n, ..., a_dim, ...) -> (..., n * a_dim, ...): the blocks in rank order
        full = flat.view((ds.n,) + tuple(shard.shape)).movedim(0, ds.dim)
        return full.reshape(full.shape[:ds.dim] + (-1,) + full.shape[ds.dim + 2:])

    @staticmethod
    def backward(ctx, grad):
        ds = ctx.ds
        shape = grad.shape[:ds.dim] + (ds.n, grad.shape[ds.dim] // ds.n) + grad.shape[ds.dim + 1:]
        parts = grad.reshape(shape).movedim(ds.dim, 0).contiguous()
        out = parts.new_empty(parts.shape[1:])
        dist.reduce_scatter_tensor(out.view(-1), parts.view(-1), group=ds.group)
        return out.div_(ds.n), None


def full(p: torch.Tensor) -> torch.Tensor:
    """``p`` where it is whole; an FSDP parameter's one-card tensor (over
    the model split, if any: this model rank's block) gathered from every
    data rank's block, its gradient reduce-scattered backward."""
    ds = getattr(p, "fsdp", None)
    return p if ds is None else _GatherFromData.apply(p, ds)


def full_numel(p: torch.Tensor) -> int:
    """The element count of ``full(p)``, without the gather."""
    ds = getattr(p, "fsdp", None)
    return p.numel() * (1 if ds is None else ds.n)


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
