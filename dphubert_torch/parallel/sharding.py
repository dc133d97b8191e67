"""Tensor-parallel layouts (the TPU package's ``parallel/sharding.py``) and
the placement of a training state on a mesh.

The reference never shards parameters (DDP only).  Over the mesh's
``model`` group the port splits, Megatron-style:

  * q/k/v projections: output rows (heads x head_dim), whole heads a rank;
    each rank runs its heads through the same attention kernels;
  * out_proj: input columns; the partial outputs are summed over the group
    (``comm.reduce_from_model``), the replicated bias added after;
  * the FFN the same way: ``intermediate_dense`` rows (weight and bias),
    ``output_dense`` columns.

Everything else (convs, norms, embeddings, gates, the output projections'
biases, projections, λs, WavLM's position-bias table and GRU gate) is
replicated over the model group.  The TPU rule splits any such leaf whose
dimension divides by the model axis; the kernels here need whole heads, so
a layer whose heads (or intermediate units) do not divide by ``n_model``
runs replicated on every model rank (ROADMAP queue 3: 11 heads of 64 at M
= 2 would be 5.5 heads a shard).  A split WavLM layer also takes its heads'
rows of the position bias and of the GRU gate (``components.py``).

With ``fsdp`` (``fsdp.py``) every large leaf is further split over the
data group on a dimension the model axis leaves free; a ``Block`` records
both splits of a parameter, and its moments follow it.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple

import torch

from .comm import all_gather_cat
from .fsdp import fsdp_dims, mark
from .mesh import Mesh, replicate

_ATT = re.compile(r"^(?:student\.)?encoder\.transformer\.layers\.(\d+)\.attention\."
                  r"(q_proj|k_proj|v_proj|out_proj)\.(weight|bias)$")
_FFN = re.compile(r"^(?:student\.)?encoder\.transformer\.layers\.(\d+)\.feed_forward\."
                  r"(intermediate_dense|output_dense)\.(weight|bias)$")


def layer_splits(spec, n_model: int) -> List[Tuple[bool, bool]]:
    """(attention split, FFN split) of every encoder layer: a sublayer is
    split where it exists and its heads (intermediate units) divide by
    ``n_model`` > 1."""
    out = []
    for layer in spec.layers:
        att, ffn = layer.attention, layer.feed_forward
        out.append((n_model > 1 and att is not None and att.num_heads % n_model == 0,
                    n_model > 1 and ffn is not None
                    and ffn.intermediate_features % n_model == 0))
    return out


def split_dims(spec, params: Iterable[str], n_model: int) -> Dict[str, Optional[int]]:
    """The dimension along which each parameter (by state-dict name, with or
    without the ``student.`` prefix) is split over the model group, or None
    where it is replicated."""
    splits = layer_splits(spec, n_model)
    out: Dict[str, Optional[int]] = {}
    for name in params:
        dim = None
        m = _ATT.match(name)
        if m and splits[int(m.group(1))][0]:
            if m.group(2) != "out_proj":
                dim = 0
            elif m.group(3) == "weight":
                dim = 1
        m = _FFN.match(name)
        if m and splits[int(m.group(1))][1]:
            if m.group(2) == "intermediate_dense":
                dim = 0
            elif m.group(3) == "weight":
                dim = 1
        out[name] = dim
    return out


def _shard_of(mesh: Mesh):
    from ..models.components import Shard

    return Shard(mesh.data_rank, mesh.n_data, mesh.model_rank, mesh.n_model, mesh.model_group)


def set_model_shard(model, mesh: Mesh) -> None:
    """Tell a model's modules where this rank's rows and heads lie (the
    student of a parallel step; its parameters are narrowed apart)."""
    shard = _shard_of(mesh)
    splits = layer_splits(model.spec, mesh.n_model)
    encoder = model.encoder
    encoder.feature_projection.shard = shard
    encoder.transformer.shard = shard
    for layer, (att, ffn) in zip(encoder.transformer.layers, splits):
        layer.shard = shard
        if layer.attention is not None:
            layer.attention.set_shard(shard, att)
        if layer.feed_forward is not None:
            layer.feed_forward.set_shard(shard, ffn)


@dataclass(frozen=True)
class Block:
    """This rank's block of a parameter (or moment) of one-card shape
    ``shape``: split along ``model_dim`` into ``n_model`` blocks over the
    model group, then along ``data_dim`` into ``n_data`` over the data
    group (FSDP); None where that group does not split it."""

    shape: Tuple[int, ...]
    model_dim: Optional[int] = None
    model_rank: int = 0
    n_model: int = 1
    data_dim: Optional[int] = None
    data_rank: int = 0
    n_data: int = 1

    def groups(self, mesh: Mesh) -> tuple:
        """The process groups over which the block's squares are summed
        (``optim.global_norm``)."""
        return ((mesh.model_group,) if self.model_dim is not None else ()) + (
            (mesh.data_group,) if self.data_dim is not None else ())


@torch.no_grad()
def shard_train_state(state, mesh: Mesh, tx=None, fsdp: bool = False) -> None:
    """Place a fresh training state on ``mesh`` in place: every rank takes
    rank 0's parameters, the student's modules learn their shard, the
    split parameters are narrowed to this rank's block, model split first
    and, with ``fsdp``, the data split of every leaf ``fsdp.fsdp_dim``
    picks (the λs stay whole), their Adam moments (and accumulator)
    beside them; ``state.shards`` records each ``Block`` by parameter name,
    and the optimizer's clip learns the groups over which each block is
    split (``tx.shard_norm``)."""
    replicate(list(state.named_params().values()), mesh)
    set_model_shard(state.student, mesh)
    named = state.named_params()
    model_dims = {n: d for n, d in split_dims(state.student.spec, named, mesh.n_model).items()
                  if d is not None}
    data_dims = {}
    if fsdp:
        data_dims = fsdp_dims({n: tuple(p.shape) for n, p in named.items()
                               if not n.startswith("lambdas.")},
                              mesh.n_data, model_dims)
    shards = {}
    for name, p in named.items():
        md, dd = model_dims.get(name), data_dims.get(name)
        if md is None and dd is None:
            continue
        shards[name] = Block(tuple(p.shape), md, mesh.model_rank, mesh.n_model, dd,
                             mesh.data_rank, mesh.n_data)
    state.mesh, state.shards = mesh, shards
    for name, block in shards.items():
        p = named[name]
        if block.model_dim is not None:
            n = block.shape[block.model_dim] // mesh.n_model
            p.data = p.data.narrow(block.model_dim, mesh.model_rank * n, n).clone()
        if block.data_dim is not None:
            mark(p, block.data_dim, mesh)
    opt = state.opt_state
    for group in (opt.mu, opt.nu, opt.acc):
        for name in shards if group is not None else ():
            group[name] = narrow(shards[name], group[name])
    if tx is not None:
        tx.shard_norm({n: b.groups(mesh) for n, b in shards.items()})


def narrow(block: Block, full: torch.Tensor) -> torch.Tensor:
    """This rank's block (a copy) of a one-card tensor; raises if the
    tensor is not at the one-card shape."""
    if tuple(full.shape) != tuple(block.shape):
        raise ValueError(f"expected a one-card tensor of shape {tuple(block.shape)}, got "
                         f"{tuple(full.shape)}")
    t = full
    for dim, rank, n in ((block.model_dim, block.model_rank, block.n_model),
                         (block.data_dim, block.data_rank, block.n_data)):
        if dim is not None:
            size = t.shape[dim] // n
            t = t.narrow(dim, rank * size, size)
    return t.clone()


def gather_tensor(block: Block, t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The one-card tensor of a split parameter (or moment, or gradient)
    from every rank's block: gathered over the data group, then over the
    model group."""
    if block.data_dim is not None:
        t = all_gather_cat(t, block.data_dim, mesh.data_group, mesh.n_data)
    if block.model_dim is not None:
        t = all_gather_cat(t, block.model_dim, mesh.model_group, mesh.n_model)
    return t


@torch.no_grad()
def gather_full(state) -> Dict[str, torch.Tensor]:
    """The one-card parameter dict (``TrainState.named_params``' names): the
    split parameters gathered over the data and the model group (every
    rank must call it), the rest as they are."""
    named = {n: p.detach() for n, p in state.named_params().items()}
    return {n: gather_tensor(state.shards[n], p, state.mesh) if n in state.shards else p
            for n, p in named.items()}


@torch.no_grad()
def gather_state_tensors(state) -> Dict[str, torch.Tensor]:
    """Every tensor of a checkpoint (``params/``, ``mu/``, ``nu/``,
    ``acc/`` names) at one-card shapes: the split ones gathered over the
    data and the model group on the compute stream (every rank must call
    it)."""
    out = {f"params/{n}": p for n, p in gather_full(state).items()}
    opt = state.opt_state
    for group in ("mu", "nu", "acc"):
        for n, t in (getattr(opt, group) or {}).items():
            if n in state.shards:
                t = gather_tensor(state.shards[n], t, state.mesh)
            out[f"{group}/{n}"] = t
    return out
