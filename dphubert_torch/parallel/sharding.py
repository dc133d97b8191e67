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
biases, projections, λs) is replicated.  The TPU rule splits any such leaf
whose dimension divides by the model axis; the kernels here need whole
heads, so a layer whose heads (or intermediate units) do not divide by
``n_model`` runs replicated on every model rank (ROADMAP queue 3: 11 heads
of 64 at M = 2 would be 5.5 heads a shard).  WavLM's attention is not split
(ROADMAP queue 1, item 7c).
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, List, Optional, Tuple

import torch

from .comm import all_gather_cat
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


@torch.no_grad()
def shard_train_state(state, mesh: Mesh, tx=None) -> None:
    """Place a fresh training state on ``mesh`` in place: every rank takes
    rank 0's parameters, the student's modules learn their shard, the
    split parameters and their Adam moments are narrowed to this model
    rank's block, ``state.shards`` records each block (dim, start, length,
    full length) by parameter name, and the optimizer's clip learns which
    leaves are split (``tx.shard_norm``)."""
    replicate(list(state.named_params().values()), mesh)
    set_model_shard(state.student, mesh)
    named = state.named_params()
    shards = {}
    for name, dim in split_dims(state.student.spec, named, mesh.n_model).items():
        if dim is None:
            continue
        full = named[name].shape[dim]
        n = full // mesh.n_model
        shards[name] = (dim, mesh.model_rank * n, n, full)
    state.mesh, state.shards = mesh, shards
    for name, p in named.items():
        if name in shards:
            p.data = narrow(shards[name], p.data)
    opt = state.opt_state
    for group in (opt.mu, opt.nu, opt.acc):
        for name in shards if group is not None else ():
            group[name] = narrow(shards[name], group[name])
    if tx is not None:
        tx.shard_norm(set(shards), mesh.model_group if mesh.n_model > 1 else None)


def narrow(block: Tuple[int, int, int, int], full: torch.Tensor) -> torch.Tensor:
    """This rank's block (a copy) of a one-card tensor; raises if the
    tensor is not at the one-card shape."""
    dim, start, n, length = block
    if full.shape[dim] != length:
        raise ValueError(f"expected a one-card tensor of {length} along dim {dim}, got shape "
                         f"{tuple(full.shape)}")
    return full.narrow(dim, start, n).clone()


def gather_tensor(block, t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The one-card tensor of a split parameter (or moment) from every
    model rank's block."""
    return all_gather_cat(t, block[0], mesh.model_group, mesh.n_model)


@torch.no_grad()
def gather_full(state) -> Dict[str, torch.Tensor]:
    """The one-card parameter dict (``TrainState.named_params``' names): the
    split parameters gathered over the model group (every rank must call
    it), the rest as they are."""
    named = {n: p.detach() for n, p in state.named_params().items()}
    return {n: gather_tensor(state.shards[n], p, state.mesh) if n in state.shards else p
            for n, p in named.items()}


@torch.no_grad()
def gather_state_tensors(state) -> Dict[str, torch.Tensor]:
    """Every tensor of a checkpoint (``params/``, ``mu/``, ``nu/``,
    ``acc/`` names) at one-card shapes: the split ones gathered over the
    model group on the compute stream (every rank must call it)."""
    out = {f"params/{n}": p for n, p in gather_full(state).items()}
    opt = state.opt_state
    for group in ("mu", "nu", "acc"):
        for n, t in (getattr(opt, group) or {}).items():
            if n in state.shards:
                t = gather_tensor(state.shards[n], t, state.mesh)
            out[f"{group}/{n}"] = t
    return out
