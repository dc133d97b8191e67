"""Fully-sharded data parallelism over the mesh's ``data`` group (the TPU
package's ``parallel/fsdp.py``), and its hybrid with the tensor-parallel
split (HSDP).

The reference trains DDP only: every rank holds the whole student, the
frozen teacher and the Adam moments.  Here every large leaf (of the
student, the projections and the teacher) is split into ``n_data`` equal
blocks along one dimension, and each data rank keeps its block between
steps, the Adam moments (and the accumulator) beside it: per-rank memory
for parameters and moments scales as 1/n_data.  A module all-gathers a
block where it reads the weight (``comm.full``) and frees the whole after
use (the teacher under ``no_grad``; the student's is kept for the
backward as any weight is), and the backward reduce-scatters its gradient,
so the optimizer and the clip run on the blocks (``optim.global_norm``
sums a block's squares over the groups that split it).

Layout rule, one for every leaf, by shape alone (``fsdp_dim``): the data
axis takes the largest dimension divisible by ``n_data`` of every leaf of
at least ``MIN_SHARD_ELEMS`` elements, ties to the lowest index; dimensions the
model axis already holds (``sharding.split_dims``) are skipped, so a
(data x model) mesh splits a q/k/v weight over ``model`` on its rows and
over ``data`` on its columns.  Smaller leaves (norms, biases, gates'
``log_alpha``) and the two λs stay whole: a gather's latency outweighs the
bytes they would save.  Nothing is split at ``n_data`` = 1.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from .comm import DataShard

# Leaves below this element count stay whole (the TPU package's constant).
MIN_SHARD_ELEMS = 2**14


def fsdp_dim(shape: Sequence[int], n_data: int, taken: Optional[int] = None,
             min_size: Optional[int] = None) -> Optional[int]:
    """The dimension of a leaf of ``shape`` that the data axis splits, or
    None: the largest one divisible by ``n_data`` other than ``taken`` (the
    model axis's), ties to the lowest index; None below ``min_size``
    elements (default ``MIN_SHARD_ELEMS``) or at ``n_data`` <= 1 (the TPU
    package's ``fsdp_spec``)."""
    min_size = MIN_SHARD_ELEMS if min_size is None else min_size
    numel = 1
    for n in shape:
        numel *= int(n)
    if n_data <= 1 or numel < min_size:
        return None
    for d in sorted(range(len(shape)), key=lambda i: (-shape[i], i)):
        if d != taken and shape[d] % n_data == 0:
            return d
    return None


def fsdp_dims(shapes: Dict[str, Tuple[int, ...]], n_data: int,
              model_dims: Optional[Dict[str, Optional[int]]] = None,
              min_size: Optional[int] = None) -> Dict[str, Optional[int]]:
    """``fsdp_dim`` of every leaf by name (one-card shapes), skipping the
    dimension ``model_dims`` gives a leaf."""
    model_dims = model_dims or {}
    return {name: fsdp_dim(shape, n_data, model_dims.get(name), min_size)
            for name, shape in shapes.items()}


def mark(p: torch.Tensor, dim: int, mesh) -> None:
    """Narrow ``p`` (a parameter, whole along ``dim``) to this data rank's
    block in place and mark it for the gather at use (``comm.full``)."""
    n = p.shape[dim] // mesh.n_data
    p.data = p.data.narrow(dim, mesh.data_rank * n, n).clone()
    p.fsdp = DataShard(dim, mesh.n_data, mesh.data_group)


@torch.no_grad()
def shard_module(module: torch.nn.Module, mesh) -> Dict[str, int]:
    """Split a whole module's parameters over the mesh's data group in
    place (the frozen teacher: it is not split over the model group);
    returns the dimension of every split parameter by name."""
    dims = {}
    for name, p in module.named_parameters():
        dim = fsdp_dim(p.shape, mesh.n_data)
        if dim is not None:
            mark(p, dim, mesh)
            dims[name] = dim
    return dims
