"""The (data x model) device mesh (the TPU package's ``parallel/mesh.py``).

The workload is data-parallel (the reference uses DDP only), so most runs
have a mesh of (n_data x 1): every rank holds the whole student, feeds its
block of each global batch, and the gradients are averaged over the
``data`` group after the backward (``comm.all_reduce_grads``).  A
``model`` axis splits the attention heads and the FFN's intermediate
units over its ranks (``sharding.py``); with FSDP the ``data`` group also
splits every large leaf of the state and the teacher (``fsdp.py``).  The ranks are laid out as the TPU
package reshapes its devices: ``model`` innermost, so global rank
``r`` is data rank ``r // n_model`` and model rank ``r % n_model``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist


@dataclass
class Mesh:
    """A (data x model) mesh over the default process group, with its two
    groups, this rank's place in it, and a gloo group over every rank for
    the host's small messages (agreeing a stop, barriers) that must not
    wait for the card's stream."""

    device_mesh: object
    n_data: int
    n_model: int
    data_rank: int
    model_rank: int
    data_group: object
    model_group: object
    host_group: object

    @property
    def rank(self) -> int:
        return self.data_rank * self.n_model + self.model_rank

    @property
    def world(self) -> int:
        return self.n_data * self.n_model

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def backend(self) -> str:
        return dist.get_backend(self.data_group)

    def __deepcopy__(self, memo):
        return self  # process groups are handles, never copies


def create_mesh(n_data: Optional[int] = None, n_model: int = 1,
                device_type: str = "cuda") -> Mesh:
    """The (n_data x n_model) mesh of the default process group
    (``torch.distributed.device_mesh.init_device_mesh`` with dims
    ``("data", "model")``); ``n_data`` defaults to world // n_model.  Every
    rank must call it."""
    if not dist.is_initialized():
        raise RuntimeError("create_mesh needs a process group: call multihost.initialize first")
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    if n_model < 1 or n_model > world:
        raise ValueError(f"a model axis of {n_model} needs at least {n_model} processes "
                         f"(devices), the group has {world}")
    if n_data is None or n_data == 0:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"a ({n_data} data x {n_model} model) mesh needs {n_data * n_model} "
                         f"processes (devices), the group has {world}")
    # the mesh gives the groups; over gloo (also with CUDA tensors: two
    # ranks on one card) it is made as a CPU mesh
    dm = init_device_mesh("cpu" if dist.get_backend() == "gloo" else device_type,
                          (n_data, n_model), mesh_dim_names=("data", "model"))
    rank = dist.get_rank()
    host = dist.new_group(backend="gloo") if dist.get_backend() != "gloo" else dist.group.WORLD
    return Mesh(dm, n_data, n_model, rank // n_model, rank % n_model,
                dm.get_group("data"), dm.get_group("model"), host)


def replicate(module_or_tensors, mesh: Mesh) -> None:
    """Broadcast a module's parameters and buffers (or a list of tensors)
    from the mesh's rank 0 (global rank 0) to every rank, in place."""
    if isinstance(module_or_tensors, torch.nn.Module):
        tensors = list(module_or_tensors.parameters()) + list(module_or_tensors.buffers())
    else:
        tensors = list(module_or_tensors)
    for t in tensors:
        dist.broadcast(t.data, src=0)


def agree_max(value: int, mesh: Optional[Mesh]) -> int:
    """The largest of every rank's ``value``, over the host group (a stop
    decided on one rank reaches all of them at the same step)."""
    if mesh is None or mesh.world == 1:
        return value
    t = torch.tensor([value], dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.host_group)
    return int(t.item())


def barrier(mesh: Optional[Mesh]) -> None:
    if mesh is not None and mesh.world > 1:
        dist.barrier(group=mesh.host_group)
