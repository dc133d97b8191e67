"""Data, tensor and fully-sharded data parallelism for the distill step
(the TPU package's ``parallel/``): process groups (``multihost``), the
(data x model) mesh (``mesh``), the Megatron split of heads and FFN units
and the placement of a training state (``sharding``), the split of every
large leaf over the data group, alone or with the model split (FSDP /
HSDP, ``fsdp``), and the step's collectives (``comm``)."""

from .comm import all_reduce_grads, copy_to_model, full, reduce_from_model
from .fsdp import MIN_SHARD_ELEMS, fsdp_dim, fsdp_dims, shard_module
from .mesh import Mesh, create_mesh, replicate
from .multihost import initialize, process_row_slice
from .sharding import Block, gather_full, shard_train_state, split_dims

__all__ = [
    "Mesh",
    "create_mesh",
    "replicate",
    "initialize",
    "process_row_slice",
    "split_dims",
    "shard_train_state",
    "gather_full",
    "Block",
    "MIN_SHARD_ELEMS",
    "fsdp_dim",
    "fsdp_dims",
    "shard_module",
    "copy_to_model",
    "reduce_from_model",
    "all_reduce_grads",
    "full",
]
