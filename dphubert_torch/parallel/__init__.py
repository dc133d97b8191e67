"""Data and tensor parallelism for the distill step (the TPU package's
``parallel/``): process groups (``multihost``), the (data x model) mesh
(``mesh``), the Megatron split of heads and FFN units and the placement of
a training state (``sharding``), and the step's collectives (``comm``).
FSDP / HSDP (the TPU package's ``fsdp.py``) is not ported: ROADMAP queue 1,
item 7b."""

from .comm import all_reduce_grads, copy_to_model, reduce_from_model
from .mesh import Mesh, create_mesh, replicate
from .multihost import initialize, process_row_slice
from .sharding import gather_full, shard_train_state, split_dims

__all__ = [
    "Mesh",
    "create_mesh",
    "replicate",
    "initialize",
    "process_row_slice",
    "split_dims",
    "shard_train_state",
    "gather_full",
    "copy_to_model",
    "reduce_from_model",
    "all_reduce_grads",
]
