"""The distill step of the port: HardConcrete-gated student, per-layer
distill loss, Lagrangian sparsity term and three-group AdamW."""

from .distill_module import (
    DistillConfig,
    TrainState,
    init_train_state,
    make_eval_step,
    make_grad_fn,
    make_train_step,
)
from .losses import cosine_similarity, distill_loss_unstacked
from .optim import DistillOptimizer
from .projections import (
    flatten_groups,
    init_projections,
    parse_layer_groups,
    projections_from_state_dict,
    projections_to_state_dict,
)
from .schedules import linear_decay_factor, tri_stage_factor

__all__ = [
    "DistillConfig",
    "DistillOptimizer",
    "TrainState",
    "init_train_state",
    "make_train_step",
    "make_eval_step",
    "make_grad_fn",
    "cosine_similarity",
    "distill_loss_unstacked",
    "linear_decay_factor",
    "tri_stage_factor",
    "parse_layer_groups",
    "flatten_groups",
    "init_projections",
    "projections_to_state_dict",
    "projections_from_state_dict",
]
