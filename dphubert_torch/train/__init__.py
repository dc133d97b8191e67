"""Training on the port: the distill step (HardConcrete-gated student,
per-layer distill loss, Lagrangian sparsity term, three-group AdamW), the
trainer loop and its checkpoint."""

from .checkpointing import load_train_state, save_train_state
from .distill_module import (
    DistillConfig,
    TrainState,
    init_train_state,
    make_eval_step,
    make_grad_fn,
    make_train_step,
)
from .losses import cosine_similarity, distill_loss, distill_loss_unstacked
from .optim import DistillOptimizer
from .projections import (
    apply_projections,
    flatten_groups,
    init_projections,
    parse_layer_groups,
    projections_from_state_dict,
    projections_to_state_dict,
)
from .schedules import linear_decay_factor, tri_stage_factor
from .trainer import MetricLogger, export_student_checkpoint, train

__all__ = [
    "DistillConfig",
    "DistillOptimizer",
    "MetricLogger",
    "TrainState",
    "export_student_checkpoint",
    "init_train_state",
    "load_train_state",
    "make_train_step",
    "make_eval_step",
    "make_grad_fn",
    "save_train_state",
    "train",
    "cosine_similarity",
    "distill_loss",
    "distill_loss_unstacked",
    "linear_decay_factor",
    "tri_stage_factor",
    "parse_layer_groups",
    "apply_projections",
    "flatten_groups",
    "init_projections",
    "projections_to_state_dict",
    "projections_from_state_dict",
]
