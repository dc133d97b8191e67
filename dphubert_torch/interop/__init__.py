from .torch_ckpt import (
    load_checkpoint,
    load_model,
    model_from_checkpoint,
    save_checkpoint,
    verify_strict,
)

__all__ = ["load_checkpoint", "save_checkpoint", "load_model", "model_from_checkpoint",
           "verify_strict"]
