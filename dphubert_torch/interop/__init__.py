from .torch_ckpt import (
    load_checkpoint,
    load_model,
    save_checkpoint,
    verify_strict,
)

__all__ = ["load_checkpoint", "save_checkpoint", "load_model", "verify_strict"]
