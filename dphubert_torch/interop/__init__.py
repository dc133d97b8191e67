from .hf import (
    config_from_hf,
    config_from_hf_wavlm,
    import_huggingface_model,
    rename_fairseq_state_dict,
    rename_hf_state_dict,
)
from .torch_ckpt import (
    load_checkpoint,
    load_model,
    model_from_checkpoint,
    save_checkpoint,
    verify_strict,
)

__all__ = ["load_checkpoint", "save_checkpoint", "load_model", "model_from_checkpoint",
           "verify_strict", "config_from_hf", "config_from_hf_wavlm",
           "import_huggingface_model", "rename_fairseq_state_dict", "rename_hf_state_dict"]
