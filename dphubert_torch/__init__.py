"""dphubert_torch: the PyTorch/CUDA port of DPHuBERT for NVIDIA Hopper.

It serves compressed HuBERT / wav2vec 2.0 checkpoints (load a portable
``{"config", "state_dict"}`` checkpoint, call ``extract_features`` or the
bucketing :class:`~dphubert_torch.serve.Predictor`) and runs the
four-stage recipe on one card: the data pipeline (:mod:`dphubert_torch.data`),
the distill step and its trainer (:mod:`dphubert_torch.train`:
``make_train_step``, ``train``), prune surgery (:mod:`dphubert_torch.prune`)
and the stage CLIs (:mod:`dphubert_torch.cli`).  Attention runs in
hand-written CUDA kernels (``csrc/attention_fwd.cu``,
``csrc/attention_bwd.cu``) built with ``nvcc`` at first use.  Everything runs on the card unless the caller
passes ``device="cpu"``, where each kernel's plain PyTorch version runs
instead.
"""

__version__ = "0.1.0"

from .configs import ModelSpec, spec_from_config, config_from_spec
from .models import (
    Wav2Vec2Model,
    wav2vec2_model,
    wavlm_model,
    wav2vec2_base,
    wav2vec2_large,
    wav2vec2_large_lv60k,
    hubert_base,
    hubert_large,
    hubert_xlarge,
    wavlm_base,
    wavlm_large,
)
from .params import (
    flatten_params,
    unflatten_params,
    init_params,
    state_dict_from_jax,
    train_params_from_jax,
)

__all__ = [
    "ModelSpec",
    "spec_from_config",
    "config_from_spec",
    "Wav2Vec2Model",
    "wav2vec2_model",
    "wavlm_model",
    "wav2vec2_base",
    "wav2vec2_large",
    "wav2vec2_large_lv60k",
    "hubert_base",
    "hubert_large",
    "hubert_xlarge",
    "wavlm_base",
    "wavlm_large",
    "flatten_params",
    "unflatten_params",
    "init_params",
    "state_dict_from_jax",
    "train_params_from_jax",
]
