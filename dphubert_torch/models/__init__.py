from .model import (
    Wav2Vec2Model,
    hubert_base,
    hubert_large,
    hubert_xlarge,
    wav2vec2_base,
    wav2vec2_large,
    wav2vec2_large_lv60k,
    wav2vec2_model,
    wav2vec2_model_original,
    wavlm_base,
    wavlm_large,
    wavlm_model,
)

__all__ = [
    "Wav2Vec2Model",
    "wav2vec2_model",
    "wav2vec2_model_original",
    "wavlm_model",
    "wav2vec2_base",
    "wav2vec2_large",
    "wav2vec2_large_lv60k",
    "hubert_base",
    "hubert_large",
    "hubert_xlarge",
    "wavlm_base",
    "wavlm_large",
]
