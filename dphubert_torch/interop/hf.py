"""HuggingFace ``transformers`` and fairseq importers (the TPU package's
``interop/hf.py``; reference ``convert_*_from_hf.py`` and
``wav2vec2/utils/import_huggingface_wavlm.py``).

The key maps work on state-dict *names*, so they accept a bare ``{name:
ndarray}`` dict and need neither ``transformers`` nor fairseq.  The HF
layout is a near superset of ours:

  HF                                      ours
  ------------------------------------    -----------------------------------
  feature_extractor.*                     feature_extractor.*
  feature_projection.*                    encoder.feature_projection.*
  encoder.pos_conv_embed.*                encoder.transformer.pos_conv_embed.*
  encoder.layer_norm.*                    encoder.transformer.layer_norm.*
  encoder.layers.*                        encoder.transformer.layers.*
  ...parametrizations.weight.original0/1  ...weight_g / weight_v
  masked_spec_embed                       (dropped: pretraining-only)

``config_from_hf``, ``config_from_hf_wavlm``, ``rename_hf_state_dict`` and
``rename_fairseq_state_dict`` are copies of the TPU package's functions;
``import_huggingface_model`` builds this package's model.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch


def config_from_hf(cfg) -> dict:
    """HF HubertConfig/Wav2Vec2Config -> portable config dict (the key map of
    the reference's ``_get_config``, import_huggingface_wavlm.py:18-37)."""
    n = cfg.num_hidden_layers
    return dict(
        extractor_mode=f"{cfg.feat_extract_norm}_norm",
        extractor_conv_layer_config=[
            list(t) for t in zip(cfg.conv_dim, cfg.conv_kernel, cfg.conv_stride)
        ],
        extractor_conv_bias=cfg.conv_bias,
        encoder_embed_dim=cfg.hidden_size,
        encoder_projection_dropout=cfg.feat_proj_dropout,
        encoder_pos_conv_kernel=cfg.num_conv_pos_embeddings,
        encoder_pos_conv_groups=cfg.num_conv_pos_embedding_groups,
        encoder_num_layers=n,
        encoder_use_attention=[True] * n,
        encoder_use_feed_forward=[True] * n,
        encoder_num_heads=[cfg.num_attention_heads] * n,
        encoder_head_dim=cfg.hidden_size // cfg.num_attention_heads,
        encoder_attention_dropout=cfg.attention_dropout,
        encoder_ff_interm_features=[cfg.intermediate_size] * n,
        encoder_ff_interm_dropout=cfg.activation_dropout,
        encoder_dropout=cfg.hidden_dropout,
        encoder_layer_norm_first=cfg.do_stable_layer_norm,
        encoder_layer_drop=cfg.layerdrop,
        aux_num_out=None,
        normalize_waveform=cfg.feat_extract_norm == "layer",
    )


def config_from_hf_wavlm(cfg) -> dict:
    """HF WavLMConfig -> portable WavLM config dict
    (reference ``_get_config_wavlm``, import_huggingface_wavlm.py:40-63)."""
    n = cfg.num_hidden_layers
    return dict(
        extractor_mode=f"{cfg.feat_extract_norm}_norm",
        extractor_conv_layer_config=[
            list(t) for t in zip(cfg.conv_dim, cfg.conv_kernel, cfg.conv_stride)
        ],
        extractor_conv_bias=cfg.conv_bias,
        encoder_embed_dim=cfg.hidden_size,
        encoder_projection_dropout=cfg.feat_proj_dropout,
        encoder_pos_conv_kernel=cfg.num_conv_pos_embeddings,
        encoder_pos_conv_groups=cfg.num_conv_pos_embedding_groups,
        encoder_num_layers=n,
        encoder_use_attention=[True] * n,
        encoder_use_feed_forward=[True] * n,
        encoder_total_num_heads=[cfg.num_attention_heads] * n,
        encoder_remaining_heads=[list(range(cfg.num_attention_heads)) for _ in range(n)],
        encoder_num_buckets=cfg.num_buckets,
        encoder_max_distance=cfg.max_bucket_distance,
        encoder_attention_dropout=cfg.attention_dropout,
        encoder_ff_interm_features=[cfg.intermediate_size] * n,
        encoder_ff_interm_dropout=cfg.activation_dropout,
        encoder_dropout=cfg.hidden_dropout,
        encoder_layer_norm_first=cfg.do_stable_layer_norm,
        encoder_layer_drop=cfg.layerdrop,
        aux_num_out=None,
        normalize_waveform=cfg.feat_extract_norm == "layer",
    )


def rename_hf_state_dict(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """HF key names -> our key names; drops pretraining-only tensors."""
    out = {}
    for k, v in sd.items():
        if k.startswith("masked_spec_embed"):
            continue
        if k.endswith("rel_attn_embed.weight") and not k.startswith(
            "encoder.layers.0."
        ):
            # position embedding only lives in the first layer in our layout
            continue
        nk = k
        if nk.startswith("feature_projection."):
            nk = "encoder." + nk
        elif nk.startswith("encoder."):
            nk = "encoder.transformer." + nk[len("encoder."):]
        # new-style torch weight_norm parametrization -> (g, v)
        nk = nk.replace("parametrizations.weight.original0", "weight_g")
        nk = nk.replace("parametrizations.weight.original1", "weight_v")
        out[nk] = np.asarray(v)
    return out


def fill_from_init(template: Dict[str, torch.Tensor], sd: Dict[str, np.ndarray]
                   ) -> Tuple[Dict[str, np.ndarray], list, list]:
    """``sd`` restricted to the keys of ``template`` (a freshly initialised
    model's state dict), the keys ``sd`` lacks (our-only tensors such as
    ``dummy_weight``, or a converter's gaps) taken from ``template`` ->
    (state dict, missing keys, unexpected keys)."""
    missing = sorted(k for k in template if k not in sd)
    unexpected = sorted(k for k in sd if k not in template)
    out = {k: sd[k] if k in sd else template[k].numpy() for k in template}
    return out, missing, unexpected


def import_huggingface_model(original, device="cuda",
                             generator: Optional[torch.Generator] = None
                             ) -> Tuple["object", Dict[str, np.ndarray]]:
    """Build our model and its flat state dict from a HF ``HubertModel`` /
    ``Wav2Vec2Model`` / ``WavLMModel`` (or their ForCTC wrappers: the
    lm_head becomes the aux layer, reference
    import_huggingface_wavlm.py:66-97).

    The model is loaded with ``strict=True`` and placed on ``device``; the
    tensors HF does not have (``dummy_weight``) come from a fresh init drawn
    from ``generator`` (seed 0 unless one is given)."""
    from ..models.model import resolve_device, wav2vec2_model

    device = resolve_device(device)
    name = original.__class__.__name__
    is_for_ctc = name in ("Wav2Vec2ForCTC", "HubertForCTC", "WavLMForCTC")
    if is_for_ctc:
        inner = getattr(original, "wav2vec2", None) or getattr(
            original, "hubert", None
        ) or getattr(original, "wavlm")
        aux_num_out = original.config.vocab_size
    else:
        inner = original
        aux_num_out = None
    is_wavlm = inner.__class__.__name__ == "WavLMModel"

    cfg = (
        config_from_hf_wavlm(inner.config)
        if is_wavlm
        else config_from_hf(inner.config)
    )
    cfg["aux_num_out"] = aux_num_out
    # the tensors HF does not have keep this init
    model = wav2vec2_model(device="cpu", generator=generator, **cfg)

    sd = {k: v.detach().cpu().numpy() for k, v in inner.state_dict().items()}
    sd = rename_hf_state_dict(sd)
    if is_for_ctc:
        head = original.lm_head.state_dict()
        sd["aux.weight"] = head["weight"].detach().cpu().numpy()
        sd["aux.bias"] = head["bias"].detach().cpu().numpy()

    sd, missing, unexpected = fill_from_init(model.state_dict(), sd)
    if missing or unexpected:
        print(f"import_huggingface_model: missing={missing} unexpected={unexpected}")
    model.load_state_dict({k: torch.from_numpy(np.array(v, copy=True)) for k, v in sd.items()},
                          strict=True)
    return model.to(device).eval(), sd


# ---------------------------------------------------------------------------
# fairseq (state-dict level; fairseq itself is not required)
# ---------------------------------------------------------------------------

_FAIRSEQ_RENAMES = [
    ("post_extract_proj.", "encoder.feature_projection.projection."),
    ("layer_norm.", "encoder.feature_projection.layer_norm."),
    ("encoder.pos_conv.0.", "encoder.transformer.pos_conv_embed.conv."),
    ("encoder.layer_norm.", "encoder.transformer.layer_norm."),
    ("encoder.layers.", "encoder.transformer.layers."),
]


def rename_fairseq_state_dict(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """fairseq wav2vec2/HuBERT model state dict -> our key names.

    Handles the well-known fairseq layout: ``feature_extractor.conv_layers.
    {i}.0.weight`` (conv), ``.2.1.weight`` (group-norm in layer 0) /
    ``.2.weight`` (transposed LN), fused in-proj already split (modern
    fairseq splits k/q/v), ``self_attn`` -> ``attention``,
    ``fc1/fc2`` -> FFN dense layers, ``self_attn_layer_norm``/
    ``final_layer_norm`` -> the two per-layer LNs.
    """
    out = {}
    for k, v in sd.items():
        v = np.asarray(v)
        nk = None
        if k.startswith("feature_extractor.conv_layers."):
            parts = k.split(".")
            i, sub = parts[2], parts[3]
            if sub == "0":  # conv
                nk = f"feature_extractor.conv_layers.{i}.conv.{parts[-1]}"
            elif sub == "2":
                # norm: group-norm is nested one deeper ('2.1.weight')
                nk = f"feature_extractor.conv_layers.{i}.layer_norm.{parts[-1]}"
            else:
                continue
        elif k.startswith(("quantizer", "project_q", "final_proj", "mask_emb",
                           "label_embs_concat")):
            continue  # pretraining heads not used downstream
        else:
            nk = k
            for old, new in _FAIRSEQ_RENAMES:
                if nk.startswith(old):
                    nk = new + nk[len(old):]
                    break
            nk = nk.replace(".self_attn_layer_norm.", ".layer_norm.")
            nk = nk.replace(".self_attn.", ".attention.")
            nk = nk.replace(".fc1.", ".feed_forward.intermediate_dense.")
            nk = nk.replace(".fc2.", ".feed_forward.output_dense.")
        if nk is not None:
            out[nk] = v
    return out
