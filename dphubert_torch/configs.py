"""Model configuration system.

The public configuration surface is the reference's flat ``config`` dict — the
24-key wav2vec2/HuBERT layout (the reference's
``convert_hubert_from_hf.py:18-44``) and the 27-key WavLM layout
(``convert_wavlm_from_hf.py:19-47``).
A checkpoint is ``{"config": <dict>, "state_dict": <flat params>}`` and
``wav2vec2_model(**config)`` must accept the dict verbatim.

Internally we normalize that dict into immutable, hashable dataclasses
(:class:`ModelSpec` and friends) so the spec can serve as a hashable static
value.  All list-typed config entries become tuples.

Dispatch rule (reference ``wav2vec2/model.py:172-178``): the presence of the
``encoder_remaining_heads`` key selects the WavLM architecture.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


DEFAULT_CONV_LAYER_CONFIG: Tuple[Tuple[int, int, int], ...] = (
    (512, 10, 5),
    (512, 3, 2),
    (512, 3, 2),
    (512, 3, 2),
    (512, 3, 2),
    (512, 2, 2),
    (512, 2, 2),
)


@dataclass(frozen=True)
class ConvLayerSpec:
    """One stage of the waveform CNN (reference ``components.py:64-134``)."""

    in_channels: int
    out_channels: int
    kernel_size: int
    stride: int
    bias: bool
    # "group_norm" | "layer_norm" | None
    norm: Optional[str]
    prune_channels: bool = False


@dataclass(frozen=True)
class AttentionSpec:
    """Prunable MHA (reference ``components.py:336-483``) or the WavLM variant
    with gated relative position bias (``components.py:486-693``)."""

    embed_dim: int
    num_heads: int
    head_dim: int
    dropout: float
    prune_heads: bool = False
    prune_layer: bool = False
    # --- WavLM extensions (None/absent for plain wav2vec2/HuBERT) ---
    is_wavlm: bool = False
    total_num_heads: Optional[int] = None
    remaining_heads: Optional[Tuple[int, ...]] = None
    has_relative_attention_bias: bool = False
    num_buckets: int = 320
    max_distance: int = 800
    gru_rel_pos: bool = True


@dataclass(frozen=True)
class FeedForwardSpec:
    """Prunable FFN (reference ``components.py:696-791``)."""

    io_features: int
    intermediate_features: int
    intermediate_dropout: float
    output_dropout: float
    prune_intermediate: bool = False
    prune_layer: bool = False


@dataclass(frozen=True)
class EncoderLayerSpec:
    """Residual attention+FFN block; either sublayer may be absent after
    layer-level pruning (reference ``components.py:794-865``)."""

    attention: Optional[AttentionSpec]
    feed_forward: Optional[FeedForwardSpec]
    embed_dim: int
    dropout: float
    layer_norm_first: bool


@dataclass(frozen=True)
class ModelSpec:
    """Fully-normalized static architecture description.

    Mirrors the information content of the reference config dict, with
    per-layer heterogeneity made explicit (pruned models have per-layer head
    counts / FFN widths / missing sublayers).
    """

    # feature extractor
    extractor_mode: str  # "group_norm" | "layer_norm"
    conv_layers: Tuple[ConvLayerSpec, ...]
    # encoder
    embed_dim: int
    projection_dropout: float
    pos_conv_kernel: int
    pos_conv_groups: int
    layers: Tuple[EncoderLayerSpec, ...]
    dropout: float
    # NOTE inverted on purpose vs the per-layer flag — the reference builds
    # Transformer(layer_norm_first=not encoder_layer_norm_first)
    # (components.py:1283): post-norm model => LN applied at the *end* of the
    # transformer, pre-norm model => LN in the preprocess.
    transformer_layer_norm_first: bool
    layer_drop: float
    # top level
    aux_num_out: Optional[int]
    normalize_waveform: bool
    is_wavlm: bool = False

    @property
    def num_layers(self) -> int:
        return len(self.layers)

    @property
    def encoder_in_features(self) -> int:
        return self.conv_layers[-1].out_channels


def _as_list(val, n: int):
    """Broadcast a scalar config value to a per-layer list (the reference's
    HF importer passes scalars for uniform models, e.g.
    ``import_huggingface_wavlm.py:28-31``)."""
    if isinstance(val, (list, tuple)):
        if len(val) != n:
            raise ValueError(f"per-layer config length {len(val)} != num_layers {n}")
        return list(val)
    return [val] * n


def spec_from_config(**config) -> ModelSpec:
    """Normalize a reference-format config dict into a :class:`ModelSpec`.

    Accepts both the wav2vec2/HuBERT key set (``encoder_num_heads`` +
    ``encoder_head_dim``) and the WavLM key set (``encoder_total_num_heads`` +
    ``encoder_remaining_heads`` + buckets/distance), dispatching exactly like
    the reference factory (``model.py:172-178``).
    """
    cfg = dict(config)
    is_wavlm = "encoder_remaining_heads" in cfg

    conv_cfg = cfg.get("extractor_conv_layer_config")
    if conv_cfg is None:
        conv_cfg = DEFAULT_CONV_LAYER_CONFIG
    conv_cfg = tuple((int(c), int(k), int(s)) for (c, k, s) in conv_cfg)

    extractor_mode = cfg["extractor_mode"]
    if extractor_mode not in ("group_norm", "layer_norm"):
        raise ValueError(f"Invalid extractor_mode: {extractor_mode}")
    conv_bias = bool(cfg["extractor_conv_bias"])
    prune_conv = bool(cfg.get("extractor_prune_conv_channels", False))

    conv_layers = []
    in_ch = 1
    for i, (out_ch, k, s) in enumerate(conv_cfg):
        if extractor_mode == "group_norm" and i == 0:
            norm = "group_norm"
        elif extractor_mode == "layer_norm":
            norm = "layer_norm"
        else:
            norm = None
        conv_layers.append(
            ConvLayerSpec(
                in_channels=in_ch,
                out_channels=out_ch,
                kernel_size=k,
                stride=s,
                bias=conv_bias,
                norm=norm,
                prune_channels=prune_conv,
            )
        )
        in_ch = out_ch

    n = int(cfg["encoder_num_layers"])
    embed_dim = int(cfg["encoder_embed_dim"])
    use_attention = [bool(b) for b in _as_list(cfg["encoder_use_attention"], n)]
    use_ff = [bool(b) for b in _as_list(cfg["encoder_use_feed_forward"], n)]
    ff_interm = [int(v) for v in _as_list(cfg["encoder_ff_interm_features"], n)]
    attn_dropout = float(cfg["encoder_attention_dropout"])
    ff_interm_dropout = float(cfg["encoder_ff_interm_dropout"])
    dropout = float(cfg["encoder_dropout"])
    layer_norm_first = bool(cfg["encoder_layer_norm_first"])
    prune_heads = bool(cfg.get("encoder_prune_attention_heads", False))
    prune_att_layer = bool(cfg.get("encoder_prune_attention_layer", False))
    prune_interm = bool(cfg.get("encoder_prune_feed_forward_intermediate", False))
    prune_ff_layer = bool(cfg.get("encoder_prune_feed_forward_layer", False))

    if is_wavlm:
        total_heads = [int(v) for v in _as_list(cfg["encoder_total_num_heads"], n)]
        remaining = [tuple(int(h) for h in hs) for hs in cfg["encoder_remaining_heads"]]
        if len(remaining) != n:
            raise ValueError("encoder_remaining_heads must have one entry per layer")
        num_buckets = int(cfg["encoder_num_buckets"])
        max_distance = int(cfg["encoder_max_distance"])
    else:
        num_heads = [int(v) for v in _as_list(cfg["encoder_num_heads"], n)]
        head_dim = int(cfg["encoder_head_dim"])

    layers = []
    for i in range(n):
        if use_attention[i]:
            if is_wavlm:
                # WavLM derives head_dim from embed_dim / total heads
                # (reference components.py:521).
                att = AttentionSpec(
                    embed_dim=embed_dim,
                    num_heads=len(remaining[i]),
                    head_dim=embed_dim // total_heads[i],
                    dropout=attn_dropout,
                    prune_heads=prune_heads,
                    prune_layer=prune_att_layer,
                    is_wavlm=True,
                    total_num_heads=total_heads[i],
                    remaining_heads=remaining[i],
                    # position embedding lives only in the first layer
                    # (reference components.py:1349)
                    has_relative_attention_bias=(i == 0),
                    num_buckets=num_buckets,
                    max_distance=max_distance,
                    gru_rel_pos=True,
                )
            else:
                att = AttentionSpec(
                    embed_dim=embed_dim,
                    num_heads=num_heads[i],
                    head_dim=head_dim,
                    dropout=attn_dropout,
                    prune_heads=prune_heads,
                    prune_layer=prune_att_layer,
                )
        else:
            att = None
        if use_ff[i]:
            ff = FeedForwardSpec(
                io_features=embed_dim,
                intermediate_features=ff_interm[i],
                intermediate_dropout=ff_interm_dropout,
                output_dropout=dropout,
                prune_intermediate=prune_interm,
                prune_layer=prune_ff_layer,
            )
        else:
            ff = None
        layers.append(
            EncoderLayerSpec(
                attention=att,
                feed_forward=ff,
                embed_dim=embed_dim,
                dropout=dropout,
                layer_norm_first=layer_norm_first,
            )
        )

    aux_num_out = cfg.get("aux_num_out")
    return ModelSpec(
        extractor_mode=extractor_mode,
        conv_layers=tuple(conv_layers),
        embed_dim=embed_dim,
        projection_dropout=float(cfg["encoder_projection_dropout"]),
        pos_conv_kernel=int(cfg["encoder_pos_conv_kernel"]),
        pos_conv_groups=int(cfg["encoder_pos_conv_groups"]),
        layers=tuple(layers),
        dropout=dropout,
        transformer_layer_norm_first=not layer_norm_first,
        layer_drop=float(cfg["encoder_layer_drop"]),
        aux_num_out=None if aux_num_out is None else int(aux_num_out),
        normalize_waveform=bool(cfg["normalize_waveform"]),
        is_wavlm=is_wavlm,
    )


def config_from_spec(spec: ModelSpec, *, prune_flags: bool = False) -> dict:
    """Re-emit the reference-format config dict for a spec (used when saving
    portable checkpoints; mirrors the key layout of
    ``convert_hubert_from_hf.py:18-44`` / ``convert_wavlm_from_hf.py:19-47``)."""
    n = spec.num_layers
    first = next((l for l in spec.layers if l.attention is not None), None)
    cfg = dict(
        extractor_mode=spec.extractor_mode,
        extractor_conv_layer_config=[
            [c.out_channels, c.kernel_size, c.stride] for c in spec.conv_layers
        ],
        extractor_conv_bias=spec.conv_layers[0].bias,
        encoder_embed_dim=spec.embed_dim,
        encoder_projection_dropout=spec.projection_dropout,
        encoder_pos_conv_kernel=spec.pos_conv_kernel,
        encoder_pos_conv_groups=spec.pos_conv_groups,
        encoder_num_layers=n,
        encoder_use_attention=[l.attention is not None for l in spec.layers],
        encoder_use_feed_forward=[l.feed_forward is not None for l in spec.layers],
        encoder_attention_dropout=(first.attention.dropout if first else 0.0),
        encoder_ff_interm_features=[
            (l.feed_forward.intermediate_features if l.feed_forward else 0)
            for l in spec.layers
        ],
        encoder_ff_interm_dropout=next(
            (l.feed_forward.intermediate_dropout for l in spec.layers if l.feed_forward),
            0.0,
        ),
        encoder_dropout=spec.dropout,
        encoder_layer_norm_first=not spec.transformer_layer_norm_first,
        encoder_layer_drop=spec.layer_drop,
        aux_num_out=spec.aux_num_out,
        normalize_waveform=spec.normalize_waveform,
    )
    if spec.is_wavlm:
        cfg["encoder_total_num_heads"] = [
            (l.attention.total_num_heads if l.attention else 0) for l in spec.layers
        ]
        cfg["encoder_remaining_heads"] = [
            (list(l.attention.remaining_heads) if l.attention else [])
            for l in spec.layers
        ]
        any_att = first.attention if first else None
        cfg["encoder_num_buckets"] = any_att.num_buckets if any_att else 320
        cfg["encoder_max_distance"] = any_att.max_distance if any_att else 800
    else:
        cfg["encoder_num_heads"] = [
            (l.attention.num_heads if l.attention else 0) for l in spec.layers
        ]
        cfg["encoder_head_dim"] = first.attention.head_dim if first else 64
    if prune_flags:
        cfg.update(
            extractor_prune_conv_channels=spec.conv_layers[0].prune_channels,
            encoder_prune_attention_heads=bool(first and first.attention.prune_heads),
            encoder_prune_attention_layer=bool(first and first.attention.prune_layer),
            encoder_prune_feed_forward_intermediate=any(
                l.feed_forward is not None and l.feed_forward.prune_intermediate
                for l in spec.layers
            ),
            encoder_prune_feed_forward_layer=any(
                l.feed_forward is not None and l.feed_forward.prune_layer
                for l in spec.layers
            ),
        )
    else:
        cfg.update(
            extractor_prune_conv_channels=False,
            encoder_prune_attention_heads=False,
            encoder_prune_attention_layer=False,
            encoder_prune_feed_forward_intermediate=False,
            encoder_prune_feed_forward_layer=False,
        )
    return cfg


def replace(spec, **kw):
    return dataclasses.replace(spec, **kw)
