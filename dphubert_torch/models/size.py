"""Differentiable model-size accounting (the TPU package's
``models/size.py``).

Wherever a HardConcrete gate exists, the corresponding dimension is replaced
by the gate's differentiable expected L0 norm, so the sparsity loss
backpropagates into ``log_alpha``.  Functions take the nested parameter dict
(``unflatten_params(dict(model.named_parameters()))``) and return a 0-dim
tensor (a Python number for an ungated model).
"""

from __future__ import annotations

from ..configs import AttentionSpec, FeedForwardSpec, ModelSpec
from .hardconcrete import l0_norm


def _conv_block_size(p, spec, in_channels):
    if "hard_concrete" in p:
        out_channels = l0_norm(p["hard_concrete"]["log_alpha"])
    else:
        out_channels = spec.out_channels
    n = in_channels * out_channels * spec.kernel_size
    if spec.bias:
        n = n + out_channels
    if spec.norm is not None:
        n = n + out_channels * 2
    return n, out_channels


def feature_extractor_size(p, spec: ModelSpec):
    """Returns (num_params, final_out_channels); includes the dummy weight."""
    in_ch = 1
    total = 0
    for i, c in enumerate(spec.conv_layers):
        n, in_ch = _conv_block_size(p["conv_layers"][str(i)], c, in_ch)
        total = total + n
    total = total + in_ch  # dummy weight
    return total, in_ch


def attention_size(p, spec: AttentionSpec):
    if "hard_concrete_for_heads" in p:
        nh = l0_norm(p["hard_concrete_for_heads"]["log_alpha"])
    else:
        nh = spec.num_heads
    e, d = spec.embed_dim, spec.head_dim
    n = (e + 1) * nh * d * 3 + (nh * d + 1) * e
    if "hard_concrete_for_layer" in p:
        n = n * l0_norm(p["hard_concrete_for_layer"]["log_alpha"])
    return n


def feed_forward_size(p, spec: FeedForwardSpec):
    io = spec.io_features
    if "hard_concrete_for_intermediate" in p:
        i = l0_norm(p["hard_concrete_for_intermediate"]["log_alpha"])
    else:
        i = spec.intermediate_features
    n = (io + 1) * i + (i + 1) * io
    if "hard_concrete_for_layer" in p:
        n = n * l0_norm(p["hard_concrete_for_layer"]["log_alpha"])
    return n


def encoder_size(p, spec: ModelSpec, in_features):
    """FeatureProjection + Transformer, with the pos-conv weights and the
    transformer-level LayerNorm."""
    fp = in_features * 2 + (in_features + 1) * spec.embed_dim
    # pos conv: numel of weight_g (K) + weight_v (E * E/groups * K) + bias (E)
    e, k, g = spec.embed_dim, spec.pos_conv_kernel, spec.pos_conv_groups
    total = fp + (k + e * (e // g) * k + e) + e * 2
    for i, layer in enumerate(spec.layers):
        lp = p["transformer"]["layers"][str(i)]
        n = layer.embed_dim * 2 * 2  # the two per-layer LayerNorms
        if layer.attention is not None:
            n = n + attention_size(lp["attention"], layer.attention)
        if layer.feed_forward is not None:
            n = n + feed_forward_size(lp["feed_forward"], layer.feed_forward)
        total = total + n
    return total


def model_size(params, spec: ModelSpec):
    """Differentiable current model size; excludes the aux head, includes
    gate-softened dimensions."""
    fe, in_features = feature_extractor_size(params["feature_extractor"], spec)
    return fe + encoder_size(params["encoder"], spec, in_features)
