"""Building blocks of wav2vec 2.0 / HuBERT as ``nn.Module``s.

The attribute tree of every module reproduces the portable state-dict keys
exactly (``feature_extractor.conv_layers.0.conv.weight`` and so on), so a
``{"config", "state_dict"}`` checkpoint loads with ``strict=True`` and no
renaming, and the TPU package's parameter tree flattens to the same keys.

Numerics follow the TPU package's component layer:
  * LayerNorm and GroupNorm take fp32 statistics; fp32 inputs use the
    two-pass formula, sub-fp32 inputs the one-pass E[x^2] - E[x]^2 form with
    fp32 accumulation, and the result is cast back to the input dtype;
  * weights are cast to the activation dtype at every call;
  * GELU is the exact (erf) form;
  * attention runs in a hand-written CUDA kernel on the card and in the
    kernel's plain version on the CPU (see ``attention_route``).

Training (the distill step) passes a ``torch.Generator`` for dropout and a
nested dict of HardConcrete gates, keyed as the TPU package's gate tree
(``models/gates.py``); both are applied where the TPU package applies them.
With no generator there is no dropout, and with no gates none is applied,
as in the TPU package's eval path.  LayerDrop is not ported (it only acts in
``forward(training=True)``, which raises).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..configs import (
    AttentionSpec,
    ConvLayerSpec,
    EncoderLayerSpec,
    FeedForwardSpec,
    ModelSpec,
)
from ..ops.flash_attention import flash_attention_qkv
from ..ops.packed_attention import packed_attention_qkv, packed_num_groups

LN_EPS = 1e-5


def _layer_norm(x, weight, bias, dim: int = -1, affine_dim: Optional[int] = None):
    """Normalise over ``dim`` with fp32 statistics and apply the affine along
    ``affine_dim`` (default ``dim``); GroupNorm with one group per channel is
    the (stats=time, affine=channel) case."""
    if affine_dim is None:
        affine_dim = dim
    shape = [1] * x.ndim
    shape[affine_dim] = x.shape[affine_dim]
    if x.dtype == torch.float32:
        mean = x.mean(dim=dim, keepdim=True)
        var = (x - mean).square().mean(dim=dim, keepdim=True)
        y = (x - mean) * torch.rsqrt(var + LN_EPS)
        if weight is not None:
            y = y * weight.float().reshape(shape) + bias.float().reshape(shape)
        return y
    x32 = x.float()
    mean = x32.mean(dim=dim, keepdim=True)
    mean_sq = x32.square().mean(dim=dim, keepdim=True)
    var = (mean_sq - mean.square()).clamp_min(0.0)
    scale = torch.rsqrt(var + LN_EPS)
    shift = -mean * scale
    if weight is not None:
        w32 = weight.float().reshape(shape)
        scale = scale * w32
        shift = shift * w32 + bias.float().reshape(shape)
    return (x32 * scale + shift).to(x.dtype)


def _uniform_(t: torch.Tensor, bound: float, gen: torch.Generator) -> None:
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=gen)


def _dropout(x, rate: float, generator: Optional[torch.Generator]):
    """Inverted dropout drawn from ``generator`` (on x's device); the
    identity when there is no generator (eval) or the rate is 0."""
    if generator is None or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def _gate(gates: Optional[dict], *path: str):
    """``gates[path[0]][path[1]]...`` or None where the tree has no entry."""
    for key in path:
        if not gates:
            return None
        gates = gates.get(key)
    return gates


def _output_length(length, kernel_size: int, stride: int):
    """Conv length recurrence floor((len - k) / stride) + 1, clamped at 0."""
    return torch.clamp_min(
        torch.div(length - kernel_size, stride, rounding_mode="floor") + 1, 0
    )


class Norm(nn.Module):
    """LayerNorm / GroupNorm parameters (weight=1, bias=0 at init)."""

    def __init__(self, n: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n))
        self.bias = nn.Parameter(torch.empty(n))

    def reset_parameters(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x):
        return _layer_norm(x, self.weight, self.bias)


class Linear(nn.Module):
    """torch-layout Linear, weight (out, in), cast to the input's dtype."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True):
        super().__init__()
        self.in_features = in_features
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None

    def reset_parameters(self, gen: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.in_features)
        _uniform_(self.weight, bound, gen)
        if self.bias is not None:
            _uniform_(self.bias, bound, gen)

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), b)


class Conv1d(nn.Module):
    """torch-layout Conv1d parameters, weight (out, in/groups, k)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, bias: bool):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_ch)) if bias else None

    def reset_parameters(self, gen: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.weight.shape[1] * self.weight.shape[2])
        _uniform_(self.weight, bound, gen)
        if self.bias is not None:
            _uniform_(self.bias, bound, gen)


class HardConcrete(nn.Module):
    """Holds a HardConcrete gate's ``log_alpha``; the masks are sampled and
    compiled outside the layers (``models/gates.py``) and passed in."""

    def __init__(self, n_in: int, init_mean: float):
        super().__init__()
        self.init_mean = init_mean
        self.log_alpha = nn.Parameter(torch.empty(n_in))

    def reset_parameters(self, gen: torch.Generator) -> None:
        mean = math.log(1 - self.init_mean) - math.log(self.init_mean)
        with torch.no_grad():
            self.log_alpha.normal_(mean, 0.01, generator=gen)


# ---------------------------------------------------------------------------
# Feature extractor
# ---------------------------------------------------------------------------


class ConvLayerBlock(nn.Module):
    """Conv1d -> optional norm -> GELU, with the conv length recurrence."""

    def __init__(self, spec: ConvLayerSpec):
        super().__init__()
        self.spec = spec
        self.conv = Conv1d(spec.in_channels, spec.out_channels, spec.kernel_size, spec.bias)
        self.layer_norm = Norm(spec.out_channels) if spec.norm is not None else None
        if spec.prune_channels:
            self.hard_concrete = HardConcrete(spec.out_channels, 0.01)

    def forward(self, x, length, gate=None):
        """x: (B, C_in, T) -> ((B, C_out, T'), length'); ``gate`` scales the
        output channels (the TPU package's conv channel gate)."""
        spec = self.spec
        bias = None if self.conv.bias is None else self.conv.bias.to(x.dtype)
        y = F.conv1d(x, self.conv.weight.to(x.dtype), bias, stride=spec.stride)
        if spec.norm == "group_norm":
            # GroupNorm(C, C): per-channel statistics over all T, padding
            # included, so the padded length changes the valid frames
            y = _layer_norm(y, self.layer_norm.weight, self.layer_norm.bias,
                            dim=2, affine_dim=1)
        elif spec.norm == "layer_norm":
            # transposed LayerNorm: over the channels at every frame
            y = _layer_norm(y, self.layer_norm.weight, self.layer_norm.bias, dim=1)
        y = F.gelu(y)
        if gate is not None:
            y = y * gate.to(y.dtype)[None, :, None]
        if length is not None:
            length = _output_length(length, spec.kernel_size, spec.stride)
        return y, length


class FeatureExtractor(nn.Module):
    """(B, T) waveform -> (B, frames, C) features."""

    def __init__(self, spec: ModelSpec):
        super().__init__()
        self.conv_layers = nn.ModuleList(ConvLayerBlock(c) for c in spec.conv_layers)
        # non-trainable carrier of the last conv layer's soft mask
        self.dummy_weight = nn.Parameter(
            torch.empty(spec.conv_layers[-1].out_channels), requires_grad=False
        )

    def reset_parameters(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.dummy_weight.fill_(1.0)

    def forward(self, wave, lengths, gates=None):
        x = wave[:, None, :]
        for i, layer in enumerate(self.conv_layers):
            x, lengths = layer(x, lengths, _gate(gates, "conv_layers", str(i)))
        x = x.transpose(1, 2)
        return x * self.dummy_weight.to(x.dtype), lengths


def output_lengths(spec: ModelSpec, lengths):
    """Compose the conv length recurrence without running the convs."""
    for c in spec.conv_layers:
        lengths = _output_length(lengths, c.kernel_size, c.stride)
    return lengths


# ---------------------------------------------------------------------------
# Encoder pieces
# ---------------------------------------------------------------------------


class FeatureProjection(nn.Module):
    """LayerNorm -> Linear(in -> embed) -> Dropout."""

    def __init__(self, in_features: int, out_features: int, dropout: float):
        super().__init__()
        self.dropout = dropout
        self.layer_norm = Norm(in_features)
        self.projection = Linear(in_features, out_features)

    def forward(self, x, generator=None):
        return _dropout(self.projection(self.layer_norm(x)), self.dropout, generator)


class WeightNormConv(nn.Module):
    """Grouped conv with weight_norm over dim 2: the state dict holds
    ``weight_g`` (1, 1, K) and ``weight_v`` as plain parameters and the
    weight is v * g / ||v|| with the norm over dims (0, 1)."""

    def __init__(self, embed_dim: int, kernel_size: int, groups: int):
        super().__init__()
        self.bias = nn.Parameter(torch.empty(embed_dim))
        self.weight_g = nn.Parameter(torch.empty(1, 1, kernel_size))
        self.weight_v = nn.Parameter(torch.empty(embed_dim, embed_dim // groups, kernel_size))

    def reset_parameters(self, gen: torch.Generator) -> None:
        v = self.weight_v
        bound = 1.0 / math.sqrt(v.shape[1] * v.shape[2])
        _uniform_(v, bound, gen)
        _uniform_(self.bias, bound, gen)
        with torch.no_grad():
            self.weight_g.copy_(v.square().sum(dim=(0, 1), keepdim=True).sqrt())

    def weight(self, dtype):
        g = self.weight_g.float()
        v = self.weight_v.float()
        norm = v.square().sum(dim=(0, 1), keepdim=True).sqrt()
        return (v * (g / norm)).to(dtype)


class ConvolutionalPositionalEmbedding(nn.Module):
    """Weight-normed grouped conv, padding K//2, even kernels drop the last
    frame, then GELU.  x: (B, L, E)."""

    def __init__(self, embed_dim: int, kernel_size: int, groups: int):
        super().__init__()
        self.kernel_size = kernel_size
        self.groups = groups
        self.conv = WeightNormConv(embed_dim, kernel_size, groups)

    def forward(self, x):
        k = self.kernel_size
        y = F.conv1d(
            x.transpose(1, 2), self.conv.weight(x.dtype), self.conv.bias.to(x.dtype),
            padding=k // 2, groups=self.groups,
        )
        if k % 2 == 0:
            y = y[..., :-1]
        return F.gelu(y).transpose(1, 2)


def attention_route(L: int, num_heads: int, head_dim: int) -> str:
    """Which attention kernel a layer takes: the TPU package's dispatch
    (``packed`` when its packed kernel could run the shape, else ``flash``).
    On a CPU tensor the chosen kernel's wrapper runs its plain version."""
    return "packed" if packed_num_groups(L, num_heads, head_dim) > 0 else "flash"


class SelfAttention(nn.Module):
    """Multi-head self-attention with decoupled inner width H*D."""

    def __init__(self, spec: AttentionSpec):
        super().__init__()
        if spec.is_wavlm:
            raise NotImplementedError(
                "WavLM attention is not ported yet (ROADMAP queue 2, the WavLM kernels)"
            )
        self.spec = spec
        inner = spec.num_heads * spec.head_dim
        self.k_proj = Linear(spec.embed_dim, inner)
        self.v_proj = Linear(spec.embed_dim, inner)
        self.q_proj = Linear(spec.embed_dim, inner)
        self.out_proj = Linear(inner, spec.embed_dim)
        if spec.prune_heads:
            self.hard_concrete_for_heads = HardConcrete(spec.num_heads, 0.01)
        if spec.prune_layer:
            self.hard_concrete_for_layer = HardConcrete(1, 0.01)

    def forward(self, x, lengths, gates=None, generator=None):
        """x: (B, L, E); lengths: int32 (B,) valid frames or None; gates:
        ``{"heads": (H,), "layer": (1,)}`` entries or None; ``generator``
        turns attention-probability dropout on (in the kernel)."""
        B, L, _ = x.shape
        H, D = self.spec.num_heads, self.spec.head_dim
        scale = D ** -0.5
        rate = self.spec.dropout if generator is not None else 0.0
        # one fused (B*L, E) @ (E, 3*H*D) product; q, k, v stay views of it
        w = torch.cat([self.q_proj.weight, self.k_proj.weight, self.v_proj.weight])
        b = torch.cat([self.q_proj.bias, self.k_proj.bias, self.v_proj.bias])
        qkv = F.linear(x, w.to(x.dtype), b.to(x.dtype))
        seed = None
        if rate > 0.0:  # one int32 on the device: the kernels read it there
            seed = torch.randint(-2**31, 2**31, (1,), generator=generator,
                                 device=x.device).to(torch.int32)
        attend = (packed_attention_qkv if attention_route(L, H, D) == "packed"
                  else flash_attention_qkv)
        out = attend(qkv, lengths, num_heads=H, scale=scale, dropout_rate=rate, seed=seed)
        head_gate = _gate(gates, "heads")
        if head_gate is not None:
            out = (out.view(B, L, H, D) * head_gate.to(out.dtype)[:, None]).view(B, L, H * D)
        out = self.out_proj(out)
        layer_gate = _gate(gates, "layer")
        if layer_gate is not None:
            out = out * layer_gate.to(out.dtype)
        return out


class FeedForward(nn.Module):
    """Linear -> GELU -> Dropout -> [intermediate gate] -> Linear -> Dropout
    -> [layer gate]."""

    def __init__(self, spec: FeedForwardSpec):
        super().__init__()
        self.spec = spec
        self.intermediate_dense = Linear(spec.io_features, spec.intermediate_features)
        self.output_dense = Linear(spec.intermediate_features, spec.io_features)
        if spec.prune_intermediate:
            self.hard_concrete_for_intermediate = HardConcrete(
                spec.intermediate_features, 0.5
            )
        if spec.prune_layer:
            self.hard_concrete_for_layer = HardConcrete(1, 0.01)

    def forward(self, x, gates=None, generator=None):
        y = _dropout(F.gelu(self.intermediate_dense(x)), self.spec.intermediate_dropout,
                     generator)
        interm_gate = _gate(gates, "intermediate")
        if interm_gate is not None:
            y = y * interm_gate.to(y.dtype)
        y = _dropout(self.output_dense(y), self.spec.output_dropout, generator)
        layer_gate = _gate(gates, "layer")
        if layer_gate is not None:
            y = y * layer_gate.to(y.dtype)
        return y


class EncoderLayer(nn.Module):
    """Pre- or post-norm residual block; either sublayer may be pruned away.
    Both LayerNorms exist, and in the post-norm path both apply even when a
    sublayer is missing."""

    def __init__(self, spec: EncoderLayerSpec):
        super().__init__()
        self.layer_norm_first = spec.layer_norm_first
        self.dropout = spec.dropout
        self.attention = SelfAttention(spec.attention) if spec.attention else None
        self.layer_norm = Norm(spec.embed_dim)
        self.feed_forward = FeedForward(spec.feed_forward) if spec.feed_forward else None
        self.final_layer_norm = Norm(spec.embed_dim)

    def forward(self, x, lengths, gates=None, generator=None):
        att_gates = _gate(gates, "attention")
        ff_gates = _gate(gates, "feed_forward")
        if self.attention is not None:
            residual = x
            if self.layer_norm_first:
                x = self.layer_norm(x)
            x = self.attention(x, lengths, att_gates, generator)
            x = residual + _dropout(x, self.dropout, generator)
        if self.layer_norm_first:
            if self.feed_forward is not None:
                x = x + self.feed_forward(self.final_layer_norm(x), ff_gates, generator)
        else:
            x = self.layer_norm(x)
            if self.feed_forward is not None:
                x = x + self.feed_forward(x, ff_gates, generator)
            x = self.final_layer_norm(x)
        return x


class Transformer(nn.Module):
    def __init__(self, spec: ModelSpec):
        super().__init__()
        self.layer_norm_first = spec.transformer_layer_norm_first
        self.dropout = spec.dropout
        self.pos_conv_embed = ConvolutionalPositionalEmbedding(
            spec.embed_dim, spec.pos_conv_kernel, spec.pos_conv_groups
        )
        self.layer_norm = Norm(spec.embed_dim)
        self.layers = nn.ModuleList(EncoderLayer(l) for l in spec.layers)

    def _preprocess(self, x, generator=None):
        x = x + self.pos_conv_embed(x)
        if self.layer_norm_first:
            x = self.layer_norm(x)
        return _dropout(x, self.dropout, generator)

    def get_intermediate_outputs(self, x, lengths, num_layers: Optional[int] = None,
                                 gates=None, generator=None):
        """Every layer's hidden state (no final LayerNorm), never applying
        LayerDrop: distillation sees all layers, as in the TPU package."""
        x = self._preprocess(x, generator)
        outs: List[torch.Tensor] = []
        for i, layer in enumerate(self.layers):
            x = layer(x, lengths, _gate(gates, "layers", str(i)), generator)
            outs.append(x)
            if num_layers is not None and len(outs) >= num_layers:
                break
        return outs

    def forward(self, x, lengths):
        x = self._preprocess(x)
        for layer in self.layers:
            x = layer(x, lengths)
        if not self.layer_norm_first:
            x = self.layer_norm(x)
        return x


class Encoder(nn.Module):
    def __init__(self, spec: ModelSpec):
        super().__init__()
        self.feature_projection = FeatureProjection(
            spec.encoder_in_features, spec.embed_dim, spec.projection_dropout
        )
        self.transformer = Transformer(spec)

    def _preprocess(self, features, lengths, generator=None
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Projection; padded frames zeroed; int32 lengths for the kernels'
        key mask (the place of the additive -10000 mask)."""
        x = self.feature_projection(features, generator)
        if lengths is None:
            return x, None
        L = x.shape[1]
        pad = torch.arange(L, device=x.device)[None, :] >= lengths[:, None]
        x = x.masked_fill(pad[:, :, None], 0.0)
        return x, lengths.to(torch.int32)

    def extract_features(self, features, lengths, num_layers: Optional[int] = None,
                         gates=None, generator=None):
        """``[projected input] + per-layer outputs``."""
        x, lengths = self._preprocess(features, lengths, generator)
        return [x] + self.transformer.get_intermediate_outputs(
            x, lengths, num_layers, gates, generator
        )

    def forward(self, features, lengths):
        x, lengths = self._preprocess(features, lengths)
        return self.transformer(x, lengths)


# ---------------------------------------------------------------------------
# Waveform normalisation
# ---------------------------------------------------------------------------


def normalize_waveform(wave, lengths):
    """Per-utterance LayerNorm over the valid samples only (Large family)."""
    if lengths is None:
        return _layer_norm(wave, None, None, dim=-1)
    T = wave.shape[1]
    valid = (torch.arange(T, device=wave.device)[None, :] < lengths[:, None]).float()
    w32 = wave.float() * valid
    n = lengths.float().clamp_min(1.0)[:, None]
    mean = w32.sum(dim=1, keepdim=True) / n
    centered = (w32 - mean) * valid
    var = centered.square().sum(dim=1, keepdim=True) / n
    normed = centered * torch.rsqrt(var + LN_EPS)
    return (normed * valid).to(wave.dtype)
