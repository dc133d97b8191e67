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
    kernel's plain version on the CPU (see ``attention_route``); WavLM's
    attention keeps its gated relative-position bias factored, as a (H, L,
    L) table and a (B, H, L) gate, through ``ops/wavlm_attention.py``.

Training (the distill step) passes a ``torch.Generator`` for dropout and a
nested dict of HardConcrete gates, keyed as the TPU package's gate tree
(``models/gates.py``); both are applied where the TPU package applies them.
With no generator there is no dropout, and with no gates none is applied,
as in the TPU package's eval path.  ``remat`` checkpoints each encoder
layer (``remat_layer``), as the TPU package checkpoints each layer, also
inside a captured CUDA graph (``RematReplay``).  LayerDrop acts in the
training forward only (``Transformer.forward``); distillation
(``get_intermediate_outputs``) sees every layer.

Parallel training (``parallel/sharding.py``) gives the modules that draw
dropout a ``Shard``: this rank's block of the global batch's rows, and, on
a (data x model) mesh, whether a layer's heads (``SelfAttention``) or
intermediate units (``FeedForward``) are split over the model group.  A
split layer runs its own heads through the same kernels with
``num_heads`` = its share, takes its slice of the replicated head or
intermediate gate after Megatron's *f* (``parallel/comm.py``), and sums
the partial output projection with *g*, the bias added after; a split
WavLM layer also takes its heads' rows of the position bias (*f* once, on
the bias layer 0 computes) and of the GRU gate (*f* on the gate).  Every
random number is the one-process run's: the kernels' dropout seed is
folded by the rank's batch and head offsets
(``ops/attention_common.fold_dropout_seed``), and an activation's dropout
mask is drawn at the global tensor's shape and this rank's block taken.
Every parameter is read through ``comm.full``, which gathers a parameter
that FSDP splits over the data group (``parallel/fsdp.py``) and passes a
whole one as it is.
"""

from __future__ import annotations

import contextlib
import functools
import math
import threading
from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ..configs import (
    AttentionSpec,
    ConvLayerSpec,
    EncoderLayerSpec,
    FeedForwardSpec,
    ModelSpec,
)
from ..ops import RematLayerCount
from ..ops.attention_common import fold_dropout_seed
from ..ops.flash_attention import flash_attention_qkv
from ..ops.packed_attention import packed_attention_qkv, packed_num_groups
from ..ops.pos_conv import PosConvFn
from ..ops.wavlm_attention import wavlm_attention_qkv
from ..parallel.comm import copy_to_model, full, reduce_from_model

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


@dataclass(frozen=True)
class Shard:
    """Where this rank's part of a sharded activation lies: rows
    ``data_rank`` of ``n_data`` equal blocks of the global batch, and the
    model group (``model_rank`` of ``n_model``) over which split layers
    divide their heads or intermediate units."""

    data_rank: int = 0
    n_data: int = 1
    model_rank: int = 0
    n_model: int = 1
    group: Any = None

    def __deepcopy__(self, memo):
        return self  # holds a process group, a handle


def _dropout(x, rate: float, generator: Optional[torch.Generator],
             shard: Optional[Shard] = None, cols: Optional[Tuple[int, int]] = None):
    """Inverted dropout drawn from ``generator`` (on x's device); the
    identity when there is no generator (eval) or the rate is 0.

    On a sharded activation (``shard`` with more than one data rank, or
    ``cols``: (offset, full width) of a split last dimension) the uniform
    draws of the global tensor are made and this rank's block of them
    taken: every layout then drops exactly the one-process run's units,
    and the generators of all ranks stay in step."""
    if generator is None or rate <= 0.0:
        return x
    keep = 1.0 - rate
    if shard is None or (shard.n_data == 1 and cols is None):
        u = torch.rand(x.shape, generator=generator, device=x.device)
    else:
        B = x.shape[0]
        width = x.shape[-1] if cols is None else cols[1]
        u = torch.rand((B * shard.n_data,) + tuple(x.shape[1:-1]) + (width,),
                       generator=generator, device=x.device)
        u = u[shard.data_rank * B:(shard.data_rank + 1) * B]
        if cols is not None:
            u = u[..., cols[0]:cols[0] + x.shape[-1]]
    return torch.where(u < keep, x / keep, torch.zeros_like(x))


def _model_slice(gate: torch.Tensor, shard: Shard, offset: int, n: int) -> torch.Tensor:
    """A split layer's slice of a replicated gate, after *f*: the gate's
    gradient then sums every model rank's slice (the sparsity term reads
    the whole gate on every rank and so counts once)."""
    return copy_to_model(gate, shard.group)[offset:offset + n]


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
        return _layer_norm(x, full(self.weight), full(self.bias))


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
        b = None if self.bias is None else full(self.bias).to(x.dtype)
        return F.linear(x, full(self.weight).to(x.dtype), b)


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
        bias = None if self.conv.bias is None else full(self.conv.bias).to(x.dtype)
        y = F.conv1d(x, full(self.conv.weight).to(x.dtype), bias, stride=spec.stride)
        if spec.norm is not None:
            norm_w, norm_b = full(self.layer_norm.weight), full(self.layer_norm.bias)
        if spec.norm == "group_norm":
            # GroupNorm(C, C): per-channel statistics over all T, padding
            # included, so the padded length changes the valid frames
            y = _layer_norm(y, norm_w, norm_b, dim=2, affine_dim=1)
        elif spec.norm == "layer_norm":
            # transposed LayerNorm: over the channels at every frame
            y = _layer_norm(y, norm_w, norm_b, dim=1)
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
        return x * full(self.dummy_weight).to(x.dtype), lengths


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

    shard: Optional[Shard] = None

    def __init__(self, in_features: int, out_features: int, dropout: float):
        super().__init__()
        self.dropout = dropout
        self.layer_norm = Norm(in_features)
        self.projection = Linear(in_features, out_features)

    def forward(self, x, generator=None):
        return _dropout(self.projection(self.layer_norm(x)), self.dropout, generator,
                        self.shard)


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
        g = full(self.weight_g).float()
        v = full(self.weight_v).float()
        norm = v.square().sum(dim=(0, 1), keepdim=True).sqrt()
        return (v * (g / norm)).to(dtype)


class ConvolutionalPositionalEmbedding(nn.Module):
    """Weight-normed grouped conv, padding K//2, even kernels drop the last
    frame (``ops.pos_conv``: its input gradient a forward conv), then GELU.
    x: (B, L, E)."""

    def __init__(self, embed_dim: int, kernel_size: int, groups: int):
        super().__init__()
        self.groups = groups
        self.conv = WeightNormConv(embed_dim, kernel_size, groups)

    def forward(self, x):
        y = PosConvFn.apply(x.transpose(1, 2), self.conv.weight(x.dtype),
                            full(self.conv.bias).to(x.dtype), self.groups)
        return F.gelu(y).transpose(1, 2)


def attention_route(L: int, num_heads: int, head_dim: int) -> str:
    """Which attention kernel a layer without a position bias takes: the
    TPU package's dispatch (``packed`` when its packed kernel could run the
    shape, else ``flash``).  On a CPU tensor the chosen kernel's wrapper runs
    its plain version.  A WavLM layer with the bias takes the ``wavlm``
    kernels (``ops/wavlm_attention.py``)."""
    return "packed" if packed_num_groups(L, num_heads, head_dim) > 0 else "flash"


# ---------------------------------------------------------------------------
# WavLM relative position bias
# ---------------------------------------------------------------------------


def _relative_positions_bucket_np(
    seq_len: int, num_buckets: int, max_distance: int
) -> np.ndarray:
    """Bucketed relative positions, computed host-side (static given L).

    Bidirectional bucketing per WavLM eq. (5) (reference
    ``components.py:563-600``): half the buckets for each sign, half of those
    exact, the rest log-spaced out to ``max_distance``.  A copy of the TPU
    package's function, float32 log included, so the buckets agree bit for
    bit.
    """
    context = np.arange(seq_len, dtype=np.int64)[:, None]
    memory = np.arange(seq_len, dtype=np.int64)[None, :]
    relative = memory - context  # (L, L)

    nb = num_buckets // 2
    buckets = (relative > 0).astype(np.int64) * nb
    rel_abs = np.abs(relative)

    max_exact = nb // 2
    is_small = rel_abs < max_exact
    # log-spaced buckets for distant positions
    rel_if_large = max_exact + (
        np.log(np.maximum(rel_abs, 1).astype(np.float32) / max_exact)
        / math.log(max_distance / max_exact)
        * (nb - max_exact)
    ).astype(np.int64)
    rel_if_large = np.minimum(rel_if_large, nb - 1)
    buckets += np.where(is_small, rel_abs, rel_if_large)
    return buckets.astype(np.int32)


@functools.lru_cache(maxsize=16)
def _bucket_index(seq_len: int, num_buckets: int, max_distance: int, device: str):
    """The (L, L) bucket ids as an int64 tensor on ``device``, kept across
    steps (the same L recurs every step of a static-shape loader)."""
    buckets = _relative_positions_bucket_np(seq_len, num_buckets, max_distance)
    return torch.from_numpy(buckets.astype(np.int64)).to(device)


def compute_wavlm_bias(table: torch.Tensor, spec: AttentionSpec, seq_len: int) -> torch.Tensor:
    """(total_num_heads, L, L) relative position bias in the table's dtype
    (fp32), contiguous: the bucket gather of the (num_buckets,
    total_num_heads) embedding table.  Its gradient, the sum of every
    layer's bias gradient into the table's rows, is PyTorch's embedding
    backward."""
    index = _bucket_index(seq_len, spec.num_buckets, spec.max_distance, str(table.device))
    return F.embedding(index, table).permute(2, 0, 1).contiguous()


class Embedding(nn.Module):
    """An (n, dim) table with ``weight``, N(0, 1) at init (the default of
    torch's nn.Embedding)."""

    def __init__(self, n: int, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n, dim))

    def reset_parameters(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.normal_(0.0, 1.0, generator=gen)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


class SelfAttention(nn.Module):
    """Multi-head self-attention with decoupled inner width H*D.

    ``heads`` of the layer's heads run here, from ``head_offset`` on: all of
    them, or this model rank's share where ``set_shard`` splits them."""

    shard: Optional[Shard] = None
    split = False  # heads split over the model group

    def __init__(self, spec: AttentionSpec):
        super().__init__()
        self.spec = spec
        self.heads, self.head_offset = spec.num_heads, 0
        inner = spec.num_heads * spec.head_dim
        self.k_proj = Linear(spec.embed_dim, inner)
        self.v_proj = Linear(spec.embed_dim, inner)
        self.q_proj = Linear(spec.embed_dim, inner)
        self.out_proj = Linear(inner, spec.embed_dim)
        if spec.prune_heads:
            self.hard_concrete_for_heads = HardConcrete(spec.num_heads, 0.01)
        if spec.prune_layer:
            self.hard_concrete_for_layer = HardConcrete(1, 0.01)

    def set_shard(self, shard: Shard, split: bool) -> None:
        """Take this rank's rows (``shard``), and with ``split`` its
        ``num_heads / n_model`` heads (the parameters are narrowed by
        ``parallel/sharding.py``)."""
        self.shard, self.split = shard, split
        H = self.spec.num_heads
        self.heads = H // shard.n_model if split else H
        self.head_offset = shard.model_rank * self.heads if split else 0

    def _qkv(self, x):
        """One fused (B*L, E) @ (E, 3*H*D) product; q, k, v stay views of
        it."""
        projs = (self.q_proj, self.k_proj, self.v_proj)
        w = torch.cat([full(p.weight) for p in projs])
        b = torch.cat([full(p.bias) for p in projs])
        return F.linear(x, w.to(x.dtype), b.to(x.dtype))

    def _dropout_seed(self, x, generator):
        """(rate, seed): with dropout, one int32 on the device that the
        kernels read there; on a shard, folded by its first row and head in
        the one-process batch (``fold_dropout_seed``)."""
        rate = self.spec.dropout if generator is not None else 0.0
        seed = None
        if rate > 0.0:
            seed = torch.randint(-2**31, 2**31, (1,), generator=generator,
                                 device=x.device).to(torch.int32)
            if self.shard is not None:
                seed = fold_dropout_seed(seed, self.shard.data_rank * x.shape[0],
                                         self.head_offset)
        return rate, seed

    def _output(self, out, gates):
        """Head gates, the output projection and the layer gate."""
        B, L, _ = out.shape
        H, D = self.heads, self.spec.head_dim
        head_gate = _gate(gates, "heads")
        if head_gate is not None:
            if self.split:
                head_gate = _model_slice(head_gate, self.shard, self.head_offset, H)
            out = (out.view(B, L, H, D) * head_gate.to(out.dtype)[:, None]).view(B, L, H * D)
        if self.split:
            partial = F.linear(out, full(self.out_proj.weight).to(out.dtype))
            out = (reduce_from_model(partial, self.shard.group)
                   + full(self.out_proj.bias).to(out.dtype))
        else:
            out = self.out_proj(out)
        layer_gate = _gate(gates, "layer")
        if layer_gate is not None:
            out = out * layer_gate.to(out.dtype)
        return out

    def forward(self, x, lengths, gates=None, generator=None):
        """x: (B, L, E); lengths: int32 (B,) valid frames or None; gates:
        ``{"heads": (H,), "layer": (1,)}`` entries or None; ``generator``
        turns attention-probability dropout on (in the kernel)."""
        L = x.shape[1]
        H, D = self.heads, self.spec.head_dim
        if self.split:
            x = copy_to_model(x, self.shard.group)
        qkv = self._qkv(x)
        rate, seed = self._dropout_seed(x, generator)
        attend = (packed_attention_qkv if attention_route(L, H, D) == "packed"
                  else flash_attention_qkv)
        out = attend(qkv, lengths, num_heads=H, scale=D ** -0.5, dropout_rate=rate, seed=seed)
        return self._output(out, gates)


class WavLMSelfAttention(SelfAttention):
    """WavLM's self-attention: the attention of ``SelfAttention`` with a
    relative-position bias in the scores, gated per query row by a GRU-style
    gate of the layer's input (reference ``components.py:486-693``).

    Layer 0 holds the (num_buckets, total_num_heads) table
    ``rel_attn_embed`` and computes the (total_num_heads, L, L) bias, which
    every later layer receives; each layer holds ``gru_rel_pos_linear``
    (embed/total_num_heads -> 8) and ``gru_rel_pos_const`` (1, TH, 1, 1).
    A pruned layer keeps the bias and gate rows of its ``remaining_heads``;
    a layer split over the model group keeps the rows of its share of
    those heads.  Without a bias (layer 0's attention pruned away) the layer
    is plain attention.

    The bias passes from layer to layer as a pair: the tensor, and the same
    tensor after Megatron's *f* over the model group, which the split layers
    slice.  The *f* is put on once, where layer 0 computes the bias, so a
    step all-reduces the bias's gradient over the model group once and not
    in every layer; a layer that stays whole reads the first, whose
    gradient is already whole on every rank.  The gate is computed whole
    on every rank from the layer's input and sliced after its own *f*, so
    the table's and the GRU's gradients sum every model rank's heads."""

    _split_rows: Optional[torch.Tensor] = None  # a split layer's bias and gate rows

    def __init__(self, spec: AttentionSpec):
        super().__init__(spec)
        TH = spec.total_num_heads
        if spec.has_relative_attention_bias:
            self.rel_attn_embed = Embedding(spec.num_buckets, TH)
        if spec.gru_rel_pos:
            self.gru_rel_pos_linear = Linear(spec.embed_dim // TH, 8)
            self.gru_rel_pos_const = nn.Parameter(torch.empty(1, TH, 1, 1))
        # the selected heads' rows of the bias and gate (None: all of them)
        keep = spec.remaining_heads
        if keep is not None and len(keep) != TH:
            self.register_buffer("_keep_heads", torch.tensor(keep, dtype=torch.int64),
                                 persistent=False)
        else:
            self._keep_heads = None

    def reset_parameters(self, gen: torch.Generator) -> None:
        if self.spec.gru_rel_pos:
            with torch.no_grad():
                self.gru_rel_pos_const.fill_(1.0)

    def set_shard(self, shard: Shard, split: bool) -> None:
        """As ``SelfAttention.set_shard``; a split layer's bias and gate rows
        are its heads': the kept heads (``remaining_heads``) first, then
        this rank's share of them."""
        super().set_shard(shard, split)
        self._split_rows = None
        if split:
            rows = (self._keep_heads.tolist() if self._keep_heads is not None
                    else list(range(self.spec.total_num_heads)))
            self._split_rows = torch.tensor(rows[self.head_offset:self.head_offset + self.heads],
                                            dtype=torch.int64, device=self.q_proj.weight.device)

    def _gate_a_1(self, x):
        """(B, TH, L) fp32 gate from the pre-projection input, split into
        TH chunks: sigmoid of the 8 outputs summed in pairs of four, then
        gate_a * (gate_b * const - 1) + 2 (``components.py:461-473`` of the
        TPU package)."""
        B, L, E = x.shape
        TH = self.spec.total_num_heads
        query = x.reshape(B, L, TH, E // TH).transpose(1, 2)
        raw = self.gru_rel_pos_linear(query)  # (B, TH, L, 8) in x's dtype
        g = torch.sigmoid(raw.reshape(B, TH, L, 2, 4).sum(-1).float())
        const = full(self.gru_rel_pos_const).float().view(1, TH, 1)
        return g[..., 0] * (g[..., 1] * const - 1.0) + 2.0

    def forward(self, x, lengths, position_bias=None, gates=None, generator=None):
        """As ``SelfAttention.forward``, with the position bias pair of an
        earlier layer (None in layer 0, which computes it) -> (output,
        position bias pair)."""
        spec = self.spec
        B, L, _ = x.shape
        if spec.has_relative_attention_bias and position_bias is None:
            bias = compute_wavlm_bias(full(self.rel_attn_embed.weight), spec, L)
            model = self.shard is not None and self.shard.n_model > 1
            position_bias = (bias, copy_to_model(bias, self.shard.group) if model else bias)
        if position_bias is None:
            return super().forward(x, lengths, gates, generator), None
        if spec.gru_rel_pos:
            gate = self._gate_a_1(x)
        else:
            gate = torch.ones((B, spec.total_num_heads, L), device=x.device)
        if self.split:
            rows = self._split_rows
            bias = position_bias[1][rows]
            gate = copy_to_model(gate, self.shard.group)[:, rows]
            x = copy_to_model(x, self.shard.group)
        else:
            bias = position_bias[0]
            if self._keep_heads is not None:
                bias, gate = bias[self._keep_heads], gate[:, self._keep_heads]
        H, D = self.heads, spec.head_dim
        qkv = self._qkv(x)
        rate, seed = self._dropout_seed(x, generator)
        out = wavlm_attention_qkv(qkv, bias, gate, lengths, num_heads=H, scale=D ** -0.5,
                                  dropout_rate=rate, seed=seed)
        return self._output(out, gates), position_bias


class FeedForward(nn.Module):
    """Linear -> GELU -> Dropout -> [intermediate gate] -> Linear -> Dropout
    -> [layer gate].  ``units`` intermediate units run here, from
    ``unit_offset`` on (a model rank's share where ``set_shard`` splits
    them)."""

    shard: Optional[Shard] = None
    split = False  # intermediate units split over the model group

    def __init__(self, spec: FeedForwardSpec):
        super().__init__()
        self.spec = spec
        self.units, self.unit_offset = spec.intermediate_features, 0
        self.intermediate_dense = Linear(spec.io_features, spec.intermediate_features)
        self.output_dense = Linear(spec.intermediate_features, spec.io_features)
        if spec.prune_intermediate:
            self.hard_concrete_for_intermediate = HardConcrete(
                spec.intermediate_features, 0.5
            )
        if spec.prune_layer:
            self.hard_concrete_for_layer = HardConcrete(1, 0.01)

    def set_shard(self, shard: Shard, split: bool) -> None:
        self.shard, self.split = shard, split
        n = self.spec.intermediate_features
        self.units = n // shard.n_model if split else n
        self.unit_offset = shard.model_rank * self.units if split else 0

    def forward(self, x, gates=None, generator=None):
        sh = self.shard
        cols = None
        if self.split:
            x = copy_to_model(x, sh.group)
            cols = (self.unit_offset, self.spec.intermediate_features)
        y = _dropout(F.gelu(self.intermediate_dense(x)), self.spec.intermediate_dropout,
                     generator, sh, cols)
        interm_gate = _gate(gates, "intermediate")
        if interm_gate is not None:
            if self.split:
                interm_gate = _model_slice(interm_gate, sh, self.unit_offset, self.units)
            y = y * interm_gate.to(y.dtype)
        if self.split:
            partial = F.linear(y, full(self.output_dense.weight).to(y.dtype))
            y = (reduce_from_model(partial, sh.group)
                 + full(self.output_dense.bias).to(y.dtype))
        else:
            y = self.output_dense(y)
        y = _dropout(y, self.spec.output_dropout, generator, sh)
        layer_gate = _gate(gates, "layer")
        if layer_gate is not None:
            y = y * layer_gate.to(y.dtype)
        return y


class EncoderLayer(nn.Module):
    """Pre- or post-norm residual block; either sublayer may be pruned away.
    Both LayerNorms exist, and in the post-norm path both apply even when a
    sublayer is missing."""

    shard: Optional[Shard] = None

    def __init__(self, spec: EncoderLayerSpec):
        super().__init__()
        self.layer_norm_first = spec.layer_norm_first
        self.dropout = spec.dropout
        self.attention = None
        if spec.attention is not None:
            self.attention = (WavLMSelfAttention(spec.attention) if spec.attention.is_wavlm
                              else SelfAttention(spec.attention))
        self.layer_norm = Norm(spec.embed_dim)
        self.feed_forward = FeedForward(spec.feed_forward) if spec.feed_forward else None
        self.final_layer_norm = Norm(spec.embed_dim)

    def forward(self, x, lengths, gates=None, generator=None, position_bias=None):
        """-> (output, position_bias): WavLM's bias pair passes through every
        layer (computed in layer 0, ``WavLMSelfAttention``); None for
        wav2vec 2.0 / HuBERT."""
        att_gates = _gate(gates, "attention")
        ff_gates = _gate(gates, "feed_forward")
        if self.attention is not None:
            residual = x
            if self.layer_norm_first:
                x = self.layer_norm(x)
            if isinstance(self.attention, WavLMSelfAttention):
                x, position_bias = self.attention(x, lengths, position_bias, att_gates,
                                                  generator)
            else:
                x = self.attention(x, lengths, att_gates, generator)
            x = residual + _dropout(x, self.dropout, generator, self.shard)
        if self.layer_norm_first:
            if self.feed_forward is not None:
                x = x + self.feed_forward(self.final_layer_norm(x), ff_gates, generator)
        else:
            x = self.layer_norm(x)
            if self.feed_forward is not None:
                x = x + self.feed_forward(x, ff_gates, generator)
            x = self.final_layer_norm(x)
        return x, position_bias


class RematReplay:
    """What ``remat_layer`` needs to run inside a CUDA graph capture, for
    one captured group of steps (``GraphedSteps``).

    A checkpointed layer's recompute must draw the numbers its forward
    drew; eagerly, ``remat_layer`` sets the generator's state back on the
    host, which a capture cannot do (the state is read at each replay, on
    the card).  So the recompute draws from a generator of its own instead:
    * in the key's eager group (``record``), the step generator's offset at
      each checkpointed layer's forward, from the group's start
      (``offsets``; eager and captured steps advance the offset alike);
    * before the capture (``register``), one generator for each of them,
      registered with the graph; inside the capture each layer's recompute
      draws from its own (``take``), swapped in with
      ``graphsafe_set_state`` and swapped out again after;
    * before each replay (``prepare``), each of them takes the step
      generator's seed and its offset plus the layer's ``offsets`` entry:
      on the card the recompute then starts where the forward's draws
      started, and the step generator moves as in eager steps."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator
        self.start = generator.get_offset()
        self.offsets: List[int] = []
        self.states: Optional[List[torch.Generator]] = None
        self.taken = 0

    def record(self) -> None:
        self.offsets.append(self.generator.get_offset() - self.start)

    def register(self, graph) -> None:
        self.states = [torch.Generator(device=self.generator.device) for _ in self.offsets]
        for g in self.states:
            graph.register_generator_state(g)

    def take(self) -> torch.Generator:
        if self.states is None or self.taken == len(self.states):
            raise RuntimeError(
                f"the capture checkpointed more layers than its eager group recorded "
                f"({len(self.offsets)})")
        self.taken += 1
        return self.states[self.taken - 1]

    def prepare(self) -> None:
        state, base = self.generator.get_state(), self.generator.get_offset()
        for g, offset in zip(self.states, self.offsets):
            g.set_state(state)
            g.set_offset(base + offset)


_remat = threading.local()  # .replay: the RematReplay of the group being run


@contextlib.contextmanager
def remat_replay(replay: Optional[RematReplay]):
    """Give ``replay`` to every ``remat_layer`` call of the block (on this
    thread): recorded in an eager group, taken from in a capture."""
    prev = getattr(_remat, "replay", None)
    _remat.replay = replay
    try:
        yield
    finally:
        _remat.replay = prev


def remat_layer(layer: EncoderLayer, x, lengths, gates, generator, position_bias):
    """``layer(x, lengths, gates, generator, position_bias)`` under
    per-layer activation checkpointing (the TPU package's checkpoint
    around each layer): the layer's activations are dropped after the
    forward and recomputed in the backward.

    Non-reentrant checkpointing, so the gradient still reaches tensors the
    layer reads from outside its arguments (the gates, which depend on
    ``log_alpha``).  The layer draws its dropout masks and its attention
    kernels' seeds from ``generator``, an explicit generator that
    ``checkpoint`` does not replay; so its state is taken before the
    forward, set again for the recompute, and the state the backward found
    is put back afterwards (also when the recompute stops early): the
    recompute draws exactly the forward's numbers, and the generator ends
    the step where a step without remat leaves it.  Inside a CUDA graph
    capture the recompute draws from its own generator of the group's
    ``RematReplay`` instead (``remat_replay``), which each replay sets to
    the same numbers.  Each recompute counts one in
    ``ops.RematLayerCount.launches`` (a capture's once, its replays not).
    WavLM's position bias is an output of layer 0's checkpointed call and
    an input of every later one, so every layer's bias gradient still
    flows into layer 0's table."""
    replay = getattr(_remat, "replay", None)
    capturing = (generator is not None and generator.device.type == "cuda"
                 and torch.cuda.is_current_stream_capturing())
    if capturing:
        if replay is None:
            raise RuntimeError("remat inside a CUDA graph capture needs the group's "
                               "RematReplay (remat_replay; GraphedSteps gives it)")
        get, put = generator.graphsafe_get_state, generator.graphsafe_set_state
        state = replay.take()
    elif generator is not None:
        if replay is not None and generator is replay.generator:
            replay.record()
        get, put = generator.get_state, generator.set_state
        state = get()
    else:
        state = None
    calls = [0]

    def run(x, position_bias):
        calls[0] += 1
        if calls[0] > 1:
            RematLayerCount.launches += 1
        if state is None or calls[0] == 1:
            return layer(x, lengths, gates, generator, position_bias)
        found = get()
        put(state)
        try:
            return layer(x, lengths, gates, generator, position_bias)
        finally:
            put(found)

    # every random number of the layer comes from ``generator``
    return torch.utils.checkpoint.checkpoint(run, x, position_bias, use_reentrant=False,
                                             preserve_rng_state=False)


class Transformer(nn.Module):
    shard: Optional[Shard] = None

    def __init__(self, spec: ModelSpec):
        super().__init__()
        self.layer_norm_first = spec.transformer_layer_norm_first
        self.dropout = spec.dropout
        self.layer_drop = spec.layer_drop
        self.pos_conv_embed = ConvolutionalPositionalEmbedding(
            spec.embed_dim, spec.pos_conv_kernel, spec.pos_conv_groups
        )
        self.layer_norm = Norm(spec.embed_dim)
        self.layers = nn.ModuleList(EncoderLayer(l) for l in spec.layers)

    def _preprocess(self, x, generator=None):
        x = x + self.pos_conv_embed(x)
        if self.layer_norm_first:
            x = self.layer_norm(x)
        return _dropout(x, self.dropout, generator, self.shard)

    def get_intermediate_outputs(self, x, lengths, num_layers: Optional[int] = None,
                                 gates=None, generator=None, remat: bool = False):
        """Every layer's hidden state (no final LayerNorm), never applying
        LayerDrop: distillation sees all layers, as in the TPU package.
        WavLM's position bias, computed in layer 0, is threaded through, so
        every layer's bias gradient flows back into layer 0's table.
        ``remat`` checkpoints each layer (``remat_layer``)."""
        x = self._preprocess(x, generator)
        outs: List[torch.Tensor] = []
        position_bias = None
        for i, layer in enumerate(self.layers):
            args = (x, lengths, _gate(gates, "layers", str(i)), generator, position_bias)
            x, position_bias = remat_layer(layer, *args) if remat else layer(*args)
            outs.append(x)
            if num_layers is not None and len(outs) >= num_layers:
                break
        return outs

    def forward(self, x, lengths, gates=None, generator=None, layer_drop_u=None):
        """The final hidden state (after the final LayerNorm in the post-norm
        layout), with LayerDrop in training: with a ``generator`` and
        ``layer_drop`` > 0, layer i's output is kept where its uniform
        ``u[i] > layer_drop`` and its input passes on otherwise (the TPU
        package's ``transformer_forward``).  Every layer is computed, so the
        forward has no branch on ``u`` and no host sync: a dropped layer's
        output is its input bit for bit, and WavLM's position bias is taken
        from the computed layer either way.  ``u`` is drawn on the device
        from ``generator``, one a layer, or injected as ``layer_drop_u``
        (``(num_layers,)``; as ``hardconcrete.sample_mask`` takes ``u``)."""
        x = self._preprocess(x, generator)
        n = len(self.layers)
        drop = generator is not None and self.layer_drop > 0.0
        if drop and layer_drop_u is None:
            layer_drop_u = torch.rand((n,), generator=generator, device=x.device)
        elif drop:
            layer_drop_u = torch.as_tensor(layer_drop_u, dtype=torch.float32).to(x.device)
            if tuple(layer_drop_u.shape) != (n,):
                raise ValueError(f"layer_drop_u must have shape ({n},), got "
                                 f"{tuple(layer_drop_u.shape)}")
        position_bias = None
        for i, layer in enumerate(self.layers):
            y, position_bias = layer(x, lengths, _gate(gates, "layers", str(i)), generator,
                                     position_bias)
            x = torch.where(layer_drop_u[i] > self.layer_drop, y, x) if drop else y
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
                         gates=None, generator=None, remat: bool = False):
        """``[projected input] + per-layer outputs``."""
        x, lengths = self._preprocess(features, lengths, generator)
        return [x] + self.transformer.get_intermediate_outputs(
            x, lengths, num_layers, gates, generator, remat
        )

    def forward(self, features, lengths, gates=None, generator=None, layer_drop_u=None):
        """The final hidden state; LayerDrop as ``Transformer.forward``."""
        x, lengths = self._preprocess(features, lengths, generator)
        return self.transformer(x, lengths, gates, generator, layer_drop_u)


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
