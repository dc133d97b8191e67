"""Plain PyTorch reference of wav2vec 2.0 / HuBERT / WavLM with the
DPHuBERT gates: the forward pass written out from the published equations
in float32, with no kernel, cache or batching of the program under test.

It reads the portable configuration dict (the 24-key HuBERT layout, the
27-key WavLM one, with the five prune flags) and a flat parameter dict under
the portable state-dict keys (``feature_extractor.conv_layers.0.conv.weight``
and so on), which this module also lays out and fills from a generator
(``param_shapes``, ``make_params``).  Nothing here imports the program.

Randomness of a training forward comes from ``Draws``: the uniform draws of
every activation dropout, the 32-bit seed of every attention dropout (whose
mask is the counter hash of ``dropout.py``) and the HardConcrete uniforms,
each drawn from one ``torch.Generator`` in the order of the recipe's step.

``Precision`` rounds the operands of every product (linear, conv and the
attention matmuls); ``FP32`` is the identity, ``FP8`` the control that
computes in the nearest precision below the configuration's bf16.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .dropout import keep_mask

LN_EPS = 1e-5
CONV_DEFAULT = ((512, 10, 5), (512, 3, 2), (512, 3, 2), (512, 3, 2), (512, 3, 2),
                (512, 2, 2), (512, 2, 2))
PRUNE_KEYS = ("extractor_prune_conv_channels", "encoder_prune_attention_heads",
              "encoder_prune_attention_layer", "encoder_prune_feed_forward_intermediate",
              "encoder_prune_feed_forward_layer")
HC_INIT = {"conv": 0.01, "heads": 0.01, "att_layer": 0.01, "interm": 0.5, "ff_layer": 0.01}


# ---------------------------------------------------------------------------
# Configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Layer:
    heads: int            # attention heads kept (0: no attention sublayer)
    head_ids: Tuple[int, ...]  # WavLM: the kept heads' rows of bias and gate
    ffn: int              # FFN width (0: no FFN sublayer)


@dataclass(frozen=True)
class Arch:
    conv: Tuple[Tuple[int, int, int], ...]
    conv_bias: bool
    group_norm: bool      # extractor_mode: GroupNorm in conv 0 only
    embed: int
    head_dim: int
    layers: Tuple[Layer, ...]
    post_norm: bool       # encoder_layer_norm_first False
    pos_kernel: int
    pos_groups: int
    wavlm: bool
    total_heads: int
    buckets: int
    max_distance: int
    dropout: float        # encoder_dropout (residual, FFN output, pre-transformer)
    proj_dropout: float
    attn_dropout: float
    ffn_dropout: float
    prune: Tuple[bool, ...]  # the five prune flags, in PRUNE_KEYS' order


def _per_layer(v, n):
    return list(v) if isinstance(v, (list, tuple)) else [v] * n


def arch(config: dict) -> Arch:
    """The configuration dict as the reference reads it."""
    n = int(config["encoder_num_layers"])
    use_att = _per_layer(config["encoder_use_attention"], n)
    use_ff = _per_layer(config["encoder_use_feed_forward"], n)
    ffn = _per_layer(config["encoder_ff_interm_features"], n)
    wavlm = "encoder_remaining_heads" in config
    embed = int(config["encoder_embed_dim"])
    if wavlm:
        total = _per_layer(config["encoder_total_num_heads"], n)
        kept = [tuple(int(h) for h in hs) for hs in config["encoder_remaining_heads"]]
        head_dim = embed // int(total[0])
        heads = [len(k) for k in kept]
    else:
        total = [0] * n
        kept = [()] * n
        heads = _per_layer(config["encoder_num_heads"], n)
        head_dim = int(config["encoder_head_dim"])
    layers = tuple(Layer(int(heads[i]) if use_att[i] else 0, kept[i] if use_att[i] else (),
                         int(ffn[i]) if use_ff[i] else 0) for i in range(n))
    conv = config.get("extractor_conv_layer_config") or CONV_DEFAULT
    return Arch(
        conv=tuple(tuple(int(v) for v in c) for c in conv),
        conv_bias=bool(config["extractor_conv_bias"]),
        group_norm=config["extractor_mode"] == "group_norm",
        embed=embed, head_dim=head_dim, layers=layers,
        post_norm=not bool(config["encoder_layer_norm_first"]),
        pos_kernel=int(config["encoder_pos_conv_kernel"]),
        pos_groups=int(config["encoder_pos_conv_groups"]),
        wavlm=wavlm, total_heads=int(total[0]) if wavlm else 0,
        buckets=int(config.get("encoder_num_buckets", 320)),
        max_distance=int(config.get("encoder_max_distance", 800)),
        dropout=float(config["encoder_dropout"]),
        proj_dropout=float(config["encoder_projection_dropout"]),
        attn_dropout=float(config["encoder_attention_dropout"]),
        ffn_dropout=float(config["encoder_ff_interm_dropout"]),
        prune=tuple(bool(config.get(k, False)) for k in PRUNE_KEYS),
    )


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def param_shapes(config: dict) -> List[Tuple[str, Tuple[int, ...], str, float]]:
    """(state-dict key, shape, init kind, init argument) of every parameter,
    in a fixed order.  Kinds: "uniform" (bound 1/sqrt(arg)), "ones",
    "zeros", "normal" (N(0, 1)), "log_alpha" (mean log((1-m)/m) for m = arg,
    spread 0.01), "norm_g" (the weight norm of the preceding weight_v)."""
    a = arch(config)
    conv_gate, heads_gate, att_gate, interm_gate, ff_gate = a.prune
    out = []
    fe = "feature_extractor"
    cin = 1
    for i, (c, k, _) in enumerate(a.conv):
        out.append((f"{fe}.conv_layers.{i}.conv.weight", (c, cin, k), "uniform", cin * k))
        if a.conv_bias:
            out.append((f"{fe}.conv_layers.{i}.conv.bias", (c,), "uniform", cin * k))
        if (a.group_norm and i == 0) or not a.group_norm:
            out.append((f"{fe}.conv_layers.{i}.layer_norm.weight", (c,), "ones", 0))
            out.append((f"{fe}.conv_layers.{i}.layer_norm.bias", (c,), "zeros", 0))
        if conv_gate:
            out.append((f"{fe}.conv_layers.{i}.hard_concrete.log_alpha", (c,), "log_alpha",
                        HC_INIT["conv"]))
        cin = c
    out.append((f"{fe}.dummy_weight", (cin,), "ones", 0))
    e = a.embed
    fp = "encoder.feature_projection"
    out += [(f"{fp}.layer_norm.weight", (cin,), "ones", 0),
            (f"{fp}.layer_norm.bias", (cin,), "zeros", 0),
            (f"{fp}.projection.weight", (e, cin), "uniform", cin),
            (f"{fp}.projection.bias", (e,), "uniform", cin)]
    tr = "encoder.transformer"
    fan = (e // a.pos_groups) * a.pos_kernel
    out += [(f"{tr}.pos_conv_embed.conv.weight_v", (e, e // a.pos_groups, a.pos_kernel),
             "uniform", fan),
            (f"{tr}.pos_conv_embed.conv.weight_g", (1, 1, a.pos_kernel), "norm_g", 0),
            (f"{tr}.pos_conv_embed.conv.bias", (e,), "uniform", fan),
            (f"{tr}.layer_norm.weight", (e,), "ones", 0),
            (f"{tr}.layer_norm.bias", (e,), "zeros", 0)]
    for i, layer in enumerate(a.layers):
        p = f"{tr}.layers.{i}"
        if layer.heads:
            inner = layer.heads * a.head_dim
            for name in ("k_proj", "v_proj", "q_proj"):
                out += [(f"{p}.attention.{name}.weight", (inner, e), "uniform", e),
                        (f"{p}.attention.{name}.bias", (inner,), "uniform", e)]
            out += [(f"{p}.attention.out_proj.weight", (e, inner), "uniform", inner),
                    (f"{p}.attention.out_proj.bias", (e,), "uniform", inner)]
            if heads_gate:
                out.append((f"{p}.attention.hard_concrete_for_heads.log_alpha", (layer.heads,),
                            "log_alpha", HC_INIT["heads"]))
            if att_gate:
                out.append((f"{p}.attention.hard_concrete_for_layer.log_alpha", (1,),
                            "log_alpha", HC_INIT["att_layer"]))
            if a.wavlm:
                th = a.total_heads
                if i == 0:
                    out.append((f"{p}.attention.rel_attn_embed.weight", (a.buckets, th),
                                "normal", 0))
                out += [(f"{p}.attention.gru_rel_pos_linear.weight", (8, e // th), "uniform",
                         e // th),
                        (f"{p}.attention.gru_rel_pos_linear.bias", (8,), "uniform", e // th),
                        (f"{p}.attention.gru_rel_pos_const", (1, th, 1, 1), "ones", 0)]
        out += [(f"{p}.layer_norm.weight", (e,), "ones", 0),
                (f"{p}.layer_norm.bias", (e,), "zeros", 0)]
        if layer.ffn:
            f = layer.ffn
            out += [(f"{p}.feed_forward.intermediate_dense.weight", (f, e), "uniform", e),
                    (f"{p}.feed_forward.intermediate_dense.bias", (f,), "uniform", e),
                    (f"{p}.feed_forward.output_dense.weight", (e, f), "uniform", f),
                    (f"{p}.feed_forward.output_dense.bias", (e,), "uniform", f)]
            if interm_gate:
                out.append((f"{p}.feed_forward.hard_concrete_for_intermediate.log_alpha", (f,),
                            "log_alpha", HC_INIT["interm"]))
            if ff_gate:
                out.append((f"{p}.feed_forward.hard_concrete_for_layer.log_alpha", (1,),
                            "log_alpha", HC_INIT["ff_layer"]))
        out += [(f"{p}.final_layer_norm.weight", (e,), "ones", 0),
                (f"{p}.final_layer_norm.bias", (e,), "zeros", 0)]
    return out


@torch.no_grad()
def make_params(config: dict, generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Every parameter, float32, on the generator's device, from one draw
    of U(-1, 1) over all of them: torch's default initialisers' ranges
    (uniform within 1/sqrt(fan_in)), N(0, 1)'s spread for the WavLM table,
    LayerNorm at (1, 0), HardConcrete's log_alpha at its init mean."""
    shapes = param_shapes(config)
    total = sum(math.prod(s) for _, s, _, _ in shapes)
    device = generator.device
    buf = torch.rand(total, generator=generator, device=device).mul_(2.0).sub_(1.0)
    out: Dict[str, torch.Tensor] = {}
    at = 0
    prev = None
    for name, shape, kind, arg in shapes:
        n = math.prod(shape)
        t = buf[at:at + n].view(shape)
        at += n
        if kind == "uniform":
            t.mul_(1.0 / math.sqrt(arg))
        elif kind == "ones":
            t.fill_(1.0)
        elif kind == "zeros":
            t.zero_()
        elif kind == "normal":
            t.mul_(math.sqrt(3.0))
        elif kind == "log_alpha":
            t.mul_(0.01 * math.sqrt(3.0)).add_(math.log(1 - arg) - math.log(arg))
        elif kind == "norm_g":
            t.copy_(prev.square().sum(dim=(0, 1), keepdim=True).sqrt())
        else:
            raise ValueError(kind)
        out[name] = t
        prev = t
    return out


# ---------------------------------------------------------------------------
# Precision of the products
# ---------------------------------------------------------------------------


class Precision:
    """Rounds the two operands of every product; the identity here."""

    name = "fp32"

    def __call__(self, x: torch.Tensor, role: str = "act") -> torch.Tensor:
        return x


FP32 = Precision()


class _Round8(torch.autograd.Function):
    """Forward: x scaled to the format's range by its absolute maximum,
    rounded to float8 e4m3 and scaled back; backward: the incoming gradient
    likewise in float8 e5m2 (the usual pair of float8 training)."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, 57344.0)


def _round(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    scale = top / amax
    return (x.float() * scale).to(dtype).float() / scale


class Float8(Precision):
    name = "fp8"

    def __call__(self, x, role="act"):
        return _Round8.apply(x)


FP8 = Float8()


# ---------------------------------------------------------------------------
# Randomness
# ---------------------------------------------------------------------------


class Draws:
    """The step's random numbers, from one generator, in the order the
    recipe's step draws them."""

    def __init__(self, generator: torch.Generator):
        self.g = generator

    def uniform(self, shape, dtype=torch.float32) -> torch.Tensor:
        return torch.rand(tuple(shape), generator=self.g, device=self.g.device, dtype=dtype)

    def seed32(self) -> int:
        s = torch.randint(-2**31, 2**31, (1,), generator=self.g, device=self.g.device)
        return int(s.to(torch.int32)[0])


# ---------------------------------------------------------------------------
# Forward pass
# ---------------------------------------------------------------------------


def layer_norm(x, w, b, dim=-1, affine_dim=None):
    """Normalise over ``dim``; the affine along ``affine_dim`` (default
    ``dim``): GroupNorm with a group per channel is (dim=time, affine=channel)."""
    mean = x.mean(dim=dim, keepdim=True)
    var = (x - mean).square().mean(dim=dim, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + LN_EPS)
    shape = [1] * x.ndim
    shape[dim if affine_dim is None else affine_dim] = -1
    return y * w.reshape(shape) + b.reshape(shape)


def linear(x, w, b, prec: Precision):
    return F.linear(prec(x), prec(w, "weight"), b)


def dropout(x, rate, draws: Optional[Draws]):
    if draws is None or rate <= 0.0:
        return x
    u = draws.uniform(x.shape)
    keep = 1.0 - rate
    return torch.where(u < keep, x / keep, torch.zeros_like(x))


def conv_lengths(a: Arch, lengths):
    for _, k, s in a.conv:
        lengths = torch.clamp_min(torch.div(lengths - k, s, rounding_mode="floor") + 1, 0)
    return lengths


def rel_buckets(L: int, num_buckets: int, max_distance: int) -> np.ndarray:
    """WavLM's bidirectional relative-position buckets (its paper's eq. 5,
    fairseq's ``_relative_positions_bucket``): half the buckets per sign,
    half of those exact, the rest log-spaced to ``max_distance``; the log in
    float32, as the released implementation takes it."""
    rel = np.arange(L)[None, :] - np.arange(L)[:, None]
    nb = num_buckets // 2
    out = (rel > 0).astype(np.int64) * nb
    ab = np.abs(rel)
    exact = nb // 2
    large = exact + (np.log(np.maximum(ab, 1).astype(np.float32) / exact)
                     / math.log(max_distance / exact) * (nb - exact)).astype(np.int64)
    large = np.minimum(large, nb - 1)
    return out + np.where(ab < exact, ab, large)


def attention(x, lengths, P, pre, a: Arch, layer: Layer, gates, draws, prec, bias_table):
    """Multi-head self-attention (WavLM: with the gated relative-position
    bias of the table computed in layer 0) -> (output, bias table)."""
    B, L, E = x.shape
    H, D = layer.heads, a.head_dim
    q = linear(x, P[pre + "q_proj.weight"], P[pre + "q_proj.bias"], prec)
    k = linear(x, P[pre + "k_proj.weight"], P[pre + "k_proj.bias"], prec)
    v = linear(x, P[pre + "v_proj.weight"], P[pre + "v_proj.bias"], prec)
    q, k, v = (t.view(B, L, H, D).transpose(1, 2) for t in (q, k, v))
    seed = draws.seed32() if (draws is not None and a.attn_dropout > 0) else None
    s = torch.matmul(prec(q), prec(k).transpose(-1, -2)) * D ** -0.5
    if a.wavlm:
        if pre + "rel_attn_embed.weight" in P and bias_table is None:
            idx = torch.from_numpy(rel_buckets(L, a.buckets, a.max_distance)).to(x.device)
            bias_table = P[pre + "rel_attn_embed.weight"][idx].permute(2, 0, 1)  # (TH, L, L)
        if bias_table is not None:
            TH = a.total_heads
            query = x.view(B, L, TH, E // TH).transpose(1, 2)
            raw = linear(query, P[pre + "gru_rel_pos_linear.weight"],
                         P[pre + "gru_rel_pos_linear.bias"], prec)
            g = torch.sigmoid(raw.view(B, TH, L, 2, 4).sum(-1))
            const = P[pre + "gru_rel_pos_const"].view(1, TH, 1)
            gate = g[..., 0] * (g[..., 1] * const - 1.0) + 2.0  # (B, TH, L)
            rows = torch.tensor(layer.head_ids, device=x.device)
            s = s + gate[:, rows, :, None] * bias_table[rows][None]
    if lengths is not None:
        pad = torch.arange(L, device=x.device)[None, :] >= lengths[:, None]
        s = s.masked_fill(pad[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    if seed is not None:
        keep = keep_mask(seed, 1.0 - a.attn_dropout, B, H, L, x.device)
        p = torch.where(keep, p / (1.0 - a.attn_dropout), torch.zeros_like(p))
    out = torch.matmul(prec(p), prec(v)).transpose(1, 2).reshape(B, L, H * D)
    head_gate = _gate(gates, "heads")
    if head_gate is not None:
        out = (out.view(B, L, H, D) * head_gate[:, None]).view(B, L, H * D)
    out = linear(out, P[pre + "out_proj.weight"], P[pre + "out_proj.bias"], prec)
    layer_gate = _gate(gates, "layer")
    if layer_gate is not None:
        out = out * layer_gate
    return out, bias_table


def feed_forward(x, P, pre, a: Arch, gates, draws, prec):
    y = F.gelu(linear(x, P[pre + "intermediate_dense.weight"],
                      P[pre + "intermediate_dense.bias"], prec))
    y = dropout(y, a.ffn_dropout, draws)
    g = _gate(gates, "intermediate")
    if g is not None:
        y = y * g
    y = linear(y, P[pre + "output_dense.weight"], P[pre + "output_dense.bias"], prec)
    y = dropout(y, a.dropout, draws)
    g = _gate(gates, "layer")
    if g is not None:
        y = y * g
    return y


def _gate(gates, *path):
    for key in path:
        if not gates:
            return None
        gates = gates.get(key)
    return gates


def extract_features(P: Dict[str, torch.Tensor], config: dict, wave: torch.Tensor,
                     lengths: Optional[torch.Tensor] = None, *, gates: Optional[dict] = None,
                     draws: Optional[Draws] = None, prec: Precision = FP32
                     ) -> Tuple[List[torch.Tensor], Optional[torch.Tensor]]:
    """[projected CNN features] + every encoder layer's output (no final
    LayerNorm of a pre-norm model), and the valid frame counts.  ``draws``
    turns dropout on; ``gates`` is the sampled HardConcrete tree
    (``distill.sample_gates``)."""
    a = arch(config)
    if bool(config.get("normalize_waveform", False)):
        raise NotImplementedError("normalize_waveform: not in the benchmark's configurations")
    x = wave[:, None, :]
    fe = "feature_extractor.conv_layers."
    for i, (_, k, s) in enumerate(a.conv):
        x = F.conv1d(prec(x), prec(P[f"{fe}{i}.conv.weight"], "weight"),
                     P.get(f"{fe}{i}.conv.bias"), stride=s)
        if a.group_norm and i == 0:
            # per-channel statistics over all T, padding included
            x = layer_norm(x, P[f"{fe}0.layer_norm.weight"], P[f"{fe}0.layer_norm.bias"],
                           dim=2, affine_dim=1)
        elif not a.group_norm:
            x = layer_norm(x.transpose(1, 2), P[f"{fe}{i}.layer_norm.weight"],
                           P[f"{fe}{i}.layer_norm.bias"]).transpose(1, 2)
        x = F.gelu(x)
        g = _gate(gates, "conv_layers", str(i))
        if g is not None:
            x = x * g[None, :, None]
    x = x.transpose(1, 2) * P["feature_extractor.dummy_weight"]
    if lengths is not None:
        lengths = conv_lengths(a, lengths)
    fp = "encoder.feature_projection."
    x = layer_norm(x, P[fp + "layer_norm.weight"], P[fp + "layer_norm.bias"])
    x = dropout(linear(x, P[fp + "projection.weight"], P[fp + "projection.bias"], prec),
                a.proj_dropout, draws)
    if lengths is not None:
        pad = torch.arange(x.shape[1], device=x.device)[None, :] >= lengths[:, None]
        x = x.masked_fill(pad[:, :, None], 0.0)
    outs = [x]
    tr = "encoder.transformer."
    v = P[tr + "pos_conv_embed.conv.weight_v"]
    w = v * (P[tr + "pos_conv_embed.conv.weight_g"] / v.square().sum(dim=(0, 1), keepdim=True).sqrt())
    k = a.pos_kernel
    y = F.conv1d(prec(x.transpose(1, 2)), prec(w, "weight"), P[tr + "pos_conv_embed.conv.bias"],
                 padding=k // 2, groups=a.pos_groups)
    if k % 2 == 0:
        y = y[..., :-1]
    x = x + F.gelu(y).transpose(1, 2)
    if a.post_norm:
        x = layer_norm(x, P[tr + "layer_norm.weight"], P[tr + "layer_norm.bias"])
    x = dropout(x, a.dropout, draws)
    table = None
    for i, layer in enumerate(a.layers):
        pre = f"{tr}layers.{i}."
        lg = _gate(gates, "layers", str(i))
        if layer.heads:
            residual = x
            h = x if a.post_norm else layer_norm(x, P[pre + "layer_norm.weight"],
                                                 P[pre + "layer_norm.bias"])
            h, table = attention(h, lengths, P, pre + "attention.", a, layer,
                                 _gate(lg, "attention"), draws, prec, table)
            x = residual + dropout(h, a.dropout, draws)
        if a.post_norm:
            x = layer_norm(x, P[pre + "layer_norm.weight"], P[pre + "layer_norm.bias"])
            if layer.ffn:
                x = x + feed_forward(x, P, pre + "feed_forward.", a, _gate(lg, "feed_forward"),
                                     draws, prec)
            x = layer_norm(x, P[pre + "final_layer_norm.weight"], P[pre + "final_layer_norm.bias"])
        elif layer.ffn:
            h = layer_norm(x, P[pre + "final_layer_norm.weight"], P[pre + "final_layer_norm.bias"])
            x = x + feed_forward(h, P, pre + "feed_forward.", a, _gate(lg, "feed_forward"),
                                 draws, prec)
        outs.append(x)
    return outs, lengths

