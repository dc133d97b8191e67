"""The yardstick's arithmetic: the chip's peaks, the model's operations
from its configuration and the batch's shapes, and each attention op's
least time on the chip.  Counts depend only on the configuration and the
shapes, never on which kernels do the work.

Operations count the products only (linear layers, convolutions, the two
attention products), 2 per multiply-add; norms, activations, dropout, gates
and the optimizer are not counted.  A backward counts the input and the
weight gradients of every product (2x its forward), except the input
gradient of the first conv, whose input is the waveform; attention's
backward counts dV, dP, dQ and dK (8 B H L D L), not the recompute of S.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

from ..reference import model as M

# NVIDIA H100 SXM data sheet, dense, at its 700 W limit
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
BYTES = {"bfloat16": 2, "float32": 4}


def conv_frames(a: M.Arch, samples: int) -> List[int]:
    """Output frames of each conv layer for a clip of ``samples``."""
    out, n = [], samples
    for _, k, s in a.conv:
        n = max((n - k) // s + 1, 0)
        out.append(n)
    return out


def forward_flops(config: dict, samples: Sequence[int]) -> dict:
    """Forward operations of the model on clips of ``samples`` each, over
    their valid lengths, as {"conv": first conv, "conv_rest": other
    extractor convs, "dense": the projection, the positional conv,
    attention's and the FFN's linear layers, "attn": the two attention
    products}."""
    a = M.arch(config)
    out = dict(conv=0.0, conv_rest=0.0, dense=0.0, attn=0.0)
    e = a.embed
    for n in samples:
        frames = conv_frames(a, n)
        cin = 1
        for i, ((c, k, _), t) in enumerate(zip(a.conv, frames)):
            out["conv" if i == 0 else "conv_rest"] += 2.0 * c * cin * k * t
            cin = c
        L = frames[-1]
        dense = 2.0 * cin * e + 2.0 * e * (e // a.pos_groups) * a.pos_kernel
        for layer in a.layers:
            if layer.heads:
                hd = layer.heads * a.head_dim
                dense += 2.0 * e * 3 * hd + 2.0 * hd * e
                if a.wavlm:
                    dense += 2.0 * e * 8  # the gate's linear over TH chunks of E / TH
                out["attn"] += 4.0 * layer.heads * a.head_dim * L * L
            if layer.ffn:
                dense += 4.0 * e * layer.ffn
        out["dense"] += dense * L
    return out


def train_step_flops(teacher_cfg: dict, student_cfg: dict, B: int, T: int) -> float:
    """One distill step on a (B, T) batch without padding: the teacher's
    forward, the student's forward and backward."""
    t = forward_flops(teacher_cfg, [T] * B)
    s = forward_flops(student_cfg, [T] * B)
    fwd = lambda f: sum(f.values())
    return fwd(t) + fwd(s) + 2.0 * (s["conv_rest"] + s["dense"] + s["attn"]) + s["conv"]


@dataclass(frozen=True)
class AttentionOp:
    """One call of attention as the model makes it: its heads, head size,
    valid lengths of its rows, whether it is a backward, whether it carries
    WavLM's gated bias; ``dtype`` of q, k, v."""

    heads: int
    head_dim: int
    lengths: tuple
    backward: bool
    wavlm: bool
    dtype: str = "bfloat16"

    def flops(self) -> float:
        per = 8.0 if self.backward else 4.0
        return per * self.heads * self.head_dim * sum(L * L for L in self.lengths)

    def bytes(self) -> float:
        """Each input read once and each output written once: q, k, v, o
        (and dO, dQ, dK, dV in a backward) over the valid rows; WavLM's bias
        (H, L, L) and gate (B, H, L) in fp32 (and dbias, dgate)."""
        rows = sum(self.lengths) * self.heads * self.head_dim * BYTES[self.dtype]
        n = rows * (8 if self.backward else 4)
        if self.wavlm:
            L = max(self.lengths)
            extra = 4.0 * (self.heads * L * L + self.heads * sum(self.lengths))
            n += extra * (2 if self.backward else 1)
        return n

    def bound_s(self) -> float:
        return max(self.flops() / PEAK_FLOPS[self.dtype], self.bytes() / PEAK_BYTES)


def attention_ops(config: dict, lengths: Sequence[int], backward: bool,
                  dtype: str = "bfloat16") -> List[AttentionOp]:
    """The attention ops of one forward (or one backward) of the model over
    rows of the given valid frame counts."""
    a = M.arch(config)
    return [AttentionOp(layer.heads, a.head_dim, tuple(lengths), backward, a.wavlm, dtype)
            for layer in a.layers if layer.heads]


def frames(config: dict, samples: int) -> int:
    return conv_frames(M.arch(config), samples)[-1]
