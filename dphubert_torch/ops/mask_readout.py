"""The dropout mask read back out of the attention forward and backward
entries.

With chosen inputs the output of ``packed_attention`` / ``flash_attention``
/ ``wavlm_attention`` (both WavLM forward entries) and the gradients that
``packed_attention_bwd_dq`` / ``_dkv``, ``flash_attention_bwd_dq`` /
``_dkv``, ``wavlm_attention_bwd_fused`` / ``wavlm_attention_bwd_dkv`` (the
single route) and ``wavlm_attention_bwd_dq`` / ``_dbias`` / ``_dkv_general``
(the general route) return are integers whose bits are the keep mask
the kernel drew at each (batch, head, row, column), so a test can hold the
kernels' device hash, at every accumulator element's (row, column), bit for
bit against the plain mask (``dropout_keep_mask``).  The tests run it on the
CPU (plain versions) and on the card, and ``chip_smoke.py`` runs it on the
card through both bodies of each entry.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

import torch

from .attention_common import dropout_keep_mask
from .flash_attention import flash_attention, flash_attention_bwd_dkv, flash_attention_bwd_dq
from .packed_attention import (
    packed_attention,
    packed_attention_bwd_dkv,
    packed_attention_bwd_dq,
)
from .wavlm_attention import (
    wavlm_attention,
    wavlm_attention_bwd_dbias,
    wavlm_attention_bwd_dkv,
    wavlm_attention_bwd_dkv_general,
    wavlm_attention_bwd_dq,
    wavlm_attention_bwd_fused,
)


def _coded(L, D, device):
    """(L, D) fp32: row j holds 2**(j // D) in column j % D."""
    j = torch.arange(L, device=device)
    x = torch.zeros(L, D, device=device)
    x[j, j % D] = 2.0 ** (j // D).float()
    return x


def forward_mask_readout(layout: str, device, dtype: torch.dtype, seeds: Iterable[int],
                         B: int = 2, H: int = 12, L: int = 200, D: int = 64,
                         rate: float = 0.1, block_kv: Optional[int] = None,
                         ) -> List[Tuple[int, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]]:
    """The dropout mask read out of the forward entry of ``layout``
    ("packed", "flash", or "wavlm": ``wavlm_attention`` with a zero bias and
    a gate of 1.5, so the gated term adds 0, on the route ``block_kv``
    picks: the single entry for None, the general one for a block_kv below
    the padded length): with q = k = 0 every key gets the same weight, and
    value row j holds 2**(j // D) in column j % D, so out * L * keep is the
    integer sum_blk keep(i, blk * D + d) * 2**blk, whose bits are row i of
    the mask.  In bf16 the codes survive the output's rounding while they
    stay below 2**4 (L <= 4 D).  Returns [(seed, got, want, l)] with (B, H,
    L, L) boolean masks and, for flash and wavlm, the row sums l (L for
    every row: l is the undropped sum), None for packed."""
    keep = 1.0 - rate
    j = torch.arange(L, device=device)
    v1 = _coded(L, D, device)
    if layout == "packed":
        v = v1.repeat(1, H).expand(B, L, H * D).contiguous().to(dtype)
    else:
        v = v1.expand(B, H, L, D).contiguous().to(dtype)
    qk = torch.zeros_like(v)
    if layout == "wavlm":
        bias = torch.zeros(H, L, L, device=device)
        gate = torch.full((B, H, L), 1.5, device=device)
    b = torch.arange(B, device=device).view(B, 1, 1, 1)
    h = torch.arange(H, device=device).view(1, H, 1, 1)
    found = []
    for seed in seeds:
        t_seed = torch.tensor([seed], dtype=torch.int32, device=device)
        l = None
        with torch.no_grad():
            if layout == "packed":
                out = packed_attention(qk, qk, v, None, num_heads=H, dropout_rate=rate,
                                       seed=t_seed)
                out = out.view(B, L, H, D).transpose(1, 2)
            elif layout == "flash":
                out, _, l = flash_attention(qk, qk, v, None, dropout_rate=rate, seed=t_seed)
            else:
                out, _, l = wavlm_attention(qk, qk, v, bias, gate, None, dropout_rate=rate,
                                            seed=t_seed, block_kv=block_kv)
        code = torch.round(out.double() * L * keep).long()
        got = ((code[..., j % D] >> (j // D)) & 1).bool()
        want = dropout_keep_mask((L, L), keep, seed, b, h, device=device)
        found.append((seed, got, want, l))
    return found


def backward_mask_readout(layout: str, device, dtype: torch.dtype, seeds: Iterable[int],
                          B: int = 2, H: int = 12, L: int = 200, D: int = 64,
                          rate: float = 0.1, route: str = "single",
                          ) -> List[Tuple[int, str, torch.Tensor, torch.Tensor]]:
    """The dropout mask read out of the dq and dkv entries of ``layout``
    ("packed", "flash", or "wavlm" with a zero bias: for ``route`` "single"
    ``wavlm_attention_bwd_fused`` and ``_dkv``, for "general"
    ``wavlm_attention_bwd_dq``, ``_dbias`` and ``_dkv_general``) in three
    runs per seed, with out = 0 (so di = 0), no lengths and m = 0, l = L
    (the statistics of q k^T = 0):
      dq: q = 0 (p = 1/L), k coded, v and dout one-hot in column 0 (dp = 1):
          round(dq L keep / scale) holds row i of the mask in its bits;
      dk: k = 0, q coded, v and dout as above: round(dk L keep / scale)
          holds column j;
      dv: q = k = 0, dout coded: round(dv L keep) holds column j.
    For "wavlm" the dq run also reads dbias: there s = 0 as well and
    gate[b] = 2**b, so dbias = sum_b 2**b keep_b / (L keep), and
    round(dbias L keep) holds the masks of every batch row (b < 24) at every
    (h, i, j): the fp32 ds that dbias sums, at each accumulator element.
    Returns [(seed, what, got, want)] with (B, H, L, L) boolean masks."""
    if route not in ("single", "general"):
        raise ValueError(f"route must be 'single' or 'general', got {route!r}")
    keep = 1.0 - rate
    scale = D ** -0.5
    zero, coded = torch.zeros(L, D, device=device), _coded(L, D, device)
    onehot = torch.zeros(L, D, device=device)
    onehot[:, 0] = 1.0
    m = torch.zeros(B, H, L, device=device)
    l = torch.full((B, H, L), float(L), device=device)
    if layout == "packed":
        def full(x):
            return x.repeat(1, H).expand(B, L, H * D).contiguous().to(dtype)

        def heads(t):
            return t.view(B, L, H, D).transpose(1, 2)

        def backward(q, k, v, dout, **kw):
            dq, di = packed_attention_bwd_dq(q, k, v, torch.zeros_like(q), dout, m, l, None,
                                             num_heads=H, **kw)
            dk, dv = packed_attention_bwd_dkv(q, k, v, torch.zeros_like(q), dout, m, l, di,
                                              None, num_heads=H, **kw)
            return {"dq": dq, "dk": dk, "dv": dv}
    else:
        def full(x):
            return x.expand(B, H, L, D).contiguous().to(dtype)

        def heads(t):
            return t

        if layout == "flash":
            def backward(q, k, v, dout, **kw):
                zeros = torch.zeros_like(q)
                dq, di = flash_attention_bwd_dq(q, k, v, zeros, dout, m, l, None, **kw)
                dk, dv = flash_attention_bwd_dkv(q, k, v, zeros, dout, m, l, di, None, **kw)
                return {"dq": dq, "dk": dk, "dv": dv}
        else:
            bias = torch.zeros(H, L, L, device=device)
            gate = (2.0 ** torch.arange(B, device=device).float()).view(B, 1, 1).expand(
                B, H, L).contiguous()

            def backward(q, k, v, dout, **kw):
                args = (q, k, v, bias, gate, torch.zeros_like(q), dout, m, l)
                if route == "single":
                    dq, _, dbias, di = wavlm_attention_bwd_fused(*args, None, **kw)
                    dk, dv = wavlm_attention_bwd_dkv(*args, di, None, **kw)
                else:
                    dq, _, di = wavlm_attention_bwd_dq(*args, None, **kw)
                    dbias = wavlm_attention_bwd_dbias(*args, di, None, **kw)
                    dk, dv = wavlm_attention_bwd_dkv_general(*args, di, None, **kw)
                return {"dq": dq, "dk": dk, "dv": dv, "dbias": dbias}
    b = torch.arange(B, device=device).view(B, 1, 1, 1)
    h = torch.arange(H, device=device).view(1, H, 1, 1)
    j = torch.arange(L, device=device)
    runs = {"dq": (zero, coded, onehot, onehot, 1.0 / scale),
            "dk": (coded, zero, onehot, onehot, 1.0 / scale),
            "dv": (zero, zero, zero, coded, 1.0)}
    found = []
    for seed in seeds:
        t_seed = torch.tensor([seed], dtype=torch.int32, device=device)
        want = dropout_keep_mask((L, L), keep, seed, b, h, device=device)
        for what, (q, k, v, dout, factor) in runs.items():
            with torch.no_grad():
                grads = backward(*(full(x) for x in (q, k, v, dout)), scale=scale,
                                 dropout_rate=rate, seed=t_seed)
            code = torch.round(heads(grads[what]).double() * (L * keep * factor)).long()
            got = ((code[..., j % D] >> (j // D)) & 1).bool()
            found.append((seed, what, got, want if what == "dq" else want.transpose(-1, -2)))
            if "dbias" in grads and what == "dq":
                code = torch.round(grads["dbias"].double() * (L * keep)).long()
                got = ((code[None] >> b) & 1).bool()
                found.append((seed, "dbias", got, want))
    return found
