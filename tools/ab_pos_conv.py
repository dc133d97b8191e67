#!/usr/bin/env python3
"""The positional conv's backward on one card, two ways.

    python3 tools/ab_pos_conv.py [--iters 20] [--out PATH]

The pos conv's backward alone (GELU and transposes included, as the
encoder runs it) in bf16 at the stage-1 rungs' shapes (B, L) = (80, 99),
(26, 305), (10, 780) at HuBERT Base's width (768 channels, 16 groups, 128
taps) and at wav2vec 2.0 Large's stage-1 shape (12, 749) at 1024 channels:
autograd through ``F.conv1d`` (cuDNN's backward-data) against
``ops.pos_conv.PosConvFn`` (the input gradient as a forward conv), in
turns, CUDA events over ``--iters`` backwards, the median of 5 rounds; also
the input-gradient kernels alone, and each route's dX against the float32
autograd gradient (relative Frobenius error).

Prints one JSON object and writes it to ``--out`` (default
``build/ab_pos_conv.json``).  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

RUNGS = ((80, 99), (26, 305), (10, 780))
LARGE = (12, 749)


def card() -> dict:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    return {"nvidia_smi": smi, "device": torch.cuda.get_device_name(0),
            "torch": torch.__version__, "cuda": torch.version.cuda}


def _ms(fn, iters: int) -> float:
    """Device ms per call of ``fn``: CUDA events over ``iters`` calls."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def run_time(iters: int) -> dict:
    from dphubert_torch.ops import pos_conv

    rows = []
    shapes = [(b, l, 768) for b, l in RUNGS] + [(*LARGE, 1024)]
    for B, L, C in shapes:
        G, K = 16, 128
        gen = torch.Generator(device="cuda").manual_seed(B * L)
        x32 = torch.randn(B, L, C, device="cuda", generator=gen)
        w32 = torch.randn(C, C // G, K, device="cuda", generator=gen) / (C // G * K) ** 0.5
        b32 = 0.1 * torch.randn(C, device="cuda", generator=gen)
        d32 = torch.randn(B, L, C, device="cuda", generator=gen)
        x, w, b, dout = (t.to(torch.bfloat16) for t in (x32, w32, b32, d32))

        def graph(route, x, w, b):
            x, w, b = (t.detach().requires_grad_() for t in (x, w, b))
            if route == "dgrad":
                y = F.conv1d(x.transpose(1, 2), w, b, padding=K // 2, groups=G)[..., :-1]
            else:
                y = pos_conv.PosConvFn.apply(x.transpose(1, 2), w, b, G)
            return F.gelu(y).transpose(1, 2), (x, w, b)

        ref = torch.autograd.grad(*graph("dgrad", x32, w32, b32), d32)[0]
        row = {"B": B, "L": L, "C": C, "groups": G, "K": K}
        outs = {r: graph(r, x, w, b) for r in ("dgrad", "fprop")}
        for r, (out, ins) in outs.items():
            dx = torch.autograd.grad(out, ins, dout, retain_graph=True)[0]
            row[f"{r}_dx_rel_err_vs_fp32"] = ((dx.float() - ref).norm() / ref.norm()).item()
        # the input-gradient kernels alone, on the untrimmed / trimmed dY
        dy = torch.randn(B, C, L + 1, device="cuda", generator=gen).to(torch.bfloat16)
        xt = x.transpose(1, 2)
        dy_t = dy[..., :-1].transpose(1, 2).contiguous().transpose(1, 2)
        alone = {
            "dgrad": lambda: torch.ops.aten.convolution_backward(
                dy, xt, w, [C], [1], [K // 2], [1], False, [0], G, [True, False, False]),
            "fprop": lambda: F.conv1d(dy_t, pos_conv.transposed_weight(w, G), None,
                                      padding=K // 2, groups=G),
        }
        fwd = lambda: F.conv1d(xt, w, b, padding=K // 2, groups=G)  # noqa: E731
        full = {r: (lambda o=o: torch.autograd.grad(o[0], o[1], dout, retain_graph=True))
                for r, o in outs.items()}
        for fn in (*full.values(), *alone.values(), fwd):
            fn()
        torch.cuda.synchronize()
        samples = {f"{k}_{r}": [] for k in ("backward", "dx_alone") for r in ("dgrad", "fprop")}
        samples["forward"] = []
        for _ in range(5):  # in turns: dgrad, fprop, fprop, dgrad
            for r in ("dgrad", "fprop", "fprop", "dgrad"):
                samples[f"backward_{r}"].append(_ms(full[r], iters))
                samples[f"dx_alone_{r}"].append(_ms(alone[r], iters))
            samples["forward"].append(_ms(fwd, iters))
        for k, v in samples.items():
            row[f"{k}_ms"] = statistics.median(v)
        row["backward_speedup"] = row["backward_dgrad_ms"] / row["backward_fprop_ms"]
        rows.append(row)
        del outs, full, alone
        torch.cuda.empty_cache()
    return {**card(), "dtype": "bfloat16", "iters": iters, "rows": rows}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_pos_conv: needs a CUDA card", file=sys.stderr)
        return 1
    result = run_time(args.iters)
    out = pathlib.Path(args.out or REPO / "build" / "ab_pos_conv.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
