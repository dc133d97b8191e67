#!/usr/bin/env python3
"""Device-time breakdown of the port's distill step on one card.

    python3 tools/profile_torch_step.py [--model wavlm_base | wav2vec2_large [--remat]
                                         | wav2vec2_large_lv60k [--remat]
                                         | --step final_distill] [--steps 2] [--norm-ranges]
                                         [--out PATH]

Builds a step that ``chip_smoke.py`` drives, with random weights from seeds
and dropout on: the stage-1 step (teacher ``hubert_base``, or
``wavlm_base`` for the DPWavLM step, the student its config with all five
prune flags, ``DistillConfig`` defaults in bf16, B = 16 clips of 15 s on
the card; ``wav2vec2_large`` or ``wav2vec2_large_lv60k``: run_large.sh's
step, distill groups ``((0,), (4, 8, 12, 16, 20, 24))`` at B = 12 clips of
15 s, with ``--remat`` the student's layers checkpointed) or, with ``--step
final_distill``, the final-distill step
(teacher ``hubert_base``, the student ``docs/pruned_config_r2.json`` with
every attention sublayer on, ``use_reg=False`` in bf16, B = 5 clips of
249,920 samples: its 11- and 9-head layers take the flash route); warms it
for two steps,
then runs ``--steps`` steps under ``torch.profiler`` (with ``record_shapes``) and prints one
JSON object: the wall time of a step, the card's busy time in it (the union
of the kernels' intervals), the device time of each kernel family and of
the top kernels by name, and for each ``aten::convolution_backward`` of the
last step the shapes it was called with and the device time of each kernel
launched under it.  With ``--norm-ranges`` the tool wraps
``models.components._layer_norm`` (the program is not changed) so that each
call's forward runs under a ``norm.fwd`` range and its backward, between
two identity autograd functions at its output and its input, under a
``norm.bwd`` range, and the JSON adds the calls and the device ms of the
kernels under each (the backward's range also holds whatever autograd
interleaves there; the port's own kernels, launched through ctypes, are
found under the ranges only in part: read them by name in
``top_kernels``).  The JSON also goes to ``--out`` (default
``build/profile_torch_step.json``).
Needs a CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import dphubert_torch as pt  # noqa: E402
from dphubert_torch.models import components  # noqa: E402
from dphubert_torch.train import DistillConfig, init_train_state, make_train_step  # noqa: E402
from dphubert_torch.utils.profiling import device_breakdown  # noqa: E402

PRUNE_FLAGS = dict(
    extractor_prune_conv_channels=True,
    encoder_prune_attention_heads=True,
    encoder_prune_attention_layer=True,
    encoder_prune_feed_forward_intermediate=True,
    encoder_prune_feed_forward_layer=True,
)


def _kernels_ms(event, out: dict) -> dict:
    """Device ms of each kernel launched under ``event``, by name."""
    for k in event.kernels:
        out[k.name] = out.get(k.name, 0.0) + k.duration / 1e3
    for child in event.cpu_children:
        _kernels_ms(child, out)
    return out


class _OpenBwd(torch.autograd.Function):
    """Identity on a norm's output: its backward, the first of the norm's,
    opens the ``norm.bwd`` range."""

    @staticmethod
    def forward(ctx, y, handles):
        ctx.handles = handles
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        ctx.handles.append(torch.ops.profiler._record_function_enter_new("norm.bwd", None))
        return g, None


class _CloseBwd(torch.autograd.Function):
    """Identity on a norm's input: its backward, after the norm's, closes
    the range."""

    @staticmethod
    def forward(ctx, x, handles):
        ctx.handles = handles
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if ctx.handles:
            torch.ops.profiler._record_function_exit(ctx.handles.pop())
        return g, None


def mark_norms() -> None:
    """Put every ``_layer_norm`` call under the ranges ``norm.fwd`` and,
    where its input takes a gradient, ``norm.bwd``."""
    plain = components._layer_norm

    def marked(x, *args, **kw):
        handles = []
        grad = torch.is_grad_enabled() and x.requires_grad
        if grad:
            x = _CloseBwd.apply(x, handles)
        with torch.profiler.record_function("norm.fwd"):
            y = plain(x, *args, **kw)
        return _OpenBwd.apply(y, handles) if grad else y

    components._layer_norm = marked


def norm_ranges(prof, steps: int) -> dict:
    """Calls and device ms of the kernels under each norm range, a step."""
    out = {}
    for name in ("norm.fwd", "norm.bwd"):
        events = [e for e in prof.events() if e.name == name
                  and e.device_type == DeviceType.CPU]  # not the card's annotation
        kernels = {}
        for e in events:
            _kernels_ms(e, kernels)
        out[name] = {"calls_per_step": len(events) / steps,
                     "kernel_ms_per_step": sum(kernels.values()) / steps,
                     "top_kernels_ms_per_step": {k[:120]: v / steps for k, v in sorted(
                         kernels.items(), key=lambda kv: -kv[1])[:8]}}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=("hubert_base", "wavlm_base", "wav2vec2_large",
                                        "wav2vec2_large_lv60k"), default="hubert_base")
    ap.add_argument("--remat", action="store_true",
                    help="checkpoint the student's layers (DistillConfig.remat)")
    ap.add_argument("--step", choices=("stage1", "final_distill"), default="stage1")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--norm-ranges", action="store_true",
                    help="put each _layer_norm call's kernels under a named range")
    ap.add_argument("--out", default=str(REPO / "build" / "profile_torch_step.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_step: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    if args.step == "final_distill" and args.model != "hubert_base":
        ap.error("--step final_distill takes the hubert_base teacher")
    teacher = getattr(pt, args.model)(device="cuda", generator=torch.Generator().manual_seed(0))
    if args.step == "stage1":
        student = pt.wav2vec2_model(device="cuda", generator=torch.Generator().manual_seed(1),
                                    **dict(teacher.config, **PRUNE_FLAGS))
        if args.model.startswith("wav2vec2_large"):
            cfg = DistillConfig(distill_layer_groups=((0,), (4, 8, 12, 16, 20, 24)),
                                compute_dtype="bfloat16", remat=args.remat)
            shape = [12, 240000]
        else:
            cfg = DistillConfig(compute_dtype="bfloat16", remat=args.remat)
            shape = [16, 240000]
    else:
        config = json.loads((REPO / "docs" / "pruned_config_r2.json").read_text())
        config["encoder_use_attention"] = [True] * config["encoder_num_layers"]
        student = pt.wav2vec2_model(device="cuda", generator=torch.Generator().manual_seed(7),
                                    **config)
        cfg = DistillConfig(use_reg=False, compute_dtype="bfloat16", remat=args.remat)
        shape = [5, 249920]
    state, tx = init_train_state(student=student, cfg=cfg,
                                 teacher_embed_dim=teacher.spec.embed_dim, seed=5)
    del student
    if args.norm_ranges:
        mark_norms()
    step = make_train_step(teacher, cfg, tx)
    gen = torch.Generator(device="cuda").manual_seed(6)
    batch = (torch.randn(*shape, device="cuda", generator=gen), None)
    for _ in range(2):
        step(state, batch)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    dev = device_breakdown(prof, steps=args.steps)
    busy_ms = dev["busy_ms"]
    conv_bwd = [e for e in prof.events() if e.name == "aten::convolution_backward"]
    conv_bwd = conv_bwd[len(conv_bwd) * (args.steps - 1) // args.steps:]  # the last step's
    result = {
        "nvidia_smi": smi, "device": torch.cuda.get_device_name(0), "model": args.model,
        "step": args.step, "remat": args.remat, "steps": args.steps, "batch": shape,
        "dtype": "bfloat16",
        "wall_ms_per_step": wall_ms, "device_busy_ms_per_step": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "kernel_ms_per_step": dev["kernel_ms"],
        "kernel_launches_per_step": dev["launches"],
        "families_ms_per_step": dev["families_ms"],
        "top_kernels": [{"name": k["name"][:120], "ms_per_step": k["ms"],
                         "calls_per_step": k["calls"]} for k in dev["top"]],
        "convolution_backward": [
            {"input_shapes": e.input_shapes,
             "kernels_ms": dict(sorted(_kernels_ms(e, {}).items(), key=lambda kv: -kv[1]))}
            for e in conv_bwd],
    }
    if args.norm_ranges:
        result["norm_ranges"] = norm_ranges(prof, args.steps)
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
