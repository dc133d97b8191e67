#!/usr/bin/env python3
"""Device-time breakdown of the port's distill step on one card.

    python3 tools/profile_torch_step.py [--model wavlm_base | --step final_distill]
                                        [--steps 2] [--out PATH]

Builds a step that ``chip_smoke.py`` drives, with random weights from seeds
and dropout on: the stage-1 step (teacher ``hubert_base``, or
``wavlm_base`` for the DPWavLM step, the student its config with all five
prune flags, ``DistillConfig`` defaults in bf16, B = 16 clips of 15 s on
the card) or, with ``--step final_distill``, the final-distill step
(teacher ``hubert_base``, the student ``docs/pruned_config_r2.json`` with
every attention sublayer on, ``use_reg=False`` in bf16, B = 5 clips of
249,920 samples: its 11- and 9-head layers take the flash route); warms it
for two steps,
then runs ``--steps`` steps under ``torch.profiler`` and prints one JSON object: the wall time of a
step, the card's busy time in it (the union of the kernels' intervals), and
the device time of each kernel family and of the top kernels by name.  The
JSON also goes to ``--out`` (default ``build/profile_torch_step.json``).
Needs a CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time
from collections import defaultdict

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import dphubert_torch as pt  # noqa: E402
from dphubert_torch.train import DistillConfig, init_train_state, make_train_step  # noqa: E402

PRUNE_FLAGS = dict(
    extractor_prune_conv_channels=True,
    encoder_prune_attention_heads=True,
    encoder_prune_attention_layer=True,
    encoder_prune_feed_forward_intermediate=True,
    encoder_prune_feed_forward_layer=True,
)
# kernel family by a substring of the kernel's name, first match wins
FAMILIES = (
    ("attention (this repo's kernels)", ("attention_fwd_", "attention_bwd_", "wavlm_")),
    ("matmul (cuBLAS)", ("gemm", "nvjet", "cublas", "cutlass")),
    ("convolution (cuDNN)", ("conv", "cudnn", "fprop", "dgrad", "wgrad", "implicit")),
    ("random numbers", ("distribution", "philox", "random", "bernoulli")),
    ("optimizer (foreach)", ("multi_tensor", "foreach")),
    ("reductions", ("reduce", "norm")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "Loops", "copy")),
)


def family(name: str) -> str:
    for label, keys in FAMILIES:
        if any(k in name for k in keys):
            return label
    return "other"


def union_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=("hubert_base", "wavlm_base"), default="hubert_base")
    ap.add_argument("--step", choices=("stage1", "final_distill"), default="stage1")
    ap.add_argument("--steps", type=int, default=2)
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
        cfg = DistillConfig(compute_dtype="bfloat16")
        shape = [16, 240000]
    else:
        config = json.loads((REPO / "docs" / "pruned_config_r2.json").read_text())
        config["encoder_use_attention"] = [True] * config["encoder_num_layers"]
        student = pt.wav2vec2_model(device="cuda", generator=torch.Generator().manual_seed(7),
                                    **config)
        cfg = DistillConfig(use_reg=False, compute_dtype="bfloat16")
        shape = [5, 249920]
    state, tx = init_train_state(student=student, cfg=cfg, teacher_embed_dim=768, seed=5)
    del student
    step = make_train_step(teacher, cfg, tx)
    gen = torch.Generator(device="cuda").manual_seed(6)
    batch = (torch.randn(*shape, device="cuda", generator=gen), None)
    for _ in range(2):
        step(state, batch)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("the profiler recorded no device activity")
    by_name = defaultdict(lambda: [0.0, 0])
    by_family = defaultdict(float)
    for e in kernels:
        us = e.time_range.elapsed_us()
        by_name[e.name][0] += us
        by_name[e.name][1] += 1
        by_family[family(e.name)] += us
    busy_ms = union_us((e.time_range.start, e.time_range.end) for e in kernels) / 1e3 / args.steps
    kernel_ms = sum(by_family.values()) / 1e3 / args.steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:25]
    result = {
        "nvidia_smi": smi, "device": torch.cuda.get_device_name(0), "model": args.model,
        "step": args.step, "steps": args.steps, "batch": shape, "dtype": "bfloat16",
        "wall_ms_per_step": wall_ms, "device_busy_ms_per_step": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "kernel_ms_per_step": kernel_ms,
        "kernel_launches_per_step": len(kernels) / args.steps,
        "families_ms_per_step": {k: v / 1e3 / args.steps
                                 for k, v in sorted(by_family.items(), key=lambda kv: -kv[1])},
        "top_kernels": [{"name": n[:120], "ms_per_step": t / 1e3 / args.steps,
                         "calls_per_step": c / args.steps} for n, (t, c) in top],
    }
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
