#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``dphubert_torch``) on one card.

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 chip_smoke.py

It builds the CUDA kernels from ``dphubert_torch/csrc/`` with nvcc, holds
each kernel against its plain PyTorch version on the card, serves HuBERT
Base and the pruned student of ``docs/pruned_config_r2.json`` through the
``Predictor`` (random weights from a seed) and checks that every attention
call of those runs went through the kernels.  Each phase prints JSON lines;
any failure raises and the script exits non-zero.  The last three lines are
the card's name and power limit as nvidia-smi prints them, the kernels line,
and ``{"ok": true, "device": {...}}``.

fp32 on the card is compared at full fp32: TF32 is switched off for matmuls
and cuDNN convolutions below, and the matmul precision is "highest".
Without a CUDA card the script exits with code 1 and prints no result.
"""

from __future__ import annotations

import copy
import json
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

import dphubert_torch as pt
from dphubert_torch.models.components import attention_route, output_lengths
from dphubert_torch.ops import _build
from dphubert_torch.ops.flash_attention import flash_attention, flash_attention_reference
from dphubert_torch.ops.packed_attention import packed_attention, packed_attention_reference
from dphubert_torch.serve import Predictor, pad_batch

REPO = pathlib.Path(__file__).resolve().parent
SR = 16000
# data-sheet peaks of one H100 SXM at 700 W (NVIDIA's data sheet, dense rates):
# bf16 on the tensor cores, fp32 on the CUDA cores, HBM3 bandwidth
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES_PER_S = 3.35e12
# the smoke's clips: batch 1 (8 clips, padded to 16 s: the packed kernel)
# and batch 2 (2 clips, padded to 26 s: the flash kernel); the Predictor
# sorts by length, so extract() on all ten clips runs exactly these batches
BATCH1_SECONDS = (2.0, 3.5, 5.0, 6.5, 8.0, 10.0, 12.5, 15.0)
BATCH2_SECONDS = (21.0, 26.0)
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}  # kernel vs plain, unit-normal inputs
MODEL_FP32_TOL = 1e-3     # per layer, card vs CPU, fp32
MODEL_BF16_REL_TOL = 5e-2  # ||bf16 - fp32|| / ||fp32|| per clip, final layer


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def time_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median of ``reps`` CUDA-event timings of one call each."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def frames(spec, seconds) -> torch.Tensor:
    return output_lengths(spec, torch.tensor([int(s * SR) for s in seconds]))


# ---------------------------------------------------------------------------
# Phase 1: the card and the build
# ---------------------------------------------------------------------------


def phase_card() -> str:
    smi = nvidia_smi()
    print(smi, flush=True)
    emit({"phase": "card", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})
    shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)  # build from the sources
    t0 = time.perf_counter()
    _build.build(["attention_fwd"])
    seconds = time.perf_counter() - t0
    report = _build.build_reports["attention_fwd"]["ptxas"]
    kernels = []
    for dt, d, regs in re.findall(
        r"Function properties for \S*attention_fwd_kernelI(13__nv_bfloat16|f)Li(\d+)E\S*\n"
        r".*?\nptxas info\s+: Used (\d+) registers", report, flags=re.S,
    ):
        d = int(d)
        kernels.append({
            "dtype": "bfloat16" if dt != "f" else "float32", "head_dim": d,
            "registers": int(regs),
            # all shared memory is dynamic: sQ, sK, sV and sP tiles in fp32
            "dynamic_smem_bytes": 4 * (2 * 64 * (d + 1) + 64 * d + 64 * 65),
        })
    check(len(kernels) == 4, f"expected 4 kernel instantiations, got {len(kernels)}")
    emit({"phase": "build", "source": "dphubert_torch/csrc/attention_fwd.cu",
          "seconds": seconds, "ptxas": kernels,
          "spill_stores_bytes": sorted({int(x) for x in re.findall(r"(\d+) bytes spill stores", report)})})
    return smi


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def attention_bound_ms(B, L, H, D, lengths, dtype, extra_out_bytes=0):
    """Least time for the work these inputs need: q and out over all rows,
    k and v over the valid keys only; 4*D operations per (query, valid key)
    and head (QK^T and PV).  A row of length 0 averages over all L keys."""
    es = torch.tensor([], dtype=dtype).element_size()
    kv = [int(n) if int(n) > 0 else L for n in lengths.tolist()]
    flops = 4.0 * H * D * L * sum(kv)
    nbytes = (2 * B * L + 2 * sum(kv)) * H * D * es + 4 * B + extra_out_bytes
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def key_mask(lengths, L):
    """(B, 1, 1, L) boolean mask for scaled_dot_product_attention."""
    return (torch.arange(L, device=lengths.device)[None, :] < lengths[:, None])[:, None, None, :]


def phase_kernels(spec) -> dict:
    results = {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    H, D = 12, 64
    scale = D ** -0.5
    for name, seconds, T in (
        ("packed_attention_fwd", BATCH1_SECONDS, 16 * SR),
        ("flash_attention_fwd", BATCH2_SECONDS, 26 * SR),
    ):
        lengths = frames(spec, seconds).to(torch.int32).cuda()
        B = len(seconds)
        L = int(output_lengths(spec, torch.tensor([T]))[0])
        for dtype in (torch.float32, torch.bfloat16):
            qkv = torch.randn(B, L, 3 * H * D, device="cuda", generator=gen).to(dtype)
            q, k, v = qkv.split(H * D, dim=-1)

            def heads(t):
                return t.view(B, L, H, D).transpose(1, 2)

            qh, kh, vh = heads(q), heads(k), heads(v)
            mask = key_mask(lengths, L)
            with torch.inference_mode():
                if name == "packed_attention_fwd":
                    run = lambda: packed_attention(q, k, v, lengths, num_heads=H, scale=scale)
                    plain = lambda: packed_attention_reference(q, k, v, lengths, num_heads=H, scale=scale)
                    got, want = run(), plain()
                    torch.cuda.synchronize()
                    err = (got.float() - want.float()).abs().max().item()
                    extra = {}
                    bound, by = attention_bound_ms(B, L, H, D, lengths, dtype)
                else:
                    run = lambda: flash_attention(qh, kh, vh, lengths, scale=scale)
                    plain = lambda: flash_attention_reference(qh, kh, vh, lengths, scale=scale)
                    (got, m, l), (want, rm, rl) = run(), plain()
                    torch.cuda.synchronize()
                    err = (got.float() - want.float()).abs().max().item()
                    extra = {"m_max_abs_err": (m - rm).abs().max().item(),
                             "l_max_rel_err": ((l - rl).abs() / rl).max().item()}
                    check(extra["m_max_abs_err"] <= 1e-4, f"{name} m disagrees: {extra}")
                    check(extra["l_max_rel_err"] <= 1e-4, f"{name} l disagrees: {extra}")
                    bound, by = attention_bound_ms(
                        B, L, H, D, lengths, dtype, extra_out_bytes=2 * 4 * B * H * L)
                check(bool(torch.isfinite(got.float()).all()), f"{name} {dtype}: non-finite output")
                check(err <= TOL[dtype], f"{name} {dtype}: max abs err {err} > {TOL[dtype]}")
                ms = time_ms(run)
                plain_ms = time_ms(plain)
                library_ms = time_ms(lambda: F.scaled_dot_product_attention(
                    qh, kh, vh, attn_mask=mask, scale=scale))
            row = {"phase": "kernel", "name": name, "dtype": str(dtype).split(".")[-1],
                   "shape_BLHD": [B, L, H, D], "lengths": lengths.tolist(),
                   "max_abs_err": err, "tolerance": TOL[dtype], **extra,
                   "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                   "bound_ms": bound, "bound_by": by}
            emit(row)
            results[(name, dtype)] = row
    return results


# ---------------------------------------------------------------------------
# Phases 3 and 4: the slice through the Predictor
# ---------------------------------------------------------------------------


def expected_launches(spec, L: int) -> dict:
    counts = {"packed_attention_fwd": 0, "flash_attention_fwd": 0}
    for layer in spec.layers:
        if layer.attention is not None:
            route = attention_route(L, layer.attention.num_heads, layer.attention.head_dim)
            counts[f"{route}_attention_fwd"] += 1
    return counts


def launch_counts() -> dict:
    return {"packed_attention_fwd": packed_attention.launches,
            "flash_attention_fwd": flash_attention.launches}


def reset_launch_counts() -> None:
    packed_attention.launches = 0
    flash_attention.launches = 0


def per_layer_card_vs_cpu(model, cpu_model, clips) -> float:
    batch, lengths = pad_batch(clips, 32000)
    wave, lens = torch.from_numpy(batch), torch.from_numpy(lengths)
    with torch.inference_mode():
        card, card_lens = model.extract_features(wave.cuda(), lens.cuda())
        cpu, cpu_lens = cpu_model.extract_features(wave, lens)
    check(torch.equal(card_lens.cpu(), cpu_lens), "card and CPU lengths differ")
    errs = [(a.cpu() - b).abs().max().item() for a, b in zip(card, cpu)]
    check(max(errs) <= MODEL_FP32_TOL, f"fp32 card vs CPU per layer: {errs}")
    return max(errs)


def phase_slice(label: str, model) -> dict:
    spec = model.spec
    rng = np.random.default_rng(0)
    clips1 = [(0.1 * rng.standard_normal(int(s * SR))).astype(np.float32) for s in BATCH1_SECONDS]
    clips2 = [(0.1 * rng.standard_normal(int(s * SR))).astype(np.float32) for s in BATCH2_SECONDS]
    clips = clips1 + clips2
    audio_seconds = sum(len(c) for c in clips) / SR
    preds = {dt: Predictor(model, dtype=dt) for dt in (torch.bfloat16, torch.float32)}

    # launch counts per batch, from the routing rule
    counts = {}
    for batch, T in ((clips1, 16 * SR), (clips2, 26 * SR)):
        L = int(output_lengths(spec, torch.tensor([T]))[0])
        want = expected_launches(spec, L)
        before = launch_counts()
        preds[torch.bfloat16].extract(batch)
        torch.cuda.synchronize()
        grew = {k: v - before[k] for k, v in launch_counts().items()}
        check(grew == want, f"{label} L={L}: launches {grew}, expected {want}")
        counts[f"L={L}"] = grew

    # correctness: fp32 card vs CPU per layer, on a short and a long pair
    cpu_model = copy.deepcopy(model).to("cpu")
    err_short = per_layer_card_vs_cpu(model, cpu_model, clips1[:2])
    err_long = per_layer_card_vs_cpu(model, cpu_model, clips2)
    del cpu_model

    # bf16 against fp32 on the card, all clips
    out = {dt: p.extract(clips) for dt, p in preds.items()}
    rel = []
    for c, a, b in zip(clips, out[torch.bfloat16], out[torch.float32]):
        n = int(output_lengths(spec, torch.tensor([len(c)]))[0])
        check(a.shape == b.shape == (n, spec.embed_dim), f"{label}: shape {a.shape}, {b.shape}")
        check(np.isfinite(a).all() and np.isfinite(b).all(), f"{label}: non-finite features")
        rel.append(float(np.linalg.norm(a - b) / np.linalg.norm(b)))
    check(max(rel) <= MODEL_BF16_REL_TOL, f"{label}: bf16 vs fp32 relative errors {rel}")

    # throughput: median over segments of two extract() calls on all clips
    rates = {}
    for dt, p in preds.items():
        p.extract(clips)  # warm
        seg = []
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(2):
                p.extract(clips)
            seg.append(2 * audio_seconds / (time.perf_counter() - t0))
        rates[str(dt).split(".")[-1]] = {"audio_sec_per_s": statistics.median(seg),
                                         "segments": seg}
    row = {"phase": "slice", "model": label, "clips_seconds": list(BATCH1_SECONDS + BATCH2_SECONDS),
           "audio_seconds_per_extract": audio_seconds, "launches_per_batch": counts,
           "fp32_card_vs_cpu_max_abs": {"short_pair": err_short, "long_pair": err_long},
           "fp32_tol": MODEL_FP32_TOL, "bf16_vs_fp32_rel": max(rel),
           "bf16_rel_tol": MODEL_BF16_REL_TOL, "extract": rates}
    emit(row)
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    smi = phase_card()
    base = pt.hubert_base(device="cuda", generator=torch.Generator().manual_seed(0))
    kernels = phase_kernels(base.spec)

    # the main path: HuBERT Base served in bf16 and fp32
    reset_launch_counts()
    phase_slice("hubert_base", base)
    main_launches = launch_counts()
    del base

    cfg = json.loads((REPO / "docs" / "pruned_config_r2.json").read_text())
    reset_launch_counts()
    student = pt.wav2vec2_model(device="cuda", generator=torch.Generator().manual_seed(1), **cfg)
    phase_slice("pruned_config_r2", student)
    emit({"phase": "pruned_student_launches", **launch_counts()})

    for name, n in main_launches.items():
        check(n > 0, f"{name} was not launched on the main path")
    replaces = {
        "packed_attention_fwd": "dphubert_tpu/ops/packed_attention.py:243",
        "flash_attention_fwd": "dphubert_tpu/ops/flash_attention.py:160",
    }
    line = []
    for name in ("packed_attention_fwd", "flash_attention_fwd"):
        r = kernels[(name, torch.bfloat16)]
        line.append({
            "name": name, "route": "cuda", "source": "dphubert_torch/csrc/attention_fwd.cu",
            "replaces": replaces[name], "launches": main_launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "dtype": "bfloat16",
        })
    print(smi, flush=True)
    emit({"kernels": line})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
