#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``dphubert_torch``) on one card.

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 chip_smoke.py

It builds the CUDA kernels from ``dphubert_torch/csrc/`` with nvcc (one
process per source, started together) and drives both paths of the port at
full width with random weights from seeds:

* serving: HuBERT Base and the pruned student of
  ``docs/pruned_config_r2.json`` through the ``Predictor``;
* training: the HuBERT Base stage-1 distill step (teacher ``hubert_base``,
  student ``hubert_base`` with all five prune flags, ``DistillConfig``
  defaults) through ``init_train_state`` / ``make_train_step``, in bf16 at
  B = 16 clips of 15 s with dropout on; before that, one step's loss,
  metrics and every parameter's gradient are held card against CPU in fp32
  and bf16 against fp32 on the card (dropout off, the same injected gates).

Every kernel is held against its plain PyTorch version on the card at the
shapes its path gives it, timed beside its bound and a library call, and
each path is checked to have gone through its kernels (launch counts, set
to 0 just before the path and read just after).  Each phase prints JSON
lines; any failure raises and the script exits non-zero.  The last three
lines are the card's name and power limit as nvidia-smi prints them, the
kernels line, and ``{"ok": true, "device": {...}}``.  It takes 60-90 s on an
H100 (build about 10 s, kernel checks, both paths).

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
from dphubert_torch.models.gates import gate_paths
from dphubert_torch.models.hardconcrete import EPS
from dphubert_torch.ops import _build
from dphubert_torch.ops.flash_attention import flash_attention, flash_attention_reference
from dphubert_torch.ops.packed_attention import (
    _launch_fwd,
    packed_attention,
    packed_attention_bwd_dkv,
    packed_attention_bwd_dq,
    packed_attention_bwd_reference,
    packed_attention_reference,
)
from dphubert_torch.params import unflatten_params
from dphubert_torch.serve import Predictor, pad_batch
from dphubert_torch.train import (
    DistillConfig,
    init_train_state,
    make_grad_fn,
    make_train_step,
)

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
# every kernel vs its plain version, unit-normal inputs: max abs error <=
# REL_TOL * max |plain|.  fp32 differs in summation order only; bf16 also in
# the rounding of p and of the outputs to bf16, and one bf16 ulp is at most
# 2**-7 of a value, so 2e-2 allows two ulps at the largest output (measured:
# one ulp).  The fp32 forward with dropout also pins the device hash: one
# flipped mask bit moves an output by about p * |v| / 0.9, some 1e-3 here.
REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
MODEL_FP32_TOL = 1e-3     # per layer, card vs CPU, fp32
MODEL_BF16_REL_TOL = 5e-2  # ||bf16 - fp32|| / ||fp32|| per clip, final layer
# training: the bench's batch (B = 16 clips of 15 s: L = 749 frames)
TRAIN_B, TRAIN_SECONDS = 16, 15.0
DROPOUT = 0.1  # HuBERT Base's attention dropout
SEED = 20250101  # the kernel rows' dropout seed
# one distill step, card vs CPU in fp32 (TF32 off): metrics within 1e-4
# relative (+1e-6), every gradient within 1e-3 of its norm, or within 1e-6 of
# the global norm where the gradient is 0 (the key biases: softmax ignores a
# constant added to a row's scores); bf16 vs fp32 on the card: loss within
# 2e-2 relative, the cosine of all gradients >= 0.99
TRAIN_FP32_METRIC_TOL = 1e-4
TRAIN_FP32_GRAD_TOL = 1e-3
TRAIN_BF16_LOSS_TOL = 2e-2
TRAIN_BF16_MIN_COS = 0.99
PRUNE_FLAGS = dict(
    extractor_prune_conv_channels=True,
    encoder_prune_attention_heads=True,
    encoder_prune_attention_layer=True,
    encoder_prune_feed_forward_intermediate=True,
    encoder_prune_feed_forward_layer=True,
)
NO_DROPOUT = dict(encoder_projection_dropout=0.0, encoder_attention_dropout=0.0,
                  encoder_ff_interm_dropout=0.0, encoder_dropout=0.0, encoder_layer_drop=0.0)
# the TPU package's ops directory, named for the kernels line only: this
# script imports nothing of that package (its name is spelled in two parts
# so that a search for the package in the port's files finds imports only)
TPU_OPS = "dphubert" + "_tpu/ops"
KERNELS = {  # name -> (source, the TPU kernel it replaces)
    "packed_attention_fwd": ("dphubert_torch/csrc/attention_fwd.cu",
                             f"{TPU_OPS}/packed_attention.py:243"),
    "flash_attention_fwd": ("dphubert_torch/csrc/attention_fwd.cu",
                            f"{TPU_OPS}/flash_attention.py:160"),
    "packed_attention_bwd_dq": ("dphubert_torch/csrc/attention_bwd.cu",
                                f"{TPU_OPS}/packed_attention.py:322"),
    "packed_attention_bwd_dkv": ("dphubert_torch/csrc/attention_bwd.cu",
                                 f"{TPU_OPS}/packed_attention.py:339"),
}


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


def dtype_name(dtype) -> str:
    return str(dtype).split(".")[-1]


# ---------------------------------------------------------------------------
# Phase 1: the card and the build
# ---------------------------------------------------------------------------


def _smem_bytes(kernel: str, d: int) -> int:
    """Dynamic shared memory of an instantiation (all fp32 tiles)."""
    tile = 64 * (d + 1)
    return 4 * {
        "attention_fwd_kernel": 2 * tile + 64 * d + 64 * 65,
        "attention_bwd_dq_kernel": 4 * tile + 64 * 65 + 192,
        "attention_bwd_dkv_kernel": 4 * tile + 2 * 64 * 65 + 192,
    }[kernel]


def _ptxas(report: str):
    """(kernel, dtype, head_dim, registers, spill bytes) per instantiation."""
    rows = []
    for block in report.split("Compiling entry function")[1:]:
        name = re.search(r"(attention_fwd_kernel|attention_bwd_dq_kernel|"
                         r"attention_bwd_dkv_kernel)I(13__nv_bfloat16|f)Li(\d+)E", block)
        regs = re.search(r"Used (\d+) registers", block)
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", block)
        kernel, d = name.group(1), int(name.group(3))
        rows.append({
            "kernel": kernel, "dtype": "float32" if name.group(2) == "f" else "bfloat16",
            "head_dim": d, "registers": int(regs.group(1)),
            "spill_stores_bytes": int(spills.group(1)), "spill_loads_bytes": int(spills.group(2)),
            "dynamic_smem_bytes": _smem_bytes(kernel, d),
        })
    return rows


def phase_card() -> str:
    smi = nvidia_smi()
    print(smi, flush=True)
    emit({"phase": "card", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})
    shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)  # build from the sources
    t0 = time.perf_counter()
    _build.build(["attention_fwd", "attention_bwd"])
    seconds = time.perf_counter() - t0
    for name, count in (("attention_fwd", 4), ("attention_bwd", 8)):
        rows = _ptxas(_build.build_reports[name]["ptxas"])
        check(len(rows) == count, f"{name}: expected {count} instantiations, got {len(rows)}")
        emit({"phase": "build", "source": f"dphubert_torch/csrc/{name}.cu",
              "seconds": _build.build_reports[name]["seconds"], "ptxas": rows})
    emit({"phase": "build", "wall_seconds_both": seconds})
    return smi


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def _bound(flops: float, nbytes: float, dtype):
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def _valid_keys(lengths, B: int, L: int):
    if lengths is None:
        return [L] * B
    return [int(n) if int(n) > 0 else L for n in lengths.tolist()]


def attention_bound_ms(B, L, H, D, lengths, dtype, extra_out_bytes=0):
    """Least time for the forward's work on these inputs: q and out over
    all rows, k and v over the valid keys only; 4*D operations per (query,
    valid key) and head (QK^T and PV).  A row of length 0 averages over all
    L keys."""
    es = torch.tensor([], dtype=dtype).element_size()
    kv = _valid_keys(lengths, B, L)
    flops = 4.0 * H * D * L * sum(kv)
    nbytes = (2 * B * L + 2 * sum(kv)) * H * D * es + 4 * B + extra_out_bytes
    return _bound(flops, nbytes, dtype)


def backward_bound_ms(kind, B, L, H, D, lengths, dtype):
    """dq: 6*D operations per (query, valid key, head) (S, dP, dQ); reads
    q, out, dout and the valid rows of k, v, plus m and l; writes dq and di.
    dkv: 8*D (S, dP, dV, dK); reads q, dout, the valid rows of k, v, and m,
    l, di; writes dk and dv."""
    es = torch.tensor([], dtype=dtype).element_size()
    kv = sum(_valid_keys(lengths, B, L))
    rows, stats = B * L * H * D * es, B * H * L * 4
    if kind == "dq":
        flops = 6.0 * H * D * L * kv
        nbytes = 3 * rows + 2 * kv * H * D * es + 2 * stats + rows + stats
    else:
        flops = 8.0 * H * D * L * kv
        nbytes = 2 * rows + 2 * kv * H * D * es + 3 * stats + 2 * rows
    return _bound(flops, nbytes + 4 * B, dtype)


def rel_error(got, want, what: str, dtype) -> dict:
    """Max abs error of ``got`` against the plain ``want``, checked
    against ``REL_TOL[dtype] * max |want|``; ``got`` must be finite."""
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    check(bool(torch.isfinite(got.float()).all()), f"{what}: non-finite output")
    check(err <= REL_TOL[dtype] * scale,
          f"{what}: max abs err {err} > {REL_TOL[dtype]} x max |plain| {scale}")
    return {"max_abs_err": err, "max_abs_plain": scale,
            "tolerance": f"{REL_TOL[dtype]} x max |plain|"}


def key_mask(lengths, L):
    """(B, 1, 1, L) boolean mask for scaled_dot_product_attention."""
    return (torch.arange(L, device=lengths.device)[None, :] < lengths[:, None])[:, None, None, :]


def phase_kernels(spec) -> dict:
    """The serving path's forward kernels at the shapes of its two batches."""
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
                    extra = {}
                    bound, by = attention_bound_ms(B, L, H, D, lengths, dtype)
                else:
                    run = lambda: flash_attention(qh, kh, vh, lengths, scale=scale)
                    plain = lambda: flash_attention_reference(qh, kh, vh, lengths, scale=scale)
                    (got, m, l), (want, rm, rl) = run(), plain()
                    torch.cuda.synchronize()
                    extra = {"m_max_abs_err": (m - rm).abs().max().item(),
                             "l_max_rel_err": ((l - rl).abs() / rl).max().item()}
                    check(extra["m_max_abs_err"] <= 1e-4, f"{name} m disagrees: {extra}")
                    check(extra["l_max_rel_err"] <= 1e-4, f"{name} l disagrees: {extra}")
                    bound, by = attention_bound_ms(
                        B, L, H, D, lengths, dtype, extra_out_bytes=2 * 4 * B * H * L)
                errs = rel_error(got, want, f"{name} {dtype}", dtype)
                ms = time_ms(run)
                plain_ms = time_ms(plain)
                library_ms = time_ms(lambda: F.scaled_dot_product_attention(
                    qh, kh, vh, attn_mask=mask, scale=scale))
            row = {"phase": "kernel", "path": "serve", "name": name, "dtype": dtype_name(dtype),
                   "shape_BLHD": [B, L, H, D], "lengths": lengths.tolist(),
                   **errs, **extra,
                   "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                   "bound_ms": bound, "bound_by": by}
            emit(row)
            results[(name, dtype)] = row
    return results


def _train_shape_cases(spec):
    """(label, B, L, lengths): the distill step's shape (no lengths, as the
    training batches) and the serving path's masked batch 1."""
    L_train = int(frames(spec, [TRAIN_SECONDS])[0])
    L_masked = int(output_lengths(spec, torch.tensor([16 * SR]))[0])
    masked = frames(spec, BATCH1_SECONDS).to(torch.int32).cuda()
    return [("train", TRAIN_B, L_train, None), ("masked", len(BATCH1_SECONDS), L_masked, masked)]


def phase_train_kernels(spec) -> dict:
    """The training path's kernels against their plain versions: the
    forward with dropout 0.1, dq and dkv, at the distill step's shape and at
    a masked shape, in fp32 and bf16."""
    results = {}
    gen = torch.Generator(device="cuda").manual_seed(1)
    H, D = 12, 64
    scale = D ** -0.5
    seed = torch.tensor([SEED], dtype=torch.int32, device="cuda")
    kw = dict(num_heads=H, scale=scale, dropout_rate=DROPOUT, seed=seed)
    for label, B, L, lengths in _train_shape_cases(spec):
        for dtype in (torch.float32, torch.bfloat16):
            qkv = torch.randn(B, L, 3 * H * D, device="cuda", generator=gen).to(dtype)
            dout = torch.randn(B, L, H * D, device="cuda", generator=gen).to(dtype)
            q, k, v = qkv.split(H * D, dim=-1)

            def heads(t):
                return t.view(B, L, H, D).transpose(1, 2)

            mask = None if lengths is None else key_mask(lengths, L)
            common = {"path": "train", "case": label, "dtype": dtype_name(dtype),
                      "shape_BLHD": [B, L, H, D],
                      "lengths": None if lengths is None else lengths.tolist(),
                      "dropout": DROPOUT}
            with torch.no_grad():
                out, m, l = _launch_fwd(q, k, v, lengths, seed, H, scale, DROPOUT, stats=True)
                want = packed_attention_reference(q, k, v, lengths, **kw)
                torch.cuda.synchronize()
                errs = rel_error(out, want, f"fwd {label} {dtype}", dtype)
                bound, by = attention_bound_ms(B, L, H, D, lengths, dtype)
                row = {"phase": "kernel", "name": "packed_attention_fwd", **common, **errs,
                       "ms": time_ms(lambda: packed_attention(q, k, v, lengths, **kw)),
                       "plain_ms": time_ms(lambda: packed_attention_reference(q, k, v, lengths, **kw),
                                           reps=5),
                       "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                           heads(q), heads(k), heads(v), attn_mask=mask, dropout_p=DROPOUT,
                           scale=scale)),
                       "library": "scaled_dot_product_attention forward, dropout_p=0.1",
                       "bound_ms": bound, "bound_by": by}
                emit(row)
                results[("packed_attention_fwd", label, dtype)] = row

                dq, di = packed_attention_bwd_dq(q, k, v, out, dout, m, l, lengths, **kw)
                dk, dv = packed_attention_bwd_dkv(q, k, v, out, dout, m, l, di, lengths, **kw)
                plain_bwd = lambda: packed_attention_bwd_reference(q, k, v, out, dout, lengths, **kw)
                wq, wk, wv = plain_bwd()
                torch.cuda.synchronize()
                plain_ms = time_ms(plain_bwd, reps=5)
            # the library's backward: scaled_dot_product_attention without
            # dropout on the same inputs, dq, dk and dv together
            x = qkv.detach().requires_grad_()
            xq, xk, xv = x.split(H * D, dim=-1)
            y = F.scaled_dot_product_attention(heads(xq), heads(xk), heads(xv), attn_mask=mask,
                                               scale=scale)
            dy = heads(dout)
            library_ms = time_ms(lambda: torch.autograd.grad(y, x, dy, retain_graph=True))
            del x, y
            for name, pairs, kind in (("packed_attention_bwd_dq", (("dq", dq, wq),), "dq"),
                                      ("packed_attention_bwd_dkv",
                                       (("dk", dk, wk), ("dv", dv, wv)), "dkv")):
                errs = {what: rel_error(got, ref, f"{what} {label} {dtype}", dtype)
                        for what, got, ref in pairs}
                if kind == "dq":
                    run = lambda: packed_attention_bwd_dq(q, k, v, out, dout, m, l, lengths, **kw)
                else:
                    run = lambda: packed_attention_bwd_dkv(q, k, v, out, dout, m, l, di, lengths, **kw)
                bound, by = backward_bound_ms(kind, B, L, H, D, lengths, dtype)
                row = {"phase": "kernel", "name": name, **common,
                       "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
                       "by_output": errs, "tolerance": f"{REL_TOL[dtype]} x max |plain|",
                       "ms": time_ms(run), "plain_ms": plain_ms,
                       "plain": "packed_attention_bwd_reference (dq, dk and dv together)",
                       "library_ms": library_ms,
                       "library": "scaled_dot_product_attention backward without dropout "
                                  "(dq, dk and dv together)",
                       "bound_ms": bound, "bound_by": by}
                emit(row)
                results[(name, label, dtype)] = row
            del qkv, dout, out, m, l, dq, dk, dv, di, wq, wk, wv
            torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# Phases 3 and 4: serving through the Predictor
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
            "flash_attention_fwd": flash_attention.launches,
            "packed_attention_bwd_dq": packed_attention_bwd_dq.launches,
            "packed_attention_bwd_dkv": packed_attention_bwd_dkv.launches}


def reset_launch_counts() -> None:
    for fn in (packed_attention, flash_attention, packed_attention_bwd_dq,
               packed_attention_bwd_dkv):
        fn.launches = 0


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
        grew = {k: launch_counts()[k] - before[k] for k in want}
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
        rates[dtype_name(dt)] = {"audio_sec_per_s": statistics.median(seg), "segments": seg}
    row = {"phase": "slice", "model": label, "clips_seconds": list(BATCH1_SECONDS + BATCH2_SECONDS),
           "audio_seconds_per_extract": audio_seconds, "launches_per_batch": counts,
           "fp32_card_vs_cpu_max_abs": {"short_pair": err_short, "long_pair": err_long},
           "fp32_tol": MODEL_FP32_TOL, "bf16_vs_fp32_rel": max(rel),
           "bf16_rel_tol": MODEL_BF16_REL_TOL, "extract": rates}
    emit(row)
    return row


# ---------------------------------------------------------------------------
# Phases 5 and 6: the distill step
# ---------------------------------------------------------------------------


def distill_models(device: str, **kw):
    """Teacher ``hubert_base`` and the gated student (all five prune flags),
    random weights from two seeds."""
    teacher = pt.hubert_base(device=device, generator=torch.Generator().manual_seed(0), **kw)
    student = pt.wav2vec2_model(device=device, generator=torch.Generator().manual_seed(1),
                                **dict(teacher.config, **PRUNE_FLAGS))
    return teacher, student


def gate_draws(spec, student, seed: int) -> dict:
    """Uniform draws for every gate from numpy, in the gates' tree layout."""
    rng = np.random.default_rng(seed)
    params = unflatten_params(dict(student.named_parameters()))
    u: dict = {}
    for gate_path, param_path in gate_paths(spec):
        leaf = params
        for k in param_path:
            leaf = leaf[k]
        node = u
        for k in gate_path[:-1]:
            node = node.setdefault(k, {})
        node[gate_path[-1]] = rng.uniform(EPS, 1.0 - EPS, tuple(leaf.shape)).astype(np.float32)
    return u


def phase_train_check() -> dict:
    """One distill step's loss, metrics and gradients at full width on a
    small batch (2 clips of 2 s, lengths 2 s and 1.5 s), dropout off, the
    same gate draws everywhere: (a) fp32 on the card against the CPU, (b)
    bf16 against fp32 on the card."""
    teacher, student = distill_models("cuda", **NO_DROPOUT)
    u = gate_draws(student.spec, student, seed=3)
    rng = np.random.default_rng(4)
    wave = (0.1 * rng.standard_normal((2, 32000))).astype(np.float32)
    lengths = np.array([32000, 24000], np.int32)
    batch = (wave, lengths)
    out = {}
    for device in ("cuda", "cpu"):
        t = teacher if device == "cuda" else copy.deepcopy(teacher).to("cpu")
        state, _ = init_train_state(student=student, cfg=DistillConfig(),
                                    teacher_embed_dim=768, device=device)
        t0 = time.perf_counter()
        metrics, grads = make_grad_fn(t, DistillConfig())(state, batch, gate_u=u)
        torch.cuda.synchronize()
        out[device] = ({k: v.item() for k, v in metrics.items()},
                       {k: g.detach().cpu() for k, g in grads.items()},
                       time.perf_counter() - t0)
    (mc, gc, sec_c), (mh, gh, sec_h) = out["cuda"], out["cpu"]
    metric_err = {k: abs(mc[k] - mh[k]) / max(abs(mh[k]), 1e-12) for k in mh}
    for k in mh:
        check(np.isfinite(mc[k]), f"train fp32: metric {k} not finite")
        check(abs(mc[k] - mh[k]) <= TRAIN_FP32_METRIC_TOL * abs(mh[k]) + 1e-6,
              f"train fp32 card vs CPU: {k} {mc[k]} vs {mh[k]}")
    global_norm = torch.cat([g.flatten() for g in gh.values()]).double().norm().item()
    grad_err, zero = {}, {}
    for k, g in gh.items():
        norm, diff = g.double().norm().item(), (gc[k] - g).double().norm().item()
        if norm <= 1e-6 * global_norm:
            zero[k] = diff / global_norm
            check(diff <= 1e-6 * global_norm, f"train fp32 card vs CPU: zero gradient of {k}: {diff}")
            continue
        grad_err[k] = diff / norm
        check(diff <= TRAIN_FP32_GRAD_TOL * norm,
              f"train fp32 card vs CPU: gradient of {k}: relative error {grad_err[k]}")
    worst = sorted(grad_err.items(), key=lambda kv: -kv[1])[:3]

    # (b) bf16 against fp32, on the card
    state, _ = init_train_state(student=student, cfg=DistillConfig(), teacher_embed_dim=768,
                                device="cuda")
    cfg16 = DistillConfig(compute_dtype="bfloat16")
    mb, gb = make_grad_fn(teacher, cfg16)(state, batch, gate_u=u)
    mb = {k: v.item() for k, v in mb.items()}
    loss_rel = abs(mb["loss"] - mc["loss"]) / abs(mc["loss"])
    flat16 = torch.cat([gb[k].flatten().cpu() for k in gc]).double()
    flat32 = torch.cat([gc[k].flatten() for k in gc]).double()
    cos = F.cosine_similarity(flat16, flat32, dim=0).item()
    per_param = {k: F.cosine_similarity(gb[k].flatten().cpu().double(), gc[k].flatten().double(),
                                        dim=0).item()
                 for k in grad_err}
    check(loss_rel <= TRAIN_BF16_LOSS_TOL, f"train bf16 vs fp32: loss relative error {loss_rel}")
    check(cos >= TRAIN_BF16_MIN_COS, f"train bf16 vs fp32: gradient cosine {cos}")
    row = {"phase": "train_check", "batch": "2 clips of 2 s, lengths (32000, 24000)",
           "fp32_card_vs_cpu": {"metrics_rel_err_max": max(metric_err.values()),
                                "grad_rel_err_max": worst[0][1], "grad_rel_err_worst3": worst,
                                "n_params": len(gh), "n_zero_grad": len(zero),
                                "zero_grad_err_max_over_global_norm": max(zero.values(), default=0.0),
                                "card_s": sec_c, "cpu_s": sec_h,
                                "metric_tol": TRAIN_FP32_METRIC_TOL,
                                "grad_tol": TRAIN_FP32_GRAD_TOL},
           "bf16_vs_fp32_card": {"loss_rel_err": loss_rel, "grad_cosine": cos,
                                 "grad_cosine_min_per_param": min(per_param.values()),
                                 "loss_tol": TRAIN_BF16_LOSS_TOL,
                                 "min_cos": TRAIN_BF16_MIN_COS},
           "loss_fp32": mc["loss"], "loss_bf16": mb["loss"]}
    emit(row)
    return row


def phase_train(steps_per_segment: int = 3, segments: int = 3) -> dict:
    """The training path: bf16 distill steps at B = 16 x 15 s with dropout
    on (HuBERT Base's rates), DistillConfig defaults, a batch that stays on
    the card (as bench.py).  Launch counts are set to 0 just before the
    measured steps and read just after."""
    teacher, student = distill_models("cuda")
    cfg = DistillConfig(compute_dtype="bfloat16")
    state, tx = init_train_state(student=student, cfg=cfg, teacher_embed_dim=768, seed=5,
                                 device="cuda")
    del student
    step = make_train_step(teacher, cfg, tx)
    gen = torch.Generator(device="cuda").manual_seed(6)
    T = int(TRAIN_SECONDS * SR)
    batch = (torch.randn(TRAIN_B, T, device="cuda", generator=gen), None)
    audio_per_step = TRAIN_B * TRAIN_SECONDS
    torch.cuda.reset_peak_memory_stats()
    history = []
    for _ in range(2):  # warm: cuBLAS / cuDNN plans, allocator
        state, metrics = step(state, batch)
        history.append(metrics)
    torch.cuda.synchronize()
    reset_launch_counts()
    seg = []
    for _ in range(segments):
        t0 = time.perf_counter()
        for _ in range(steps_per_segment):
            state, metrics = step(state, batch)
            history.append(metrics)
        torch.cuda.synchronize()
        seg.append(steps_per_segment * audio_per_step / (time.perf_counter() - t0))
    counts = launch_counts()
    n = steps_per_segment * segments
    peak = torch.cuda.max_memory_allocated()
    per_step = {"packed_attention_fwd": 24, "flash_attention_fwd": 0,
                "packed_attention_bwd_dq": 12, "packed_attention_bwd_dkv": 12}
    check(counts == {k: v * n for k, v in per_step.items()},
          f"train launches {counts} over {n} steps, expected {per_step} per step")
    hist = [{k: v.item() for k, v in m.items()} for m in history]
    for i, m in enumerate(hist):
        for k, v in m.items():
            check(np.isfinite(v), f"train step {i}: {k} = {v}")
    gap = [m["sparsity_expected"] - m["sparsity_target"] for m in hist]
    lam1 = state.lambdas["lambda1"].item()
    # dual ascent: λ1's gradient is (s - t), so λ1 moves with its sign
    check(lam1 != 0.0 and np.sign(lam1) == np.sign(np.mean(gap)),
          f"λ1 = {lam1} after steps with mean s - t = {np.mean(gap)}")
    row = {"phase": "train", "model": "hubert_base teacher, gated hubert_base student",
           "dtype": "bfloat16", "batch": [TRAIN_B, T], "audio_seconds_per_step": audio_per_step,
           "steps_timed": n, "audio_sec_per_s": statistics.median(seg), "segments": seg,
           "step_s": audio_per_step / statistics.median(seg),
           "peak_memory_bytes": peak, "launches": counts,
           "launches_per_step": {k: v / n for k, v in counts.items()},
           "lambda1_final": lam1, "s_minus_t": [gap[0], gap[-1]],
           "loss": [hist[0]["loss"], hist[-1]["loss"]],
           "grad_norm": [hist[0]["grad_norm"], hist[-1]["grad_norm"]]}
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
    train_kernels = phase_train_kernels(base.spec)

    # path 1: HuBERT Base served in bf16 and fp32
    reset_launch_counts()
    phase_slice("hubert_base", base)
    path_launches = {"serve": launch_counts()}
    del base

    cfg = json.loads((REPO / "docs" / "pruned_config_r2.json").read_text())
    reset_launch_counts()
    student = pt.wav2vec2_model(device="cuda", generator=torch.Generator().manual_seed(1), **cfg)
    phase_slice("pruned_config_r2", student)
    emit({"phase": "pruned_student_launches", **launch_counts()})
    del student

    # path 2: the distill step (phase_train resets the counts before its steps)
    phase_train_check()
    train = phase_train()
    path_launches["train"] = train["launches"]

    rows = {
        "packed_attention_fwd": train_kernels[("packed_attention_fwd", "train", torch.bfloat16)],
        "flash_attention_fwd": kernels[("flash_attention_fwd", torch.bfloat16)],
        "packed_attention_bwd_dq": train_kernels[("packed_attention_bwd_dq", "train", torch.bfloat16)],
        "packed_attention_bwd_dkv": train_kernels[("packed_attention_bwd_dkv", "train", torch.bfloat16)],
    }
    line = []
    for name, r in rows.items():
        by_path = {p: c[name] for p, c in path_launches.items() if c[name]}
        check(sum(by_path.values()) > 0, f"{name} was not launched on any path")
        source, replaces = KERNELS[name]
        line.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "dtype": r["dtype"], "shape": r["shape_BLHD"],
        })
    print(smi, flush=True)
    emit({"kernels": line})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
