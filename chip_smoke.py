#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``dphubert_torch``) on one card.

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 chip_smoke.py

It builds the CUDA kernels from ``dphubert_torch/csrc/`` with nvcc (one
process per source, started together) and drives every path of the port at
full width with random weights from seeds:

* serving: HuBERT Base and the pruned student of
  ``docs/pruned_config_r2.json`` through the ``Predictor``;
* the stage-1 distill step (teacher ``hubert_base``, student ``hubert_base``
  with all five prune flags, ``DistillConfig`` defaults) in bf16 at B = 16
  clips of 15 s with dropout on; before that, one step's loss, metrics and
  every parameter's gradient are held card against CPU in fp32 and bf16
  against fp32 on the card (dropout off, the same injected gates);
* the final-distill step (``use_reg=False``) of a student with the head
  counts of ``docs/pruned_config_r2.json`` and every attention sublayer on,
  whose 11- and 9-head layers take the flash route at the loader's top rung
  (L = 780): held card against CPU and bf16 against fp32 as above, then
  timed in bf16 at B = 5 x 15.62 s;
* the four-stage recipe through the port's CLI functions on synthetic WAVs:
  prepare_data, distill (and a deadline stop, exit 76, resumed), prune,
  final_distill of the pruned student and of the r2-heads student,
  save_final_ckpt, and the final checkpoint served;
* DPWavLM: WavLM Base and the pruned WavLM student of
  ``docs/convergence_wavlm_r4_pruned_config.json`` served; the DPWavLM
  stage-1 step (teacher ``wavlm_base``, the gated student) held card
  against CPU and bf16 against fp32 at 2 x 2 s, on the single-KV-block route
  and again on the general route (``DPHUBERT_WAVLM_SINGLE_BLOCK=0``), then
  timed in bf16 at B = 16 x 15 s with dropout on, on the single route and
  then, in the same process with the same seeds, on the general one; and
  the WavLM recipe through the CLIs (stage 1, prune, final distill, export,
  serving);
* the training forward with LayerDrop (``forward(training=True)``) of
  HuBERT Base and WavLM Base, gated, layer_drop 0.1 with layers 3 and 8
  dropped by injected uniforms: fp32 card vs CPU, the dropped layers the
  identity bit for bit, u = 1 the layer_drop 0 forward bit for bit, bf16 vs
  fp32, 12 forward launches a call whatever is dropped, one backward, and
  the bf16 forward timed at B = 8 x 15 s (phase "layerdrop");
* ``dphubert_torch.utils.profiling`` on the stage-1 step: ``trace``
  around 2 steps writes a Chrome trace; ``device_breakdown``'s kernel
  families' shares of the busy time sum to it, and the packed kernels ran
  as counted (phase "profile");
* wav2vec 2.0 Large (``run_large.sh``): a seeded ``wav2vec2_large`` written
  as a fairseq checkpoint and converted back with ``convert_from_fairseq``
  bit for bit, then served; ``wavlm_large`` served; the packed kernels at
  the Large step's shape (12 clips, 16 heads); the Large stage-1 step with
  per-layer remat held against the step without it (fp32, dropout on, the
  same generator seed), then both timed in bf16 at B = 12 x 15 s, and both
  as 4-step CUDA graphs (remat's recomputes replayed inside the graph);
* the recipe script ``run_torch.sh`` itself, on the card, and its exported
  checkpoint served;
* every timed step of the port's main paths (stage 1, the final distill,
  DPWavLM on both routes, wav2vec 2.0 Large without and with remat) also
  as a CUDA graph of 4 steps (``make_train_step(..., steps_per_call=4)``,
  the trainer's ``--steps_per_dispatch 4``): from the same state and generator, two
  replays equal 8 eager steps bit for bit (parameters, moments, counters,
  generator, metrics), both timed in one process, with peak memory
  (phase "graph_train"); on the recipes' ladders (the first, middle and
  top of stage 1's 12 batch shapes at 160 s a batch and of Large's 12 at
  180 s, for the smoke's time) every key captured into the one shared pool
  and replayed in turn, with peak and reserved memory against eager's,
  and two keys interleaved bit for bit eager (phase "graph_keys"); stage
  1 through the CLI on two shapes with 4 groups
  (phase "pipeline_graphs").  Launches count what ran: the wrappers'
  counts, less their counts at captures, plus every counted replay's
  captured launches (``GraphedSteps``'s tally); every kernel entry ran
  inside a replayed graph on at least one path;
* the checkpoint path on the stage-1 state (phase "ckpt"): the synchronous
  write, the background saver's stall and the steps beside its copy and
  its write over 7 saves, rotation, a resume from a background-written
  file bit for bit, and the size gate's decision for the Base and the
  Large state.  The pipelines run with ``--steps_per_dispatch 4
  --ckpt_backend rotated``, ``run_torch.sh``'s defaults;
* data and tensor parallelism: one NCCL rank as a (1 x 1) mesh
  runs the stage-1 step with its gradient all-reduce, eager and as a
  4-step CUDA graph with the all-reduce captured, bit for bit the
  mesh-less step (phase "dp_nccl_world1", with both step times and the
  bytes all-reduced a step); then the same rank with every leaf FSDP
  splits at 2 ranks placed as a block of its data group (all-gathered
  where read, its gradient reduce-scattered, kept out of the all-reduce,
  its norm summed over the group), 12 eager steps and the 4-step graph's
  calls bit for bit those; processes on the card over gloo (this script
  with ``--parallel-rank``; NCCL refuses two ranks on one card) run the
  same step at full width, every rank held against the one-process step
  (loss 1e-3, gradient norm 1e-3, cosines 0.9999), with its step time,
  launches, peak and reserved memory: two in the (1 data x 2 model) and
  (2 data x 1 model) layouts (phase "parallel_card"), in (2 x 1) with
  FSDP and, for DPWavLM Base, in (1 x 2), and four in (2 x 2) with HSDP
  (phase "fsdp_card", with the elements each rank keeps of the split
  leaves); the packed kernels and the seven WavLM entries at the split
  step's 6 heads, (16, 749, 6, 64) (WavLM's with those heads' 6 bias
  rows), against their plain versions (the kernels line's ``tp`` rows).
  NCCL across cards is not run: the machine has one card.

Every kernel (six attention kernels for wav2vec 2.0 / HuBERT, seven for
WavLM's gated-bias attention) is held against its plain PyTorch version on
the card at the shapes its path gives it, timed beside its bound and a
library call (the backward rows beside two: the library's backward without
and with dropout), and the packed, flash and WavLM entries, forward and
backward, give up their dropout mask bit for bit through both bodies (bf16
on the tensor cores, fp32 on the CUDA cores; the rows and the kernels line
name the body, and the build fails if a tensor-core body spills or ptxas
warns about its wgmma), and
each path is checked to have gone through its kernels (launch counts, set
to 0 just before the path and read just after, exactly what the routing
rule predicts).  Each phase prints JSON lines; any failure raises and the
script exits non-zero.  The last three lines are the card's name and power
limit as nvidia-smi prints them, the kernels line, and ``{"ok": true,
"device": {...}}``.  The pipelines' and the Large phases' files go to
``build/smoke_*/`` and are removed at the end.

fp32 on the card is compared at full fp32: TF32 is switched off for matmuls
and cuDNN convolutions below, and the matmul precision is "highest".
Without a CUDA card the script exits with code 1 and prints no result.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import json
import os
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

import dphubert_torch as pt
from dphubert_torch.models.components import attention_route, output_lengths
from dphubert_torch.models.gates import gate_paths, sample_gates
from dphubert_torch.models.hardconcrete import EPS
from dphubert_torch.ops import LAUNCH_COUNTERS, _build
from dphubert_torch.ops.attention_common import kernel_body
from dphubert_torch.ops.mask_readout import backward_mask_readout, forward_mask_readout
from dphubert_torch.cli import convert_from_fairseq as cli_convert_from_fairseq
from dphubert_torch.cli import distill as cli_distill
from dphubert_torch.cli import final_distill as cli_final_distill
from dphubert_torch.cli import load_dpmodel as cli_load_dpmodel
from dphubert_torch.cli import prepare_data as cli_prepare_data
from dphubert_torch.cli import prune as cli_prune
from dphubert_torch.cli import save_final_ckpt as cli_save_final_ckpt
from dphubert_torch.data import load_audio
from dphubert_torch.data.sampler import StaticShapeBatcher
from dphubert_torch.interop.torch_ckpt import load_checkpoint, load_model, save_checkpoint
from dphubert_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_bwd_reference,
    flash_attention_reference,
)
from dphubert_torch.ops.packed_attention import (
    _launch_fwd,
    packed_attention,
    packed_num_groups,
    packed_attention_bwd_dkv,
    packed_attention_bwd_dq,
    packed_attention_bwd_reference,
    packed_attention_reference,
)
from dphubert_torch.ops.wavlm_attention import (
    wavlm_attention,
    wavlm_attention_bwd_dbias,
    wavlm_attention_bwd_dkv,
    wavlm_attention_bwd_dkv_general,
    wavlm_attention_bwd_dq,
    wavlm_attention_bwd_fused,
    wavlm_attention_bwd_reference,
    wavlm_attention_fwd,
    wavlm_attention_fwd_general,
    wavlm_attention_reference,
    wavlm_kernel_body,
    wavlm_route,
)
from dphubert_torch.parallel.dryrun import check_ranks, run_rank, spawn
from dphubert_torch.params import unflatten_params
from dphubert_torch.serve import Predictor, pad_batch
from dphubert_torch.train import (
    DistillConfig,
    init_train_state,
    make_grad_fn,
    make_train_step,
)
from dphubert_torch.train.checkpointing import (
    BackgroundSaver,
    RotatingCheckpointer,
    background_ckpt_fits,
    device_snapshot,
    load_train_state,
    save_train_state,
    snapshot_bytes,
)
from dphubert_torch.train.distill_module import GraphedSteps
from dphubert_torch.utils import device_breakdown, trace

REPO = pathlib.Path(__file__).resolve().parent
SR = 16000
# data-sheet peaks of one H100 SXM at 700 W (NVIDIA's data sheet, dense rates):
# bf16 on the tensor cores, fp32 on the CUDA cores, HBM3 bandwidth
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES_PER_S = 3.35e12
# the kernels' finite mask value, for the library call's materialised mask
NEG_INF_MASK = -0.7 * float(np.finfo(np.float32).max)
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
    "flash_attention_bwd_dq": ("dphubert_torch/csrc/attention_bwd.cu",
                               f"{TPU_OPS}/flash_attention.py:444"),
    "flash_attention_bwd_dkv": ("dphubert_torch/csrc/attention_bwd.cu",
                                f"{TPU_OPS}/flash_attention.py:402"),
    "wavlm_attention_fwd": ("dphubert_torch/csrc/wavlm_attention.cu",
                            f"{TPU_OPS}/wavlm_attention.py:216"),
    "wavlm_attention_bwd_dkv": ("dphubert_torch/csrc/wavlm_attention.cu",
                                f"{TPU_OPS}/wavlm_attention.py:642"),
    "wavlm_attention_bwd_fused": ("dphubert_torch/csrc/wavlm_attention.cu",
                                  f"{TPU_OPS}/wavlm_attention.py:679"),
    "wavlm_attention_fwd_general": ("dphubert_torch/csrc/wavlm_attention.cu",
                                    f"{TPU_OPS}/wavlm_attention.py:268"),
    "wavlm_attention_bwd_dkv_general": ("dphubert_torch/csrc/wavlm_attention.cu",
                                        f"{TPU_OPS}/wavlm_attention.py:766"),
    "wavlm_attention_bwd_dq": ("dphubert_torch/csrc/wavlm_attention.cu",
                               f"{TPU_OPS}/wavlm_attention.py:805"),
    "wavlm_attention_bwd_dbias": ("dphubert_torch/csrc/wavlm_attention.cu",
                                  f"{TPU_OPS}/wavlm_attention.py:844"),
}
WRAPPERS = LAUNCH_COUNTERS  # name -> the wrapper whose ``launches`` counts it
# the loader's top rung (cli/common.py: rungs from 32,000 to 250,000
# samples, 12 shapes): every clip of 249,920 to 250,000 samples lands there,
# is cropped to 249,920 (15.62 s, L = 780 frames) and batched 5 to a batch
# at the default 87.5 s per batch; longer clips are dropped by max_len
TOP_RUNG = 249_920
FINAL_B = 5
R2_CONFIG = REPO / "docs" / "pruned_config_r2.json"
WAVLM_PRUNED_CONFIG = REPO / "docs" / "convergence_wavlm_r4_pruned_config.json"
WAVLM_GENERAL_BLOCK_KV = 128  # an explicit block_kv < Lp: the general route
# run_large.sh's stage 1: wav2vec 2.0 Large (24 layers, 1024 wide, 16 heads
# of 64), six distill groups, B = 12 clips of 15 s (180 s a batch)
LARGE_B = 12
LARGE_GROUPS = ((0,), (4, 8, 12, 16, 20, 24))
LARGE_HEADS = 16
LARGE_DIR = REPO / "build" / "smoke_large"
# remat against plain, fp32 on the card, the same generator seed: every
# gradient within 1e-4 of its norm (a dropout mask replayed wrongly moves one
# by O(1); the two differ only where cuDNN's backward sums in another order)
REMAT_GRAD_TOL = 1e-4
GRAPH_K = 4  # steps a dispatch on the graph paths (run_torch.sh's default)
# the graph phases' timing, in turns with eager groups: segments of replays
# (few: the smoke's time)
GRAPH_TIMED_SEGMENTS, GRAPH_TIMED_REPLAYS = 2, 2


def r2_all_attention_config() -> dict:
    """``docs/pruned_config_r2.json`` with every attention sublayer kept:
    its head counts (12, 12, 12, 12, 12, 12, 11, 12, 8, 10, 10, 9) are the
    irregular ones a pruned student gets, but the file itself switches
    attention off in layers 4-9 and 11, so as it stands no layer of it
    takes the flash route.  With every sublayer on, layers 6 (11 heads) and
    11 (9 heads) do at L = 780."""
    cfg = json.loads(R2_CONFIG.read_text())
    cfg["encoder_use_attention"] = [True] * cfg["encoder_num_layers"]
    return cfg


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


# the tensor-core bodies (bf16, D = 64), 8192-byte bf16 tiles and 1024 bytes
# to align the base: the forward's resident Q tile and a two-stage ring of
# K and V (csrc/attention_fwd_wgmma.cuh, also WavLM's forward); the backward's two resident tiles, the
# same ring, and m, l and di of 64 rows (one set in dq, one a stage in dkv;
# csrc/attention_bwd_wgmma.cuh); WavLM's dq and dkv as those with the gate
# beside m, l and di (dkv also a 64 x 68 fp32 bias tile), and its dbias
# body's two-stage ring of Q, dO, K, V and the four statistics
# (csrc/wavlm_attention_wgmma.cuh)
WGMMA_SMEM_BYTES = {"attention_fwd_wgmma_kernel": 5 * 8192 + 1024,
                    "wavlm_fwd_wgmma_kernel": 5 * 8192 + 1024,
                    "attention_bwd_dq_wgmma_kernel": 6 * 8192 + 768 + 1024,
                    "attention_bwd_dkv_wgmma_kernel": 6 * 8192 + 2 * 768 + 1024,
                    "wavlm_bwd_dq_wgmma_kernel": 6 * 8192 + 1024 + 1024,
                    "wavlm_bwd_dbias_wgmma_kernel": 2 * (4 * 8192 + 1024) + 1024,
                    "wavlm_bwd_dkv_wgmma_kernel": 6 * 8192 + 2 * 1024 + 64 * 68 * 4 + 1024}


def _smem_bytes(kernel: str, d: int) -> int:
    """Dynamic shared memory of an instantiation (all fp32 tiles but the
    tensor-core bodies'); for the WavLM dq side without its dbias strip,
    which adds 128 bytes per 32-row x column (ceil64(L) + 8 columns in the
    fused entry, 72 in the dbias one)."""
    if kernel in WGMMA_SMEM_BYTES:
        return WGMMA_SMEM_BYTES[kernel]
    tile = 64 * (d + 1)
    return 4 * {
        "attention_fwd_kernel": 2 * tile + 64 * d + 64 * 65,
        "attention_bwd_dq_kernel": 4 * tile + 64 * 65 + 192,
        "attention_bwd_dkv_kernel": 4 * tile + 2 * 64 * 65 + 192,
        "wavlm_fwd_kernel": 2 * tile + 64 * d + 64 * 65,
        "wavlm_dkv_kernel": 4 * tile + 2 * 64 * 65 + 256,
        "wavlm_bwd_q_kernel": tile + 2 * 64 * (d + 1) + 32 * 65 + 128,
    }[kernel]


def _ptxas(report: str):
    """(kernel, body, dtype, head_dim, registers, spill bytes) per
    instantiation; the WavLM dq-side body also names its (dq, dbias)
    switches.  The tensor-core bodies are not templates: bf16 at D = 64."""
    rows = []
    for block in report.split("Compiling entry function")[1:]:
        name = re.search(r"(attention_fwd_kernel|attention_bwd_dq_kernel|"
                         r"attention_bwd_dkv_kernel|wavlm_fwd_kernel|wavlm_dkv_kernel|"
                         r"wavlm_bwd_q_kernel)I(13__nv_bfloat16|f)Li(\d+)E(?:Lb(\d)ELb(\d)E)?",
                         block)
        wgmma = re.search(r"(attention_fwd_wgmma_kernel|attention_bwd_dq_wgmma_kernel|"
                          r"attention_bwd_dkv_wgmma_kernel|wavlm_fwd_wgmma_kernel|"
                          r"wavlm_bwd_dq_wgmma_kernel|wavlm_bwd_dbias_wgmma_kernel|"
                          r"wavlm_bwd_dkv_wgmma_kernel)", block)
        regs = re.search(r"Used (\d+) registers", block)
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", block)
        if wgmma is not None:
            kernel, d, dtype = wgmma.group(1), 64, "bfloat16"
        else:
            kernel, d = name.group(1), int(name.group(3))
            dtype = "float32" if name.group(2) == "f" else "bfloat16"
        row = {
            "kernel": kernel, "body": "wgmma" if wgmma is not None else "fma",
            "dtype": dtype, "head_dim": d, "registers": int(regs.group(1)),
            "spill_stores_bytes": int(spills.group(1)), "spill_loads_bytes": int(spills.group(2)),
            "dynamic_smem_bytes": _smem_bytes(kernel, d),
        }
        if name is not None and name.group(4) is not None:
            row["dq"], row["dbias"] = name.group(4) == "1", name.group(5) == "1"
        rows.append(row)
    return rows


# instantiations per source; wavlm_attention: 15 CUDA-core (fp32 at D = 64
# and 80, bf16 at 80: five each; bf16 at D = 64 reaches none) and the four
# tensor-core bodies
SOURCES = (("attention_fwd", 4), ("attention_bwd", 8), ("wavlm_attention", 19))


def phase_card() -> str:
    smi = nvidia_smi()
    print(smi, flush=True)
    emit({"phase": "card", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})
    shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)  # build from the sources
    t0 = time.perf_counter()
    _build.build([name for name, _ in SOURCES])
    seconds = time.perf_counter() - t0
    for name, count in SOURCES:
        report = _build.build_reports[name]["ptxas"]
        rows = _ptxas(report)
        check(len(rows) == count, f"{name}: expected {count} instantiations, got {len(rows)}")
        for row in rows:
            if row["body"] == "wgmma":
                check(row["spill_stores_bytes"] == row["spill_loads_bytes"] == 0,
                      f"{row['kernel']} spills: {row}")
        # ptxas names the wgmma it serializes ("Potential Performance Loss")
        warnings = [line.strip() for line in report.splitlines() if "wgmma" in line.lower()
                    and "Compiling entry" not in line and "Function properties" not in line]
        check(not warnings, f"{name}: ptxas warns about wgmma: {warnings}")
        emit({"phase": "build", "source": f"dphubert_torch/csrc/{name}.cu",
              "seconds": _build.build_reports[name]["seconds"], "ptxas": rows,
              "wgmma_warnings": warnings})
    emit({"phase": "build", "wall_seconds_all": seconds})
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


def forward_flops(B, L, H, D, lengths) -> float:
    """4*D operations per (query, valid key) and head (QK^T and PV); a row
    of length 0 averages over all L keys."""
    return 4.0 * H * D * L * sum(_valid_keys(lengths, B, L))


def attention_bound_ms(B, L, H, D, lengths, dtype, extra_out_bytes=0):
    """Least time for the forward's work on these inputs: q and out over
    all rows, k and v over the valid keys only; ``forward_flops``."""
    es = torch.tensor([], dtype=dtype).element_size()
    kv = _valid_keys(lengths, B, L)
    nbytes = (2 * B * L + 2 * sum(kv)) * H * D * es + 4 * B + extra_out_bytes
    return _bound(forward_flops(B, L, H, D, lengths), nbytes, dtype)


def backward_flops(kind, B, L, H, D, lengths) -> float:
    """dq: 6*D operations per (query, valid key, head) (S, dP, dQ); dkv:
    8*D (S, dP, dV, dK)."""
    return (6.0 if kind == "dq" else 8.0) * H * D * L * sum(_valid_keys(lengths, B, L))


def backward_bound_ms(kind, B, L, H, D, lengths, dtype):
    """``backward_flops``; bytes: dq reads q, out, dout and the valid rows
    of k, v, plus m and l, and writes dq and di; dkv reads q, dout, the
    valid rows of k, v, and m, l, di, and writes dk and dv."""
    es = torch.tensor([], dtype=dtype).element_size()
    kv = sum(_valid_keys(lengths, B, L))
    rows, stats = B * L * H * D * es, B * H * L * 4
    if kind == "dq":
        nbytes = 3 * rows + 2 * kv * H * D * es + 2 * stats + rows + stats
    else:
        nbytes = 2 * rows + 2 * kv * H * D * es + 3 * stats + 2 * rows
    return _bound(backward_flops(kind, B, L, H, D, lengths), nbytes + 4 * B, dtype)


def library_backward_ms(x, heads, mask, dout, scale):
    """The library's backward on the same inputs (dq, dk and dv together):
    ``scaled_dot_product_attention`` without dropout (``library_ms``, the
    yardstick of the earlier rows) and with dropout_p = 0.1 (like for
    like), as (ms, ms)."""
    times = []
    for p in (0.0, DROPOUT):
        x = x.detach().requires_grad_()
        xq, xk, xv = (heads(t) for t in x.split(x.shape[-1] // 3, dim=-1))
        y = F.scaled_dot_product_attention(xq, xk, xv, attn_mask=mask, dropout_p=p, scale=scale)
        times.append(time_ms(lambda: torch.autograd.grad(y, x, dout, retain_graph=True)))
        del y
    return tuple(times)


BACKWARD_ENTRIES = {"packed": (packed_attention_bwd_dq, packed_attention_bwd_dkv),
                    "flash": (flash_attention_bwd_dq, flash_attention_bwd_dkv)}


def backward_rows(layout, common, dims, args, kw, outputs, plain_ms, library) -> dict:
    """The dq and dkv rows of one case of ``layout``: each output (kernel,
    plain) against the plain version's, the kernel timed with the case's
    dropout (``ms``) and without (``ms_no_dropout``: what the hash costs),
    beside its bound and the library's backward without and with dropout
    (``library``: the pair of ``library_backward_ms``)."""
    B, L, H, D, lengths, dtype = dims
    q, k, v, out, dout, m, l, di = args
    dq_fn, dkv_fn = BACKWARD_ENTRIES[layout]
    calls = {"dq": lambda **o: dq_fn(q, k, v, out, dout, m, l, lengths, **{**kw, **o}),
             "dkv": lambda **o: dkv_fn(q, k, v, out, dout, m, l, di, lengths, **{**kw, **o})}
    rows = {}
    for kind, names in (("dq", ("dq",)), ("dkv", ("dk", "dv"))):
        errs = {w: rel_error(*outputs[w], f"{layout} {w} {common['case']} {dtype}", dtype)
                for w in names}
        bound, by = backward_bound_ms(kind, B, L, H, D, lengths, dtype)
        with torch.no_grad():
            ms = time_ms(calls[kind])
            ms_no_dropout = time_ms(lambda: calls[kind](dropout_rate=0.0))
        name = f"{layout}_attention_bwd_{kind}"
        rows[name] = {
            "phase": "kernel", "name": name, **common, "body": kernel_body(dtype, D),
            "max_abs_err": max(e["max_abs_err"] for e in errs.values()), "by_output": errs,
            "tolerance": f"{REL_TOL[dtype]} x max |plain|",
            "ms": ms, "ms_no_dropout": ms_no_dropout, "plain_ms": plain_ms,
            "achieved_tflops": backward_flops(kind, B, L, H, D, lengths) / ms / 1e9,
            "plain": f"{layout}_attention_bwd_reference (dq, dk and dv together)",
            "library_ms": library[0],
            "library": "scaled_dot_product_attention backward without dropout "
                       "(dq, dk and dv together)",
            "library_dropout_ms": library[1], "library_dropout": "the same with dropout_p=0.1",
            "bound_ms": bound, "bound_by": by}
        emit(rows[name])
    return rows


# the backward entries a mask readout runs, by layout (and WavLM route)
READOUT_ENTRIES = {
    ("packed", "single"): ("packed_attention_bwd_dq", "packed_attention_bwd_dkv"),
    ("flash", "single"): ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"),
    ("wavlm", "single"): ("wavlm_attention_bwd_fused", "wavlm_attention_bwd_dkv"),
    ("wavlm", "general"): ("wavlm_attention_bwd_dq", "wavlm_attention_bwd_dbias",
                           "wavlm_attention_bwd_dkv_general"),
}


def phase_mask_readout(layout: str, path: str, B: int = 2, H: int = 12,
                       cases=((torch.bfloat16, 200), (torch.float32, 200),
                              (torch.float32, 749)), route: str = "single") -> None:
    """The dropout mask read out of a layout's backward entries on the card
    (``backward_mask_readout``: dq, dk and dv, and for WavLM dbias, B x H
    heads of 64, out = 0; for WavLM ``route`` picks the single pair or the
    general dq, dbias and dkv entries), bit for bit, through both bodies:
    by default bf16 (wgmma) and fp32 (CUDA cores) at L = 200, fp32 also at
    the stage-1 L = 749 (bf16 holds the readout's codes up to L = 256).
    Fails on any flipped bit, or if the entries did not launch 3 times a
    seed."""
    entries = READOUT_ENTRIES[(layout, route)]
    for dtype, L in cases:
        before = [WRAPPERS[e].launches for e in entries]
        seeds = (SEED, -2**31)
        found = backward_mask_readout(layout, "cuda", dtype, seeds, B=B, H=H, L=L, route=route)
        flipped = {f"{what} seed {seed}": int((got != want).sum().item())
                   for seed, what, got, want in found}
        row = {"phase": "mask_readout", "entry": "backward", "path": path, "layout": layout,
               "route": route, "kernels": list(entries), "dtype": dtype_name(dtype),
               "body": kernel_body(dtype, 64), "shape_BHLD": [B, H, L, 64],
               "flipped_bits": flipped}
        emit(row)
        check(sum(flipped.values()) == 0, f"{layout} backward mask readout: {row}")
        check([WRAPPERS[e].launches - n for e, n in zip(entries, before)]
              == [3 * len(seeds)] * len(entries),
              f"{layout} {route} backward readout did not go through {entries}")


def phase_forward_mask_readout(layout: str, path: str, B: int = 2, H=None,
                               cases=((torch.bfloat16, 200), (torch.float32, 200))) -> None:
    """The dropout mask read out of a layout's forward entry on the card
    (``forward_mask_readout``: q = k = 0, coded value rows, B x H heads of
    64, by default 2 x 12, 11 for flash; for WavLM a zero bias, both
    entries: the single one and the general one at block_kv 128), bit for
    bit, through both bodies, by default at L = 200: bf16 (wgmma, every
    accumulator element's (row, column)) and fp32 (CUDA cores).  Fails on
    any flipped bit, or on an l other than L."""
    if H is None:
        H = 11 if layout == "flash" else 12
    entries = {"packed": ((None, "packed_attention_fwd"),),
               "flash": ((None, "flash_attention_fwd"),),
               "wavlm": ((None, "wavlm_attention_fwd"),
                         (WAVLM_GENERAL_BLOCK_KV, "wavlm_attention_fwd_general"))}[layout]
    for block_kv, entry in entries:
        for dtype, L in cases:
            n = WRAPPERS[entry].launches
            found = forward_mask_readout(layout, "cuda", dtype, (SEED, -2**31), B=B, H=H, L=L,
                                         block_kv=block_kv)
            flipped = {f"seed {seed}": int((got != want).sum().item())
                       for seed, got, want, _ in found}
            l_ok = all(l is None or bool((l == L).all()) for *_, l in found)
            body = (wavlm_kernel_body(entry, dtype, 64) if layout == "wavlm"
                    else kernel_body(dtype, 64))
            row = {"phase": "mask_readout", "entry": "forward", "path": path, "layout": layout,
                   "kernel": entry, "dtype": dtype_name(dtype), "body": body,
                   "shape_BHLD": [B, H, L, 64], "flipped_bits": flipped, "l_is_L": l_ok}
            emit(row)
            check(sum(flipped.values()) == 0 and l_ok, f"{layout} forward mask readout: {row}")
            check(WRAPPERS[entry].launches == n + len(found),
                  f"{entry}: the readout did not go through its kernel")


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
            # serving runs without dropout: ms_no_dropout is ms
            row = {"phase": "kernel", "path": "serve", "name": name, "dtype": dtype_name(dtype),
                   "shape_BLHD": [B, L, H, D], "lengths": lengths.tolist(), "dropout": 0.0,
                   "body": kernel_body(dtype, D), **errs, **extra,
                   "ms": ms, "ms_no_dropout": ms,
                   "achieved_tflops": forward_flops(B, L, H, D, lengths) / ms / 1e9,
                   "plain_ms": plain_ms, "library_ms": library_ms,
                   "bound_ms": bound, "bound_by": by}
            emit(row)
            results[(name, dtype)] = row
    return results


def _train_shape_cases(spec):
    """(label, B, L, H, lengths): the distill step's shape (no lengths, as
    the training batches) and the serving path's masked batch 1."""
    L_train = int(frames(spec, [TRAIN_SECONDS])[0])
    L_masked = int(output_lengths(spec, torch.tensor([16 * SR]))[0])
    masked = frames(spec, BATCH1_SECONDS).to(torch.int32).cuda()
    return [("train", TRAIN_B, L_train, 12, None),
            ("masked", len(BATCH1_SECONDS), L_masked, 12, masked)]


def phase_train_kernels(spec, cases=None, dtypes=(torch.float32, torch.bfloat16),
                        path: str = "train") -> dict:
    """The training path's kernels against their plain versions: the
    forward with dropout 0.1, dq and dkv, at the distill step's shape and at
    a masked shape (``cases``: label, B, L, H, lengths), in ``dtypes``."""
    results = {}
    gen = torch.Generator(device="cuda").manual_seed(1)
    D = 64
    scale = D ** -0.5
    seed = torch.tensor([SEED], dtype=torch.int32, device="cuda")
    for label, B, L, H, lengths in cases or _train_shape_cases(spec):
        kw = dict(num_heads=H, scale=scale, dropout_rate=DROPOUT, seed=seed)
        for dtype in dtypes:
            qkv = torch.randn(B, L, 3 * H * D, device="cuda", generator=gen).to(dtype)
            dout = torch.randn(B, L, H * D, device="cuda", generator=gen).to(dtype)
            q, k, v = qkv.split(H * D, dim=-1)

            def heads(t):
                return t.view(B, L, H, D).transpose(1, 2)

            mask = None if lengths is None else key_mask(lengths, L)
            common = {"path": path, "case": label, "dtype": dtype_name(dtype),
                      "shape_BLHD": [B, L, H, D],
                      "lengths": None if lengths is None else lengths.tolist(),
                      "dropout": DROPOUT}
            with torch.no_grad():
                out, m, l = _launch_fwd(q, k, v, lengths, seed, H, scale, DROPOUT, stats=True)
                want = packed_attention_reference(q, k, v, lengths, **kw)
                torch.cuda.synchronize()
                errs = rel_error(out, want, f"fwd {label} {dtype}", dtype)
                bound, by = attention_bound_ms(B, L, H, D, lengths, dtype)
                ms = time_ms(lambda: packed_attention(q, k, v, lengths, **kw))
                row = {"phase": "kernel", "name": "packed_attention_fwd", **common,
                       "body": kernel_body(dtype, D), **errs, "ms": ms,
                       "ms_no_dropout": time_ms(lambda: packed_attention(
                           q, k, v, lengths, **{**kw, "dropout_rate": 0.0})),
                       "achieved_tflops": forward_flops(B, L, H, D, lengths) / ms / 1e9,
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
            library = library_backward_ms(qkv, heads, mask, heads(dout), scale)
            rows = backward_rows("packed", common, (B, L, H, D, lengths, dtype),
                                 (q, k, v, out, dout, m, l, di), kw,
                                 {"dq": (dq, wq), "dk": (dk, wk), "dv": (dv, wv)}, plain_ms, library)
            results.update({(name, label, dtype): row for name, row in rows.items()})
            del qkv, dout, out, m, l, dq, dk, dv, di, wq, wk, wv
            torch.cuda.empty_cache()
    if cases is None:
        phase_mask_readout("packed", "train")
        phase_forward_mask_readout("packed", "train")
    return results


def _flash_cases():
    """(label, B, L, H, lengths): the final-distill shapes of the flash
    route (B = 5 clips of the top rung, L = 780, the 11- and 9-head layers
    of a pruned student, no lengths as the training batches) and a masked
    case."""
    L = int(output_lengths(pt.spec_from_config(**r2_all_attention_config()),
                           torch.tensor([TOP_RUNG]))[0])
    masked = torch.tensor([L, 700, 512, 300, 64], dtype=torch.int32, device="cuda")
    return [("final_distill", FINAL_B, L, 11, None), ("final_distill_9h", FINAL_B, L, 9, None),
            ("masked", FINAL_B, L, 11, masked)]


def phase_flash_kernels() -> dict:
    """The flash route's kernels against their plain versions: the forward
    with dropout 0.1, dq and dkv, on (B, H, L, D) views of a fused QKV
    tensor (the model's strides), in fp32 and bf16."""
    results = {}
    gen = torch.Generator(device="cuda").manual_seed(2)
    D = 64
    scale = D ** -0.5
    seed = torch.tensor([SEED], dtype=torch.int32, device="cuda")
    kw = dict(scale=scale, dropout_rate=DROPOUT, seed=seed)
    for label, B, L, H, lengths in _flash_cases():
        for dtype in (torch.float32, torch.bfloat16):
            qkv = torch.randn(B, L, 3 * H * D, device="cuda", generator=gen).to(dtype)
            dout = torch.randn(B, H, L, D, device="cuda", generator=gen).to(dtype)
            q, k, v = (t.view(B, L, H, D).transpose(1, 2) for t in qkv.split(H * D, dim=-1))
            mask = None if lengths is None else key_mask(lengths, L)
            common = {"path": "final_distill", "case": label, "dtype": dtype_name(dtype),
                      "shape_BHLD": [B, H, L, D],
                      "lengths": None if lengths is None else lengths.tolist(),
                      "dropout": DROPOUT}
            with torch.no_grad():
                out, m, l = flash_attention(q, k, v, lengths, **kw)
                want, wm, wl = flash_attention_reference(q, k, v, lengths, **kw)
                torch.cuda.synchronize()
                errs = rel_error(out, want, f"flash fwd {label} {dtype}", dtype)
                stats = {"m_max_abs_err": (m - wm).abs().max().item(),
                         "l_max_rel_err": ((l - wl).abs() / wl).max().item()}
                check(stats["m_max_abs_err"] <= 1e-4 and stats["l_max_rel_err"] <= 1e-4,
                      f"flash fwd {label} {dtype} statistics: {stats}")
                bound, by = attention_bound_ms(B, L, H, D, lengths, dtype,
                                               extra_out_bytes=2 * 4 * B * H * L)
                ms = time_ms(lambda: flash_attention(q, k, v, lengths, **kw))
                row = {"phase": "kernel", "name": "flash_attention_fwd", **common,
                       "body": kernel_body(dtype, D), **errs, **stats, "ms": ms,
                       "ms_no_dropout": time_ms(lambda: flash_attention(
                           q, k, v, lengths, **{**kw, "dropout_rate": 0.0})),
                       "achieved_tflops": forward_flops(B, L, H, D, lengths) / ms / 1e9,
                       "plain_ms": time_ms(lambda: flash_attention_reference(q, k, v, lengths, **kw),
                                           reps=5),
                       "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                           q, k, v, attn_mask=mask, dropout_p=DROPOUT, scale=scale)),
                       "library": "scaled_dot_product_attention forward, dropout_p=0.1",
                       "bound_ms": bound, "bound_by": by}
                emit(row)
                results[("flash_attention_fwd", label, dtype)] = row

                dq, di = flash_attention_bwd_dq(q, k, v, out, dout, m, l, lengths, **kw)
                dk, dv = flash_attention_bwd_dkv(q, k, v, out, dout, m, l, di, lengths, **kw)
                plain_bwd = lambda: flash_attention_bwd_reference(q, k, v, out, dout, lengths, **kw)
                wq, wk, wv = plain_bwd()
                torch.cuda.synchronize()
                plain_ms = time_ms(plain_bwd, reps=5)
            library = library_backward_ms(qkv, lambda t: t.view(B, L, H, D).transpose(1, 2),
                                          mask, dout, scale)
            rows = backward_rows("flash", common, (B, L, H, D, lengths, dtype),
                                 (q, k, v, out, dout, m, l, di), kw,
                                 {"dq": (dq, wq), "dk": (dk, wk), "dv": (dv, wv)}, plain_ms, library)
            results.update({(name, label, dtype): row for name, row in rows.items()})
            del qkv, dout, out, m, l, dq, dk, dv, di, wq, wk, wv
            torch.cuda.empty_cache()
    phase_mask_readout("flash", "final_distill")
    phase_forward_mask_readout("flash", "final_distill")
    return results


def wavlm_flops(kind, B, L, H, D, lengths) -> float:
    """The operations of one WavLM entry's function on these inputs (not
    what a body recomputes), per (query, valid key, head): fwd 4*D (QK^T,
    PV) + 2 (gate * bias); fused 6*D (S, dP, dQ) + 6 (the bias term, ds *
    bias, gate * ds); dq 6*D + 4; dbias 4*D (S, dP) + 4; dkv 8*D (S, dP,
    dV, dK) + 2."""
    ops = {"fwd": 4 * D + 2, "fused": 6 * D + 6, "dq": 6 * D + 4, "dbias": 4 * D + 4,
           "dkv": 8 * D + 2}[kind]
    return float(ops) * H * L * sum(_valid_keys(lengths, B, L))


def wavlm_bound_ms(kind, B, L, H, D, lengths, dtype):
    """Least time for one WavLM entry's work on these inputs:
    ``wavlm_flops``; bytes: each input the entry reads, read once (q over
    all rows; k, v over the valid keys; the (H, L, valid) bias; gate; fwd
    nothing more; fused and dq: out, dout, m, l; dbias and dkv: dout, m, l
    and the di the dq side wrote) and each output written once (fwd: out,
    m, l; fused: dq, dgate, dbias, di; dq: dq, dgate, di; dbias: dbias;
    dkv: dk, dv)."""
    es = torch.tensor([], dtype=dtype).element_size()
    kv = _valid_keys(lengths, B, L)
    rows, kv_rows = B * L * H * D * es, sum(kv) * H * D * es
    stat, bias = B * H * L * 4, H * L * max(kv) * 4
    nbytes = {
        "fwd": 2 * rows + 2 * kv_rows + bias + stat + 2 * stat,
        "fused": 3 * rows + 2 * kv_rows + bias + 3 * stat + rows + 2 * stat + H * L * L * 4,
        "dq": 3 * rows + 2 * kv_rows + bias + 3 * stat + rows + 2 * stat,
        "dbias": 2 * rows + 2 * kv_rows + bias + 4 * stat + H * L * L * 4,
        "dkv": 2 * rows + 2 * kv_rows + bias + 4 * stat + 2 * kv_rows,
    }[kind]
    return _bound(wavlm_flops(kind, B, L, H, D, lengths), nbytes + 4 * B, dtype)


def _wavlm_cases(spec):
    """(label, B, L, H, lengths, backward): the DPWavLM step's shape (B =
    16 x 15 s, no lengths, 12 heads), a pruned layer's 7 of 12 heads there,
    and the serving batches (8 clips at L = 799 and 2 at L = 1299, with
    their lengths, forward only)."""
    L_train = int(frames(spec, [TRAIN_SECONDS])[0])
    cases = [("train", TRAIN_B, L_train, 12, None, True),
             ("train_7_heads", TRAIN_B, L_train, 7, None, True)]
    for label, seconds, T in (("serve_batch1", BATCH1_SECONDS, 16 * SR),
                              ("serve_batch2", BATCH2_SECONDS, 26 * SR)):
        lengths = frames(spec, seconds).to(torch.int32).cuda()
        L = int(output_lengths(spec, torch.tensor([T]))[0])
        cases.append((label, len(seconds), L, 12, lengths, False))
    return cases


def _rel_row(pairs, dtype, what):
    errs = {name: rel_error(got, ref, f"{what} {name}", dtype) for name, got, ref in pairs}
    return {"max_abs_err": max(e["max_abs_err"] for e in errs.values()), "by_output": errs,
            "tolerance": f"{REL_TOL[dtype]} x max |plain|"}


def phase_wavlm_kernels(spec, cases=None) -> dict:
    """The seven WavLM entries against their plain versions, on (B, H, L,
    D) views of a fused QKV tensor (the model's strides) with an fp32 bias
    (H, L, L) and gate (B, H, L): the DPWavLM step's shape with dropout 0.1
    in fp32 and bf16 (the single route's forward, fused backward and dkv;
    the general entries, block_kv 128, on the same inputs, held against the
    single ones too); 7 of 12 heads in bf16; the serving batches with their
    lengths, forward only.  library = scaled_dot_product_attention with
    the materialised (B, H, L, L) mask gate * bias (+ the key mask), the
    mask built outside the timing; for the backward, its backward with the
    mask needing a gradient.  The rows name the body (in bf16 every entry:
    wgmma), carry the time without dropout
    and the achieved TFLOP/s of the entry's function; in bf16 (every entry
    on the tensor cores) the general forward's out, m and l and the general
    backward's dq, dgate, di, dbias, dk and dv equal the single route's bit
    for bit (the same bodies), and every backward entry's rerun must give
    the same bits.  Then the dropout mask is read out of both routes'
    backward entries and of both forward entries through both bodies.
    ``cases`` (label, B, L, H, lengths, backward) replaces the cases, in
    bf16 and without the readouts: "tp2", the tensor-parallel step's 6
    heads, runs every entry, as "train" does."""
    results = {}
    gen = torch.Generator(device="cuda").manual_seed(12)
    D = 64
    scale = D ** -0.5
    seed = torch.tensor([SEED], dtype=torch.int32, device="cuda")
    for label, B, L, H, lengths, backward in cases or _wavlm_cases(spec):
        dtypes = ((torch.float32, torch.bfloat16) if label in ("train", "serve_batch1",
                                                               "serve_batch2")
                  else (torch.bfloat16,))
        rate = DROPOUT if backward else 0.0
        kw = dict(scale=scale, dropout_rate=rate, seed=seed)
        for dtype in dtypes:
            qkv = torch.randn(B, L, 3 * H * D, device="cuda", generator=gen).to(dtype)
            dout = torch.randn(B, H, L, D, device="cuda", generator=gen).to(dtype)
            bias = torch.randn(H, L, L, device="cuda", generator=gen)
            gate = 1.0 + 2.0 * torch.rand(B, H, L, device="cuda", generator=gen)
            q, k, v = (t.view(B, L, H, D).transpose(1, 2) for t in qkv.split(H * D, dim=-1))
            args = (q, k, v, bias, gate)
            mask = (gate[..., None] * bias[None])
            if lengths is not None:
                mask = mask.masked_fill(~key_mask(lengths, L), NEG_INF_MASK)
            mask = mask.to(dtype)
            path = "fsdp_card" if label == "tp2" else "wavlm_train" if backward else "wavlm_serve"
            common = {"path": path, "case": label,
                      "dtype": dtype_name(dtype), "shape_BHLD": [B, H, L, D],
                      "lengths": None if lengths is None else lengths.tolist(), "dropout": rate}
            with torch.no_grad():
                out, m, l = wavlm_attention_fwd(*args, lengths, **kw)
                want, wm, wl = wavlm_attention_reference(*args, lengths, **kw)
                torch.cuda.synchronize()
                stats = {"m_max_abs_err": (m - wm).abs().max().item(),
                         "l_max_rel_err": ((l - wl).abs() / wl).max().item()}
                check(stats["m_max_abs_err"] <= 1e-4 and stats["l_max_rel_err"] <= 1e-4,
                      f"wavlm fwd {label} {dtype} statistics: {stats}")
                bound, by = wavlm_bound_ms("fwd", B, L, H, D, lengths, dtype)
                ms = time_ms(lambda: wavlm_attention_fwd(*args, lengths, **kw))
                row = {"phase": "kernel", "name": "wavlm_attention_fwd", **common,
                       "body": wavlm_kernel_body("wavlm_attention_fwd", dtype, D),
                       **rel_error(out, want, f"wavlm fwd {label} {dtype}", dtype), **stats,
                       "ms": ms,
                       "ms_no_dropout": ms if rate == 0.0 else time_ms(
                           lambda: wavlm_attention_fwd(*args, lengths, **{**kw, "dropout_rate": 0.0})),
                       "achieved_tflops": wavlm_flops("fwd", B, L, H, D, lengths) / ms / 1e9,
                       "plain_ms": time_ms(lambda: wavlm_attention_reference(*args, lengths, **kw),
                                           reps=5),
                       "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                           q, k, v, attn_mask=mask, dropout_p=rate, scale=scale)),
                       "library": f"scaled_dot_product_attention forward, (B, H, L, L) mask "
                                  f"gate * bias, dropout_p={rate}",
                       "bound_ms": bound, "bound_by": by}
                emit(row)
                results[("wavlm_attention_fwd", label, dtype)] = row
            if not backward:
                del qkv, dout, bias, gate, mask, out, m, l, want
                continue
            with torch.no_grad():
                dq, dgate, dbias, di = wavlm_attention_bwd_fused(*args, out, dout, m, l, lengths,
                                                                 **kw)
                dk, dv = wavlm_attention_bwd_dkv(*args, out, dout, m, l, di, lengths, **kw)
                plain_bwd = lambda: wavlm_attention_bwd_reference(*args, out, dout, lengths, **kw)
                wq, wk, wv, wbias, wgate = plain_bwd()
                torch.cuda.synchronize()
                plain_ms = time_ms(plain_bwd, reps=3, warmup=1)
            # the library's backward: SDPA with the mask needing a gradient,
            # dq, dk, dv and the mask's gradient together, without dropout
            x = qkv.detach().requires_grad_()
            xm = mask.detach().requires_grad_()
            xq, xk, xv = (t.view(B, L, H, D).transpose(1, 2) for t in x.split(H * D, dim=-1))
            y = F.scaled_dot_product_attention(xq, xk, xv, attn_mask=xm, scale=scale)
            library_ms = time_ms(lambda: torch.autograd.grad(y, (x, xm), dout, retain_graph=True))
            del x, xm, y
            library = ("scaled_dot_product_attention backward without dropout, the (B, H, L, L) "
                       "mask needing a gradient (dq, dk, dv and dmask together)")

            def call(fn, *di_in):
                return lambda **o: fn(*args, out, dout, m, l, *di_in, lengths, **{**kw, **o})

            # (name, kind, (output, kernel, plain) pairs, the outputs of its first
            # call, the call)
            entries = (
                ("wavlm_attention_bwd_fused", "fused",
                 (("dq", dq, wq), ("dgate", dgate, wgate), ("dbias", dbias, wbias)),
                 (dq, dgate, dbias, di), call(wavlm_attention_bwd_fused)),
                ("wavlm_attention_bwd_dkv", "dkv", (("dk", dk, wk), ("dv", dv, wv)), (dk, dv),
                 call(wavlm_attention_bwd_dkv, di)),
            )
            general = {}
            if label in ("train", "tp2"):
                # the general route's entries on the same inputs: against the
                # plain versions, and (fp32) against the single entries
                with torch.no_grad():
                    out_g, m_g, l_g = wavlm_attention_fwd_general(*args, lengths, **kw)
                    dq_g, dgate_g, di_g = wavlm_attention_bwd_dq(*args, out, dout, m, l, lengths,
                                                                 **kw)
                    dbias_g = wavlm_attention_bwd_dbias(*args, out, dout, m, l, di_g, lengths,
                                                        **kw)
                    dk_g, dv_g = wavlm_attention_bwd_dkv_general(*args, out, dout, m, l, di_g,
                                                                 lengths, **kw)
                    torch.cuda.synchronize()
                general = {"out": (out_g, out), "m": (m_g, m), "l": (l_g, l), "dq": (dq_g, dq),
                           "dgate": (dgate_g, dgate), "dbias": (dbias_g, dbias), "di": (di_g, di),
                           "dk": (dk_g, dk), "dv": (dv_g, dv)}
                vs_single = {n: (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
                             for n, (a, b) in general.items()}
                bits = {n: torch.equal(*pair) for n, pair in general.items()}
                if dtype == torch.float32:
                    check(max(vs_single.values()) <= 1e-5,
                          f"wavlm general vs single entries, fp32: {vs_single}")
                else:  # the same tensor-core bodies (the forward in another block order)
                    check(all(bits.values()),
                          f"wavlm general vs single entries, bf16, not bit for bit: {bits}")
                bound, by = wavlm_bound_ms("fwd", B, L, H, D, lengths, dtype)
                ms = time_ms(lambda: wavlm_attention_fwd_general(*args, lengths, **kw))
                row = {"phase": "kernel", "name": "wavlm_attention_fwd_general", **common,
                       "block_kv": WAVLM_GENERAL_BLOCK_KV,
                       "body": wavlm_kernel_body("wavlm_attention_fwd_general", dtype, D),
                       **rel_error(out_g, want, f"wavlm fwd general {label} {dtype}", dtype),
                       "rel_err_vs_single": vs_single,
                       "fwd_bit_identical_to_single": all(bits[n] for n in ("out", "m", "l")),
                       "ms": ms,
                       "ms_no_dropout": time_ms(lambda: wavlm_attention_fwd_general(
                           *args, lengths, **{**kw, "dropout_rate": 0.0})),
                       "achieved_tflops": wavlm_flops("fwd", B, L, H, D, lengths) / ms / 1e9,
                       "plain_ms": results[("wavlm_attention_fwd", label, dtype)]["plain_ms"],
                       "library_ms": results[("wavlm_attention_fwd", label, dtype)]["library_ms"],
                       "bound_ms": bound, "bound_by": by}
                emit(row)
                results[("wavlm_attention_fwd_general", label, dtype)] = row
                entries += (
                    ("wavlm_attention_bwd_dq", "dq", (("dq", dq_g, wq), ("dgate", dgate_g, wgate)),
                     (dq_g, dgate_g, di_g), call(wavlm_attention_bwd_dq)),
                    ("wavlm_attention_bwd_dbias", "dbias", (("dbias", dbias_g, wbias),),
                     (dbias_g,), call(wavlm_attention_bwd_dbias, di_g)),
                    ("wavlm_attention_bwd_dkv_general", "dkv", (("dk", dk_g, wk), ("dv", dv_g, wv)),
                     (dk_g, dv_g), call(wavlm_attention_bwd_dkv_general, di_g)),
                )
            for name, kind, pairs, first, run in entries:
                bound, by = wavlm_bound_ms(kind, B, L, H, D, lengths, dtype)
                with torch.no_grad():
                    ms = time_ms(run)
                    ms_no_dropout = time_ms(lambda: run(dropout_rate=0.0))
                    again = run()
                again = again if isinstance(again, tuple) else (again,)
                check(all(torch.equal(a, b) for a, b in zip(again, first)),
                      f"{name} {label} {dtype}: a rerun gave other bits")
                same = {"wavlm_attention_bwd_dq": ("dq", "dgate", "di"),
                        "wavlm_attention_bwd_dbias": ("dbias",),
                        "wavlm_attention_bwd_dkv_general": ("dk", "dv")}.get(name, ())
                row = {"phase": "kernel", "name": name, **common,
                       "body": wavlm_kernel_body(name, dtype, D),
                       **_rel_row(pairs, dtype, f"{name} {label} {dtype}"),
                       "rerun_bit_identical": True,
                       **({"bit_identical_to_single": {n: bits[n] for n in same}} if same else {}),
                       "ms": ms, "ms_no_dropout": ms_no_dropout, "plain_ms": plain_ms,
                       "achieved_tflops": wavlm_flops(kind, B, L, H, D, lengths) / ms / 1e9,
                       "plain": "wavlm_attention_bwd_reference (dq, dk, dv, dbias, dgate together)",
                       "library_ms": library_ms, "library": library,
                       "bound_ms": bound, "bound_by": by}
                emit(row)
                results[(name, label, dtype)] = row
            del qkv, dout, bias, gate, mask, out, m, l, want, dq, dk, dv, dgate, dbias, di
            del wq, wk, wv, wbias, wgate, general, entries
            torch.cuda.empty_cache()
    if cases is not None:
        return results
    phase_mask_readout("wavlm", "wavlm_train")
    phase_mask_readout("wavlm", "wavlm_general_train", route="general")
    phase_forward_mask_readout("wavlm", "wavlm_train")
    return results


# ---------------------------------------------------------------------------
# Phases 3 and 4: serving through the Predictor
# ---------------------------------------------------------------------------


def wrapper_counts() -> dict:
    """Each wrapper's own counter: a CUDA graph's capture counts once (and
    runs nothing), its replays not at all."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def launch_counts() -> dict:
    """The launches that ran: the wrappers' counters, less what they
    counted at graph captures, plus what the counted graph replays ran
    (``GraphedSteps``'s tally)."""
    cap, rep = GraphedSteps.captured, GraphedSteps.replayed
    return {n: c - cap.get(n, 0) + rep.get(n, 0) for n, c in wrapper_counts().items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
    GraphedSteps.reset_tally()


def nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def model_launches(spec, L: int, backward: bool, remat: bool = False) -> dict:
    """Kernel launches of one pass of a model at L frames, from the routing
    rules: a forward per attention layer, and its backward kernels with
    ``backward``; with ``remat`` (and ``backward``) each layer's forward
    runs again in the backward's recompute, and every layer counts one
    ``remat_layer``; with ``backward`` the pos conv's input gradient once
    as a forward conv (``pos_conv_dgrad``).  A WavLM model whose layer 0
    keeps its attention (and so the bias table) takes the WavLM kernels in
    every attention layer, on the route ``wavlm_route`` gives (read at the
    call, as the model reads it); every other layer takes the packed or
    flash route."""
    counts = dict.fromkeys(WRAPPERS, 0)
    wavlm_bias = spec.is_wavlm and spec.layers[0].attention is not None
    for layer in spec.layers:
        if layer.attention is None:
            continue
        if wavlm_bias and wavlm_route(L) == "single":
            fwd, bwd = "wavlm_attention_fwd", ("wavlm_attention_bwd_fused",
                                               "wavlm_attention_bwd_dkv")
        elif wavlm_bias:
            fwd, bwd = "wavlm_attention_fwd_general", (
                "wavlm_attention_bwd_dq", "wavlm_attention_bwd_dbias",
                "wavlm_attention_bwd_dkv_general")
        else:
            route = attention_route(L, layer.attention.num_heads, layer.attention.head_dim)
            fwd, bwd = f"{route}_attention_fwd", (f"{route}_attention_bwd_dq",
                                                  f"{route}_attention_bwd_dkv")
        counts[fwd] += 2 if backward and remat else 1
        if backward:
            for name in bwd:
                counts[name] += 1
    counts["pos_conv_dgrad"] = int(backward)
    counts["remat_layer"] = len(spec.layers) if backward and remat else 0
    return counts


def add_counts(*terms) -> dict:
    """sum of n x counts over (n, counts) terms"""
    return {k: sum(n * c[k] for n, c in terms) for k in WRAPPERS}


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
        want = model_launches(spec, L, backward=False)
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
        for _ in range(3):
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


def distill_models(device: str, family: str = "hubert", **kw):
    """Teacher ``hubert_base`` (or ``wavlm_base``: DPWavLM) and the gated
    student (its config with all five prune flags), random weights from two
    seeds."""
    factory = pt.hubert_base if family == "hubert" else pt.wavlm_base
    teacher = factory(device=device, generator=torch.Generator().manual_seed(0), **kw)
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


def step_check(label: str, teacher, student, cfg: DistillConfig, batch, gate_u=None) -> dict:
    """One distill step's loss, metrics and gradients at full width, dropout
    off: (a) fp32 on the card against the CPU, (b) bf16 against fp32 on the
    card, with the same inputs (and gate draws) everywhere."""
    out = {}
    for device in ("cuda", "cpu"):
        t = teacher if device == "cuda" else copy.deepcopy(teacher).to("cpu")
        state, _ = init_train_state(student=student, cfg=cfg, teacher_embed_dim=768,
                                    device=device)
        t0 = time.perf_counter()
        metrics, grads = make_grad_fn(t, cfg)(state, batch, gate_u=gate_u)
        torch.cuda.synchronize()
        out[device] = ({k: v.item() for k, v in metrics.items()},
                       {k: g.detach().cpu() for k, g in grads.items()},
                       time.perf_counter() - t0)
        del state, t
    (mc, gc, sec_c), (mh, gh, sec_h) = out["cuda"], out["cpu"]
    metric_err = {k: abs(mc[k] - mh[k]) / max(abs(mh[k]), 1e-12) for k in mh}
    for k in mh:
        check(np.isfinite(mc[k]), f"{label} fp32: metric {k} not finite")
        check(abs(mc[k] - mh[k]) <= TRAIN_FP32_METRIC_TOL * abs(mh[k]) + 1e-6,
              f"{label} fp32 card vs CPU: {k} {mc[k]} vs {mh[k]}")
    global_norm = torch.cat([g.flatten() for g in gh.values()]).double().norm().item()
    grad_err, zero = {}, {}
    for k, g in gh.items():
        norm, diff = g.double().norm().item(), (gc[k] - g).double().norm().item()
        if norm <= 1e-6 * global_norm:
            zero[k] = diff / global_norm
            check(diff <= 1e-6 * global_norm, f"{label} fp32 card vs CPU: zero gradient of {k}: {diff}")
            continue
        grad_err[k] = diff / norm
        check(diff <= TRAIN_FP32_GRAD_TOL * norm,
              f"{label} fp32 card vs CPU: gradient of {k}: relative error {grad_err[k]}")
    worst = sorted(grad_err.items(), key=lambda kv: -kv[1])[:3]

    # (b) bf16 against fp32, on the card
    state, _ = init_train_state(student=student, cfg=cfg, teacher_embed_dim=768, device="cuda")
    cfg16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
    mb, gb = make_grad_fn(teacher, cfg16)(state, batch, gate_u=gate_u)
    mb = {k: v.item() for k, v in mb.items()}
    loss_rel = abs(mb["loss"] - mc["loss"]) / abs(mc["loss"])
    flat16 = torch.cat([gb[k].flatten().cpu() for k in gc]).double()
    flat32 = torch.cat([gc[k].flatten() for k in gc]).double()
    cos = F.cosine_similarity(flat16, flat32, dim=0).item()
    per_param = {k: F.cosine_similarity(gb[k].flatten().cpu().double(), gc[k].flatten().double(),
                                        dim=0).item()
                 for k in grad_err}
    check(loss_rel <= TRAIN_BF16_LOSS_TOL, f"{label} bf16 vs fp32: loss relative error {loss_rel}")
    check(cos >= TRAIN_BF16_MIN_COS, f"{label} bf16 vs fp32: gradient cosine {cos}")
    return {"fp32_card_vs_cpu": {"metrics_rel_err_max": max(metric_err.values()),
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


def phase_train_check(family: str = "hubert", label: str = "train_check") -> dict:
    """The stage-1 step (gated student) on a small batch: 2 clips of 2 s,
    lengths 2 s and 1.5 s, the same gate draws everywhere; ``family``
    "wavlm" is the DPWavLM step.

    The DPWavLM check runs without the L1 term (``l1_weight=0``: cosine and
    the Lagrangian): the L1 gradient is sign(residual) / N, and card and CPU
    differ in the residuals by up to 1.4e-5, so a residual that close to 0
    flips sign between them.  Measured (chip run, WavLM Base at this
    batch): one flip among 608,256 residuals moved the last layer's
    gradient by 0.3% and the bias table's by 0.17%; without the L1 term
    every gradient agreed within 1.5e-5.  HuBERT's check at the same batch
    has no flip and keeps the term; the L1 code is shared."""
    teacher, student = distill_models("cuda", family, **NO_DROPOUT)
    u = gate_draws(student.spec, student, seed=3)
    rng = np.random.default_rng(4)
    wave = (0.1 * rng.standard_normal((2, 32000))).astype(np.float32)
    batch = (wave, np.array([32000, 24000], np.int32))
    cfg = DistillConfig() if family == "hubert" else DistillConfig(l1_weight=0.0)
    row = {"phase": label, "family": family,
           "batch": "2 clips of 2 s, lengths (32000, 24000)", "l1_weight": cfg.l1_weight,
           **step_check(label, teacher, student, cfg, batch, gate_u=u)}
    emit(row)
    return row, teacher.spec, student.spec


def phase_wavlm_general_check() -> dict:
    """The DPWavLM check of ``phase_train_check`` on the general route
    (``DPHUBERT_WAVLM_SINGLE_BLOCK=0``, the TPU package's escape hatch):
    every WavLM layer runs the general forward, dq, dbias and dkv entries.
    Launch counts are set to 0 just before and read just after: the card's
    fp32 and bf16 passes each launch one teacher forward and one student
    forward and backward; ``pos_conv_dgrad`` also counts the CPU pass's
    backward."""
    os.environ["DPHUBERT_WAVLM_SINGLE_BLOCK"] = "0"
    try:
        reset_launch_counts()
        row, spec_t, spec_s = phase_train_check("wavlm", "wavlm_general_check")
        counts = launch_counts()
        L = int(frames(spec_t, [2.0])[0])
        per_pass = add_counts((1, model_launches(spec_t, L, False)),
                              (1, model_launches(spec_s, L, True)))
    finally:
        del os.environ["DPHUBERT_WAVLM_SINGLE_BLOCK"]
    want = {k: 2 * v for k, v in per_pass.items()}
    want["pos_conv_dgrad"] += 1
    check(counts == want, f"wavlm general route: launches {counts}, expected {want}")
    check(want["wavlm_attention_bwd_dbias"] == 24 and want["wavlm_attention_fwd"] == 0,
          f"wavlm general route per pass {per_pass}")
    emit({"phase": "wavlm_general_launches", "L": L, "launches": counts})
    row["launches"] = counts
    return row


def phase_final_distill_check() -> dict:
    """The final-distill step (``use_reg=False``, no gates) of a pruned
    student that takes the flash route: r2's head counts with every
    attention sublayer kept (``r2_all_attention_config``), on one clip of
    15.62 s (the loader's top rung, L = 780 frames, no lengths, as the
    training batches), dropout off."""
    teacher = pt.hubert_base(device="cuda", generator=torch.Generator().manual_seed(0),
                             **NO_DROPOUT)
    student = pt.wav2vec2_model(device="cuda", generator=torch.Generator().manual_seed(7),
                                **dict(r2_all_attention_config(), **NO_DROPOUT))
    L = int(output_lengths(student.spec, torch.tensor([TOP_RUNG]))[0])
    routes = [attention_route(L, l.attention.num_heads, 64) for l in student.spec.layers]
    check(routes.count("flash") == 2, f"final-distill student routes at L={L}: {routes}")
    rng = np.random.default_rng(8)
    batch = ((0.1 * rng.standard_normal((1, TOP_RUNG))).astype(np.float32), None)
    row = {"phase": "final_distill_check", "batch": f"1 clip of {TOP_RUNG} samples, L = {L}",
           "student_routes": routes,
           **step_check("final_distill", teacher, student, DistillConfig(use_reg=False), batch)}
    emit(row)
    return row


def timed_steps(label: str, step, state, batch, per_step: dict, audio_per_step: float,
                steps_per_segment: int = 2, segments: int = 3):
    """Two warm steps, then ``segments`` timed segments of
    ``steps_per_segment`` steps ending in a synchronize; launch counts are
    set to 0 just before the timed steps and read just after, and must be
    exactly ``per_step`` per step.  Returns (state, row fields, metrics of
    every step)."""
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
    check(counts == {k: v * n for k, v in per_step.items()},
          f"{label} launches {counts} over {n} steps, expected {per_step} per step")
    hist = [{k: v.item() for k, v in m.items()} for m in history]
    for i, m in enumerate(hist):
        for k, v in m.items():
            check(np.isfinite(v), f"{label} step {i}: {k} = {v}")
    fields = {"dtype": "bfloat16", "audio_seconds_per_step": audio_per_step, "steps_timed": n,
              "audio_sec_per_s": statistics.median(seg), "segments": seg,
              "step_s": audio_per_step / statistics.median(seg),
              "peak_memory_bytes": torch.cuda.max_memory_allocated(), "launches": counts,
              "launches_per_step": {k: v / n for k, v in counts.items()},
              "loss": [hist[0]["loss"], hist[-1]["loss"]],
              "grad_norm": [hist[0]["grad_norm"], hist[-1]["grad_norm"]]}
    return state, fields, hist


def phase_train(family: str = "hubert", label: str = "") -> dict:
    """The training path: bf16 distill steps at B = 16 x 15 s with dropout
    on (the teacher preset's rates), DistillConfig defaults, a batch that
    stays on the card (as bench.py); ``family`` "wavlm" is the DPWavLM step
    (bench.py's DPWavLM mode): on the single route (``wavlm_route`` at L =
    749, read now) exactly 24 WavLM forwards (12 teacher, 12 student), 12
    fused backwards and 12 dkv a step; on the general one 24 general
    forwards and 12 each of the general dq, dbias and dkv; no packed or
    flash kernel."""
    teacher, student = distill_models("cuda", family)
    cfg = DistillConfig(compute_dtype="bfloat16")
    state, tx = init_train_state(student=student, cfg=cfg, teacher_embed_dim=768, seed=5,
                                 device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(6)
    T = int(TRAIN_SECONDS * SR)
    batch = (torch.randn(TRAIN_B, T, device="cuda", generator=gen), None)
    L = int(output_lengths(teacher.spec, torch.tensor([T]))[0])
    per_step = add_counts((1, model_launches(teacher.spec, L, False)),
                          (1, model_launches(state.student.spec, L, True)))
    if family == "hubert":
        check(per_step["packed_attention_fwd"] == 24 and per_step["packed_attention_bwd_dq"] == 12
              and per_step["flash_attention_fwd"] == 0, f"stage-1 launches per step {per_step}")
    else:
        want = dict.fromkeys(WRAPPERS, 0)
        if wavlm_route(L) == "single":
            want.update(wavlm_attention_fwd=24, wavlm_attention_bwd_fused=12,
                        wavlm_attention_bwd_dkv=12, pos_conv_dgrad=1)
        else:
            want.update(wavlm_attention_fwd_general=24, wavlm_attention_bwd_dq=12,
                        wavlm_attention_bwd_dbias=12, wavlm_attention_bwd_dkv_general=12,
                        pos_conv_dgrad=1)
        check(per_step == want, f"DPWavLM launches per step {per_step}, expected {want}")
    label = label or ("train" if family == "hubert" else "wavlm_train")
    step = make_train_step(teacher, cfg, tx)
    state, fields, hist = timed_steps(label, step, state, batch, per_step,
                                      TRAIN_B * TRAIN_SECONDS)
    gap = [m["sparsity_expected"] - m["sparsity_target"] for m in hist]
    lam1 = state.lambdas["lambda1"].item()
    # dual ascent: λ1's gradient is (s - t), so λ1 moves with its sign
    check(lam1 != 0.0 and np.sign(lam1) == np.sign(np.mean(gap)),
          f"λ1 = {lam1} after steps with mean s - t = {np.mean(gap)}")
    row = {"phase": label, "model": f"{family}_base teacher, gated {family}_base student",
           "batch": [TRAIN_B, T], "L": L, "route": wavlm_route(L) if family == "wavlm" else None,
           **fields, "lambda1_final": lam1, "s_minus_t": [gap[0], gap[-1]]}
    emit(row)
    if family == "hubert" and label == "train":
        row["profile"] = phase_profile(step, state, batch, per_step)
    del state, tx, batch, step
    torch.cuda.empty_cache()
    graph = phase_graph_train(f"graph_{label}", teacher, student, cfg, 5, (TRAIN_B, T),
                              per_step, TRAIN_B * TRAIN_SECONDS, fields["peak_memory_bytes"])
    row["graph"] = {f"graph_{label}": graph}
    if family == "hubert" and label == "train":  # run_torch.sh's ladder at 160 s a batch
        row["graph"]["graph_keys_train"] = phase_graph_keys("graph_keys_train", teacher,
                                                            student, cfg, 5, 160,
                                                            rungs=LADDER_RUNGS)
    return row


PROFILE_DIR = REPO / "build" / "smoke_profile"
PROFILE_STEPS = 2
PACKED_KERNEL_NAMES = {"packed_attention_fwd": "attention_fwd_wgmma_kernel",
                       "packed_attention_bwd_dq": "attention_bwd_dq_wgmma_kernel",
                       "packed_attention_bwd_dkv": "attention_bwd_dkv_wgmma_kernel"}


def phase_profile(step, state, batch, per_step: dict) -> dict:
    """``dphubert_torch.utils.profiling`` on phase "train"'s stage-1 step
    (its state, batch and step: bf16, B = 16 x 15 s, dropout on):
    ``trace`` around 2 steps writes a Chrome trace (its path and size
    printed); ``device_breakdown`` of that profile: the kernel families'
    shares of the busy time sum to it within 1% (kernels that run at once
    share their time; the kernel time over the busy time, and the kernels
    that ran beside others, are printed), and the packed entries' tensor-core kernels
    ran as often as their wrappers counted, 24 / 12 / 12 a step."""
    shutil.rmtree(PROFILE_DIR, ignore_errors=True)
    torch.cuda.synchronize()
    reset_launch_counts()
    with trace(PROFILE_DIR) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_STEPS):
            state, _ = step(state, batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / PROFILE_STEPS
    counts = launch_counts()
    check(counts == {k: PROFILE_STEPS * v for k, v in per_step.items()},
          f"profile: launches {nonzero(counts)} over {PROFILE_STEPS} steps")
    path = prof.trace_path
    size = path.stat().st_size
    check(path.parent == PROFILE_DIR and path.name.endswith(".pt.trace.json") and size > 0,
          f"profile: trace file {path}, {size} bytes")
    dev = device_breakdown(prof, steps=PROFILE_STEPS, top=1 << 30)
    families = sum(dev["families_busy_ms"].values())
    check(abs(families - dev["busy_ms"]) <= 0.01 * dev["busy_ms"],
          f"profile: families {families} ms against busy {dev['busy_ms']} ms a step")
    # kernels that ran beside others (their time less their share of busy)
    concurrent = sorted(dev["top"], key=lambda k: k["busy_ms"] - k["ms"])[:8]
    calls = {name: sum(k["calls"] for k in dev["top"] if kernel in k["name"])
             for name, kernel in PACKED_KERNEL_NAMES.items()}
    check(calls == {name: float(per_step[name]) for name in calls},
          f"profile: packed kernels a step {calls}, the wrappers counted {nonzero(per_step)}")
    row = {"phase": "profile", "path": "train", "steps": PROFILE_STEPS,
           "trace": str(path.relative_to(REPO)), "trace_bytes": size,
           "wall_ms_per_step": wall_ms, "device_busy_ms_per_step": dev["busy_ms"],
           "device_idle_share": 1.0 - dev["busy_ms"] / wall_ms,
           "kernel_ms_per_step": dev["kernel_ms"],
           "kernel_over_busy": dev["kernel_ms"] / dev["busy_ms"],
           "families_ms_per_step": dev["families_ms"],
           "families_busy_ms_per_step": dev["families_busy_ms"],
           "families_busy_over_busy": families / dev["busy_ms"],
           "concurrent_kernels": [dict(k, name=k["name"][:120]) for k in concurrent
                                  if k["ms"] > k["busy_ms"]],
           "kernel_launches_per_step": dev["launches"], "packed_kernel_calls_per_step": calls,
           "top_kernels": [dict(k, name=k["name"][:120]) for k in dev["top"][:10]],
           "card": nvidia_smi(), "launches": counts}
    emit(row)
    shutil.rmtree(PROFILE_DIR, ignore_errors=True)
    return row


def phase_wavlm_general_train(single: dict) -> dict:
    """The DPWavLM step of ``phase_train("wavlm")`` on the general route
    (``DPHUBERT_WAVLM_SINGLE_BLOCK=0``): the same models, batch and seeds at
    full width, right after the single route's run ``single`` in the same
    process: exactly 24 / 12 / 12 / 12 launches a step of the general
    forward, dq, dbias and dkv entries and none elsewhere, and a peak memory
    within 1% of the single route's; its step time beside the single
    route's."""
    gc.collect()  # the single route's models and state, if a cycle holds them
    os.environ["DPHUBERT_WAVLM_SINGLE_BLOCK"] = "0"
    try:
        row = phase_train("wavlm", "wavlm_general_train")
    finally:
        del os.environ["DPHUBERT_WAVLM_SINGLE_BLOCK"]
    check(row["route"] == "general" and single["route"] == "single",
          f"routes {single['route']}, {row['route']}")
    check(row["peak_memory_bytes"] <= 1.01 * single["peak_memory_bytes"],
          f"general-route step peak {row['peak_memory_bytes']} > 1.01 x the single route's "
          f"{single['peak_memory_bytes']}")
    keys = ("step_s", "audio_sec_per_s", "segments", "peak_memory_bytes")
    emit({"phase": "wavlm_routes", "single": {k: single[k] for k in keys},
          "general": {k: row[k] for k in keys},
          "step_ratio_general_over_single": row["step_s"] / single["step_s"],
          "peak_ratio_general_over_single": row["peak_memory_bytes"]
          / single["peak_memory_bytes"]})
    return row


def phase_final_distill_step() -> dict:
    """The final-distill step on the flash route: bf16, B = 5 clips of the
    top rung (L = 780), the r2-heads student with every attention sublayer
    (two flash layers), dropout on at HuBERT Base's rates, ``use_reg=False``,
    a batch that stays on the card."""
    teacher = pt.hubert_base(device="cuda", generator=torch.Generator().manual_seed(0))
    student = pt.wav2vec2_model(device="cuda", generator=torch.Generator().manual_seed(7),
                                **r2_all_attention_config())
    cfg = DistillConfig(use_reg=False, compute_dtype="bfloat16")
    state, tx = init_train_state(student=student, cfg=cfg, teacher_embed_dim=768, seed=9,
                                 device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(10)
    batch = (torch.randn(FINAL_B, TOP_RUNG, device="cuda", generator=gen), None)
    L = int(output_lengths(teacher.spec, torch.tensor([TOP_RUNG]))[0])
    per_step = add_counts((1, model_launches(teacher.spec, L, False)),
                          (1, model_launches(state.student.spec, L, True)))
    check({k: per_step[k] for k in ("flash_attention_fwd", "flash_attention_bwd_dq",
                                    "flash_attention_bwd_dkv")} == dict.fromkeys(
        ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv"), 2),
          f"final-distill launches per step {per_step}")
    state, fields, _ = timed_steps("final_distill", make_train_step(teacher, cfg, tx), state,
                                   batch, per_step, FINAL_B * TOP_RUNG / SR)
    row = {"phase": "final_distill_step",
           "model": "hubert_base teacher, r2-heads student with every attention sublayer",
           "batch": [FINAL_B, TOP_RUNG], "L": L, **fields}
    emit(row)
    del state, tx, batch
    torch.cuda.empty_cache()
    graph = phase_graph_train("graph_final_distill", teacher, student, cfg, 9,
                              (FINAL_B, TOP_RUNG), per_step, FINAL_B * TOP_RUNG / SR,
                              fields["peak_memory_bytes"])
    row["graph"] = {"graph_final_distill": graph}
    return row


# ---------------------------------------------------------------------------
# The training forward with LayerDrop
# ---------------------------------------------------------------------------

LAYERDROP_RATE = 0.1  # encoder_layer_drop of the LayerDrop phase
LAYERDROP_DROPPED = (3, 8)  # the layers its injected uniforms drop
LAYERDROP_B = 8  # the timed forward: 8 clips of 15 s


def phase_layerdrop(family: str) -> dict:
    """``Wav2Vec2Model.forward(training=True)`` with LayerDrop: HuBERT Base
    or WavLM Base at full width, its config with all five prune flags and
    gates sampled from numpy draws, every dropout rate 0 and
    ``encoder_layer_drop`` 0.1; the injected uniforms drop layers 3 and 8.
    At 2 clips of 2 s (lengths 32000, 24000): fp32 on the card against the
    CPU (TF32 off) within MODEL_FP32_TOL; each dropped layer's output is its
    input bit for bit (forward hooks), a kept one's is not; with u all
    ones, bit for bit the forward of the same weights with layer_drop 0; bf16
    against fp32 within MODEL_BF16_REL_TOL; exactly 12 forward launches a
    call whatever is dropped (every layer is computed), and one backward of
    mean(out^2) runs 12 of each backward entry.  Then the bf16 forward timed
    at B = 8 x 15 s with its uniforms drawn from the generator on the card
    (median of 5 calls; ``torch.no_grad`` off, as in training)."""
    factory = pt.hubert_base if family == "hubert" else pt.wavlm_base
    base = factory(device="cpu", generator=torch.Generator().manual_seed(0))
    cfg = dict(base.config, **PRUNE_FLAGS, **NO_DROPOUT)
    cfg["encoder_layer_drop"] = LAYERDROP_RATE
    del base
    model = pt.wav2vec2_model(device="cuda", generator=torch.Generator().manual_seed(31), **cfg)
    spec = model.spec
    n = spec.num_layers
    u = torch.ones(n)
    u[list(LAYERDROP_DROPPED)] = 0.05  # <= layer_drop: dropped
    gate_u = gate_draws(spec, model, seed=32)

    def gates_of(m):
        return sample_gates(spec, unflatten_params(dict(m.named_parameters())), u=gate_u)

    rng = np.random.default_rng(33)
    wave = torch.from_numpy((0.1 * rng.standard_normal((2, 32000))).astype(np.float32))
    lengths = torch.tensor([32000, 24000], dtype=torch.int32)

    def forward(m, device, dtype=torch.float32, layer_drop_u=u, grad=False):
        with torch.set_grad_enabled(grad):
            out, _ = m.forward(wave.to(device, dtype), lengths.to(device), gates=gates_of(m),
                               training=True, generator=torch.Generator(device=device),
                               layer_drop_u=layer_drop_u)
        return out

    fwd = "packed_attention_fwd" if family == "hubert" else "wavlm_attention_fwd"
    bwd = (("packed_attention_bwd_dq", "packed_attention_bwd_dkv") if family == "hubert"
           else ("wavlm_attention_bwd_fused", "wavlm_attention_bwd_dkv"))
    L = int(frames(spec, [2.0])[0])
    check(family == "hubert" or wavlm_route(L) == "single", f"WavLM route at L = {L}")
    ins, outs = {}, {}

    def keep(i):
        def hook(mod, args, out):  # returns None: the layer's output stands
            ins[i], outs[i] = args[0], out[0]
        return hook

    hooks = [layer.register_forward_hook(keep(i))
             for i, layer in enumerate(model.encoder.transformer.layers)]
    reset_launch_counts()
    card = forward(model, "cuda")
    torch.cuda.synchronize()
    counts = launch_counts()
    for h in hooks:
        h.remove()
    check(counts == dict(dict.fromkeys(WRAPPERS, 0), **{fwd: n}),
          f"layerdrop {family}: launches {nonzero(counts)}, expected {n} x {fwd}")
    # a dropped layer passes its input on unchanged; the next layer reads it
    identity = {i: torch.equal(ins[i + 1], ins[i]) for i in range(n - 1)}
    check(all(identity[i] == (i in LAYERDROP_DROPPED) for i in identity),
          f"layerdrop {family}: layers whose output was their input {identity}")
    check(all(not torch.equal(outs[i], ins[i]) for i in LAYERDROP_DROPPED),
          f"layerdrop {family}: a dropped layer was not computed")
    cpu_model = copy.deepcopy(model).to("cpu")
    cpu = forward(cpu_model, "cpu")
    del cpu_model
    err = (card.cpu() - cpu).abs().max().item()
    check(err <= MODEL_FP32_TOL, f"layerdrop {family}: fp32 card vs CPU {err}")
    kept = pt.wav2vec2_model(device="cuda", **dict(cfg, encoder_layer_drop=0.0))
    kept.load_state_dict(model.state_dict())
    ones_equal = torch.equal(forward(model, "cuda", layer_drop_u=torch.ones(n)),
                             forward(kept, "cuda", layer_drop_u=None))
    check(ones_equal, f"layerdrop {family}: u = 1 differs from the layer_drop 0 forward")
    del kept
    half = forward(model, "cuda", torch.bfloat16).float()
    bf16_rel = ((half - card).norm() / card.norm()).item()
    check(bf16_rel <= MODEL_BF16_REL_TOL, f"layerdrop {family}: bf16 vs fp32 {bf16_rel}")
    # one backward, fp32, every layer computed and differentiated
    reset_launch_counts()
    out = forward(model, "cuda", grad=True)
    params = [p for p in model.parameters() if p.requires_grad]
    grads = torch.autograd.grad(out.float().square().mean(), params, allow_unused=True)
    torch.cuda.synchronize()
    bwd_counts = launch_counts()
    want = dict(dict.fromkeys(WRAPPERS, 0), **{fwd: n}, **dict.fromkeys(bwd, n),
                pos_conv_dgrad=1)
    check(bwd_counts == want, f"layerdrop {family} backward: launches {nonzero(bwd_counts)}")
    check(all(g is None or bool(torch.isfinite(g).all()) for g in grads),
          f"layerdrop {family}: non-finite gradient")
    del out, grads
    # time: bf16 at B = 8 x 15 s, the uniforms drawn on the card
    T = int(TRAIN_SECONDS * SR)
    big = torch.randn(LAYERDROP_B, T, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(34), dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(35)
    gates = gates_of(model)
    reset_launch_counts()
    times = []
    for i in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y, _ = model.forward(big, gates=gates, training=True, generator=gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        check(bool(torch.isfinite(y).all()), f"layerdrop {family}: non-finite output")
        del y
    timed = launch_counts()
    check(timed == dict(dict.fromkeys(WRAPPERS, 0), **{fwd: 7 * n}),
          f"layerdrop {family}: timed launches {nonzero(timed)}")
    row = {"phase": "layerdrop", "family": family, "layer_drop": LAYERDROP_RATE,
           "dropped": list(LAYERDROP_DROPPED), "check_batch": "2 clips of 2 s, lengths "
           "(32000, 24000), fp32, every dropout rate 0", "L": L,
           "fp32_card_vs_cpu_max_abs": err, "fp32_tol": MODEL_FP32_TOL,
           "dropped_layers_identity": True, "u_ones_equals_layer_drop_0": ones_equal,
           "bf16_vs_fp32_rel": bf16_rel, "bf16_rel_tol": MODEL_BF16_REL_TOL,
           "launches_forward": nonzero(counts), "launches_backward": nonzero(bwd_counts),
           "timed_batch": [LAYERDROP_B, T], "timed_dtype": "bfloat16",
           "forward_ms": 1e3 * statistics.median(times[2:]),
           "forward_ms_calls": [1e3 * t for t in times], "card": nvidia_smi()}
    emit(row)
    row["launches"] = add_counts((1, counts), (1, bwd_counts), (1, timed))
    del model, big
    torch.cuda.empty_cache()
    return row


# ---------------------------------------------------------------------------
# K-step CUDA graphs against eager steps, and the checkpoint path
# ---------------------------------------------------------------------------


def same_snapshot(got, want, what: str) -> int:
    """Two ``device_snapshot``s bit for bit: every tensor, the counters and
    the generator; returns the number of tensors compared."""
    check((got.step, got.count, got.mini_step) == (want.step, want.count, want.mini_step),
          f"{what}: counters {(got.step, got.count, got.mini_step)} vs "
          f"{(want.step, want.count, want.mini_step)}")
    check(torch.equal(got.generator, want.generator), f"{what}: generator states differ")
    got_t, want_t = got.tensors, want.tensors
    check(set(got_t) == set(want_t), f"{what}: tensor names differ")
    diff = [k for k, t in want_t.items() if not torch.equal(got_t[k], t)]
    check(not diff, f"{what}: {len(diff)} of {len(want_t)} tensors differ, e.g. {diff[:3]}")
    return len(want_t)


@contextlib.contextmanager
def deterministic():
    """Deterministic algorithms for the block (cuDNN's, and PyTorch's own,
    warning where it has none): cuDNN's default weight-gradient algorithms
    and the embedding backward of WavLM's bias table sum with atomics, so
    two eager runs of the same steps differ in the last bits (measured:
    55 of 816 tensors of the stage-1 state and 764 of 927 of DPWavLM's
    after 2 steps; with cuDNN's alone, WavLM's 2 table moments still
    differed), and a graph could not be
    held to eager bit for bit."""
    prev = torch.backends.cudnn.deterministic, torch.are_deterministic_algorithms_enabled()
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev[0]
        torch.use_deterministic_algorithms(prev[1])


def phase_graph_train(label, teacher, student, cfg, seed, batch_shape, per_step,
                      audio_per_step, eager_peak, embed_dim: int = 768) -> dict:
    """``steps_per_call=4`` on the card against eager single steps, from
    the same state and generator (``seed``), on a stack of 4 batches that
    stays on the card, dropout on.

    Bits (``deterministic``): the eager run takes 3 groups of 4 steps; the
    graphed run's first call runs its group eagerly and captures it (the
    wrappers count exactly 2 x 4 steps' launches, the eager group's and the
    capture's, and the capture's 4 steps are what ``GraphedSteps``
    tallies as captured), then two replays must equal the eager run after
    8 and 12 steps bit for bit (parameters, moments, count, phase,
    generator, every metric: the second replay shows that each replay
    reads its own steps' scalars).

    Time (cuDNN's default algorithms, as the trainer runs): a fresh state
    and a fresh capture, then 2 segments of 2 replays, and 2 segments of 4
    eager steps, in turns.  ``max_memory_allocated`` of the graphed run
    alone (its eager group, its capture and a replay; the caller's eager
    run has its own), and the memory it reserves.

    Launches: counts set to 0 at the start and read at the end, and every
    step the phase ran, eager or inside a counted replay, must have run
    exactly ``per_step`` (``launch_counts``)."""
    B, T = batch_shape
    gen = torch.Generator(device="cuda").manual_seed(seed + 1000)
    stack = torch.randn(GRAPH_K, B, T, device="cuda", generator=gen)
    ran = 0  # steps run, eager or replayed

    def want(n):
        return {k: n * v for k, v in per_step.items()}

    def fresh():
        return init_train_state(student=student, cfg=cfg, teacher_embed_dim=embed_dim,
                                seed=seed, device="cuda")

    def eager_group(step, state):
        nonlocal ran
        steps = []
        for j in range(GRAPH_K):
            state, m = step(state, (stack[j], None))
            steps.append(m)
        ran += GRAPH_K
        return state, {k: torch.stack([m[k].float() for m in steps]) for k in steps[0]}

    def graph_group(group, state):
        nonlocal ran
        ran += GRAPH_K
        return group(state, (stack, None))

    reset_launch_counts()
    with deterministic():
        a, tx_a = fresh()
        single = make_train_step(teacher, cfg, tx_a)
        eager_metrics, eager_snaps = [], []
        for call in range(3):
            a, metrics = eager_group(single, a)
            eager_metrics.append(metrics)
            if call:
                eager_snaps.append(device_snapshot(a))
        del a, single, tx_a
        b, tx_b = fresh()
        group = make_train_step(teacher, cfg, tx_b, steps_per_call=GRAPH_K)
        before = wrapper_counts()
        b, m = graph_group(group, b)
        counted = {k: v - before[k] for k, v in wrapper_counts().items()}
        check(counted == want(2 * GRAPH_K), f"{label}: the first call's wrappers counted "
              f"{counted}, expected its eager group's and its capture's, 2 x {GRAPH_K} steps")
        check(GraphedSteps.captured == nonzero(want(GRAPH_K)),
              f"{label}: captured {GraphedSteps.captured}, expected {GRAPH_K} steps")
        for k, v in eager_metrics[0].items():
            check(torch.equal(m[k], v), f"{label}: the first (eager) group's {k} differs")
        n_tensors = 0
        for r in range(2):
            b, m = graph_group(group, b)
            n_tensors = same_snapshot(device_snapshot(b), eager_snaps[r],
                                      f"{label} replay {r + 1}")
            for k, v in eager_metrics[r + 1].items():
                check(torch.equal(m[k], v), f"{label} replay {r + 1}: metric {k} "
                      f"{m[k].tolist()} vs eager {v.tolist()}")
        check(GraphedSteps.replays == 2
              and GraphedSteps.replayed == nonzero(want(2 * GRAPH_K)),
              f"{label}: {GraphedSteps.replays} replays ran {GraphedSteps.replayed}")
        del b, group, tx_b, eager_snaps
        gc.collect()
        torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    b, tx_b = fresh()
    group = make_train_step(teacher, cfg, tx_b, steps_per_call=GRAPH_K)
    t0 = time.perf_counter()
    b, m = graph_group(group, b)
    torch.cuda.synchronize()
    first_call_s = time.perf_counter() - t0
    b, m = graph_group(group, b)
    torch.cuda.synchronize()
    graph_peak = torch.cuda.max_memory_allocated()  # one state, its graph and its eager group
    graph_reserved = torch.cuda.memory_reserved()
    a, tx_a = fresh()
    single = make_train_step(teacher, cfg, tx_a)
    a, _ = eager_group(single, a)  # warm
    eager_seg, graph_seg = [], []
    for _ in range(GRAPH_TIMED_SEGMENTS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(GRAPH_TIMED_REPLAYS):
            b, m = graph_group(group, b)
        torch.cuda.synchronize()
        graph_seg.append((time.perf_counter() - t0) / (GRAPH_TIMED_REPLAYS * GRAPH_K))
        t0 = time.perf_counter()
        a, _ = eager_group(single, a)
        torch.cuda.synchronize()
        eager_seg.append((time.perf_counter() - t0) / GRAPH_K)
    for k, v in m.items():
        check(bool(torch.isfinite(v).all()), f"{label}: {k} = {v.tolist()}")
    check(len(group.graphs) == 1, f"{label}: {len(group.graphs)} graphs for one key")
    counts = launch_counts()
    check(counts == want(ran), f"{label}: {ran} steps ran {counts}, expected {per_step} a step")
    eager_s, graph_s = statistics.median(eager_seg), statistics.median(graph_seg)
    row = {"phase": "graph_train", "path": label, "k": GRAPH_K, "batch": [B, T],
           "dtype": cfg.compute_dtype, "bit_exact_replays": 2, "tensors_compared": n_tensors,
           "metrics_compared": sorted(eager_metrics[0]),
           "eager_step_s": eager_s, "eager_segments_s": eager_seg,
           "graph_step_s": graph_s, "graph_segments_s": graph_seg,
           "graph_over_eager": graph_s / eager_s,
           "eager_audio_sec_per_s": audio_per_step / eager_s,
           "graph_audio_sec_per_s": audio_per_step / graph_s,
           "first_call_s": first_call_s,
           "graph_peak_memory_bytes": graph_peak, "graph_reserved_bytes": graph_reserved,
           "eager_peak_memory_bytes": eager_peak, "graph_over_eager_peak": graph_peak / eager_peak,
           "launches_per_replay": want(GRAPH_K), "steps_run": ran,
           "replays": GraphedSteps.replays, "launches": counts,
           "launches_in_graphs": dict(GraphedSteps.replayed)}
    emit(row)
    del a, b, group, single, tx_a, tx_b, stack
    gc.collect()
    torch.cuda.empty_cache()
    return row


def rung_ladder(seconds_per_batch: float):
    """The loader's (batch size, samples) shapes at ``seconds_per_batch``:
    ``cli/common.py``'s 12 rungs from 32,000 to 250,000 samples."""
    batcher = StaticShapeBatcher([250_000], max_token_count=int(seconds_per_batch * SR),
                                 min_len=32_000, max_len=250_000, num_shapes=12)
    return [(batcher.batch_sizes[r], r) for r in batcher.rungs]


def phase_graph_keys(label, teacher, student, cfg, seed, seconds_per_batch,
                     embed_dim: int = 768, interleaved: bool = True, rungs=None) -> dict:
    """Many keys in the one shared pool of ``GraphedSteps``, at full width,
    on the loader's ladder at ``seconds_per_batch`` (the recipe's 12
    shapes, or the rungs of it that ``rungs`` indexes; dropout on, bf16).

    ``interleaved`` (``deterministic``): two keys, the top rung and a
    short one, called A B A B (each key's first group eager and captured,
    then a replay each, in turn) against the same 16 eager single steps:
    bit for bit after every group, so no replay overwrites what another
    graph left live.

    Memory (cuDNN's default algorithms, as the trainer runs): one eager
    step on every rung (the eager peak), then all its keys captured into
    the pool and each replayed once, in turn (timed as one cycle): peak
    and reserved memory against eager's, and what stays reserved once the
    allocator's cache is emptied (the graphs' pool and the live state).
    Launches: every step run, eager or replayed, exactly its rung's."""
    ladder = rung_ladder(seconds_per_batch)
    full_ladder = len(ladder)
    if rungs is not None:
        ladder = [ladder[i] for i in rungs]
    per_rung = {}
    for B, T in ladder:
        L = int(output_lengths(teacher.spec, torch.tensor([T]))[0])
        per_rung[(B, T)] = add_counts((1, model_launches(teacher.spec, L, False)),
                                      (1, model_launches(student.spec, L, True)))
    gen = torch.Generator(device="cuda").manual_seed(seed + 2000)
    stacks = {}

    def stack(shape):
        if shape not in stacks:
            stacks[shape] = torch.randn(GRAPH_K, *shape, device="cuda", generator=gen)
        return stacks[shape]

    def fresh():
        return init_train_state(student=student, cfg=cfg, teacher_embed_dim=embed_dim,
                                seed=seed, device="cuda")

    expected = dict.fromkeys(WRAPPERS, 0)

    def ran(shape, n):
        for k, v in per_rung[shape].items():
            expected[k] += n * v

    reset_launch_counts()
    row = {"phase": "graph_keys", "path": label, "k": GRAPH_K, "dtype": cfg.compute_dtype,
           "seconds_per_batch": seconds_per_batch, "ladder": ladder,
           "rungs_of_ladder": f"{len(ladder)} of {full_ladder}"}
    if interleaved:
        keys = [ladder[-1], ladder[len(ladder) // 2]]
        with deterministic():
            a, tx_a = fresh()
            b, tx_b = fresh()
            single = make_train_step(teacher, cfg, tx_a)
            group = make_train_step(teacher, cfg, tx_b, steps_per_call=GRAPH_K)
            for call in range(4):
                shape = keys[call % 2]
                waves = stack(shape)
                want = []
                for j in range(GRAPH_K):
                    a, m = single(a, (waves[j], None))
                    want.append(m)
                b, got = group(b, (waves, None))
                ran(shape, 2 * GRAPH_K)
                n_tensors = same_snapshot(device_snapshot(b), device_snapshot(a),
                                          f"{label} interleaved group {call} {shape}")
                for k, v in got.items():
                    check(torch.equal(v, torch.stack([m[k].float() for m in want])),
                          f"{label} interleaved group {call}: metric {k}")
            check(len(group.graphs) == 2 and GraphedSteps.replays == 2,
                  f"{label}: {len(group.graphs)} graphs, {GraphedSteps.replays} replays")
            row.update(interleaved_keys=keys, interleaved_groups=4, interleaved_replays=2,
                       interleaved_bit_exact_tensors=n_tensors)
            del a, b, tx_a, tx_b, single, group
            gc.collect()
            torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    b, tx_b = fresh()
    single = make_train_step(teacher, cfg, tx_b)
    for shape in ladder:
        b, m = single(b, (stack(shape)[0], None))
        ran(shape, 1)
    torch.cuda.synchronize()
    eager = {"peak_allocated": torch.cuda.max_memory_allocated(),
             "peak_reserved": torch.cuda.max_memory_reserved(),
             "reserved": torch.cuda.memory_reserved()}
    torch.cuda.reset_peak_memory_stats()
    group = make_train_step(teacher, cfg, tx_b, steps_per_call=GRAPH_K)
    replays0 = GraphedSteps.replays
    t0 = time.perf_counter()
    for shape in ladder:  # each key's first group: eager, then captured
        b, m = group(b, (stack(shape), None))
        ran(shape, GRAPH_K)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for shape in ladder:  # one replay of every key, in turn
        b, m = group(b, (stack(shape), None))
        ran(shape, GRAPH_K)
    torch.cuda.synchronize()
    cycle_s = time.perf_counter() - t0
    for k, v in m.items():
        check(bool(torch.isfinite(v).all()), f"{label}: {k} = {v.tolist()}")
    check(len(group.graphs) == len(ladder) and GraphedSteps.replays - replays0 == len(ladder),
          f"{label}: {len(group.graphs)} graphs, {GraphedSteps.replays - replays0} replays "
          f"for {len(ladder)} keys")
    graphs = {"peak_allocated": torch.cuda.max_memory_allocated(),
              "peak_reserved": torch.cuda.max_memory_reserved(),
              "reserved": torch.cuda.memory_reserved(),
              "allocated": torch.cuda.memory_allocated()}
    torch.cuda.empty_cache()
    graphs["reserved_after_empty_cache"] = torch.cuda.memory_reserved()
    counts = launch_counts()
    check(counts == expected, f"{label}: launches {counts}, expected {expected}")
    audio = sum(B * T for B, T in ladder) * GRAPH_K / SR
    row.update(keys_captured=len(group.graphs), eager_memory=eager, graph_memory=graphs,
               graph_over_eager_peak_reserved=graphs["peak_reserved"] / eager["peak_reserved"],
               capture_seconds_all_keys=capture_s, replay_cycle_s=cycle_s,
               replay_cycle_audio_sec_per_s=audio / cycle_s,
               replays=GraphedSteps.replays, launches=counts,
               launches_in_graphs=dict(GraphedSteps.replayed))
    emit(row)
    del b, tx_b, single, group, stacks
    gc.collect()
    torch.cuda.empty_cache()
    return row


CKPT_SAVES = 7  # timed background saves (and one more for the resume)
# of the recipes' 12 rungs, the first, middle and top (each holds about
# the same audio, so each costs alike): the smoke's time
LADDER_RUNGS = (0, 6, 11)


def phase_ckpt(large: dict) -> dict:
    """The checkpoint path on the HuBERT Base stage-1 state (bf16 step at B
    = 16 x 15 s, dropout on), timed under cuDNN's default algorithms, as
    the trainer runs: the synchronous ``last.pt`` write; then 7
    background saves, each after one step alone (no save in flight):
    ``submit``'s host time (the device snapshot), the step right after it
    with only the pinned copy on the side stream beside it (the writer
    holds the write until that step ends), and the steps while the file is
    written.  Between the 4th and the 5th, under deterministic algorithms
    (``deterministic``), a fresh state resumed from a background-written
    file and stepped 2 steps must equal the live run bit for bit.
    Rotation under ``keep`` = 3 over the 8 saves; ``background_ckpt_fits``
    for this state and for the Large one (``large``, from
    ``phase_large_train``)."""
    ck_dir = REPO / "build" / "smoke_ckpt"
    shutil.rmtree(ck_dir, ignore_errors=True)
    ck_dir.mkdir(parents=True)
    teacher, student = distill_models("cuda")
    cfg = DistillConfig(compute_dtype="bfloat16")
    state, tx = init_train_state(student=student, cfg=cfg, teacher_embed_dim=768, seed=27,
                                 device="cuda")
    step = make_train_step(teacher, cfg, tx)
    gen = torch.Generator(device="cuda").manual_seed(28)
    T = int(TRAIN_SECONDS * SR)
    batches = [torch.randn(TRAIN_B, T, device="cuda", generator=gen) for _ in range(2)]

    def timed_step(i):
        nonlocal state
        t0 = time.perf_counter()
        state, _ = step(state, (batches[i % 2], None))
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    for i in range(2):  # warm
        timed_step(i)
    t0 = time.perf_counter()
    save_train_state(ck_dir / "last.pt", state)
    sync_write_s = time.perf_counter() - t0
    file_bytes = (ck_dir / "last.pt").stat().st_size

    mgr = RotatingCheckpointer(ck_dir / "rotated", keep=3)
    events, copied_only = [], threading.Event()

    def write(snap, **kw):
        events.append(time.perf_counter())  # the snapshot is on the host
        copied_only.wait()  # held until the step beside the copy has ended
        mgr.save(snap.step, snap, **kw)
        events.append(time.perf_counter())

    def gated_save():
        """a step alone, submit, one step beside the copy alone, then the
        write: returns (step alone s, submit s, copy step s, steps beside
        the write, copy done s, write done s, whether the copy landed
        within its step)."""
        alone = timed_step(1)
        events.clear()
        copied_only.clear()
        t0 = time.perf_counter()
        saver.submit(state)
        submit = time.perf_counter() - t0
        copy_step = timed_step(0)
        within = bool(events)
        copied_only.set()
        beside = []
        while saver.in_flight():
            beside.append(timed_step(len(beside) + 1))
        check(len(events) == 2, "the background save did not land")
        return alone, submit, copy_step, beside, events[0] - t0, events[1] - t0, within

    saver = BackgroundSaver(write)
    t0 = time.perf_counter()
    saver.reserve(state)  # the trainer pins the buffers before its first step
    reserve_s = time.perf_counter() - t0
    saves = [gated_save() for _ in range(CKPT_SAVES // 2 + 1)]

    # resume from a background-written file: a fresh state (another seed)
    # loaded from it and stepped on the same 2 batches equals the live run
    with deterministic():
        resume_step = state.step
        copied_only.set()
        saver.submit(state)
        for i in range(2):
            timed_step(i)
        saver.wait()
        live = device_snapshot(state)
        fresh, fresh_tx = init_train_state(student=student, cfg=cfg, teacher_embed_dim=768,
                                           seed=99, device="cuda")
        pos = load_train_state(mgr.path(resume_step), fresh)
        fresh_step = make_train_step(teacher, cfg, fresh_tx)
        for i in range(2):
            fresh, _ = fresh_step(fresh, (batches[i], None))
        n_tensors = same_snapshot(device_snapshot(fresh), live, "resume from a background file")
        del fresh, fresh_tx, fresh_step, live

    saves += [gated_save() for _ in range(CKPT_SAVES - len(saves))]
    check(saver.close() is None, "background save failed")
    on_disk = sorted(p.name for p in mgr.directory.iterdir())
    check(len(on_disk) == 3 and mgr.path(resume_step).name not in on_disk,
          f"rotation under keep 3 left {on_disk}")
    alone, submit_s, copy_steps, beside, copy_s, write_s, within = (list(x) for x in zip(*saves))
    beside = [t for b in beside for t in b]
    paired = [c / a for c, a in zip(copy_steps, alone)]
    base_bytes = snapshot_bytes(state)
    alone_s = statistics.median(alone)
    row = {"phase": "ckpt", "state": "hubert_base stage 1 (gated student, moments)",
           "timed_under": "cuDNN's default algorithms (the resume's bits: deterministic)",
           "state_bytes": base_bytes, "file_bytes": file_bytes,
           "sync_write_s": sync_write_s, "reserve_pinned_s": reserve_s,
           "background_saves": len(saves), "submit_s": submit_s,
           "background_copy_done_s": copy_s, "copy_done_within_its_step": within,
           "background_write_done_s": write_s,
           "step_alone_s": alone, "step_alone_min_median_max_s": [min(alone), alone_s, max(alone)],
           "steps_copy_in_flight_s": copy_steps, "steps_write_in_flight_s": beside,
           "copy_steps_median_over_alone": statistics.median(copy_steps) / alone_s,
           "copy_step_over_its_alone_step": paired,
           "copy_step_over_its_alone_step_median": statistics.median(paired),
           "write_steps_median_over_alone": statistics.median(beside) / alone_s,
           "rotated_on_disk": on_disk, "resume_bit_exact_tensors": n_tensors,
           "resume_position": list(pos),
           "background_ckpt_fits": {"base": background_ckpt_fits(state),
                                    "large": large["fits"]},
           "snapshot_bytes": {"base": base_bytes, "large": large["bytes"]},
           "card_total_bytes": torch.cuda.mem_get_info()[1]}
    emit(row)
    del state, tx, step, batches
    shutil.rmtree(ck_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    return row


def write_wav(path, wave: np.ndarray) -> None:
    """16 kHz mono PCM16 WAV."""
    pcm = (np.clip(wave, -1, 1) * 32767).astype("<i2").tobytes()
    with open(path, "wb") as f:
        f.write(b"RIFF" + (36 + len(pcm)).to_bytes(4, "little") + b"WAVE")
        f.write(b"fmt " + (16).to_bytes(4, "little") + (1).to_bytes(2, "little")
                + (1).to_bytes(2, "little") + SR.to_bytes(4, "little")
                + (2 * SR).to_bytes(4, "little") + (2).to_bytes(2, "little")
                + (16).to_bytes(2, "little"))
        f.write(b"data" + len(pcm).to_bytes(4, "little") + pcm)


def write_corpus(pipe_dir: pathlib.Path, rng):
    """15 training and 5 validation WAVs of 249,920-250,000 samples (all on
    the loader's top rung) and their manifests -> (root, tsv)."""
    shutil.rmtree(pipe_dir, ignore_errors=True)
    root, tsv = pipe_dir / "librispeech", pipe_dir / "tsv"
    for sub, prefix, n in (("train-clean-100/1/2", "u", 3 * FINAL_B),
                           ("dev-clean/3/4", "d", FINAL_B)):
        (root / sub).mkdir(parents=True)
        for i in range(n):
            samples = TOP_RUNG + int(rng.integers(0, 81))  # 15.62-15.625 s: the top rung
            write_wav(root / sub / f"{prefix}{i:03d}.wav", 0.1 * rng.standard_normal(samples))
    cli_prepare_data.cli_main(["--data", str(root), "--out", str(tsv), "--extension", "wav"])
    return root, tsv


GRAPH_RUNGS = ((TOP_RUNG, 40), (142_400, 72))  # (rung, clips): 8 batches each at 87.5 s


def write_graph_corpus(corpus_dir: pathlib.Path, rng):
    """A corpus on two of the loader's rungs with 8 batches each at the
    default 87.5 s a batch (40 clips of 249,920-250,000 samples, B = 5;
    72 of 142,400-142,480, B = 9), so that ``--steps_per_dispatch 4``
    forms two groups on each shape, and the usual 5 validation clips ->
    (root, tsv)."""
    root, tsv = corpus_dir / "librispeech", corpus_dir / "tsv"
    shutil.rmtree(corpus_dir, ignore_errors=True)
    train = root / "train-clean-100/5/6"
    train.mkdir(parents=True)
    i = 0
    for rung, n in GRAPH_RUNGS:
        for _ in range(n):
            samples = rung + int(rng.integers(0, 81))
            write_wav(train / f"g{i:03d}.wav", 0.1 * rng.standard_normal(samples))
            i += 1
    (root / "dev-clean/7/8").mkdir(parents=True)
    for i in range(FINAL_B):
        write_wav(root / "dev-clean/7/8" / f"d{i:03d}.wav",
                  0.1 * rng.standard_normal(TOP_RUNG + int(rng.integers(0, 81))))
    cli_prepare_data.cli_main(["--data", str(root), "--out", str(tsv), "--extension", "wav"])
    return root, tsv


class Stages:
    """Runs pipeline stages through their CLI functions: launch counts set
    to 0 just before each stage and read just after, and held to exactly
    what its steps and its validation pass need."""

    def __init__(self, spec_t, L: int, valid_batches: int):
        self.spec_t, self.L, self.valid_batches = spec_t, L, valid_batches
        self.rows, self.total = [], dict.fromkeys(WRAPPERS, 0)

    def _add(self, row):
        for k in self.total:
            self.total[k] += row["launches"][k]
        self.rows.append(row)
        emit({"phase": "pipeline_stage", **row})

    def run(self, label, module, argv, *, student_spec=None, steps=0, valid_passes=0, code=0):
        reset_launch_counts()
        t = time.perf_counter()
        try:
            module.cli_main(argv)
            got = 0
        except SystemExit as exit_:
            got = exit_.code
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        counts = launch_counts()
        check(got == code, f"pipeline {label}: exit {got}, expected {code}")
        row = {"stage": label, "exit": got, "seconds": seconds, "launches": counts}
        if student_spec is not None:
            per_step = add_counts((1, model_launches(self.spec_t, self.L, False)),
                                  (1, model_launches(student_spec, self.L, True)))
            per_valid = add_counts((1, model_launches(self.spec_t, self.L, False)),
                                   (1, model_launches(student_spec, self.L, False)))
            want = add_counts((steps, per_step), (valid_passes * self.valid_batches, per_valid))
            check(counts == want, f"pipeline {label}: launches {counts}, expected {want}")
            row.update(steps=steps, validation_batches=valid_passes * self.valid_batches,
                       launches_per_step=per_step, launches_per_validation_batch=per_valid)
        self._add(row)
        torch.cuda.empty_cache()
        return row

    def serve(self, final, root, rng):
        """The final checkpoint served: bf16 through the Predictor on the
        corpus's validation clips and two short ones; fp32 card against the
        CPU per layer."""
        reset_launch_counts()
        model = load_model(final, device="cuda")
        clips = [load_audio(p)[0][0] for p in sorted((root / "dev-clean/3/4").glob("*.wav"))]
        clips += [(0.1 * rng.standard_normal(n)).astype(np.float32) for n in (32000, 56000)]
        feats = Predictor(model, dtype=torch.bfloat16).extract(clips)
        for c, f in zip(clips, feats):
            n = int(output_lengths(model.spec, torch.tensor([len(c)]))[0])
            check(f.shape == (n, 768) and np.isfinite(f).all(), f"served features {f.shape}")
        err = per_layer_card_vs_cpu(model, copy.deepcopy(model).to("cpu"), clips[-2:])
        self._add({"stage": "serve final checkpoint", "clips": len(clips),
                   "fp32_card_vs_cpu_max_abs": err, "launches": launch_counts()})
        return model.spec


def phase_pipeline() -> dict:
    """run.sh's recipe on the card at full width: prepare_data, stage-1
    distill (3 updates; again with a deadline in the past, exit 76, then
    resumed to the end), prune, final distill of the pruned student (2
    updates) and of the r2-heads student (3 updates, the flash route),
    save_final_ckpt, and the final checkpoint served.  Each stage runs
    through its CLI function with the default flags (bf16, 87.5 s per
    batch: B = 5 x 249,920 samples) and --device cuda; launch counts are set
    to 0 just before each stage and must be exactly what its steps and its
    validation pass need."""
    pipe_dir = REPO / "build" / "smoke_pipeline"
    rng = np.random.default_rng(11)
    t0 = time.perf_counter()
    root, tsv = write_corpus(pipe_dir, rng)
    teacher = pt.hubert_base(device="cpu", generator=torch.Generator().manual_seed(0))
    teacher_ckpt = pipe_dir / "hubert_base_teacher.pth"
    save_checkpoint(teacher_ckpt, teacher.config, teacher.state_dict())
    spec_t = teacher.spec
    del teacher
    L = int(output_lengths(spec_t, torch.tensor([TOP_RUNG]))[0])
    common = ["--tsv_dir", str(tsv), "--train_subset", "train100",
              "--teacher_ckpt", str(teacher_ckpt), "--log_interval", "1",
              "--num_workers", "4", "--device", "cuda",
              "--steps_per_dispatch", str(GRAPH_K), "--ckpt_backend", "rotated"]
    stages = Stages(spec_t, L, valid_batches=1)

    exp1, exp1b = pipe_dir / "stage1", pipe_dir / "stage1_deadline"
    stages.run("distill", cli_distill, common + ["--student_ckpt", str(teacher_ckpt),
                                                 "--exp_dir", str(exp1), "--max_updates", "3"],
               student_spec=spec_t, steps=3, valid_passes=1)
    distilled = exp1 / "ckpts" / "distilled.pth"
    check(distilled.exists(), "stage 1 wrote no distilled.pth")
    argv1b = common + ["--student_ckpt", str(teacher_ckpt), "--exp_dir", str(exp1b),
                       "--max_updates", "3"]
    os.environ["DPHUBERT_DEADLINE_TS"] = "1"  # 1970: always past
    try:
        stages.run("distill, deadline", cli_distill, argv1b, student_spec=spec_t, steps=1,
                   code=76)
    finally:
        del os.environ["DPHUBERT_DEADLINE_TS"]
    last = exp1b / "ckpts" / "rotated"
    check((last / "step_1.pt").exists() and not (exp1b / "ckpts" / "distilled.pth").exists(),
          "the deadline stop must checkpoint (ckpts/rotated/step_1.pt) and export nothing")
    stages.run("distill, resumed", cli_distill, argv1b + ["--resume_checkpoint", str(last)],
               student_spec=spec_t, steps=2, valid_passes=1)
    check((exp1b / "ckpts" / "distilled.pth").exists(), "the resumed stage 1 exported nothing")
    rotated = sorted(p.name for p in last.glob("step_*.pt"))
    check(rotated == ["step_1.pt", "step_3.pt"], f"stage 1 resumed: rotated files {rotated}")
    graphs = phase_pipeline_graphs(pipe_dir, stages, teacher_ckpt, rng)

    stages.run("prune", cli_prune, ["--distilled_ckpt", str(distilled),
                                    "--original_ckpt", str(teacher_ckpt)])
    pruned = exp1 / "ckpts" / "pruned_hubert_base.pth"
    pruned_cfg = load_checkpoint(pruned)["config"]
    exp2 = pipe_dir / "stage2"
    stages.run("final_distill", cli_final_distill,
               common + ["--student_ckpt", str(pruned), "--exp_dir", str(exp2),
                         "--max_updates", "2"],
               student_spec=pt.spec_from_config(**pruned_cfg), steps=2, valid_passes=1)

    r2_cfg = r2_all_attention_config()
    r2 = pt.wav2vec2_model(device="cpu", generator=torch.Generator().manual_seed(7), **r2_cfg)
    r2_ckpt = pipe_dir / "r2_all_attention.pth"
    save_checkpoint(r2_ckpt, r2_cfg, r2.state_dict())
    del r2
    r2_spec = pt.spec_from_config(**r2_cfg)
    r2_row = stages.run("final_distill, r2 heads", cli_final_distill,
                        common + ["--student_ckpt", str(r2_ckpt),
                                  "--exp_dir", str(pipe_dir / "stage2_r2"), "--max_updates", "3"],
                        student_spec=r2_spec, steps=3, valid_passes=1)
    check(r2_row["launches_per_step"]["flash_attention_fwd"] == 2
          and r2_row["launches_per_step"]["flash_attention_bwd_dq"] == 2
          and r2_row["launches_per_step"]["flash_attention_bwd_dkv"] == 2,
          f"r2 final distill: flash launches per step {r2_row['launches_per_step']}")

    stages.run("save_final_ckpt", cli_save_final_ckpt,
               ["--config_path", str(pruned),
                "--ckpt_after_final_distill", str(exp2 / "ckpts" / "distilled.pth")])
    final = exp2 / "ckpts" / "pruned_hubert_base.pth"
    stages.run("load_dpmodel", cli_load_dpmodel, [str(final), "--device", "cuda"])
    stages.serve(final, root, rng)
    row = {"phase": "pipeline", "seconds": time.perf_counter() - t0,
           "pruned_config": {k: pruned_cfg[k] for k in ("encoder_num_heads",
                                                          "encoder_ff_interm_features",
                                                          "encoder_use_attention")},
           "launches": stages.total, "launches_in_graphs": graphs}
    emit(row)
    shutil.rmtree(pipe_dir, ignore_errors=True)
    return row


def phase_pipeline_graphs(pipe_dir, stages, teacher_ckpt, rng) -> dict:
    """Stage 1 through the CLI on the two-rung corpus (``write_graph_corpus``):
    16 updates with ``--steps_per_dispatch 1`` and then with 4 (a rotated
    background checkpoint every 4 steps, so the capture after the first
    group waits for a save in flight), each from the teacher.  With K = 4
    the loader's runs form 4 groups, 2 on each shape: 2 keys captured into
    one pool and each replayed once (counted), and every update's launches
    ran (``Stages``).  Peak and reserved memory of both runs;
    returns the launches that ran inside replays."""
    root, tsv = write_graph_corpus(pipe_dir / "graphs", rng)
    spec_t = stages.spec_t
    per_rung = [model_launches(spec_t, int(output_lengths(spec_t, torch.tensor([r]))[0]), True)
                for r, _ in GRAPH_RUNGS]
    check(per_rung[0] == per_rung[1], f"stage 1 launches differ by rung: {per_rung}")
    argv = ["--tsv_dir", str(tsv), "--train_subset", "train100",
            "--teacher_ckpt", str(teacher_ckpt), "--student_ckpt", str(teacher_ckpt),
            "--log_interval", "1", "--num_workers", "4", "--device", "cuda",
            "--max_updates", "16", "--ckpt_interval", "4", "--ckpt_backend", "rotated"]
    memory = {}
    for k in (1, GRAPH_K):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        exp = pipe_dir / f"stage1_graphs_k{k}"
        stages.run(f"distill, two rungs, K = {k}", cli_distill,
                   argv + ["--exp_dir", str(exp), "--steps_per_dispatch", str(k)],
                   student_spec=spec_t, steps=16, valid_passes=1)
        memory[f"k{k}"] = {"peak_allocated": torch.cuda.max_memory_allocated(),
                           "peak_reserved": torch.cuda.max_memory_reserved()}
        rotated = sorted(p.name for p in (exp / "ckpts" / "rotated").glob("step_*.pt"))
        check(rotated == ["step_12.pt", "step_16.pt", "step_8.pt"],
              f"K = {k}: rotated files {rotated}")
        steps = [json.loads(line)["step"] for line in (exp / "metrics.jsonl").open()]
        check(steps == list(range(1, 17)), f"K = {k}: logged steps {steps}")
    per_step = stages.rows[-1]["launches_per_step"]
    in_graphs = dict(GraphedSteps.replayed)
    check(GraphedSteps.replays == 2 and in_graphs == nonzero({n: 2 * GRAPH_K * v
                                                             for n, v in per_step.items()}),
          f"K = 4 through the CLI: {GraphedSteps.replays} replays ran {in_graphs}; "
          "expected 2 keys, each captured once and replayed once")
    emit({"phase": "pipeline_graphs", "rungs": GRAPH_RUNGS, "updates": 16, "k": GRAPH_K,
          "keys": 2, "replays": GraphedSteps.replays, "memory": memory,
          "k4_over_k1_peak_reserved": memory[f"k{GRAPH_K}"]["peak_reserved"]
          / memory["k1"]["peak_reserved"],
          "seconds": {r["stage"]: r["seconds"] for r in stages.rows[-2:]}})
    shutil.rmtree(pipe_dir / "graphs", ignore_errors=True)
    return in_graphs


def phase_wavlm_pipeline() -> dict:
    """The DPWavLM recipe through the port's CLI functions at full width, on
    the corpus of ``phase_pipeline``: a ``wavlm_base`` teacher checkpoint
    (random weights), stage-1 distill of the gated WavLM student (3
    updates), prune (which emits ``encoder_remaining_heads``), final
    distill of the pruned WavLM student (2 updates), save_final_ckpt,
    load_dpmodel and the final checkpoint served; default flags (bf16, B =
    5 x 249,920 samples) and --device cuda, launch counts exact per stage."""
    pipe_dir = REPO / "build" / "smoke_pipeline_wavlm"
    rng = np.random.default_rng(13)
    t0 = time.perf_counter()
    root, tsv = write_corpus(pipe_dir, rng)
    teacher = pt.wavlm_base(device="cpu", generator=torch.Generator().manual_seed(0))
    teacher_ckpt = pipe_dir / "wavlm_base_teacher.pth"
    save_checkpoint(teacher_ckpt, teacher.config, teacher.state_dict())
    spec_t = teacher.spec
    del teacher
    L = int(output_lengths(spec_t, torch.tensor([TOP_RUNG]))[0])
    common = ["--tsv_dir", str(tsv), "--train_subset", "train100",
              "--teacher_ckpt", str(teacher_ckpt), "--log_interval", "1",
              "--num_workers", "4", "--device", "cuda",
              "--steps_per_dispatch", str(GRAPH_K), "--ckpt_backend", "rotated"]
    stages = Stages(spec_t, L, valid_batches=1)
    exp1, exp2 = pipe_dir / "stage1", pipe_dir / "stage2"
    stages.run("wavlm distill", cli_distill, common + ["--student_ckpt", str(teacher_ckpt),
                                                       "--exp_dir", str(exp1),
                                                       "--max_updates", "3"],
               student_spec=spec_t, steps=3, valid_passes=1)
    distilled = exp1 / "ckpts" / "distilled.pth"
    stages.run("wavlm prune", cli_prune, ["--distilled_ckpt", str(distilled),
                                          "--original_ckpt", str(teacher_ckpt)])
    pruned = exp1 / "ckpts" / "pruned_hubert_base.pth"
    pruned_cfg = load_checkpoint(pruned)["config"]
    check(all(isinstance(h, list) for h in pruned_cfg["encoder_remaining_heads"])
          and pruned_cfg["encoder_total_num_heads"] == [12] * 12,
          f"WavLM prune: {pruned_cfg.get('encoder_remaining_heads')}")
    stages.run("wavlm final_distill", cli_final_distill,
               common + ["--student_ckpt", str(pruned), "--exp_dir", str(exp2),
                         "--max_updates", "2"],
               student_spec=pt.spec_from_config(**pruned_cfg), steps=2, valid_passes=1)
    stages.run("wavlm save_final_ckpt", cli_save_final_ckpt,
               ["--config_path", str(pruned),
                "--ckpt_after_final_distill", str(exp2 / "ckpts" / "distilled.pth")])
    final = exp2 / "ckpts" / "pruned_hubert_base.pth"
    stages.run("wavlm load_dpmodel", cli_load_dpmodel, [str(final), "--device", "cuda"])
    served = stages.serve(final, root, rng)
    check(served.is_wavlm, "the final WavLM checkpoint did not serve as WavLM")
    row = {"phase": "wavlm_pipeline", "seconds": time.perf_counter() - t0,
           "pruned_config": {k: pruned_cfg[k] for k in ("encoder_remaining_heads",
                                                          "encoder_ff_interm_features",
                                                          "encoder_use_attention")},
           "launches": stages.total}
    emit(row)
    shutil.rmtree(pipe_dir, ignore_errors=True)
    return row


# ---------------------------------------------------------------------------
# Phase 9: wav2vec 2.0 Large (run_large.sh): fairseq import, serving, the
# stage-1 step with and without remat; then run_torch.sh itself
# ---------------------------------------------------------------------------


# our names -> fairseq's: the inverse of interop/hf.py's fairseq renames
_TO_FAIRSEQ = (
    ("encoder.feature_projection.projection.", "post_extract_proj."),
    ("encoder.feature_projection.layer_norm.", "layer_norm."),
    ("encoder.transformer.pos_conv_embed.conv.", "encoder.pos_conv.0."),
    ("encoder.transformer.layer_norm.", "encoder.layer_norm."),
    ("encoder.transformer.layers.", "encoder.layers."),
)


def to_fairseq(sd: dict) -> dict:
    """A state dict in our names -> a fairseq wav2vec 2.0 checkpoint's
    ``model`` entry (``dummy_weight``, which fairseq does not have, left
    out)."""
    out = {}
    for k, v in sd.items():
        if k == "feature_extractor.dummy_weight":
            continue
        parts = k.split(".")
        if k.startswith("feature_extractor.conv_layers."):
            sub = "0" if parts[3] == "conv" else "2"
            out[f"feature_extractor.conv_layers.{parts[2]}.{sub}.{parts[-1]}"] = v
            continue
        for ours, theirs in _TO_FAIRSEQ:
            if k.startswith(ours):
                k = theirs + k[len(ours):]
                break
        if k.startswith("encoder.layers."):
            k = k.replace(".attention.", ".self_attn.")
            k = k.replace(".layer_norm.", ".self_attn_layer_norm.")
            k = k.replace(".feed_forward.intermediate_dense.", ".fc1.")
            k = k.replace(".feed_forward.output_dense.", ".fc2.")
        out[k] = v
    return out


def phase_large_kernels(spec) -> dict:
    """The packed kernels at the Large stage-1 shape: B = 12 clips of 15 s
    (L = 749), 16 heads of 64 (two head groups in the TPU package's
    routing, a shape no earlier path ran), bf16 with dropout 0.1, against
    their plain versions and timed beside their bound and the library;
    then the dropout mask read out of the forward and the backward pair at
    12 x 16 heads through both bodies (bf16 at L = 200, where its codes
    survive; fp32 at L = 749)."""
    L = int(frames(spec, [TRAIN_SECONDS])[0])
    check(packed_num_groups(L, LARGE_HEADS, 64) == 2,
          f"Large: packed_num_groups({L}, 16, 64) = {packed_num_groups(L, LARGE_HEADS, 64)}")
    rows = phase_train_kernels(spec, cases=[("large_train", LARGE_B, L, LARGE_HEADS, None)],
                               dtypes=(torch.bfloat16,), path="large_train")
    readout = ((torch.bfloat16, 200), (torch.float32, L))
    phase_mask_readout("packed", "large_train", B=LARGE_B, H=LARGE_HEADS, cases=readout)
    phase_forward_mask_readout("packed", "large_train", B=LARGE_B, H=LARGE_HEADS, cases=readout)
    return rows


def phase_large_convert():
    """A seeded ``wav2vec2_large`` written as a fairseq checkpoint (``{"model":
    state dict in fairseq's names}``), converted with ``convert_from_fairseq``
    (bit for bit the original, ``dummy_weight`` from its fresh init), the
    converted teacher served (``phase_slice``: exact launches per batch,
    fp32 card vs CPU per layer within 1e-3, bf16 vs fp32), and
    ``wavlm_large`` served the same way.  The HuggingFace import needs
    ``transformers``, which this host lacks: the CPU tests hold it.
    Returns (the converted checkpoint's path, the Large spec)."""
    shutil.rmtree(LARGE_DIR, ignore_errors=True)
    LARGE_DIR.mkdir(parents=True)
    t0 = time.perf_counter()
    original = pt.wav2vec2_large(device="cpu", generator=torch.Generator().manual_seed(20))
    sd = original.state_dict()
    fairseq_ckpt, converted = LARGE_DIR / "wav2vec2_large_fairseq.pt", LARGE_DIR / "wav2vec2_large.pth"
    torch.save({"model": to_fairseq(sd)}, fairseq_ckpt)
    cli_convert_from_fairseq.cli_main(["--ckpt", str(fairseq_ckpt), "--arch", "wav2vec2_large",
                                       "--out", str(converted)])
    back = load_checkpoint(converted)
    differ = sorted(k for k, v in sd.items()
                    if k not in back["state_dict"] or not np.array_equal(back["state_dict"][k],
                                                                         v.numpy()))
    check(set(back["state_dict"]) == set(sd) and not differ,
          f"fairseq round trip: {len(differ)} tensors differ: {differ[:5]}")
    check(back["config"] == original.config, "fairseq round trip: the config differs")
    convert_s = time.perf_counter() - t0
    n_params = sum(v.numel() for v in sd.values())
    spec = original.spec
    del original, sd, back
    fairseq_ckpt.unlink()

    teacher = load_model(converted, device="cuda")
    served = phase_slice("wav2vec2_large_converted", teacher)
    del teacher
    torch.cuda.empty_cache()
    wavlm = pt.wavlm_large(device="cuda", generator=torch.Generator().manual_seed(0))
    check(wavlm.spec.is_wavlm and wavlm.spec.layers[0].attention.num_heads == LARGE_HEADS,
          "wavlm_large: not a 16-head WavLM")
    served_wavlm = phase_slice("wavlm_large", wavlm)
    del wavlm
    torch.cuda.empty_cache()
    emit({"phase": "large_convert", "arch": "wav2vec2_large", "parameters": n_params,
          "fairseq_round_trip_bit_for_bit": True, "convert_seconds": convert_s,
          "fp32_card_vs_cpu_max_abs": served["fp32_card_vs_cpu_max_abs"],
          "wavlm_large_fp32_card_vs_cpu_max_abs": served_wavlm["fp32_card_vs_cpu_max_abs"],
          "hf_import": "held on the CPU by tests/test_torch_interop_hf.py (no transformers here)"})
    return converted, spec


def _large_models(converted):
    """The converted Large teacher on the card and the gated student (its
    config with all five prune flags, random weights, dropout on at the
    preset's rates) on the CPU, for ``init_train_state`` to copy."""
    teacher = load_model(converted, device="cuda")
    student = pt.wav2vec2_model(device="cpu", generator=torch.Generator().manual_seed(21),
                                **dict(teacher.config, **PRUNE_FLAGS))
    return teacher, student


def phase_large_remat_check(converted) -> dict:
    """One Large stage-1 step (run_large.sh's distill groups, dropout on)
    with remat and without, fp32 on the card at 2 clips of 2 s, from states
    with the same generator seed: every gradient within REMAT_GRAD_TOL of
    its norm (1e-6 of the global norm where it is 0), the metrics within
    1e-6 relative, the generator's state afterwards identical, and the
    launches exactly the plain pass's plus one forward per student
    attention layer."""
    teacher, student = _large_models(converted)
    rng = np.random.default_rng(22)
    batch = ((0.1 * rng.standard_normal((2, 32000))).astype(np.float32),
             np.array([32000, 24000], np.int32))
    L = int(frames(teacher.spec, [2.0])[0])
    out = {}
    for remat in (False, True):
        cfg = DistillConfig(distill_layer_groups=LARGE_GROUPS, remat=remat)
        state, _ = init_train_state(student=student, cfg=cfg, teacher_embed_dim=1024, seed=23,
                                    device="cuda")
        reset_launch_counts()
        metrics, grads = make_grad_fn(teacher, cfg)(state, batch)
        torch.cuda.synchronize()
        counts = launch_counts()
        want = add_counts((1, model_launches(teacher.spec, L, False)),
                          (1, model_launches(state.student.spec, L, True, remat=remat)))
        check(counts == want, f"Large remat={remat}: launches {counts}, expected {want}")
        out[remat] = ({k: v.item() for k, v in metrics.items()},
                      {k: g.detach() for k, g in grads.items()},
                      state.generator.get_state(), counts)
        del state, grads
    (m0, g0, gen0, c0), (m1, g1, gen1, c1) = out[False], out[True]
    check(torch.equal(gen0, gen1), "Large remat: the generator's state differs after the step")
    check(c1["packed_attention_fwd"] == c0["packed_attention_fwd"] + 24,
          f"Large remat: forward launches {c0} -> {c1}")
    for k in m0:
        check(abs(m1[k] - m0[k]) <= 1e-6 * abs(m0[k]) + 1e-9,
              f"Large remat: metric {k} {m1[k]} vs {m0[k]}")
    global_norm = torch.cat([g.flatten() for g in g0.values()]).double().norm().item()
    rel, zero = {}, {}
    for k, g in g0.items():
        norm, diff = g.double().norm().item(), (g1[k] - g).double().norm().item()
        if norm <= 1e-6 * global_norm:
            zero[k] = diff / global_norm
            check(diff <= 1e-6 * global_norm, f"Large remat: zero gradient of {k}: {diff}")
            continue
        rel[k] = diff / norm
        check(diff <= REMAT_GRAD_TOL * norm, f"Large remat: gradient of {k}: {rel[k]}")
    worst = sorted(rel.items(), key=lambda kv: -kv[1])[:3]
    row = {"phase": "large_remat_check", "batch": "2 clips of 2 s, lengths (32000, 24000)",
           "dtype": "float32", "L": L, "distill_layer_groups": LARGE_GROUPS,
           "grad_rel_err_max": worst[0][1] if worst else 0.0, "grad_rel_err_worst3": worst,
           "zero_grad_err_max_over_global_norm": max(zero.values(), default=0.0),
           "n_params": len(g0), "tol": REMAT_GRAD_TOL, "generator_state_equal": True,
           "loss": [m0["loss"], m1["loss"]], "launches": {"plain": c0, "remat": c1}}
    emit(row)
    del teacher, student, out
    torch.cuda.empty_cache()
    return row


def phase_large_train(converted) -> dict:
    """run_large.sh's stage-1 step on the card: the converted Large teacher,
    the gated student, bf16, B = 12 clips of 15 s (L = 749) with dropout on,
    a batch that stays on the card; timed without remat and with it (each
    from a fresh state: median of 3 segments of 2 steps after 2 warm steps),
    with ``max_memory_allocated`` and exactly 48 / 24 / 24 packed launches a
    step (teacher 24 and student 24 forwards, 24 dq, 24 dkv) without remat
    and 72 / 24 / 24 with it; then both as 4-step CUDA graphs (phase
    "graph_train", row "large_graphs" beside each other) and the ladder's
    three rungs without remat (run_large_torch.sh's default)."""
    teacher, student = _large_models(converted)
    gen = torch.Generator(device="cuda").manual_seed(24)
    T = int(TRAIN_SECONDS * SR)
    batch = (torch.randn(LARGE_B, T, device="cuda", generator=gen), None)
    L = int(output_lengths(teacher.spec, torch.tensor([T]))[0])
    runs, total, graphed = {}, dict.fromkeys(WRAPPERS, 0), {}
    for remat in (False, True):
        cfg = DistillConfig(distill_layer_groups=LARGE_GROUPS, compute_dtype="bfloat16",
                            remat=remat)
        state, tx = init_train_state(student=student, cfg=cfg, teacher_embed_dim=1024, seed=25,
                                     device="cuda")
        per_step = add_counts((1, model_launches(teacher.spec, L, False)),
                              (1, model_launches(state.student.spec, L, True, remat=remat)))
        want = dict.fromkeys(WRAPPERS, 0)
        want.update(packed_attention_fwd=72 if remat else 48, packed_attention_bwd_dq=24,
                    packed_attention_bwd_dkv=24, pos_conv_dgrad=1,
                    remat_layer=24 if remat else 0)
        check(per_step == want, f"Large remat={remat}: launches per step {per_step}")
        label = "large_train_remat" if remat else "large_train"
        state, fields, _ = timed_steps(label, make_train_step(teacher, cfg, tx), state, batch,
                                       per_step, LARGE_B * TRAIN_SECONDS)
        runs[label] = fields
        if not remat:  # the background saver's decision for this state
            ckpt = {"bytes": snapshot_bytes(state), "fits": background_ckpt_fits(state)}
        graphed[remat] = (cfg, per_step, fields["peak_memory_bytes"])
        total = {k: total[k] + fields["launches"][k] for k in total}
        emit({"phase": label, "model": "wav2vec2_large teacher (converted from fairseq), "
                                        "gated wav2vec2_large student",
              "remat": remat, "distill_layer_groups": LARGE_GROUPS, "batch": [LARGE_B, T],
              "L": L, **fields})
        del state, tx
        torch.cuda.empty_cache()
    plain_, remat_ = runs["large_train"], runs["large_train_remat"]
    emit({"phase": "large_train_summary",
          "step_s": {"plain": plain_["step_s"], "remat": remat_["step_s"]},
          "remat_time_ratio": remat_["step_s"] / plain_["step_s"],
          "peak_memory_bytes": {"plain": plain_["peak_memory_bytes"],
                                "remat": remat_["peak_memory_bytes"]}})
    del batch
    torch.cuda.empty_cache()
    # both steps as K = 4 graphs: remat's recomputes draw their forwards'
    # dropout from generators of their own inside the graph
    graph = {}
    for remat, label in ((False, "graph_large_train"), (True, "graph_large_train_remat")):
        cfg, per_step, peak = graphed[remat]
        graph[label] = phase_graph_train(label, teacher, student, cfg, 25, (LARGE_B, T),
                                         per_step, LARGE_B * TRAIN_SECONDS, peak,
                                         embed_dim=1024)
    keys = ("eager_step_s", "graph_step_s", "graph_over_eager", "eager_peak_memory_bytes",
            "graph_peak_memory_bytes", "graph_reserved_bytes")
    plain_g, remat_g = graph["graph_large_train"], graph["graph_large_train_remat"]
    emit({"phase": "large_graphs", "k": GRAPH_K, "batch": [LARGE_B, T],
          "plain": {k: plain_g[k] for k in keys}, "remat": {k: remat_g[k] for k in keys},
          "remat_over_plain_graph_step": remat_g["graph_step_s"] / plain_g["graph_step_s"],
          "remat_over_plain_graph_peak": remat_g["graph_peak_memory_bytes"]
          / plain_g["graph_peak_memory_bytes"], "card": nvidia_smi()})
    # run_large_torch.sh's default: K = 4 graphs without remat, on its
    # ladder at 180 s a batch: its first, middle and top rungs (the smoke's
    # time; every rung holds about 180 s of audio, so each costs alike)
    graph["graph_keys_large"] = phase_graph_keys("graph_keys_large", teacher, student,
                                                 graphed[False][0], 25, 180, embed_dim=1024,
                                                 interleaved=False, rungs=LADDER_RUNGS)
    del teacher, student
    torch.cuda.empty_cache()
    return {"launches": total, **runs, "ckpt": ckpt, "graph": graph}


def phase_recipe_driver() -> dict:
    """``bash run_torch.sh`` on the card at Base width, on the corpus of
    ``phase_pipeline`` (15 + 5 clips on the loader's top rung) with a
    random ``hubert_base`` teacher checkpoint: the recipe's defaults
    (DEVICE=cuda, 160 s a batch, bf16) with the update counts cut to 3 and
    2.  Each stage is a process of its own (its launches are not counted
    here; ``python`` is this interpreter); it must exit 0, and the exported
    ``dphubert.pth`` is then served here with its launches counted."""
    pipe_dir = REPO / "build" / "smoke_recipe_driver"
    rng = np.random.default_rng(26)
    t0 = time.perf_counter()
    root, tsv = write_corpus(pipe_dir, rng)
    teacher = pt.hubert_base(device="cpu", generator=torch.Generator().manual_seed(0))
    teacher_ckpt = pipe_dir / "hubert_base_teacher.pth"
    save_checkpoint(teacher_ckpt, teacher.config, teacher.state_dict())
    spec_t = teacher.spec
    del teacher
    # the script calls `python`: this interpreter (a wrapper, not a link,
    # so that a virtual environment's packages come with it)
    bin_dir = pipe_dir / "bin"
    bin_dir.mkdir()
    (bin_dir / "python").write_text(f'#!/bin/sh\nexec "{sys.executable}" "$@"\n')
    (bin_dir / "python").chmod(0o755)
    exp = pipe_dir / "exp"
    env = dict(os.environ, PATH=f"{bin_dir}{os.pathsep}{os.environ.get('PATH', '')}",
               PYTHONPATH=str(REPO), TSV_DIR=str(tsv), TRAIN_SUBSET="train100",
               TEACHER_CKPT=str(teacher_ckpt), MAX_UPDATES="3", FINAL_MAX_UPDATES="2",
               LOG_INTERVAL="1", DEVICE="cuda", EXP_DIR=str(exp))
    proc = subprocess.run(["bash", str(REPO / "run_torch.sh")], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    final = exp / "dphubert.pth"
    check(proc.returncode == 0 and final.exists() and f"Done: {final}" in proc.stdout,
          f"run_torch.sh exited {proc.returncode}:\n{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    rotated = {stage: sorted(p.name for p in (exp / stage / "ckpts" / "rotated").glob("*.pt"))
               for stage in ("stage1", "stage2")}
    check(rotated == {"stage1": ["step_3.pt"], "stage2": ["step_2.pt"]},
          f"run_torch.sh's default rotated checkpoints: {rotated}")
    stage_lines = [line for line in proc.stdout.splitlines() if line.startswith("[run_torch.sh]")]
    L = int(output_lengths(spec_t, torch.tensor([TOP_RUNG]))[0])
    stages = Stages(spec_t, L, valid_batches=1)
    stages.serve(final, root, rng)
    row = {"phase": "recipe_driver", "script": "run_torch.sh", "exit": proc.returncode,
           "seconds": seconds, "stages": stage_lines, "rotated": rotated,
           "load_dpmodel": [line for line in proc.stdout.splitlines()
                            if line.startswith(("Loaded", "extract_features"))],
           "launches": stages.total}
    emit(row)
    shutil.rmtree(pipe_dir, ignore_errors=True)
    return row


# ---------------------------------------------------------------------------
# Parallel: data and tensor parallelism of the distill step
# ---------------------------------------------------------------------------

PARALLEL_DIR = REPO / "build" / "smoke_parallel"
TP_HEADS = 6  # HuBERT Base's 12 heads over a model group of 2
# the gradients whose one-process norm is under this share of the global
# norm are not held to the per-gradient cosine: in exact arithmetic the key
# biases' gradient is 0 (softmax ignores a constant added to a row), and in
# bf16 what is left is rounding noise, whose cosine means nothing
PARALLEL_COS_MIN_SHARE = 1e-3
PARALLEL_RANK_TIMEOUT_S = 600
# two runs of one bf16 program, split differently, hold tighter than bf16
# against fp32: the loss's relative error, the cosine (all the gradients
# and each one), and the gathered gradient norm over the one-process norm
# (a data average off by n_data shows there, not in a cosine)
PARALLEL_LOSS_TOL = 1e-3
PARALLEL_MIN_COS = 0.9999
PARALLEL_NORM_TOL = 1e-3


def phase_dp_nccl_world1() -> dict:
    """One NCCL rank as a (1 x 1) mesh: the HuBERT Base stage-1 step at full
    width (bf16, B = 16 x 15 s, dropout 0.1) with its gradient all-reduce
    (one flat buffer, NCCL at world size 1: the sum of one rank) held bit
    for bit (``deterministic``) against the mesh-less step: 4 eager steps,
    then, as a 4-step CUDA graph with the all-reduce captured (its
    communicator made by the key's eager first group), the first call and
    two replays against 12 eager mesh-less steps (parameters, moments,
    counters, generator, metrics).  Then, under cuDNN's default
    algorithms, 3 segments of 4 eager mesh steps and of one replay, in
    turns; the all-reduced bytes a step."""
    import torch.distributed as dist

    from dphubert_torch.parallel import multihost
    from dphubert_torch.parallel.mesh import create_mesh

    t_phase = time.perf_counter()
    check(not dist.is_initialized(), "a process group is already up")
    multihost.initialize("cuda", backend="nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = create_mesh(1, 1, "cuda")
        check(mesh.backend() == "nccl", f"backend {mesh.backend()}")
        teacher, student = distill_models("cuda")
        cfg = DistillConfig(compute_dtype="bfloat16")
        T = int(TRAIN_SECONDS * SR)
        L = int(output_lengths(teacher.spec, torch.tensor([T]))[0])
        per_step = add_counts((1, model_launches(teacher.spec, L, False)),
                              (1, model_launches(student.spec, L, True)))
        gen = torch.Generator(device="cuda").manual_seed(31)
        stack = torch.randn(GRAPH_K, TRAIN_B, T, device="cuda", generator=gen)
        ran = 0

        def fresh(m=None):
            return init_train_state(student=student, cfg=cfg, teacher_embed_dim=768, seed=32,
                                    device="cuda", mesh=m)

        def eager_group(step, state):
            nonlocal ran
            steps = []
            for j in range(GRAPH_K):
                state, metrics = step(state, (stack[j], None))
                steps.append(metrics)
            ran += GRAPH_K
            return state, {k: torch.stack([m[k].float() for m in steps]) for k in steps[0]}

        def same_metrics(got, want, what):
            for k, v in want.items():
                check(torch.equal(got[k], v), f"{what}: {k} {got[k].tolist()} vs {v.tolist()}")

        reset_launch_counts()
        with deterministic():
            a, tx_a = fresh()
            plain = make_train_step(teacher, cfg, tx_a)
            want_m, want_s = [], []
            for _ in range(3):
                a, m = eager_group(plain, a)
                want_m.append(m)
                want_s.append(device_snapshot(a))
            del a, tx_a, plain
            b, tx_b = fresh(mesh)
            b, m = eager_group(make_train_step(teacher, cfg, tx_b, mesh=mesh), b)
            same_metrics(m, want_m[0], "eager mesh step")
            n_tensors = same_snapshot(device_snapshot(b), want_s[0], "eager mesh step")
            # every fp32 gradient and every metric but grad_norm, in one buffer
            reduced_bytes = 4 * (sum(p.numel() for p in b.named_params().values()) + len(m) - 1)
            del b, tx_b
            c, tx_c = fresh(mesh)
            group = make_train_step(teacher, cfg, tx_c, steps_per_call=GRAPH_K, mesh=mesh)
            for call in range(3):
                c, m = group(c, (stack, None))
                ran += GRAPH_K
                same_metrics(m, want_m[call], f"mesh graph call {call}")
                same_snapshot(device_snapshot(c), want_s[call], f"mesh graph call {call}")
            check(GraphedSteps.replays == 2, f"{GraphedSteps.replays} replays")
            del c, tx_c, group
            gc.collect()
            torch.cuda.empty_cache()
            # the FSDP path on the world-1 data group (``mark_world1``):
            # every leaf the rule splits at 2 data ranks all-gathered where
            # it is read and its gradient reduce-scattered, the student's
            # kept out of the all-reduce and their squares summed over the
            # data group; 12 eager steps (the first step's loss the
            # mesh-less one's bits), then the 4-step graph's 3 calls bit
            # for bit those steps
            def fsdp_fresh():
                state, tx = fresh(mesh)
                f_teacher = copy.deepcopy(teacher)
                return state, tx, f_teacher, mark_world1(state, tx, f_teacher, mesh)

            e, tx_e, e_teacher, fsdp_marked = fsdp_fresh()
            e_step = make_train_step(e_teacher, cfg, tx_e, mesh=mesh)
            fsdp_m, fsdp_s = [], []
            for _ in range(3):
                e, m = eager_group(e_step, e)
                fsdp_m.append(m)
                fsdp_s.append(device_snapshot(e))
            check(torch.equal(fsdp_m[0]["loss"][0], want_m[0]["loss"][0]),
                  f"FSDP first step's loss {fsdp_m[0]['loss'][0].item()} vs "
                  f"{want_m[0]['loss'][0].item()}")
            del e, tx_e, e_teacher, e_step, want_s
            f, tx_f, f_teacher, _ = fsdp_fresh()
            f_group = make_train_step(f_teacher, cfg, tx_f, steps_per_call=GRAPH_K, mesh=mesh)
            for call in range(3):
                f, m = f_group(f, (stack, None))
                ran += GRAPH_K
                same_metrics(m, fsdp_m[call], f"FSDP graph call {call}")
                same_snapshot(device_snapshot(f), fsdp_s[call], f"FSDP graph call {call}")
            check(GraphedSteps.replays == 4, f"{GraphedSteps.replays} replays")
            del f, tx_f, f_teacher, f_group, fsdp_s
            gc.collect()
            torch.cuda.empty_cache()

        torch.cuda.reset_peak_memory_stats()
        b, tx_b = fresh(mesh)
        eager = make_train_step(teacher, cfg, tx_b, mesh=mesh)
        c, tx_c = fresh(mesh)
        group = make_train_step(teacher, cfg, tx_c, steps_per_call=GRAPH_K, mesh=mesh)
        b, _ = eager_group(eager, b)  # warm
        c, _ = group(c, (stack, None))  # the key's eager group and capture
        ran += GRAPH_K
        eager_seg, graph_seg = [], []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            c, m = group(c, (stack, None))
            torch.cuda.synchronize()
            ran += GRAPH_K
            graph_seg.append((time.perf_counter() - t0) / GRAPH_K)
            t0 = time.perf_counter()
            b, _ = eager_group(eager, b)
            torch.cuda.synchronize()
            eager_seg.append((time.perf_counter() - t0) / GRAPH_K)
        for k, v in m.items():
            check(bool(torch.isfinite(v).all()), f"dp_nccl_world1: {k} = {v.tolist()}")
        counts = launch_counts()
        check(counts == {k: ran * v for k, v in per_step.items()},
              f"dp_nccl_world1: {ran} steps ran {counts}, expected {per_step} a step")
        eager_s, graph_s = statistics.median(eager_seg), statistics.median(graph_seg)
        row = {"phase": "dp_nccl_world1", "backend": "nccl", "world_size": 1, "mesh": [1, 1],
               "batch": [TRAIN_B, T], "dtype": "bfloat16", "dropout": DROPOUT,
               "bit_exact": {"eager_steps": GRAPH_K, "graph_calls": 3, "graph_replays": 2,
                             "tensors_compared": n_tensors,
                             "metrics_compared": sorted(want_m[0])},
               "fsdp_bit_exact": {"eager_steps": 3 * GRAPH_K, "graph_calls": 3,
                                  "graph_replays": 2, "leaves_split": fsdp_marked,
                                  "against": "the same placement's eager steps; the first "
                                             "step's loss the mesh-less one's"},
               "allreduced_bytes_per_step": reduced_bytes,
               "eager_step_s": eager_s, "eager_segments_s": eager_seg,
               "graph_step_s": graph_s, "graph_segments_s": graph_seg,
               "graph_over_eager": graph_s / eager_s,
               "eager_audio_sec_per_s": TRAIN_B * TRAIN_SECONDS / eager_s,
               "graph_audio_sec_per_s": TRAIN_B * TRAIN_SECONDS / graph_s,
               "peak_memory_bytes": torch.cuda.max_memory_allocated(),
               "steps_run": ran, "launches": counts,
               "launches_in_graphs": dict(GraphedSteps.replayed),
               "seconds": time.perf_counter() - t_phase}
        emit(row)
        del b, c, tx_b, tx_c, eager, group, stack, teacher, student
        gc.collect()
        torch.cuda.empty_cache()
        return row
    finally:
        multihost.shutdown()


def mark_world1(state, tx, teacher, mesh) -> dict:
    """Place ``state`` and ``teacher`` on the world-1 ``mesh`` as FSDP
    splits them over 2 data ranks: every leaf the rule splits at 2 ranks
    (the λs stay whole, as ``shard_train_state`` keeps them) is marked as a
    block of the data group (``fsdp.mark``; at world size 1 the whole
    tensor), and each of the state's is recorded as a ``Block`` with that
    ``data_dim`` in ``state.shards`` and in the clip's groups: the step
    all-gathers it where it is read, reduce-scatters its gradient, keeps it
    out of the all-reduce and sums its squares over the data group
    (``make_grad_fn``'s FSDP branch).  Returns the leaves so placed."""
    from dphubert_torch.parallel.fsdp import fsdp_dim, mark
    from dphubert_torch.parallel.sharding import Block

    n = {"state": 0, "teacher": 0}
    for name, p in state.named_params().items():
        dim = None if name.startswith("lambdas.") else fsdp_dim(p.shape, 2)
        if dim is not None:
            state.shards[name] = Block(tuple(p.shape), data_dim=dim, data_rank=mesh.data_rank,
                                       n_data=mesh.n_data)
            mark(p, dim, mesh)
            n["state"] += 1
    tx.shard_norm({name: b.groups(mesh) for name, b in state.shards.items()})
    for p in teacher.parameters():
        dim = fsdp_dim(p.shape, 2)
        if dim is not None:
            mark(p, dim, mesh)
            n["teacher"] += 1
    return n


def _cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    return F.cosine_similarity(a.flatten().double(), b.flatten().double(), dim=0).item()


# (label, family, (n_data, n_model), fsdp, path) of phase "parallel_card",
# by the size of the process group that runs them; ``path`` is the row (and
# the launch count) a layout belongs to: "parallel_card" for data and
# tensor parallelism, "fsdp_card" for FSDP, HSDP and DPWavLM under TP
CARD_LAYOUTS = {2: (("1x2", "hubert", (1, 2), False, "parallel_card"),
                    ("2x1", "hubert", (2, 1), False, "parallel_card"),
                    ("fsdp_2x1", "hubert", (2, 1), True, "fsdp_card"),
                    ("wavlm_tp_1x2", "wavlm", (1, 2), False, "fsdp_card")),
                4: (("hsdp_2x2", "hubert", (2, 2), True, "fsdp_card"),)}
CARD_PATHS = ("parallel_card", "fsdp_card")


def _one_process_reference(family: str, batch, first) -> tuple:
    """Rank 0's one-process bf16 loss and gradients of the step (the same
    seeds as the ranks' states), broadcast to every rank of the group as
    one flat fp32 buffer, so every rank holds it alike; (loss, {name:
    gradient})."""
    import torch.distributed as dist

    teacher, student = distill_models("cuda", family)
    cfg = DistillConfig(compute_dtype="bfloat16")
    state, _ = init_train_state(student=student, cfg=cfg,
                                teacher_embed_dim=teacher.spec.embed_dim, seed=34, device="cuda")
    shapes = {n: p.shape for n, p in state.named_params().items()}
    flat = torch.empty(1 + sum(int(np.prod(v)) for v in shapes.values()), device="cuda")
    if first.rank == 0:
        metrics, grads = make_grad_fn(teacher, cfg)(state, (batch, None))
        flat = torch.cat([metrics["loss"].float().reshape(1)]
                         + [grads[n].float().flatten() for n in shapes])
        del metrics, grads
    del state, teacher, student
    gc.collect()
    torch.cuda.empty_cache()
    dist.broadcast(flat, src=0)
    out, at = {}, 1
    for n, shape in shapes.items():
        k = int(np.prod(shape))
        out[n] = flat[at:at + k].view(shape)
        at += k
    return flat[0].item(), out


def parallel_card_job(payload: dict, first) -> dict:
    """The job of the ranks of phase "parallel_card" (this script with
    ``--parallel-rank``, ``dphubert_torch.parallel.dryrun``'s rank
    harness): gloo on the one card, ``first`` the group's mesh.  For each
    layout of ``CARD_LAYOUTS`` for this group, in turn: every rank holds
    the one-process bf16 gradient of its family's step (rank 0 takes it,
    ``_one_process_reference``); every rank places a fresh state from the
    same seed on the layout's mesh (with ``fsdp``: split over the data
    group, the teacher too, ``fsdp.shard_module``), runs the step's forward
    and backward on its rows and heads (the gradient average included),
    gathers the gradients to one-card shapes and holds the loss, the
    cosines and the norm against the reference; then one whole step
    (``make_train_step``) timed, its launches counted, the teacher's
    forward alone counted, peak and reserved memory from the placement on,
    and, with ``fsdp``, the elements it keeps of the split leaves.  Returns
    this rank's rows by layout."""
    import torch.distributed as dist

    from dphubert_torch.parallel.fsdp import shard_module
    from dphubert_torch.parallel.mesh import create_mesh
    from dphubert_torch.parallel.multihost import process_row_slice
    from dphubert_torch.parallel.sharding import gather_tensor

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = first.rank
    out = {"rank": rank, "layouts": {}}
    T = int(TRAIN_SECONDS * SR)
    gen = torch.Generator(device="cuda").manual_seed(33)
    batch = torch.randn(TRAIN_B, T, device="cuda", generator=gen)
    meshes = {(first.n_data, first.n_model): first}
    ref_family, ref = None, None
    for label, family, (n_data, n_model), fsdp, path in CARD_LAYOUTS[first.world]:
        if family != ref_family:  # the previous family's reference freed first
            ref = g_ref = None
            gc.collect()
            torch.cuda.empty_cache()
            ref, ref_family = _one_process_reference(family, batch, first), family
        loss_ref, g_ref = ref
        if (n_data, n_model) not in meshes:
            meshes[(n_data, n_model)] = create_mesh(n_data, n_model, "cuda")
        mesh = meshes[(n_data, n_model)]
        what = f"parallel_card {label} rank {rank}"
        teacher, student = distill_models("cuda", family)
        cfg = DistillConfig(compute_dtype="bfloat16")
        if fsdp:
            shard_module(teacher, mesh)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state, tx = init_train_state(student=student, cfg=cfg,
                                     teacher_embed_dim=teacher.spec.embed_dim, seed=34,
                                     device="cuda", mesh=mesh, fsdp=fsdp)
        del student
        rows = process_row_slice(mesh.data_rank, n_data, TRAIN_B)
        local = (batch[rows], None)
        row = {"layout": label, "path": path, "family": family, "mesh": [n_data, n_model],
               "fsdp": fsdp, "backend": mesh.backend()}
        reset_launch_counts()
        t0 = time.perf_counter()
        metrics, grads = make_grad_fn(teacher, cfg, mesh)(state, local)
        torch.cuda.synchronize()
        row["grad_step_s"] = time.perf_counter() - t0
        row["launches_forward_backward"] = nonzero(launch_counts())
        whole = {n: gather_tensor(state.shards[n], g, mesh) if n in state.shards else g
                 for n, g in grads.items()}
        loss = metrics["loss"].item()
        flat = torch.cat([whole[n].float().flatten() for n in g_ref])
        flat_ref = torch.cat([g_ref[n].flatten() for n in g_ref])
        norm = flat_ref.double().norm().item()
        cos = {n: _cosine(whole[n], g) for n, g in g_ref.items()
               if g.double().norm().item() >= PARALLEL_COS_MIN_SHARE * norm}
        small = {n: _cosine(whole[n], g) for n, g in g_ref.items() if n not in cos}
        row.update(loss=loss, loss_one_process=loss_ref,
                   loss_rel_err=abs(loss - loss_ref) / abs(loss_ref),
                   grad_norm_ratio=flat.double().norm().item() / norm,
                   grad_cosine_all=_cosine(flat, flat_ref),
                   grad_cosine_min_per_param=min(cos.values()),
                   grad_cosine_worst3=sorted(cos.items(), key=lambda kv: kv[1])[:3],
                   params_held_per_param=len(cos), params_below_share=len(small),
                   below_share_cosine_min=min(small.values(), default=None),
                   split_over_model=sum(b.model_dim is not None for b in state.shards.values()),
                   split_over_data=sum(b.data_dim is not None for b in state.shards.values()))
        check(row["loss_rel_err"] <= PARALLEL_LOSS_TOL, f"{what}: loss {loss} vs {loss_ref}")
        check(abs(row["grad_norm_ratio"] - 1) <= PARALLEL_NORM_TOL,
              f"{what}: gradient norm {row['grad_norm_ratio']} x one process's")
        check(row["grad_cosine_all"] >= PARALLEL_MIN_COS,
              f"{what}: gradient cosine {row['grad_cosine_all']}")
        check(row["grad_cosine_min_per_param"] >= PARALLEL_MIN_COS,
              f"{what}: gradient cosines {row['grad_cosine_worst3']}")
        del metrics, grads, whole, flat, flat_ref
        if fsdp:  # what the rank keeps of the split leaves: 1 / n_data, moments too
            opt, named = state.opt_state, state.named_params()
            kept = [(named[n].numel() * n_data, int(np.prod(b.shape)) //
                     (b.n_model if b.model_dim is not None else 1), opt.mu[n].numel() * n_data)
                    for n, b in state.shards.items() if b.data_dim is not None]
            check(kept and all(a == w == m for a, w, m in kept),
                  f"{what}: split leaves {kept[:3]}")
            row["data_split_elements_kept"] = sum(a for a, _, _ in kept) // n_data
        # one whole step, timed; its launches; the teacher's forward alone
        step = make_train_step(teacher, cfg, tx, mesh=mesh)
        state, _ = step(state, local)  # warm
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        state, m = step(state, local)
        torch.cuda.synchronize()
        row["step_s"] = time.perf_counter() - t0
        row["launches_per_step"] = nonzero(launch_counts())
        check(np.isfinite(m["loss"].item()), f"{what}: loss not finite")
        reset_launch_counts()
        with torch.no_grad():
            teacher.extract_features(local[0].to(torch.bfloat16))
        row["teacher_forward_launches"] = nonzero(launch_counts())
        row["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
        row["peak_reserved_bytes"] = torch.cuda.max_memory_reserved()
        # 12 student layers (their heads) + 12 teacher layers (12 heads)
        fwd, bwd = (("packed_attention_fwd", ("packed_attention_bwd_dq",
                                              "packed_attention_bwd_dkv"))
                    if family == "hubert" else
                    ("wavlm_attention_fwd", ("wavlm_attention_bwd_fused",
                                             "wavlm_attention_bwd_dkv")))
        check(row["launches_per_step"] == {fwd: 24, **dict.fromkeys(bwd, 12), "pos_conv_dgrad": 1}
              and row["teacher_forward_launches"] == {fwd: 12},
              f"{what}: launches {row['launches_per_step']}, teacher "
              f"{row['teacher_forward_launches']}")
        row["student_heads_per_layer"] = sorted({a.heads for a in state.student.modules()
                                                 if hasattr(a, "head_offset")})
        check(row["student_heads_per_layer"] == [12 // n_model],
              f"{what}: heads {row['student_heads_per_layer']}")
        out["layouts"][label] = row
        del state, tx, step, m, teacher
        gc.collect()
        torch.cuda.empty_cache()
        dist.barrier()
    return out


def dropout_draw_ms(spec, L: int) -> dict:
    """The uniform draws of one Base step's activation dropouts (the
    feature projection's, the transformer's, and per layer the attention
    output's and the FFN's two), timed with CUDA events: at the global
    batch's shape, which every rank of a mesh draws, and at the shapes a
    rank keeps under (2 data x 1 model) and, for the FFN's intermediate,
    under (1 data x 2 model).  What a rank pays for drawing the global
    mask is global minus its own share."""
    E = spec.embed_dim
    n = len(spec.layers)
    inter = spec.layers[0].feed_forward.intermediate_features
    gen = torch.Generator(device="cuda").manual_seed(35)

    def shapes(B, I):
        return [(B, L, E)] * (2 + 2 * n) + [(B, L, I)] * n

    def draw(shape_list):
        for shape in shape_list:
            torch.rand(shape, generator=gen, device="cuda")

    return {name: time_ms(lambda sl=sl: draw(sl), reps=10)
            for name, sl in (("global", shapes(TRAIN_B, inter)),
                             ("rank_2x1", shapes(TRAIN_B // 2, inter)),
                             ("rank_1x2", shapes(TRAIN_B, inter // 2)))}


def phase_parallel_card(spec) -> dict:
    """Data and tensor parallelism, FSDP, HSDP and DPWavLM under tensor
    parallelism on the one card, over gloo (CUDA tensors; NCCL refuses two
    ranks on one card), all through ``parallel_card_job``: two processes
    run the HuBERT Base stage-1 step at (1 data x 2 model) and (2 x 1)
    (row "parallel_card"), at (2 x 1) with FSDP and the DPWavLM Base step
    at (1 x 2) (row "fsdp_card"); four processes run HuBERT Base at (2 x 2)
    HSDP (row "fsdp_card").  Full width, bf16, B = 16 x 15 s, dropout 0.1,
    eager, K = 1, each rank on its rows and heads, every rank held to loss
    1e-3 of the one-process bf16 step, the gathered gradient norm within
    1e-3 of its norm, the cosine of all the gathered gradients and of
    every gradient (past ``PARALLEL_COS_MIN_SHARE`` of the norm) >=
    0.9999; each rank's launches (under (1 x 2): 12 student forwards, the
    backward at 6 heads, 12 teacher forwards at 12), step time, peak and
    reserved memory (every rank holds the reference alike, so the layouts'
    peaks compare).  NCCL across cards is not run here.  Before that, the
    packed kernels at the split step's shape, (16, 749, 6, 64), in fp32 and
    bf16, and the seven WavLM entries there with those heads' 6 bias rows,
    against their plain versions (the kernels line's ``tp`` rows); the
    dropout draws of one step."""
    t_phase = time.perf_counter()
    L = int(frames(spec, [TRAIN_SECONDS])[0])
    kernels = phase_train_kernels(spec, cases=[("tp2", TRAIN_B, L, TP_HEADS, None)],
                                  path="parallel_card")
    kernels.update(phase_wavlm_kernels(spec, cases=[("tp2", TRAIN_B, L, TP_HEADS, None, True)]))
    draws = dropout_draw_ms(spec, L)
    entry = [str(pathlib.Path(__file__).resolve()), "--parallel-rank"]
    ranks, seconds = [], {}
    for world, layout in ((2, (1, 2)), (4, (2, 2))):
        t0 = time.perf_counter()
        shutil.rmtree(PARALLEL_DIR, ignore_errors=True)
        got, results = spawn("card", world, PARALLEL_DIR, {}, layout, entry=entry,
                             device="cuda", backend="gloo", timeout=PARALLEL_RANK_TIMEOUT_S)
        check_ranks(results, f"parallel_card rank ({world} processes)")
        ranks += [dict(g, processes=world) for g in got]
        seconds[f"{world}_processes"] = time.perf_counter() - t0
    shutil.rmtree(PARALLEL_DIR, ignore_errors=True)
    rows = {}
    for path in CARD_PATHS:
        counts = dict.fromkeys(WRAPPERS, 0)
        per_rank = []
        for got in ranks:
            lays = {k: v for k, v in got["layouts"].items() if v["path"] == path}
            if lays:
                per_rank.append({"rank": got["rank"], "processes": got["processes"], **lays})
            for lay in lays.values():
                for name, n in lay["launches_per_step"].items():
                    counts[name] += n
        rows[path] = {"phase": path, "backend": "gloo (on CUDA tensors)", "card": 1,
                      "batch": [TRAIN_B, L], "dtype": "bfloat16", "dropout": DROPOUT,
                      "loss_tol": PARALLEL_LOSS_TOL, "min_cos": PARALLEL_MIN_COS,
                      "norm_tol": PARALLEL_NORM_TOL,
                      "per_param_cos_min_share": PARALLEL_COS_MIN_SHARE,
                      "ranks": per_rank, "launches": counts}
    rows["parallel_card"]["activation_dropout_draw_ms"] = draws
    rows["fsdp_card"].update(spawn_seconds=seconds, seconds=time.perf_counter() - t_phase)
    for row in rows.values():
        emit(row)
    return {"rows": rows, "kernels": kernels}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    t_start = time.perf_counter()

    smi = phase_card()
    laps = {}  # seconds by path, for the smoke's time budget

    def lap(name):
        laps[name] = time.perf_counter() - t_start - sum(laps.values())

    lap("build")
    base = pt.hubert_base(device="cuda", generator=torch.Generator().manual_seed(0))
    base_spec = base.spec
    kernels = phase_kernels(base.spec)
    train_kernels = phase_train_kernels(base.spec)
    flash_kernels = phase_flash_kernels()
    wavlm_kernels = phase_wavlm_kernels(base.spec)

    # path 1: HuBERT Base served in bf16 and fp32
    reset_launch_counts()
    phase_slice("hubert_base", base)
    path_launches = {"serve": launch_counts()}
    graph_paths = {}  # the graph phases' rows, by path
    del base
    lap("kernels_and_serve")

    cfg = json.loads(R2_CONFIG.read_text())
    reset_launch_counts()
    student = pt.wav2vec2_model(device="cuda", generator=torch.Generator().manual_seed(1), **cfg)
    phase_slice("pruned_config_r2", student)
    emit({"phase": "pruned_student_launches", **launch_counts()})
    del student

    # path 2: the stage-1 distill step (timed_steps resets the counts before
    # its steps and reads them after)
    phase_train_check()
    train_row = phase_train()
    path_launches["train"] = train_row["launches"]
    path_launches["profile"] = train_row["profile"]["launches"]
    graph_paths.update(train_row["graph"])
    lap("train")

    # path 3: the final-distill step of a student on the flash route, then
    # the whole recipe through the CLIs (each stage resets and reads)
    phase_final_distill_check()
    final_step = phase_final_distill_step()
    path_launches["final_distill"] = final_step["launches"]
    graph_paths.update(final_step["graph"])
    pipeline = phase_pipeline()
    path_launches["pipeline"] = pipeline["launches"]
    graph_paths["pipeline"] = pipeline
    lap("final_distill_and_pipeline")

    # path 4: DPWavLM: WavLM Base and the pruned WavLM student served, the
    # step checked on both routes, the timed bf16 step on the single route
    # and then on the general one, the WavLM recipe
    reset_launch_counts()
    wavlm = pt.wavlm_base(device="cuda", generator=torch.Generator().manual_seed(0))
    phase_slice("wavlm_base", wavlm)
    del wavlm
    wavlm_student = pt.wav2vec2_model(device="cuda", generator=torch.Generator().manual_seed(1),
                                      **json.loads(WAVLM_PRUNED_CONFIG.read_text()))
    phase_slice("wavlm_pruned_r4", wavlm_student)
    path_launches["wavlm_serve"] = launch_counts()
    del wavlm_student
    phase_train_check("wavlm", "wavlm_train_check")
    path_launches["wavlm_general"] = phase_wavlm_general_check()["launches"]
    wavlm_step = phase_train("wavlm")
    path_launches["wavlm_train"] = wavlm_step["launches"]
    graph_paths.update(wavlm_step["graph"])
    general_step = phase_wavlm_general_train(wavlm_step)
    path_launches["wavlm_general_train"] = general_step["launches"]
    graph_paths.update(general_step["graph"])
    path_launches["wavlm_pipeline"] = phase_wavlm_pipeline()["launches"]
    lap("wavlm")

    # the training forward with LayerDrop (forward(training=True)), HuBERT
    # Base and WavLM Base
    for family in ("hubert", "wavlm"):
        path_launches[f"layerdrop_{family}"] = phase_layerdrop(family)["launches"]
    lap("layerdrop")

    # path 5: wav2vec 2.0 Large (run_large.sh): the packed kernels at its
    # shape, the fairseq import and serving (and wavlm_large served), the
    # stage-1 step with remat against without, both timed; then the recipe
    # script run_torch.sh itself
    reset_launch_counts()
    converted, large_spec = phase_large_convert()
    path_launches["large_serve"] = launch_counts()
    large_kernels = phase_large_kernels(large_spec)
    check_launches = phase_large_remat_check(converted)["launches"]
    path_launches["large_remat_check"] = add_counts((1, check_launches["plain"]),
                                                    (1, check_launches["remat"]))
    large_train = phase_large_train(converted)
    path_launches["large_train"] = large_train["launches"]
    graph_paths.update(large_train["graph"])
    shutil.rmtree(LARGE_DIR, ignore_errors=True)
    lap("large")

    # path 6: the checkpoint path (sync write, background saver, rotation,
    # resume) on the Base stage-1 state; launches as single steps
    reset_launch_counts()
    phase_ckpt(large_train["ckpt"])
    path_launches["ckpt"] = launch_counts()
    lap("ckpt")
    path_launches["recipe_driver"] = phase_recipe_driver()["launches"]
    lap("recipe_driver")

    # path 7: parallel: one NCCL rank as a (1 x 1) mesh, eager and as a
    # captured 4-step graph, bit for bit the mesh-less step; two gloo ranks
    # on the card in both layouts, and the packed kernels at 6 heads
    reset_launch_counts()
    graph_paths["dp_nccl_world1"] = phase_dp_nccl_world1()
    # and (path 8) FSDP (2 x 1), HSDP (2 x 2) and DPWavLM at (1 x 2), by
    # the same ranks; the WavLM entries at the split step's 6 heads
    lap("dp_nccl_world1")
    parallel = phase_parallel_card(base_spec)
    lap("parallel_card")
    for path, row in parallel["rows"].items():
        path_launches[path] = row["launches"]
    for path, row in graph_paths.items():
        path_launches[path] = row["launches"]
    graph_replayed = {p: row["launches_in_graphs"] for p, row in graph_paths.items()}

    bf16 = torch.bfloat16
    rows = {
        "packed_attention_fwd": train_kernels[("packed_attention_fwd", "train", bf16)],
        "flash_attention_fwd": flash_kernels[("flash_attention_fwd", "final_distill", bf16)],
        "packed_attention_bwd_dq": train_kernels[("packed_attention_bwd_dq", "train", bf16)],
        "packed_attention_bwd_dkv": train_kernels[("packed_attention_bwd_dkv", "train", bf16)],
        "flash_attention_bwd_dq": flash_kernels[("flash_attention_bwd_dq", "final_distill", bf16)],
        "flash_attention_bwd_dkv": flash_kernels[("flash_attention_bwd_dkv", "final_distill",
                                                  bf16)],
        **{name: wavlm_kernels[(name, "train", bf16)] for name in KERNELS
           if name.startswith("wavlm_")},
    }
    serve_rows = {"packed_attention_fwd": kernels[("packed_attention_fwd", bf16)],
                  "flash_attention_fwd": kernels[("flash_attention_fwd", bf16)],
                  "wavlm_attention_fwd": wavlm_kernels[("wavlm_attention_fwd", "serve_batch2",
                                                        bf16)]}
    large_rows = {("large_train", name): large_kernels[(name, "large_train", bf16)]
                  for name in ("packed_attention_fwd", "packed_attention_bwd_dq",
                               "packed_attention_bwd_dkv")}
    tp_rows = {name: parallel["kernels"][(name, "tp2", bf16)]
               for name in ("packed_attention_fwd", "packed_attention_bwd_dq",
                            "packed_attention_bwd_dkv")}
    tp_rows.update({name: parallel["kernels"][(name, "tp2", bf16)] for name in KERNELS
                    if name.startswith("wavlm_")})
    line = []
    for name, r in rows.items():
        by_path = {p: c[name] for p, c in path_launches.items() if c[name]}
        check(sum(by_path.values()) > 0, f"{name} was not launched on any path")
        source, replaces = KERNELS[name]
        entry = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "launches_in_graphs": {p: c[name] for p, c in graph_replayed.items() if c.get(name)},
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "dtype": r["dtype"],
            "shape": r.get("shape_BLHD") or r["shape_BHLD"], "body": r.get("body", "fma"),
        }
        for key in ("ms_no_dropout", "achieved_tflops", "library_dropout_ms"):
            if key in r:
                entry[key] = r[key]
        if ("large_train", name) in large_rows:  # the Large step's shape
            lr = large_rows[("large_train", name)]
            entry["large"] = {k: lr[k] for k in ("ms", "ms_no_dropout", "plain_ms", "library_ms",
                                                 "library_dropout_ms", "bound_ms", "bound_by",
                                                 "max_abs_err", "achieved_tflops", "body")
                              if k in lr}
            entry["large"]["shape"] = lr["shape_BLHD"]
        if name in tp_rows:  # the tensor-parallel step's shape: 6 heads a rank
            tr = tp_rows[name]
            entry["tp"] = {k: tr[k] for k in ("ms", "ms_no_dropout", "plain_ms", "library_ms",
                                              "library_dropout_ms", "bound_ms", "bound_by",
                                              "max_abs_err", "achieved_tflops", "body")
                           if k in tr}
            entry["tp"]["shape"] = tr.get("shape_BLHD") or tr["shape_BHLD"]
        if name in serve_rows:  # its serving row, without dropout
            sr = serve_rows[name]
            entry["serve"] = {k: sr[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                                 "max_abs_err", "achieved_tflops") if k in sr}
            entry["serve"]["shape"] = sr.get("shape_BLHD") or sr["shape_BHLD"]
        line.append(entry)
    check(len(line) == len(KERNELS) == 13, f"kernels line holds {len(line)} entries")
    # every entry launched inside a replayed K-step graph on some path
    in_graphs = {e["name"]: e["launches_in_graphs"] for e in line}
    check(all(in_graphs.values()), f"entries never replayed in a graph: {in_graphs}")
    # bf16 on the tensor cores: every entry
    bodies = {e["name"]: e["body"] for e in line}
    check(set(bodies.values()) == {"wgmma"}, f"bf16 bodies of the entries: {bodies}")
    emit({"phase": "done", "seconds": time.perf_counter() - t_start, "seconds_by_path": laps})
    print(smi, flush=True)
    emit({"kernels": line})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 2 and sys.argv[1] == "--parallel-rank":
        run_rank({"card": parallel_card_job}, sys.argv[2:])
        sys.exit(0)
    sys.exit(main())
