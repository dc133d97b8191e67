#!/bin/bash
# wav2vec 2.0 Large compression recipe on one NVIDIA card (reference
# run_large.sh:13-55; run_large.sh's environment over run_torch.sh):
# the 24-layer 1024-wide teacher, six distill groups, the longer schedule
# and 180 s of audio a batch.
#
# REMAT defaults to 0: on an H100 80GB HBM3 the Large stage-1 step at
# B = 12 x 15 s in bf16 fits without per-layer activation checkpointing,
# which adds one student forward a step. As 4-step CUDA graphs (the
# default STEPS_PER_DISPATCH=4, with or without remat) remat cost 1.18x
# the step time (0.267 against 0.227 s) and saved half the memory (peak
# 13.9 against 26.5 GB, one key reserving 19.2 against 32.3 GB) on an
# NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase "large_graphs",
# PERF.md section 6). Those numbers are of the wav2vec2_large layout
# (fairseq's libri960_big.pt: GroupNorm extractor, post-LN encoder). For
# wav2vec2_large_lv60k (wav2vec_vox_new.pt: a LayerNorm after every conv,
# pre-LN, the waveform normalised) with REMAT=1 at this script's 180 s a
# batch, see the benchmark cell wav2vec2_large_lv60k.distill_remat
# (PERF.md sections 4 and 5). Set REMAT=1 to trade that time for
# activation memory (a larger SECONDS_PER_BATCH, or a smaller card).
# Without remat all 12 batch shapes at 180 s a batch captured as 4-step
# graphs fit on an H100 80GB (chip_smoke.py phase "graph_keys", PERF.md
# section 5).
# NPROC=n runs each training stage on n processes (run_torch.sh).
set -euo pipefail

export TEACHER_CKPT=${TEACHER_CKPT:-pretrained/wav2vec2-large.hf.pth}
export SECONDS_PER_BATCH=${SECONDS_PER_BATCH:-180}
export EXP_DIR=${EXP_DIR:-exp/wav2vec2-large_sp0.75}

TSV_DIR=${TSV_DIR:-data/librispeech} \
TRAIN_SUBSET=${TRAIN_SUBSET:-train960} \
DISTILL_LAYERS="0.4,8,12,16,20,24" \
MAX_UPDATES=${MAX_UPDATES:-140000} WARMUP_UPDATES=${WARMUP_UPDATES:-42000} \
FINAL_MAX_UPDATES=${FINAL_MAX_UPDATES:-70000} \
FINAL_WARMUP_UPDATES=${FINAL_WARMUP_UPDATES:-14000} \
REMAT=${REMAT:-0} \
bash "$(dirname "$0")/run_torch.sh"
