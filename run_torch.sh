#!/bin/bash
# Full compression recipe on one NVIDIA card: HuBERT Base -> DPHuBERT at
# sparsity 0.75, through the PyTorch/CUDA package (dphubert_torch).
#
# run.sh's four stages and hyperparameters (reference run.sh:45-115) with
# `python -m dphubert_torch.cli.*`.  Environment as run.sh's, plus
# DEVICE (default cuda; cpu runs the kernels' plain versions) and REMAT=1
# (per-layer activation checkpointing of the student: less activation
# memory for one more student forward a step).
#
# run.sh's runtime knobs: STEPS_PER_DISPATCH (default 4: K batches a
# dispatch, one CUDA graph of K steps on the card) and CKPT_BACKEND
# (default rotated: ckpts/rotated/step_<n>.pt, the newest three kept;
# last: ckpts/last.pt), both written by a background thread.
# NPROC=n (default 1) runs each training stage on n processes, one per card,
# under `python -m torch.distributed.run --standalone --nproc_per_node n`:
# data parallel (SECONDS_PER_BATCH stays per card); with DEVICE=cpu over
# gloo.  torchrun exits 1 whatever its ranks exit with, so a stage's own
# exit code (75, 76) is read from the <stage>/exit_code file its rank 0
# writes.
# Not passed: --rng_impl (the TPU's generator choice; the port draws from
# torch generators) and --scan_layers (it shrank the TPU package's compiled
# Large program and has no counterpart in eager PyTorch).
set -euo pipefail

# ---- hyperparameters (the recipe record, reference run.sh:16-42) ----
tsv_dir=${TSV_DIR:-data/librispeech}          # prepared by cli.prepare_data
train_subset=${TRAIN_SUBSET:-train960}
teacher_ckpt=${TEACHER_CKPT:-pretrained/hubert-base-ls960.hf.pth}
student_ckpt=${STUDENT_CKPT:-$teacher_ckpt}
distill_layers=${DISTILL_LAYERS:-"0.4,8,12"}
distill_mode="layer2layer"
l2_weight=0; l1_weight=1; cos_weight=1; cos_type="raw"

learning_rate=0.0002
warmup_updates=${WARMUP_UPDATES:-15000}
max_updates=${MAX_UPDATES:-50000}
seconds_per_batch=${SECONDS_PER_BATCH:-160}   # per card
clip_norm=10

num_shapes=${NUM_SHAPES:-12}                  # static length-bucket ladder
log_interval=${LOG_INTERVAL:-50}
ckpt_interval=${CKPT_INTERVAL:-1000}
device=${DEVICE:-cuda}
nproc=${NPROC:-1}
launch=(python -m)
if [ "$nproc" -gt 1 ]; then
  launch=(python -m torch.distributed.run --standalone --nproc_per_node "$nproc" -m)
fi

extra_flags=()
[ "${REMAT:-0}" = 1 ] && extra_flags+=(--remat)
ckpt_backend=${CKPT_BACKEND:-rotated}         # rotated: keep-3 step files; last: last.pt
steps_per_dispatch=${STEPS_PER_DISPATCH:-4}   # K steps a CUDA graph, with or without remat
runtime_flags=(--steps_per_dispatch "$steps_per_dispatch" --ckpt_backend "$ckpt_backend")

pruning_units="conv,head,interm"
reg_learning_rate=0.02
target_sparsity=${TARGET_SPARSITY:-0.75}
sparsity_warmup_updates=${SPARSITY_WARMUP_UPDATES:-5000}

final_learning_rate=0.0001
final_warmup_updates=${FINAL_WARMUP_UPDATES:-5000}
final_max_updates=${FINAL_MAX_UPDATES:-25000}

root_dir=${EXP_DIR:-exp/hubert-base_sp${target_sparsity}}
mkdir -p "$root_dir"

# A preempted stage (SIGTERM, or the trainer's RSS watchdog converting an
# impending OOM kill into a clean checkpoint) exits 75: resume it from its
# own checkpoint until it completes; any other failure aborts.
# $resume_from must match the stage's --ckpt_backend: last.pt for last, the
# ckpts/rotated directory for rotated (the trainer takes its newest step);
# $stage_dir is the stage's --exp_dir (its exit_code file under torchrun).
resume_path() {  # $1 = stage dir
  if [ "$ckpt_backend" = rotated ]; then
    echo "$1/ckpts/rotated"
  else
    echo "$1/ckpts/last.pt"
  fi
}

retry_resumable() {
  local attempt=0 rc resume_args
  while :; do
    resume_args=()
    [ $attempt -gt 0 ] && resume_args=(--resume_checkpoint "$resume_from")
    rm -f "$stage_dir/exit_code"
    "$@" "${resume_args[@]}"
    rc=${PIPESTATUS[0]:-$?}
    if [ "$rc" -ne 0 ] && [ -f "$stage_dir/exit_code" ]; then
      rc=$(cat "$stage_dir/exit_code")
    fi
    [ "$rc" -eq 0 ] && return 0
    [ "$rc" -ne 75 ] && return "$rc"
    attempt=$((attempt + 1))
    echo "[run.sh] $(date -Is) stage preempted (exit 75), resuming (attempt $attempt)"
  done
}

echo "[run_torch.sh] $(date -Is) stage 1 (distill) start"
# ---- stage 1: joint distillation + structured pruning ----
stage_dir="$root_dir/stage1"
resume_from=$(resume_path "$stage_dir")
retry_resumable "${launch[@]}" dphubert_torch.cli.distill \
  --tsv_dir "$tsv_dir" --train_subset "$train_subset" \
  --seconds_per_batch "$seconds_per_batch" \
  --exp_dir "$root_dir/stage1" \
  --teacher_ckpt "$teacher_ckpt" --student_ckpt "$student_ckpt" \
  --distill_layers "$distill_layers" --distill_mode "$distill_mode" \
  --l2_weight "$l2_weight" --l1_weight "$l1_weight" \
  --cos_weight "$cos_weight" --cos_type "$cos_type" \
  --learning_rate "$learning_rate" --warmup_updates "$warmup_updates" \
  --max_updates "$max_updates" --clip_norm "$clip_norm" \
  --pruning_units "$pruning_units" --reg_learning_rate "$reg_learning_rate" \
  --target_sparsity "$target_sparsity" \
  --sparsity_warmup_updates "$sparsity_warmup_updates" \
  --num_shapes "$num_shapes" \
  --log_interval "$log_interval" --ckpt_interval "$ckpt_interval" \
  --precision bf16 --device "$device" "${runtime_flags[@]}" \
  ${extra_flags[@]+"${extra_flags[@]}"} 2>&1 | tee -a "$root_dir/stage1.log" || exit 1

echo "[run_torch.sh] $(date -Is) stage 1.5 (prune) start"
# ---- stage 1.5: mask surgery ----
python -m dphubert_torch.cli.prune \
  --distilled_ckpt "$root_dir/stage1/ckpts/distilled.pth" \
  --original_ckpt "$teacher_ckpt"

echo "[run_torch.sh] $(date -Is) stage 2 (final_distill) start"
# ---- stage 2: final distillation of the pruned student ----
stage_dir="$root_dir/stage2"
resume_from=$(resume_path "$stage_dir")
retry_resumable "${launch[@]}" dphubert_torch.cli.final_distill \
  --tsv_dir "$tsv_dir" --train_subset "$train_subset" \
  --seconds_per_batch "$seconds_per_batch" \
  --exp_dir "$root_dir/stage2" \
  --teacher_ckpt "$teacher_ckpt" \
  --student_ckpt "$root_dir/stage1/ckpts/pruned_hubert_base.pth" \
  --distill_layers "$distill_layers" --distill_mode "$distill_mode" \
  --l2_weight "$l2_weight" --l1_weight "$l1_weight" \
  --cos_weight "$cos_weight" --cos_type "$cos_type" \
  --learning_rate "$final_learning_rate" \
  --warmup_updates "$final_warmup_updates" \
  --max_updates "$final_max_updates" --clip_norm "$clip_norm" \
  --num_shapes "$num_shapes" \
  --log_interval "$log_interval" --ckpt_interval "$ckpt_interval" \
  --precision bf16 --device "$device" "${runtime_flags[@]}" \
  ${extra_flags[@]+"${extra_flags[@]}"} 2>&1 | tee -a "$root_dir/stage2.log" || exit 1

echo "[run_torch.sh] $(date -Is) stage 3 (save_final_ckpt) start"
# ---- stage 3: merge + export the portable checkpoint ----
python -m dphubert_torch.cli.save_final_ckpt \
  --config_path "$root_dir/stage1/ckpts/pruned_hubert_base.pth" \
  --ckpt_after_final_distill "$root_dir/stage2/ckpts/distilled.pth" \
  --out "$root_dir/dphubert.pth"

python -m dphubert_torch.cli.load_dpmodel "$root_dir/dphubert.pth" --device "$device"
echo "[run_torch.sh] $(date -Is) done"
echo "Done: $root_dir/dphubert.pth"
