"""Shared CLI plumbing for the pipeline stages (the TPU package's
``cli/common.py``)."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from ..data import AudioDataset, DistillDataLoader, StaticShapeBatcher
from ..interop.torch_ckpt import load_checkpoint, model_from_checkpoint


def load_model_ckpt(path, device="cuda"):
    """Checkpoint -> (model on ``device`` in eval mode, raw ckpt dict)."""
    ckpt = load_checkpoint(path)
    return model_from_checkpoint(ckpt, device), ckpt


def apply_pruning_units(config: dict, pruning_units: str) -> dict:
    """Inject prune-enable flags from the --pruning_units CSV
    (reference ``distill.py:67-78``)."""
    units = pruning_units.split(",") if pruning_units else []
    config = dict(config)
    config.update(
        extractor_prune_conv_channels="conv" in units,
        encoder_prune_attention_heads="head" in units,
        encoder_prune_attention_layer="attlayer" in units,
        encoder_prune_feed_forward_intermediate="interm" in units,
        encoder_prune_feed_forward_layer="ffnlayer" in units,
    )
    return config


def merge_params(template: Dict[str, object], source: Dict[str, object]) -> Dict[str, object]:
    """Overlay ``source`` entries onto the state dict ``template`` where the
    keys coincide: an ungated checkpoint loads into a gated student and the
    gates' log_alphas keep their fresh init, mirroring strict=False loading
    (reference ``distill.py:81``).  Keys only in ``source`` are dropped."""
    return {k: source.get(k, v) for k, v in template.items()}


def build_loader(args, subset: str, num_replicas: int = 1,
                 shard: Optional[Tuple[int, int]] = None,
                 shuffle_seed: int = 0) -> DistillDataLoader:
    """``seconds_per_batch`` is the audio budget of one data rank's batch,
    as in the reference CLI (each DDP rank packs its own); the global batch
    is ``num_replicas`` times that and ``shard`` = (data rank, data ranks)
    decodes this rank's rows of it.  The rung ladder is the TPU package's
    (32,000 to 250,000 samples, ``num_shapes`` rungs).  Batches are fed as
    int16 PCM (half the host-to-card bytes of float32, and the same
    values).  The epoch comes in same-rung runs of ``--steps_per_dispatch``
    batches, so that the trainer can stack them into one dispatch."""
    dataset = AudioDataset(args.tsv_dir, subset)
    batcher = StaticShapeBatcher(
        dataset.len_list,
        max_token_count=int(args.seconds_per_batch * 16000),
        min_len=32000,
        max_len=250000,
        num_shapes=args.num_shapes,
        seed=shuffle_seed,
        num_replicas=num_replicas,
        run_length=getattr(args, "steps_per_dispatch", 1),
    )
    return DistillDataLoader(dataset, batcher, num_workers=args.num_workers,
                             seed=shuffle_seed, shard=shard, feed_dtype="int16")
