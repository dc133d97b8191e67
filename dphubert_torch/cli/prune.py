"""Mask surgery on the stage-1 output (reference ``prune.py``).

Consumes the distilled checkpoint, infers which gates it has, prunes
(``prune/surgery.py``) and writes ``pruned_hubert_base.pth`` with the
heterogeneous config, verified by a strict reload.  Host-side numpy work:
it takes no device.
"""

from __future__ import annotations

import json
import pathlib
from argparse import ArgumentParser

import torch

from ..configs import spec_from_config
from ..interop.torch_ckpt import load_checkpoint, save_checkpoint, verify_strict
from ..models.model import Wav2Vec2Model
from ..prune.surgery import prune_model


def _infer_prune_flags(state_dict) -> dict:
    """Probe gate keys to recover which pruning units were on
    (reference ``prune.py:20-28``)."""
    return dict(
        extractor_prune_conv_channels=(
            "feature_extractor.conv_layers.0.hard_concrete.log_alpha" in state_dict
        ),
        encoder_prune_attention_heads=(
            "encoder.transformer.layers.0.attention.hard_concrete_for_heads.log_alpha"
            in state_dict
        ),
        encoder_prune_attention_layer=(
            "encoder.transformer.layers.0.attention.hard_concrete_for_layer.log_alpha"
            in state_dict
        ),
        encoder_prune_feed_forward_intermediate=(
            "encoder.transformer.layers.0.feed_forward.hard_concrete_for_intermediate.log_alpha"
            in state_dict
        ),
        encoder_prune_feed_forward_layer=(
            "encoder.transformer.layers.0.feed_forward.hard_concrete_for_layer.log_alpha"
            in state_dict
        ),
    )


def _student_state_dict(state_dict: dict) -> dict:
    """Lightning-style checkpoints prefix the student's keys; ours do not."""
    if any(k.startswith("student_model.") for k in state_dict):
        return {k[len("student_model."):]: v for k, v in state_dict.items()
                if k.startswith("student_model.")}
    return state_dict


def _shapes_model(config: dict) -> Wav2Vec2Model:
    """The model of ``config`` on the meta device: keys and shapes only, no
    memory for the weights."""
    with torch.device("meta"):
        return Wav2Vec2Model(spec_from_config(**config), config_override=config)


def prune_from_ckpt(distilled_ckpt, original_ckpt=None) -> dict:
    ckpt = load_checkpoint(distilled_ckpt)
    state_dict = _student_state_dict(ckpt["state_dict"])
    if original_ckpt is not None:
        config = dict(load_checkpoint(original_ckpt)["config"])
    else:
        config = dict(ckpt["config"])
    config.update(_infer_prune_flags(state_dict))

    verify_strict(_shapes_model(config), state_dict)
    pruned_config, pruned_sd = prune_model(spec_from_config(**config), state_dict)
    print(json.dumps(pruned_config, indent=4))
    return {
        "state_dict": pruned_sd,
        "config": pruned_config,
        "distill_linear_projs": ckpt.get("distill_linear_projs", {}),
    }


def load_pruned_model(ckpt_path) -> Wav2Vec2Model:
    """Strict reload check of a written checkpoint (keys and shapes)."""
    ckpt = load_checkpoint(ckpt_path)
    model = _shapes_model(ckpt["config"])
    verify_strict(model, ckpt["state_dict"])
    return model


def parse_args(argv=None):
    parser = ArgumentParser(description="Prune and save distilled model.")
    parser.add_argument("--distilled_ckpt", type=pathlib.Path, required=True)
    parser.add_argument("--original_ckpt", type=pathlib.Path, default=None,
                        help="Source of the base config (optional if the "
                        "distilled ckpt embeds its config).")
    parser.add_argument("--out", type=pathlib.Path, default=None)
    return parser.parse_args(argv)


def cli_main(argv=None):
    args = parse_args(argv)
    out_path = args.out or (args.distilled_ckpt.parent / "pruned_hubert_base.pth")
    ret = prune_from_ckpt(args.distilled_ckpt, args.original_ckpt)
    save_checkpoint(out_path, ret["config"], ret["state_dict"], ret["distill_linear_projs"])
    load_pruned_model(out_path)  # strict reload check
    print(f"Successfully saved pruned model weights and config to: {out_path}")


if __name__ == "__main__":
    cli_main()
