"""What the benchmark takes from the program under test (``dphubert_torch``):
its model loaded from a configuration and a state dict, the stage-1 train
step, the trainer's feed and its launch counters.  Everything else the
benchmark makes itself."""

from __future__ import annotations

from typing import Dict

import torch


def load_model(config: dict, params: Dict[str, torch.Tensor], device) -> torch.nn.Module:
    """The checkpoint loader's path: ``Wav2Vec2Model`` of the configuration,
    the state dict loaded with ``strict=True``, in eval mode; built on
    ``device`` without an initialisation of its own."""
    from dphubert_torch.configs import spec_from_config
    from dphubert_torch.models.model import Wav2Vec2Model

    with torch.device(device):
        model = Wav2Vec2Model(spec_from_config(**config), config_override=config)
    model.load_state_dict(params, strict=True)
    return model.eval()


def distill_config(recipe: dict, dtype: str):
    from dphubert_torch.train import DistillConfig

    return DistillConfig(
        distill_mode="layer2layer",
        distill_layer_groups=tuple(tuple(g) for g in recipe["groups"]),
        l2_weight=0.0, l1_weight=recipe["l1_weight"], cos_weight=recipe["cos_weight"],
        cos_type="raw", learning_rate=recipe["learning_rate"], weight_decay=0.0,
        warmup_updates=recipe["warmup_updates"], max_updates=recipe["max_updates"],
        clip_norm=recipe["clip_norm"], use_reg=True,
        reg_learning_rate=recipe["reg_learning_rate"],
        target_sparsity=recipe["target_sparsity"],
        sparsity_warmup_updates=recipe["sparsity_warmup_updates"],
        compute_dtype=dtype)


def launches() -> Dict[str, int]:
    """The kernels' launch counters, graph replays included: the counters
    (which count a capture and not its replays) less the captured counts
    plus the replayed ones."""
    from dphubert_torch.ops import kernel_launches
    from dphubert_torch.train.distill_module import GraphedSteps

    out = dict(kernel_launches())
    for k, v in GraphedSteps.captured.items():
        out[k] = out.get(k, 0) - v
    for k, v in GraphedSteps.replayed.items():
        out[k] = out.get(k, 0) + v
    return out
