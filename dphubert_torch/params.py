"""State-dict helpers.

The portable checkpoint's flat keys (``feature_extractor.conv_layers.0.conv.weight``)
are the module paths of :class:`~dphubert_torch.models.model.Wav2Vec2Model`,
and the TPU package's nested parameter tree flattens to the same keys with
the same (torch) layouts, so moving parameters between the two is a flatten
and a ``torch.from_numpy``, with no renaming or transposition.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .configs import ModelSpec


def flatten_params(tree, prefix: str = "") -> Dict[str, object]:
    """Nested dict -> flat ``{"a.b.c": leaf}`` (state-dict layout)."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten_params(v, prefix=f"{key}."))
        else:
            out[key] = v
    return out


def unflatten_params(flat: Dict[str, object]) -> dict:
    """Flat state dict -> nested dict."""
    tree: dict = {}
    for key, v in flat.items():
        parts = key.split(".")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def state_dict_from_jax(tree_or_flat) -> Dict[str, torch.Tensor]:
    """The TPU package's parameters (a nested tree or its flat dict, leaves
    as arrays) -> this package's state dict, for
    ``model.load_state_dict(..., strict=True)``."""
    flat = flatten_params(tree_or_flat)
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in flat.items()}


def train_params_from_jax(params) -> Dict[str, torch.Tensor]:
    """The TPU package's training parameters ``{"student", "projs",
    ["lambdas"]}`` (its ``TrainState.params``, leaves as arrays) -> flat
    tensors named as ``TrainState.named_params`` names them
    (``student.<state-dict key>``, ``projs.groups.0.weight``,
    ``lambdas.lambda1``), for ``TrainState.load_params``."""
    out = {f"student.{k}": v for k, v in state_dict_from_jax(params["student"]).items()}
    for group in ("projs", "lambdas"):
        if group in params:
            flat = flatten_params(params[group], prefix=f"{group}.")
            out.update({k: torch.from_numpy(np.array(v, dtype=np.float32, copy=True))
                        for k, v in flat.items()})
    return out


def init_params(spec: ModelSpec, generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    """A randomly initialised state dict for ``spec`` (on the CPU)."""
    from .models.model import Wav2Vec2Model

    model = Wav2Vec2Model(spec)
    model.reset_parameters(
        generator if generator is not None else torch.Generator().manual_seed(0)
    )
    return model.state_dict()
