"""Gate trees: sampling (train) and compiling (eval) HardConcrete masks.

The gate tree parallels the layer structure, keyed as the TPU package's
(``models/gates.py``), so gates and their uniform draws pass between the two
packages as they are::

    {
      "conv_layers": {"0": mask, ...},                       # channel gates
      "layers": {
        "0": {
          "attention":   {"heads": mask, "layer": mask},
          "feed_forward": {"intermediate": mask, "layer": mask},
        }, ...
      },
    }

Entries exist only where the spec enables pruning.  Functions take the
nested parameter dict (``unflatten_params(dict(model.named_parameters()))``),
so sampled gates stay differentiable in ``log_alpha``.
"""

from __future__ import annotations

from typing import Callable, Iterator, Optional, Tuple

import torch

from ..configs import ModelSpec
from .hardconcrete import eval_mask, sample_mask


def has_gates(spec: ModelSpec) -> bool:
    if any(c.prune_channels for c in spec.conv_layers):
        return True
    for l in spec.layers:
        if l.attention is not None and (l.attention.prune_heads or l.attention.prune_layer):
            return True
        if l.feed_forward is not None and (
            l.feed_forward.prune_intermediate or l.feed_forward.prune_layer
        ):
            return True
    return False


def gate_paths(spec: ModelSpec) -> Iterator[Tuple[Tuple[str, ...], Tuple[str, ...]]]:
    """(gate tree path, parameter path of its ``log_alpha``) for every gate,
    in the order the TPU package's ``sample_gates`` draws them."""
    for i, c in enumerate(spec.conv_layers):
        if c.prune_channels:
            yield (("conv_layers", str(i)),
                   ("feature_extractor", "conv_layers", str(i), "hard_concrete", "log_alpha"))
    for i, l in enumerate(spec.layers):
        base = ("encoder", "transformer", "layers", str(i))
        if l.attention is not None:
            if l.attention.prune_heads:
                yield (("layers", str(i), "attention", "heads"),
                       base + ("attention", "hard_concrete_for_heads", "log_alpha"))
            if l.attention.prune_layer:
                yield (("layers", str(i), "attention", "layer"),
                       base + ("attention", "hard_concrete_for_layer", "log_alpha"))
        if l.feed_forward is not None:
            if l.feed_forward.prune_intermediate:
                yield (("layers", str(i), "feed_forward", "intermediate"),
                       base + ("feed_forward", "hard_concrete_for_intermediate", "log_alpha"))
            if l.feed_forward.prune_layer:
                yield (("layers", str(i), "feed_forward", "layer"),
                       base + ("feed_forward", "hard_concrete_for_layer", "log_alpha"))


def _get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _build(spec: ModelSpec, params, mask_fn: Callable) -> Optional[dict]:
    if not has_gates(spec):
        return None
    gates: dict = {}
    for gate_path, param_path in gate_paths(spec):
        node = gates
        for key in gate_path[:-1]:
            node = node.setdefault(key, {})
        node[gate_path[-1]] = mask_fn(gate_path, _get(params, param_path))
    return gates


def sample_gates(
    spec: ModelSpec, params, generator: Optional[torch.Generator] = None,
    u: Optional[dict] = None,
) -> Optional[dict]:
    """Sample every HardConcrete mask for one training step, drawing in the
    TPU package's order from ``generator``, or taking the uniform draws from
    ``u``, a tree of the gates' layout (tensors or numpy arrays)."""
    def mask(gate_path, log_alpha):
        return sample_mask(log_alpha, generator, None if u is None else _get(u, gate_path))

    return _build(spec, params, mask)


def compile_gates(spec: ModelSpec, params) -> Optional[dict]:
    """Deterministic eval-mode masks (the host-side numpy top-k of
    ``eval_mask``), as float32 tensors on each ``log_alpha``'s device."""
    def mask(gate_path, log_alpha):
        return torch.from_numpy(eval_mask(log_alpha)).to(log_alpha.device)

    return _build(spec, params, mask)
