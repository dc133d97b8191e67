"""Mask surgery: turn a gated model + trained log_alphas into a physically
smaller dense model (a copy of the TPU package's ``prune/surgery.py``, on
the port's state dict).

Host-side numpy surgery reproducing the reference's in-place module
surgery (``wav2vec2/model.py:115-125`` ->
``components.py:198-235,451-483,661-693,763-791,1011-1016`` and
``pruning_utils.py``):

  * compile deterministic eval masks (top-k of the HardConcrete soft mask),
  * index-select surviving channels/heads/units out of every affected weight,
  * fold the *soft* mask values into the downstream weights (so the pruned
    model reproduces the gated model's eval-mode outputs),
  * drop whole sublayers whose layer gate or unit count hit zero,
  * emit the new heterogeneous config.

Everything runs in numpy on the host: surgery is a one-shot,
shape-changing operation.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from ..configs import ModelSpec, config_from_spec, spec_from_config
from ..models.hardconcrete import eval_mask
from ..params import flatten_params, unflatten_params


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().copy()
    return np.array(x, copy=True)


def _select(arr: np.ndarray, index: np.ndarray, axis: int) -> np.ndarray:
    return np.take(arr, index, axis=axis)


def _prune_linear(p: dict, index: np.ndarray, dim: str) -> None:
    """index_select on a torch-layout Linear (weight (out, in))
    (reference ``pruning_utils.py:9-23``)."""
    axis = 1 if dim == "input" else 0
    p["weight"] = _select(p["weight"], index, axis)
    if "bias" in p and axis == 0:
        p["bias"] = _select(p["bias"], index, 0)


def _prune_conv1d(p: dict, index: np.ndarray, dim: str) -> None:
    axis = 1 if dim == "input" else 0
    p["weight"] = _select(p["weight"], index, axis)
    if "bias" in p and axis == 0:
        p["bias"] = _select(p["bias"], index, 0)


def _prune_norm(p: dict, index: np.ndarray) -> None:
    p["weight"] = _select(p["weight"], index, 0)
    p["bias"] = _select(p["bias"], index, 0)


def _prune_feature_extractor(fe: dict, spec: ModelSpec):
    """Per-conv-layer channel pruning chain (reference
    ``components.py:198-235``): shrink this layer's outputs and the next
    layer's inputs (or the dummy_weight at the last layer)."""
    new_shapes = []
    n_layers = len(spec.conv_layers)
    index = None
    for i, cspec in enumerate(spec.conv_layers):
        lp = fe["conv_layers"][str(i)]
        if "hard_concrete" in lp:
            mask = eval_mask(lp["hard_concrete"]["log_alpha"])
            index = np.nonzero(mask)[0]
            if len(index) == 0:
                raise ValueError(f"Conv channels pruned to zero at layer {i}")
            new_shapes.append((len(index), cspec.kernel_size, cspec.stride))

            _prune_conv1d(lp["conv"], index, "output")
            if "layer_norm" in lp:
                _prune_norm(lp["layer_norm"], index)

            if i == n_layers - 1:
                fe["dummy_weight"] = (fe["dummy_weight"] * mask)[index]
            else:
                nxt = fe["conv_layers"][str(i + 1)]
                nxt["conv"]["weight"] = nxt["conv"]["weight"] * mask[None, :, None]
                _prune_conv1d(nxt["conv"], index, "input")
            del lp["hard_concrete"]
        else:
            new_shapes.append(
                (cspec.out_channels, cspec.kernel_size, cspec.stride)
            )
            index = np.arange(cspec.out_channels)
    return new_shapes, index


def _prune_attention(ap: dict, head_dim: int, is_wavlm: bool):
    """Returns (new_config, keep_params: bool).  Folds the layer gate into
    out_proj and selects surviving heads (reference
    ``components.py:451-483`` / ``661-693``)."""
    cfg = {"use_attention": True}
    if "hard_concrete_for_layer" in ap:
        layer_mask = eval_mask(ap["hard_concrete_for_layer"]["log_alpha"])
        ap["out_proj"]["weight"] = ap["out_proj"]["weight"] * layer_mask
        ap["out_proj"]["bias"] = ap["out_proj"]["bias"] * layer_mask
        if float(layer_mask[0]) == 0.0:
            cfg["use_attention"] = False
        del ap["hard_concrete_for_layer"]

    if "hard_concrete_for_heads" in ap:
        head_mask = eval_mask(ap["hard_concrete_for_heads"]["log_alpha"])
        head_index = np.nonzero(head_mask)[0]
        if is_wavlm:
            cfg["remaining_heads"] = [int(h) for h in head_index]
        else:
            cfg["num_heads"] = len(head_index)
        if len(head_index) == 0:
            cfg["use_attention"] = False
        else:
            full_mask = np.repeat(head_mask, head_dim)
            full_index = np.nonzero(full_mask)[0]
            _prune_linear(ap["k_proj"], full_index, "output")
            _prune_linear(ap["v_proj"], full_index, "output")
            _prune_linear(ap["q_proj"], full_index, "output")
            ap["out_proj"]["weight"] = ap["out_proj"]["weight"] * full_mask
            _prune_linear(ap["out_proj"], full_index, "input")
        del ap["hard_concrete_for_heads"]
    return cfg


def _prune_feed_forward(fp: dict):
    cfg = {"use_feed_forward": True}
    if "hard_concrete_for_layer" in fp:
        layer_mask = eval_mask(fp["hard_concrete_for_layer"]["log_alpha"])
        fp["output_dense"]["weight"] = fp["output_dense"]["weight"] * layer_mask
        fp["output_dense"]["bias"] = fp["output_dense"]["bias"] * layer_mask
        if float(layer_mask[0]) == 0.0:
            cfg["use_feed_forward"] = False
        del fp["hard_concrete_for_layer"]

    if "hard_concrete_for_intermediate" in fp:
        interm_mask = eval_mask(fp["hard_concrete_for_intermediate"]["log_alpha"])
        interm_index = np.nonzero(interm_mask)[0]
        cfg["ff_interm_features"] = len(interm_index)
        if len(interm_index) == 0:
            cfg["use_feed_forward"] = False
        else:
            _prune_linear(fp["intermediate_dense"], interm_index, "output")
            fp["output_dense"]["weight"] = fp["output_dense"]["weight"] * interm_mask
            _prune_linear(fp["output_dense"], interm_index, "input")
        del fp["hard_concrete_for_intermediate"]
    return cfg


def prune_model(spec: ModelSpec, state_dict: Mapping[str, object]
                ) -> Tuple[dict, Dict[str, np.ndarray]]:
    """Full surgery chain on a gated model's state dict (tensors or arrays)
    -> (pruned config, pruned state dict of numpy arrays).

    Mirrors ``Wav2Vec2Model.prune`` + ``prune.py:32-59``: the pruned
    heterogeneous config has all prune flags off, and the state dict's keys
    are the reference's pruned state dict's; it loads into
    ``wav2vec2_model(**config)`` with ``strict=True``.
    """
    p = unflatten_params({k: _np(v) for k, v in state_dict.items()})

    conv_shapes, conv_index = _prune_feature_extractor(p["feature_extractor"], spec)

    # feature projection consumes the conv survivors
    fp = p["encoder"]["feature_projection"]
    _prune_norm(fp["layer_norm"], conv_index)
    _prune_linear(fp["projection"], conv_index, "input")

    use_attention = []
    use_feed_forward = []
    num_heads = []
    remaining_heads = []
    ff_interm_features = []

    for i, layer in enumerate(spec.layers):
        lp = p["encoder"]["transformer"]["layers"][str(i)]
        if layer.attention is not None:
            acfg = _prune_attention(
                lp["attention"], layer.attention.head_dim, layer.attention.is_wavlm
            )
            if layer.attention.is_wavlm:
                rh = acfg.get(
                    "remaining_heads", list(layer.attention.remaining_heads)
                )
                remaining_heads.append(rh)
            else:
                num_heads.append(acfg.get("num_heads", layer.attention.num_heads))
            use_attention.append(acfg["use_attention"])
            if not acfg["use_attention"]:
                # keep WavLM's rel-pos machinery out too: the reference drops
                # the whole attention module when the layer dies
                del lp["attention"]
        else:
            use_attention.append(False)
            if spec.is_wavlm:
                remaining_heads.append([])
            else:
                num_heads.append(0)

        if layer.feed_forward is not None:
            fcfg = _prune_feed_forward(lp["feed_forward"])
            use_feed_forward.append(fcfg["use_feed_forward"])
            ff_interm_features.append(
                fcfg.get(
                    "ff_interm_features", layer.feed_forward.intermediate_features
                )
            )
            if not fcfg["use_feed_forward"]:
                del lp["feed_forward"]
        else:
            use_feed_forward.append(False)
            ff_interm_features.append(0)

    # Emit pruned config: original config + new per-layer lists, flags off
    # (reference prune.py:32-59).
    cfg = config_from_spec(spec, prune_flags=False)
    cfg.update(
        extractor_conv_layer_config=[list(s) for s in conv_shapes],
        encoder_use_attention=use_attention,
        encoder_use_feed_forward=use_feed_forward,
        encoder_ff_interm_features=ff_interm_features,
    )
    if spec.is_wavlm:
        cfg["encoder_remaining_heads"] = remaining_heads
    else:
        cfg["encoder_num_heads"] = num_heads
    spec_from_config(**cfg)  # the emitted config must describe a model
    return cfg, flatten_params(p)
