"""Portable checkpoint interop.

A checkpoint is a torch pickle holding::

    {"state_dict": {flat keys -> tensors},
     "config": <plain dict>,
     ["distill_linear_projs": {flat keys -> tensors}]}

or the same content in the native format (``.npz`` with the config as JSON
in ``__config__``).  Both formats are byte-compatible with the TPU
package's ``interop/torch_ckpt.py``: either package reads what the other
writes.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np
import torch


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _to_tensor(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().clone()
    return torch.from_numpy(np.array(v, copy=True))


def load_checkpoint(path) -> dict:
    """Load a portable checkpoint (.pth torch pickle or native .npz) with
    numpy leaves."""
    path = os.fspath(path)
    if path.endswith(".npz"):
        return load_native(path)
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    out = {"config": ckpt["config"]}
    out["state_dict"] = {k: _to_numpy(v) for k, v in ckpt["state_dict"].items()}
    if "distill_linear_projs" in ckpt:
        out["distill_linear_projs"] = {
            k: _to_numpy(v) for k, v in ckpt["distill_linear_projs"].items()
        }
    return out


def save_checkpoint(
    path,
    config: dict,
    state_dict: Dict[str, object],
    distill_linear_projs: Optional[Dict[str, object]] = None,
) -> None:
    """Save in the torch-pickle format (or native .npz); leaves may be
    tensors or arrays."""
    path = os.fspath(path)
    if path.endswith(".npz"):
        save_native(path, config, state_dict, distill_linear_projs)
        return
    payload = {
        "state_dict": {k: _to_tensor(v) for k, v in state_dict.items()},
        "config": config,
    }
    if distill_linear_projs is not None:
        payload["distill_linear_projs"] = {
            k: _to_tensor(v) for k, v in distill_linear_projs.items()
        }
    torch.save(payload, path)


# --- native format ----------------------------------------------------------


def save_native(path, config, state_dict, distill_linear_projs=None) -> None:
    arrays = {f"state_dict/{k}": _to_numpy(v) for k, v in state_dict.items()}
    if distill_linear_projs is not None:
        arrays.update(
            {f"distill_linear_projs/{k}": _to_numpy(v) for k, v in distill_linear_projs.items()}
        )
    arrays["__config__"] = np.frombuffer(
        json.dumps(config).encode("utf-8"), dtype=np.uint8
    )
    np.savez(path, **arrays)


def load_native(path) -> dict:
    data = np.load(path, allow_pickle=False)
    config = json.loads(bytes(data["__config__"]).decode("utf-8"))
    out = {"config": config, "state_dict": {}}
    for k in data.files:
        if k.startswith("state_dict/"):
            out["state_dict"][k[len("state_dict/"):]] = data[k]
        elif k.startswith("distill_linear_projs/"):
            out.setdefault("distill_linear_projs", {})[
                k[len("distill_linear_projs/"):]
            ] = data[k]
    return out


# --- model-level helpers ----------------------------------------------------


def model_from_checkpoint(ckpt: dict, device="cuda"):
    """A loaded checkpoint dict (``load_checkpoint``) -> ``Wav2Vec2Model``
    on ``device`` in eval mode, loaded with ``strict=True``; the model keeps
    the checkpoint's config as it is.  Raises if CUDA is asked for and
    absent."""
    from ..configs import spec_from_config
    from ..models.model import Wav2Vec2Model, resolve_device

    device = resolve_device(device)
    model = Wav2Vec2Model(spec_from_config(**ckpt["config"]), config_override=ckpt["config"])
    model.load_state_dict(
        {k: torch.from_numpy(np.array(v, copy=True)) for k, v in ckpt["state_dict"].items()},
        strict=True,
    )
    return model.to(device).eval()


def load_model(path, device="cuda"):
    """Checkpoint -> ``Wav2Vec2Model`` on ``device`` in eval mode, loaded
    with ``strict=True`` (the ``wav2vec2_model(**ckpt["config"])`` +
    ``load_state_dict`` one-liner).  Raises if CUDA is asked for and absent."""
    return model_from_checkpoint(load_checkpoint(path), device)


def verify_strict(model, state_dict: Dict[str, object]) -> None:
    """strict=True load check: the key sets are equal and the shapes match."""
    expect = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    missing = set(expect) - set(state_dict)
    unexpected = set(state_dict) - set(expect)
    if missing or unexpected:
        raise ValueError(
            f"strict load failed: missing={sorted(missing)}, "
            f"unexpected={sorted(unexpected)}"
        )
    for k, shape in expect.items():
        got = tuple(np.shape(state_dict[k]))
        if got != shape:
            raise ValueError(f"shape mismatch for {k}: ckpt {got} vs model {shape}")
