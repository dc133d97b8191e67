"""The training-state checkpoint: one synchronous, last-only file.

The TPU package writes ``ckpts/last.npz`` (``trainer.py:80-168``) or an orbax
directory; the port writes ``ckpts/last.pt``, a ``torch.save`` of plain
containers and tensors that loads with ``torch.load(weights_only=True)``:

    {"params":  {name: tensor},          # TrainState.named_params(): the
                                         # student, projections and λs
     "opt":     {"mu": {...}, "nu": {...}, "count": int, "mini_step": int,
                 "acc": {...} or None},   # the three Adam groups' moments
     "step":    int,                      # micro-steps taken
     "generator": uint8 tensor,           # the state's generator (gates and
                                          # dropout), on the card or the CPU
     "epoch": int, "batch_in_epoch": int, # the loader's position
     "meta": {"format": ..., "generator_device": "cuda" | "cpu",
              "accum_grad": int}}

so that a resumed run takes exactly the batches, gate draws and dropout
masks an uninterrupted run would.  The file is written to a temporary name
and renamed, so a crash mid-write leaves the previous checkpoint whole.
Orbax's rotation, the background saver and the paced device gather of the
TPU package are not ported (ROADMAP queue 1).
"""

from __future__ import annotations

import os
import pathlib
from typing import Tuple

import torch

from .distill_module import TrainState

FORMAT = "dphubert_torch train state 1"


def _host(tensors: dict) -> dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in tensors.items()}


def save_train_state(path, state: TrainState, *, epoch: int = 0,
                     batch_in_epoch: int = 0, accum_grad: int = 1) -> None:
    """Write the full training state and the loader position to ``path``."""
    path = pathlib.Path(path)
    opt = state.opt_state
    payload = {
        "params": _host(state.named_params()),
        "opt": {"mu": _host(opt.mu), "nu": _host(opt.nu), "count": int(opt.count),
                "mini_step": int(opt.mini_step),
                "acc": None if opt.acc is None else _host(opt.acc)},
        "step": int(state.step),
        "generator": state.generator.get_state(),
        "epoch": int(epoch),
        "batch_in_epoch": int(batch_in_epoch),
        "meta": {"format": FORMAT, "generator_device": state.generator.device.type,
                 "accum_grad": int(accum_grad)},
    }
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    torch.save(payload, tmp)
    os.replace(tmp, path)


def _copy_into(dst: dict, src: dict, what: str) -> None:
    if set(dst) != set(src):
        raise ValueError(f"{what}: names differ: {sorted(set(dst) ^ set(src))[:8]}")
    for k, t in dst.items():
        t.copy_(src[k].to(t.device, t.dtype))


@torch.no_grad()
def load_train_state(path, state: TrainState, *, accum_grad: int = 1) -> Tuple[int, int]:
    """Restore ``path`` into ``state`` in place (parameters, moments, step
    and generator); returns the loader position (epoch, batch_in_epoch).
    Raises where the checkpoint cannot continue this run: another format,
    a generator of another device type, another ``accum_grad``."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    meta = ckpt.get("meta", {})
    if meta.get("format") != FORMAT:
        raise ValueError(f"{path}: not a {FORMAT!r} checkpoint (meta {meta})")
    if meta["generator_device"] != state.generator.device.type:
        raise ValueError(
            f"{path} holds a {meta['generator_device']} generator, this run has a "
            f"{state.generator.device.type} one: resume on the device that wrote it"
        )
    if meta["accum_grad"] != accum_grad:
        raise ValueError(f"{path} was written with accum_grad={meta['accum_grad']}, "
                         f"this run has {accum_grad}")
    state.load_params(ckpt["params"])
    opt = state.opt_state
    _copy_into(opt.mu, ckpt["opt"]["mu"], "Adam first moments")
    _copy_into(opt.nu, ckpt["opt"]["nu"], "Adam second moments")
    if opt.acc is not None:
        _copy_into(opt.acc, ckpt["opt"]["acc"], "gradient accumulator")
    opt.count = int(ckpt["opt"]["count"])
    opt.mini_step = int(ckpt["opt"]["mini_step"])
    state.step = int(ckpt["step"])
    state.generator.set_state(ckpt["generator"])
    return int(ckpt["epoch"]), int(ckpt["batch_in_epoch"])
