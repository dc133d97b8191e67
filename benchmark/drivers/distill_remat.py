"""The stage-1 distill cells with per-layer remat (``kind`` "distill_remat"):
``distill``'s feed, set-up, window and check, with four differences.

* The step checkpoints each of the student's encoder layers
  (``DistillConfig.remat``, as ``run_large_torch.sh REMAT=1`` runs it), as
  the configuration's ``recipe`` asks (``"remat": true``).
* The reference is ``reference/normalized.py``'s: the waveform normalised
  per clip where the configuration asks for it, a batch taken in slices
  that the card holds in float32.
* The window's attention ops count one more student forward a step: the
  recompute of every checkpointed layer's attention in the backward.
* The process runs with the caching allocator's segments expandable
  (``PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True``) from the start of
  set-up, before its first allocation, unless that variable names the
  setting.  With
  fixed-size segments the eager groups and the captures of the three graph
  keys fragment the reserved memory by timing: a program without the
  setting reserved 35.3 to 37.8 GiB from run to run on the same shapes, at
  the same 14.6 GiB allocated, so ``train_peak_gib`` read the timing and
  not the program.

``distill.Driver`` reads the step's configuration from
``program.distill_config`` and builds the reference's trainer from
``reference.distill.Trainer`` when it is called; this driver gives it its
own in their place for the length of that call, so that the rest of the
step and of the check is ``distill``'s, line for line.
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import replace
from typing import List

import torch

from ..lib import flops as FL
from ..lib import program
from ..reference import distill as RD
from ..reference import model as M
from ..reference import normalized as RN
from . import distill


@contextlib.contextmanager
def in_place_of(module, name: str, value):
    """``module.<name>`` is ``value`` inside the block."""
    kept = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, kept)


def expandable_segments(device) -> None:
    """On a CUDA device, the allocator grows its segments in place from
    here on, unless ``PYTORCH_CUDA_ALLOC_CONF`` names the setting."""
    if device.type != "cuda" or "expandable_segments" in os.environ.get(
            "PYTORCH_CUDA_ALLOC_CONF", ""):
        return
    setting = getattr(torch._C, "_accelerator_setAllocatorSettings", None)
    (setting or torch.cuda.memory._set_allocator_settings)("expandable_segments:True")


class Driver(distill.Driver):
    def __init__(self, config: dict, mix: dict, seeds, device):
        recipe = dict(config["recipe"])
        self.remat = bool(recipe.pop("remat"))
        super().__init__(dict(config, recipe=recipe), mix, seeds, device)

    def setup(self) -> None:
        expandable_segments(self.device)
        base = program.distill_config

        def with_remat(recipe, dtype):
            return replace(base(recipe, dtype), remat=self.remat)

        with in_place_of(program, "distill_config", with_remat):
            super().setup()

    def reference(self, prec=M.FP32, fault=None) -> dict:
        with in_place_of(RD, "Trainer", RN.Trainer):
            return super().reference(prec, fault)

    def attention_ops(self) -> List[FL.AttentionOp]:
        """``distill``'s, and with remat the student's attention forwards
        once more a step."""
        ops = super().attention_ops()
        if self.remat:
            s = self.config["student"]
            for r in self.done:
                B, T = self.feed.shapes[r]
                ops += FL.attention_ops(s, [FL.frames(s, T)] * B, False) * self.K
        return ops
