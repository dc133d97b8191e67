"""Plain reference of a model that normalises its waveform, and of the
stage-1 step over a batch taken in slices: wav2vec 2.0 Large LV-60k
(fairseq's ``wav2vec_vox_new``; Baevski et al. 2020): a LayerNorm after
every extractor conv, conv bias, a pre-LN encoder, and each clip's
waveform normalised before the extractor.

``model.py`` computes the LayerNorm extractor and the pre-LN encoder; this
file adds the waveform's normalisation in front of it: each clip to zero
mean and unit variance over its valid samples, with no affine, 1e-5 added
to the variance, and padded samples set to 0.  Departures from the
published description: fairseq's loader normalises a whole clip
(``F.layer_norm`` over the clip, eps 1e-5) and pads afterwards, and the
released models' feature extractor (Hugging Face's
``zero_mean_unit_var_norm``) normalises each clip of a padded batch over
its own samples with eps 1e-7; this file takes the second's rule with the
first's epsilon, as the recipe's step does.

The step (``Trainer``): at Large's widths the float32 step over one check
batch (11 clips of 15.62 s) reached 67.4 GiB allocated on an 80 GB H100,
and the float8 control keeps a rounded copy of every product's operands
besides; so a batch is taken in slices of at most ``slice_seconds`` of
audio (60 s: 24.0 GiB) and their gradients summed.  A slice's loss is
weighted by its share of the batch's clips.  The distill loss is a mean
over the batch's clips, which share one length (the
benchmark's batches are unpadded), and the Lagrangian term, which does not
depend on the batch, is weighted by shares that sum to 1; so the weighted
sum of the slices' losses is the batch's loss, and the sum of their
gradients its gradient, exactly up to the order of summation.  Every
random number is the one-batch step's: each slice starts from the step's
generator state and draws each batch-shaped tensor (dropout's, two or more
dimensions) at the whole batch's shape, taking its own rows, and the
gates' draws (one dimension) whole; the attention dropout's seed is moved
by the slice's first row, which the counter hash adds times a constant
(``dropout.py``).  So the generator ends each slice, and the step, where
the one-batch step leaves it.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from . import distill as RD
from . import model as M
from .dropout import _SEED_B, _U32

SR = 16000


def normalize(wave: torch.Tensor, lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, T): each clip to zero mean and unit variance over its first
    ``lengths`` samples (all of them without), padded samples 0."""
    B, T = wave.shape
    if lengths is None:
        lengths = torch.full((B,), T, device=wave.device)
    valid = torch.arange(T, device=wave.device)[None, :] < lengths[:, None]
    n = lengths.to(wave.dtype)[:, None]
    mean = torch.where(valid, wave, 0.0).sum(dim=1, keepdim=True) / n
    var = torch.where(valid, (wave - mean).square(), 0.0).sum(dim=1, keepdim=True) / n
    return torch.where(valid, (wave - mean) * torch.rsqrt(var + M.LN_EPS), 0.0)


def plain(config: dict) -> dict:
    """The configuration as ``model.py`` reads it: the normalisation is
    done here."""
    return dict(config, normalize_waveform=False)


def extract_features(P: Dict[str, torch.Tensor], config: dict, wave: torch.Tensor,
                     lengths: Optional[torch.Tensor] = None, **kw):
    """``model.extract_features`` of the normalised waveform, where the
    configuration asks for it."""
    if config.get("normalize_waveform", False):
        wave = normalize(wave, lengths)
    return M.extract_features(P, plain(config), wave, lengths, **kw)


class Rows(M.Draws):
    """The whole batch's draws, the rows ``[lo, lo + n)`` of them."""

    def __init__(self, generator: torch.Generator, lo: int, n: int, batch: int):
        super().__init__(generator)
        self.lo, self.n, self.batch = lo, n, batch

    def uniform(self, shape, dtype=torch.float32) -> torch.Tensor:
        shape = tuple(shape)
        if len(shape) < 2:
            return super().uniform(shape, dtype)
        if shape[0] != self.n:
            raise ValueError(f"a draw of {shape} in a slice of {self.n} rows")
        whole = super().uniform((self.batch,) + shape[1:], dtype)
        return whole[self.lo:self.lo + self.n]

    def seed32(self) -> int:
        return (super().seed32() + self.lo * _SEED_B) & _U32


class Trainer(RD.Trainer):
    """``distill.Trainer`` with the waveform normalised per clip where the
    configurations ask for it (the teacher's and the student's alike), a
    batch taken in slices of at most ``slice_seconds`` of audio, and
    batches with ``lengths``."""

    def __init__(self, teacher_cfg: dict, teacher: Dict[str, torch.Tensor], student_cfg: dict,
                 student: Dict[str, torch.Tensor], recipe: RD.Recipe, prec=M.FP32,
                 slice_seconds: float = 60.0):
        flags = {bool(c.get("normalize_waveform", False)) for c in (teacher_cfg, student_cfg)}
        if len(flags) != 1:
            raise ValueError("the teacher and the student normalise the waveform alike")
        self.normalize = flags.pop()
        self.slice_seconds = slice_seconds
        super().__init__(plain(teacher_cfg), teacher, plain(student_cfg), student, recipe, prec)

    def loss_and_grads(self, wave: torch.Tensor, draws: M.Draws, grads: bool = True,
                       lengths: Optional[torch.Tensor] = None):
        """(loss, {name: gradient}) of one step on a float batch (B, T), the
        slices' sums; with ``grads`` false, (loss, None)."""
        B, T = wave.shape
        n = max(1, min(B, math.floor(self.slice_seconds * SR / T)))
        start = draws.g.get_state()
        P = self.params
        names = list(P)
        loss, total = 0.0, None
        for lo in range(0, B, n):
            rows = slice(lo, min(lo + n, B))
            draws.g.set_state(start)
            d = draws if n == B else Rows(draws.g, lo, rows.stop - lo, B)
            part = None if lengths is None else lengths[rows]
            with torch.set_grad_enabled(grads):
                part_loss = (rows.stop - lo) / B * self._loss(wave[rows], d, part)
            loss = loss + part_loss.detach()
            if not grads:
                continue
            got = torch.autograd.grad(part_loss, [P[k] for k in names], allow_unused=True)
            got = [torch.zeros_like(P[k]) if g is None else g for k, g in zip(names, got)]
            total = got if total is None else [a + b for a, b in zip(total, got)]
            del part_loss, got
        return loss, (None if total is None else dict(zip(names, total)))

    def _loss(self, wave: torch.Tensor, draws: M.Draws,
              lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        recipe, P = self.recipe, self.params
        student = {k[len("student."):]: v for k, v in P.items() if k.startswith("student.")}
        gates = RD.sample_gates(self.scfg, student, draws)
        if self.normalize:
            wave = normalize(wave, lengths)
        with torch.no_grad():
            teacher_h, _ = M.extract_features(self.teacher, self.tcfg, wave, lengths,
                                              prec=self.prec)
        student_h, _ = M.extract_features(student, self.scfg, wave, lengths, gates=gates,
                                          draws=draws, prec=self.prec)
        projs = {k[len("projs."):]: v for k, v in P.items() if k.startswith("projs.")}
        loss = RD.distill_loss(projs, student_h, teacher_h, recipe, self.prec)
        s = 1.0 - RD.expected_size(self.scfg, student) / self.original
        t = RD.target_sparsity(recipe, self.count)
        return loss + P["lambdas.lambda1"] * (s - t) + P["lambdas.lambda2"] * (s - t) ** 2
