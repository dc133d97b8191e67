"""Batched feature extraction for compressed checkpoints.

The serving surface is "load the checkpoint, call ``extract_features``".
The Predictor sorts the clips by length, cuts them into batches of at most
``max_batch``, pads each batch to a multiple of ``length_step`` samples
(the same buckets as the TPU package's Predictor, which matters: the
GroupNorm of the first conv layer takes its statistics over all samples,
padding included), runs the model with the true lengths and returns each
clip's valid frames.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .models.model import Wav2Vec2Model, resolve_device
from .utils.profiling import span


def _ceil_to(x: int, m: int) -> int:
    return max(m, (x + m - 1) // m * m)


def pad_batch(waves: Sequence[np.ndarray], length_step: int) -> Tuple[np.ndarray, np.ndarray]:
    """Zero-pad clips to one (B, T) float32 batch, T a multiple of
    ``length_step``, with int32 lengths."""
    chunk = [np.asarray(w, np.float32) for w in waves]
    T = _ceil_to(max(len(w) for w in chunk), length_step)
    batch = np.zeros((len(chunk), T), np.float32)
    lengths = np.zeros((len(chunk),), np.int32)
    for r, w in enumerate(chunk):
        batch[r, : len(w)] = w
        lengths[r] = len(w)
    return batch, lengths


class Predictor:
    """Length-bucketed feature extractor.

    >>> model = load_model("dphubert.pth")
    >>> p = Predictor(model, dtype=torch.bfloat16)
    >>> feats = p.extract([wave1, wave2])     # list of (frames_i, E) float32
    """

    def __init__(
        self,
        model: Wav2Vec2Model,
        *,
        length_step: int = 32000,  # 2 s buckets
        max_batch: int = 8,
        dtype: torch.dtype = torch.float32,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.length_step = length_step
        self.max_batch = max_batch
        self.dtype = dtype

    def extract(self, waves: Sequence[np.ndarray]) -> List[np.ndarray]:
        """Final-layer features of each clip, valid frames only, as float32.

        Under a profiler each batch's phases are ranges of the trace
        (``utils.profiling.span``), inside ``predictor.extract``:
        ``predictor.pad``, ``.h2d``, ``.forward`` (the enqueue), ``.readback``
        (the copies to the host, which wait for the card) and ``.unpad``."""
        with span("predictor.extract"):
            results: List[Optional[np.ndarray]] = [None] * len(waves)
            order = sorted(range(len(waves)), key=lambda i: len(waves[i]))
            for start in range(0, len(order), self.max_batch):
                with span("predictor.pad"):
                    idx = order[start : start + self.max_batch]
                    batch, lengths = pad_batch([waves[i] for i in idx], self.length_step)
                with torch.inference_mode():
                    with span("predictor.h2d"):
                        wave = torch.from_numpy(batch).to(self.device).to(self.dtype)
                        lens = torch.from_numpy(lengths).to(self.device)
                    with span("predictor.forward"):
                        outs, out_lens = self.model.extract_features(wave, lens)
                    with span("predictor.readback"):
                        out = outs[-1].float().cpu().numpy()
                        out_lens = out_lens.cpu().numpy()
                with span("predictor.unpad"):
                    for r, i in enumerate(idx):
                        results[i] = out[r, : out_lens[r]]
        return results  # type: ignore[return-value]
