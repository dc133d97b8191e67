"""Dataset + prefetching loader (the TPU package's ``data/loader.py``).

``AudioDataset`` mirrors the reference's manifest-driven dataset
(``audio_dataset.py:220-280``): decode a waveform, check the manifest
length.  ``DistillDataLoader`` is the feed: a background thread pool decodes
and random-crops the next batches to their rung's length while the card
computes, and hands them over as numpy arrays; the trainer copies each to
the card one step ahead (``train/trainer.py``).  In a data-parallel run
every process sees the same global batches (the batcher is seeded by
(seed, epoch)) and ``shard=(p, n)`` decodes only rows ``[p*B/n,
(p+1)*B/n)`` of each, as the TPU package's loader does.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Tuple

import numpy as np

from .audio import load_audio
from .manifest import read_manifest
from .sampler import StaticShapeBatcher


class AudioDataset:
    def __init__(self, tsv_dir, subset: str) -> None:
        self.f_list, self.ind_list, self.len_list = read_manifest(tsv_dir, subset)

    def __len__(self) -> int:
        return len(self.f_list)

    def load(self, index: int) -> np.ndarray:
        wave, _sr = load_audio(self.f_list[index])
        if wave.shape[1] != self.len_list[index]:
            raise ValueError(
                f"manifest length {self.len_list[index]} != decoded "
                f"{wave.shape[1]} for {self.f_list[index]}"
            )
        return wave[0]  # mono channel 0, like torchaudio.load()[0][0]


def crop_to(wave: np.ndarray, num_frames: int, rng: np.random.Generator,
            rand_crop: bool = True) -> np.ndarray:
    """Random-offset crop (reference ``_crop_audio``,
    audio_dataset.py:283-312)."""
    if wave.shape[0] > num_frames:
        offset = int(rng.integers(wave.shape[0] - num_frames)) if rand_crop else 0
        return wave[offset : offset + num_frames]
    return wave


class DistillDataLoader:
    """Epoch iterator producing (waveforms (B, T), lengths or None).

    All samples in a batch are cropped to the batch's rung length, so
    lengths are uniform and training batches carry ``lengths=None``: the
    same semantics as the reference's crop-to-min collate
    (``lightning.py:321``), with a closed set of shapes.
    """

    def __init__(
        self,
        dataset: AudioDataset,
        batcher: StaticShapeBatcher,
        *,
        num_workers: int = 8,
        prefetch: int = 4,
        rand_crop: bool = True,
        seed: int = 0,
        shard: Optional[Tuple[int, int]] = None,  # (data rank, data ranks)
        feed_dtype: str = "float32",
    ) -> None:
        self.dataset = dataset
        self.batcher = batcher
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.rand_crop = rand_crop
        self.seed = seed
        # data parallel: decode only this rank's rows; the batch order is
        # deterministic, so every rank agrees on the global batch
        self.shard = shard
        # "int16": feed PCM-scale integers and let the train step divide by
        # 32768 on the card: bit-identical to the float32 feed for
        # int16-sourced audio (WAV/FLAC), at half the host-to-card bytes
        if feed_dtype not in ("float32", "int16"):
            raise ValueError(feed_dtype)
        self.feed_dtype = feed_dtype

    def _make_batch(self, rung: int, idx: np.ndarray, rng: np.random.Generator):
        if self.shard is not None:
            p, n = self.shard
            local = len(idx) // n
            idx = idx[p * local : (p + 1) * local]
        int16 = self.feed_dtype == "int16"
        out = np.empty((len(idx), rung), dtype=np.int16 if int16 else np.float32)
        for row, i in enumerate(idx):
            w = crop_to(self.dataset.load(int(i)), rung, rng, self.rand_crop)
            # float came from PCM/32768, so *32768 recovers the exact
            # integers (clip guards non-PCM synthetic sources)
            out[row] = (
                np.clip(w * 32768.0, -32768, 32767).astype(np.int16)
                if int16 else w
            )
        return out

    def epoch(self, epoch: int, skip: int = 0
              ) -> Iterator[Tuple[np.ndarray, Optional[np.ndarray]]]:
        """Iterate one epoch's batches; ``skip`` drops the first k batches
        without decoding them (checkpoint resume mid-epoch) while keeping
        the remaining batches' crop randomness identical to an
        uninterrupted epoch: each batch's rng seed is derived from its
        position, not from how many batches were actually produced."""
        batches = self.batcher.epoch_batches(epoch)
        rng = np.random.default_rng(self.seed + 7919 * epoch)
        # per-batch independent rng keeps decode order (and resume skips)
        # irrelevant to the crop stream
        seeds = [int(rng.integers(2**63)) for _ in batches]
        batches, seeds = batches[skip:], seeds[skip:]
        if self.num_workers <= 0:
            for (rung, idx), seed in zip(batches, seeds):
                yield self._make_batch(rung, idx, np.random.default_rng(seed)), None
            return

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            # a consumer that stops early (a deadline or a SIGTERM) sets
            # ``stop``; the producer then ends instead of blocking forever
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                    futures = []
                    for (rung, idx), seed in zip(batches, seeds):
                        if stop.is_set():
                            break
                        brng = np.random.default_rng(seed)
                        futures.append(pool.submit(self._make_batch, rung, idx, brng))
                        while len(futures) >= self.prefetch:
                            put(futures.pop(0).result())
                    for f in futures:
                        if stop.is_set():
                            f.cancel()
                        else:
                            put(f.result())
                put(None)
            except Exception as err:  # a decode error reaches the consumer
                put(err)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item, None
        finally:
            stop.set()
            t.join(timeout=60)

    def __len__(self) -> int:
        return len(self.batcher.epoch_batches(0))
