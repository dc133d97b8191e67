"""Batch samplers (a copy of the TPU package's ``data/sampler.py``; same
behaviour, batch for batch, for the same seed and epoch).

Two strategies:

* :class:`BucketizeBatchSampler` + :class:`DistributedBatchSampler` —
  behavioral mirrors of the reference samplers
  (``dataset/audio_dataset.py:19-217``): length-sorted linspace buckets,
  greedy token-count packing, seeded epoch permutation, pad-to-world-size,
  rank-strided slicing.  Batches have *dynamic* shapes (crop-to-min).

* :class:`StaticShapeBatcher` — the pipeline's batcher: a fixed ladder of
  sequence lengths; every sample is cropped down to its bucket's length and
  batches have exactly ``floor(max_token_count / T_bucket)`` samples, so the
  whole epoch uses a small closed set of (B, T) shapes (the TPU package
  compiled one XLA program each), zero padding (preserving the reference's
  unpadded rectangular-batch semantics), and near-constant audio-seconds
  per batch.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np


class BucketizeBatchSampler:
    """Reference-compatible bucketized packing (audio_dataset.py:19-142)."""

    def __init__(
        self,
        lengths: Sequence[int],
        num_buckets: int,
        min_len: int = 0,
        max_len: Optional[int] = None,
        max_token_count: Optional[int] = None,
        batch_size: Optional[int] = None,
        shuffle: bool = True,
        drop_last: bool = False,
        seed: int = 0,
    ) -> None:
        if max_len is None:
            max_len = int(max(lengths))
        if not 0 <= min_len <= max_len:
            raise ValueError("min_len must be in [0, max_len]")
        if (max_token_count is None) == (batch_size is None):
            raise ValueError("exactly one of max_token_count/batch_size required")
        if max_token_count is not None and max_len > max_token_count:
            raise ValueError("max_token_count must cover max_len")

        keep = [
            (l, i) for i, l in enumerate(lengths) if min_len <= l <= max_len
        ]
        if not keep:
            raise ValueError("no samples left after length filtering")
        keep.sort(key=lambda x: x[0])
        self.lengths = [e[0] for e in keep]
        self.indices = [e[1] for e in keep]
        self.max_token_count = max_token_count
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._seed = seed
        self._rng = np.random.default_rng(seed)

        boundaries = np.linspace(min_len - 1, max_len + 1, num_buckets + 1)
        bucket_ids = np.searchsorted(boundaries, self.lengths, side="left")
        buckets = {}
        for pos, b in enumerate(bucket_ids):
            buckets.setdefault(int(b), []).append(pos)
        self.buckets = {k: np.asarray(v) for k, v in sorted(buckets.items())}
        self._update_iter_list()

    def _update_iter_list(self) -> None:
        if self.shuffle:
            for k in self.buckets:
                self._rng.shuffle(self.buckets[k])
        self.iter_list: List[List[int]] = []
        total_len = 0
        batch: List[int] = []
        cap = self.max_token_count if self.max_token_count else self.batch_size
        for k in self.buckets:
            for pos in self.buckets[k]:
                pos = int(pos)
                sample_len = self.lengths[pos] if self.max_token_count else 1
                if total_len + sample_len <= cap:
                    batch.append(self.indices[pos])
                    total_len += sample_len
                else:
                    self.iter_list.append(batch)
                    batch = [self.indices[pos]]
                    total_len = sample_len
        if batch and (self.max_token_count or not self.drop_last):
            self.iter_list.append(batch)

    def set_epoch(self, epoch: int) -> None:
        """Reshuffle within buckets and repack for a new epoch.

        The reference gets per-epoch reshuffling by rebuilding its
        dataloader every epoch (``distill.py:47`` reload_dataloaders_every_
        n_epochs + sampler construction in ``lightning.py:306-317``); this
        hook provides the same behavior without reconstructing the sampler.
        Deterministic given (seed, epoch).
        """
        self._rng = np.random.default_rng(self._seed + epoch)
        self._update_iter_list()

    def __iter__(self) -> Iterator[List[int]]:
        return iter(self.iter_list)

    def __len__(self) -> int:
        return len(self.iter_list)


class DistributedBatchSampler:
    """Deterministic (seed+epoch) permutation, pad to world size, strided
    rank slice (audio_dataset.py:196-211)."""

    def __init__(
        self,
        batch_sampler: BucketizeBatchSampler,
        num_replicas: int,
        rank: int,
        shuffle: bool = True,
        seed: int = 0,
        epoch: int = 0,
        drop_last: bool = False,
    ) -> None:
        if not 0 <= rank < num_replicas:
            raise ValueError(f"rank {rank} not in [0, {num_replicas})")
        indices = list(batch_sampler.iter_list)
        if shuffle:
            rng = np.random.default_rng(seed + epoch)
            perm = rng.permutation(len(indices))
            indices = [indices[i] for i in perm]
        if drop_last:
            total = len(indices) - len(indices) % num_replicas
            indices = indices[:total]
        else:
            pad = num_replicas - len(indices) % num_replicas
            if pad != num_replicas:
                indices = indices + indices[:pad]
        self.total_size = len(indices)
        self.num_samples = self.total_size // num_replicas
        self.subset = indices[rank : self.total_size : num_replicas]

    def __iter__(self):
        return iter(self.subset)

    def __len__(self):
        return self.num_samples


class StaticShapeBatcher:
    """TPU-native static-shape batching.

    Bucket ladder: geometric steps from ``min_len`` to ``max_len`` (default
    ratio chosen to give ~``num_shapes`` rungs).  A sample of length L lands
    on the largest rung <= L and is random-cropped to exactly that length.
    Batch size per rung = floor(max_token_count / rung), so every batch
    carries ~max_token_count samples of audio regardless of shape.

    ``run_length=K`` emits the epoch as same-rung *runs* of K consecutive
    batches (runs shuffled, K=1 recovers the plain batch shuffle): the
    trainer can then stack K consecutive batches into one multi-step
    dispatch (``steps_per_dispatch``) without ever mixing shapes.  Batch
    contents are identical either way — only epoch order changes, and it
    is equally deterministic given (seed, epoch).
    """

    def __init__(
        self,
        lengths: Sequence[int],
        *,
        max_token_count: int,
        min_len: int = 32000,
        max_len: int = 250000,
        num_shapes: int = 12,
        seed: int = 0,
        num_replicas: int = 1,
        drop_last: bool = True,
        run_length: int = 1,
    ) -> None:
        if max_len > max_token_count:
            raise ValueError("max_token_count must cover max_len")
        self.lengths = np.asarray(lengths)
        self.min_len = min_len
        self.max_len = max_len
        self.max_token_count = int(max_token_count)
        self.seed = seed
        self.num_replicas = num_replicas
        self.drop_last = drop_last
        self.run_length = max(int(run_length), 1)

        ratio = (max_len / min_len) ** (1.0 / (num_shapes - 1))
        rungs = [min_len]
        while rungs[-1] < max_len and len(rungs) < num_shapes:
            rungs.append(min(int(round(rungs[-1] * ratio)), max_len))
        # round rungs to multiples of 320 (one output frame of the CNN) so
        # frame counts are stable per rung
        self.rungs = sorted({(r // 320) * 320 for r in rungs})
        self.batch_sizes = {r: self.max_token_count // r for r in self.rungs}

        keep = (self.lengths >= min_len) & (self.lengths <= max_len)
        self.keep_idx = np.nonzero(keep)[0]
        if len(self.keep_idx) == 0:
            raise ValueError("no samples left after length filtering")
        kept_lengths = self.lengths[self.keep_idx]
        rung_arr = np.asarray(self.rungs)
        # largest rung <= length
        self.sample_rung = rung_arr[
            np.clip(np.searchsorted(rung_arr, kept_lengths, side="right") - 1, 0, None)
        ]

    @property
    def shapes(self) -> List[Tuple[int, int]]:
        """The closed set of (batch, time) shapes an epoch can produce."""
        return [(self.batch_sizes[r] * self.num_replicas, r) for r in self.rungs]

    def epoch_batches(self, epoch: int) -> List[Tuple[int, np.ndarray]]:
        """List of (rung_length, global_sample_indices) for one epoch.

        Each entry's index array has ``batch_size(rung) * num_replicas``
        entries — the *global* batch; per-host decoding of only the rows a
        process owns happens in ``DistillDataLoader(shard=...)``.
        Deterministic given (seed, epoch) on every rank — the reference
        achieves cross-rank consistency the same way (seed+epoch generator,
        audio_dataset.py:196-199).
        """
        rng = np.random.default_rng(self.seed + epoch)
        order = rng.permutation(len(self.keep_idx))
        batches = []
        for rung in self.rungs:
            mask = self.sample_rung[order] == rung
            members = self.keep_idx[order[mask]]
            gbs = self.batch_sizes[rung] * self.num_replicas
            n_full = len(members) // gbs
            for b in range(n_full):
                batches.append((rung, members[b * gbs : (b + 1) * gbs]))
            if not self.drop_last and len(members) % gbs:
                tail = members[n_full * gbs :]
                reps = int(np.ceil(gbs / len(tail)))
                batches.append((rung, np.tile(tail, reps)[:gbs]))
        if self.run_length > 1:
            # same-rung runs of K (batches are rung-contiguous here), runs
            # shuffled: consecutive batches share a shape so the trainer
            # can stack them into one dispatch
            runs = []
            start = 0
            while start < len(batches):
                rung = batches[start][0]
                end = start
                while end < len(batches) and batches[end][0] == rung:
                    end += 1
                for j in range(start, end, self.run_length):
                    runs.append(batches[j:min(j + self.run_length, end)])
                start = end
            order = rng.permutation(len(runs))
            return [b for k in order for b in runs[k]]
        perm = rng.permutation(len(batches))
        return [batches[i] for i in perm]
