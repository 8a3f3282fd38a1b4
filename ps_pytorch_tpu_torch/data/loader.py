"""Host-side batch iteration (the port's subset of data/loader.py).

``BatchIterator`` keeps the JAX package's numpy ``RandomState`` shuffle,
so a port run sees the same per-worker index stream as the reference
for the same seed. Batches are gathered with plain numpy indexing (the
native threaded gather binding is not ported yet, ROADMAP.md); they go
to the card in one copy per step, inside the train step.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np


class BatchIterator:
    """Epoch-shuffled minibatch iterator over in-memory arrays. Yields
    ``{"image": uint8 [B,H,W,C], "label": int32 [B]}`` numpy dicts and
    drops the last partial batch."""

    def __init__(self, images: np.ndarray, labels: np.ndarray, batch_size: int,
                 shuffle: bool = True, seed: int = 0, drop_last: bool = True):
        if len(images) < batch_size:
            # replicate up to one batch so tiny (test) datasets still yield
            reps = -(-batch_size // len(images))
            images = np.concatenate([images] * reps)
            labels = np.concatenate([labels] * reps)
        self.images = np.ascontiguousarray(images)
        self.labels = np.ascontiguousarray(labels)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._rng = np.random.RandomState(seed)
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.images) // self.batch_size
        if not self.drop_last and len(self.images) % self.batch_size:
            n += 1
        return n

    @property
    def num_samples(self) -> int:
        return len(self.images)

    def epoch(self) -> Iterator[dict]:
        idx = np.arange(len(self.images))
        if self.shuffle:
            self._rng.shuffle(idx)
        self._epoch += 1
        for start in range(0, len(idx), self.batch_size):
            batch_idx = idx[start:start + self.batch_size]
            if len(batch_idx) < self.batch_size and self.drop_last:
                return
            yield {"image": self.images[batch_idx], "label": self.labels[batch_idx]}

    def __iter__(self):
        return self.epoch()

    def forever(self) -> Iterator[dict]:
        while True:
            yield from self.epoch()


def shard_for_worker(images: np.ndarray, labels: np.ndarray, worker_index: int,
                     num_workers: int, mode: str = "reshuffle", seed: int = 0):
    """Per-worker data assignment (loader.py:127). ``reshuffle``: the
    reference's parity, every worker sees the full set under its own
    shuffle seed; ``disjoint``: a contiguous 1/num_workers partition."""
    if mode == "reshuffle":
        return images, labels, seed + worker_index * 1009
    if mode == "disjoint":
        n = len(images) // num_workers
        lo = worker_index * n
        return images[lo:lo + n], labels[lo:lo + n], seed
    raise ValueError(f"unknown shard mode {mode!r}")
