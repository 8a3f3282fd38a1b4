"""Host-side batch iteration with device prefetch (the port of
data/loader.py).

``BatchIterator`` keeps the JAX package's numpy ``RandomState`` shuffle,
so a port run sees the same per-worker index stream as the reference
for the same seed. Batches are gathered by the native threaded gather
(``gather_rows``: ``native/loader.cc`` through ``data/_native.py``).
``prefetch_to_device`` keeps ``size`` batches in flight to the card:
each is staged in pinned host memory and copied on a copy stream
without blocking, so the train step receives device tensors and makes
no host copy of its own.
"""

from __future__ import annotations

import collections
import ctypes
from typing import Iterator

import numpy as np
import torch

from .. import DeviceLike, resolve_device
from . import _native


def gather_rows(array: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """``array[indices]`` through the native threaded gather (loader.py:28):
    out-of-range indices, negative ones included (no numpy wrap), raise
    ``IndexError``. Plain numpy indexing only where JAX takes it too: an
    empty array or one that is not C-contiguous. A failed build raises
    ``_native.NativeBuildError``."""
    idx = np.ascontiguousarray(indices, np.int64)
    if idx.size and (idx.min() < 0 or idx.max() >= len(array)):
        raise IndexError("gather index out of range")
    if array.nbytes == 0 or not array.flags.c_contiguous:
        return array[idx]
    lib = _native.load()
    item_bytes = array.dtype.itemsize * int(np.prod(array.shape[1:], dtype=np.int64))
    out = np.empty((len(idx),) + array.shape[1:], array.dtype)
    ok = lib.psl_gather(array.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), array.shape[0],
                        item_bytes, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                        len(idx), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), 0)
    if not ok:
        raise IndexError("gather index out of range")
    return out


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
        # contiguous once: the native gather needs C layout
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
            yield {"image": gather_rows(self.images, batch_idx),
                   "label": gather_rows(self.labels, batch_idx)}

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


class _Staging:
    """One pinned host buffer per key of a batch, and the event of the
    last copy out of them."""

    def __init__(self):
        self.host: dict = {}
        self.event = None

    def fill(self, batch: dict) -> dict:
        """Copy ``batch`` into the pinned buffers, once the previous copy
        out of them has landed (refilling earlier would change a batch in
        flight)."""
        if self.event is not None:
            # waits only for the last copy out of these buffers (a batch
            # already handed to the card), never for a step
            self.event.synchronize()  # psl: sync-ok
        out = {}
        for k, v in batch.items():
            src = torch.as_tensor(np.ascontiguousarray(v))
            buf = self.host.get(k)
            if buf is None or buf.shape != src.shape or buf.dtype != src.dtype:
                buf = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
                self.host[k] = buf
            buf.copy_(src)
            out[k] = buf
        return out


def prefetch_to_device(iterator: Iterator[dict], size: int = 2, device: DeviceLike = None,
                       tracer=None) -> Iterator[dict]:
    """Keep ``size`` batches in flight to ``device`` (loader.py:150): the
    reference's pin-memory thread and worker prefetch. Yields the batches
    in order, each a dict of tensors on ``device``.

    On a card each batch is staged in pinned host memory (``size + 1``
    staging buffers in turn, each refilled only after its last copy's
    event completed) and copied with ``non_blocking=True`` on a copy
    stream; at hand-over the consumer's stream waits for that copy's
    event and each tensor is tied to the consumer's stream
    (``record_stream``), so the caching allocator reuses its memory only
    after the consumer's work on it. On the CPU it yields the same
    tensors, unpinned. ``tracer`` wraps each dispatch in one ``h2d`` span:
    the host's staging and the copy's dispatch, not its completion."""
    if tracer is None:
        from ..obs import NULL_TRACER as tracer  # noqa: N811 - constant
    dev = resolve_device(device)
    queue = collections.deque()
    if dev.type == "cuda":
        copy_stream = torch.cuda.Stream(device=dev)
        slots = [_Staging() for _ in range(size + 1)]
    dispatched = 0

    def dispatch(batch: dict):
        if dev.type != "cuda":
            return {k: torch.as_tensor(np.ascontiguousarray(v)) for k, v in batch.items()}, None
        slot = slots[dispatched % len(slots)]
        pinned = slot.fill(batch)
        with torch.cuda.stream(copy_stream):
            out = {k: v.to(dev, non_blocking=True) for k, v in pinned.items()}
            slot.event = torch.cuda.Event()
            slot.event.record(copy_stream)
        return out, slot.event

    def enqueue(n: int) -> None:
        nonlocal dispatched
        for _ in range(n):
            batch = next(iterator, None)
            if batch is None:
                return
            with tracer.span("h2d"):
                queue.append(dispatch(batch))
            dispatched += 1

    enqueue(size)
    while queue:
        out, event = queue.popleft()
        if event is not None:
            consumer = torch.cuda.current_stream(dev)
            consumer.wait_event(event)
            for t in out.values():
                t.record_stream(consumer)
        yield out
        enqueue(1)
