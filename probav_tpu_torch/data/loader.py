"""Host-side input pipeline: shuffled batching and device prefetch (port of
``probav_tpu/data/loader.py``).

``Batcher`` is the JAX package's numpy batcher unchanged, so one seed gives
the same batches in both packages: a full permutation per epoch, and
``drop_remainder`` for training so every step has the same shape.
``prefetch_to_device`` copies the next batches from pinned host memory with
``non_blocking=True`` on a producer thread while the current step runs.
"""

from __future__ import annotations

import itertools
import queue as queue_mod
import threading
from typing import Iterable, Iterator, Optional, Sequence

import numpy as np
import torch


class Batcher:
    """Iterate tuples of equally-indexed numpy arrays in shuffled batches.

    ``rows`` (with ``drop_remainder``) keeps those rows of each batch of
    ``batch_size`` and gathers no other: a data-parallel rank's share,
    drawn from the same permutation as every other rank's."""

    def __init__(self, arrays: Sequence[np.ndarray], batch_size: int,
                 shuffle: bool = True, seed: int = 17,
                 drop_remainder: bool = True, rows: slice = slice(None)):
        n = len(arrays[0])
        if any(len(a) != n for a in arrays):
            raise ValueError("array length mismatch")
        if rows != slice(None) and not drop_remainder:
            raise ValueError("rows of a batch need drop_remainder: the last "
                             "batch would be short")
        self.arrays = arrays
        self.rows = rows
        self.n = n
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_remainder = drop_remainder
        self.seed = seed
        self._rng = np.random.default_rng(seed)

    @property
    def steps_per_epoch(self) -> int:
        if self.drop_remainder:
            return self.n // self.batch_size
        return -(-self.n // self.batch_size)

    def epoch(self, skip: int = 0, rng=None) -> Iterator[tuple]:
        """One pass.  ``skip`` drops the first batches without building
        them (the permutation is still drawn, so a resumed run sees the
        remainder an uninterrupted run would).  An explicit ``rng`` draws
        the permutation from it instead of the batcher's own stream."""
        r = self._rng if rng is None else rng
        idx = r.permutation(self.n) if self.shuffle else np.arange(self.n)
        end = (self.n - self.n % self.batch_size
               if self.drop_remainder else self.n)
        for start in range(skip * self.batch_size, end, self.batch_size):
            take = idx[start:start + self.batch_size][self.rows]
            yield tuple(a[take] for a in self.arrays)

    def skip_epochs(self, epochs: int) -> None:
        """Advance the shuffle RNG past ``epochs`` whole epochs."""
        for _ in range(epochs):
            if self.shuffle:
                self._rng.permutation(self.n)

    def repeat(self, epochs: Optional[int] = None,
               skip: int = 0) -> Iterator[tuple]:
        """``skip`` batches are dropped from the first epoch only."""
        counter = range(epochs) if epochs is not None else itertools.count()
        for _ in counter:
            yield from self.epoch(skip=skip)
            skip = 0


PREFETCH = 2   # batches in flight ahead of the consumer


def prefetch_to_device(it: Iterable, device) -> Iterator:
    """Yield the tuples of numpy arrays of ``it`` as tensors on ``device``,
    up to PREFETCH batches ahead of the consumer.

    A producer thread builds each batch, pins it, and starts its copy with
    ``non_blocking=True`` on a side stream; the consumer's stream waits on
    that copy before the batch is used.  On the CPU the batches are the
    arrays' own memory.  An error in the producer is raised in the
    consumer.
    """
    device = torch.device(device)
    cuda = device.type == "cuda"
    q: "queue_mod.Queue" = queue_mod.Queue(maxsize=PREFETCH)
    end = object()
    stop = threading.Event()
    stream = torch.cuda.Stream(device) if cuda else None

    def put(batch):
        if not cuda:
            return tuple(torch.from_numpy(np.ascontiguousarray(a))
                         for a in batch), None
        with torch.cuda.stream(stream):
            out = tuple(torch.from_numpy(np.ascontiguousarray(a))
                        .pin_memory().to(device, non_blocking=True)
                        for a in batch)
            ev = torch.cuda.Event()
            ev.record(stream)
        return out, ev

    def offer(item) -> bool:
        """Queue ``item`` unless the consumer has gone; False if it has."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue_mod.Full:
                pass
        return False

    def producer():
        try:
            for batch in it:
                if not offer(put(batch)):
                    return
            offer(end)
        except BaseException as exc:   # re-raised in the consumer
            offer(exc)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is end:
                break
            if isinstance(item, BaseException):
                raise item
            batch, ev = item
            if ev is not None:
                torch.cuda.current_stream(device).wait_event(ev)
                for b in batch:   # the allocator must not reuse it early
                    b.record_stream(torch.cuda.current_stream(device))
            yield batch
    finally:
        stop.set()
        t.join()
