"""Shared data-pipeline plumbing (port of `leaf_tpu/data/common.py`).

Datasets are plain Python iterables yielding numpy batches, wrapped in a
background-thread prefetcher so that host data preparation overlaps the
device's work; `put_batch` takes a batch to the device.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Callable, Iterable, Iterator

import numpy as np
import torch


def put_batch(array, device: torch.device, dtype=None) -> torch.Tensor:
    """A host batch on `device` (in `dtype`).  On a card the copy is made
    from pinned memory and not waited for: a copy from pageable memory
    holds the host until the stream has run everything enqueued before it,
    which would undo the overlap of the host's next step with the device's
    work."""
    host = torch.from_numpy(np.ascontiguousarray(array))
    if dtype is not None:
        host = host.to(dtype)
    if device.type != "cuda":
        return host
    return host.pin_memory().to(device, non_blocking=True)


@dataclasses.dataclass
class DataInfo:
    """A batch iterable with its sizes."""
    loader: Any
    num_batches: int = 0
    num_samples: int = 0

    def set_epoch(self, epoch: int):
        if hasattr(self.loader, "set_epoch"):
            self.loader.set_epoch(epoch)


class Prefetcher:
    """Iterate `source` on a background thread, keeping up to `depth`
    ready batches.  Exceptions propagate to the consumer."""

    def __init__(self, source: Iterable, depth: int = 2):
        self.source = source
        self.depth = depth

    def __iter__(self) -> Iterator:
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        end, err = object(), object()
        # set when the consumer abandons the iterator (the train loop stops
        # after N steps), so that the worker stops pulling from the source
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for item in self.source:
                    if not put((None, item)):
                        return
            except BaseException as e:  # noqa: BLE001 -- re-raised below
                put((err, e))
            finally:
                # the stop-aware put: dropping `end` while the queue is
                # momentarily full would hang the consumer
                put((end, None))

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                tag, item = q.get()
                if tag is end:
                    break
                if tag is err:
                    raise item
                yield item
        finally:
            stop.set()


def bucket_for(n: int, bounds) -> int:
    """Smallest bucket boundary that fits length `n` (overflow: the
    largest).  `bounds` must be sorted ascending."""
    for b in bounds:
        if n <= b:
            return b
    return bounds[-1]


def bucket_batches(it: Iterator, batch_size: int,
                   length_of: Callable[[Any], int],
                   boundaries: Iterable[int]) -> Iterator[list]:
    """Group a (pre-shuffled) sample stream into length-homogeneous
    batches: each sample goes to the smallest `boundaries` bucket that
    fits `length_of(sample)` (overflow: the largest), and a batch is
    emitted the moment any bucket fills.  At the end of the stream the
    leftovers are flushed longest bucket first in mixed batches, the last
    one partial."""
    bounds = sorted(boundaries)
    buckets: dict = {b: [] for b in bounds}
    for sample in it:
        buf = buckets[bucket_for(length_of(sample), bounds)]
        buf.append(sample)
        if len(buf) == batch_size:
            yield list(buf)
            buf.clear()
    leftovers = [s for b in reversed(bounds) for s in buckets[b]]
    for i in range(0, len(leftovers), batch_size):
        yield leftovers[i:i + batch_size]


def shuffle_buffer(it: Iterator, bufsize: int, initial: int, rng) -> Iterator:
    """Streaming reservoir shuffle (webdataset's `_shuffle`): fill a
    buffer of `bufsize`, then yield a random element per incoming sample;
    drain shuffled at the end.  `rng` is a `random.Random`.  `initial` is
    the reference's start-up fill level and changes nothing here."""
    del initial
    buf = []
    for sample in it:
        if len(buf) >= bufsize:
            idx = rng.randrange(len(buf))
            out, buf[idx] = buf[idx], sample
            yield out
        else:
            buf.append(sample)
    rng.shuffle(buf)
    yield from buf
