"""Shuffled batch indices and a prefetching batch stream: the port's
copies of videometamaterials_tpu/data/loader.py:InfiniteBatchSampler
(numpy only, with that sampler's defaults fixed: shuffled, whole batches)
and prefetch_batches (:72-93).

The sampler gives the same index stream as the JAX package's for the same
seed, example count, batch size, process index and process count.
"""

from __future__ import annotations

import itertools
import queue
import threading
from typing import Iterator

import numpy as np
import torch


class InfiniteBatchSampler:
    """Shuffled epochs of indices, cut into whole batches (an epoch's
    remainder is dropped). With process_count > 1 each process takes a
    disjoint contiguous stripe of every epoch's order (the last process
    also the remainder), or the whole order where there are fewer examples
    than processes; a stripe shorter than a batch falls back to a batch
    drawn with replacement, the same on every process."""

    def __init__(self, num_examples: int, batch_size: int, seed: int = 0,
                 process_index: int = 0, process_count: int = 1):
        if num_examples <= 0:
            raise ValueError("the sampler needs at least one example")
        if not 0 <= process_index < process_count:
            raise ValueError(f"process {process_index} of {process_count}")
        self.n = num_examples
        self.batch_size = batch_size
        self.seed = seed
        self.process_index = process_index
        self.process_count = process_count

    def _stripe(self, order: np.ndarray) -> np.ndarray:
        per = self.n // self.process_count
        if per == 0:
            return order
        start = self.process_index * per
        last = self.process_index == self.process_count - 1
        return order[start:] if last else order[start:start + per]

    def __iter__(self) -> Iterator[np.ndarray]:
        bs, e = self.batch_size, 0
        while True:
            order = np.random.default_rng((self.seed, e)).permutation(self.n)
            stripe = self._stripe(order)
            e += 1
            if len(stripe) < bs:
                # fewer examples than a batch: sample with replacement so
                # tiny datasets still train
                rng = np.random.default_rng((self.seed, e, 17))
                yield rng.integers(0, self.n, size=bs)
                continue
            for i in range(0, len(stripe) - bs + 1, bs):
                yield stripe[i:i + bs]


def prefetch_batches(dataset, sampler: InfiniteBatchSampler, *,
                     start: int = 0, pin: bool = False,
                     queue_size: int = 2) -> Iterator[tuple[torch.Tensor,
                                                            torch.Tensor]]:
    """(videos, labels) CPU tensors of dataset.get_batch over the
    sampler's batches from batch `start` on, made by a producer thread
    while the caller trains on the previous batch; in pinned memory with
    `pin`, so that a non-blocking copy to the card overlaps. Closing the
    generator stops the thread; an error in the producer is raised here."""
    q: queue.Queue = queue.Queue(maxsize=queue_size)
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for idx in itertools.islice(iter(sampler), start, None):
                videos, labels = dataset.get_batch(idx)
                batch = (torch.from_numpy(videos), torch.from_numpy(labels))
                if pin:
                    batch = tuple(t.pin_memory() for t in batch)
                if not put(batch):
                    return
        except BaseException as e:      # handed to the consumer, raised there
            put(e)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        thread.join(timeout=10)
