"""Shuffled batch indices: the port's own copy of
videometamaterials_tpu/data/loader.py:InfiniteBatchSampler (numpy only),
with that sampler's defaults fixed: one process, shuffled, whole batches.

It gives the same index stream as the JAX package's sampler for the same
seed, example count and batch size.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np


class InfiniteBatchSampler:
    """Shuffled epochs of indices, cut into whole batches (an epoch's
    remainder is dropped)."""

    def __init__(self, num_examples: int, batch_size: int, seed: int = 0):
        if num_examples <= 0:
            raise ValueError("the sampler needs at least one example")
        self.n = num_examples
        self.batch_size = batch_size
        self.seed = seed

    def __iter__(self) -> Iterator[np.ndarray]:
        bs, e = self.batch_size, 0
        while True:
            order = np.random.default_rng((self.seed, e)).permutation(self.n)
            e += 1
            if self.n < bs:
                # fewer examples than a batch: sample with replacement so
                # tiny datasets still train
                rng = np.random.default_rng((self.seed, e, 17))
                yield rng.integers(0, self.n, size=bs)
                continue
            for i in range(0, self.n - bs + 1, bs):
                yield order[i:i + bs]
