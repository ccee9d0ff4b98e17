"""T5-style bucketed relative position bias tables (temporal attention).

Port of videometamaterials_tpu/ops/relative_bias.py: relative position
r = k_pos - q_pos, half of the buckets encode the sign, half the magnitude
with exact small distances and log-spaced large ones capped at max_distance.
"""

from __future__ import annotations

import math

import numpy as np


def relative_position_bucket(relative_position: np.ndarray,
                             num_buckets: int = 32,
                             max_distance: int = 128) -> np.ndarray:
    ret = np.zeros_like(relative_position)
    n = -relative_position

    num_buckets //= 2
    ret += (n < 0).astype(np.int64) * num_buckets
    n = np.abs(n)

    max_exact = num_buckets // 2
    is_small = n < max_exact
    n_safe = np.maximum(n, 1)       # log(0) is unused where is_small
    val_if_large = max_exact + (
        np.log(n_safe.astype(np.float64) / max_exact)
        / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).astype(np.int64)
    val_if_large = np.minimum(val_if_large, num_buckets - 1)

    ret += np.where(is_small, n, val_if_large)
    return ret


def temporal_bucket_table(num_frames: int, num_buckets: int = 32,
                          max_distance: int = 32) -> np.ndarray:
    """(num_frames, num_frames) bucket ids, query frame by key frame."""
    pos = np.arange(num_frames, dtype=np.int64)
    rel_pos = pos[None, :] - pos[:, None]
    return relative_position_bucket(rel_pos, num_buckets=num_buckets,
                                    max_distance=max_distance)
