"""Rotary position embedding, interleaved-pair convention.

Port of videometamaterials_tpu/ops/rotary.py (lucidrains'
rotary-embedding-torch as the reference uses it): angles
freqs[n, 2i] = freqs[n, 2i+1] = n * theta^(-2i/dim), and
out = t * cos + rotate_half(t) * sin with rotate_half pairing
(x0, x1) -> (-x1, x0).
"""

from __future__ import annotations

import numpy as np
import torch


def rotary_frequencies(seq_len: int, dim: int,
                       theta: float = 10000.0) -> np.ndarray:
    """(seq_len, dim) angle table with interleaved duplication, float32."""
    inv_freq = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
    freqs = np.outer(np.arange(seq_len, dtype=np.float64), inv_freq)
    return np.repeat(freqs, 2, axis=-1).astype(np.float32)


def _rotate_half_interleaved(x: torch.Tensor) -> torch.Tensor:
    x1 = x[..., 0::2]
    x2 = x[..., 1::2]
    return torch.stack([-x2, x1], dim=-1).reshape(x.shape)


def apply_rotary_heads(x: torch.Tensor, freqs: torch.Tensor,
                       heads: int) -> torch.Tensor:
    """Rotary on a merged-heads tensor x: (..., seq, heads*d); rotates the
    leading rot_dim features of every head's d-block."""
    *lead, n, hd = x.shape
    d = hd // heads
    xr = x.reshape(*lead, n, heads, d)
    rot = freqs.shape[-1]
    x1, x2 = xr[..., :rot], xr[..., rot:]
    f = freqs.to(x.dtype)[:, None, :]
    x1 = x1 * torch.cos(f) + _rotate_half_interleaved(x1) * torch.sin(f)
    out = x1 if x2.shape[-1] == 0 else torch.cat([x1, x2], dim=-1)
    return out.reshape(*lead, n, hd)


def rotary_head_matrices(freqs: np.ndarray, dim_head: int) -> np.ndarray:
    """Per-position rotary as a (seq, d, d) matrix acting on row vectors:
    q_rotated[f] == q[f] @ A[f] for every head's d-block. Features beyond
    rot_dim pass through."""
    seq, rot = freqs.shape
    cos = np.cos(freqs).astype(np.float32)
    sin = np.sin(freqs).astype(np.float32)
    a = np.zeros((seq, dim_head, dim_head), np.float32)
    idx = np.arange(rot)
    a[:, idx, idx] = cos
    even = np.arange(0, rot, 2)
    odd = even + 1
    a[:, odd, even] = -sin[:, even]
    a[:, even, odd] = sin[:, odd]
    if rot < dim_head:
        tail = np.arange(rot, dim_head)
        a[:, tail, tail] = 1.0
    return a
