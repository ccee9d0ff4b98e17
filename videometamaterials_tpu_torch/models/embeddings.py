"""Timestep and relative-position embeddings.

Port of videometamaterials_tpu/models/embeddings.py (SinusoidalPosEmb,
RelativePositionBias). The whole-signal CNN/GRU embedders are ablation-only
and wait for a later slice.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from videometamaterials_tpu_torch.ops.relative_bias import (
    temporal_bucket_table,
)


class SinusoidalPosEmb(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        half = self.dim // 2
        scale = math.log(10000.0) / (half - 1)
        freqs = torch.exp(torch.arange(half, dtype=torch.float32,
                                       device=t.device) * -scale)
        args = t.float()[:, None] * freqs[None, :]
        return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


class RelativePositionBias(nn.Module):
    """Learned T5 bucket bias; the table is the reference's
    `relative_attention_bias` embedding (num_buckets, heads)."""

    def __init__(self, heads: int = 8, num_buckets: int = 32,
                 max_distance: int = 128):
        super().__init__()
        self.num_buckets = num_buckets
        self.max_distance = max_distance
        self.relative_attention_bias = nn.Embedding(num_buckets, heads)

    def forward(self, num_frames: int) -> torch.Tensor:
        """Returns (heads, n, n) float32."""
        buckets = torch.as_tensor(
            temporal_bucket_table(num_frames, self.num_buckets,
                                  self.max_distance),
            device=self.relative_attention_bias.weight.device)
        values = self.relative_attention_bias.weight.float()[buckets]
        return values.permute(2, 0, 1)
