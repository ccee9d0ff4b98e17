"""Timestep and relative-position embeddings.

Port of videometamaterials_tpu/models/embeddings.py: SinusoidalPosEmb,
RelativePositionBias, and SignalEmbedding, the whole-curve CNN/GRU encoder
of the conditioning ablation (per_frame_cond: false; the reference's
vddp.py:538-572). The embedders run in PyTorch's own Conv1d and GRU: the
JAX package runs them in XLA, with no kernel of its own.
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


class SignalEmbedding(nn.Module):
    """The whole-curve encoder of a (B, L) signal, float32.

    'CNN': five stride-2 Conv1d(k=4, p=1) + SiLU stages (1 -> 16 -> 32 ->
    64 -> 128 -> out channels), which take the 50-point curve tail to
    length 1; returns (B, out), the mean over the length if more than one
    position is left. 'GRU': a 3-layer GRU of `out` features; returns the
    top layer's sequence (B, L, out), one token a curve point. Parameters
    carry the reference's names: `emb_model.{0,2,4,6,8}.*` (CNN),
    `emb_model.weight_ih_l{k}` etc. (GRU)."""

    def __init__(self, cond_arch: str, init_channel: int = 1,
                 channel_upsamplings=(16, 32, 64, 128, 256)):
        super().__init__()
        self.cond_arch = cond_arch
        chans = [init_channel, *channel_upsamplings]
        if cond_arch == "CNN":
            layers = []
            for cin, cout in zip(chans[:-1], chans[1:]):
                layers += [nn.Conv1d(cin, cout, 4, stride=2, padding=1),
                           nn.SiLU()]
            self.emb_model = nn.Sequential(*layers)
        elif cond_arch == "GRU":
            self.emb_model = nn.GRU(init_channel, channel_upsamplings[-1],
                                    num_layers=3, batch_first=True)
        else:
            raise ValueError(f"unknown architecture {cond_arch!r}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.float()[:, None, :] if self.cond_arch == "CNN" \
            else x.float()[..., None]
        if self.cond_arch == "CNN":
            h = self.emb_model(h)                      # (B, out, L')
            return h.mean(dim=-1) if h.shape[-1] > 1 else h[..., 0]
        return self.emb_model(h)[0]
