"""Normalizations with the reference's conventions, fp32 statistics.

Port of videometamaterials_tpu/ops/norms.py. Both functions take
channels-last tensors, compute their statistics in float32 whatever the
input dtype, and return the input dtype.

One-pass statistics (biased var = E[x^2] - mean^2) are the default, as in
the JAX package's unfused path; the fused kernels and their twins use the
two-pass form (`one_pass=False`). The JAX package's switch
VMT_ONEPASS_NORMS is read when the module is imported, as there: "0" or
"" makes the default two-pass.
"""

from __future__ import annotations

import os

import torch

ONE_PASS_STATS = os.environ.get("VMT_ONEPASS_NORMS", "1") not in ("", "0")


def _stats(x32: torch.Tensor, dims, one_pass: bool | None):
    if one_pass is None:
        one_pass = ONE_PASS_STATS
    mean = x32.mean(dim=dims, keepdim=True)
    if one_pass:
        meansq = x32.square().mean(dim=dims, keepdim=True)
        var = (meansq - mean.square()).clamp_min(0.0)
    else:
        var = (x32 - mean).square().mean(dim=dims, keepdim=True)
    return mean, var


def channel_layer_norm(x: torch.Tensor, gamma: torch.Tensor,
                       eps: float = 1e-5,
                       one_pass: bool | None = None) -> torch.Tensor:
    """Scale-only LayerNorm over the last (channel) axis, biased variance,
    eps inside the sqrt. gamma: (C,)."""
    x32 = x.float()
    mean, var = _stats(x32, -1, one_pass)
    out = (x32 - mean) / torch.sqrt(var + eps) * gamma.float()
    return out.to(x.dtype)


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               num_groups: int, eps: float = 1e-5,
               one_pass: bool | None = None) -> torch.Tensor:
    """GroupNorm on a channels-last (B, ..., C) tensor: statistics per
    sample and channel group over every other axis (torch GroupNorm on
    (B, C, F, H, W))."""
    b, c = x.shape[0], x.shape[-1]
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by {num_groups} groups")
    grouped = x.float().reshape(b, -1, num_groups, c // num_groups)
    mean, var = _stats(grouped, (1, 3), one_pass)
    normed = ((grouped - mean) / torch.sqrt(var + eps)).reshape(x.shape)
    return (normed * scale.float() + bias.float()).to(x.dtype)
