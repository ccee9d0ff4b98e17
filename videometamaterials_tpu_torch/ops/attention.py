"""Attention cores: stacked softmax attention and linear attention.

Port of videometamaterials_tpu/ops/attention.py (functions at :30 and
:123). Scores, softmax statistics and accumulations run in float32; the
results come back in the value dtype.
"""

from __future__ import annotations

import torch


def stacked_softmax_attention(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, scale: float,
                              num_video_tokens: int) -> torch.Tensor:
    """q: (b, s, h, n, d); k, v: (b, s, h, m, d) with any conditioning
    tokens stacked IN FRONT of the n video tokens. Returns (b, s, h, n, d).
    The position-bias and focus-mask arguments of the JAX function serve
    the temporal generic plan, which the port does not run (its temporal
    blocks take the frames-major plans)."""
    n = num_video_tokens
    m = k.shape[-2]
    # the JAX core rounds the weights to v's dtype before the value product
    # only in its matmul form, which it takes for token counts above 64
    rounds_weights = max(n, m) > 64
    q = q * scale
    sim = torch.einsum("bshid,bshjd->bshij", q.float(), k.float())
    sim = sim - sim.amax(dim=-1, keepdim=True)
    attn = torch.exp(sim)
    attn = attn / attn.sum(dim=-1, keepdim=True)
    if rounds_weights:
        attn = attn.to(v.dtype).float()
    out = torch.einsum("bshij,bshjd->bshid", attn, v.float())
    return out.to(v.dtype)


def linear_attention_tokens_first(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, *, scale: float,
                                  spatial_size: int) -> torch.Tensor:
    """Linear (efficiency) attention: q softmaxes over its features, k over
    the tokens, v is scaled by 1/spatial_size.
    q: (B, N, h, d); k, v: (B, M, h, d). Returns (B, N, h, d)."""
    q32 = q.float()
    k32 = k.float()
    q32 = torch.exp(q32 - q32.amax(dim=-1, keepdim=True))
    q32 = q32 / q32.sum(dim=-1, keepdim=True)
    k32 = torch.exp(k32 - k32.amax(dim=1, keepdim=True))
    k32 = k32 / k32.sum(dim=1, keepdim=True)
    q32 = q32 * scale
    v32 = v.float() / spatial_size
    context = torch.einsum("bnhd,bnhe->bhde", k32, v32)
    out = torch.einsum("bhde,bnhd->bnhe", context, q32)
    return out.to(v.dtype)
