"""Attention cores: stacked softmax attention and linear attention.

Port of videometamaterials_tpu/ops/attention.py (functions at :30 and
:123). Scores, softmax statistics and accumulations run in float32; the
results come back in the value dtype.
"""

from __future__ import annotations

import torch

NEG_INF = -0.7 * torch.finfo(torch.float32).max


def stacked_softmax_attention(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, scale: float,
                              num_video_tokens: int,
                              pos_bias: torch.Tensor | None = None,
                              pos_bias_on_cond: bool = False,
                              focus_present_mask=None) -> torch.Tensor:
    """q: (b, s, h, n, d); k, v: (b, s, h, m, d) with any conditioning
    tokens stacked IN FRONT of the n video tokens, or (b, 1, h, m, d):
    conditioning keys and values shared by every s (broadcast, never
    copied). pos_bias (h, n, n) lands on the video block of the scores and,
    with pos_bias_on_cond (per-frame tokens, m = 2n), on the first n
    columns too (vddp.py:502-512). focus_present_mask (b,) bool: a True
    sample's queries attend to their own token only (vddp.py:514-524);
    defined only without stacked conditioning tokens (m == n), as in the
    JAX core. Returns (b, s, h, n, d)."""
    n = num_video_tokens
    m = k.shape[-2]
    # the JAX core rounds the weights to v's dtype before the value product
    # only in its matmul form, which it takes for token counts above 64
    rounds_weights = max(n, m) > 64
    q = q * scale
    sim = torch.einsum("bshid,bshjd->bshij", q.float(), k.float())
    if pos_bias is not None:
        bias = pos_bias.float()
        sim = torch.cat([sim[..., :m - n], sim[..., m - n:] + bias], dim=-1)
        if pos_bias_on_cond and m != n:
            sim = torch.cat([sim[..., :n] + bias, sim[..., n:]], dim=-1)
    if focus_present_mask is not None:
        if sim.shape[-1] != n:
            raise ValueError("focus_present masking requires unstacked K")
        eye = torch.eye(n, dtype=torch.bool, device=sim.device)
        allow = eye | ~focus_present_mask.to(sim.device)[:, None, None, None,
                                                         None]
        sim = sim.masked_fill(~allow, NEG_INF)
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
