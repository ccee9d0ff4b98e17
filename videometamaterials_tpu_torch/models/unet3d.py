"""Factorized video U-Net denoiser, PyTorch port.

Port of videometamaterials_tpu/models/unet3d.py with the same math and
execution plans:

  - videos are (B, F, H, W, C) at module boundaries; pseudo-3D convs fold
    frames into the batch and run as channels_last 2D convs;
  - fp32 parameters, bf16 activations (the compute dtype), fp32 norms and
    softmax statistics;
  - classifier-free guidance takes an explicit per-sample `null_cond_mask`
    and can run the CFG pair as one doubled batch (`cfg_tiled_pair`).

Parameters carry the reference implementation's state-dict names and
layouts (`downs.0.3.fn.fn.fn.to_qkv.weight`, Conv3d weights as
(O, I, 1, kh, kw), ...), so `convert.py` can place a flax tree and a
reference checkpoint with `load_state_dict(strict=True)`.

The temporal-attention and spatial linear-attention blocks each have two
plans: the unfused plan (plain PyTorch, what the JAX package runs off the
TPU) and the fused plan, which calls the hand-written CUDA kernels on a
CUDA tensor and their plain twins on a CPU tensor. Under grad the fused
plans backpropagate through autograd of the plain twins ('recompute'),
through the backward kernels ('kernel', from `fused_bwd_kernels` and
`temporal_vjp`), or, for the temporal blocks under `temporal_vjp: saved`,
from the softmax weights the forward kernel saved ('saved'). The linear
blocks take the JAX package's `VMT_LINEAR_LAYOUT` switch ('merged' stats
+ apply, or the 'head' kernel) inside `fused_linear_block`;
`UNet3D.fused_plans(False)` runs every block on its
unfused plan over the same parameters (the JAX Trainer's plan split).

The conditioning ablation of the paper (per_frame_cond: false) is built
as the JAX model builds it: the whole curve through the CNN embedder (its
hidden joins the time embedding, added or concatenated), and conditioning
tokens that are the hidden broadcast to `cond_attention_tokens`, the GRU's
token a curve point, or none; the tokens enter the blocks stacked in front
of the keys ('self-stacked', on the fused kernels at any token count up to
MAX_COND_TOKENS) or as the keys of a cross-attention (the generic plan).
The circular padding modes and `use_sparse_linear_attn: false` are built
too.

The training-side variants follow the JAX model: a focus-present mask
(b,) bool limits a True sample's temporal queries to their own frame; a
temporal block under a mask leaves the fused kernel for its unfused plan,
which masks only without conditioning tokens (the JAX temporal_xla and
Attention ignore the mask where tokens are stacked, unet3d.py:466-471;
matched, not repaired). `temporal_s_tile` runs the unfused temporal
blocks tile by tile over the spatial positions (`temporal_stiled`), and
`remat_blocks` recomputes every ResnetBlock in the backward
(torch.utils.checkpoint, non-reentrant, so the recompute runs under grad
as the first pass did and ops/conv.py takes the same rounding branch in
both).
"""

from __future__ import annotations

import contextlib
import functools
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from videometamaterials_tpu_torch.config import (
    COND_ATTENTIONS,
    CURVE_POINTS,
    ModelConfig,
    resolve_device,
    set_precision,
    temporal_bwd_mode,
)
from videometamaterials_tpu_torch.models.embeddings import (
    RelativePositionBias,
    SignalEmbedding,
    SinusoidalPosEmb,
)
from videometamaterials_tpu_torch.ops.attention import (
    NEG_INF,
    linear_attention_tokens_first,
    stacked_softmax_attention,
)
from videometamaterials_tpu_torch.ops.conv import (
    conv1x1,
    conv2d_spatial,
    conv_transpose2d_spatial,
)
from videometamaterials_tpu_torch.ops.cuda.fused_linear_block import (
    fused_linear_block,
)
from videometamaterials_tpu_torch.ops.cuda.fused_temporal_block import (
    check_cond_tokens,
    fused_temporal_block,
    reference_temporal_block,
)
from videometamaterials_tpu_torch.ops.norms import (
    channel_layer_norm,
    group_norm,
)
from videometamaterials_tpu_torch.ops.rotary import (
    apply_rotary_heads,
    rotary_frequencies,
    rotary_head_matrices,
)


# ------------------------------------------------------- parameter holders


class SpatialConv(nn.Module):
    """Reference Conv3d with a (1, k, k) kernel: weight (O, I, 1, k, k)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 padding: int | None = None, padding_mode: str = "zeros"):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, 1, k, k))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.stride, self.padding = stride, padding
        self.padding_mode = padding_mode

    def forward(self, x):
        return conv2d_spatial(x, self.weight[:, :, 0], self.bias,
                              stride=self.stride, padding=self.padding,
                              padding_mode=self.padding_mode)


class SpatialConvTranspose(nn.Module):
    """Reference ConvTranspose3d (1, 4, 4) / stride (1, 2, 2): weight
    (I, O, 1, 4, 4)."""

    def __init__(self, dim: int, padding_mode: str = "zeros"):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim, dim, 1, 4, 4))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.padding_mode = padding_mode

    def forward(self, x):
        return conv_transpose2d_spatial(x, self.weight[:, :, 0], self.bias,
                                        padding_mode=self.padding_mode)


class Conv1x1(nn.Module):
    """Reference 1x1 conv: weight (O, I, 1, 1, 1), optional bias."""

    def __init__(self, cin: int, cout: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, 1, 1, 1))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    @property
    def matrix(self) -> torch.Tensor:       # (O, I)
        return self.weight.view(self.weight.shape[0], self.weight.shape[1])

    def forward(self, x):
        return conv1x1(x, self.matrix, self.bias)


class _ChannelLayerNorm(nn.Module):
    """Reference scale-only LayerNorm: gamma (1, C, 1, 1, 1)."""

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(1, dim, 1, 1, 1))

    @property
    def scale(self) -> torch.Tensor:        # (C,)
        return self.gamma.view(-1)


class _PreNorm(nn.Module):
    """Holds the reference's Residual(PreNorm(fn)) parameters: `norm`, `fn`."""

    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.norm = _ChannelLayerNorm(dim)
        self.fn = fn


class _Rearranged(nn.Module):
    """The reference's EinopsToAndFrom wrapper: only nests `fn`."""

    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn


class _GroupNormParams(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))


# ------------------------------------------------------------------ blocks


@functools.lru_cache(maxsize=None)
def _rotary_tables(f: int, dim_head: int, device: torch.device):
    """The rotary angle table (f, rot) and per-frame rotation matrices
    (f, d, d) on `device`, float32, built once per (f, d, device): they do
    not depend on parameters, so no step copies them to the card again."""
    freqs = rotary_frequencies(f, min(32, dim_head))
    return (torch.as_tensor(freqs, device=device),
            torch.as_tensor(rotary_head_matrices(freqs, dim_head),
                            device=device))


def _inference_cache(module: nn.Module, key, params, build):
    """`build()` once per state of `params`: the fused plans fold and cast
    their weights once per model instead of once per forward. A load, a
    cast or an optimizer step changes a parameter's storage, dtype or
    version counter and so rebuilds. With autograd on it builds afresh, so
    gradients still reach the parameters. The cache lives on the module,
    so two models (two variants of the config) never share an entry."""
    if torch.is_grad_enabled():
        return build()
    stamp = tuple((p.device, p.data_ptr(), p.dtype, p._version)
                  for p in params)
    hit = module._kernel_weights.get(key)
    if hit is None or hit[0] != stamp:
        hit = module._kernel_weights[key] = (stamp, build())
    return hit[1]


class Block(nn.Module):
    """Conv(1,3,3) + GroupNorm + optional FiLM + SiLU."""

    def __init__(self, dim: int, dim_out: int, groups: int, dtype,
                 padding_mode: str = "zeros"):
        super().__init__()
        self.proj = SpatialConv(dim, dim_out, 3, padding_mode=padding_mode)
        self.norm = _GroupNormParams(dim_out)
        self.groups = groups
        self.dtype = dtype

    def forward(self, x, scale_shift=None):
        x = self.proj(x.to(self.dtype))
        x = group_norm(x, self.norm.weight, self.norm.bias, self.groups)
        if scale_shift is not None:
            scale, shift = scale_shift
            x = (x * (scale[:, None, None, None, :].to(x.dtype) + 1)
                 + shift[:, None, None, None, :].to(x.dtype))
        return F.silu(x)


class ResnetBlock(nn.Module):
    """Two Blocks + 1x1 skip; FiLM scale/shift from the time+cond
    embedding."""

    def __init__(self, dim: int, dim_out: int, time_emb_dim: int | None,
                 groups: int, dtype, padding_mode: str = "zeros"):
        super().__init__()
        self.mlp = (nn.Sequential(nn.SiLU(), nn.Linear(time_emb_dim,
                                                       dim_out * 2))
                    if time_emb_dim is not None else None)
        self.block1 = Block(dim, dim_out, groups, dtype, padding_mode)
        self.block2 = Block(dim_out, dim_out, groups, dtype, padding_mode)
        self.res_conv = Conv1x1(dim, dim_out) if dim != dim_out else None
        self.dtype = dtype

    def forward(self, x, time_emb=None):
        scale_shift = None
        if self.mlp is not None:
            scale_shift = self.mlp(time_emb.float()).chunk(2, dim=-1)
        h = self.block1(x, scale_shift=scale_shift)
        h = self.block2(h)
        if self.res_conv is not None:
            x = self.res_conv(x.to(self.dtype))
        return h + x.to(h.dtype)


class Attention(nn.Module):
    """Full softmax attention shared by the temporal blocks and the mid
    spatial block. Conditioning: 'self-stacked' (the tokens' keys and
    values stacked in front of the block's own), 'cross-attention' (queries
    from `to_q` against the tokens alone) or 'none'. Projections are
    bias-free Linears in the reference layout (out, in); to_k/to_v exist
    with a conditioning mode, to_q with cross-attention (the JAX
    Attention.setup)."""

    def __init__(self, dim: int, heads: int, dim_head: int, cond_dim: int,
                 dtype, cond_attention: str = "self-stacked",
                 per_frame_cond: bool = True):
        super().__init__()
        hidden = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.dtype = dtype
        self.cond_attention = cond_attention
        self.per_frame_cond = per_frame_cond
        self.to_qkv = nn.Linear(dim, hidden * 3, bias=False)
        self.to_out = nn.Linear(hidden, dim, bias=False)
        if cond_attention != "none":
            self.to_k = nn.Linear(cond_dim, hidden, bias=False)
            self.to_v = nn.Linear(cond_dim, hidden, bias=False)
        if cond_attention == "cross-attention":
            self.to_q = nn.Linear(dim, hidden, bias=False)
        self._kernel_weights = {}

    def _cond_kv(self, label_emb):
        le = label_emb.to(self.dtype)
        return conv1x1(le, self.to_k.weight), conv1x1(le, self.to_v.weight)

    def forward(self, x, pos_bias=None, label_emb=None,
                use_rotary: bool = False, focus_present_mask=None):
        """Generic plan (the JAX Attention.__call__) on (b, s, n, c), n the
        token axis: the mid spatial block (s frames, n pixels, no rotary,
        no position bias) and the temporal blocks under cross-attention (s
        pixels, n frames, rotary and the position bias). Conditioning
        tokens (b, T, cond_dim): per-frame ones (T = s, one in front of
        each frame's keys, the mid block), else shared by every s. The
        focus-present mask applies only where no tokens are used."""
        b, s, n, _ = x.shape
        heads, dh = self.heads, self.dim_head
        hidden = heads * dh
        x = x.to(self.dtype)
        freqs = (torch.as_tensor(rotary_frequencies(n, min(32, dh)),
                                 device=x.device) if use_rotary else None)
        cond_used = self.cond_attention != "none" and label_emb is not None

        def split_heads(t):       # (b, s', m, hidden) -> (b, s', heads, m, d)
            return t.reshape(t.shape[0], t.shape[1], t.shape[2], heads,
                             dh).permute(0, 1, 3, 2, 4)

        if self.cond_attention == "cross-attention" and cond_used:
            q = conv1x1(x, self.to_q.weight)
            if freqs is not None:
                q = apply_rotary_heads(q, freqs, heads)
            ek, ev = self._cond_kv(label_emb)        # (b, T, hidden)
            out = stacked_softmax_attention(
                split_heads(q), split_heads(ek[:, None]),
                split_heads(ev[:, None]), scale=dh ** -0.5,
                num_video_tokens=n)
            out = out.permute(0, 1, 3, 2, 4).reshape(b, s, n, hidden)
            return conv1x1(out, self.to_out.weight)

        qkv = conv1x1(x, self.to_qkv.weight)
        q, k, v = qkv.chunk(3, dim=-1)
        if freqs is not None:
            q = apply_rotary_heads(q, freqs, heads)
            k = apply_rotary_heads(k, freqs, heads)
        if cond_used:                                 # 'self-stacked'
            ek, ev = self._cond_kv(label_emb)
            if pos_bias is None and self.per_frame_cond:
                # one token per frame in front of that frame's keys
                if ek.shape[1] != s:
                    raise ValueError("per-frame cond tokens must align with "
                                     "the frame axis")
                ek, ev = ek[:, :, None, :], ev[:, :, None, :]
            else:
                t_tok = ek.shape[1]
                if freqs is not None and self.per_frame_cond:
                    ek = apply_rotary_heads(ek, freqs, heads)
                ek = ek[:, None].expand(b, s, t_tok, hidden)
                ev = ev[:, None].expand(b, s, t_tok, hidden)
            k = torch.cat([ek, k], dim=-2)
            v = torch.cat([ev, v], dim=-2)
        out = stacked_softmax_attention(
            split_heads(q), split_heads(k), split_heads(v), scale=dh ** -0.5,
            num_video_tokens=n, pos_bias=pos_bias,
            pos_bias_on_cond=self.per_frame_cond and cond_used,
            focus_present_mask=None if cond_used else focus_present_mask)
        out = out.permute(0, 1, 3, 2, 4).reshape(b, s, n, hidden)
        return conv1x1(out, self.to_out.weight)

    # ---------------------------------------------- frames-major temporal

    def _folded_temporal_weights(self, f: int):
        """Per-frame QKV weights (f, c, 3*hidden) with rotary and the
        1/sqrt(d) q-scale folded in, in float32; and the rotary angles."""
        heads, dh = self.heads, self.dim_head
        hidden = heads * dh
        scale = dh ** -0.5
        w = self.to_qkv.weight.float().t()                 # (c, 3*hidden)
        c = w.shape[0]
        w_q, w_k, w_v = w.split(hidden, dim=-1)
        freqs, rot = _rotary_tables(f, dh, w.device)      # rot: (f, d, d)
        w_qf = torch.einsum("chd,fde->fche", w_q.reshape(c, heads, dh),
                            rot * scale).reshape(f, c, hidden)
        w_kf = torch.einsum("chd,fde->fche", w_k.reshape(c, heads, dh),
                            rot).reshape(f, c, hidden)
        w_vf = w_v[None].expand(f, c, hidden)
        return torch.cat([w_qf, w_kf, w_vf], dim=-1), freqs

    def _temporal_cond(self, label_emb, freqs):
        """Conditioning K/V (b, T, hidden) of the frames-major temporal
        plans (self-stacked tokens), with rotary on the keys under
        per-frame conditioning (time is encoded into the per-frame cond
        keys), or (None, None)."""
        if label_emb is None:
            return None, None
        ek, ev = self._cond_kv(label_emb)
        if self.per_frame_cond:
            ek = apply_rotary_heads(ek, freqs, self.heads)
        return ek, ev

    def _cond_block_biased(self, f, t_tok) -> bool:
        """The position bias lands on the cond block only with per-frame
        tokens, one a frame (vddp.py:502-512)."""
        return self.per_frame_cond and t_tok == f

    def _temporal_bias_all(self, f, t_tok, pos_bias):
        """(f, f+T, heads) float32: the position bias on the video block
        and, with per-frame cond tokens, on the cond block too (zeros
        there otherwise)."""
        bias_v = pos_bias.float().permute(1, 2, 0)
        if not t_tok:
            return bias_v.contiguous()
        bias_c = (bias_v if self._cond_block_biased(f, t_tok)
                  else bias_v.new_zeros((f, t_tok, bias_v.shape[-1])))
        return torch.cat([bias_v, bias_c], dim=1).contiguous()

    def temporal_fused(self, x_bfsc, norm_gamma, pos_bias, label_emb=None,
                       bwd: str = "recompute"):
        """The whole temporal block through the fused kernel (its twin on a
        CPU tensor). x_bfsc: (b, f, s, c). Returns x + block(x). Under grad
        the fold re-runs, in float32, so the weight gradients reach
        to_qkv.weight and come out float32; bwd is the backward plan."""
        f = x_bfsc.shape[1]
        dt = self.dtype

        def weights():
            w_all, freqs = self._folded_temporal_weights(f)
            w_out = self.to_out.weight.t()
            if not torch.is_grad_enabled():     # cached: cast once
                w_all, w_out = (w_all.to(dt).contiguous(),
                                w_out.to(dt).contiguous())
            return w_all, w_out, freqs

        w_all, w_out, freqs = _inference_cache(
            self, ("temporal", f), (self.to_qkv.weight, self.to_out.weight),
            weights)
        ek, ev = self._temporal_cond(label_emb, freqs)
        t_tok = 0 if ek is None else ek.shape[1]
        return fused_temporal_block(
            x_bfsc.contiguous(), norm_gamma.float().contiguous(), w_all, w_out,
            None if ek is None else ek.to(dt).contiguous(),
            None if ev is None else ev.to(dt).contiguous(),
            self._temporal_bias_all(f, t_tok, pos_bias), heads=self.heads,
            bwd=bwd)

    def temporal_stiled(self, x_bfsc, norm_gamma, pos_bias, label_emb=None,
                        s_tile: int = 1152):
        """The s-tiled plan (the JAX temporal_stiled): the block through
        reference_temporal_block on each tile of s_tile spatial positions,
        the whole axis at once where s_tile does not divide it into two or
        more tiles."""
        b, f, s, _ = x_bfsc.shape
        dt = self.dtype
        w_all, freqs = self._folded_temporal_weights(f)
        ek, ev = self._temporal_cond(label_emb, freqs)
        t_tok = 0 if ek is None else ek.shape[1]
        args = (norm_gamma, w_all.to(dt), self.to_out.weight.t().to(dt),
                None if ek is None else ek.to(dt),
                None if ev is None else ev.to(dt),
                self._temporal_bias_all(f, t_tok, pos_bias))
        n = s // s_tile if s % s_tile == 0 else 1
        if n <= 1:
            return reference_temporal_block(x_bfsc, *args, heads=self.heads)
        return torch.cat([
            reference_temporal_block(tile, *args, heads=self.heads)
            for tile in x_bfsc.split(s_tile, dim=2)], dim=2)

    def temporal_xla(self, x_bfsc, norm_gamma, pos_bias, label_emb=None,
                     focus_present_mask=None):
        """The unfused plan of the temporal block (the JAX package's
        temporal_xla): LN + folded QKV + joint softmax over [video | cond]
        keys + out-proj + residual, in frames-major (b, f, s, c) layout.
        Scores and weights are stored in the compute dtype, as the JAX plan
        stores them under bf16. The focus-present mask applies only without
        conditioning tokens, as in the JAX plan."""
        b, f, s, _ = x_bfsc.shape
        heads, dh = self.heads, self.dim_head
        hidden = heads * dh
        dt = self.dtype
        y = channel_layer_norm(x_bfsc, norm_gamma).to(dt)
        w_all, freqs = self._folded_temporal_weights(f)
        qkv = torch.einsum("bfsc,fch->bfsh", y, w_all.to(dt))
        q, k, v = (t.reshape(b, f, s, heads, dh).float()
                   for t in qkv.split(hidden, dim=-1))
        bias = pos_bias.float().permute(1, 2, 0)[None, :, :, None, :].to(dt)
        sim_v = torch.einsum("bishd,bjshd->bijsh", q, k).to(dt) + bias
        ek, ev = self._temporal_cond(label_emb, freqs)
        if ek is not None:
            t_tok = ek.shape[1]
            ekh = ek.reshape(b, t_tok, heads, dh).float()
            evh = ev.reshape(b, t_tok, heads, dh).float()
            sim_c = torch.einsum("bishd,bthd->bitsh", q, ekh).to(dt)
            if self._cond_block_biased(f, t_tok):
                sim_c = sim_c + bias
            mx = torch.maximum(sim_v.amax(dim=2, keepdim=True),
                               sim_c.amax(dim=2, keepdim=True)).float()
            e_v = torch.exp(sim_v.float() - mx)
            e_c = torch.exp(sim_c.float() - mx)
            z = e_v.sum(dim=2, keepdim=True) + e_c.sum(dim=2, keepdim=True)
            out = torch.einsum("bijsh,bjshd->bishd",
                               (e_v / z).to(dt).float(), v)
            out = out + torch.einsum("bitsh,bthd->bishd",
                                     (e_c / z).to(dt).float(), evh)
        else:
            if focus_present_mask is not None:
                eye = torch.eye(f, dtype=torch.bool, device=sim_v.device)
                allow = eye[None, :, :, None, None] | ~focus_present_mask[
                    :, None, None, None, None]
                sim_v = sim_v.masked_fill(~allow, NEG_INF)
            mx = sim_v.amax(dim=2, keepdim=True).float()
            e = torch.exp(sim_v.float() - mx)
            attn = (e / e.sum(dim=2, keepdim=True)).to(dt).float()
            out = torch.einsum("bijsh,bjshd->bishd", attn, v)
        out = out.to(dt).reshape(b, f, s, hidden)
        out = conv1x1(out, self.to_out.weight)
        return x_bfsc + out.to(x_bfsc.dtype)


class SpatialLinearAttention(nn.Module):
    """Linear attention over the pixels of each frame, conditioning tokens
    stacked in front ('self-stacked': one a frame, or T shared by the
    frames) or alone as the keys ('cross-attention', queries from to_q).
    to_qkv/to_q/to_out are 1x1 convs, to_k/to_v Linears (the reference's
    layouts); to_k/to_v exist with a conditioning mode, to_q in place of
    to_qkv under cross-attention (the JAX module's parameters)."""

    def __init__(self, dim: int, heads: int, dim_head: int, cond_dim: int,
                 dtype, cond_attention: str = "self-stacked",
                 per_frame_cond: bool = True):
        super().__init__()
        hidden = heads * dim_head
        self.dim, self.heads, self.dim_head = dim, heads, dim_head
        self.dtype = dtype
        self.cond_attention = cond_attention
        self.per_frame_cond = per_frame_cond
        if cond_attention == "cross-attention":
            self.to_q = Conv1x1(dim, hidden, bias=False)
        else:
            self.to_qkv = Conv1x1(dim, hidden * 3, bias=False)
        if cond_attention != "none":
            self.to_k = nn.Linear(cond_dim, hidden, bias=False)
            self.to_v = nn.Linear(cond_dim, hidden, bias=False)
        self.to_out = Conv1x1(hidden, dim)
        self._kernel_weights = {}

    def _cond_kv(self, label_emb, b, f):
        """Conditioning K/V on the folded frame axis: (b*f, 1, hidden) with
        per-frame tokens, else the T tokens shared by the frames
        (b*f, T, hidden) (the JAX _fused_cond_kv)."""
        hidden = self.heads * self.dim_head
        le = label_emb.to(self.dtype)
        ek = conv1x1(le, self.to_k.weight)
        ev = conv1x1(le, self.to_v.weight)
        if self.per_frame_cond:
            if ek.shape[1] != f:
                raise ValueError("per-frame cond tokens must align with the "
                                 "frame axis")
            return ek.reshape(b * f, 1, hidden), ev.reshape(b * f, 1, hidden)
        t_tok = ek.shape[1]
        return tuple(t[:, None].expand(b, f, t_tok, hidden).reshape(
            b * f, t_tok, hidden) for t in (ek, ev))

    def forward(self, x, label_emb=None):
        """Unfused plan on the normed input; returns the block's update
        (b, f, h, w, dim) without the residual."""
        b, f, h, w, c = x.shape
        heads, dh = self.heads, self.dim_head
        xf = x.reshape(b * f, h * w, c).to(self.dtype)
        cond_used = self.cond_attention != "none" and label_emb is not None
        if self.cond_attention == "cross-attention" and cond_used:
            q = conv1x1(xf, self.to_q.matrix).reshape(b * f, h * w, heads, dh)
            k, v = (t.reshape(b * f, -1, heads, dh)
                    for t in self._cond_kv(label_emb, b, f))
        else:
            qkv = conv1x1(xf, self.to_qkv.matrix)
            q, k, v = (t.reshape(b * f, h * w, heads, dh)
                       for t in qkv.chunk(3, dim=-1))
            if cond_used:
                ek, ev = self._cond_kv(label_emb, b, f)
                k = torch.cat([ek.reshape(b * f, -1, heads, dh), k], dim=1)
                v = torch.cat([ev.reshape(b * f, -1, heads, dh), v], dim=1)
        out = linear_attention_tokens_first(q, k, v, scale=dh ** -0.5,
                                            spatial_size=h * w)
        out = conv1x1(out.reshape(b * f, h * w, heads * dh),
                      self.to_out.matrix, self.to_out.bias)
        return out.reshape(b, f, h, w, self.dim)

    def forward_fused(self, x, norm_gamma, label_emb=None,
                      bwd: str = "recompute"):
        """Fused plan: LN, attention, out-proj and residual through the
        stats + apply kernels (their twins on a CPU tensor). Under grad the
        weights enter in float32 (float32 gradients); bwd is the backward
        plan."""
        b, f, h, w, c = x.shape
        dt = self.dtype
        ek = ev = None
        if label_emb is not None:
            ek, ev = (t.contiguous() for t in self._cond_kv(label_emb, b, f))

        def weights():
            w_qkv, w_out = self.to_qkv.matrix.t(), self.to_out.matrix.t()
            if not torch.is_grad_enabled():     # cached: cast once
                w_qkv, w_out = (w_qkv.to(dt).contiguous(),
                                w_out.to(dt).contiguous())
            return w_qkv, w_out, self.to_out.bias.float().contiguous()

        w_qkv, w_out, out_bias = _inference_cache(
            self, "linear",
            (self.to_qkv.weight, self.to_out.weight, self.to_out.bias),
            weights)
        out = fused_linear_block(
            x.reshape(b * f, h * w, c).to(dt).contiguous(),
            norm_gamma.float().contiguous(), w_qkv, w_out, out_bias, ek, ev,
            heads=self.heads, scale=self.dim_head ** -0.5,
            spatial_size=h * w, bwd=bwd)
        return out.reshape(b, f, h, w, c).to(x.dtype)


class TemporalAttentionBlock(nn.Module):
    """PreNorm + residual full attention over the frame axis; parameters
    nest as the reference's `fn.norm.gamma` / `fn.fn.fn.<proj>`. Under
    'none' and 'self-stacked' conditioning it runs the frames-major plans
    as the JAX block dispatches them (unet3d.py:705-725): the fused kernel
    without a focus mask, else the s-tiled plan without a mask where
    s_tile divides h*w into two or more tiles, else temporal_xla (with the
    mask); under cross-attention the generic plan (the JAX block's
    fallback), which has no fused form. The fused backward plan is
    resolved at each call (`config.temporal_bwd_mode` of `bwd`, an
    explicit plan or None, and fused_bwd_kernels)."""

    def __init__(self, dim: int, heads: int, dim_head: int, cond_dim: int,
                 dtype, use_fused_block: bool, bwd: str | None = None,
                 cond_attention: str = "self-stacked",
                 per_frame_cond: bool = True,
                 fused_bwd_kernels: bool = False,
                 s_tile: int | None = None):
        super().__init__()
        self.fn = _PreNorm(dim, _Rearranged(Attention(
            dim, heads, dim_head, cond_dim, dtype, cond_attention,
            per_frame_cond)))
        self.generic = cond_attention == "cross-attention"
        self.use_fused_block = use_fused_block and not self.generic
        self.temporal_vjp = bwd
        self.fused_bwd_kernels = fused_bwd_kernels
        self.s_tile = s_tile

    @property
    def bwd(self) -> str:
        return temporal_bwd_mode(self.temporal_vjp, self.fused_bwd_kernels)

    def forward(self, x, pos_bias, label_emb=None, focus_present_mask=None):
        b, f, h, w, c = x.shape
        attn = self.fn.fn.fn
        if self.generic:
            y = channel_layer_norm(x, self.fn.norm.scale)
            y = y.permute(0, 2, 3, 1, 4).reshape(b, h * w, f, c)
            y = attn(y, pos_bias=pos_bias, label_emb=label_emb,
                     use_rotary=True, focus_present_mask=focus_present_mask)
            y = y.reshape(b, h, w, f, c).permute(0, 3, 1, 2, 4)
            return x + y.to(x.dtype)
        x4 = x.reshape(b, f, h * w, c)
        if self.use_fused_block and focus_present_mask is None:
            out = attn.temporal_fused(x4, self.fn.norm.scale, pos_bias,
                                      label_emb=label_emb, bwd=self.bwd)
        elif self.s_tile and focus_present_mask is None \
                and (h * w) % self.s_tile == 0 and h * w > self.s_tile:
            out = attn.temporal_stiled(x4, self.fn.norm.scale, pos_bias,
                                       label_emb=label_emb,
                                       s_tile=self.s_tile)
        else:
            out = attn.temporal_xla(x4, self.fn.norm.scale, pos_bias,
                                    label_emb=label_emb,
                                    focus_present_mask=focus_present_mask)
        return out.reshape(b, f, h, w, c)


class SpatialAttentionBlock(nn.Module):
    """PreNorm + residual full attention over the pixels of each frame
    (mid block only)."""

    def __init__(self, dim: int, heads: int, dim_head: int, cond_dim: int,
                 dtype, cond_attention: str = "self-stacked",
                 per_frame_cond: bool = True):
        super().__init__()
        self.fn = _PreNorm(dim, _Rearranged(Attention(
            dim, heads, dim_head, cond_dim, dtype, cond_attention,
            per_frame_cond)))

    def forward(self, x, label_emb=None):
        b, f, h, w, c = x.shape
        y = channel_layer_norm(x, self.fn.norm.scale).reshape(b, f, h * w, c)
        y = self.fn.fn.fn(y, label_emb=label_emb).reshape(b, f, h, w, c)
        return x + y.to(x.dtype)


class SpatialLinearAttentionBlock(nn.Module):
    """PreNorm + residual linear attention (`fn.norm.gamma`,
    `fn.fn.<proj>`)."""

    def __init__(self, dim: int, heads: int, dim_head: int, cond_dim: int,
                 dtype, use_fused_block: bool, bwd: str = "recompute",
                 cond_attention: str = "self-stacked",
                 per_frame_cond: bool = True):
        super().__init__()
        self.fn = _PreNorm(dim, SpatialLinearAttention(
            dim, heads, dim_head, cond_dim, dtype, cond_attention,
            per_frame_cond))
        # the fused plan has no cross-attention form (the JAX _fused_ok)
        self.use_fused_block = (use_fused_block
                                and cond_attention != "cross-attention")
        self.bwd = bwd

    def forward(self, x, label_emb=None):
        gamma = self.fn.norm.scale
        if self.use_fused_block:
            return self.fn.fn.forward_fused(x, gamma, label_emb=label_emb,
                                            bwd=self.bwd)
        y = self.fn.fn(channel_layer_norm(x, gamma), label_emb=label_emb)
        return x + y.to(x.dtype)


class Downsample(SpatialConv):
    def __init__(self, dim: int, dtype, padding_mode: str = "zeros"):
        super().__init__(dim, dim, 4, stride=2, padding=1,
                         padding_mode=padding_mode)
        self.dtype = dtype

    def forward(self, x):
        return super().forward(x.to(self.dtype))


class Upsample(SpatialConvTranspose):
    def __init__(self, dim: int, dtype, padding_mode: str = "zeros"):
        super().__init__(dim, padding_mode)
        self.dtype = dtype

    def forward(self, x):
        return super().forward(x.to(self.dtype))


# ------------------------------------------------------------------- UNet


class UNet3D(nn.Module):
    """The denoiser (the JAX UNet3D), from the flagship (per-frame
    conditioning: self-stacked tokens, one a frame, hidden added to the
    time embedding) to the paper's conditioning ablations (per_frame_cond
    False: the CNN hidden, 'self-stacked' / 'cross-attention' / 'none'
    tokens, the GRU's tokens, 'concat' to the time embedding), with or
    without spatial linear attention, in every padding mode, with the
    focus-present mask, the s-tiled temporal plan and checkpointed
    ResnetBlocks (remat_blocks).

    cond_length is the width of the whole-curve conditioning (the tail of
    the CSVs' 51-point curves): the GRU's token count, so the null token's
    length. A token count above what the fused temporal kernels take
    raises a ValueError here, where a fused temporal block would get it."""

    def __init__(self, dim: int = 64, dim_mults: Sequence[int] = (1, 2, 4, 8),
                 channels: int = 3, attn_heads: int = 8,
                 attn_dim_head: int = 32, init_kernel_size: int = 7,
                 use_sparse_linear_attn: bool = True, resnet_groups: int = 8,
                 use_temporal_attention_cond: bool = True,
                 cond_to_time: str = "add", per_frame_cond: bool = True,
                 padding_mode: str = "zeros", num_frames: int = 11,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 use_fused_linear_block: bool | str | int = "all",
                 use_fused_temporal_block: bool | str | int = "all",
                 fused_bwd_kernels: bool = False,
                 temporal_vjp: str | None = None,
                 cond_attention: str = "self-stacked",
                 cond_attention_tokens: int = 16,
                 cond_att_GRU: bool = False,
                 cond_length: int = CURVE_POINTS - 1,
                 remat_blocks: bool = False,
                 temporal_s_tile: int | None = None):
        super().__init__()
        temporal_bwd_mode(temporal_vjp, fused_bwd_kernels)    # validates
        self.remat_blocks = remat_blocks
        linear_bwd = "kernel" if fused_bwd_kernels else "recompute"
        if cond_attention not in COND_ATTENTIONS:
            raise ValueError(f"unknown cond_attention {cond_attention!r}")
        if cond_to_time not in ("add", "concat"):
            raise ValueError(f"unknown cond_to_time {cond_to_time!r}")
        self.dtype = compute_dtype
        self.init_dim = dim
        self.use_temporal_attention_cond = use_temporal_attention_cond
        self.use_sparse_linear_attn = use_sparse_linear_attn
        self.per_frame_cond = per_frame_cond
        self.cond_to_time = cond_to_time
        # per-frame conditioning forces self-stacked tokens, one a frame
        # (the JAX _cond_attention and _cond_tokens)
        cdt = self.cond_attention = ("self-stacked" if per_frame_cond
                                     else cond_attention)
        self.cond_att_GRU = cond_att_GRU and not per_frame_cond
        self.num_tokens = 0 if cdt == "none" else (
            num_frames if per_frame_cond
            else cond_length if self.cond_att_GRU else cond_attention_tokens)
        time_dim = cond_dim = dim * 4
        time_emb_dim = time_dim + cond_dim if cond_to_time == "concat" \
            else cond_dim
        temporal_tokens = (self.num_tokens if cdt == "self-stacked"
                           and use_temporal_attention_cond else 0)

        def temporal(d, tokens=temporal_tokens):
            fused = self._tri_state(use_fused_temporal_block, d)
            if fused and cdt != "cross-attention":
                check_cond_tokens(tokens)
            return TemporalAttentionBlock(
                d, attn_heads, attn_dim_head, cond_dim, compute_dtype, fused,
                temporal_vjp, cdt, per_frame_cond, fused_bwd_kernels,
                temporal_s_tile)

        def linear(d):
            if not use_sparse_linear_attn:
                return nn.Identity()
            return SpatialLinearAttentionBlock(
                d, attn_heads, 32, cond_dim, compute_dtype,
                self._tri_state(use_fused_linear_block, d), linear_bwd, cdt,
                per_frame_cond)

        def res(a, b_, emb=time_emb_dim):
            return ResnetBlock(a, b_, emb, resnet_groups, compute_dtype,
                               padding_mode)

        self.time_rel_pos_bias = RelativePositionBias(
            heads=attn_heads, num_buckets=32, max_distance=32)
        self.init_conv = SpatialConv(channels, dim, init_kernel_size,
                                     padding_mode=padding_mode)
        self.init_temporal_attn = temporal(dim, tokens=0)
        self.time_mlp = nn.Sequential(
            SinusoidalPosEmb(dim), nn.Linear(dim, time_dim),
            nn.GELU(), nn.Linear(time_dim, time_dim))
        chans = (16, 32, 64, 128, cond_dim)
        if per_frame_cond:
            self.sign_emb = nn.Linear(1, cond_dim)
            self.cond_token_to_hidden = nn.Sequential(
                nn.LayerNorm(cond_dim, eps=1e-5),
                nn.Linear(cond_dim, cond_dim), nn.SiLU(),
                nn.Linear(cond_dim, time_dim))
        else:
            self.sign_emb_CNN = SignalEmbedding("CNN", 1, chans)
            if self.cond_att_GRU and cdt != "none":
                self.sign_emb_GRU = SignalEmbedding("GRU", 1, chans)
        if cdt != "none":
            self.null_text_token = nn.Parameter(torch.zeros(
                1, self.num_tokens, cond_dim))
        self.null_text_hidden = nn.Parameter(torch.zeros(1, time_dim))

        dims = [dim, *(dim * m for m in dim_mults)]
        in_out = list(zip(dims[:-1], dims[1:]))
        self.downs = nn.ModuleList()
        for i, (d_in, d_out) in enumerate(in_out):
            last = i == len(in_out) - 1
            self.downs.append(nn.ModuleList([
                res(d_in, d_out), res(d_out, d_out), linear(d_out),
                temporal(d_out),
                nn.Identity() if last else Downsample(d_out, compute_dtype,
                                                      padding_mode)]))
        mid = dims[-1]
        self.mid_block1 = res(mid, mid)
        # the reference builds the mid attention with the default head dim 32
        self.mid_spatial_attn = SpatialAttentionBlock(
            mid, attn_heads, 32, cond_dim, compute_dtype, cdt, per_frame_cond)
        self.mid_temporal_attn = temporal(mid)
        self.mid_block2 = res(mid, mid)
        self.ups = nn.ModuleList()
        for i, (d_in, d_out) in enumerate(reversed(in_out)):
            last = i == len(in_out) - 1
            self.ups.append(nn.ModuleList([
                res(d_out * 2, d_in), res(d_in, d_in), linear(d_in),
                temporal(d_in),
                nn.Identity() if last else Upsample(d_in, compute_dtype,
                                                    padding_mode)]))
        self.final_conv = nn.Sequential(
            res(dim * 2, dim, emb=None), Conv1x1(dim, channels))

    def _tri_state(self, flag, dim: int) -> bool:
        """False | True/'all' (every level) | 'level0' (full resolution) |
        int N (blocks with dim <= N)."""
        if isinstance(flag, bool):
            return flag
        if isinstance(flag, int):
            return dim <= flag
        if flag == "all":
            return True
        if flag == "level0":
            return dim == self.init_dim
        raise ValueError(f"unknown fused-block setting {flag!r}")

    @contextlib.contextmanager
    def fused_plans(self, enabled: bool):
        """With enabled=False, every attention block runs its unfused plan
        inside the block, on the same parameters; enabled=True keeps the
        configured plans."""
        blocks = [m for m in self.modules()
                  if isinstance(m, (TemporalAttentionBlock,
                                    SpatialLinearAttentionBlock))]
        saved = [m.use_fused_block for m in blocks]
        if not enabled:
            for m in blocks:
                m.use_fused_block = False
        try:
            yield self
        finally:
            for m, flag in zip(blocks, saved):
                m.use_fused_block = flag

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Seeded random weights with the JAX package's initializers:
        LeCun-normal kernels, zero biases, unit norm scales, standard
        normal null tokens and bias table."""
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if name in ("null_text_token", "null_text_hidden") \
                    or name.endswith("relative_attention_bias.weight"):
                p.copy_(torch.randn(p.shape, generator=generator))
            elif leaf.startswith("bias"):        # bias, GRU bias_ih_l0 ...
                p.zero_()
            elif leaf == "gamma" or p.dim() == 1:
                p.fill_(1.0)
            else:
                if name.startswith(("ups.", "downs.")) and \
                        isinstance(self.get_submodule(name.rsplit(".", 1)[0]),
                                   SpatialConvTranspose):
                    fan_in = p.shape[0] * p.shape[3] * p.shape[4]
                else:
                    fan_in = int(np.prod(p.shape[1:]))
                p.copy_(torch.randn(p.shape, generator=generator)
                        * fan_in ** -0.5)

    def _res(self, block: ResnetBlock, x, t=None):
        """A ResnetBlock, recomputed in the backward under remat_blocks
        (non-reentrant: grad mode stays on in the first pass and in the
        recompute, so both take the same convolution branch)."""
        if self.remat_blocks and torch.is_grad_enabled():
            return checkpoint(block, x, t, use_reentrant=False,
                              preserve_rng_state=False)
        return block(x, t)

    def forward(self, x, time, cond, null_cond_mask=None,
                focus_present_mask=None, cfg_tiled_pair: bool = False):
        """x: (b, f, h, w, channels) in [-1, 1]; time (b,); cond (b, f)
        per-frame stresses, or (b, cond_length) the whole curve's tail
        without per-frame conditioning; null_cond_mask (b,) bool, True =
        learned null conditioning; focus_present_mask (b,) bool or None,
        True = the sample's temporal queries see their own frame only. With
        cfg_tiled_pair, x arrives at batch b while time, cond and the mask
        arrive CFG-folded at 2b: the conditioning-free init stage runs once
        and is tiled to 2b after it (sampling only: no focus mask). Returns
        the predicted noise, float32, at the time batch."""
        b, f = x.shape[:2]
        if cfg_tiled_pair:
            if time.shape[0] != 2 * b:
                raise ValueError(
                    "cfg_tiled_pair expects untiled x with time/cond folded "
                    f"to 2x its batch; got {b} and {time.shape[0]}")
            if focus_present_mask is not None:
                raise ValueError(
                    "cfg_tiled_pair assumes sampling (no focus mask)")
            b = 2 * b
        x = x.to(self.dtype)
        pos_bias = self.time_rel_pos_bias(f)
        x = self.init_conv(x)
        fmask = focus_present_mask
        x = self.init_temporal_attn(x, pos_bias, focus_present_mask=fmask)
        if cfg_tiled_pair:
            x = torch.cat([x, x], dim=0)
        r = x

        t_emb = self.time_mlp(time)
        if self.per_frame_cond:
            tokens = self.sign_emb(cond.float()[..., None])   # (b, f, cond)
            hidden = self.cond_token_to_hidden(tokens.mean(dim=-2))
        else:
            hidden = self.sign_emb_CNN(cond)                  # (b, cond)
            if self.cond_attention == "none":
                tokens = None
            elif self.cond_att_GRU:
                tokens = self.sign_emb_GRU(cond)              # (b, L, cond)
            else:
                tokens = hidden[:, None].expand(b, self.num_tokens,
                                                hidden.shape[-1])
        if null_cond_mask is None:
            null_cond_mask = torch.zeros(b, dtype=torch.bool,
                                         device=x.device)
        if tokens is not None:
            tokens = torch.where(null_cond_mask[:, None, None],
                                 self.null_text_token.to(tokens.dtype), tokens)
        hidden = torch.where(null_cond_mask[:, None],
                             self.null_text_hidden.to(hidden.dtype), hidden)
        t = (t_emb + hidden if self.cond_to_time == "add"
             else torch.cat([t_emb, hidden], dim=-1))
        tokens_temporal = tokens if self.use_temporal_attention_cond else None

        def lin_block(lin, x):
            if not self.use_sparse_linear_attn:
                return x
            return lin(x, label_emb=tokens)

        def res(block, x, t_=t):
            return self._res(block, x, t_)

        hs = []
        for res1, res2, lin, temporal, down in self.downs:
            x = lin_block(lin, res(res2, res(res1, x)))
            x = temporal(x, pos_bias, label_emb=tokens_temporal,
                         focus_present_mask=fmask)
            hs.append(x)
            x = down(x)
        x = res(self.mid_block1, x)
        x = self.mid_spatial_attn(x, label_emb=tokens)
        x = self.mid_temporal_attn(x, pos_bias, label_emb=tokens_temporal,
                                   focus_present_mask=fmask)
        x = res(self.mid_block2, x)
        for res1, res2, lin, temporal, up in self.ups:
            x = torch.cat([x, hs.pop()], dim=-1)
            x = lin_block(lin, res(res2, res(res1, x)))
            x = temporal(x, pos_bias, label_emb=tokens_temporal,
                         focus_present_mask=fmask)
            x = up(x)
        x = torch.cat([x, r.to(x.dtype)], dim=-1)
        x = res(self.final_conv[0], x, None)
        return self.final_conv[1](x).float()

    @classmethod
    def from_config(cls, cfg: ModelConfig) -> "UNet3D":
        return cls(
            dim=cfg.unet_dim, dim_mults=tuple(cfg.dim_mults),
            channels=cfg.channels, attn_heads=cfg.unet_attn_heads,
            attn_dim_head=cfg.unet_attn_dim_head,
            init_kernel_size=cfg.init_kernel_size,
            use_sparse_linear_attn=cfg.unet_use_sparse_linear_attn,
            resnet_groups=cfg.unet_resnet_groups,
            use_temporal_attention_cond=cfg.unet_temporal_att_cond,
            cond_to_time=cfg.unet_cond_to_time,
            per_frame_cond=cfg.per_frame_cond,
            padding_mode=cfg.padding_mode, num_frames=cfg.num_frames,
            compute_dtype=cfg.torch_dtype,
            use_fused_linear_block=cfg.use_fused_linear_block,
            use_fused_temporal_block=cfg.use_fused_temporal_block,
            fused_bwd_kernels=cfg.fused_bwd_kernels,
            temporal_vjp=cfg.temporal_vjp,
            cond_attention=cfg.unet_cond_attention,
            cond_attention_tokens=cfg.unet_cond_attention_tokens,
            cond_att_GRU=cfg.unet_cond_att_GRU,
            cond_length=cfg.cond_length,
            remat_blocks=cfg.remat_blocks,
            temporal_s_tile=cfg.temporal_s_tile)


def build_unet(cfg: ModelConfig, *, device=None,
               seed: int | None = 0) -> UNet3D:
    """Entry point: the model of `cfg` in eval mode on `device` (the GPU
    unless the caller names another). With a seed its weights are the
    seeded random initialization; with seed=None they are left for
    `load_state_dict`."""
    dev = resolve_device(device)
    set_precision()
    model = UNet3D.from_config(cfg)
    if seed is not None:
        model.init_weights(torch.Generator().manual_seed(seed))
    return model.to(dev).eval()


def state_dict_template(cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """The state dict of cfg's model on the meta device: its names and
    shapes, no data."""
    with torch.device("meta"):
        return UNet3D.from_config(cfg).state_dict()
