"""Whole spatial linear-attention block: stats and apply kernel wrappers and
their plain twins.

Replaces videometamaterials_tpu/ops/pallas/fused_linear_block.py:
_merged_stats_kernel and _merged_apply_kernel. The kernels are
csrc/fused_linear_block.cu; its source note gives the bounds and the
design.

    stats:  z[a] = sum_tok exp(clip(k, +-60))[a]
            ctx[h, a, e] = sum_tok bf16(exp(clip(k)))[h, a] * bf16(v / HW)[h, e]
            (the conditioning tokens counted once)
    apply:  out = x + out_bias + bf16(qn_h @ bf16(ctx_h)) @ W_out with
            qn = bf16(softmax_head(q) * scale / z) (per-head max shift)

Only the eight diagonal (32 x 32) blocks of the TPU kernel's masked
(256 x 256) context are computed: ctx is (B, heads, d, d).
"""

from __future__ import annotations

import torch

from videometamaterials_tpu_torch.ops.cuda import _build
from videometamaterials_tpu_torch.ops.norms import channel_layer_norm

K_CLAMP = 60.0
CHANNELS = (64, 128, 256, 512)
HEADS = 8
HIDDEN = 256
APPLY_TILE = 64


def stats_tile(n: int) -> int:
    """Tokens per block of the stats pass: large tiles keep the partials
    scratch small at full resolution, small ones give the low-resolution
    levels enough blocks."""
    return 256 if n >= 4096 else 64


def _stats_terms(x, gamma, w_qkv, ek, ev, *, heads: int, spatial_size: int):
    """The stats' summands: bf16(exp(clip(k))) and bf16(v / HW), each
    (B, N + Mc, heads, d) over the tokens and then the conditioning tokens,
    and exp(clip(k)) unrounded (B, N + Mc, hidden). Roundings follow x's
    dtype."""
    b = x.shape[0]
    hidden = w_qkv.shape[1] // 3
    cdt = x.dtype
    y = channel_layer_norm(x, gamma, one_pass=False).to(cdt)
    kv = y.float() @ w_qkv[:, hidden:].float()
    k, v = kv[..., :hidden], kv[..., hidden:]
    if ek is not None:
        k = torch.cat([k, ek.float()], dim=1)
        v = torch.cat([v, ev.float()], dim=1)
    pk = torch.exp(k.clamp(-K_CLAMP, K_CLAMP))
    v = (v * (1.0 / spatial_size)).to(cdt).float()
    return (pk.to(cdt).float().reshape(b, -1, heads, hidden // heads),
            v.reshape(b, -1, heads, hidden // heads), pk)


def linear_stats_plain(x, gamma, w_qkv, ek, ev, *, heads: int,
                       spatial_size: int):
    """Plain twin of the stats kernel. x: (B, N, C); w_qkv (C, 3*hidden);
    ek/ev (B, Mc, hidden) or None. Returns ctx (B, heads, d, d) and
    z (B, hidden), float32. Roundings follow x's dtype."""
    pk_r, v, pk = _stats_terms(x, gamma, w_qkv, ek, ev, heads=heads,
                               spatial_size=spatial_size)
    return torch.einsum("bnha,bnhe->bhae", pk_r, v), pk.sum(dim=1)


def linear_stats_magnitude(x, gamma, w_qkv, ek, ev, *, heads: int,
                           spatial_size: int) -> torch.Tensor:
    """sum_tok |bf16(exp(clip(k)))| * |bf16(v / HW)|, (B, heads, d, d): the
    scale of ctx's summands. The kernel's and the twin's f32 projections
    differ in summation order, so a summand's factor near a bf16 rounding
    boundary can round one ulp (2^-7 of it) apart; ctx then differs by a
    share of this, not of |ctx|, which cancellation can make small."""
    pk_r, v, _ = _stats_terms(x, gamma, w_qkv, ek, ev, heads=heads,
                              spatial_size=spatial_size)
    return torch.einsum("bnha,bnhe->bhae", pk_r, v.abs())


def linear_apply_plain(x, gamma, w_qkv, w_out, out_bias, ctx, z, *,
                       heads: int, scale: float) -> torch.Tensor:
    """Plain twin of the apply kernel; returns x + block(x) in x's dtype."""
    b, n, c = x.shape
    hidden = w_out.shape[0]
    d = hidden // heads
    cdt = x.dtype
    y = channel_layer_norm(x, gamma, one_pass=False).to(cdt)
    q = (y.float() @ w_qkv[:, :hidden].float()).reshape(b, n, heads, d)
    e = torch.exp(q - q.amax(dim=-1, keepdim=True))
    brd = scale / e.sum(dim=-1, keepdim=True)
    qn = ((e * brd).reshape(b, n, hidden) * (1.0 / z)[:, None, :]).to(cdt)
    oh = torch.einsum("bnha,bhae->bnhe", qn.float().reshape(b, n, heads, d),
                      ctx.to(cdt).float())
    oh = oh.to(cdt).float().reshape(b, n, hidden)
    out = x.float() + out_bias.float() + oh @ w_out.float()
    return out.to(x.dtype)


def linear_block_plain(x, gamma, w_qkv, w_out, out_bias, ek, ev, *,
                       heads: int, scale: float, spatial_size: int):
    ctx, z = linear_stats_plain(x, gamma, w_qkv, ek, ev, heads=heads,
                                spatial_size=spatial_size)
    return linear_apply_plain(x, gamma, w_qkv, w_out, out_bias, ctx, z,
                              heads=heads, scale=scale)


def _check_common(x, gamma, w_qkv, heads):
    req = _build.require
    req(x.is_cuda, "the kernels take CUDA tensors")
    req(x.dtype == torch.bfloat16 and x.dim() == 3 and x.is_contiguous(),
        "x must be contiguous bf16 (B, N, C)")
    c = x.shape[2]
    req(c in CHANNELS, f"the kernels take C in {CHANNELS}, got {c}")
    req(heads == HEADS, f"the kernels take {HEADS} heads of 32")
    req(gamma.dtype == torch.float32 and tuple(gamma.shape) == (c,)
        and gamma.is_contiguous(), "gamma must be contiguous float32 (C,)")
    req(w_qkv.dtype == torch.bfloat16 and w_qkv.is_contiguous()
        and tuple(w_qkv.shape) == (c, 3 * HIDDEN),
        "w_qkv must be contiguous bf16 (C, 3*hidden)")
    for t in (gamma, w_qkv):
        req(t.device == x.device, "all operands on x's device")


def linear_stats(x, gamma, w_qkv, ek, ev, *, heads: int, spatial_size: int):
    """(ctx, z) of the block. A CPU tensor takes the plain twin; a CUDA
    tensor launches the kernel (partials pass + ordered reduce) or raises."""
    if x.device.type == "cpu":
        return linear_stats_plain(x, gamma, w_qkv, ek, ev, heads=heads,
                                  spatial_size=spatial_size)
    _check_common(x, gamma, w_qkv, heads)
    b, n, c = x.shape
    req = _build.require
    req((ek is None) == (ev is None), "ek and ev come together")
    m_c = 0
    if ek is not None:
        m_c = ek.shape[1]
        for t in (ek, ev):
            req(t.dtype == torch.bfloat16 and t.is_contiguous()
                and tuple(t.shape) == (b, m_c, HIDDEN)
                and t.device == x.device,
                "ek/ev must be contiguous bf16 (B, Mc, hidden) on x's device")
    tile = stats_tile(n)
    n_tiles = -(-n // tile)
    f32 = dict(dtype=torch.float32, device=x.device)
    part_ctx = torch.empty((b, n_tiles, 32, HIDDEN), **f32)
    part_z = torch.empty((b, n_tiles, HIDDEN), **f32)
    ctx = torch.empty((b, HEADS, 32, 32), **f32)
    z = torch.empty((b, HIDDEN), **f32)
    lib = _build.load_library()
    p = _build.ptr
    err = lib.vmt_linear_stats(
        p(x), p(gamma), p(w_qkv), p(ek), p(ev), p(part_ctx), p(part_z),
        p(ctx), p(z), b, n, c, m_c, heads, tile, 1.0 / spatial_size,
        _build.stream_handle(x.device))
    _build.check_launch(lib, err, "linear_stats")
    _build.LAUNCH_COUNTS["linear_stats"] += 1
    return ctx, z


def linear_apply(x, gamma, w_qkv, w_out, out_bias, ctx, z, *, heads: int,
                 scale: float) -> torch.Tensor:
    """x + block(x) from the stats. A CPU tensor takes the plain twin; a
    CUDA tensor launches the kernel or raises."""
    if x.device.type == "cpu":
        return linear_apply_plain(x, gamma, w_qkv, w_out, out_bias, ctx, z,
                                  heads=heads, scale=scale)
    _check_common(x, gamma, w_qkv, heads)
    b, n, c = x.shape
    req = _build.require
    req(w_out.dtype == torch.bfloat16 and w_out.is_contiguous()
        and tuple(w_out.shape) == (HIDDEN, c),
        "w_out must be contiguous bf16 (hidden, C)")
    req(out_bias.dtype == torch.float32 and out_bias.is_contiguous()
        and tuple(out_bias.shape) == (c,), "out_bias must be float32 (C,)")
    req(ctx.dtype == torch.float32 and ctx.is_contiguous()
        and tuple(ctx.shape) == (b, HEADS, 32, 32),
        "ctx must be contiguous float32 (B, heads, d, d)")
    req(z.dtype == torch.float32 and z.is_contiguous()
        and tuple(z.shape) == (b, HIDDEN), "z must be float32 (B, hidden)")
    for t in (w_out, out_bias, ctx, z):
        req(t.device == x.device, "all operands on x's device")
    out = torch.empty_like(x)
    lib = _build.load_library()
    p = _build.ptr
    err = lib.vmt_linear_apply(
        p(x), p(gamma), p(w_qkv), p(w_out), p(out_bias), p(ctx), p(z),
        p(out), b, n, c, heads, APPLY_TILE, scale,
        _build.stream_handle(x.device))
    _build.check_launch(lib, err, "linear_apply")
    _build.LAUNCH_COUNTS["linear_apply"] += 1
    return out


def fused_linear_block(x, gamma, w_qkv, w_out, out_bias, ek, ev, *,
                       heads: int, scale: float, spatial_size: int):
    """x: (B, N, C) with frames folded into B; w_qkv (C, 3*hidden);
    w_out (hidden, C); out_bias (C,); ek/ev (B, Mc, hidden) or None.
    Returns x + block(x)."""
    ctx, z = linear_stats(x, gamma, w_qkv, ek, ev, heads=heads,
                          spatial_size=spatial_size)
    return linear_apply(x, gamma, w_qkv, w_out, out_bias, ctx, z,
                        heads=heads, scale=scale)
