"""Whole spatial linear-attention block: stats, apply, head-layout and
backward kernel wrappers, their plain twins and the differentiable entry
point.

Replaces videometamaterials_tpu/ops/pallas/fused_linear_block.py:
_merged_stats_kernel and _merged_apply_kernel, and _kernel, the "head"
layout (csrc/fused_linear_block.cu, the apply's head mode after the
backward's stats pass), and both
backward kernels, _bwd_kernel (per-head) and _bwd_kernel_merged
(csrc/fused_linear_block_bwd.cu, one source with a clip flag); each source
note gives the bounds and the design. `fused_linear_block` is the JAX
package's custom VJP as a torch.autograd.Function: the forward of the
layout ('merged': stats + apply; 'head': the head-layout kernel) on the
primals, which are saved, and a backward that is autograd through the JAX
package's reference_linear_block ('recompute', the JAX default) or the
backward kernel ('kernel'), routed per-head or merged by the JAX rule
(`bwd_route`).

    stats:  z[a] = sum_tok exp(clip(k, +-60))[a]
            ctx[h, a, e] = sum_tok bf16(exp(clip(k)))[h, a] * bf16(v / HW)[h, e]
            (the conditioning tokens counted once)
    apply:  out = x + out_bias + bf16(qn_h @ bf16(ctx_h)) @ W_out with
            qn = bf16(softmax_head(q) * scale / z) (per-head max shift)
    head:   out = bf16(x + out_bias + sum_h (softmax_d(q_h) scale)
                  (softmax_tok(k_h)^T v_h / HW) W_out_h), unclamped and
            max-shifted, float32 after the bf16 LN output (the kernel's
            products past q on the tensor cores to a bf16 hi + lo split)

Only the eight diagonal (32 x 32) blocks of the TPU kernel's masked
(256 x 256) context are computed: ctx is (B, heads, d, d).
"""

from __future__ import annotations

import os

import torch

from videometamaterials_tpu_torch.ops.attention import (
    linear_attention_tokens_first,
)
from videometamaterials_tpu_torch.ops.cuda import _build
from videometamaterials_tpu_torch.ops.norms import channel_layer_norm

K_CLAMP = 60.0
CHANNELS = (64, 128, 256, 512)
HEADS = 8
HIDDEN = 256
# tokens an apply block (the M of its tensor-core products); the stats
# tiles are multiples of it, walked in sub-tiles of 64
APPLY_TILE = 64
# the JAX _core_bwd route (fused_linear_block.py:580-586): the merged
# backward is untiled there, so it takes only shapes whose ~12 live
# (N, hidden) f32 arrays fit in 40 MiB; larger ones go per-head
ROUTE_BYTES = 40 * 2 ** 20
LAYOUTS = ("merged", "head")


def stats_tile(n: int) -> int:
    """Tokens per block of the stats pass, a multiple of APPLY_TILE: large
    tiles keep the partials scratch small at full resolution, small ones
    give the low-resolution levels enough blocks."""
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


def _check_cond(ek, ev, x) -> int:
    """Check the conditioning K/V of a kernel launch; returns Mc."""
    req = _build.require
    req((ek is None) == (ev is None), "ek and ev come together")
    if ek is None:
        return 0
    for t in (ek, ev):
        req(t.dtype == torch.bfloat16 and t.is_contiguous()
            and tuple(t.shape) == (x.shape[0], ek.shape[1], HIDDEN)
            and t.device == x.device,
            "ek/ev must be contiguous bf16 (B, Mc, hidden) on x's device")
    return ek.shape[1]


def linear_stats(x, gamma, w_qkv, ek, ev, *, heads: int, spatial_size: int):
    """(ctx, z) of the block. A CPU tensor takes the plain twin; a CUDA
    tensor launches the kernel (partials pass + ordered reduce) or raises."""
    if x.device.type == "cpu":
        return linear_stats_plain(x, gamma, w_qkv, ek, ev, heads=heads,
                                  spatial_size=spatial_size)
    _check_common(x, gamma, w_qkv, heads)
    b, n, c = x.shape
    m_c = _check_cond(ek, ev, x)
    _build.require_aligned(x, w_qkv)
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
    _build.require_aligned(x, w_qkv, w_out, out_bias, ctx, z)
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


def linear_block_fwd(x, gamma, w_qkv, w_out, out_bias, ek, ev, *,
                     heads: int, scale: float, spatial_size: int):
    """x: (B, N, C) with frames folded into B; w_qkv (C, 3*hidden);
    w_out (hidden, C); out_bias (C,); ek/ev (B, Mc, hidden) or None.
    Returns x + block(x): the stats and apply kernels (their twins on a CPU
    tensor)."""
    ctx, z = linear_stats(x, gamma, w_qkv, ek, ev, heads=heads,
                          spatial_size=spatial_size)
    return linear_apply(x, gamma, w_qkv, w_out, out_bias, ctx, z,
                        heads=heads, scale=scale)


def linear_block_head_plain(x, gamma, w_qkv, w_out, out_bias, ek, ev, *,
                            heads: int, scale: float, spatial_size: int):
    """Plain twin of the head-layout kernel (the JAX _kernel, :336-411):
    y = LN(x) gamma (two-pass) rounded to x's dtype; then float32
    throughout: q, k, v from w_qkv rounded to x's dtype, the q feature
    softmax times scale, the token softmax over [cond || tokens] max-shifted
    and unclamped, ctx = pk^T (v / HW) per head, oh = q ctx, and
    x + out_bias + oh @ W_out with W_out as given (float32 there); one
    rounding to x's dtype at the end."""
    b, n, _ = x.shape
    hidden = w_out.shape[0]
    d = hidden // heads
    y = channel_layer_norm(x, gamma, one_pass=False).to(x.dtype).float()
    q, k, v = (y @ w_qkv.to(x.dtype).float()).split(hidden, dim=-1)
    q = q.reshape(b, n, heads, d)
    q = torch.exp(q - q.amax(dim=-1, keepdim=True))
    q = q * (scale / q.sum(dim=-1, keepdim=True))
    if ek is not None:
        k = torch.cat([ek.float(), k], dim=1)
        v = torch.cat([ev.float(), v], dim=1)
    m = k.shape[1]
    k = k.reshape(b, m, heads, d)
    pk = torch.exp(k - k.amax(dim=1, keepdim=True))
    pk = pk / pk.sum(dim=1, keepdim=True)
    ctx = torch.einsum("bmha,bmhe->bhae", pk,
                       v.reshape(b, m, heads, d) * (1.0 / spatial_size))
    oh = torch.einsum("bnha,bhae->bnhe", q, ctx).reshape(b, n, hidden)
    out = x.float() + out_bias.float() + oh @ w_out.float()
    return out.to(x.dtype)


def linear_block_head(x, gamma, w_qkv, w_out, out_bias, ek, ev, *,
                      heads: int, scale: float, spatial_size: int):
    """x + block(x) through the head-layout kernel (its operands as
    linear_block_fwd's). A CPU tensor takes the plain twin; a CUDA tensor
    launches the kernel (online-max stats, ordered merge, apply) or
    raises. W_out is bf16 here: the JAX model hands its kernel a weight
    cast to the compute dtype, which it then reads in float32; the
    kernel's out-projection takes those bf16 values exactly against the hi
    and lo bf16 parts of the float32 oh."""
    if x.device.type == "cpu":
        return linear_block_head_plain(x, gamma, w_qkv, w_out, out_bias, ek,
                                       ev, heads=heads, scale=scale,
                                       spatial_size=spatial_size)
    _check_common(x, gamma, w_qkv, heads)
    b, n, c = x.shape
    req = _build.require
    req(w_out.dtype == torch.bfloat16 and w_out.is_contiguous()
        and tuple(w_out.shape) == (HIDDEN, c) and w_out.device == x.device,
        "w_out must be contiguous bf16 (hidden, C)")
    req(out_bias.dtype == torch.float32 and out_bias.is_contiguous()
        and tuple(out_bias.shape) == (c,) and out_bias.device == x.device,
        "out_bias must be float32 (C,)")
    m_c = _check_cond(ek, ev, x)
    _build.require_aligned(x, w_qkv, w_out, out_bias, ek, ev)
    lib = _build.load_library()
    out = torch.empty_like(x)
    ws = _build.workspace(lib.vmt_linear_head_workspace(b, n), x.device)
    p = _build.ptr
    err = lib.vmt_linear_head(
        p(x), p(gamma), p(w_qkv), p(w_out), p(out_bias), p(ek), p(ev),
        p(out), p(ws), b, n, c, m_c, heads, APPLY_TILE, scale,
        1.0 / spatial_size, _build.stream_handle(x.device))
    _build.check_launch(lib, err, "linear_block_head")
    _build.LAUNCH_COUNTS["linear_head"] += 1
    return out


def bwd_route(n: int, hidden: int = HIDDEN, layout: str = "merged") -> str:
    """The backward kernel the JAX package takes (_core_bwd, :574-588): for
    the merged layout 'head' where 12 * N * hidden * 4 B is above 40 MiB
    (the merged backward is untiled there), else 'merged'; for the head
    layout 'head' at every N."""
    if layout == "head":
        return "head"
    return "head" if 12 * n * hidden * 4 > ROUTE_BYTES else "merged"


def linear_block_softmax_plain(x, gamma, w_qkv, w_out, out_bias, ek, ev, *,
                               heads: int, scale: float, spatial_size: int):
    """The block in the form the merged backward kernel differentiates: y
    rounded to x's dtype, then float32 with a max-shifted token softmax of
    k clamped to +-60, with no gradient where |k| >= 60 (the JAX merged
    backward's where form, fused_linear_block.py:311, :315). The per-head
    backward differentiates the head layout's forward
    (linear_block_head_plain), as the JAX _bwd_kernel mirrors _kernel."""
    b, n, _ = x.shape
    hidden = w_out.shape[0]
    d = hidden // heads
    y = channel_layer_norm(x, gamma, one_pass=False).to(x.dtype).float()
    q, k, v = (y @ w_qkv.float()).split(hidden, dim=-1)
    if ek is not None:
        k = torch.cat([ek.float(), k], dim=1)
        v = torch.cat([ev.float(), v], dim=1)
    k = torch.where(k.abs() < K_CLAMP, k, k.detach().clamp(-K_CLAMP, K_CLAMP))
    m = k.shape[1]
    pk = torch.softmax(k.reshape(b, m, heads, d), dim=1)
    ctx = torch.einsum("bmha,bmhe->bhae", pk,
                       v.reshape(b, m, heads, d) / spatial_size)
    qs = torch.softmax(q.reshape(b, n, heads, d), dim=-1) * scale
    oh = torch.einsum("bnha,bhae->bnhe", qs, ctx).reshape(b, n, hidden)
    out = x.float() + out_bias.float() + oh @ w_out.float()
    return out.to(x.dtype)


def linear_block_bwd_plain(x, gamma, w_qkv, w_out, out_bias, ek, ev, g, *,
                           heads: int, scale: float, spatial_size: int,
                           route: str):
    """Plain twin of the backward kernel: autograd through the forward it
    differentiates, linear_block_softmax_plain (clamped) on the merged
    route and linear_block_head_plain (unclamped) on the per-head one, at
    the weights rounded to x's dtype. Returns (dx, dgamma, dw_qkv, dw_out,
    dout_bias, dek, dev); dx in x's dtype, the rest float32, dek/dev None
    without conditioning tokens."""
    cdt = x.dtype
    fwd = (linear_block_softmax_plain if route == "merged"
           else linear_block_head_plain)
    return _build.plain_cotangents(fwd, x, g,
                  (gamma, w_qkv.to(cdt), w_out.to(cdt), out_bias,
                   None if ek is None else ek.to(cdt),
                   None if ev is None else ev.to(cdt)),
                  heads=heads, scale=scale, spatial_size=spatial_size)


def reference_linear_block(x, gamma, w_qkv, w_out, out_bias, ek, ev, *,
                           heads: int, scale: float, spatial_size: int):
    """Own copy of the JAX package's reference_linear_block
    (fused_linear_block.py:518-547), with its roundings: y = one-pass
    LN(x) gamma in x's dtype, qkv in that dtype, the conditioning K/V
    stacked in front, linear_attention_tokens_first (max-shifted and
    unclamped; its out in the compute dtype), the out-projection and
    out_bias in the compute dtype, then the residual. It is the function
    the JAX 'recompute' backward differentiates, for both layouts; the
    forward kernels and their twins keep the stats' +-60 clamp."""
    b, n, _ = x.shape
    hidden = w_out.shape[0]
    d = hidden // heads
    y = channel_layer_norm(x, gamma)
    qkv = torch.einsum("bnc,ce->bne", y, w_qkv.to(y.dtype))
    q, k, v = (t.reshape(b, n, heads, d) for t in qkv.split(hidden, dim=-1))
    if ek is not None:
        k = torch.cat([ek.to(k.dtype).reshape(b, -1, heads, d), k], dim=1)
        v = torch.cat([ev.to(v.dtype).reshape(b, -1, heads, d), v], dim=1)
    out = linear_attention_tokens_first(q, k, v, scale=scale,
                                        spatial_size=spatial_size)
    out = torch.einsum("bnh,hc->bnc", out.reshape(b, n, hidden),
                       w_out.to(out.dtype))
    out = out + out_bias.to(out.dtype)
    return x + out.to(x.dtype)


def linear_block_recompute(x, gamma, w_qkv, w_out, out_bias, ek, ev, g, *,
                           heads: int, scale: float, spatial_size: int):
    """The default backward: autograd through reference_linear_block, as
    the JAX 'recompute' _core_bwd (:589-594) takes jax.vjp of it, in
    linear_block_bwd_plain's result order."""
    cdt = x.dtype
    return _build.plain_cotangents(reference_linear_block, x, g,
                  (gamma, w_qkv.to(cdt), w_out.to(cdt), out_bias,
                   None if ek is None else ek.to(cdt),
                   None if ev is None else ev.to(cdt)),
                  heads=heads, scale=scale, spatial_size=spatial_size)


def linear_block_bwd(x, gamma, w_qkv, w_out, out_bias, ek, ev, g, *,
                     heads: int, scale: float, spatial_size: int,
                     route: str):
    """All cotangents of the block (linear_block_bwd_plain's order) on the
    given route ('head' or 'merged'). A CPU tensor takes the plain twin; a
    CUDA tensor launches the backward kernel or raises."""
    if route not in ("head", "merged"):
        raise ValueError(f"unknown backward route {route!r}")
    if x.device.type == "cpu":
        return linear_block_bwd_plain(x, gamma, w_qkv, w_out, out_bias, ek,
                                      ev, g, heads=heads, scale=scale,
                                      spatial_size=spatial_size, route=route)
    _check_common(x, gamma, w_qkv, heads)
    b, n, c = x.shape
    req = _build.require
    req(w_out.dtype == torch.bfloat16 and tuple(w_out.shape) == (HIDDEN, c)
        and w_out.device == x.device, "w_out must be bf16 (hidden, C)")
    req(g.dtype == x.dtype and g.shape == x.shape and g.is_contiguous()
        and g.device == x.device, "g must be contiguous, of x's shape and dtype")
    m_c = _check_cond(ek, ev, x)
    lib = _build.load_library()
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    dgamma = torch.empty((c,), **f32)
    dw_qkv = torch.empty((c, 3 * HIDDEN), **f32)
    dw_out = torch.empty((HIDDEN, c), **f32)
    dout_bias = torch.empty((c,), **f32)
    dek = torch.empty((b, m_c, HIDDEN), **f32) if m_c else None
    dev = torch.empty((b, m_c, HIDDEN), **f32) if m_c else None
    ws = _build.workspace(lib.vmt_linear_block_bwd_workspace(b, n, c),
                          x.device)
    w_out_t = w_out.t().contiguous()
    _build.require_aligned(x, w_qkv, w_out_t, g, ek, ev)
    p = _build.ptr
    err = lib.vmt_linear_block_bwd(
        p(x), p(gamma), p(w_qkv), p(w_out_t), p(ek), p(ev), p(g), p(dx),
        p(dgamma), p(dw_qkv), p(dw_out), p(dout_bias), p(dek), p(dev), p(ws),
        b, n, c, m_c, heads, scale, 1.0 / spatial_size,
        int(route == "merged"), _build.stream_handle(x.device))
    _build.check_launch(lib, err, f"linear_block_bwd ({route})")
    _build.LAUNCH_COUNTS[f"linear_bwd_{route}"] += 1
    return dx, dgamma, dw_qkv, dw_out, dout_bias, dek, dev


class _FusedLinearBlock(torch.autograd.Function):
    """The JAX custom VJP (fused_linear_block.py:550-745): the layout's
    forward on the primals, which are saved; the backward recomputes
    through reference_linear_block or runs the backward kernel on the JAX
    route."""

    @staticmethod
    def forward(ctx, x, gamma, w_qkv, w_out, out_bias, ek, ev, heads, scale,
                spatial_size, bwd, layout):
        cdt = x.dtype
        w_qkv, w_out = w_qkv.to(cdt).contiguous(), w_out.to(cdt).contiguous()
        ctx.kw = dict(heads=heads, scale=scale, spatial_size=spatial_size)
        ctx.bwd, ctx.layout = bwd, layout
        ctx.save_for_backward(x, gamma, w_qkv, w_out, out_bias, ek, ev)
        fwd = linear_block_head if layout == "head" else linear_block_fwd
        return fwd(x, gamma, w_qkv, w_out, out_bias, ek, ev, **ctx.kw)

    @staticmethod
    def backward(ctx, g):
        args = ctx.saved_tensors
        if ctx.bwd == "kernel":
            route = bwd_route(args[0].shape[1], layout=ctx.layout)
            grads = linear_block_bwd(*args, g.contiguous(), **ctx.kw,
                                     route=route)
        else:
            grads = linear_block_recompute(*args, g, **ctx.kw)
        return (*grads, None, None, None, None, None)


def fused_linear_block(x, gamma, w_qkv, w_out, out_bias, ek, ev, *,
                       heads: int, scale: float, spatial_size: int,
                       bwd: str = "recompute", layout: str | None = None):
    """x + block(x), differentiable in every operand. x: (B, N, C) in the
    compute dtype; w_qkv/w_out in any float dtype (cast to x's inside, so
    float32 weights get float32 gradients); bwd: 'recompute' (autograd
    through reference_linear_block) or 'kernel' (the backward kernel; its
    twin on the CPU); layout: 'merged' (stats + apply) or 'head' (the
    head-layout kernel), None resolving VMT_LINEAR_LAYOUT, then 'merged',
    as the JAX entry point does (fused_linear_block.py:904-906)."""
    if bwd not in ("recompute", "kernel"):
        raise ValueError(f"unknown backward plan {bwd!r}")
    if layout is None:
        layout = os.environ.get("VMT_LINEAR_LAYOUT", "merged")
    if layout not in LAYOUTS:
        raise ValueError(f"unknown linear layout {layout!r}")
    return _FusedLinearBlock.apply(x, gamma, w_qkv, w_out, out_bias, ek, ev,
                                   heads, scale, spatial_size, bwd, layout)
