"""Whole temporal-attention block: CUDA kernel wrappers, their plain twins
and the differentiable entry point.

Replaces videometamaterials_tpu/ops/pallas/fused_temporal_block.py:_kernel
(the split softmax layout, and the merged layout with emit_p, which also
writes the softmax weights p; both csrc/fused_temporal_block.cu and
csrc/any_shape.cu) and _bwd_kernel (csrc/fused_temporal_block_bwd.cu and
csrc/any_shape_bwd.cu); each source note gives the bound and the design.
`fused_temporal_block` is the JAX package's custom VJP as a
torch.autograd.Function: the forward kernel, the primal inputs
saved, and a backward that is autograd through the plain twin
('recompute', the JAX default) or the backward kernel ('kernel'); or the
'saved' plan (the JAX fused_temporal_block_savedp): the forward kernel
emits p, which is saved with the primals, and temporal_bwd_from_p (plain
torch, as the JAX function is XLA) backs it through.

    out = x + W_out . softmax_j(q_i.k_j + bias_ij || q_i.ek_t + bias_it)
                    . [v_j || ev_t]

per spatial position over the F frames (+ T conditioning tokens: 11 on
the flagship, 0 in the init block, 6, 16 or 50 on the conditioning
ablations, any number beside), with LN scale-only and two-pass, rotary and
1/sqrt(d) folded into the per-frame `w_all`, and bf16 roundings at qkv, at
the softmax weights and at the value sum (the JAX kernel's :124, :226,
:235).

Rows 1, 2 (the emit_p forward) and 3 (the backward) have two instances
each, picked from the shape alone (`forward_instance`): the specialised
kernels (csrc/fused_temporal_block.cu, csrc/fused_temporal_block_bwd.cu)
at the flagship's shapes (F = 11, 8 heads of 32, C in CHANNELS, T <=
MAX_COND_TOKENS) and the any-shape kernels (csrc/any_shape.cu,
csrc/any_shape_bwd.cu) at every other shape the JAX kernels take.

The JAX package's switches are read where it reads them: VMT_TEMPORAL_VJP
in `config.temporal_bwd_mode`, VMT_TEMPORAL_BWD_KERNEL=1 in the backward
(the backward kernel under the 'recompute' plan too, :480-488), and
VMT_TEMPORAL_SOFTMAX ('split' or 'merged', default 'split') in
`fused_temporal_block`, which validates it. Split and merged are two TPU
layouts of one function, and the port's merged instance (the emit_p
kernel, row 2) gives an `out` bit-equal to the split one's (row 1;
chip_smoke.py phase 2). So 'merged' runs row 1 where nothing reads p, and
the emit_p kernel under the 'saved' plan, which forces merged in the JAX
package as well.

`reference_temporal_block` is the port's copy of the JAX XLA twin
(fused_temporal_block.py:413-459): what the JAX s-tiled plan runs on each
tile, with the unfused path's LayerNorm (one-pass unless
VMT_ONEPASS_NORMS=0) and no rounding of the softmax weights.
"""

from __future__ import annotations

import os

import torch

from videometamaterials_tpu_torch.ops.cuda import _build
from videometamaterials_tpu_torch.ops.norms import channel_layer_norm

FRAMES = 11
CHANNELS = (64, 128, 256, 512)
HEADS = 8
HIDDEN = 256
# the specialised kernels pad a position's F + T keys to 32, 64 or 80
# (csrc/fused_temporal_block.cu: kMaxKeys)
MAX_COND_TOKENS = 80 - FRAMES
# the instances of rows 1-3 (`forward_instance`)
SPECIALISED, ANY_SHAPE = "specialised", "any"


def check_cond_tokens(t_tok: int) -> None:
    """Raise ValueError for a count of conditioning tokens the specialised
    kernels of rows 1-3 do not take (the any-shape instances take any)."""
    if not 0 <= t_tok <= MAX_COND_TOKENS:
        raise ValueError(
            f"the specialised fused temporal kernels take 0 to "
            f"{MAX_COND_TOKENS} conditioning tokens (F + T <= "
            f"{MAX_COND_TOKENS + FRAMES} keys a position), got {t_tok}; "
            "more take the any-shape instances")


def forward_instance(f: int, heads: int, dim_head: int, c: int,
                     t_tok: int) -> str:
    """The instance of rows 1, 2 and 3 a launch at this shape takes:
    SPECIALISED (LAUNCH_COUNTS entries 'fused_temporal_block',
    'temporal_fwd_p', 'temporal_bwd') at the flagship's shapes, ANY_SHAPE
    ('temporal_block_any', 'temporal_fwd_p_any', 'temporal_bwd_any') at
    every other. A pure function of the shape."""
    if (f == FRAMES and heads == HEADS and heads * dim_head == HIDDEN
            and c in CHANNELS and 0 <= t_tok <= MAX_COND_TOKENS):
        return SPECIALISED
    return ANY_SHAPE


def temporal_block_plain(x, gamma, w_all, w_out, ek, ev, bias_all, *,
                         heads: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch (the pattern of the JAX
    package's reference_temporal_block, with the kernel's roundings).
    x: (B, F, S, C); gamma (C,); w_all (F, C, 3*hidden); w_out (hidden, C);
    ek/ev (B, T, hidden) or None; bias_all (F, F+T, heads) float32.
    Roundings follow w_all's dtype (none in float32)."""
    return _plain(x, gamma, w_all, w_out, ek, ev, bias_all, heads=heads)[0]


def temporal_block_plain_p(x, gamma, w_all, w_out, ek, ev, bias_all, *,
                           heads: int):
    """temporal_block_plain's (out, p): p (B, F, S, (F+T)*heads) holds the
    softmax weights the value sum consumes, in w_all's dtype, with lanes
    key-group-major (jg * heads + h), the JAX merged layout's p_all."""
    out, p = _plain(x, gamma, w_all, w_out, ek, ev, bias_all, heads=heads)
    b, f, s, _ = x.shape
    return out, p.permute(0, 1, 3, 2, 4).reshape(b, f, s, -1)


def _plain(x, gamma, w_all, w_out, ek, ev, bias_all, *, heads: int):
    """(out, p) with p (B, F, F+T, S, heads), the twins' one body: the
    kernel's two stages composed."""
    acc, p = temporal_attn_plain(x, gamma, w_all, ek, ev, bias_all,
                                 heads=heads)
    return temporal_outproj_plain(x, acc, w_out), p


def temporal_attn_plain(x, gamma, w_all, ek, ev, bias_all, *, heads: int):
    """The kernel's first stage in plain PyTorch: (acc, p), acc (B, F, S,
    hidden) the value sum rounded to w_all's dtype (the JAX kernel's :235,
    where the CUDA kernel splits into its two launches), p (B, F, F+T, S,
    heads) the softmax weights the value sum consumes."""
    b, f, s, c = x.shape
    hidden = w_all.shape[-1] // 3
    d = hidden // heads
    cdt = w_all.dtype
    y = channel_layer_norm(x, gamma, one_pass=False).to(cdt)
    qkv = torch.einsum("bfsc,fch->bfsh", y.float(), w_all.float()).to(cdt)
    q, k, v = (t.float().reshape(b, f, s, heads, d)
               for t in qkv.split(hidden, dim=-1))
    bias = bias_all.float()
    sim = torch.einsum("bishd,bjshd->bijsh", q, k) + bias[None, :, :f, None, :]
    if ek is not None:
        t_tok = ek.shape[1]
        ekh = ek.float().reshape(b, t_tok, heads, d)
        evh = ev.float().reshape(b, t_tok, heads, d)
        sim_c = (torch.einsum("bishd,bthd->bitsh", q, ekh)
                 + bias[None, :, f:, None, :])
        sim = torch.cat([sim, sim_c], dim=2)
    p = torch.softmax(sim, dim=2).to(cdt)
    pf = p.float()
    acc = torch.einsum("bijsh,bjshd->bishd", pf[:, :, :f], v)
    if ek is not None:
        acc = acc + torch.einsum("bitsh,bthd->bishd", pf[:, :, f:], evh)
    return acc.to(cdt).reshape(b, f, s, hidden), p


def temporal_outproj_plain(x, acc, w_out) -> torch.Tensor:
    """The kernel's second stage in plain PyTorch: x + acc @ w_out, summed
    in float32 and rounded to x's dtype."""
    out = torch.einsum("bfsh,hc->bfsc", acc.float(), w_out.float())
    return (x.float() + out).to(x.dtype)


def reference_temporal_block(x, gamma, w_all, w_out, ek, ev, bias_all, *,
                             heads: int) -> torch.Tensor:
    """Own copy of the JAX package's reference_temporal_block: x + block(x)
    with the unfused path's LayerNorm statistics, qkv and the value sum
    rounded to w_all's dtype, the softmax in float32, and the
    out-projection and the residual add in that dtype. Shapes as
    temporal_block_plain's."""
    b, f, s, c = x.shape
    hidden = w_out.shape[0]
    d = hidden // heads
    dt = w_all.dtype
    y = channel_layer_norm(x, gamma).to(dt)
    qkv = torch.einsum("bfsc,fch->bfsh", y, w_all)
    q, k, v = (t.reshape(b, f, s, heads, d).float()
               for t in qkv.split(hidden, dim=-1))
    bias = bias_all.float()
    sim = torch.einsum("bishd,bjshd->bijsh", q, k) + bias[None, :, :f, None, :]
    if ek is not None:
        t_tok = ek.shape[1]
        ekh = ek.float().reshape(b, t_tok, heads, d)
        evh = ev.float().reshape(b, t_tok, heads, d)
        sim_c = (torch.einsum("bishd,bthd->bitsh", q, ekh)
                 + bias[None, :, f:, None, :])
        p = torch.softmax(torch.cat([sim, sim_c], dim=2), dim=2)
        out = (torch.einsum("bijsh,bjshd->bishd", p[:, :, :f], v)
               + torch.einsum("bitsh,bthd->bishd", p[:, :, f:], evh))
    else:
        out = torch.einsum("bijsh,bjshd->bishd", torch.softmax(sim, dim=2), v)
    out = out.to(dt).reshape(b, f, s, hidden)
    out = torch.einsum("bfsh,hc->bfsc", out, w_out.to(dt))
    return x + out.to(x.dtype)


def _check(x, gamma, w_all, w_out, ek, ev, bias_all, heads,
           specialised: bool = True) -> int:
    """The operands of a launch of row 1, 2 or 3; `specialised` adds the
    specialised kernels' shapes (F = 11, 8 heads of 32, C in CHANNELS, at
    most MAX_COND_TOKENS tokens, aligned rows). Returns dim_head."""
    req = _build.require
    req(x.is_cuda, "the kernel takes CUDA tensors")
    req(x.dtype == torch.bfloat16 and x.dim() == 4 and x.is_contiguous(),
        "x must be contiguous bf16 (B, F, S, C)")
    b, f, s, c = x.shape
    hidden = w_out.shape[0]
    t_tok = 0 if ek is None else ek.shape[1]
    if specialised:
        req(f == FRAMES, f"the kernel takes {FRAMES} frames, got {f}")
        req(c in CHANNELS, f"the kernel takes C in {CHANNELS}, got {c}")
        req(heads == HEADS and hidden == HIDDEN,
            f"the kernel takes {HEADS} heads of 32 and w_out ({HIDDEN}, C)")
        check_cond_tokens(t_tok)
    req(heads > 0 and hidden > 0 and hidden % heads == 0,
        f"hidden {hidden} is not a multiple of {heads} heads")
    req(gamma.dtype == torch.float32 and tuple(gamma.shape) == (c,)
        and gamma.is_contiguous(), "gamma must be contiguous float32 (C,)")
    req(w_all.dtype == torch.bfloat16 and w_all.is_contiguous()
        and tuple(w_all.shape) == (f, c, 3 * hidden),
        "w_all must be contiguous bf16 (F, C, 3*hidden)")
    req(w_out.dtype == torch.bfloat16 and w_out.is_contiguous()
        and tuple(w_out.shape) == (hidden, c),
        "w_out must be contiguous bf16 (hidden, C)")
    req(bias_all.dtype == torch.float32 and bias_all.is_contiguous()
        and tuple(bias_all.shape) == (f, f + t_tok, heads),
        "bias_all must be contiguous float32 (F, F+T, heads)")
    req((ek is None) == (ev is None), "ek and ev come together")
    for t in (ek, ev):
        req(t is None or (t.dtype == torch.bfloat16 and t.is_contiguous()
                          and tuple(t.shape) == (b, t_tok, hidden)),
            "ek/ev must be contiguous bf16 (B, T, hidden)")
    for t in (gamma, w_all, w_out, bias_all, ek, ev):
        req(t is None or t.device == x.device, "all operands on x's device")
    if specialised:
        _build.require_aligned(x, w_all, w_out, ek, ev)
    return hidden // heads


def _instance(x, w_out, ek, heads) -> str:
    b, f, s, c = x.shape
    return forward_instance(f, heads, w_out.shape[0] // heads, c,
                            0 if ek is None else ek.shape[1])


def temporal_block_fwd(x, gamma, w_all, w_out, ek, ev, bias_all, *,
                       heads: int, emit_p: bool = False):
    """x + block(x), or (out, p) with emit_p (temporal_block_plain_p's p;
    out bit-equal to the launch without p). A CPU tensor takes the plain
    twin; a CUDA tensor launches the instance `forward_instance` names or
    raises."""
    if x.device.type == "cpu":
        out, p_w = temporal_block_plain_p(x, gamma, w_all, w_out, ek, ev,
                                          bias_all, heads=heads)
        return (out, p_w) if emit_p else out
    if _instance(x, w_out, ek, heads) == ANY_SHAPE:
        return _fwd_any(x, gamma, w_all, w_out, ek, ev, bias_all, heads,
                        emit_p=emit_p)
    b, f, s, c = x.shape
    t_tok = 0 if ek is None else ek.shape[1]
    _check(x, gamma, w_all, w_out, ek, ev, bias_all, heads)
    lib = _build.load_library()
    out = torch.empty_like(x)
    # the bf16 value sums between the kernel's two launches
    acc = torch.empty((b, f, s, HIDDEN), dtype=x.dtype, device=x.device)
    p_w = (torch.empty((b, f, s, (f + t_tok) * heads), dtype=x.dtype,
                       device=x.device) if emit_p else None)
    p = _build.ptr
    err = lib.vmt_temporal_block_fwd(
        p(x), p(gamma), p(w_all), p(w_out), p(bias_all), p(ek), p(ev),
        p(out), p(acc), p(p_w), b, f, s, c, t_tok, heads,
        _build.stream_handle(x.device))
    name = "temporal_fwd_p" if emit_p else "fused_temporal_block"
    _build.check_launch(lib, err, name)
    _build.LAUNCH_COUNTS[name] += 1
    return (out, p_w) if emit_p else out


def _fwd_any(x, gamma, w_all, w_out, ek, ev, bias_all, heads, emit_p=False):
    """Row 1 (or, with emit_p, row 2: (out, p)) through the any-shape
    kernel: LN, the QKV projection, the attention and the out-projection
    with the residual, its bf16 scratch (y, qkv, acc) allocated here."""
    d = _check(x, gamma, w_all, w_out, ek, ev, bias_all, heads,
               specialised=False)
    b, f, s, c = x.shape
    t_tok = 0 if ek is None else ek.shape[1]
    lib = _build.load_library()
    _build.require(lib.vmt_temporal_block_any_smem(f, t_tok, d) > 0,
                   f"one warp's shared memory of the attention stage does "
                   f"not fit at F = {f}, T = {t_tok}, dim_head = {d}")
    hidden = heads * d
    out = torch.empty_like(x)
    y = torch.empty_like(x)
    qkv = torch.empty((b, f, s, 3 * hidden), dtype=x.dtype, device=x.device)
    acc = torch.empty((b, f, s, hidden), dtype=x.dtype, device=x.device)
    p_w = (torch.empty((b, f, s, (f + t_tok) * heads), dtype=x.dtype,
                       device=x.device) if emit_p else None)
    p = _build.ptr
    err = lib.vmt_temporal_block_any(
        p(x), p(gamma), p(w_all), p(w_out), p(bias_all), p(ek), p(ev),
        p(out), p(y), p(qkv), p(acc), p(p_w), b, f, s, c, t_tok, heads, d,
        _build.stream_handle(x.device))
    name = "temporal_fwd_p_any" if emit_p else "temporal_block_any"
    _build.check_launch(lib, err, name)
    _build.LAUNCH_COUNTS[name] += 1
    return (out, p_w) if emit_p else out


def temporal_block_bwd_plain(x, gamma, w_all, w_out, ek, ev, bias_all, g, *,
                             heads: int):
    """Plain twin of the backward kernel: autograd through
    temporal_block_plain at the bf16-rounded weights. Returns (dx, dgamma,
    dw_all, dw_out, dek, dev, dbias): dx in x's dtype, the rest float32;
    dek/dev None without conditioning tokens."""
    cdt = x.dtype
    return _build.plain_cotangents(
        temporal_block_plain, x, g,
        [gamma] + [None if t is None else t.to(cdt)
                   for t in (w_all, w_out, ek, ev)] + [bias_all],
        heads=heads)


def temporal_block_bwd(x, gamma, w_all, w_out, ek, ev, bias_all, g, *,
                       heads: int):
    """All cotangents of the block (the order of temporal_block_bwd_plain's
    result). A CPU tensor takes the plain twin; a CUDA tensor launches the
    instance `forward_instance` names or raises."""
    if x.device.type == "cpu":
        return temporal_block_bwd_plain(x, gamma, w_all, w_out, ek, ev,
                                        bias_all, g, heads=heads)
    if _instance(x, w_out, ek, heads) == ANY_SHAPE:
        return _bwd_any(x, gamma, w_all, w_out, ek, ev, bias_all, g, heads)
    _check(x, gamma, w_all, w_out, ek, ev, bias_all, heads)
    _check_g(x, g)
    _build.require_aligned(g)
    b, f, s, c = x.shape
    t_tok = 0 if ek is None else ek.shape[1]
    lib = _build.load_library()
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    dgamma = torch.empty((c,), **f32)
    dw_all = torch.empty((f, c, 3 * HIDDEN), **f32)
    dw_out = torch.empty((HIDDEN, c), **f32)
    dbias = torch.empty((f, f + t_tok, heads), **f32)
    dekv = torch.empty((b, 2, t_tok, HIDDEN), **f32) if t_tok else None
    ws = _build.workspace(
        lib.vmt_temporal_block_bwd_workspace(b, f, s, c, t_tok), x.device)
    w_out_t = w_out.t().contiguous()
    p = _build.ptr
    err = lib.vmt_temporal_block_bwd(
        p(x), p(gamma), p(w_all), p(w_out_t), p(bias_all), p(ek),
        p(ev), p(g), p(dx), p(dgamma), p(dw_all), p(dw_out), p(dbias),
        p(dekv), p(ws), b, f, s, c, t_tok, heads,
        _build.stream_handle(x.device))
    _build.check_launch(lib, err, "temporal_block_bwd")
    _build.LAUNCH_COUNTS["temporal_bwd"] += 1
    dek = dev = None
    if t_tok:
        dek, dev = dekv[:, 0], dekv[:, 1]
    return dx, dgamma, dw_all, dw_out, dek, dev, dbias


def _check_g(x, g) -> None:
    _build.require(g.dtype == x.dtype and g.shape == x.shape
                   and g.is_contiguous() and g.device == x.device,
                   "g must be contiguous, of x's shape and dtype")


def _bwd_any(x, gamma, w_all, w_out, ek, ev, bias_all, g, heads):
    """Row 3 through the any-shape kernels (csrc/any_shape_bwd.cu): the
    recomputed LN and projections, the attention backward with ordered
    partials, dy and the LN backward, the weight sums; one workspace
    allocated here, the weights handed transposed for dy and g_acc."""
    d = _check(x, gamma, w_all, w_out, ek, ev, bias_all, heads,
               specialised=False)
    _check_g(x, g)
    b, f, s, c = x.shape
    t_tok = 0 if ek is None else ek.shape[1]
    hidden = heads * d
    lib = _build.load_library()
    _build.require(lib.vmt_temporal_block_bwd_any_smem(f, t_tok, d) > 0,
                   f"one warp's shared memory of the attention backward does "
                   f"not fit at F = {f}, T = {t_tok}, dim_head = {d}")
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    dgamma = torch.empty((c,), **f32)
    dw_all = torch.empty((f, c, 3 * hidden), **f32)
    dw_out = torch.empty((hidden, c), **f32)
    dbias = torch.empty((f, f + t_tok, heads), **f32)
    dekv = torch.empty((b, 2, t_tok, hidden), **f32) if t_tok else None
    ws = _build.workspace(lib.vmt_temporal_block_bwd_any_workspace(
        b, f, s, c, t_tok, heads, d), x.device)
    w_all_t = w_all.transpose(1, 2).contiguous()
    w_out_t = w_out.t().contiguous()
    p = _build.ptr
    err = lib.vmt_temporal_block_bwd_any(
        p(x), p(gamma), p(w_all), p(w_all_t), p(w_out_t), p(bias_all), p(ek),
        p(ev), p(g), p(dx), p(dgamma), p(dw_all), p(dw_out), p(dbias),
        p(dekv), p(ws), b, f, s, c, t_tok, heads, d,
        _build.stream_handle(x.device))
    _build.check_launch(lib, err, "temporal_bwd_any")
    _build.LAUNCH_COUNTS["temporal_bwd_any"] += 1
    dek = dev = None
    if t_tok:
        dek, dev = dekv[:, 0], dekv[:, 1]
    return dx, dgamma, dw_all, dw_out, dek, dev, dbias


def temporal_bwd_from_p(x, gamma, w_all, w_out, ek, ev, bias_all, p, g, *,
                        heads: int):
    """Own copy of the JAX package's temporal_bwd_from_p
    (fused_temporal_block.py:591-667), the backward of the 'saved' plan:
    the block's cotangents from the saved softmax weights p
    (B, F, S, (F+T)*heads, key-group-major lanes) with only the LN + QKV
    projection recomputed. It stands in for XLA code, so it is plain torch.
    `proj` uses the one-pass LN, as the JAX function's default
    channel_layer_norm does (the forward kernel is two-pass); dx, dgamma
    and dw_all come from autograd over it. Returns (dx, dgamma, dw_all,
    dw_out, dek, dev, dbias), dek/dev None without conditioning tokens."""
    b, f, s, c = x.shape
    hidden = w_out.shape[0]
    d = hidden // heads
    dtype = w_all.dtype
    f32 = torch.float32
    has_cond = ek is not None

    def proj(x_, gamma_, w_all_):
        y = channel_layer_norm(x_, gamma_, one_pass=True).to(dtype)
        return torch.einsum("bfsc,fch->bfsh", y, w_all_)

    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (x, gamma, w_all)]
        qkv = proj(*leaves)
    q, k, v = (t.detach().reshape(b, f, s, heads, d).to(f32)
               for t in qkv.split(hidden, dim=-1))

    p_v = p[..., :f * heads].reshape(b, f, s, f, heads).to(f32)
    g32 = g.to(f32)
    dout = torch.einsum("bisc,nc->bisn", g32,
                        w_out.to(f32)).reshape(b, f, s, heads, d)

    # value-side cotangents + out recompute (for dw_out)
    out_h = torch.einsum("bisjh,bjshd->bishd", p_v, v)
    dp_v = torch.einsum("bishd,bjshd->bisjh", dout, v)
    dv = torch.einsum("bisjh,bishd->bjshd", p_v, dout)
    tsum = torch.einsum("bisjh,bisjh->bish", p_v, dp_v)
    dek = dev = None
    if has_cond:
        t_tok = ek.shape[1]
        ekh = ek.reshape(b, t_tok, heads, d).to(f32)
        evh = ev.reshape(b, t_tok, heads, d).to(f32)
        p_c = p[..., f * heads:].reshape(b, f, s, t_tok, heads).to(f32)
        out_h = out_h + torch.einsum("bisth,bthd->bishd", p_c, evh)
        dp_c = torch.einsum("bishd,bthd->bisth", dout, evh)
        dev = torch.einsum("bisth,bishd->bthd", p_c, dout
                           ).reshape(b, t_tok, hidden).to(ev.dtype)
        tsum = tsum + torch.einsum("bisth,bisth->bish", p_c, dp_c)
    dw_out = torch.einsum("bisn,bisc->nc",
                          out_h.reshape(b, f, s, hidden).to(dtype).to(f32),
                          g32).to(w_out.dtype)

    # softmax jacobian + score backward
    ds_v = p_v * (dp_v - tsum[:, :, :, None, :])
    dbias = torch.einsum("bisjh->ijh", ds_v)
    dq = torch.einsum("bisjh,bjshd->bishd", ds_v, k)
    dk = torch.einsum("bisjh,bishd->bjshd", ds_v, q)
    if has_cond:
        ds_c = p_c * (dp_c - tsum[:, :, :, None, :])
        dbias = torch.cat([dbias, torch.einsum("bisth->ith", ds_c)], dim=1)
        dq = dq + torch.einsum("bisth,bthd->bishd", ds_c, ekh)
        dek = torch.einsum("bisth,bishd->bthd", ds_c, q
                           ).reshape(b, t_tok, hidden).to(ek.dtype)

    dqkv = torch.cat([t.reshape(b, f, s, hidden) for t in (dq, dk, dv)],
                     dim=-1).to(qkv.dtype)
    dx, dgamma, dw_all = torch.autograd.grad(qkv, leaves, dqkv)
    dx = (dx.to(f32) + g32).to(x.dtype)                  # residual path
    return (dx, dgamma, dw_all, dw_out, dek, dev, dbias.to(bias_all.dtype))


class _FusedTemporalBlock(torch.autograd.Function):
    """The JAX custom VJP (fused_temporal_block.py:462-588): the forward
    kernel on the primals, which are saved; the backward recomputes
    through the plain twin or runs the backward kernel."""

    @staticmethod
    def forward(ctx, x, gamma, w_all, w_out, ek, ev, bias_all, heads, bwd):
        cdt = x.dtype
        w_all, w_out = w_all.to(cdt).contiguous(), w_out.to(cdt).contiguous()
        ctx.heads, ctx.bwd = heads, bwd
        ctx.save_for_backward(x, gamma, w_all, w_out, ek, ev, bias_all)
        return temporal_block_fwd(x, gamma, w_all, w_out, ek, ev, bias_all,
                                  heads=heads)

    @staticmethod
    def backward(ctx, g):
        args = ctx.saved_tensors
        run = (temporal_block_bwd if ctx.bwd == "kernel" or bwd_kernel_env()
               else temporal_block_bwd_plain)
        dx, dgamma, dw_all, dw_out, dek, dev, dbias = run(
            *args, g.contiguous(), heads=ctx.heads)
        return dx, dgamma, dw_all, dw_out, dek, dev, dbias, None, None


class _FusedTemporalBlockSavedP(torch.autograd.Function):
    """The JAX fused_temporal_block_savedp (fused_temporal_block.py:670-
    692): the forward kernel emits the softmax weights p, saved with the
    7 primals; the backward is temporal_bwd_from_p, with all 7 cotangents
    (the trainable position bias's dbias among them)."""

    @staticmethod
    def forward(ctx, x, gamma, w_all, w_out, ek, ev, bias_all, heads):
        cdt = x.dtype
        w_all, w_out = w_all.to(cdt).contiguous(), w_out.to(cdt).contiguous()
        ctx.heads = heads
        out, p = temporal_block_fwd(x, gamma, w_all, w_out, ek, ev, bias_all,
                                    heads=heads, emit_p=True)
        ctx.save_for_backward(x, gamma, w_all, w_out, ek, ev, bias_all, p)
        return out

    @staticmethod
    def backward(ctx, g):
        grads = temporal_bwd_from_p(*ctx.saved_tensors, g, heads=ctx.heads)
        return (*grads, None)


BWD_PLANS = ("recompute", "kernel", "saved")
SOFTMAX_LAYOUTS = ("split", "merged")


def bwd_kernel_env() -> bool:
    """VMT_TEMPORAL_BWD_KERNEL=1: the backward kernel under every plan
    but 'saved' (the JAX _bwd_kernel_env, read when the backward runs)."""
    return os.environ.get("VMT_TEMPORAL_BWD_KERNEL", "") == "1"


def softmax_layout() -> str:
    """VMT_TEMPORAL_SOFTMAX, default 'split', validated as the JAX entry
    point validates it (both layouts run row 1 here where p is not read;
    see the module docstring)."""
    layout = os.environ.get("VMT_TEMPORAL_SOFTMAX", "split")
    if layout not in SOFTMAX_LAYOUTS:
        raise ValueError(f"unknown VMT_TEMPORAL_SOFTMAX {layout!r}: one of "
                         f"{SOFTMAX_LAYOUTS}")
    return layout


def fused_temporal_block(x, gamma, w_all, w_out, ek, ev, bias_all, *,
                         heads: int, bwd: str = "recompute") -> torch.Tensor:
    """x + block(x), differentiable in every operand. x: (B, F, S, C) in the
    compute dtype; w_all/w_out in any float dtype (cast to x's inside, so
    float32 weights get float32 gradients); bwd: 'recompute' (autograd
    through the plain twin), 'kernel' (the backward kernel; its twin on
    the CPU) or 'saved' (the forward emits p and temporal_bwd_from_p backs
    it through). Under 'saved' with no operand needing a gradient (sampling
    under a saved-plan configuration) nothing would read p, so the plain
    forward kernel runs: its out is bit-equal to the emit_p launch's."""
    if bwd not in BWD_PLANS:
        raise ValueError(f"unknown backward plan {bwd!r}")
    softmax_layout()
    operands = (x, gamma, w_all, w_out, ek, ev, bias_all)
    needs_grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in operands)
    if bwd == "saved" and needs_grad:
        return _FusedTemporalBlockSavedP.apply(*operands, heads)
    return _FusedTemporalBlock.apply(*operands, heads, bwd)
