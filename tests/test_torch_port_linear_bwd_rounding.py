"""PyTorch port, the linear-attention backward's rounding points in bf16 on
the CPU: a plain version that rounds where the CUDA backward kernel
(csrc/fused_linear_block_bwd.cu) rounds, against the JAX package's
backward kernels in interpret mode, _bwd_kernel (the per-head route,
unclamped) and _bwd_kernel_merged (the merged route, k clamped at +-60),
on the same bf16 inputs and cotangent made with numpy. The same for the
head-layout forward (vmt_linear_head in csrc/fused_linear_block.cu), whose
stats are the backward's stats pass and whose apply splits its float32
operands into bf16 hi + lo parts: against the JAX head-layout _kernel.

The kernel gives every product bf16 operands and f32 sums. The merged JAX
kernel rounds at nearly the same points; the per-head JAX kernel keeps
g_oh, dq, dctx, dv, dpk and oh in f32, so on that route the roundings are
the port's own, and this file measures what they cost: each cotangent
within 5e-2 of its JAX counterpart's largest element (the JAX package's
rule for its backward kernels, tests/test_fused_linear_block.py:205-211),
with the share printed (pytest -s) beside the share of the same plain
version without its bf16 roundings. A frame of 1100 tokens spans 18 of
the stats pass's 64-token sub-tiles and two of its 1024-token chunks.

tests/test_torch_port_cuda.py holds the kernels against the plain versions
here on the card, where JAX is not installed: this module imports JAX only
inside the functions that call it."""

import numpy as np
import pytest
import torch

from videometamaterials_tpu_torch.ops.norms import channel_layer_norm

torch.set_num_threads(1)

# the shapes of tests/test_torch_port_train_kernels.py's linear block
B, N, C = 6, 16, 8
# a frame over several stats sub-tiles and two chunks
LONG_B, LONG_N = 2, 1100
HEADS, D = 4, 32
HD = HEADS * D
SCALE = D ** -0.5
NAMES = ("dx", "dgamma", "dw_qkv", "dw_out", "dout_bias", "dek", "dev")
GRAD_TOL = 5e-2
# the head layout's update against the JAX kernel's, as its kernel is held
# to its twin on the card (tests/test_torch_port_cuda.py APPLY_TOL)
APPLY_TOL = 3e-2
K_CLAMP = 60.0
# the kernel's stats pass: 64-token sub-tiles in 1024-token chunks, each
# sub-tile exponentiating against the chunk's running column max
SUB_TILE, CHUNK = 64, 1024


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def _bf16(a):
    return torch.tensor(a).to(torch.bfloat16).float().numpy()


def _inputs(n_cond, b=B, n=N):
    """bf16-valued x, weights, cond K/V and cotangent (float32 arrays)."""
    return dict(
        x=_bf16(_rand((b, n, C), 0)),
        gamma=_rand((C,), 1, 0.2) + 1.0,
        w_qkv=_bf16(_rand((C, 3 * HD), 2, 0.1)),
        w_out=_bf16(_rand((HD, C), 3, 0.1)),
        out_bias=_rand((C,), 4, 0.1),
        ek=_bf16(_rand((b, n_cond, HD), 5, 0.5)) if n_cond else None,
        ev=_bf16(_rand((b, n_cond, HD), 6, 0.5)) if n_cond else None,
        g=_bf16(_rand((b, n, C), 8)))


def _jax_args(a):
    import jax.numpy as jnp

    bf = jnp.bfloat16
    names = ("x", "gamma", "w_qkv", "w_out", "out_bias", "ek", "ev")
    dtypes = (bf, jnp.float32, bf, bf, jnp.float32, bf, bf)
    return [None if a[n] is None else jnp.asarray(a[n], t)
            for n, t in zip(names, dtypes)]


def _jax_cotangents(a, route):
    """jax.vjp of the JAX entry point with its backward kernel on the
    route's layout (at N <= 1100 the merged layout takes
    _bwd_kernel_merged)."""
    import jax
    import jax.numpy as jnp

    from videometamaterials_tpu.ops.pallas.fused_linear_block import (
        fused_linear_block as j_fused_linear,
    )

    bf = jnp.bfloat16
    args = _jax_args(a)
    present = [i for i, v in enumerate(args) if v is not None]

    def f(*xs):
        full = list(args)
        for i, v in zip(present, xs):
            full[i] = v
        return j_fused_linear(*full, heads=HEADS, scale=SCALE,
                              spatial_size=a["x"].shape[1], interpret=True,
                              bwd_kernel=True, layout=route)

    _, vjp = jax.vjp(f, *[args[i] for i in present])
    out = [None] * len(args)
    for i, v in zip(present, vjp(jnp.asarray(a["g"], bf))):
        out[i] = np.asarray(v, np.float32)
    return out


def kernel_rounding_stats(kk, vs, kkc, evc, *, heads, inv_hw, rounded=True):
    """The stats pass (shared by the backward and the head-layout forward):
    per 1024-token chunk the running max of its 64-token sub-tiles' column
    maxima, sum exp(kk - m) in f32 and sum bf16(exp(kk - m)) bf16(v / HW)
    (no bf16 with rounded=False), then per frame the chunks merged by max
    with the cond tokens (f32) folded in once. kk: the keys as the route
    takes them (clamped or not), vs = v / HW, kkc / evc the cond tokens'
    keys (taken the same way) and values, or None. Returns the max M and
    1 / z, (b, H), and the normalised ctx, (b, heads, d, d)."""
    rb = (lambda t: t.to(torch.bfloat16).float()) if rounded else (
        lambda t: t)
    b, n, hd = kk.shape
    d = hd // heads

    def per_head(t):
        return t.reshape(*t.shape[:-1], heads, d)

    ms, zs, cs = [], [], []
    for c0 in range(0, n, CHUNK):
        m = torch.full((b, hd), -torch.inf)
        z = torch.zeros(b, hd)
        ctx = torch.zeros(b, heads, d, d)
        for s0 in range(c0, min(n, c0 + CHUNK), SUB_TILE):
            sl = slice(s0, min(n, s0 + SUB_TILE))
            m_new = torch.maximum(m, kk[:, sl].amax(dim=1))
            sc = torch.exp(m - m_new)
            p = torch.exp(kk[:, sl] - m_new[:, None])
            z = z * sc + p.sum(dim=1)
            ctx = ctx * per_head(sc)[..., None] + torch.einsum(
                "bnha,bnhe->bhae", per_head(rb(p)), per_head(rb(vs[:, sl])))
            m = m_new
        ms.append(m), zs.append(z), cs.append(ctx)
    ms, zs, cs = torch.stack(ms), torch.stack(zs), torch.stack(cs)
    M = ms.amax(dim=0)
    if kkc is not None:
        M = torch.maximum(M, kkc.amax(dim=1))
        pc = torch.exp(kkc - M[:, None])
        Z = pc.sum(dim=1)
        ctx = torch.einsum("bmha,bmhe->bhae", per_head(pc),
                           per_head(evc * inv_hw))
    else:
        Z = torch.zeros(b, hd)
        ctx = torch.zeros(b, heads, d, d)
    sc = torch.exp(ms - M)
    Z = Z + (zs * sc).sum(dim=0)
    ctx = ctx + (cs * per_head(sc)[..., None]).sum(dim=0)
    zinv = 1.0 / Z
    return M, zinv, ctx * per_head(zinv)[..., None]


def kernel_rounding_bwd(x, gamma, w_qkv, w_out, ek, ev, g, *, heads, scale,
                        spatial_size, clip, rounded=True):
    """The CUDA backward's arithmetic, written out in float32 with a bf16
    rounding (nearest even) wherever the kernel rounds; rounded=False
    leaves every one of them out (y and dx stay rounded: they are bf16 in
    both frameworks). S = sum_e dctx ctx takes the dctx that dP = v dctx^T
    takes, bf16 with the roundings: where one token holds a feature's
    softmax, dk = P (dP - S) cancels, and a dctx rounded in dP but not in S
    would leave dP's rounding error in dk (up to 6e-2 of dgamma's max at
    keys x300 on the per-head route; 4e-3 as it is). Inputs: float32
    tensors holding bf16 values. Returns (dx, dgamma, dw_qkv, dw_out,
    dout_bias, dek, dev)."""
    rb = (lambda t: t.to(torch.bfloat16).float()) if rounded else (
        lambda t: t)
    b, n, c = x.shape
    hd = w_out.shape[0]
    d = hd // heads
    inv_hw = 1.0 / spatial_size

    def per_head(t):
        return t.reshape(*t.shape[:-1], heads, d)

    y = channel_layer_norm(x.to(torch.bfloat16), gamma,
                           one_pass=False).float()
    q, k, v = (y @ w_qkv).split(hd, dim=-1)
    g_oh = g @ w_out.t()
    kk = k.clamp(-K_CLAMP, K_CLAMP) if clip else k
    vs = v * inv_hw
    kkc = None
    if ek is not None:
        kkc = ek.clamp(-K_CLAMP, K_CLAMP) if clip else ek
    M, zinv, ctxn = kernel_rounding_stats(kk, vs, kkc, ev, heads=heads,
                                          inv_hw=inv_hw, rounded=rounded)

    e = torch.exp(per_head(q) - per_head(q).amax(dim=-1, keepdim=True))
    Q = (e * (scale / e.sum(dim=-1, keepdim=True))).reshape(b, n, hd)
    dctx = torch.einsum("bnha,bnhe->bhae", per_head(rb(Q)), per_head(rb(g_oh)))
    ctx_b, dctx_b = rb(ctxn), rb(dctx)
    # S from the dctx that dP takes (its rounding cancels in dP - S)
    S = (dctx_b * ctxn).sum(dim=-1).reshape(b, hd)

    # the token passes
    t = Q * torch.einsum("bnhe,bhae->bnha", per_head(rb(g_oh)),
                         ctx_b).reshape(b, n, hd)
    dq = t - Q * per_head(t).sum(dim=-1, keepdim=True).expand(
        -1, -1, -1, d).reshape(b, n, hd) / scale
    P = torch.exp(kk - M[:, None]) * zinv[:, None]
    dP = torch.einsum("bnhe,bhae->bnha", per_head(rb(vs)),
                      dctx_b).reshape(b, n, hd)
    keep = (k.abs() < K_CLAMP) if clip else torch.ones_like(k, dtype=bool)
    dk = torch.where(keep, P * (dP - S[:, None]), torch.zeros_like(P))
    dv = torch.einsum("bnha,bhae->bnhe", per_head(rb(P)),
                      dctx_b).reshape(b, n, hd) * inv_hw
    dqkv = rb(torch.cat([dq, dk, dv], dim=-1))
    oh = rb(torch.einsum("bnha,bhae->bnhe", per_head(rb(Q)),
                         ctx_b).reshape(b, n, hd))
    dw_qkv = torch.einsum("bnc,bnj->cj", y, dqkv)
    dw_out = torch.einsum("bnh,bnc->hc", oh, g)
    dy = dqkv @ w_qkv.t()
    mu = x.mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt((x - mu).square().mean(dim=-1, keepdim=True) + 1e-5)
    xhat = (x - mu) * rstd
    dgamma = (xhat * dy).sum(dim=(0, 1))
    dxh = dy * gamma
    dx = g + rstd * (dxh - dxh.mean(dim=-1, keepdim=True)
                     - xhat * (dxh * xhat).mean(dim=-1, keepdim=True))
    dx = dx.to(torch.bfloat16).float()
    dek = dev = None
    if ek is not None:
        Pc = torch.exp(kkc - M[:, None]) * zinv[:, None]
        dPc = torch.einsum("bmhe,bhae->bmha", per_head(ev * inv_hw),
                           dctx_b).reshape(b, -1, hd)
        keep_c = (ek.abs() < K_CLAMP) if clip else torch.ones_like(
            ek, dtype=bool)
        dek = torch.where(keep_c, Pc * (dPc - S[:, None]), torch.zeros_like(Pc))
        dev = torch.einsum("bmha,bhae->bmhe", per_head(Pc),
                           dctx_b).reshape(b, -1, hd) * inv_hw
    return dx, dgamma, dw_qkv, dw_out, g.sum(dim=(0, 1)), dek, dev


def bf16_parts(t, k):
    """The first k bf16 parts of a float32 tensor: bf16(t), then
    bf16(t - bf16(t)), ...; two parts keep about 16 of its 24 significant
    bits (the kernels' hi + lo split, csrc/temporal_tile.cuh frag_a)."""
    parts = []
    for _ in range(k):
        parts.append(t.to(torch.bfloat16).float())
        t = t - parts[-1]
    return parts


def kernel_rounding_head_fwd(x, gamma, w_qkv, w_out, out_bias, ek, ev, *,
                             heads, scale, spatial_size, rounded=True,
                             parts=2):
    """The CUDA head-layout forward's arithmetic: the stats pass as
    kernel_rounding_stats on the unclamped keys (bf16 operands of ctx with
    rounded=True), then its apply: Q = scale softmax_head(q), oh = Q ctx,
    x + out_bias + oh W_out, rounded to bf16 once. parts=2: Q, ctxn and oh
    as the kernel takes them on the tensor cores, as bf16 hi + lo, with the
    products it keeps (Q_hi c_hi + Q_hi c_lo + Q_lo c_hi; oh_hi W +
    oh_lo W, W bf16-valued); parts=1 the bf16 parts alone; parts=None
    float32 throughout, as the JAX head kernel computes it. Inputs: float32
    tensors holding bf16 values (gamma, out_bias float32). Returns the bf16
    output as float32."""
    b, n, _ = x.shape
    hd = w_out.shape[0]
    d = hd // heads
    inv_hw = 1.0 / spatial_size
    y = channel_layer_norm(x.to(torch.bfloat16), gamma,
                           one_pass=False).float()
    q, k, v = (y @ w_qkv).split(hd, dim=-1)
    _, _, ctxn = kernel_rounding_stats(k, v * inv_hw, ek, ev, heads=heads,
                                       inv_hw=inv_hw, rounded=rounded)
    q = q.reshape(b, n, heads, d)
    e = torch.exp(q - q.amax(dim=-1, keepdim=True))
    Q = e * (scale / e.sum(dim=-1, keepdim=True))
    if parts is None:
        oh = torch.einsum("bnha,bhae->bnhe", Q, ctxn)
    else:
        qs, cs = bf16_parts(Q, parts), bf16_parts(ctxn, parts)
        oh = sum(torch.einsum("bnha,bhae->bnhe", qs[i], cs[j])
                 for i in range(parts) for j in range(parts - i))
        oh = sum(bf16_parts(oh, parts))
    out = x + out_bias + oh.reshape(b, n, hd) @ w_out
    return out.to(torch.bfloat16).float()


def _shares(got, want):
    """Each cotangent's max |got - want| over max |want|."""
    out = {}
    for name, a, w in zip(NAMES, got, want):
        if w is None:
            assert a is None, name
            continue
        scale = np.abs(w).max()
        assert scale > 0 and np.abs(a.numpy()).max() > 0, name
        out[name] = float(np.abs(a.numpy() - w).max() / scale)
    return out


@pytest.mark.parametrize("route", ["head", "merged"])
@pytest.mark.parametrize("n_cond", [0, 6])
def test_kernel_rounding_points_match_the_jax_backward_kernels(route, n_cond):
    """The plain version rounding where the kernel rounds, against the JAX
    backward kernel of its route: every cotangent within 5e-2 of the JAX
    one's max. The shares, and those of the version without the roundings,
    are printed."""
    a = _inputs(n_cond)
    want = _jax_cotangents(a, route)
    t = {k: None if v is None else torch.tensor(v) for k, v in a.items()}
    kw = dict(heads=HEADS, scale=SCALE, spatial_size=N,
              clip=route == "merged")
    args = (t["x"], t["gamma"], t["w_qkv"], t["w_out"], t["ek"], t["ev"],
            t["g"])
    rounded = _shares(kernel_rounding_bwd(*args, **kw), want)
    exact = _shares(kernel_rounding_bwd(*args, **kw, rounded=False), want)
    print(f"\n{route} route, {n_cond} cond tokens: share of the JAX "
          "cotangent's max, rounded as the kernel / unrounded: " + ", ".join(
              f"{k} {rounded[k]:.2e} / {exact[k]:.2e}" for k in rounded))
    for name, share in rounded.items():
        assert share <= GRAD_TOL, (name, share)


def test_clamp_routes_differ_in_the_rounded_version():
    """Head 0's keys times 300 (|k| on both sides of 60), 6 cond tokens:
    the rounded version on each route matches its JAX kernel, and the two
    routes differ by more than the tolerance."""
    a = _inputs(6)
    w = a["w_qkv"].copy()
    w[:, HD:HD + D] *= 300.0
    a["w_qkv"] = _bf16(w)
    t = {k: None if v is None else torch.tensor(v) for k, v in a.items()}
    args = (t["x"], t["gamma"], t["w_qkv"], t["w_out"], t["ek"], t["ev"],
            t["g"])
    k = channel_layer_norm(t["x"].to(torch.bfloat16), t["gamma"],
                           one_pass=False).float() @ t["w_qkv"][:, HD:2 * HD]
    assert (k.abs() > K_CLAMP).any() and (k.abs() < K_CLAMP).any()
    got = {}
    for route in ("head", "merged"):
        got[route] = kernel_rounding_bwd(*args, heads=HEADS, scale=SCALE,
                                         spatial_size=N,
                                         clip=route == "merged")
        shares = _shares(got[route], _jax_cotangents(a, route))
        assert max(shares.values()) <= GRAD_TOL, (route, shares)
    gap = (got["merged"][2] - got["head"][2]).abs().max()
    assert gap > GRAD_TOL * got["head"][2].abs().max()


@pytest.mark.parametrize("route", ["head", "merged"])
def test_kernel_rounding_points_over_sub_tiles_and_chunks(route):
    """A frame of 1100 tokens with 6 cond tokens: the running max moves
    across 18 sub-tiles and two chunks are merged, as in the kernel's stats
    pass. Every cotangent of the rounded version within 5e-2 of the JAX
    one's max; the shares are printed."""
    a = _inputs(6, b=LONG_B, n=LONG_N)
    want = _jax_cotangents(a, route)
    t = {k: None if v is None else torch.tensor(v) for k, v in a.items()}
    kw = dict(heads=HEADS, scale=SCALE, spatial_size=LONG_N,
              clip=route == "merged")
    args = (t["x"], t["gamma"], t["w_qkv"], t["w_out"], t["ek"], t["ev"],
            t["g"])
    rounded = _shares(kernel_rounding_bwd(*args, **kw), want)
    exact = _shares(kernel_rounding_bwd(*args, **kw, rounded=False), want)
    print(f"\n{route} route, N = {LONG_N}: share of the JAX cotangent's "
          "max, rounded as the kernel / unrounded: " + ", ".join(
              f"{k} {rounded[k]:.2e} / {exact[k]:.2e}" for k in rounded))
    for name, share in rounded.items():
        assert share <= GRAD_TOL, (name, share)


def _jax_head(a):
    from videometamaterials_tpu.ops.pallas.fused_linear_block import (
        fused_linear_block as j_fused_linear,
    )

    out = j_fused_linear(*_jax_args(a), heads=HEADS, scale=SCALE,
                         spatial_size=a["x"].shape[1], interpret=True,
                         layout="head")
    return np.asarray(out, np.float32)


def _head_inputs(b, n, k_scale):
    """_inputs with 6 cond tokens, x scaled to 0.01 (the LN output does not
    change) so that the bf16 output resolves the update, head 0's keys
    times k_scale and v times HW (an O(1) update, as chip_smoke.py's
    phase_head)."""
    a = _inputs(6, b=b, n=n)
    a["x"] = _bf16(a["x"] * 0.01)
    w = a["w_qkv"].copy()
    w[:, HD:HD + D] *= k_scale
    w[:, 2 * HD:] *= n
    a["w_qkv"] = _bf16(w)
    return a


def _head_args(a):
    t = {k: None if v is None else torch.tensor(v) for k, v in a.items()}
    return (t["x"], t["gamma"], t["w_qkv"], t["w_out"], t["out_bias"],
            t["ek"], t["ev"])


@pytest.mark.parametrize("k_scale", [1.0, 40.0])
@pytest.mark.parametrize("b,n", [(B, N), (LONG_B, LONG_N)])
def test_head_layout_rounded_stats_match_the_jax_head_kernel(b, n, k_scale):
    """The head-layout forward with the stats pass's bf16 operands of ctx
    (two roundings the JAX head kernel does not make) against the JAX
    head-layout _kernel on bf16 inputs, 6 cond tokens, head 0's keys times
    k_scale (x40: the unclamped keys of chip_smoke.py's phase_head): the
    update out - x within 3e-2 of the JAX update's max, with the apply's
    products as the kernel splits them (bf16 hi + lo) and in float32. The
    shares of both, and of the version without any rounding, are
    printed."""
    a = _head_inputs(b, n, k_scale)
    want = _jax_head(a) - a["x"]
    args = _head_args(a)
    kw = dict(heads=HEADS, scale=SCALE, spatial_size=n)
    scale = np.abs(want).max()
    shares = {}
    for name, rounded, parts in (("split", True, 2), ("f32", True, None),
                                 ("unrounded", False, None)):
        got = kernel_rounding_head_fwd(*args, **kw, rounded=rounded,
                                       parts=parts).numpy()
        shares[name] = float(np.abs(got - a["x"] - want).max() / scale)
    print(f"\nhead layout, N = {n}, keys x{k_scale:g}: update within "
          f"{shares['split']:.2e} of the JAX one's max rounded as the kernel "
          f"(apply split), {shares['f32']:.2e} with a float32 apply, "
          f"{shares['unrounded']:.2e} unrounded")
    assert scale > 0.1
    assert shares["split"] <= APPLY_TOL, shares
    assert shares["f32"] <= APPLY_TOL, shares


# the card test's bound on the share of outputs that differ from the
# rounding model (tests/test_torch_port_cuda.py MODEL_BITS)
MODEL_BITS = 0.03


@pytest.mark.parametrize("k_scale", [1.0, 40.0])
def test_head_apply_split_resolves_float32(k_scale):
    """The apply's hi + lo split against its float32 apply on the card
    test's inputs (tests/test_torch_port_cuda.py
    test_linear_head_kernel_matches_its_rounding_model: N = 1100, C = 64,
    8 heads, one cond token, v times HW * 32, x times 0.01): at most
    MODEL_BITS of the bf16 outputs differ, so the card test can hold the
    kernel to either; with the bf16 parts alone (what a kernel computes
    that drops the lo terms) more than MODEL_BITS differ, so that test
    sees such a kernel. The shares are printed."""
    b, n, c, hd = LONG_B, LONG_N, 64, 256
    w = _rand((c, 3 * hd), 2, c ** -0.5)
    w[:, hd:hd + D] *= k_scale
    w[:, 2 * hd:] *= n * 32.0
    args = [torch.tensor(v) for v in (
        _bf16(_rand((b, n, c), 0) * 0.01), _rand((c,), 1, 0.1) + 1.0,
        _bf16(w), _bf16(_rand((hd, c), 3, hd ** -0.5)), _rand((c,), 4, 0.1),
        _bf16(_rand((b, 1, hd), 5)), _bf16(_rand((b, 1, hd), 6)))]
    kw = dict(heads=8, scale=SCALE, spatial_size=n)
    f32 = kernel_rounding_head_fwd(*args, **kw, parts=None)
    bits = {p: (kernel_rounding_head_fwd(*args, **kw, parts=p) != f32)
            .float().mean().item() for p in (2, 1)}
    print(f"\nkeys x{k_scale:g}: outputs different from the float32 apply "
          f"{bits[2]:.2e} (hi + lo), {bits[1]:.2e} (bf16 alone)")
    assert bits[2] <= MODEL_BITS, bits
    assert bits[1] > MODEL_BITS, bits
