"""PyTorch port, CUDA kernels on the card: each kernel against its plain twin
at the flagship widths (a short spatial extent), and its launch counter.
Skipped without a CUDA device. On the card, where JAX is not installed,
run it without tests/conftest.py (which imports JAX):
`python -m pytest --noconftest tests/test_torch_port_cuda.py`.
chip_smoke.py runs the same comparison at every main-path shape."""

import math

import pytest
import torch

from videometamaterials_tpu_torch.ops.cuda import _build
from videometamaterials_tpu_torch.ops.cuda import fused_linear_block as lin
from videometamaterials_tpu_torch.ops.cuda import fused_temporal_block as tmp

# bf16 outputs: the JAX kernel test's tolerance
# (tests/test_fused_temporal_block.py:50); float32 z: summation order
BF16_TOL = dict(rtol=3e-2, atol=3e-2)
STATS_TOL = dict(rtol=1e-3, atol=1e-3)
# ctx: a bf16(exp(k)) or bf16(v / HW) factor can round one ulp (2^-7 of
# it) apart in the kernel and the twin, so ctx is held to 2^-7 of the sum
# of its summands' magnitudes
CTX_SHARE = 2.0 ** -7
# linear apply: the update out - x - out_bias against the twin's, relative
# to its largest element. Its stats inputs are O(1) (z = 1 + |N|,
# ctx ~ 32 N) so the update is about as large as x; the real stats (v / HW)
# leave it below one bf16 ulp of the output
APPLY_TOL = 3e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.Generator(device="cuda").manual_seed(0)


def _rnd(gen, *shape, scale=1.0):
    return torch.randn(*shape, generator=gen, device="cuda") * scale


@pytest.mark.parametrize("c", [64, 512])
@pytest.mark.parametrize("t_tok", [0, 11])
def test_temporal_kernel_matches_twin(cuda, c, t_tok):
    bf = torch.bfloat16
    b, f, s, hd = 2, 11, 100, 256          # 100: a ragged last tile of 8
    args = dict(
        x=_rnd(cuda, b, f, s, c).to(bf), gamma=1 + _rnd(cuda, c, scale=0.1),
        w_all=(_rnd(cuda, f, c, 3 * hd) * c ** -0.5).to(bf),
        w_out=(_rnd(cuda, hd, c) * hd ** -0.5).to(bf),
        ek=_rnd(cuda, b, t_tok, hd).to(bf) if t_tok else None,
        ev=_rnd(cuda, b, t_tok, hd).to(bf) if t_tok else None,
        bias_all=_rnd(cuda, f, f + t_tok, 8, scale=0.5))
    before = _build.LAUNCH_COUNTS["fused_temporal_block"]
    got = tmp.fused_temporal_block(**args, heads=8)
    torch.cuda.synchronize()
    assert _build.LAUNCH_COUNTS["fused_temporal_block"] == before + 1
    torch.testing.assert_close(got.float(),
                               tmp.temporal_block_plain(**args, heads=8)
                               .float(), **BF16_TOL)


@pytest.mark.parametrize("n,c", [(100, 64), (144, 512)])
def test_linear_kernels_match_twins(cuda, n, c):
    bf = torch.bfloat16
    b, hd = 6, 256
    x = _rnd(cuda, b, n, c).to(bf)
    gamma = 1 + _rnd(cuda, c, scale=0.1)
    w_qkv = (_rnd(cuda, c, 3 * hd) * c ** -0.5).to(bf)
    w_out = (_rnd(cuda, hd, c) * hd ** -0.5).to(bf)
    out_bias = _rnd(cuda, c, scale=0.1)
    ek, ev = _rnd(cuda, b, 1, hd).to(bf), _rnd(cuda, b, 1, hd).to(bf)
    ctx_p, z_p = lin.linear_stats_plain(x, gamma, w_qkv, ek, ev, heads=8,
                                        spatial_size=n)
    ctx_k, z_k = lin.linear_stats(x, gamma, w_qkv, ek, ev, heads=8,
                                  spatial_size=n)
    mag = lin.linear_stats_magnitude(x, gamma, w_qkv, ek, ev, heads=8,
                                     spatial_size=n)
    assert ((ctx_k - ctx_p).abs() <= CTX_SHARE * mag).all()
    torch.testing.assert_close(z_k, z_p, **STATS_TOL)
    ctx, z = _rnd(cuda, b, 8, 32, 32, scale=32.0), 1 + _rnd(cuda, b, hd).abs()
    _assert_apply_matches(x, gamma, w_qkv, w_out, out_bias, ctx, z)


def _assert_apply_matches(x, gamma, w_qkv, w_out, out_bias, ctx, z):
    args = (x, gamma, w_qkv, w_out, out_bias, ctx, z)
    got = lin.linear_apply(*args, heads=8, scale=32 ** -0.5)
    torch.cuda.synchronize()
    want = lin.linear_apply_plain(*args, heads=8, scale=32 ** -0.5)
    assert torch.isfinite(got).all()
    base = x.float() + out_bias
    upd_k, upd_p = got.float() - base, want.float() - base
    assert upd_p.pow(2).mean().sqrt() > 0.5 * x.float().pow(2).mean().sqrt()
    err = (upd_k - upd_p).abs().max()
    assert err <= APPLY_TOL * upd_p.abs().max(), err


def test_linear_apply_kernel_per_head_shift(cuda):
    """Head 0's q logits ~1000x the others' (tests/test_fused_linear_block.py
    :288): the per-head max shift keeps the output finite and the other
    heads exact. Head 0's context is zero: a one-ulp bf16 flip of an LN
    output moves its logits by ~0.5 and reorders its near-ties."""
    bf = torch.bfloat16
    b, n, c, hd = 4, 100, 64, 256
    w_qkv = _rnd(cuda, c, 3 * hd) * c ** -0.5
    w_qkv[:, :32] *= 1000.0
    ctx = _rnd(cuda, b, 8, 32, 32, scale=32.0)
    ctx[:, 0] = 0.0
    _assert_apply_matches(
        _rnd(cuda, b, n, c).to(bf), 1 + _rnd(cuda, c, scale=0.1),
        w_qkv.to(bf), (_rnd(cuda, hd, c) * hd ** -0.5).to(bf),
        _rnd(cuda, c, scale=0.1), ctx, 1 + _rnd(cuda, b, hd).abs())


@pytest.mark.parametrize("t_tok", [0, 11])
def test_temporal_emit_p_kernel(cuda, t_tok):
    """The emit_p launch: out bit-equal to the plain launch's, out and p
    within the bf16 tolerance of the twin's, p summing to one per position
    and head (8 significant bits a weight: 2^-8, and float32 sums), the
    same bits on a second launch."""
    bf = torch.bfloat16
    b, f, s, c, hd = 2, 11, 100, 64, 256   # 100: a ragged last tile of 8
    args = dict(
        x=_rnd(cuda, b, f, s, c).to(bf), gamma=1 + _rnd(cuda, c, scale=0.1),
        w_all=(_rnd(cuda, f, c, 3 * hd) * c ** -0.5).to(bf),
        w_out=(_rnd(cuda, hd, c) * hd ** -0.5).to(bf),
        ek=_rnd(cuda, b, t_tok, hd).to(bf) if t_tok else None,
        ev=_rnd(cuda, b, t_tok, hd).to(bf) if t_tok else None,
        bias_all=_rnd(cuda, f, f + t_tok, 8, scale=0.5))
    before = _build.LAUNCH_COUNTS["temporal_fwd_p"]
    out, p = tmp.temporal_block_fwd(**args, heads=8, emit_p=True)
    torch.cuda.synchronize()
    assert _build.LAUNCH_COUNTS["temporal_fwd_p"] == before + 1
    assert torch.equal(out, tmp.temporal_block_fwd(**args, heads=8))
    want_out, want_p = tmp.temporal_block_plain_p(**args, heads=8)
    torch.testing.assert_close(out.float(), want_out.float(), **BF16_TOL)
    torch.testing.assert_close(p.float(), want_p.float(), **BF16_TOL)
    sums = p.float().reshape(b, f, s, f + t_tok, 8).sum(dim=3)
    assert (sums - 1).abs().max() <= 2.0 ** -7
    out2, p2 = tmp.temporal_block_fwd(**args, heads=8, emit_p=True)
    assert torch.equal(out, out2) and torch.equal(p, p2)


def _head_args(gen, b, n, c, k_scale, heads=8, d=32, m_c=1):
    """Head-layout inputs with an O(1) update beside x: the v columns of
    w_qkv times HW (undoing v / HW) and 32, the key columns times k_scale
    (8: the token softmax picks few tokens, so ctx is no average near 0)."""
    bf, hd = torch.bfloat16, heads * d
    w_qkv = _rnd(gen, c, 3 * hd) * c ** -0.5
    w_qkv[:, hd:2 * hd] *= k_scale
    w_qkv[:, 2 * hd:] *= n * 32.0
    return dict(x=_rnd(gen, b, n, c).to(bf), gamma=1 + _rnd(gen, c, scale=0.1),
                w_qkv=w_qkv.to(bf),
                w_out=(_rnd(gen, hd, c) * hd ** -0.5).to(bf),
                out_bias=_rnd(gen, c, scale=0.1),
                ek=_rnd(gen, b, m_c, hd).to(bf) if m_c else None,
                ev=_rnd(gen, b, m_c, hd).to(bf) if m_c else None)


def _update_err(got, want, x, out_bias):
    """max |update - twin's update| over the twin's largest update, the
    update being out - x - out_bias, which must be O(1) beside x."""
    assert torch.isfinite(got).all()
    base = x.float() + out_bias
    upd_k, upd_p = got.float() - base, want.float() - base
    assert upd_p.pow(2).mean().sqrt() > 0.5 * x.float().pow(2).mean().sqrt()
    return ((upd_k - upd_p).abs().max() / upd_p.abs().max()).item()


@pytest.mark.parametrize("n,c", [(100, 64), (144, 512), (37, 128),
                                 (100, 256)])
def test_linear_head_kernel_matches_twin(cuda, n, c):
    args = _head_args(cuda, 6, n, c, 8.0)
    kw = dict(heads=8, scale=32 ** -0.5, spatial_size=n)
    before = _build.LAUNCH_COUNTS["linear_head"]
    got = lin.linear_block_head(**args, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCH_COUNTS["linear_head"] == before + 1
    want = lin.linear_block_head_plain(**args, **kw)
    assert _update_err(got, want, args["x"], args["out_bias"]) <= APPLY_TOL
    # deterministic: the ordered merge has no atomics
    assert torch.equal(got, lin.linear_block_head(**args, **kw))


def test_linear_head_kernel_does_not_clamp(cuda):
    """Keys times 40, |k| on both sides of 60: the head kernel follows its
    unclamped twin and misses the clamped merged twin."""
    n = 100
    args = _head_args(cuda, 6, n, 64, 40.0)
    kw = dict(heads=8, scale=32 ** -0.5, spatial_size=n)
    from videometamaterials_tpu_torch.ops.norms import channel_layer_norm
    k = (channel_layer_norm(args["x"], args["gamma"], one_pass=False).float()
         @ args["w_qkv"][:, 256:512].float())
    assert (k.abs() > 60).any() and (k.abs() < 60).any()
    got = lin.linear_block_head(**args, **kw)
    torch.cuda.synchronize()
    x, ob = args["x"], args["out_bias"]
    assert _update_err(got, lin.linear_block_head_plain(**args, **kw), x,
                       ob) <= APPLY_TOL
    assert _update_err(got, lin.linear_block_plain(**args, **kw), x,
                       ob) > APPLY_TOL


def test_cuda_wrapper_raises_instead_of_falling_back(cuda):
    """A CUDA tensor of a shape or type no instance takes raises: row 1 in
    float32; row 8 (the head layout, which takes every shape the JAX
    kernel takes with d <= 64) with x in float32, and at 2 heads of 128."""
    x = torch.zeros((2, 11, 16, 48), dtype=torch.bfloat16, device="cuda")
    args = (torch.ones(48, device="cuda"),
            torch.zeros((11, 48, 768), dtype=torch.bfloat16, device="cuda"),
            torch.zeros((256, 48), dtype=torch.bfloat16, device="cuda"),
            None, None, torch.zeros((11, 11, 8), device="cuda"))
    with pytest.raises(ValueError, match="bf16"):
        tmp.fused_temporal_block(x.float(), *args, heads=8)
    xl = torch.zeros((2, 16, 48), dtype=torch.bfloat16, device="cuda")
    largs = (torch.ones(48, device="cuda"),
             torch.zeros((48, 768), dtype=torch.bfloat16, device="cuda"),
             torch.zeros((256, 48), dtype=torch.bfloat16, device="cuda"),
             torch.zeros(48, device="cuda"), None, None)
    with pytest.raises(ValueError, match="bf16"):
        lin.linear_block_head(xl.float(), *largs, heads=8, scale=32 ** -0.5,
                              spatial_size=16)
    with pytest.raises(ValueError, match="d up to 64"):
        lin.linear_block_head(xl, *largs, heads=2, scale=128 ** -0.5,
                              spatial_size=16)


# ------------------------------------------------------------ backward
# each cotangent within 5e-2 of the twin's largest element, rtol 0, and
# nonzero somewhere: the JAX backward-kernel tests' rule
# (tests/test_fused_temporal_block.py:277, tests/test_fused_linear_block.py
# :205-211), without their 1e-3 floor on the max, which the linear dek/dev
# lie below
GRAD_TOL = 5e-2


def _assert_cotangents(names, got, want):
    for name, a, b in zip(names, got, want):
        if b is None:
            assert a is None, name
            continue
        a32, b32 = a.float(), b.float()
        assert torch.isfinite(a32).all(), name
        scale = b32.abs().max().item()
        assert scale > 0, name
        err = (a32 - b32).abs().max().item()
        assert err <= GRAD_TOL * scale, (name, err, scale)
        assert a32.abs().max() > 0, name


@pytest.mark.parametrize("c", [64, 512])
@pytest.mark.parametrize("t_tok", [0, 11])
def test_temporal_bwd_kernel_matches_twin(cuda, c, t_tok):
    bf = torch.bfloat16
    b, f, s, hd = 2, 11, 100, 256          # 100: a ragged last tile of 8
    args = dict(
        x=_rnd(cuda, b, f, s, c).to(bf), gamma=1 + _rnd(cuda, c, scale=0.1),
        w_all=(_rnd(cuda, f, c, 3 * hd) * c ** -0.5).to(bf),
        w_out=(_rnd(cuda, hd, c) * hd ** -0.5).to(bf),
        ek=_rnd(cuda, b, t_tok, hd).to(bf) if t_tok else None,
        ev=_rnd(cuda, b, t_tok, hd).to(bf) if t_tok else None,
        bias_all=_rnd(cuda, f, f + t_tok, 8, scale=0.5))
    g = _rnd(cuda, b, f, s, c).to(bf)
    before = _build.LAUNCH_COUNTS["temporal_bwd"]
    got = tmp.temporal_block_bwd(**args, g=g, heads=8)
    torch.cuda.synchronize()
    assert _build.LAUNCH_COUNTS["temporal_bwd"] == before + 1
    want = tmp.temporal_block_bwd_plain(**args, g=g, heads=8)
    _assert_cotangents(("dx", "dgamma", "dw_all", "dw_out", "dek", "dev",
                        "dbias"), got, want)
    # deterministic: no atomics, the same bits twice
    again = tmp.temporal_block_bwd(**args, g=g, heads=8)
    for a, b_ in zip(got, again):
        assert a is None or torch.equal(a, b_)


@pytest.mark.parametrize("route", ["head", "merged"])
@pytest.mark.parametrize("n,c", [(100, 64), (144, 512)])
def test_linear_bwd_kernel_matches_twin(cuda, route, n, c):
    bf = torch.bfloat16
    b, hd = 6, 256
    args = dict(
        x=_rnd(cuda, b, n, c).to(bf), gamma=1 + _rnd(cuda, c, scale=0.1),
        w_qkv=(_rnd(cuda, c, 3 * hd) * c ** -0.5).to(bf),
        w_out=(_rnd(cuda, hd, c) * hd ** -0.5).to(bf),
        out_bias=_rnd(cuda, c, scale=0.1),
        # the conditioning key takes about half of each feature's softmax,
        # so dek, dev and the softmax's S term are not lost beside the rest
        ek=(_rnd(cuda, b, 1, hd) + math.log(n) + 0.5).to(bf),
        ev=_rnd(cuda, b, 1, hd).to(bf))
    g = _rnd(cuda, b, n, c).to(bf)
    kw = dict(heads=8, scale=32 ** -0.5, spatial_size=n, route=route)
    name = f"linear_bwd_{route}"
    before = _build.LAUNCH_COUNTS[name]
    got = lin.linear_block_bwd(**args, g=g, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCH_COUNTS[name] == before + 1
    want = lin.linear_block_bwd_plain(**args, g=g, **kw)
    _assert_cotangents(("dx", "dgamma", "dw_qkv", "dw_out", "dout_bias",
                        "dek", "dev"), got, want)
    again = lin.linear_block_bwd(**args, g=g, **kw)
    for a, b_ in zip(got, again):
        assert torch.equal(a, b_)


@pytest.mark.parametrize("c", [64, 512])
def test_linear_bwd_kernel_clamp_routes(cuda, c):
    """N = 100 (a ragged tile), head 0's key columns times 40 and its
    conditioning keys ~ 60 N(0, 1), so |k| lies on both sides of 60: the
    merged route follows its clamped twin (dk, dek zero where |k| >= 60),
    the per-head route its unclamped twin, and the twins differ."""
    bf, b, n, hd = torch.bfloat16, 6, 100, 256
    w_qkv = _rnd(cuda, c, 3 * hd) * c ** -0.5
    w_qkv[:, hd:hd + 32] *= 40.0
    ek = _rnd(cuda, b, 1, hd) + math.log(n) + 0.5
    ek[..., :32] = _rnd(cuda, b, 1, 32) * 60.0
    args = dict(
        x=_rnd(cuda, b, n, c).to(bf), gamma=1 + _rnd(cuda, c, scale=0.1),
        w_qkv=w_qkv.to(bf), w_out=(_rnd(cuda, hd, c) * hd ** -0.5).to(bf),
        out_bias=_rnd(cuda, c, scale=0.1), ek=ek.to(bf),
        ev=_rnd(cuda, b, 1, hd).to(bf))
    from videometamaterials_tpu_torch.ops.norms import channel_layer_norm
    k = (channel_layer_norm(args["x"], args["gamma"], one_pass=False).float()
         @ args["w_qkv"][:, hd:hd + 32].float())
    assert (k.abs() > 60).any() and (k.abs() < 60).any()
    g = _rnd(cuda, b, n, c).to(bf)
    names = ("dx", "dgamma", "dw_qkv", "dw_out", "dout_bias", "dek", "dev")
    twins = {}
    for route in ("merged", "head"):
        kw = dict(heads=8, scale=32 ** -0.5, spatial_size=n, route=route)
        twins[route] = lin.linear_block_bwd_plain(**args, g=g, **kw)
        _assert_cotangents(names, lin.linear_block_bwd(**args, g=g, **kw),
                           twins[route])
    gap = (twins["merged"][2] - twins["head"][2]).abs().max()
    assert gap > GRAD_TOL * twins["head"][2].abs().max()


# the kernels against the plain versions that round where they round
# (tests/test_torch_port_linear_bwd_rounding.py): what is left is the
# order of the f32 sums, which can move a bf16 rounding by one ulp (dek,
# whose P (dP - S) cancels, shows it most). The f32 cotangents within
# MODEL_TOL of their max, a tenth of the twins' GRAD_TOL, and nearer the
# rounded version than MODEL_NEAR times the unrounded one's largest share;
# bf16 outputs (dx, the head layout's out) in at most MODEL_BITS of their
# elements different
MODEL_TOL = 5e-3
MODEL_NEAR = 0.5
MODEL_BITS = 0.03


def _model_args(gen, b, n, c, n_cond, heads=8):
    bf, hd = torch.bfloat16, heads * 32
    return dict(
        x=_rnd(gen, b, n, c).to(bf), gamma=1 + _rnd(gen, c, scale=0.1),
        w_qkv=(_rnd(gen, c, 3 * hd) * c ** -0.5).to(bf),
        w_out=(_rnd(gen, hd, c) * hd ** -0.5).to(bf),
        out_bias=_rnd(gen, c, scale=0.1),
        ek=_rnd(gen, b, n_cond, hd).to(bf) if n_cond else None,
        ev=_rnd(gen, b, n_cond, hd).to(bf) if n_cond else None)


def _cpu(t):
    return None if t is None else t.float().cpu()


@pytest.mark.parametrize("n_cond", [0, 6])
@pytest.mark.parametrize("route", ["head", "merged"])
def test_linear_bwd_kernel_matches_its_rounding_model(cuda, route, n_cond):
    """N = 1100 at C = 64: 18 of the stats pass's 64-token sub-tiles and
    two of its 1024-token chunks. Each f32 cotangent within MODEL_TOL of
    its max of the plain version rounding where the kernel rounds, and
    nearer it than the version without the roundings (shares printed); dx
    in at most MODEL_BITS of its elements different."""
    from test_torch_port_linear_bwd_rounding import kernel_rounding_bwd

    b, n, c = 2, 1100, 64
    a = _model_args(cuda, b, n, c, n_cond)
    g = _rnd(cuda, b, n, c).to(torch.bfloat16)
    got = lin.linear_block_bwd(**a, g=g, heads=8, scale=32 ** -0.5,
                               spatial_size=n, route=route)
    names = ("dx", "dgamma", "dw_qkv", "dw_out", "dout_bias", "dek", "dev")
    args = [_cpu(a[k]) for k in ("x", "gamma", "w_qkv", "w_out", "ek", "ev")]
    shares, bits = {}, {}
    for rounded in (True, False):
        want = kernel_rounding_bwd(*args, _cpu(g), heads=8, scale=32 ** -0.5,
                                   spatial_size=n, clip=route == "merged",
                                   rounded=rounded)
        shares[rounded] = {
            name: ((u.float().cpu() - w).abs().max() / w.abs().max()).item()
            for name, u, w in zip(names, got, want) if w is not None}
        bits[rounded] = (got[0].float().cpu() != want[0]).float().mean().item()
    print(f"\n{route} route, {n_cond} cond tokens: share of the model's max, "
          "rounded as the kernel / unrounded: " + ", ".join(
              f"{k} {v:.2e} / {shares[False][k]:.2e}"
              for k, v in shares[True].items())
          + f"; dx elements different {bits[True]:.2e} / {bits[False]:.2e}")
    f32 = [name for name in shares[True] if name != "dx"]
    for name in f32:
        assert shares[True][name] <= MODEL_TOL, (name, shares[True][name])
    assert (max(shares[True][k] for k in f32)
            <= MODEL_NEAR * max(shares[False][k] for k in f32)), shares
    assert bits[True] <= MODEL_BITS, bits


# the any-shape instance (csrc/any_linear_bwd.cu) at its widths, C = 40
# (no multiple of 64), 33 frames of 1100 tokens: the plan's 1024-token
# pass-1 tiles (a running max over 16 sub-tiles, two tiles merged), and
# 4 x 40 pads each head to 48 columns
ANY_MODEL_SHAPES = [(4, 64), (16, 32), (4, 40)]


@pytest.mark.parametrize("route", ["head", "merged"])
@pytest.mark.parametrize("heads,d", ANY_MODEL_SHAPES)
def test_linear_bwd_any_shape_matches_its_rounding_model(cuda, heads, d,
                                                         route):
    """Rows 6-7's any-shape instance against the plain version rounding
    where it rounds (kernel_rounding_bwd at its plan's tile), 6 cond
    tokens: each f32 cotangent within MODEL_TOL of its max and nearer it
    than the version without the roundings (shares printed); dx in at
    most MODEL_BITS of its elements different."""
    from test_torch_port_linear_bwd_rounding import kernel_rounding_bwd

    b, n, c, m_c = 33, 1100, 40, 6
    plan = lin.bwd_any_plan(b, n, c, heads, d)
    assert lin.forward_instance(heads, d, c) == lin.ANY_SHAPE
    a = _linear_bwd_args(cuda, b, n, c, m_c, heads, d)
    g = _rnd(cuda, b, n, c).to(torch.bfloat16)
    got = lin.linear_block_bwd(**a, g=g, heads=heads, scale=d ** -0.5,
                               spatial_size=n, route=route)
    names = ("dx", "dgamma", "dw_qkv", "dw_out", "dout_bias", "dek", "dev")
    args = [_cpu(a[k]) for k in ("x", "gamma", "w_qkv", "w_out", "ek", "ev")]
    shares, bits = {}, {}
    for rounded in (True, False):
        want = kernel_rounding_bwd(*args, _cpu(g), heads=heads,
                                   scale=d ** -0.5, spatial_size=n,
                                   clip=route == "merged", rounded=rounded,
                                   chunk=plan["sums_tile"])
        shares[rounded] = {
            name: ((u.float().cpu() - w).abs().max() / w.abs().max()).item()
            for name, u, w in zip(names, got, want) if w is not None}
        bits[rounded] = (got[0].float().cpu() != want[0]).float().mean().item()
    print(f"\n{heads}x{d} {route} route, tiles of {plan['sums_tile']}: "
          "share of the model's max, rounded / unrounded: " + ", ".join(
              f"{k} {v:.2e} / {shares[False][k]:.2e}"
              for k, v in shares[True].items())
          + f"; dx elements different {bits[True]:.2e} / {bits[False]:.2e}")
    f32 = [name for name in shares[True] if name != "dx"]
    for name in f32:
        assert shares[True][name] <= MODEL_TOL, (name, shares[True][name])
    assert (max(shares[True][k] for k in f32)
            <= MODEL_NEAR * max(shares[False][k] for k in f32)), shares
    assert bits[True] <= MODEL_BITS, bits


# the head layout's plain versions per instance (name: the keywords of
# kernel_rounding_head_fwd): the first rounds where the instance rounds.
# The specialised instance (8 heads of 32) rounds its stats' operands and
# takes Q, ctxn and oh as bf16 hi + lo on the tensor cores; the any-shape
# instance (csrc/any_linear_head.cu) keeps its stats in float32, as bf16
# hi + lo products too ("hi only": the same without oh's lo part)
HEAD_MODELS = {
    "specialised": (8, 64, {"split": dict(rounded=True, parts=2),
                            "f32": dict(rounded=True, parts=None),
                            "unrounded": dict(rounded=False, parts=None)}),
    "any": (4, 96, {"split": dict(rounded=False, stats_parts=2, parts=2),
                    "hi only": dict(rounded=False, stats_parts=2, parts=2,
                                    oh_parts=1),
                    "f32": dict(rounded=False, parts=None)}),
}


@pytest.mark.parametrize("instance", sorted(HEAD_MODELS))
@pytest.mark.parametrize("k_scale", [1.0, 40.0])
def test_linear_head_kernel_matches_its_rounding_model(cuda, k_scale,
                                                       instance):
    """The head-layout forward at N = 1100, one cond token, v times HW * 32
    (an O(1) update, as chip_smoke.py's head inputs), head 0's keys times
    k_scale, x times 0.01 (the LN output does not change; the bf16 output
    then resolves the update), on each instance (HEAD_MODELS: the
    specialised one at 8 heads of 32 and C = 64, the any-shape one at 4
    heads of 32 and C = 96): at most MODEL_BITS of the outputs differ from
    the plain version that rounds where the instance rounds. The shares
    against the other versions are printed beside it; for the any-shape
    instance the version without oh's lo part differs in more than
    MODEL_BITS (what a dropped lo part shows)."""
    from test_torch_port_linear_bwd_rounding import kernel_rounding_head_fwd

    heads, c, models = HEAD_MODELS[instance]
    b, n, hd = 2, 1100, heads * 32
    assert lin.forward_instance(heads, 32, c) == (
        lin.SPECIALISED if instance == "specialised" else lin.ANY_SHAPE)
    a = _model_args(cuda, b, n, c, 1, heads=heads)
    w = a["w_qkv"].float()
    w[:, hd:hd + 32] *= k_scale
    w[:, 2 * hd:] *= n * 32.0
    a["w_qkv"] = w.to(torch.bfloat16)
    a["x"] = (a["x"].float() * 0.01).to(torch.bfloat16)
    name = "linear_head" if instance == "specialised" else "linear_head_any"
    before = _build.LAUNCH_COUNTS[name]
    got = lin.linear_block_head(**a, heads=heads, scale=32 ** -0.5,
                                spatial_size=n).float().cpu()
    assert _build.LAUNCH_COUNTS[name] == before + 1
    x = _cpu(a["x"])
    args = [_cpu(a[k]) for k in ("x", "gamma", "w_qkv", "w_out", "out_bias",
                                 "ek", "ev")]
    # the stats tiles: the specialised instance's 1024-token chunks, the
    # any-shape instance's plan tile
    chunk = ({} if instance == "specialised" else
             dict(chunk=lin.head_any_plan(b, n, c, heads, 32)["stats_tile"]))
    shares, bits, wants = {}, {}, {}
    for model, kw in models.items():
        want = wants[model] = kernel_rounding_head_fwd(
            *args, heads=heads, scale=32 ** -0.5, spatial_size=n, **kw,
            **chunk)
        shares[model] = ((got - want).abs().max()
                         / (want - x).abs().max()).item()
        bits[model] = (got != want).float().mean().item()
    print(f"\nhead layout, {instance} instance, keys x{k_scale:g}: outputs "
          "different " + ", ".join(f"{k} {v:.2e}" for k, v in bits.items())
          + "; update within " + ", ".join(
              f"{k} {v:.2e}" for k, v in shares.items()) + " of its max")
    assert bits["split"] <= MODEL_BITS, bits
    if instance == "any":
        assert (wants["split"] != wants["hi only"]).float().mean() > \
            MODEL_BITS


@pytest.mark.parametrize("bwd", ["recompute", "kernel", "saved"])
def test_fused_plans_send_gradients_to_every_parameter(cuda, bwd):
    """On the card with grad on, the fused plans keep the graph: every
    parameter of a fused block gets a nonzero gradient that matches the
    unfused plan's (the attention blocks at flagship widths, levels 0-1).
    'saved': the backward kernels with temporal_vjp saved, whose temporal
    blocks run the emit_p forward."""
    from videometamaterials_tpu_torch.models.unet3d import (
        SpatialLinearAttentionBlock,
        TemporalAttentionBlock,
        UNet3D,
    )

    model = UNet3D(dim=64, dim_mults=(1, 2), num_frames=11,
                   fused_bwd_kernels=bwd != "recompute",
                   temporal_vjp="saved" if bwd == "saved" else None).cuda()
    model.init_weights(torch.Generator().manual_seed(0))
    x = _rnd(cuda, 2, 11, 16, 16, 3)
    t = torch.tensor([10, 200], device="cuda")
    cond = _rnd(cuda, 2, 11)

    def grads(fused):
        model.zero_grad(set_to_none=True)
        with model.fused_plans(fused):
            eps = model(x, t, cond)
        assert eps.grad_fn is not None
        eps.square().mean().backward()
        return {n: None if p.grad is None else p.grad.clone()
                for n, p in model.named_parameters()}

    counts = dict(_build.LAUNCH_COUNTS)
    fused = grads(True)
    torch.cuda.synchronize()
    # 6 temporal blocks (init, 2 down, mid, 2 up), 4 linear blocks
    n_kernel = _build.LAUNCH_COUNTS["temporal_bwd"] - counts["temporal_bwd"]
    assert n_kernel == (6 if bwd == "kernel" else 0)
    n_p = _build.LAUNCH_COUNTS["temporal_fwd_p"] - counts["temporal_fwd_p"]
    assert n_p == (6 if bwd == "saved" else 0)
    unfused = grads(False)
    names = ["time_rel_pos_bias.relative_attention_bias.weight"]
    for prefix, m in model.named_modules():
        if isinstance(m, (TemporalAttentionBlock,
                          SpatialLinearAttentionBlock)):
            names += [f"{prefix}.{n}" for n, _ in m.named_parameters()]
    assert len(names) == 1 + 6 * 5 + 4 * 6
    for name in names:
        if name.startswith("init_temporal_attn.") and (
                "to_k" in name or "to_v" in name):
            # the init block runs without conditioning tokens
            assert fused[name] is None and unfused[name] is None, name
            continue
        a, b_ = fused[name].float(), unfused[name].float()
        assert a.abs().max() > 0, name
        scale = b_.abs().max().item()
        assert (a - b_).abs().max().item() <= GRAD_TOL * scale, name


# ------------------------------------------- the tensor-core temporal tiles
# The forward's first stage takes 64 positions a block at C <= 128 and 32
# at C >= 256, the backward 32 at every C: S = 150 and 37 leave a ragged
# last tile at both, and 37 a grid of one or two position tiles.


def _temporal_args(gen, b, s, c, t_tok):
    bf, f, hd = torch.bfloat16, 11, 256
    return dict(
        x=_rnd(gen, b, f, s, c).to(bf), gamma=1 + _rnd(gen, c, scale=0.1),
        w_all=(_rnd(gen, f, c, 3 * hd) * c ** -0.5).to(bf),
        w_out=(_rnd(gen, hd, c) * hd ** -0.5).to(bf),
        ek=_rnd(gen, b, t_tok, hd).to(bf) if t_tok else None,
        ev=_rnd(gen, b, t_tok, hd).to(bf) if t_tok else None,
        bias_all=_rnd(gen, f, f + t_tok, 8, scale=0.5))


def _check_temporal_kernels(args, g):
    """Forward, emit_p forward and backward against their twins, each
    launch twice with the same bits, emit_p's out bit-equal to the plain
    launch's."""
    out = tmp.temporal_block_fwd(**args, heads=8)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        out.float(), tmp.temporal_block_plain(**args, heads=8).float(),
        **BF16_TOL)
    assert torch.equal(out, tmp.temporal_block_fwd(**args, heads=8))
    out_p, p = tmp.temporal_block_fwd(**args, heads=8, emit_p=True)
    assert torch.equal(out_p, out)
    _, want_p = tmp.temporal_block_plain_p(**args, heads=8)
    torch.testing.assert_close(p.float(), want_p.float(), **BF16_TOL)
    assert torch.equal(p, tmp.temporal_block_fwd(**args, heads=8,
                                                 emit_p=True)[1])
    got = tmp.temporal_block_bwd(**args, g=g, heads=8)
    torch.cuda.synchronize()
    _assert_cotangents(("dx", "dgamma", "dw_all", "dw_out", "dek", "dev",
                        "dbias"), got,
                       tmp.temporal_block_bwd_plain(**args, g=g, heads=8))
    for a, b_ in zip(got, tmp.temporal_block_bwd(**args, g=g, heads=8)):
        assert a is None or torch.equal(a, b_)


@pytest.mark.parametrize("s,c", [(150, 64), (37, 64), (150, 512), (37, 512)])
@pytest.mark.parametrize("t_tok", [0, 11])
def test_temporal_kernels_ragged_position_tiles(cuda, s, c, t_tok):
    args = _temporal_args(cuda, 2, s, c, t_tok)
    _check_temporal_kernels(args, _rnd(cuda, *args["x"].shape).to(
        torch.bfloat16))


@pytest.mark.parametrize("c", [64, 128, 256, 512])
@pytest.mark.parametrize("t_tok", [0, 11])
def test_temporal_kernels_every_width(cuda, c, t_tok):
    args = _temporal_args(cuda, 3, 96, c, t_tok)
    _check_temporal_kernels(args, _rnd(cuda, *args["x"].shape).to(
        torch.bfloat16))


def test_contraction_is_deterministic_through_linear_bwd(cuda):
    """The split-K contraction (44 chunks of the 32768 rows for dW_qkv,
    128 for dW_out) gives the same bits on a second launch of the merged
    linear backward, and the weight gradients match the twin."""
    bf = torch.bfloat16
    b, n, c, hd = 8, 4096, 64, 256
    args = dict(
        x=_rnd(cuda, b, n, c).to(bf), gamma=1 + _rnd(cuda, c, scale=0.1),
        w_qkv=(_rnd(cuda, c, 3 * hd) * c ** -0.5).to(bf),
        w_out=(_rnd(cuda, hd, c) * hd ** -0.5).to(bf),
        out_bias=_rnd(cuda, c, scale=0.1),
        ek=(_rnd(cuda, b, 1, hd) + math.log(n) + 0.5).to(bf),
        ev=_rnd(cuda, b, 1, hd).to(bf))
    g = _rnd(cuda, b, n, c).to(bf)
    kw = dict(heads=8, scale=32 ** -0.5, spatial_size=n, route="merged")
    got = lin.linear_block_bwd(**args, g=g, **kw)
    torch.cuda.synchronize()
    for a, b_ in zip(got, lin.linear_block_bwd(**args, g=g, **kw)):
        assert torch.equal(a, b_)
    want = lin.linear_block_bwd_plain(**args, g=g, **kw)
    _assert_cotangents(("dw_qkv", "dw_out"), got[2:4], want[2:4])


# -------------------------------------------- the tensor-core linear tiles
# The apply kernel takes 64 tokens a block; the stats 64 (N < 4096) or 256
# tokens a block in sub-tiles of 64, four heads a block. N = 37 is one
# short tile, 100 a ragged second one, 4100 a ragged 256-token block whose
# last sub-tile holds 4 tokens.


def _linear_args(gen, b, n, c, m_c):
    bf, hd = torch.bfloat16, 256
    return dict(
        x=_rnd(gen, b, n, c).to(bf), gamma=1 + _rnd(gen, c, scale=0.1),
        w_qkv=(_rnd(gen, c, 3 * hd) * c ** -0.5).to(bf),
        ek=_rnd(gen, b, m_c, hd).to(bf) if m_c else None,
        ev=_rnd(gen, b, m_c, hd).to(bf) if m_c else None)


@pytest.mark.parametrize("c", [64, 128, 256, 512])
@pytest.mark.parametrize("n", [37, 100, 4100])
@pytest.mark.parametrize("m_c", [0, 1])
def test_linear_stats_kernel_every_width(cuda, c, n, m_c):
    """ctx within 2^-7 of its summands' magnitude, z within 1e-3, one
    launch counted, and the same bits on a second launch (the ordered
    reduce has no atomics)."""
    args = _linear_args(cuda, 2, n, c, m_c)
    kw = dict(heads=8, spatial_size=n)
    before = _build.LAUNCH_COUNTS["linear_stats"]
    ctx_k, z_k = lin.linear_stats(**args, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCH_COUNTS["linear_stats"] == before + 1
    ctx_p, z_p = lin.linear_stats_plain(**args, **kw)
    mag = lin.linear_stats_magnitude(**args, **kw)
    assert torch.isfinite(ctx_k).all()
    assert ((ctx_k - ctx_p).abs() <= CTX_SHARE * mag).all()
    torch.testing.assert_close(z_k, z_p, **STATS_TOL)
    ctx2, z2 = lin.linear_stats(**args, **kw)
    assert torch.equal(ctx_k, ctx2) and torch.equal(z_k, z2)


@pytest.mark.parametrize("c", [64, 128, 256, 512])
@pytest.mark.parametrize("n", [37, 100])
def test_linear_apply_kernel_every_width(cuda, c, n):
    """The update against the twin's at O(1) stats, one launch counted,
    the same bits on a second launch."""
    bf, hd, b = torch.bfloat16, 256, 3
    x = _rnd(cuda, b, n, c).to(bf)
    gamma = 1 + _rnd(cuda, c, scale=0.1)
    w_qkv = (_rnd(cuda, c, 3 * hd) * c ** -0.5).to(bf)
    w_out = (_rnd(cuda, hd, c) * hd ** -0.5).to(bf)
    out_bias = _rnd(cuda, c, scale=0.1)
    ctx, z = _rnd(cuda, b, 8, 32, 32, scale=32.0), 1 + _rnd(cuda, b, hd).abs()
    before = _build.LAUNCH_COUNTS["linear_apply"]
    _assert_apply_matches(x, gamma, w_qkv, w_out, out_bias, ctx, z)
    assert _build.LAUNCH_COUNTS["linear_apply"] == before + 1
    args = (x, gamma, w_qkv, w_out, out_bias, ctx, z)
    assert torch.equal(lin.linear_apply(*args, heads=8, scale=32 ** -0.5),
                       lin.linear_apply(*args, heads=8, scale=32 ** -0.5))


def test_guided_eps_at_the_eval_chunk(cuda):
    """chip_smoke.py phase 6's kernel check: the flagship's guided eps at
    the eval CLI's chunk of 4 videos (CFG 8: temporal batch 8, 88 linear
    frames) through the kernels, 10/8/8 launches, within 0.15 relative L2
    of the unfused plans (chip_smoke.MODEL_TOL)."""
    from videometamaterials_tpu_torch.config import ModelConfig
    from videometamaterials_tpu_torch.sample import build_sampler

    diffusion = build_sampler(ModelConfig(), device="cuda", seed=0)
    x = _rnd(cuda, 4, 11, 96, 96, 3)
    t = torch.full((4,), 128, device="cuda")
    cond = torch.rand((4, 11), generator=cuda, device="cuda") * 2 - 1
    before = dict(_build.LAUNCH_COUNTS)
    with torch.no_grad():
        fused = diffusion.guided_eps(x, t, cond, 5.0)
        torch.cuda.synchronize()
        launched = {k: _build.LAUNCH_COUNTS[k] - before[k] for k in before}
        with diffusion.model.fused_plans(False):
            unfused = diffusion.guided_eps(x, t, cond, 5.0)
    assert launched == {**dict.fromkeys(before, 0), "fused_temporal_block": 10,
                        "linear_stats": 8, "linear_apply": 8}
    assert torch.isfinite(fused).all()
    rel = ((fused - unfused).norm() / unfused.norm()).item()
    assert rel <= 0.15, rel


def test_ddim_and_interpolate_steps_on_the_kernels(cuda):
    """The flagship's DDIM-64 steps (the second pair and the last, whose
    t_next is -1) and a 3-step interpolate at batch 2 through the kernels,
    10/8/8 launches a step, against the same steps on the unfused plans
    with the same noise, at phase 3's bound (0.15 relative L2): a DDIM
    step is linear in the guided eps, so its difference over |d img /
    d eps| is the eps difference; interpolate's steps are DDPM steps,
    held on their result."""
    from videometamaterials_tpu_torch.config import ModelConfig
    from videometamaterials_tpu_torch.sample import build_sampler

    diffusion = build_sampler(ModelConfig(sampling_timesteps=64,
                                          ddim_sampling_eta=0.5),
                              device="cuda", seed=0)
    assert diffusion.is_ddim_sampling
    pairs = diffusion.ddim_pairs()
    assert len(pairs) == 64 and pairs[-1][1] == -1
    x = _rnd(cuda, 1, 11, 96, 96, 3)
    noise = _rnd(cuda, 1, 11, 96, 96, 3)
    cond = torch.rand((1, 11), generator=cuda, device="cuda") * 2 - 1
    per_step = {"fused_temporal_block": 10, "linear_stats": 8,
                "linear_apply": 8}
    for t, t_next in (pairs[1], pairs[-1]):
        before = dict(_build.LAUNCH_COUNTS)
        with torch.no_grad():
            fused = diffusion.ddim_step(x, t, t_next, cond, 5.0, noise)
            torch.cuda.synchronize()
            launched = {k: _build.LAUNCH_COUNTS[k] - before[k]
                        for k in before}
            with diffusion.model.fused_plans(False):
                unfused = diffusion.ddim_step(x, t, t_next, cond, 5.0, noise)
                eps = diffusion.guided_eps(x, torch.full((1,), t,
                                                         device="cuda"),
                                           cond, 5.0).float()
        assert launched == {**dict.fromkeys(before, 0), **per_step}
        assert torch.isfinite(fused).all()
        root = math.sqrt(1.0 / float(diffusion._abar[t]) - 1.0)
        if t_next < 0:
            gain = root
        else:
            sqrt_next, c, _ = diffusion.ddim_coeffs(t, t_next)
            gain = abs(c - sqrt_next * root)
        rel = ((fused - unfused).norm() / (gain * eps.norm())).item()
        assert rel <= 0.15, (t, t_next, rel)

    x1, x2 = _rnd(cuda, 2, 11, 96, 96, 3), _rnd(cuda, 2, 11, 96, 96, 3)
    noises = [_rnd(cuda, 2, 11, 96, 96, 3) for _ in range(5)]
    kw = dict(t=3, lam=0.3, guidance_scale=5.0,
              cond=torch.rand((2, 11), generator=cuda, device="cuda") * 2 - 1,
              noise1=noises[3], noise2=noises[4], noise_fn=noises.__getitem__)
    before = dict(_build.LAUNCH_COUNTS)
    fused = diffusion.interpolate(x1.clamp(-1, 1), x2.clamp(-1, 1), **kw)
    torch.cuda.synchronize()
    launched = {k: _build.LAUNCH_COUNTS[k] - before[k] for k in before}
    assert launched == {**dict.fromkeys(before, 0),
                        **{k: 3 * v for k, v in per_step.items()}}
    with diffusion.model.fused_plans(False):
        unfused = diffusion.interpolate(x1.clamp(-1, 1), x2.clamp(-1, 1),
                                        **kw)
    assert torch.isfinite(fused).all()
    rel = ((fused - unfused).norm() / unfused.norm()).item()
    assert rel <= 0.15, rel


@pytest.mark.parametrize("op", ["conv2d_spatial", "conv_transpose2d_spatial"])
def test_bf16_convolution_rounds_once_on_the_card(cuda, op):
    """torch's bf16 conv2d on the card rounds the product to bf16 before
    it adds the bias (30-34% of outputs off one rounding); the port's
    convolutions outside autograd round once, after the bias, as the
    TPU's output fusion does (tests/test_torch_port_bf16_rounding.py: the
    same on the CPU against the JAX function). At most 2% of outputs may
    differ from one rounding of the float32 result (TF32 off: another
    summation order)."""
    from videometamaterials_tpu_torch.ops import conv

    k = 4 if op == "conv_transpose2d_spatial" else 3
    x = _rnd(cuda, 2, 11, 24, 24, 64).to(torch.bfloat16)
    w = (_rnd(cuda, 64, 64, k, k) / (k * 8)).to(torch.bfloat16)
    b = _rnd(cuda, 64, scale=2.0)
    fn = getattr(conv, op)
    got = fn(x, w, b)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        want = fn(x.float(), w.float(), b).to(torch.bfloat16)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    assert got.dtype == torch.bfloat16
    share = (got != want).float().mean().item()
    print(f"{op}: {share:.4f} of outputs off one rounding (limit 0.02)")
    assert share <= 0.02


# ------------------------------ the conditioning ablations' token counts
# The temporal kernels pad a position's F + T keys to 32, 64 or 80: T = 16
# (the CNN arm, model.yaml's cond_attention_tokens) stays in the 32-key
# instance that takes T at run time, T = 50 (the GRU arm, a token a curve
# point) takes the 64-key one. The linear kernels take the T tokens as Mc
# conditioning tokens of every folded frame.


@pytest.mark.parametrize("s,c", [(150, 64), (37, 512)])
@pytest.mark.parametrize("t_tok", [16, 50])
def test_temporal_kernels_at_the_ablation_token_counts(cuda, s, c, t_tok):
    """Rows 1-3 at T = 16 and 50 against their twins (the bias of the
    conditioning columns random, as a per-frame count would set it, so a
    kernel that drops or misplaces it misses), one launch counted each."""
    args = _temporal_args(cuda, 2, s, c, t_tok)
    before = dict(_build.LAUNCH_COUNTS)
    _check_temporal_kernels(args, _rnd(cuda, *args["x"].shape).to(
        torch.bfloat16))
    assert _build.LAUNCH_COUNTS["fused_temporal_block"] == \
        before["fused_temporal_block"] + 2
    assert _build.LAUNCH_COUNTS["temporal_fwd_p"] == \
        before["temporal_fwd_p"] + 2
    assert _build.LAUNCH_COUNTS["temporal_bwd"] == before["temporal_bwd"] + 2


def test_temporal_kernels_refuse_a_count_above_the_maximum(cuda):
    """The specialised kernels of rows 1-3 take at most MAX_COND_TOKENS
    tokens and their checks still refuse more; the wrappers send a launch
    of more tokens to the any-shape instances, which take it (rows 2 and 3
    against their twins)."""
    t_tok = tmp.MAX_COND_TOKENS + 1
    args = _temporal_args(cuda, 1, 37, 64, t_tok)
    with pytest.raises(ValueError, match="conditioning tokens"):
        tmp._check(**args, heads=8)
    assert tmp.forward_instance(11, 8, 32, 64, t_tok) == tmp.ANY_SHAPE
    before = dict(_build.LAUNCH_COUNTS)
    _check_temporal_kernels(args, _rnd(cuda, *args["x"].shape).to(
        torch.bfloat16))
    assert _build.LAUNCH_COUNTS["temporal_fwd_p_any"] == \
        before["temporal_fwd_p_any"] + 2
    assert _build.LAUNCH_COUNTS["temporal_bwd_any"] == \
        before["temporal_bwd_any"] + 2
    assert _build.LAUNCH_COUNTS["temporal_bwd"] == before["temporal_bwd"]


@pytest.mark.parametrize("c", [64, 512])
@pytest.mark.parametrize("n", [100, 4100])
def test_linear_stats_kernel_at_16_cond_tokens(cuda, c, n):
    """Row 4 with Mc = 16 conditioning tokens: ctx within 2^-7 of its
    summands' magnitude, z within 1e-3, the same bits on a second launch."""
    args = _linear_args(cuda, 2, n, c, 16)
    kw = dict(heads=8, spatial_size=n)
    ctx_k, z_k = lin.linear_stats(**args, **kw)
    torch.cuda.synchronize()
    ctx_p, z_p = lin.linear_stats_plain(**args, **kw)
    mag = lin.linear_stats_magnitude(**args, **kw)
    assert ((ctx_k - ctx_p).abs() <= CTX_SHARE * mag).all()
    torch.testing.assert_close(z_k, z_p, **STATS_TOL)
    ctx2, z2 = lin.linear_stats(**args, **kw)
    assert torch.equal(ctx_k, ctx2) and torch.equal(z_k, z2)


def test_linear_stats_and_apply_at_16_cond_tokens_through_the_block(cuda):
    """Rows 4-5 chained as the block runs them, Mc = 16: the kernels'
    (ctx, z) into the apply kernel against the twins' into the apply twin
    (the update at O(1) stats: the v columns times HW)."""
    bf, hd, b, n, c = torch.bfloat16, 256, 2, 100, 64
    args = _linear_args(cuda, b, n, c, 16)
    w = args["w_qkv"].float()
    w[:, 2 * hd:] *= n * 32.0
    args["w_qkv"] = w.to(bf)
    w_out = (_rnd(cuda, hd, c) * hd ** -0.5).to(bf)
    out_bias = _rnd(cuda, c, scale=0.1)
    kw = dict(heads=8, spatial_size=n)
    ctx, z = lin.linear_stats(**args, **kw)
    got = lin.linear_apply(args["x"], args["gamma"], args["w_qkv"], w_out,
                           out_bias, ctx, z, heads=8, scale=32 ** -0.5)
    ctx_p, z_p = lin.linear_stats_plain(**args, **kw)
    want = lin.linear_apply_plain(args["x"], args["gamma"], args["w_qkv"],
                                  w_out, out_bias, ctx_p, z_p, heads=8,
                                  scale=32 ** -0.5)
    base = args["x"].float() + out_bias
    upd, upd_p = got.float() - base, want.float() - base
    assert (upd - upd_p).abs().max() <= APPLY_TOL * upd_p.abs().max()


@pytest.mark.parametrize("route", ["head", "merged"])
@pytest.mark.parametrize("n,c", [(100, 64), (144, 512)])
def test_linear_bwd_kernel_at_16_cond_tokens(cuda, route, n, c):
    """Rows 6 (per-head) and 7 (merged) with Mc = 16 conditioning tokens
    that together take about half of each feature's token softmax: every
    cotangent within 5e-2 of the twin's max, the same bits twice."""
    bf, hd, b, m_c = torch.bfloat16, 256, 3, 16
    args = dict(
        x=_rnd(cuda, b, n, c).to(bf), gamma=1 + _rnd(cuda, c, scale=0.1),
        w_qkv=(_rnd(cuda, c, 3 * hd) * c ** -0.5).to(bf),
        w_out=(_rnd(cuda, hd, c) * hd ** -0.5).to(bf),
        out_bias=_rnd(cuda, c, scale=0.1),
        ek=(_rnd(cuda, b, m_c, hd) + math.log(n / m_c) + 0.5).to(bf),
        ev=_rnd(cuda, b, m_c, hd).to(bf))
    g = _rnd(cuda, b, n, c).to(bf)
    kw = dict(heads=8, scale=32 ** -0.5, spatial_size=n, route=route)
    got = lin.linear_block_bwd(**args, g=g, **kw)
    torch.cuda.synchronize()
    _assert_cotangents(("dx", "dgamma", "dw_qkv", "dw_out", "dout_bias",
                        "dek", "dev"), got,
                       lin.linear_block_bwd_plain(**args, g=g, **kw))
    for a, b_ in zip(got, lin.linear_block_bwd(**args, g=g, **kw)):
        assert torch.equal(a, b_)


# ------------------------------------------------------- any-shape instances
# rows 1, 4 and 5 at shapes outside the specialised instances' set
# (chip_smoke.py phase 13 runs the whole grid): other frame counts, head
# counts and widths, widths off 16-byte rows (C = 36), T > 69, N and S off
# the tiles, and a tiny model's (3 frames, 2 heads of 4, C = 8: every
# projection shorter than one K step)


def _any_temporal_args(gen, b, f, s, c, t_tok, heads, d):
    bf, hd = torch.bfloat16, heads * d
    return dict(
        x=_rnd(gen, b, f, s, c).to(bf), gamma=1 + _rnd(gen, c, scale=0.1),
        w_all=(_rnd(gen, f, c, 3 * hd) * c ** -0.5).to(bf),
        w_out=(_rnd(gen, hd, c) * hd ** -0.5).to(bf),
        ek=_rnd(gen, b, t_tok, hd).to(bf) if t_tok else None,
        ev=_rnd(gen, b, t_tok, hd).to(bf) if t_tok else None,
        bias_all=_rnd(gen, f, f + t_tok, heads, scale=0.5))


@pytest.mark.parametrize("f,heads,d,c,t_tok", [
    (5, 4, 64, 96, 96), (16, 16, 32, 32, 150), (11, 8, 32, 1024, 11),
    (11, 4, 32, 36, 0), (11, 8, 32, 64, 70), (3, 2, 4, 8, 3)])
def test_temporal_any_shape_instance_matches_twin(cuda, f, heads, d, c,
                                                  t_tok):
    args = _any_temporal_args(cuda, 2, f, 100, c, t_tok, heads, d)
    assert tmp.forward_instance(f, heads, d, c, t_tok) == tmp.ANY_SHAPE
    before = dict(_build.LAUNCH_COUNTS)
    got = tmp.temporal_block_fwd(**args, heads=heads)
    again = tmp.temporal_block_fwd(**args, heads=heads)
    torch.cuda.synchronize()
    assert _build.LAUNCH_COUNTS["temporal_block_any"] == \
        before["temporal_block_any"] + 2
    assert _build.LAUNCH_COUNTS["fused_temporal_block"] == \
        before["fused_temporal_block"]
    assert torch.equal(got, again)
    torch.testing.assert_close(
        got.float(), tmp.temporal_block_plain(**args, heads=heads).float(),
        **BF16_TOL)


# (heads, d, C, Mc, N): 300 tokens (ids as before), d = 40 padded to 48,
# and N = 9191 (a ragged last stats tile and sub-tile)
LINEAR_ANY_CASES = (
    [pytest.param(h, d, c, m, 300, id=f"{h}-{d}-{c}-{m}") for h, d, c, m in (
        (4, 32, 96, 11), (16, 32, 1024, 0), (4, 64, 32, 96), (8, 32, 36, 1),
        (4, 32, 8, 1), (3, 40, 96, 11))]
    + [pytest.param(4, 32, 64, 1, 9191, id="4-32-64-1-N9191")])


@pytest.mark.parametrize("heads,d,c,m_c,n", LINEAR_ANY_CASES)
def test_linear_any_shape_instances_match_twins(cuda, heads, d, c, m_c, n):
    bf, b, hd = torch.bfloat16, 6, heads * d
    x = _rnd(cuda, b, n, c).to(bf)
    gamma = 1 + _rnd(cuda, c, scale=0.1)
    w_qkv = (_rnd(cuda, c, 3 * hd) * c ** -0.5).to(bf)
    w_out = (_rnd(cuda, hd, c) * hd ** -0.5).to(bf)
    out_bias = _rnd(cuda, c, scale=0.1)
    ek = _rnd(cuda, b, m_c, hd).to(bf) if m_c else None
    ev = _rnd(cuda, b, m_c, hd).to(bf) if m_c else None
    kw = dict(heads=heads, spatial_size=n)
    assert lin.forward_instance(heads, d, c) == lin.ANY_SHAPE
    before = dict(_build.LAUNCH_COUNTS)
    ctx_k, z_k = lin.linear_stats(x, gamma, w_qkv, ek, ev, **kw)
    ctx_2, z_2 = lin.linear_stats(x, gamma, w_qkv, ek, ev, **kw)
    torch.cuda.synchronize()
    assert torch.equal(ctx_k, ctx_2) and torch.equal(z_k, z_2)
    ctx_p, z_p = lin.linear_stats_plain(x, gamma, w_qkv, ek, ev, **kw)
    mag = lin.linear_stats_magnitude(x, gamma, w_qkv, ek, ev, **kw)
    assert ((ctx_k - ctx_p).abs() <= CTX_SHARE * mag).all()
    torch.testing.assert_close(z_k, z_p, **STATS_TOL)
    ctx = _rnd(cuda, b, heads, d, d, scale=32.0 * d / 32)
    z = 1 + _rnd(cuda, b, hd).abs()
    args = (x, gamma, w_qkv, w_out, out_bias, ctx, z)
    akw = dict(heads=heads, scale=d ** -0.5)
    got = lin.linear_apply(*args, **akw)
    torch.cuda.synchronize()
    assert torch.equal(got, lin.linear_apply(*args, **akw))
    assert _update_err(got, lin.linear_apply_plain(*args, **akw), x,
                       out_bias) <= APPLY_TOL
    assert _build.LAUNCH_COUNTS["linear_stats_any"] == \
        before["linear_stats_any"] + 2
    assert _build.LAUNCH_COUNTS["linear_apply_any"] == \
        before["linear_apply_any"] + 2
    assert _build.LAUNCH_COUNTS["linear_stats"] == before["linear_stats"]


def test_linear_any_apply_per_head_shift(cuda):
    """Row 5 any-shape at 4 heads of 64: head 0's q logits ~1000x the
    others' (as test_linear_apply_kernel_per_head_shift for the specialised
    instance): the per-head max shift keeps the output finite and the other
    heads exact; head 0's context is zero."""
    bf, b, n, c, heads, d = torch.bfloat16, 4, 100, 64, 4, 64
    hd = heads * d
    w_qkv = _rnd(cuda, c, 3 * hd) * c ** -0.5
    w_qkv[:, :d] *= 1000.0
    ctx = _rnd(cuda, b, heads, d, d, scale=64.0)
    ctx[:, 0] = 0.0
    x = _rnd(cuda, b, n, c).to(bf)
    out_bias = _rnd(cuda, c, scale=0.1)
    args = (x, 1 + _rnd(cuda, c, scale=0.1), w_qkv.to(bf),
            (_rnd(cuda, hd, c) * hd ** -0.5).to(bf), out_bias, ctx,
            1 + _rnd(cuda, b, hd).abs())
    akw = dict(heads=heads, scale=d ** -0.5)
    assert lin.forward_instance(heads, d, c) == lin.ANY_SHAPE
    got = lin.linear_apply(*args, **akw)
    torch.cuda.synchronize()
    assert _update_err(got, lin.linear_apply_plain(*args, **akw), x,
                       out_bias) <= APPLY_TOL


def test_linear_any_stats_clamp_at_60(cuda):
    """Row 4 any-shape with the key columns scaled so |k| lies on both
    sides of 60: the clamp of exp(clip(k, +-60)) in the kernel follows the
    twin's (ctx within CTX_SHARE of its summands, z within STATS_TOL)."""
    bf, b, n, c, heads, d = torch.bfloat16, 6, 300, 96, 4, 32
    hd = heads * d
    w_qkv = _rnd(cuda, c, 3 * hd) * c ** -0.5
    w_qkv[:, hd:2 * hd] *= 40.0
    x = _rnd(cuda, b, n, c).to(bf)
    gamma = 1 + _rnd(cuda, c, scale=0.1)
    w_qkv = w_qkv.to(bf)
    ek, ev = _rnd(cuda, b, 2, hd).to(bf), _rnd(cuda, b, 2, hd).to(bf)
    kw = dict(heads=heads, spatial_size=n)
    y = (x.float() - x.float().mean(-1, keepdim=True))
    k = y @ w_qkv[:, hd:2 * hd].float()
    assert (k.abs() > 70).any() and (k.abs() < 50).any()
    ctx_k, z_k = lin.linear_stats(x, gamma, w_qkv, ek, ev, **kw)
    torch.cuda.synchronize()
    ctx_p, z_p = lin.linear_stats_plain(x, gamma, w_qkv, ek, ev, **kw)
    mag = lin.linear_stats_magnitude(x, gamma, w_qkv, ek, ev, **kw)
    assert torch.isfinite(ctx_k).all() and torch.isfinite(z_k).all()
    assert ((ctx_k - ctx_p).abs() <= CTX_SHARE * mag).all()
    torch.testing.assert_close(z_k, z_p, **STATS_TOL)


def test_any_shape_instances_match_the_specialised(cuda):
    """At a flagship shape (C = 512, 8 heads of 32, T = 11) the any-shape
    instances agree with the specialised ones within the twins'
    tolerances."""
    args = _temporal_args(cuda, 2, 144, 512, 11)
    torch.testing.assert_close(tmp._fwd_any(**args, heads=8).float(),
                               tmp.temporal_block_fwd(**args, heads=8).float(),
                               **BF16_TOL)
    bf, b, n, c, hd = torch.bfloat16, 6, 144, 512, 256
    x = _rnd(cuda, b, n, c).to(bf)
    gamma = 1 + _rnd(cuda, c, scale=0.1)
    w_qkv = (_rnd(cuda, c, 3 * hd) * c ** -0.5).to(bf)
    ek, ev = _rnd(cuda, b, 1, hd).to(bf), _rnd(cuda, b, 1, hd).to(bf)
    kw = dict(heads=8, spatial_size=n)
    ctx_a, z_a = lin._stats_any(x, gamma, w_qkv, ek, ev, **kw)
    ctx_s, z_s = lin.linear_stats(x, gamma, w_qkv, ek, ev, **kw)
    mag = lin.linear_stats_magnitude(x, gamma, w_qkv, ek, ev, **kw)
    assert ((ctx_a - ctx_s).abs() <= CTX_SHARE * mag).all()
    torch.testing.assert_close(z_a, z_s, **STATS_TOL)
    w_out = (_rnd(cuda, hd, c) * hd ** -0.5).to(bf)
    out_bias = _rnd(cuda, c, scale=0.1)
    ctx, z = _rnd(cuda, b, 8, 32, 32, scale=32.0), 1 + _rnd(cuda, b, hd).abs()
    args = (x, gamma, w_qkv, w_out, out_bias, ctx, z)
    akw = dict(heads=8, scale=32 ** -0.5)
    assert _update_err(lin._apply_any(*args, **akw),
                       lin.linear_apply(*args, **akw), x, out_bias) <= \
        APPLY_TOL


# ------------------------------------------ any-shape training instances
# rows 2, 3, 6 and 7 at shapes outside the specialised instances' set
# (chip_smoke.py phase 14 runs the configurations' shapes and the grid)


@pytest.mark.parametrize("f,heads,d,c,t_tok", [
    (5, 4, 64, 96, 96), (16, 16, 32, 32, 150), (11, 8, 32, 1024, 11),
    (11, 4, 64, 64, 0), (11, 8, 32, 64, 70), (3, 2, 4, 8, 3)])
def test_temporal_training_any_shape_instances_match_twins(cuda, f, heads, d,
                                                           c, t_tok):
    """Row 2: out bit-equal to row 1's any-shape launch, p against the twin
    and summing to one; row 3: every cotangent within GRAD_TOL of the
    twin's max; each launch twice with the same bits, one count each."""
    args = _any_temporal_args(cuda, 2, f, 100, c, t_tok, heads, d)
    g = _rnd(cuda, *args["x"].shape).to(torch.bfloat16)
    assert tmp.forward_instance(f, heads, d, c, t_tok) == tmp.ANY_SHAPE
    before = dict(_build.LAUNCH_COUNTS)
    out = tmp.temporal_block_fwd(**args, heads=heads)
    out_p, p = tmp.temporal_block_fwd(**args, heads=heads, emit_p=True)
    again = tmp.temporal_block_fwd(**args, heads=heads, emit_p=True)
    torch.cuda.synchronize()
    assert torch.equal(out_p, out) and torch.equal(p, again[1])
    _, want_p = tmp.temporal_block_plain_p(**args, heads=heads)
    torch.testing.assert_close(p.float(), want_p.float(), **BF16_TOL)
    sums = p.float().reshape(2, f, 100, f + t_tok, heads).sum(dim=3)
    assert (sums - 1).abs().max() <= 2.0 ** -7
    got = tmp.temporal_block_bwd(**args, g=g, heads=heads)
    torch.cuda.synchronize()
    _assert_cotangents(("dx", "dgamma", "dw_all", "dw_out", "dek", "dev",
                        "dbias"), got,
                       tmp.temporal_block_bwd_plain(**args, g=g, heads=heads))
    for a, b_ in zip(got, tmp.temporal_block_bwd(**args, g=g, heads=heads)):
        assert a is None or torch.equal(a, b_)
    counts = {k: _build.LAUNCH_COUNTS[k] - before[k] for k in before}
    assert {k: v for k, v in counts.items() if v} == dict(
        temporal_block_any=1, temporal_fwd_p_any=2, temporal_bwd_any=2)


def _linear_bwd_args(gen, b, n, c, m_c, heads, d):
    bf, hd = torch.bfloat16, heads * d
    return dict(
        x=_rnd(gen, b, n, c).to(bf), gamma=1 + _rnd(gen, c, scale=0.1),
        w_qkv=(_rnd(gen, c, 3 * hd) * c ** -0.5).to(bf),
        w_out=(_rnd(gen, hd, c) * hd ** -0.5).to(bf),
        out_bias=_rnd(gen, c, scale=0.1),
        # the conditioning tokens take about half of each feature's token
        # softmax, so dek, dev and the softmax's S term are seen
        ek=((_rnd(gen, b, m_c, hd) + math.log(n / m_c) + 0.5).to(bf)
            if m_c else None),
        ev=_rnd(gen, b, m_c, hd).to(bf) if m_c else None)


@pytest.mark.parametrize("route", ["head", "merged"])
@pytest.mark.parametrize("heads,d,c,m_c", [
    (4, 32, 96, 11), (16, 32, 1024, 1), (4, 64, 32, 96), (8, 32, 36, 1),
    (4, 32, 8, 0)])
def test_linear_bwd_any_shape_instances_match_twins(cuda, heads, d, c, m_c,
                                                    route):
    """Rows 6 and 7 at other head counts and widths (C off 16-byte rows
    too) and N = 300 (a ragged last tile): every cotangent within GRAD_TOL
    of the twin's max, the same bits twice, one count each."""
    args = _linear_bwd_args(cuda, 3, 300, c, m_c, heads, d)
    g = _rnd(cuda, *args["x"].shape).to(torch.bfloat16)
    kw = dict(heads=heads, scale=d ** -0.5, spatial_size=300, route=route)
    assert lin.forward_instance(heads, d, c) == lin.ANY_SHAPE
    name = f"linear_bwd_{route}_any"
    before = dict(_build.LAUNCH_COUNTS)
    got = lin.linear_block_bwd(**args, g=g, **kw)
    torch.cuda.synchronize()
    _assert_cotangents(("dx", "dgamma", "dw_qkv", "dw_out", "dout_bias",
                        "dek", "dev"), got,
                       lin.linear_block_bwd_plain(**args, g=g, **kw))
    for a, b_ in zip(got, lin.linear_block_bwd(**args, g=g, **kw)):
        assert a is None or torch.equal(a, b_)
    counts = {k: _build.LAUNCH_COUNTS[k] - before[k] for k in before}
    assert {k: v for k, v in counts.items() if v} == {name: 2}


def test_linear_bwd_any_shape_clamp_routes(cuda):
    """4 heads of 32 at C = 96, N = 100, head 0's key columns times 40 and
    its conditioning keys ~ 60 N(0, 1): the merged instance follows its
    clamped twin (dk, dek zero where |k| >= 60), the per-head one its
    unclamped twin, and the twins differ."""
    heads, d, c, n = 4, 32, 96, 100
    args = _linear_bwd_args(cuda, 3, n, c, 1, heads, d)
    w = args["w_qkv"].float()
    w[:, heads * d:heads * d + 32] *= 40.0
    args["w_qkv"] = w.to(torch.bfloat16)
    ek = args["ek"].float()
    ek[..., :32] = _rnd(cuda, 3, 1, 32) * 60.0
    args["ek"] = ek.to(torch.bfloat16)
    g = _rnd(cuda, 3, n, c).to(torch.bfloat16)
    names = ("dx", "dgamma", "dw_qkv", "dw_out", "dout_bias", "dek", "dev")
    twins = {}
    for route in ("merged", "head"):
        kw = dict(heads=heads, scale=d ** -0.5, spatial_size=n, route=route)
        twins[route] = lin.linear_block_bwd_plain(**args, g=g, **kw)
        _assert_cotangents(names, lin.linear_block_bwd(**args, g=g, **kw),
                           twins[route])
    gap = (twins["merged"][2] - twins["head"][2]).abs().max()
    assert gap > GRAD_TOL * twins["head"][2].abs().max()


def test_training_any_shape_instances_match_the_specialised(cuda):
    """At a flagship shape (8 heads of 32, C = 64, T = 11) the any-shape
    instances of rows 2, 3, 6 and 7 agree with the specialised ones within
    the twins' bounds."""
    args = _temporal_args(cuda, 2, 100, 64, 11)
    g = _rnd(cuda, *args["x"].shape).to(torch.bfloat16)
    spec_out, spec_p = tmp.temporal_block_fwd(**args, heads=8, emit_p=True)
    any_out, any_p = tmp._fwd_any(**args, heads=8, emit_p=True)
    torch.testing.assert_close(any_out.float(), spec_out.float(), **BF16_TOL)
    torch.testing.assert_close(any_p.float(), spec_p.float(), **BF16_TOL)
    _assert_cotangents(("dx", "dgamma", "dw_all", "dw_out", "dek", "dev",
                        "dbias"), tmp._bwd_any(**args, g=g, heads=8),
                       tmp.temporal_block_bwd(**args, g=g, heads=8))
    largs = _linear_bwd_args(cuda, 3, 300, 64, 1, 8, 32)
    lg = _rnd(cuda, 3, 300, 64).to(torch.bfloat16)
    operands = [largs[k] for k in ("x", "gamma", "w_qkv", "w_out", "ek",
                                   "ev")]
    for route in ("head", "merged"):
        kw = dict(heads=8, scale=32 ** -0.5, spatial_size=300, route=route)
        _assert_cotangents(("dx", "dgamma", "dw_qkv", "dw_out", "dout_bias",
                            "dek", "dev"), lin._bwd_any(*operands, lg, **kw),
                           lin.linear_block_bwd(**largs, g=lg, **kw))


# ------------------------------------------- row 8 and rows 1-3 any shape


@pytest.mark.parametrize("heads,d,c,m_c", [
    (4, 32, 64, 1), (4, 64, 96, 0), (12, 32, 1024, 11), (8, 32, 40, 96)])
def test_linear_head_any_shape_instance_matches_twin(cuda, heads, d, c, m_c):
    """Row 8 off the flagship's shapes (other head counts and widths, C
    off 16-byte rows, N = 300, 0 to 96 cond tokens): the update within
    APPLY_TOL of the twin's, the same bits twice, one count each and none
    of the specialised instance."""
    args = _head_args(cuda, 6, 300, c, 8.0, heads=heads, d=d, m_c=m_c)
    kw = dict(heads=heads, scale=d ** -0.5, spatial_size=300)
    assert lin.forward_instance(heads, d, c) == lin.ANY_SHAPE
    before = dict(_build.LAUNCH_COUNTS)
    got = lin.linear_block_head(**args, **kw)
    again = lin.linear_block_head(**args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    want = lin.linear_block_head_plain(**args, **kw)
    assert _update_err(got, want, args["x"], args["out_bias"]) <= APPLY_TOL
    counts = {k: _build.LAUNCH_COUNTS[k] - before[k] for k in before}
    assert {k: v for k, v in counts.items() if v} == dict(linear_head_any=2)


@pytest.mark.parametrize("f,heads,d", [(24, 4, 64), (11, 4, 40)])
def test_temporal_any_shape_tensor_core_stages_are_bit_stable(cuda, f, heads,
                                                              d):
    """Rows 1-3's attention stages on the tensor cores at two query tiles
    (F = 24) and at a head width off the k-steps of 16 (d = 40), T = 11,
    S = 144: each row twice with the same bits, row 2's out bit-equal to
    row 1's, and each within the twins' bounds."""
    args = _any_temporal_args(cuda, 2, f, 144, 96, 11, heads, d)
    g = _rnd(cuda, *args["x"].shape).to(torch.bfloat16)
    assert tmp.forward_instance(f, heads, d, 96, 11) == tmp.ANY_SHAPE
    out = tmp.temporal_block_fwd(**args, heads=heads)
    out_p, p = tmp.temporal_block_fwd(**args, heads=heads, emit_p=True)
    again_p = tmp.temporal_block_fwd(**args, heads=heads, emit_p=True)
    torch.cuda.synchronize()
    assert torch.equal(out, tmp.temporal_block_fwd(**args, heads=heads))
    assert torch.equal(out_p, out)
    assert torch.equal(again_p[0], out) and torch.equal(again_p[1], p)
    want_out, want_p = tmp.temporal_block_plain_p(**args, heads=heads)
    torch.testing.assert_close(out.float(), want_out.float(), **BF16_TOL)
    torch.testing.assert_close(p.float(), want_p.float(), **BF16_TOL)
    got = tmp.temporal_block_bwd(**args, g=g, heads=heads)
    for a, b_ in zip(got, tmp.temporal_block_bwd(**args, g=g, heads=heads)):
        assert torch.equal(a, b_)
    _assert_cotangents(("dx", "dgamma", "dw_all", "dw_out", "dek", "dev",
                        "dbias"), got,
                       tmp.temporal_block_bwd_plain(**args, g=g, heads=heads))
