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


def _head_args(gen, b, n, c, k_scale):
    """Head-layout inputs with an O(1) update beside x: the v columns of
    w_qkv times HW (undoing v / HW) and 32, the key columns times k_scale
    (8: the token softmax picks few tokens, so ctx is no average near 0)."""
    bf, hd = torch.bfloat16, 256
    w_qkv = _rnd(gen, c, 3 * hd) * c ** -0.5
    w_qkv[:, hd:2 * hd] *= k_scale
    w_qkv[:, 2 * hd:] *= n * 32.0
    return dict(x=_rnd(gen, b, n, c).to(bf), gamma=1 + _rnd(gen, c, scale=0.1),
                w_qkv=w_qkv.to(bf),
                w_out=(_rnd(gen, hd, c) * hd ** -0.5).to(bf),
                out_bias=_rnd(gen, c, scale=0.1),
                ek=_rnd(gen, b, 1, hd).to(bf), ev=_rnd(gen, b, 1, hd).to(bf))


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
    x = torch.zeros((2, 11, 16, 48), dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="C in"):
        tmp.fused_temporal_block(
            x, torch.ones(48, device="cuda"),
            torch.zeros((11, 48, 768), dtype=torch.bfloat16, device="cuda"),
            torch.zeros((256, 48), dtype=torch.bfloat16, device="cuda"),
            None, None, torch.zeros((11, 11, 8), device="cuda"), heads=8)


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


def _model_args(gen, b, n, c, n_cond):
    bf, hd = torch.bfloat16, 256
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


@pytest.mark.parametrize("k_scale", [1.0, 40.0])
def test_linear_head_kernel_matches_its_rounding_model(cuda, k_scale):
    """The head-layout forward at N = 1100, C = 64, one cond token, v times
    HW * 32 (an O(1) update, as chip_smoke.py's head inputs), head 0's keys
    times k_scale, x times 0.01 (the LN output does not change; the bf16
    output then resolves the update): at most MODEL_BITS of the outputs
    differ from the plain version whose stats round as the kernel's and
    whose apply splits Q, ctxn and oh into bf16 hi + lo as the kernel's.
    The shares against that version with a float32 apply and against the
    unrounded version are printed beside it."""
    from test_torch_port_linear_bwd_rounding import kernel_rounding_head_fwd

    b, n, c, hd = 2, 1100, 64, 256
    a = _model_args(cuda, b, n, c, 1)
    w = a["w_qkv"].float()
    w[:, hd:hd + 32] *= k_scale
    w[:, 2 * hd:] *= n * 32.0
    a["w_qkv"] = w.to(torch.bfloat16)
    a["x"] = (a["x"].float() * 0.01).to(torch.bfloat16)
    got = lin.linear_block_head(**a, heads=8, scale=32 ** -0.5,
                                spatial_size=n).float().cpu()
    x = _cpu(a["x"])
    args = [_cpu(a[k]) for k in ("x", "gamma", "w_qkv", "w_out", "out_bias",
                                 "ek", "ev")]
    shares, bits = {}, {}
    for name, rounded, parts in (("split", True, 2), ("f32", True, None),
                                 ("unrounded", False, None)):
        want = kernel_rounding_head_fwd(*args, heads=8, scale=32 ** -0.5,
                                        spatial_size=n, rounded=rounded,
                                        parts=parts)
        shares[name] = ((got - want).abs().max()
                        / (want - x).abs().max()).item()
        bits[name] = (got != want).float().mean().item()
    print(f"\nhead layout, keys x{k_scale:g}: outputs different "
          + ", ".join(f"{bits[k]:.2e}" for k in bits)
          + "; update within "
          + ", ".join(f"{shares[k]:.2e}" for k in shares)
          + " of its max (the model rounded as the kernel with the apply "
          "split / with a float32 apply / unrounded)")
    assert bits["split"] <= MODEL_BITS, bits


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
