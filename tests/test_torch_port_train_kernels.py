"""PyTorch port, backward kernels on the CPU: each backward twin (what a
backward wrapper runs for a CPU tensor) against the JAX package's backward
kernel in interpret mode and against jax.vjp of its XLA reference, on the
same numpy inputs and cotangent. The CUDA kernels are held against these
twins on the card (tests/test_torch_port_cuda.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videometamaterials_tpu.ops.pallas.fused_linear_block import (
    fused_linear_block as j_fused_linear,
    reference_linear_block,
)
from videometamaterials_tpu.ops.pallas.fused_temporal_block import (
    fused_temporal_block as j_fused_temporal,
    reference_temporal_block,
)
from videometamaterials_tpu_torch.ops.cuda import _build
from videometamaterials_tpu_torch.ops.cuda import fused_linear_block as t_lin
from videometamaterials_tpu_torch.ops.cuda import fused_temporal_block as t_tmp

torch.set_num_threads(1)

# each cotangent within 5e-2 of the oracle's largest |element|, rtol 0,
# and nonzero somewhere: the JAX package's rule for its backward kernels
# (tests/test_fused_temporal_block.py:277,
# tests/test_fused_linear_block.py:205-211), without their 1e-3 floor on
# the max, under which a small cotangent's limit exceeds the cotangent
GRAD_TOL = 5e-2


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def _assert_cotangents(names, got, want):
    for name, a, b in zip(names, got, want):
        if b is None:
            assert a is None, name
            continue
        a32 = a.float().numpy() if isinstance(a, torch.Tensor) \
            else np.asarray(a, np.float32)
        b32 = np.asarray(b, np.float32)
        scale = np.abs(b32).max()
        assert scale > 0, name
        np.testing.assert_allclose(a32 / scale, b32 / scale, rtol=0,
                                   atol=GRAD_TOL, err_msg=name)
        assert np.abs(a32).max() > 0, name


def _jax_vjp(fn, args, g):
    """Cotangents of fn at args (None operands stay None)."""
    present = [i for i, a in enumerate(args) if a is not None]

    def f(*xs):
        full = list(args)
        for i, v in zip(present, xs):
            full[i] = v
        return fn(*full)

    _, vjp = jax.vjp(f, *[args[i] for i in present])
    out = [None] * len(args)
    for i, v in zip(present, vjp(g)):
        out[i] = v
    return out


# ------------------------------------------------------ temporal block
# the shapes of tests/test_fused_temporal_block.py (S = 2 tiles of 128)
B, F, S, C = 2, 5, 256, 8
HEADS, D = 4, 32
HD = HEADS * D
T_NAMES = ("dx", "dgamma", "dw_all", "dw_out", "dek", "dev", "dbias")


def _temporal_args(n_cond):
    return (_rand((B, F, S, C), 0), _rand((C,), 1, 0.2) + 1.0,
            _rand((F, C, 3 * HD), 2, 0.1), _rand((HD, C), 3, 0.1),
            _rand((B, n_cond, HD), 5, 0.5) if n_cond else None,
            _rand((B, n_cond, HD), 6, 0.5) if n_cond else None,
            _rand((F, F + n_cond, HEADS), 7, 0.3))


def _bf16_jax(args):
    bf = jnp.bfloat16
    x, gamma, w_all, w_out, ek, ev, bias = args
    opt = (lambda a: None if a is None else jnp.asarray(a, bf))
    return [jnp.asarray(x, bf), jnp.asarray(gamma), jnp.asarray(w_all, bf),
            jnp.asarray(w_out, bf), opt(ek), opt(ev), jnp.asarray(bias)]


def _bf16_torch(args):
    bf = torch.bfloat16
    x, gamma, w_all, w_out, ek, ev, bias = args
    opt = (lambda a: None if a is None else torch.tensor(a).to(bf))
    return [torch.tensor(x).to(bf), torch.tensor(gamma),
            torch.tensor(w_all).to(bf), torch.tensor(w_out).to(bf), opt(ek),
            opt(ev), torch.tensor(bias)]


@pytest.mark.parametrize("oracle", ["reference_vjp", "interpret_kernel"])
@pytest.mark.parametrize("n_cond", [0, F])
def test_temporal_bwd_twin_matches_jax(n_cond, oracle):
    args = _temporal_args(n_cond)
    g = _rand((B, F, S, C), 8)
    before = dict(_build.LAUNCH_COUNTS)
    got = t_tmp.temporal_block_bwd(*_bf16_torch(args),
                                   torch.tensor(g).to(torch.bfloat16),
                                   heads=HEADS)
    assert _build.LAUNCH_COUNTS == before     # CPU tensor: the twin ran
    if oracle == "reference_vjp":
        def fn(*a):
            return reference_temporal_block(*a, heads=HEADS)
    else:
        def fn(*a):
            return j_fused_temporal(*a, heads=HEADS, tile=128,
                                    interpret=True, bwd_kernel=True)
    # the JAX order is the port's: (x, gamma, w_all, w_out, ek, ev, bias_all)
    want = _jax_vjp(fn, _bf16_jax(args), jnp.asarray(g, jnp.bfloat16))
    _assert_cotangents(T_NAMES, got, want)


def test_temporal_bwd_twin_is_autograd_of_the_forward_twin():
    """The default ('recompute') backward of the differentiable entry point
    and the backward twin give the same cotangents, which reach every
    operand including the trainable bias table and the cond K/V."""
    args = [None if a is None else torch.tensor(a)
            for a in _temporal_args(F)]
    leaves = [a.clone().requires_grad_(True) for a in args]
    out = t_tmp.fused_temporal_block(*leaves, heads=HEADS)
    g = torch.tensor(_rand((B, F, S, C), 8))
    out.backward(g)
    twin = t_tmp.temporal_block_bwd_plain(*args, g, heads=HEADS)
    for name, leaf, want in zip(T_NAMES, leaves, twin):
        torch.testing.assert_close(leaf.grad, want, rtol=1e-5, atol=1e-6,
                                   msg=name)
        assert leaf.grad.abs().max() > 0, name


# ---------------------------------------------------- linear block
# the shapes of tests/test_fused_linear_block.py, float32
B2, N, CL = 6, 16, 8
L_KW = dict(heads=HEADS, scale=D ** -0.5, spatial_size=N)
L_NAMES = ("dx", "dgamma", "dw_qkv", "dw_out", "dout_bias", "dek", "dev")


def _linear_args(n_cond, k_scale=1.0):
    w_qkv = _rand((CL, 3 * HD), 2, 0.1)
    w_qkv[:, HD:HD + D] *= k_scale           # head 0's keys
    return (_rand((B2, N, CL), 0), _rand((CL,), 1, 0.2) + 1.0, w_qkv,
            _rand((HD, CL), 3, 0.1), _rand((CL,), 4, 0.1),
            _rand((B2, n_cond, HD), 5, 0.5) if n_cond else None,
            _rand((B2, n_cond, HD), 6, 0.5) if n_cond else None)


def _jax_linear(args, g, layout):
    jargs = [None if a is None else jnp.asarray(a) for a in args]
    if layout is None:
        def fn(*a):
            return reference_linear_block(*a, **L_KW)
    else:
        def fn(*a):
            return j_fused_linear(*a, **L_KW, interpret=True,
                                  bwd_kernel=True, layout=layout)
    return _jax_vjp(fn, jargs, jnp.asarray(g))


def _twin(args, g, route):
    t_args = [None if a is None else torch.tensor(a) for a in args]
    before = dict(_build.LAUNCH_COUNTS)
    got = t_lin.linear_block_bwd(*t_args, torch.tensor(g), **L_KW,
                                 route=route)
    assert _build.LAUNCH_COUNTS == before
    return got


@pytest.mark.parametrize("oracle", ["reference_vjp", "interpret_kernel"])
@pytest.mark.parametrize("route", ["head", "merged"])
@pytest.mark.parametrize("n_cond", [0, 6])
def test_linear_bwd_twin_matches_jax(n_cond, route, oracle):
    args = _linear_args(n_cond)
    g = _rand((B2, N, CL), 8)
    want = _jax_linear(args, g, None if oracle == "reference_vjp" else route)
    _assert_cotangents(L_NAMES, _twin(args, g, route), want)


def test_linear_bwd_routes_differ_where_k_is_clamped():
    """Head 0's keys scaled so that some |k| > 60: the merged twin matches
    _bwd_kernel_merged (clamped k, dk and dek zero where |k| >= 60), the
    per-head twin matches _bwd_kernel (the unclamped softmax), and the two
    differ from each other."""
    args = _linear_args(6, k_scale=300.0)
    g = _rand((B2, N, CL), 8)
    x, gamma, w_qkv = (torch.tensor(a) for a in args[:3])
    from videometamaterials_tpu_torch.ops.norms import channel_layer_norm
    k = channel_layer_norm(x, gamma, one_pass=False) @ w_qkv[:, HD:2 * HD]
    assert (k.abs() > 60).any() and (k.abs() < 60).any()
    merged = _twin(args, g, "merged")
    head = _twin(args, g, "head")
    _assert_cotangents(L_NAMES, merged, _jax_linear(args, g, "merged"))
    _assert_cotangents(L_NAMES, head, _jax_linear(args, g, "head"))
    scale = head[2].abs().max()
    assert (merged[2] - head[2]).abs().max() > GRAD_TOL * scale


def _jax_route(n, hidden):
    """The backward kernel the JAX _core_bwd picks for the merged layout at
    N tokens and this hidden: its two pallas runs replaced by markers."""
    import importlib

    j_mod = importlib.import_module(
        "videometamaterials_tpu.ops.pallas.fused_linear_block")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_mod, "_run_bwd_kernel", lambda *a, **k: "head")
        mp.setattr(j_mod, "_run_bwd_kernel_merged", lambda *a, **k: "merged")
        residuals = (np.zeros((1, n, 8), np.float32), None, None,
                     np.zeros((hidden, 8), np.float32), None, None, None)
        return j_mod._core_bwd(HEADS, 1.0, n, True, True, "merged",
                               residuals, None)


def test_bwd_route_is_the_jax_rule():
    """Per-head above 12 * N * hidden * 4 B = 40 MiB: the flagship level 0
    (N = 9216), merged at the lower levels; at hidden 128 and 512 the
    block's own hidden decides, where hidden 256 would route the other way
    (N = 4096 at 128, N = 2304 at 512), as the JAX _core_bwd decides."""
    assert t_lin.bwd_route(9216) == "head"
    assert [t_lin.bwd_route(n) for n in (2304, 576, 144)] == ["merged"] * 3
    assert t_lin.bwd_route(3413) == "merged" and t_lin.bwd_route(3414) == "head"
    for hidden, n, want in ((128, 4096, "merged"), (128, 9216, "head"),
                            (512, 2304, "head"), (512, 576, "merged")):
        assert t_lin.bwd_route(n, hidden=hidden) == want == _jax_route(
            n, hidden), (hidden, n)
    assert t_lin.bwd_route(4096) != t_lin.bwd_route(4096, hidden=128)
    assert t_lin.bwd_route(2304) != t_lin.bwd_route(2304, hidden=512)


def test_entry_point_kernel_backward_takes_the_jax_route(monkeypatch):
    """16 heads of 32 (hidden 512) at N = 2304: the entry point's 'kernel'
    backward routes by the block's hidden, per-head as the JAX _core_bwd
    does (hidden 256 would take the merged route)."""
    n, heads, d = 2304, 16, 32
    hd = heads * d
    rng = np.random.default_rng(0)
    args = [torch.tensor(rng.normal(size=s).astype(np.float32) * sc)
            for s, sc in (((1, n, CL), 1.0), ((CL,), 0.1), ((CL, 3 * hd), 0.1),
                          ((hd, CL), 0.1), ((CL,), 0.1))]
    args[1] = args[1] + 1.0
    routes = []
    real = t_lin.linear_block_bwd

    def spy(*a, route, **kw):
        routes.append(route)
        return real(*a, route=route, **kw)

    monkeypatch.setattr(t_lin, "linear_block_bwd", spy)
    leaves = [a.clone().requires_grad_(True) for a in args]
    out = t_lin.fused_linear_block(*leaves, None, None, heads=heads,
                                   scale=d ** -0.5, spatial_size=n,
                                   bwd="kernel")
    out.backward(torch.ones_like(out))
    assert routes == [_jax_route(n, hd)] == ["head"]
    assert all(leaf.grad.abs().max() > 0 for leaf in leaves)


@pytest.mark.parametrize("bwd", ["recompute", "kernel"])
def test_linear_entry_point_backward_plans(bwd):
    """The differentiable entry point's two backward plans on the CPU:
    'recompute' is autograd through the forward twins, 'kernel' the
    backward twin on the JAX route; both reach every operand."""
    args = [None if a is None else torch.tensor(a) for a in _linear_args(1)]
    g = torch.tensor(_rand((B2, N, CL), 8))
    leaves = [a.clone().requires_grad_(True) for a in args]
    t_lin.fused_linear_block(*leaves, **L_KW, bwd=bwd).backward(g)
    if bwd == "kernel":
        want = t_lin.linear_block_bwd_plain(*args, g, **L_KW,
                                            route=t_lin.bwd_route(N))
    else:
        want = t_lin.linear_block_recompute(*args, g, **L_KW)
    for name, leaf, w in zip(L_NAMES, leaves, want):
        torch.testing.assert_close(leaf.grad, w, rtol=1e-5, atol=1e-6,
                                   msg=name)
        assert leaf.grad.abs().max() > 0, name
