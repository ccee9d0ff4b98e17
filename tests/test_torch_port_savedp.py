"""PyTorch port, the `temporal_vjp: saved` plan on the CPU: the temporal
twin's (out, p) against the JAX forward kernel with emit_p in interpret
mode, the port's temporal_bwd_from_p against the JAX function on the JAX
kernel's p, and the saved plan's gradients against jax.vjp of the JAX
fused_temporal_block(vjp_mode="saved"). The emit_p CUDA kernel is held
against the twin on the card (tests/test_torch_port_cuda.py,
chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videometamaterials_tpu.ops.pallas.fused_temporal_block import (
    _run_kernel as j_run_kernel,
    fused_temporal_block as j_fused_temporal,
    temporal_bwd_from_p as j_bwd_from_p,
)
from videometamaterials_tpu_torch.ops.cuda import _build
from videometamaterials_tpu_torch.ops.cuda import fused_temporal_block as t_tmp

torch.set_num_threads(1)

# the shapes of tests/test_fused_temporal_block.py (S = 2 tiles of 128)
B, F, S, C = 2, 5, 256, 8
HEADS, D = 4, 32
HD = HEADS * D
# bf16 outputs and weights: the JAX kernel test's tolerance
# (tests/test_fused_temporal_block.py:50)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)
# temporal_bwd_from_p on the same p: float32 weights differ in summation
# order only (1e-4 of each cotangent's max); bf16 weights round the
# projection and its cotangents in different places (5e-2, the JAX rule
# for its backward plans, tests/test_fused_temporal_block.py:277)
F32_SHARE, BF16_SHARE = 1e-4, 5e-2
NAMES = ("dx", "dgamma", "dw_all", "dw_out", "dek", "dev", "dbias")


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def _args(n_cond):
    return (_rand((B, F, S, C), 0), _rand((C,), 1, 0.2) + 1.0,
            _rand((F, C, 3 * HD), 2, 0.1), _rand((HD, C), 3, 0.1),
            _rand((B, n_cond, HD), 5, 0.5) if n_cond else None,
            _rand((B, n_cond, HD), 6, 0.5) if n_cond else None,
            _rand((F, F + n_cond, HEADS), 7, 0.3))


def _jax(args, dtype):
    """gamma and the bias stay float32, as the model passes them."""
    x, gamma, w_all, w_out, ek, ev, bias = args
    opt = (lambda a: None if a is None else jnp.asarray(a, dtype))
    return [jnp.asarray(x, dtype), jnp.asarray(gamma),
            jnp.asarray(w_all, dtype), jnp.asarray(w_out, dtype), opt(ek),
            opt(ev), jnp.asarray(bias)]


def _torch(args, dtype):
    x, gamma, w_all, w_out, ek, ev, bias = args
    opt = (lambda a: None if a is None else torch.tensor(a).to(dtype))
    return [torch.tensor(x).to(dtype), torch.tensor(gamma),
            torch.tensor(w_all).to(dtype), torch.tensor(w_out).to(dtype),
            opt(ek), opt(ev), torch.tensor(bias)]


def _assert_shares(names, got, want, share):
    """Each cotangent within `share` of its oracle's largest |element|."""
    for name, a, b in zip(names, got, want):
        if b is None:
            assert a is None, name
            continue
        a32 = a.float().numpy()
        b32 = np.asarray(b, np.float32)
        scale = np.abs(b32).max()
        assert scale > 0, name
        np.testing.assert_allclose(a32 / scale, b32 / scale, rtol=0,
                                   atol=share, err_msg=name)
        assert np.abs(a32).max() > 0, name


@pytest.mark.parametrize("n_cond", [0, F])
def test_twin_out_and_p_match_the_emit_p_kernel(n_cond):
    """The wrapper on CPU tensors (the twin) gives the JAX merged-layout
    kernel's out and p, lanes key-group-major; p sums to one per position
    and head."""
    args = _args(n_cond)
    before = dict(_build.LAUNCH_COUNTS)
    out, p = t_tmp.temporal_block_fwd(*_torch(args, torch.bfloat16),
                                      heads=HEADS, emit_p=True)
    assert _build.LAUNCH_COUNTS == before     # CPU tensor: the twin ran
    want_out, want_p = j_run_kernel(
        *_jax(args, jnp.bfloat16), heads=HEADS, tile=128, interpret=True,
        softmax_layout="merged", emit_p=True)
    assert p.dtype == torch.bfloat16
    assert tuple(p.shape) == (B, F, S, (F + n_cond) * HEADS)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want_out, np.float32), **BF16_TOL)
    np.testing.assert_allclose(p.float().numpy(),
                               np.asarray(want_p, np.float32), **BF16_TOL)
    # bf16 keeps 8 significant bits: each weight within 2^-8 of its value,
    # the sum within 2^-8 of one, and float32 sums besides
    sums = p.float().reshape(B, F, S, F + n_cond, HEADS).sum(dim=3)
    torch.testing.assert_close(sums, torch.ones_like(sums), rtol=0,
                               atol=2.0 ** -7)


@pytest.mark.parametrize("dtype,n_cond", [("float32", 0), ("float32", F),
                                          ("bfloat16", F)])
def test_bwd_from_p_matches_jax(dtype, n_cond):
    """On the JAX kernel's own p, the port's temporal_bwd_from_p gives the
    JAX function's seven cotangents."""
    args = _args(n_cond)
    jargs = _jax(args, getattr(jnp, dtype))
    _, p = j_run_kernel(*jargs, heads=HEADS, tile=128, interpret=True,
                        softmax_layout="merged", emit_p=True)
    g = _rand((B, F, S, C), 8)
    want = j_bwd_from_p(*jargs, p, jnp.asarray(g, jargs[0].dtype),
                        heads=HEADS)
    tdt = getattr(torch, dtype)
    p_t = torch.tensor(np.asarray(p, np.float32)).to(torch.bfloat16)
    got = t_tmp.temporal_bwd_from_p(*_torch(args, tdt), p_t,
                                    torch.tensor(g).to(tdt), heads=HEADS)
    _assert_shares(NAMES, got, want,
                   F32_SHARE if dtype == "float32" else BF16_SHARE)


@pytest.mark.parametrize("n_cond", [0, F])
def test_saved_plan_gradients_match_jax_vjp(n_cond):
    """fused_temporal_block(bwd='saved') against jax.vjp of the JAX
    fused_temporal_block(vjp_mode='saved') (interpret mode), bf16, every
    operand's cotangent within 5e-2 of its max, the position bias's
    included; the forward is the twin's out."""
    args = _args(n_cond)
    g = _rand((B, F, S, C), 8)
    t_args = _torch(args, torch.bfloat16)
    leaves = [None if a is None else a.clone().requires_grad_(True)
              for a in t_args]
    out = t_tmp.fused_temporal_block(*leaves, heads=HEADS, bwd="saved")
    assert torch.equal(out, t_tmp.temporal_block_plain(*t_args, heads=HEADS))
    out.backward(torch.tensor(g).to(torch.bfloat16))
    got = [None if a is None else a.grad for a in leaves]

    jargs = _jax(args, jnp.bfloat16)
    present = [i for i, a in enumerate(jargs) if a is not None]

    def fn(*xs):
        full = list(jargs)
        for i, v in zip(present, xs):
            full[i] = v
        return j_fused_temporal(*full, heads=HEADS, tile=128, interpret=True,
                                vjp_mode="saved")

    _, vjp = jax.vjp(fn, *[jargs[i] for i in present])
    want = [None] * 7
    for i, v in zip(present, vjp(jnp.asarray(g, jnp.bfloat16))):
        want[i] = v
    _assert_shares(NAMES, got, want, BF16_SHARE)


def test_saved_plan_without_grad_runs_the_plain_forward(monkeypatch):
    """Nothing needs a gradient (sampling under a saved-plan config): no p
    is asked for, the plain forward runs."""
    calls = []
    fwd = t_tmp.temporal_block_fwd

    def spy(*a, **kw):
        calls.append(kw.get("emit_p", False))
        return fwd(*a, **kw)

    monkeypatch.setattr(t_tmp, "temporal_block_fwd", spy)
    t_args = _torch(_args(F), torch.bfloat16)
    with torch.no_grad():
        out = t_tmp.fused_temporal_block(*t_args, heads=HEADS, bwd="saved")
    leaves = [None if a is None else a.clone().requires_grad_(True)
              for a in t_args]
    out_grad = t_tmp.fused_temporal_block(*leaves, heads=HEADS, bwd="saved")
    assert calls == [False, True]
    assert torch.equal(out, out_grad.detach())
