"""PyTorch port, kernel modules on the CPU: each plain twin (what a kernel
wrapper runs for a CPU tensor) against the JAX package's XLA reference and
its Pallas kernel in interpret mode, on the same numpy inputs. The CUDA
kernels themselves are held against these twins on the card
(tests/test_torch_port_cuda.py, chip_smoke.py)."""

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


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


# ------------------------------------------------------ temporal block
# shapes of tests/test_fused_temporal_block.py (S = 2 tiles of 128)
B, F, S, C = 2, 5, 256, 8
HEADS, D = 4, 32
HD = HEADS * D
# bf16 operands: the twin, the XLA reference and the interpret-mode kernel
# round at different places (the reference keeps the softmax weights in
# f32, the kernel rounds them to bf16) -- the JAX kernel test's tolerance
# (tests/test_fused_temporal_block.py:50)
TEMPORAL_TOL = dict(rtol=3e-2, atol=3e-2)


def _temporal_inputs(n_cond):
    x = _rand((B, F, S, C), 0)
    gamma = _rand((C,), 1, 0.2) + 1.0
    w_all = _rand((F, C, 3 * HD), 2, 0.1)
    w_out = _rand((HD, C), 3, 0.1)
    ek = _rand((B, n_cond, HD), 5, 0.5) if n_cond else None
    ev = _rand((B, n_cond, HD), 6, 0.5) if n_cond else None
    bias_all = _rand((F, F + n_cond, HEADS), 7, 0.3)
    return x, gamma, w_all, w_out, ek, ev, bias_all


def _as_jax(args):
    x, gamma, w_all, w_out, ek, ev, bias = args
    bf = jnp.bfloat16
    opt = (lambda a: None if a is None else jnp.asarray(a, bf))
    return (jnp.asarray(x, bf), jnp.asarray(gamma), jnp.asarray(w_all, bf),
            jnp.asarray(w_out, bf), opt(ek), opt(ev), jnp.asarray(bias))


def _as_torch(args):
    x, gamma, w_all, w_out, ek, ev, bias = args
    bf = torch.bfloat16
    opt = (lambda a: None if a is None else torch.tensor(a).to(bf))
    return (torch.tensor(x).to(bf), torch.tensor(gamma),
            torch.tensor(w_all).to(bf), torch.tensor(w_out).to(bf), opt(ek),
            opt(ev), torch.tensor(bias))


@pytest.mark.parametrize("oracle", ["reference", "interpret_kernel"])
@pytest.mark.parametrize("n_cond", [0, F])
def test_temporal_twin_matches_jax(n_cond, oracle):
    args = _temporal_inputs(n_cond)
    before = dict(_build.LAUNCH_COUNTS)
    got = t_tmp.fused_temporal_block(*_as_torch(args), heads=HEADS)
    assert _build.LAUNCH_COUNTS == before     # CPU tensor: the twin ran
    if oracle == "reference":
        want = reference_temporal_block(*_as_jax(args), heads=HEADS)
    else:
        want = j_fused_temporal(*_as_jax(args), heads=HEADS, tile=128,
                                interpret=True, softmax_layout="split")
    got = got.float().numpy()
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               **TEMPORAL_TOL)
    assert not np.allclose(got, np.asarray(_as_jax(args)[0], np.float32))


def test_temporal_twin_float32_matches_reference_tightly():
    """In float32 the twin rounds nowhere: it is the reference's function
    (two-pass LN against the reference's one-pass: 1e-4)."""
    args = _temporal_inputs(F)
    t_args = [None if a is None else torch.tensor(a) for a in args]
    got = t_tmp.temporal_block_plain(*t_args, heads=HEADS)
    want = reference_temporal_block(
        *[None if a is None else jnp.asarray(a) for a in args], heads=HEADS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


# ---------------------------------------------------- linear block
# shapes of tests/test_fused_linear_block.py
B2, N, CL = 6, 16, 8
# float32 operands: only the summation order differs
# (tests/test_fused_linear_block.py:48)
LINEAR_TOL = dict(rtol=2e-4, atol=2e-4)
LIN_KW = dict(heads=HEADS, scale=D ** -0.5, spatial_size=N)


def _linear_inputs(n_cond):
    return (_rand((B2, N, CL), 0), _rand((CL,), 1, 0.2) + 1.0,
            _rand((CL, 3 * HD), 2, 0.1), _rand((HD, CL), 3, 0.1),
            _rand((CL,), 4, 0.1),
            _rand((B2, n_cond, HD), 5, 0.5) if n_cond else None,
            _rand((B2, n_cond, HD), 6, 0.5) if n_cond else None)


def _lin_torch(args):
    return [None if a is None else torch.tensor(a) for a in args]


def _lin_jax(args):
    return [None if a is None else jnp.asarray(a) for a in args]


@pytest.mark.parametrize("oracle", ["reference", "interpret_kernel"])
@pytest.mark.parametrize("n_cond", [0, 1, 6])
def test_linear_twin_matches_jax(n_cond, oracle):
    args = _linear_inputs(n_cond)
    before = dict(_build.LAUNCH_COUNTS)
    got = t_lin.fused_linear_block(*_lin_torch(args), **LIN_KW)
    assert _build.LAUNCH_COUNTS == before
    if oracle == "reference":
        want = reference_linear_block(*_lin_jax(args), **LIN_KW)
    else:
        want = j_fused_linear(*_lin_jax(args), interpret=True,
                              layout="merged", **LIN_KW)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LINEAR_TOL)


def test_linear_twin_finite_under_extreme_scales():
    """The case pinned by tests/test_fused_linear_block.py:288: (a) one
    head's q logits ~200 above the others' (the per-head max shift keeps
    the q softmax exact); (b) a feature whose k logits all sit below exp's
    underflow (the symmetric clamp keeps z > 0: finiteness only)."""
    args = list(_linear_inputs(0))
    args[2] = args[2].copy()
    args[2][:, 0:D] *= 1000.0
    got = t_lin.fused_linear_block(*_lin_torch(args), **LIN_KW).numpy()
    assert np.isfinite(got).all()
    want = reference_linear_block(*_lin_jax(args), **LIN_KW)
    np.testing.assert_allclose(got, np.asarray(want), **LINEAR_TOL)

    args = list(_linear_inputs(0))
    args[0] = args[0].copy()
    args[0][:, :, 0] = 10.0
    args[2] = args[2].copy()
    args[2][:, HD:2 * HD] = 0.0
    args[2][0, HD] = -80.0
    got = t_lin.fused_linear_block(*_lin_torch(args), **LIN_KW).numpy()
    assert np.isfinite(got).all()
    want = j_fused_linear(*_lin_jax(args), interpret=True, layout="merged",
                          **LIN_KW)
    np.testing.assert_allclose(got, np.asarray(want), **LINEAR_TOL)


def test_linear_stats_twin_is_the_compact_merged_context():
    """The twin's (B, heads, d, d) context holds the diagonal (d, d) blocks
    of the full (hidden, hidden) context that the JAX stats kernel computes
    before its head mask, here computed with numpy; the summands'
    magnitude (the scale of the card check's ctx bound) likewise."""
    from videometamaterials_tpu.ops.norms import channel_layer_norm

    args = _linear_inputs(1)
    x, gamma, w_qkv, _, _, ek, ev = args
    ctx, z = t_lin.linear_stats_plain(*_lin_torch((x, gamma, w_qkv, ek, ev)),
                                      heads=HEADS, spatial_size=N)
    y = np.asarray(channel_layer_norm(jnp.asarray(x), jnp.asarray(gamma)))
    kv = y @ w_qkv[:, HD:]
    pk = np.exp(np.clip(kv[..., :HD], -60, 60))
    pkc = np.exp(np.clip(ek, -60, 60))
    v = np.concatenate([ev, kv[..., HD:]], axis=1) / N
    full = np.einsum("bna,bne->bae", np.concatenate([pkc, pk], axis=1), v)
    full_abs = np.einsum("bna,bne->bae", np.concatenate([pkc, pk], axis=1),
                         np.abs(v))
    mag = t_lin.linear_stats_magnitude(
        *_lin_torch((x, gamma, w_qkv, ek, ev)), heads=HEADS, spatial_size=N)
    for h in range(HEADS):
        sl = slice(h * D, (h + 1) * D)
        np.testing.assert_allclose(ctx[:, h].numpy(), full[:, sl, sl],
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(mag[:, h].numpy(), full_abs[:, sl, sl],
                                   rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(z.numpy(), pk.sum(1) + pkc.sum(1), rtol=1e-5)


def test_wrappers_raise_on_what_the_kernels_do_not_take():
    """The input checks run before any build and refuse what the kernels do
    not take (here: tensors off the card, with unsupported shapes)."""
    x = torch.zeros((2, 5, 16, 8), dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        t_tmp._check(x, torch.ones(8), torch.zeros((5, 8, 768)),
                     torch.zeros((256, 8)), None, None,
                     torch.zeros((5, 5, 8)), 8)
    with pytest.raises(ValueError):
        t_lin._check_common(torch.zeros((2, 16, 8)), torch.ones(8),
                            torch.zeros((8, 768)), 8)


def test_failed_build_raises(tmp_path, monkeypatch):
    """No nvcc, no library: the build raises instead of falling back."""
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "Path", _NoDefaultCuda)
    _build.build_info.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc"):
            _build.build_info()
    finally:
        _build.build_info.cache_clear()


class _NoDefaultCuda(type(_build.Path())):
    def exists(self):
        return False if str(self).startswith("/usr/local/cuda") else \
            super().exists()
