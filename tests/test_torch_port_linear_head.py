"""PyTorch port, the head-layout linear block and the repaired recompute
backward on the CPU: the head twin against the JAX fused_linear_block
(layout="head") in interpret mode, with |k| on both sides of the merged
stats' +-60 clamp; the backward route under that layout; the
VMT_LINEAR_LAYOUT switch through UNet3D against the JAX model under the
same switch; and the 'recompute' cotangents against jax.vjp of the JAX
entry point where the clamp bites. The head CUDA kernel is held against
the twin on the card (tests/test_torch_port_cuda.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videometamaterials_tpu.models import UNet3D as JUNet3D
from videometamaterials_tpu.ops.pallas.fused_linear_block import (
    fused_linear_block as j_fused_linear,
)
from videometamaterials_tpu_torch.convert import flax_to_torch_state_dict
from videometamaterials_tpu_torch.models.unet3d import UNet3D
from videometamaterials_tpu_torch.ops.cuda import _build
from videometamaterials_tpu_torch.ops.cuda import fused_linear_block as t_lin
from videometamaterials_tpu_torch.ops.norms import channel_layer_norm

torch.set_num_threads(1)

# the shapes of tests/test_fused_linear_block.py, float32
B, N, C = 6, 16, 8
HEADS, D = 4, 32
HD = HEADS * D
KW = dict(heads=HEADS, scale=D ** -0.5, spatial_size=N)
# float32 operands: only the summation order differs
# (tests/test_fused_linear_block.py:48)
F32_TOL = dict(rtol=2e-4, atol=2e-4)
# k_scale multiplies head 0's key weights: at 300 its |k| lies on both
# sides of the merged stats' clamp (tests/test_torch_port_train_kernels.py
# :191)
K_SCALE = 300.0


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def _args(n_cond, k_scale=1.0, b=B, n=N, c=C, hd=HD, d=D):
    w_qkv = _rand((c, 3 * hd), 2, 0.1)
    w_qkv[:, hd:hd + d] *= k_scale           # head 0's keys
    return (_rand((b, n, c), 0), _rand((c,), 1, 0.2) + 1.0, w_qkv,
            _rand((hd, c), 3, 0.1), _rand((c,), 4, 0.1),
            _rand((b, n_cond, hd), 5, 0.5) if n_cond else None,
            _rand((b, n_cond, hd), 6, 0.5) if n_cond else None)


def _torch(args):
    return [None if a is None else torch.tensor(a) for a in args]


def _jax(args):
    return [None if a is None else jnp.asarray(a) for a in args]


def _keys(args, hd=HD):
    x, gamma, w_qkv = _torch(args[:3])
    return channel_layer_norm(x, gamma, one_pass=False) @ w_qkv[:, hd:2 * hd]


@pytest.mark.parametrize("k_scale", [1.0, K_SCALE])
@pytest.mark.parametrize("n_cond", [0, 1])
def test_head_twin_matches_the_jax_head_kernel(n_cond, k_scale):
    args = _args(n_cond, k_scale)
    if k_scale > 1:
        k = _keys(args)
        assert (k.abs() > 60).any() and (k.abs() < 60).any()
    before = dict(_build.LAUNCH_COUNTS)
    got = t_lin.fused_linear_block(*_torch(args), **KW, layout="head")
    assert _build.LAUNCH_COUNTS == before     # CPU tensor: the twin ran
    torch.testing.assert_close(
        got, t_lin.linear_block_head(*_torch(args), **KW), rtol=0, atol=0)
    want = np.asarray(j_fused_linear(*_jax(args), **KW, interpret=True,
                                     layout="head"))
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    if k_scale > 1:   # the clamped merged twin misses the same bound here
        merged = t_lin.fused_linear_block(*_torch(args), **KW,
                                          layout="merged").numpy()
        assert not np.allclose(merged, want, **F32_TOL)


def test_bwd_route_of_the_head_layout_is_per_head():
    """Under layout='head' the JAX _core_bwd (:574-588) sends every shape
    to the per-head backward; only 'merged' routes by the 40 MiB rule."""
    for n in (144, 576, 2304, 3413, 3414, 9216):
        assert t_lin.bwd_route(n, layout="head") == "head"
    assert t_lin.bwd_route(2304, layout="merged") == "merged"


def test_layout_switch_reaches_the_head_twin_through_unet3d(monkeypatch):
    """VMT_LINEAR_LAYOUT=head, the JAX package's own switch, sends every
    fused linear block of UNet3D to the head layout (no new argument), and
    the model's eps matches the JAX model's under the same switch."""
    # 4 heads: 4 x 32 = 128 takes the fused plan (the JAX gate)
    tiny = dict(dim=8, dim_mults=(1, 2), channels=3, attn_heads=4,
                attn_dim_head=8, init_kernel_size=3,
                use_temporal_attention_cond=True, per_frame_cond=True)
    frames, img = 11, 8
    j_model = JUNet3D(compute_dtype="float32", use_fused_linear_block=True,
                      **tiny)
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (1, frames, img, img, 3)).astype(np.float32)
    time = np.array([5], np.int32)
    cond = rng.uniform(-1, 1, (1, frames)).astype(np.float32)
    # a random tree of the model's structure (eval_shape: no init run),
    # LeCun-scaled kernels, norm scales near 1, biases near 0
    shapes = jax.eval_shape(j_model.init, jax.random.PRNGKey(0), x, time,
                            cond)

    def leaf(path, shape):
        noise = rng.standard_normal(shape.shape).astype(np.float32)
        if len(shape.shape) >= 2:
            return noise / np.float32(np.sqrt(np.prod(shape.shape[:-1])))
        name = str(getattr(path[-1], "key", path[-1]))
        base = 1.0 if name in ("scale", "gn_scale", "norm_gamma") else 0.0
        return np.float32(base) + np.float32(0.05) * noise

    params = jax.tree_util.tree_map_with_path(leaf, shapes)
    monkeypatch.setenv("VMT_LINEAR_LAYOUT", "head")
    monkeypatch.setenv("VMT_PALLAS_INTERPRET", "1")
    # a function of its own, traced under the switch (no cached trace)
    want = np.asarray(jax.jit(lambda *a: j_model.apply(*a))(
        params, x, time, cond))

    calls = []
    head = t_lin.linear_block_head

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return head(*a, **kw)

    monkeypatch.setattr(t_lin, "linear_block_head", spy)
    model = UNet3D(compute_dtype=torch.float32, num_frames=frames,
                   use_fused_linear_block=True,
                   use_fused_temporal_block=False, **tiny)
    model.load_state_dict(flax_to_torch_state_dict(params), strict=True)
    with torch.no_grad():
        got = model.eval()(torch.tensor(x), torch.tensor(time),
                           torch.tensor(cond)).numpy()
    assert len(calls) == 4                    # 2 down, 2 up
    np.testing.assert_allclose(got, want, **F32_TOL)


def test_recompute_backward_is_the_jax_vjp_where_k_is_clamped():
    """The 'recompute' plan differentiates reference_linear_block, as the
    JAX _core_bwd does (:589-594): at k_scale 300 (|k| on both sides of 60,
    where the clamped forward twin is another function), float32, 2 heads
    of 4, one conditioning token, every cotangent within 5e-2 of the JAX
    one's max."""
    b, n, c, heads, d = 2, 16, 8, 2, 4
    hd = heads * d
    kw = dict(heads=heads, scale=d ** -0.5, spatial_size=n)
    args = _args(1, K_SCALE, b=b, n=n, c=c, hd=hd, d=d)
    k = _keys(args, hd=hd)
    assert (k.abs() > 60).any() and (k.abs() < 60).any()
    g = _rand((b, n, c), 8)
    leaves = [a.requires_grad_(True) for a in _torch(args)]
    t_lin.fused_linear_block(*leaves, **kw, bwd="recompute").backward(
        torch.tensor(g))
    _, vjp = jax.vjp(lambda *a: j_fused_linear(*a, **kw, interpret=True,
                                                bwd_kernel=False),
                     *_jax(args))
    names = ("dx", "dgamma", "dw_qkv", "dw_out", "dout_bias", "dek", "dev")
    for name, leaf, want in zip(names, leaves, vjp(jnp.asarray(g))):
        want = np.asarray(want)
        scale = np.abs(want).max()
        assert scale > 0, name
        np.testing.assert_allclose(leaf.grad.numpy() / scale, want / scale,
                                   rtol=0, atol=5e-2, err_msg=name)
