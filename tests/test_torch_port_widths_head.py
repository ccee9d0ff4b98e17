"""PyTorch port, the head-layout linear block (row 8) at every shape the
TPU kernel takes, on the CPU: the twin that the any-shape CUDA instance
follows (linear_block_head_plain) against the JAX fused_linear_block
(layout="head") in interpret mode at other head counts, widths off the
specialised channels and 96 conditioning tokens, with |k| on both sides of
60; the instance each shape takes; and UNet3D under VMT_LINEAR_LAYOUT=head
at a 4 x 32 linear width and at channels off the specialised set, against
the JAX model under the same switch on weights bridged by convert.py. The
CUDA instance is held against the same twin on the card
(tests/test_torch_port_cuda.py, chip_smoke.py phase 15)."""

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
from videometamaterials_tpu_torch.ops.cuda import fused_linear_block as lin
from videometamaterials_tpu_torch.ops.norms import channel_layer_norm

torch.set_num_threads(1)

# the shapes of tests/test_fused_linear_block.py, float32
B, N, D = 6, 16, 32
# float32 operands: only the summation order differs
# (tests/test_fused_linear_block.py:48)
F32_TOL = dict(rtol=2e-4, atol=2e-4)
# head 0's key weights times this: its |k| lies on both sides of 60, where
# the merged stats' clamp would change the function
# (tests/test_torch_port_linear_head.py)
K_SCALE = 300.0


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def _args(heads, c, m_c):
    hd = heads * D
    w_qkv = _rand((c, 3 * hd), 2, 0.1)
    w_qkv[:, hd:hd + D] *= K_SCALE
    return (_rand((B, N, c), 0), _rand((c,), 1, 0.2) + 1.0, w_qkv,
            _rand((hd, c), 3, 0.1), _rand((c,), 4, 0.1),
            _rand((B, m_c, hd), 5, 0.5) if m_c else None,
            _rand((B, m_c, hd), 6, 0.5) if m_c else None)


@pytest.mark.parametrize("m_c", [0, 96])
@pytest.mark.parametrize("c", [32, 96])
@pytest.mark.parametrize("heads", [4, 12])
def test_head_twin_matches_the_jax_head_kernel_at_other_widths(heads, c,
                                                               m_c):
    args = _args(heads, c, m_c)
    x, gamma, w_qkv = (torch.tensor(a) for a in args[:3])
    hd = heads * D
    k = channel_layer_norm(x, gamma, one_pass=False) @ w_qkv[:, hd:2 * hd]
    assert (k.abs() > 60).any() and (k.abs() < 60).any()
    assert lin.forward_instance(heads, D, c) == lin.ANY_SHAPE
    kw = dict(heads=heads, scale=D ** -0.5, spatial_size=N)
    t_args = [None if a is None else torch.tensor(a) for a in args]
    before = dict(_build.LAUNCH_COUNTS)
    got = lin.linear_block_head(*t_args, **kw)
    assert _build.LAUNCH_COUNTS == before     # CPU tensor: the twin ran
    torch.testing.assert_close(
        got, lin.fused_linear_block(*t_args, **kw, layout="head"),
        rtol=0, atol=0)
    want = np.asarray(j_fused_linear(
        *[None if a is None else jnp.asarray(a) for a in args], **kw,
        interpret=True, layout="head"))
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


# (heads, d, C): the flagship's shapes take the specialised instance
# (csrc/fused_linear_block.cu, vmt_linear_head), every other the any-shape
# one (csrc/any_shape_bwd.cu, vmt_linear_head_any)
ROUTES = [((8, 32, 64), lin.SPECIALISED), ((8, 32, 512), lin.SPECIALISED),
          ((8, 32, 1024), lin.ANY_SHAPE), ((4, 32, 64), lin.ANY_SHAPE),
          ((12, 32, 96), lin.ANY_SHAPE), ((8, 32, 40), lin.ANY_SHAPE),
          ((4, 64, 64), lin.ANY_SHAPE), ((16, 32, 512), lin.ANY_SHAPE)]


@pytest.mark.parametrize("shape,want", ROUTES)
def test_head_layout_route_is_a_function_of_the_shape(shape, want,
                                                      monkeypatch):
    """The instance is `forward_instance` of the shape: off the CPU (meta
    tensors here) an any-shape shape reaches the any-shape launcher, a
    flagship shape the specialised one (whose checks refuse a tensor that
    is not on the card)."""
    heads, d, c = shape
    assert lin.forward_instance(heads, d, c) == want
    hd = heads * d
    meta = dict(device="meta")
    args = (torch.empty((2, 16, c), dtype=torch.bfloat16, **meta),
            torch.empty((c,), **meta),
            torch.empty((c, 3 * hd), dtype=torch.bfloat16, **meta),
            torch.empty((hd, c), dtype=torch.bfloat16, **meta),
            torch.empty((c,), **meta), None, None)
    calls = []
    monkeypatch.setattr(lin, "_head_any",
                        lambda *a, **kw: calls.append(a[0].shape))
    kw = dict(heads=heads, scale=d ** -0.5, spatial_size=16)
    if want == lin.ANY_SHAPE:
        lin.linear_block_head(*args, **kw)
        assert calls == [(2, 16, c)]
    else:
        with pytest.raises(ValueError, match="CUDA"):
            lin.linear_block_head(*args, **kw)
        assert not calls


def _random_params(model, args, seed):
    """A random parameter tree of the JAX model's structure: LeCun-scaled
    kernels, norm scales near 1 and biases near 0 but not equal."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), *args)
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        noise = rng.standard_normal(s.shape).astype(np.float32)
        if len(s.shape) >= 2:
            return noise / np.float32(np.sqrt(np.prod(s.shape[:-1])))
        base = 1.0 if name in ("scale", "gn_scale", "norm_gamma") else 0.0
        return np.float32(base) + np.float32(0.05) * noise

    return jax.tree_util.tree_map_with_path(leaf, shapes)


# UNet3D keywords: 4 heads (a 4 x 32 = 128 linear width, the JAX gate's
# least) at C = 8 and 16; 8 heads (8 x 32) at C = 40 and 80, widths off
# the specialised channels
MODELS = {
    "heads4": dict(dim=8, attn_heads=4, attn_dim_head=8),
    "c40": dict(dim=40, attn_heads=8, attn_dim_head=4),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_unet_head_layout_at_other_widths_matches_jax(name, monkeypatch):
    """VMT_LINEAR_LAYOUT=head sends every fused linear block of UNet3D to
    the head layout; each block's shape takes the any-shape instance, and
    the model's eps matches the JAX model's under the same switch."""
    tiny = dict(dim_mults=(1, 2), channels=3, init_kernel_size=3,
                use_temporal_attention_cond=True, per_frame_cond=True,
                **MODELS[name])
    frames, img = 5, 8
    j_model = JUNet3D(compute_dtype="float32", use_fused_linear_block=True,
                      **tiny)
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (1, frames, img, img, 3)).astype(np.float32)
    time = np.array([5], np.int32)
    cond = rng.uniform(-1, 1, (1, frames)).astype(np.float32)
    params = _random_params(j_model, (x, time, cond), 1)
    monkeypatch.setenv("VMT_LINEAR_LAYOUT", "head")
    monkeypatch.setenv("VMT_PALLAS_INTERPRET", "1")
    want = np.asarray(jax.jit(lambda *a: j_model.apply(*a))(
        params, x, time, cond))

    calls = []
    head = lin.linear_block_head

    def spy(*a, **kw):
        calls.append((kw["heads"], a[2].shape[1] // (3 * kw["heads"]),
                      a[0].shape[-1]))
        return head(*a, **kw)

    monkeypatch.setattr(lin, "linear_block_head", spy)
    model = UNet3D(compute_dtype=torch.float32, num_frames=frames,
                   use_fused_linear_block=True,
                   use_fused_temporal_block=False, **tiny)
    model.load_state_dict(flax_to_torch_state_dict(params), strict=True)
    with torch.no_grad():
        got = model.eval()(torch.tensor(x), torch.tensor(time),
                           torch.tensor(cond)).numpy()
    assert len(calls) == 4                    # 2 down, 2 up
    assert all(lin.forward_instance(*s) == lin.ANY_SHAPE for s in calls)
    np.testing.assert_allclose(got, want, **F32_TOL)
