"""PyTorch port, whole model on the CPU: the UNet3D forward against the JAX
UNet3D.apply on weights bridged from the same flax tree, the weight bridge
itself (key map, strict load, the committed demo checkpoint at full
width) and the bf16 inference-cast allowlist."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videometamaterials_tpu.models import UNet3D as JUNet3D
from videometamaterials_tpu.training.torch_import import (
    build_key_map,
    import_state_dict,
)
from videometamaterials_tpu.utils import cast_params_for_inference as j_cast
from videometamaterials_tpu_torch.convert import (
    flax_to_torch_state_dict,
    key_map,
)
from videometamaterials_tpu_torch.models.unet3d import UNet3D
from videometamaterials_tpu_torch.utils import cast_params_for_inference

torch.set_num_threads(1)

TINY = dict(dim=16, dim_mults=(1, 2), channels=3, attn_heads=2,
            attn_dim_head=8, init_kernel_size=3, resnet_groups=8,
            use_sparse_linear_attn=True, use_temporal_attention_cond=True,
            cond_to_time="add", per_frame_cond=True)
FRAMES, IMG = 11, 8
# float32 on both sides: convolutions, GroupNorm and attention agree to
# summation order; the fused plan's twins use two-pass LN and the +-60 k
# clamp (exact here), so they meet the same bound
MODEL_TOL = dict(rtol=2e-4, atol=2e-4)


def _random_params(model, args, seed):
    """A random parameter tree of the JAX model's structure (eval_shape:
    no init run). LeCun-scaled kernels; norm scales near 1 and biases near
    0 but not equal, so the comparison sees every parameter."""
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


@pytest.fixture(scope="module")
def tiny():
    j_model = JUNet3D(compute_dtype="float32", **TINY)
    x = np.random.default_rng(0).uniform(
        -1, 1, (2, FRAMES, IMG, IMG, 3)).astype(np.float32)
    time = np.array([3, 250], np.int32)
    cond = np.random.default_rng(1).uniform(-1, 1, (2, FRAMES)).astype(
        np.float32)
    params = _random_params(j_model, (x, time, cond), 2)
    return j_model, params, x, time, cond


def _port(params, fused):
    model = UNet3D(compute_dtype=torch.float32, num_frames=FRAMES,
                   use_fused_linear_block=fused,
                   use_fused_temporal_block=fused, **TINY)
    model.load_state_dict(flax_to_torch_state_dict(params), strict=True)
    return model.eval()


@pytest.mark.parametrize("fused", [False, "all"])
@pytest.mark.parametrize("cfg_tiled_pair", [False, True])
def test_forward_matches_jax(tiny, fused, cfg_tiled_pair):
    j_model, params, x, time, cond = tiny
    mask = np.array([False, True])
    if cfg_tiled_pair:
        # one latent, CFG-folded time/cond/mask: [cond-half; null-half]
        x_in, time, cond = x[:1], np.array([7, 7], np.int32), \
            np.concatenate([cond[:1], cond[:1]])
    else:
        x_in = x
    want = jax.jit(j_model.apply, static_argnames="cfg_tiled_pair")(
        params, x_in, time, cond, null_cond_mask=mask,
        cfg_tiled_pair=cfg_tiled_pair)
    with torch.no_grad():
        got = _port(params, fused)(
            torch.tensor(x_in), torch.tensor(time), torch.tensor(cond),
            null_cond_mask=torch.tensor(mask), cfg_tiled_pair=cfg_tiled_pair)
    assert got.dtype == torch.float32 and got.shape == (2, FRAMES, IMG, IMG, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)


def test_fused_plan_weights_follow_a_reload(tiny):
    """The fused plans fold and cast their weights once per parameter
    state: a second forward reuses them, a load_state_dict rebuilds them."""
    j_model, params, x, time, cond = tiny
    other = _random_params(j_model, (x, time, cond), 3)
    args = (torch.tensor(x), torch.tensor(time), torch.tensor(cond))
    model = _port(params, "all")
    with torch.no_grad():
        first = model(*args)
        torch.testing.assert_close(model(*args), first, rtol=0, atol=0)
        model.load_state_dict(flax_to_torch_state_dict(other), strict=True)
        torch.testing.assert_close(model(*args), _port(other, "all")(*args),
                                   rtol=0, atol=0)


def test_state_dict_names_are_the_reference_keys(tiny):
    """Every port key is a key of the JAX importer's map onto the same flax
    leaf, and the JAX importer takes the port's state dict back to the
    original tree."""
    _, params, *_ = tiny
    state = flax_to_torch_state_dict(params)
    ref_map = build_key_map(2)
    ours = key_map(2)
    for key in state:
        assert key in ref_map, key
        assert ref_map[key][0] == ours[key][0], key
    back = import_state_dict({k: v.numpy() for k, v in state.items()},
                             params, num_resolutions=2)
    jax.tree.map(np.testing.assert_array_equal, back, params)


def test_inference_cast_allowlist_matches_jax(tiny):
    _, params, *_ = tiny
    cast_tree = j_cast(params)
    ours = key_map(2)
    model = cast_params_for_inference(_port(params, False))
    for key, p in model.state_dict().items():
        path = ours[key][0]
        leaf = cast_tree["params"]
        for name in path:
            leaf = leaf[name]
        assert (p.dtype == torch.bfloat16) == (leaf.dtype == jnp.bfloat16), key


def test_bridge_loads_demo_checkpoint_strictly_at_full_width():
    """The committed EMA tree (flagship widths) converts, loads with
    strict=True and gives the JAX forward's output at 16x16x11 in
    float32."""
    from flax import serialization

    with open("ckpt_cache/demo4x_step_8000.msgpack", "rb") as fh:
        tree = serialization.msgpack_restore(fh.read())["ema_params"]
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), tree)
    state = flax_to_torch_state_dict(tree)
    model = UNet3D(compute_dtype=torch.float32, use_fused_linear_block=False,
                   use_fused_temporal_block=False)
    assert set(state) == set(model.state_dict())
    model.load_state_dict(state, strict=True)

    j_model = JUNet3D(dim=64, dim_mults=(1, 2, 4, 8), channels=3,
                      attn_heads=8, attn_dim_head=32,
                      use_temporal_attention_cond=True, per_frame_cond=True,
                      compute_dtype="float32")
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (1, 11, 16, 16, 3)).astype(np.float32)
    time = np.array([100], np.int32)
    cond = rng.uniform(-1, 1, (1, 11)).astype(np.float32)
    want = jax.jit(j_model.apply)(tree, x, time, cond)
    with torch.no_grad():
        got = model.eval()(torch.tensor(x), torch.tensor(time),
                           torch.tensor(cond))
    # full width: more and longer sums than the tiny model
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3,
                               atol=1e-3)
