"""PyTorch port, the reference checkpoint.pt import on the CPU: a synthetic
reference-layout checkpoint (the shapes the JAX importer inverts, the
`module.` and `denoise_fn.` prefixes, the schedule buffers, the rotary
tables, the reference's unused to_q and CNN tensors, a Conv2d 1x1 in its
4-d layout) goes through the JAX importer into the JAX UNet and through
the port's into the port's UNet: the same eps, and the port's state dict
equal to the JAX tree's converted. The port's key map is the composition
of the JAX build_key_map with convert.key_map. Unknown, missing, GRU and
misshapen keys raise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videometamaterials_tpu.models import UNet3D as JUNet3D
from videometamaterials_tpu.training.torch_import import (
    _t_conv1d,
    _t_conv1x1,
    _t_conv_spatial,
    _t_conv_transpose,
    _t_gamma,
    _t_linear,
    build_key_map,
    import_state_dict as j_import,
    state_dict_to_numpy,
)
from videometamaterials_tpu_torch import convert
from videometamaterials_tpu_torch.models.unet3d import UNet3D
from videometamaterials_tpu_torch.training import torch_import

torch.set_num_threads(1)

TINY = dict(dim=8, dim_mults=(1, 2), channels=3, attn_heads=2,
            attn_dim_head=4, use_sparse_linear_attn=True,
            use_temporal_attention_cond=True, per_frame_cond=True)
FRAMES, IMG = 3, 8
# float32 both sides, the same weights: tests/test_torch_port_model.py's
# 2e-4 is the two packages' float32 difference on bounded inputs
EPS_TOL = dict(rtol=1e-4, atol=1e-4)

# reference (torch) shape of a flax leaf, the inverse of each transform
_INVERSE_SHAPES = {
    _t_linear: lambda s: (s[1], s[0]),
    _t_conv_spatial: lambda s: (s[3], s[2], 1, s[0], s[1]),
    _t_conv1x1: lambda s: (s[1], s[0], 1, 1, 1),
    _t_conv_transpose: lambda s: (s[2], s[3], 1, s[0], s[1]),
    _t_conv1d: lambda s: (s[2], s[1], s[0]),
    _t_gamma: lambda s: (1, s[0], 1, 1, 1),
}
_ALIASED = (".proj.conv.", ".4.conv.", ".conv_transpose.", "init_conv.conv.")


def _leaf(params, path):
    node = params["params"]
    for p in path:
        if p not in node:
            return None
        node = node[p]
    return node


def _reference_state(params, seed):
    """A reference-layout state dict of the JAX model's leaves, prefixed
    as a DDP-wrapped GaussianDiffusion writes it, with the buffers and
    the tensors the reference builds but does not use."""
    rng = np.random.default_rng(seed)
    state = {}
    for key, (path, transform) in build_key_map(2).items():
        leaf = _leaf(params, path)
        if leaf is None or any(a in key for a in _ALIASED):
            continue
        shape = _INVERSE_SHAPES.get(transform, lambda s: s)(leaf.shape)
        if key == "downs.0.2.fn.fn.to_qkv.weight":
            shape = shape[:4]                     # a Conv2d 1x1: (O, I, 1, 1)
        scale = 1.0 if key.endswith(("gamma", "norm.weight")) else 0.2
        state[key] = (rng.standard_normal(shape) * scale).astype(np.float32)
    state["init_temporal_attn.fn.fn.fn.to_q.weight"] = \
        rng.standard_normal((8, 8)).astype(np.float32)
    state["downs.1.2.fn.fn.to_q.weight"] = \
        rng.standard_normal((64, 16, 1, 1)).astype(np.float32)
    state["sign_emb_CNN.emb_model.0.weight"] = \
        rng.standard_normal((4, 1, 3)).astype(np.float32)
    state["betas"] = np.linspace(1e-4, 0.02, 8).astype(np.float32)
    state["alphas_cumprod"] = np.cumprod(1 - state["betas"])
    state["init_temporal_attn.fn.fn.fn.rotary_emb.freqs"] = \
        np.ones(2, np.float32)
    return {"module.denoise_fn." + k: torch.from_numpy(v)
            for k, v in state.items()}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    j_model = JUNet3D(compute_dtype="float32", **TINY)
    params = jax.jit(j_model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, FRAMES, IMG, IMG, 3)),
        jnp.zeros((1,), jnp.int32), jnp.zeros((1, FRAMES)))
    path = tmp_path_factory.mktemp("torch_import") / "checkpoint.pt"
    ckpt = {"model": _reference_state(params, 1),
            "ema": _reference_state(params, 2),
            "optimizer": {"state": {}, "param_groups": []}, "steps": 7}
    torch.save(ckpt, path)
    t_model = UNet3D(compute_dtype=torch.float32, num_frames=FRAMES, **TINY)
    return j_model, params, t_model, path, ckpt


@pytest.mark.parametrize("which", ["ema", "model"])
def test_same_eps_through_both_importers(setup, which):
    j_model, params, t_model, path, _ = setup
    j_params = j_import(state_dict_to_numpy(str(path), which), params, 2)
    weights = torch_import.load_reference_weights(
        path, t_model.state_dict(), which)
    # the port's import is the JAX import converted, bit for bit
    want = convert.flax_to_torch_state_dict(jax.device_get(j_params))
    assert set(weights) == set(want) == set(t_model.state_dict())
    for k in want:
        assert torch.equal(weights[k], want[k]), k
    t_model.load_state_dict(weights, strict=True)
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (2, FRAMES, IMG, IMG, 3)).astype(np.float32)
    t = np.array([3, 200], np.int32)
    cond = rng.uniform(-1, 1, (2, FRAMES)).astype(np.float32)
    j_eps = jax.jit(j_model.apply)(j_params, x, t, cond)
    with torch.no_grad():
        eps = t_model.eval()(torch.tensor(x), torch.tensor(t),
                             torch.tensor(cond))
    np.testing.assert_allclose(eps.numpy(), np.asarray(j_eps), **EPS_TOL)


def test_key_map_is_the_composition_of_the_two_maps(setup):
    """Every reference key the JAX importer places on a leaf of this model
    (aliases included) lands on the port key that convert.key_map gives
    that leaf."""
    _, params, t_model, *_ = setup
    by_path = {path: key for key, (path, _) in convert.key_map(2).items()}
    placed = 0
    for ref_key, (path, _) in build_key_map(2).items():
        if _leaf(params, path) is None:
            continue
        assert torch_import.port_key("module.denoise_fn." + ref_key) == \
            by_path[path], ref_key
        placed += 1
    assert placed > 100
    assert set(by_path.values()) >= set(t_model.state_dict())


def test_bad_checkpoints_raise(setup):
    *_, t_model, path, ckpt = setup
    template = t_model.state_dict()
    ema = dict(ckpt["ema"])
    with pytest.raises(KeyError, match="does not have"):
        torch_import.import_state_dict(
            {**ema, "denoise_fn.not.a.real.key": torch.zeros(1)}, template)
    with pytest.raises(KeyError, match="does not have"):
        # to_q of an attention the model does not have
        torch_import.import_state_dict(
            {**ema, "nowhere.fn.fn.to_q.weight": torch.zeros(1)}, template)
    with pytest.raises(NotImplementedError, match="item 8"):
        torch_import.import_state_dict(
            {**ema, "denoise_fn.sign_emb_GRU.emb_model.weight_ih_l0":
             torch.zeros(3, 2)}, template)
    missing = {k: v for k, v in ema.items()
               if not k.endswith("final_conv.1.bias")}
    with pytest.raises(KeyError, match="lacks"):
        torch_import.import_state_dict(missing, template)
    key = "module.denoise_fn.init_conv.weight"
    with pytest.raises(ValueError, match="shape"):
        torch_import.import_state_dict({**ema, key: ema[key][:, :2]},
                                       template)
    with pytest.raises(KeyError, match="twice"):
        torch_import.import_state_dict(
            {**ema, "init_conv.conv.weight": ema[key]}, template)
    with pytest.raises(ValueError, match="which"):
        torch_import.read_reference_checkpoint(path, "optimizer")
    # a bare state dict is taken whole; torch.load runs weights_only
    bare = path.parent / "bare.pt"
    torch.save(ema, bare)
    got = torch_import.load_reference_weights(bare, template)
    assert all(torch.equal(got[k], v) for k, v in
               torch_import.load_reference_weights(path, template).items())
