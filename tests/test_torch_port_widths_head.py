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
# one (csrc/any_linear_head.cu, vmt_linear_head_any)
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


# ------------------------------------------------------- row 8's plan
# `fused_linear_block.head_any_plan`, the mirror of
# csrc/any_linear_head.cu's head_plan (chip_smoke.py phase 15 (a) holds the
# two equal on the card at every launch)


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_head", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _phase15_head_shapes(cs, tmp_path):
    """(BF, N, C, heads, d) of every row 8 any-shape launch of
    chip_smoke.py phase 15 (a): the wide and heads4x64 paths (a guided
    step and a train step), the grid, the ragged shapes, WHEAD_MODES, the
    |k| case and the flagship's level 0."""
    import itertools

    from videometamaterials_tpu_torch.config import load_model_yaml

    shapes = {(22, cs.WIDTH_S, c, h, d) for (h, d), c in itertools.product(
        cs.WIDTH_HEADS, cs.WIDTH_C)}
    shapes |= {(22, 9191, c, h, d) for (h, d), c, _ in cs.WIDTH_RAGGED_LINEAR}
    shapes |= {(bf, n, c, h, d) for bf, n, c, _, h, d in cs.WHEAD_MODES}
    shapes |= {(22, 9216, 64, 4, 32), (*cs.WHEAD_FLAGSHIP[0], cs.HEADS, 32)}
    paths = set()
    for name in ("wide", "heads4x64"):
        cfg = load_model_yaml(cs.width_yaml(tmp_path, name))
        for batch, train in ((1, False), (cs.WTRAIN_BATCH, True)):
            paths |= {(bf, n, c, h, d) for bf, n, c, _, h, d in
                      cs.head_path(cfg, batch, train)[1]}
    assert paths, "the paths launch row 8 any-shape"
    return sorted(shapes | paths)


def _covers_every_head_once(heads, group):
    got = [h for g0 in range(0, heads, group)
           for h in range(g0, min(heads, g0 + group))]
    return got == list(range(heads))


def test_head_any_plan_fits_every_phase15_shape(tmp_path):
    """Every row 8 launch of phase 15 (a) is planned within 227 KB of
    shared memory a block (kernel by kernel), its stats and apply head
    groups cover every head once (a stats group of one head or an even
    number, a resident apply's group every head), each kernel names its
    mode (resident with no ring stages, or streamed with 3 to 6) and the
    apply whether its oh tiles hold one head group; d pads to
    16 ceil(d / 16); the workspace is the stats' partials and ctxn's hi
    and lo blocks, with no float32 q, k, v, y or oh: at heads4x64's level
    0 about 14 MB."""
    cs = _chip_smoke()
    for bf, n, c, heads, d in _phase15_head_shapes(cs, tmp_path):
        plan = lin.head_any_plan(bf, n, c, heads, d)
        assert plan["dp"] == -(-d // 16) * 16, plan
        for kernel in ("stats", "apply"):
            assert 0 < plan[f"{kernel}_smem"] <= lin.MAX_SMEM, plan
            assert plan[f"{kernel}_res"] in (0, 1), plan
            if plan[f"{kernel}_res"]:
                assert c <= 128 and plan[f"{kernel}_stages"] == 0, plan
            else:
                assert (lin.ANY_MIN_STAGES <= plan[f"{kernel}_stages"]
                        <= lin.ANY_MAX_STAGES), plan
            assert _covers_every_head_once(heads, plan[f"{kernel}_group"])
        group = plan["stats_group"]
        assert group == 1 or group % 2 == 0, plan
        assert group * plan["dp"] <= 128, plan
        assert plan["stats_tile"] == lin.stats_tile(n)
        assert plan["apply_ohg"] in (0, 1), plan
        if plan["apply_res"]:
            assert plan["apply_group"] == heads and not plan["apply_ohg"]
        assert plan["apply_tile"] in (16, 32, 64)
        tiles = -(-n // plan["stats_tile"])
        r = lambda v: -(-v // 256) * 256
        dp = plan["dp"]
        assert plan["workspace"] == (
            2 * r(bf * tiles * heads * d * 4)
            + r(bf * tiles * heads * d * d * 4)
            + r(bf * heads * 2 * dp * (dp + 8) * 2)), plan
    ws = lin.head_any_plan(22, 9216, 64, 4, 32)["workspace"]
    assert 13e6 < ws < 15e6, ws


def test_head_any_plan_reaches_every_mode(tmp_path):
    """Phase 15 (a)'s shapes take every mode of the plan
    (chip_smoke.HEAD_PLAN_MODES, which phase 15 (a) checks on the card):
    resident and streamed stats and apply, stats tiles of 64 and 256
    tokens, stats groups of 1, 2 and 4 heads, apply tiles of 64, 32 and 16
    tokens, oh tiles of every head and of one group, d padded to 16, 32,
    48 and 64."""
    cs = _chip_smoke()
    plans = [lin.head_any_plan(*shape)
             for shape in _phase15_head_shapes(cs, tmp_path)]
    for key, values in cs.HEAD_PLAN_MODES.items():
        assert {p[key] for p in plans} >= set(values), key


@pytest.mark.parametrize("heads", [1, 3, 4, 16, 64])
def test_head_any_plan_refuses_only_d_above_64(heads):
    """Over d up to 70, C from 8 to 4096 and N from 1 to 9216 the plan
    fits 227 KB a block and covers every head once, or refuses with
    ValueError: at d > 64, and at no other shape (the parent instance
    took every d <= 64)."""
    for d in (*range(1, lin.ANY_MAX_D + 1, 7), 64, 65, 70):
        for c in (8, 40, 128, 1024, 4096):
            for n in (1, 144, 9216):
                if d > lin.ANY_MAX_D:
                    with pytest.raises(ValueError):
                        lin.head_any_plan(22, n, c, heads, d)
                    continue
                plan = lin.head_any_plan(22, n, c, heads, d)
                assert max(plan["stats_smem"],
                           plan["apply_smem"]) <= lin.MAX_SMEM
                assert _covers_every_head_once(heads, plan["apply_group"])


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
