"""PyTorch port, the sampling kernels (rows 1, 4 and 5) at every shape the
TPU kernels take, on the CPU: the twins that the any-shape CUDA instances
follow against the JAX Pallas kernels in interpret mode at other head
counts and widths and more than 69 conditioning tokens; the UNet3D's eps
of a 4 x 64-head model and of a 96-token model against the JAX model
(VMT_PALLAS_INTERPRET=1) on weights bridged by convert.py; the pure
function that picks each launch's instance; the linear block's fused-plan
gate against the JAX model's; and the training plans above 69 tokens.
The CUDA instances are held against the same twins on the card
(tests/test_torch_port_cuda.py, chip_smoke.py phase 13)."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videometamaterials_tpu.models import UNet3D as JUNet3D
from videometamaterials_tpu.models.unet3d import (
    SpatialLinearAttentionBlock as JLinearBlock,
)
from videometamaterials_tpu.ops.pallas.fused_linear_block import (
    fused_linear_block as j_linear,
)
from videometamaterials_tpu.ops.pallas.fused_temporal_block import (
    fused_temporal_block as j_temporal,
)
from videometamaterials_tpu_torch.convert import flax_to_torch_state_dict
from videometamaterials_tpu_torch.models.unet3d import (
    SpatialLinearAttentionBlock,
    UNet3D,
)
from videometamaterials_tpu_torch.ops.cuda import _build
from videometamaterials_tpu_torch.ops.cuda import fused_linear_block as lin
from videometamaterials_tpu_torch.ops.cuda import fused_temporal_block as tmp

torch.set_num_threads(1)

# the JAX kernel tests' shapes (tests/test_fused_temporal_block.py:17-18,
# tests/test_fused_linear_block.py:15-16)
B, F, S, C = 2, 5, 128, 8
BF, N = 6, 16
# bf16 temporal: 3e-2 (tests/test_fused_temporal_block.py:50); float32
# linear: 2e-4 (tests/test_fused_linear_block.py:48)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)
F32_TOL = dict(rtol=2e-4, atol=2e-4)
# the UNet3D's eps in float32 against the JAX model's, as a share of its
# largest |element|. Against the JAX XLA plans: the plans sum in other
# orders (convolutions, norms, the projections) and nothing rounds to bf16.
# Against the JAX temporal kernel in interpret mode: that kernel rounds its
# softmax weights and value sums to bf16 in a float32 model too
# (fused_temporal_block.py:226, :235) where the port's float32 twin does
# not, a few 2^-8 of the eps
EPS_SHARE = {"xla": 1e-4, "interpret": 2e-2}
TOKENS = (0, 5, 96)
# the JAX kernel unrolls frames x keys, which its interpret mode compiles
# in about a minute at 5 frames and 101 keys: 96 tokens run at 2 frames,
# once (the card holds the CUDA instance at 96 and 150 tokens with 4 x 64
# heads: chip_smoke.py phase 13)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


# ------------------------------------------------------ the kernels' twins


def _temporal_inputs(heads, d, t_tok, f=F):
    hd = heads * d
    return dict(x=_rand((B, f, S, C), 0), gamma=_rand((C,), 1, 0.2) + 1.0,
                w_all=_rand((f, C, 3 * hd), 2, 0.1),
                w_out=_rand((hd, C), 3, 0.1),
                ek=_rand((B, t_tok, hd), 5, 0.5) if t_tok else None,
                ev=_rand((B, t_tok, hd), 6, 0.5) if t_tok else None,
                bias_all=_rand((f, f + t_tok, heads), 7, 0.3))


@pytest.mark.parametrize("heads,d,t_tok", [
    (4, 32, 0), (4, 32, 5), (4, 32, 96), (2, 64, 0), (2, 64, 5)])
def test_temporal_twin_matches_the_jax_kernel(heads, d, t_tok):
    """Row 1 in bf16: the port's forward on a CPU tensor (the twin the
    any-shape instance follows) against the JAX kernel in interpret mode,
    at shapes only the any-shape instance takes on the card."""
    f = 2 if t_tok > 69 else F
    a = _temporal_inputs(heads, d, t_tok, f)
    want = np.asarray(j_temporal(
        *(None if v is None else jnp.asarray(v, jnp.float32 if k in (
            "gamma", "bias_all") else jnp.bfloat16) for k, v in a.items()),
        heads=heads, tile=128, interpret=True), np.float32)
    t = {k: None if v is None else torch.tensor(v).to(
        torch.float32 if k in ("gamma", "bias_all") else torch.bfloat16)
        for k, v in a.items()}
    got = tmp.temporal_block_fwd(**t, heads=heads)
    assert tmp.forward_instance(f, heads, d, C, t_tok) == tmp.ANY_SHAPE
    np.testing.assert_allclose(got.float().numpy(), want, **BF16_TOL)
    assert not np.allclose(want, t["x"].float().numpy(), atol=1e-2)


# (heads, d, Mc, C, N): 4 x 32 at every token count (ids as before), 2 x 64
# and 3 x 40 (d off the k-steps of 16 that the any-shape instances pad to
# 48), and C = 96 at N = 70 (three K-chunks, a ragged last tile)
LINEAR_TWIN_CASES = (
    [pytest.param(4, 32, m_c, C, N, id=str(m_c)) for m_c in TOKENS]
    + [pytest.param(h, d, m_c, C, N, id=f"{h}x{d}-{m_c}")
       for h, d in ((2, 64), (3, 40)) for m_c in (0, 5)]
    + [pytest.param(3, 40, 5, 96, 70, id="3x40-5-C96-N70")])


@pytest.mark.parametrize("heads,d,m_c,c,n", LINEAR_TWIN_CASES)
def test_linear_twins_match_the_jax_merged_kernel(heads, d, m_c, c, n):
    """Rows 4 and 5 in float32: stats then apply on CPU tensors (the twins
    the any-shape instances follow) against the JAX merged kernel in
    interpret mode, at head counts and widths only the any-shape instances
    take on the card."""
    hd = heads * d
    a = dict(x=_rand((BF, n, c), 0), gamma=_rand((c,), 1, 0.2) + 1.0,
             w_qkv=_rand((c, 3 * hd), 2, 0.1), w_out=_rand((hd, c), 3, 0.1),
             out_bias=_rand((c,), 4, 0.1),
             ek=_rand((BF, m_c, hd), 5, 0.5) if m_c else None,
             ev=_rand((BF, m_c, hd), 6, 0.5) if m_c else None)
    kw = dict(heads=heads, scale=d ** -0.5, spatial_size=n)
    want = np.asarray(j_linear(
        *(None if v is None else jnp.asarray(v) for v in a.values()), **kw,
        interpret=True, layout="merged"))
    before = dict(_build.LAUNCH_COUNTS)
    got = lin.linear_block_fwd(
        *(None if v is None else torch.tensor(v) for v in a.values()), **kw)
    assert _build.LAUNCH_COUNTS == before     # CPU tensor: the twins ran
    assert lin.forward_instance(heads, d, c) == lin.ANY_SHAPE
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    assert not np.allclose(want, a["x"], atol=1e-3)


# the any-shape rows 4-5's launch plan (`any_plan`, the mirror of
# csrc/any_shape.cu's lin_plan, which chip_smoke.py holds it to on the
# card) over heads, every d up to 64, C and N
PLAN_HEADS = (1, 2, 3, 4, 8, 12, 16, 32, 64)
PLAN_C = (8, 32, 96, 1024, 4096)
PLAN_N = (1, 144, 9191)


@pytest.mark.parametrize("heads", PLAN_HEADS)
def test_any_plan_fits_and_covers_every_head(heads):
    for d in range(1, lin.ANY_MAX_D + 1):
        for c in PLAN_C:
            for n in PLAN_N:
                plan = lin.any_plan(22, n, c, heads, d)
                assert plan["dp"] % 16 == 0 and d <= plan["dp"] < d + 16
                for stage in ("stats", "apply"):
                    group = plan[f"{stage}_group"]
                    assert 0 < plan[f"{stage}_smem"] <= lin.MAX_SMEM
                    assert 1 <= group <= heads
                    # the groups a block (stats) or a q pass (apply) walks
                    # cover every head once
                    covered = sorted({h for g0 in range(0, heads, group)
                                      for h in range(g0, min(heads,
                                                             g0 + group))})
                    assert covered == list(range(heads))
                    # a column half of the stats, a warp's share of the
                    # apply's q: at most 128 columns
                    parts = (1 if stage == "stats"
                             else 8 // (plan["apply_tile"] // 16))
                    assert -(-group // parts) * plan["dp"] <= 128
                assert plan["stats_tile"] == lin.stats_tile(n)
                assert plan["apply_tile"] in (16, 32, 64)
                # the resident modes fit two blocks an SM; a resident apply
                # block walks whole 64-token tiles, every head in one pass
                for stage in ("stats", "apply"):
                    if plan[f"{stage}_res"]:
                        assert plan[f"{stage}_smem"] <= lin.RES_SMEM
                        assert plan[f"{stage}_stages"] == 0
                    else:
                        assert (lin.ANY_MIN_STAGES <= plan[f"{stage}_stages"]
                                <= lin.ANY_MAX_STAGES)
                # a stats group is one head or an even number (each column
                # half of a block holds the k and v of half of them)
                assert plan["stats_group"] == 1 or plan["stats_group"] % 2 == 0
                if plan["stats_res"] or plan["apply_res"]:
                    assert c <= 128     # the resident LN's four chunks
                if plan["apply_res"]:
                    assert plan["apply_group"] == heads
                    assert plan["apply_span"] in (64, 128, 256)
                else:
                    assert plan["apply_span"] == plan["apply_tile"]
    for d in (65, 80, 128):
        with pytest.raises(ValueError):
            lin.any_plan(22, 144, 64, heads, d)


def test_any_plan_shrinks_tiles_and_groups():
    """The oh tile (tokens x heads dp) bounds the apply's shared memory:
    at 9191 tokens its token tile goes from 64 to 32 and 16 as heads x d
    grows. A small grid shrinks the apply's tile and the stats' head group
    until the blocks fill (most of) the SMs."""
    tiles = [lin.any_plan(22, 9191, 64, h, 64)["apply_tile"]
             for h in (4, 16, 32, 40, 64)]
    assert tiles == sorted(tiles, reverse=True) and tiles[0] == 64
    assert tiles[-1] == 16 and 32 in tiles
    big, small = lin.any_plan(22, 9216, 64, 4, 32), lin.any_plan(
        22, 144, 512, 4, 32)
    assert (big["apply_tile"], big["stats_group"]) == (64, 4)
    assert (small["apply_tile"], small["stats_group"]) == (32, 2)
    for plan, n in ((big, 9216), (small, 144)):
        assert -(-n // plan["stats_tile"]) * 22 * -(
            -4 // plan["stats_group"]) >= lin.ANY_GRID_BLOCKS or \
            plan["stats_group"] == 1


# ------------------------------------------------------ the model


FRAMES, IMG, CURVE = 5, 16, 50
TINY = dict(dim=8, dim_mults=(1, 2), channels=3, init_kernel_size=3,
            use_temporal_attention_cond=True)
# (frames, the JAX model's temporal plan, UNet3D keywords)
MODELS = {
    # 4 heads of 64 in the temporal blocks, 4 x 32 = 128 in the linear ones
    "heads4x64": (3, "interpret", dict(attn_heads=4, attn_dim_head=64,
                                       per_frame_cond=True)),
    # the CNN hidden broadcast to 96 tokens; the JAX model on its XLA plan
    # (its kernel's interpret mode would compile for minutes at 96 tokens;
    # test_temporal_twin_matches_the_jax_kernel holds the kernel there)
    "tokens96": (5, "xla", dict(attn_heads=2, attn_dim_head=4,
                                per_frame_cond=False,
                                cond_attention="self-stacked",
                                cond_attention_tokens=96)),
}


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


@pytest.fixture(scope="module", params=sorted(MODELS))
def jax_eps(request):
    """(name, frames, JAX plan, kwargs, flax params, inputs, the JAX
    model's eps)."""
    frames, plan, kw = MODELS[request.param]
    j_model = JUNet3D(compute_dtype="float32",
                      use_fused_temporal_block=plan == "interpret",
                      use_fused_linear_block=True, **TINY, **kw)
    x = np.random.default_rng(0).uniform(
        -1, 1, (2, frames, IMG, IMG, 3)).astype(np.float32)
    time = np.array([3, 250], np.int32)
    width = frames if kw["per_frame_cond"] else CURVE
    cond = np.random.default_rng(1).uniform(
        -1, 1, (2, width)).astype(np.float32)
    mask = np.array([False, True])
    params = _random_params(j_model, (x, time, cond), 2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VMT_PALLAS_INTERPRET", "1")
        want = np.asarray(jax.jit(lambda p, *a: j_model.apply(
            p, *a[:3], null_cond_mask=a[3]))(params, x, time, cond, mask))
    return (request.param, frames, plan, kw, params, (x, time, cond, mask),
            want)


def test_unet_eps_at_other_widths_matches_jax(jax_eps):
    """The port's fused plans (the twins) against the JAX model (its
    temporal kernel in interpret mode, or its XLA plans; its linear blocks
    off the TPU take the XLA plan), on weights convert.py bridges from the
    same flax tree."""
    name, frames, plan, kw, params, (x, time, cond, mask), want = jax_eps
    model = UNet3D(compute_dtype=torch.float32, num_frames=frames,
                   cond_length=CURVE, use_fused_linear_block="all",
                   use_fused_temporal_block="all", **TINY, **kw)
    model.load_state_dict(flax_to_torch_state_dict(params), strict=True)
    temporal = [m for m in model.modules()
                if type(m).__name__ == "TemporalAttentionBlock"]
    assert temporal and all(m.use_fused_block for m in temporal)
    with torch.no_grad():
        got = model.eval()(torch.tensor(x), torch.tensor(time),
                           torch.tensor(cond),
                           null_cond_mask=torch.tensor(mask)).numpy()
    assert got.shape == want.shape
    share = np.abs(got - want).max() / np.abs(want).max()
    assert share <= EPS_SHARE[plan], (name, share)


# ------------------------------------------------------ the route


FLAGSHIP_TEMPORAL = [(11, 8, 32, c, t) for c in (64, 128, 256, 512)
                     for t in (0, 11, 69)]
OTHER_TEMPORAL = [(5, 4, 32, 8, 0), (5, 2, 64, 8, 96), (11, 4, 64, 64, 11),
                  (11, 16, 32, 64, 11), (11, 8, 32, 1024, 11),
                  (11, 8, 32, 96, 0), (16, 8, 32, 64, 11),
                  (11, 8, 32, 64, 70), (11, 8, 32, 64, 96),
                  (5, 8, 32, 32, 150)]


@pytest.mark.parametrize("shape", FLAGSHIP_TEMPORAL + OTHER_TEMPORAL)
def test_temporal_route_is_a_function_of_the_shape(shape):
    want = (tmp.SPECIALISED if shape in FLAGSHIP_TEMPORAL
            else tmp.ANY_SHAPE)
    assert tmp.forward_instance(*shape) == want


@pytest.mark.parametrize("heads,d,c", [
    (8, 32, 64), (8, 32, 128), (8, 32, 256), (8, 32, 512), (8, 32, 1024),
    (4, 32, 64), (16, 32, 512), (12, 32, 96), (4, 64, 64), (8, 32, 40)])
def test_linear_route_is_a_function_of_the_shape(heads, d, c):
    flagship = (heads, d) == (8, 32) and c in (64, 128, 256, 512)
    assert lin.forward_instance(heads, d, c) == (
        lin.SPECIALISED if flagship else lin.ANY_SHAPE)


# ------------------------------------------------------ the linear gate


@pytest.mark.parametrize("heads", [2, 4, 6, 8])
def test_linear_fused_gate_follows_the_jax_block(heads, monkeypatch):
    """The linear block takes its fused plan where the JAX block does: on
    its platform (here pretended) and where heads * 32 is a multiple of
    128, else the unfused plan."""
    monkeypatch.setattr(jax, "devices",
                        lambda *a: [types.SimpleNamespace(platform="tpu")])
    j_block = JLinearBlock(dim=64, heads=heads, dim_head=32,
                           cond_attention="self-stacked",
                           use_fused_block=True)
    block = SpatialLinearAttentionBlock(64, heads, 32, 32, torch.float32,
                                        use_fused_block=True)
    assert block.use_fused_block == j_block._fused_ok()
    assert block.use_fused_block == (heads in (4, 8))
    model = UNet3D(compute_dtype=torch.float32, num_frames=FRAMES,
                   attn_heads=heads, attn_dim_head=32, **TINY)
    linear = [m for m in model.modules()
              if isinstance(m, SpatialLinearAttentionBlock)]
    assert linear and all(m.use_fused_block == (heads in (4, 8))
                          for m in linear)


# ------------------------------------------------------ training plans
# float32: the plans differentiate the same function (the saved plan's
# backward takes the one-pass LN where the twin's forward is two-pass), so
# each gradient within 1e-4 of its largest |element|
PLAN_SHARE = 1e-4


@pytest.mark.parametrize("plan", ["kernel", "saved", "env"])
def test_training_plans_refuse_more_than_69_tokens(plan, monkeypatch):
    """The plans that launch the temporal training kernels (rows 2-3) take
    more than MAX_COND_TOKENS tokens since their any-shape instances exist:
    at 70 tokens each trains (here through the twins) and gives the
    recompute plan's gradients in every operand."""
    a = {k: None if v is None else torch.tensor(v)
         for k, v in _temporal_inputs(4, 32, 70).items()}
    g = torch.tensor(_rand(a["x"].shape, 8))

    def grads(bwd):
        leaves = {k: None if v is None else v.clone().requires_grad_(True)
                  for k, v in a.items()}
        tmp.fused_temporal_block(**leaves, heads=4, bwd=bwd).backward(g)
        return {k: v.grad for k, v in leaves.items() if v is not None}

    want = grads("recompute")
    if plan == "env":
        monkeypatch.setenv("VMT_TEMPORAL_BWD_KERNEL", "1")
    before = dict(_build.LAUNCH_COUNTS)
    got = grads("recompute" if plan == "env" else plan)
    assert _build.LAUNCH_COUNTS == before     # CPU tensors: the twins ran
    assert 70 > tmp.MAX_COND_TOKENS
    for k, w in want.items():
        scale = w.abs().max().item()
        assert scale > 0, k
        assert (got[k] - w).abs().max().item() <= PLAN_SHARE * scale, k
