"""PyTorch port, the training-side variants on the CPU: the focus-present
mask (the UNet3D of three conditioning arms against the JAX UNet3D, the
unfused route under the fused flag, the attention core, what raises), the
s-tiled temporal plan against the JAX model's, remat_blocks (bit-equal
gradients in float32 and bf16, and the reentrant form shown to differ),
MultiSteps against optax.MultiSteps, its checkpoint tree against flax's
state dict both ways and a resume in the middle of an accumulation, and
each VMT_* switch resolving the plan the JAX package resolves."""

import importlib
import os
import subprocess
import sys
from pathlib import Path

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from videometamaterials_tpu.models import UNet3D as JUNet3D
from videometamaterials_tpu.ops.attention import (
    stacked_softmax_attention as j_attention,
)
from videometamaterials_tpu_torch import config as t_config
from videometamaterials_tpu_torch.convert import (
    flax_to_torch_state_dict,
    torch_to_flax_tree,
)
from videometamaterials_tpu_torch.diffusion.gaussian import GaussianDiffusion
from videometamaterials_tpu_torch.models import unet3d as t_unet
from videometamaterials_tpu_torch.models.unet3d import UNet3D
from videometamaterials_tpu_torch.ops.attention import (
    stacked_softmax_attention,
)
from videometamaterials_tpu_torch.ops.cuda import fused_linear_block as t_lin
from videometamaterials_tpu_torch.ops.cuda import fused_temporal_block as t_tmp
from videometamaterials_tpu_torch.training import checkpoint as ckpt
from videometamaterials_tpu_torch.training.msgpack_io import (
    read_msgpack,
    write_msgpack,
)
from videometamaterials_tpu_torch.training.trainer import (
    TrainState,
    apply_gradients,
)

# the modules (the package exports functions of the same names)
j_lin = importlib.import_module(
    "videometamaterials_tpu.ops.pallas.fused_linear_block")
j_tmp = importlib.import_module(
    "videometamaterials_tpu.ops.pallas.fused_temporal_block")

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FRAMES, IMG, CURVE = 11, 16, 50
TINY = dict(dim=8, dim_mults=(1, 2), channels=3, attn_heads=2,
            attn_dim_head=4, init_kernel_size=3,
            use_temporal_attention_cond=True)
ARMS = {"per-frame": dict(per_frame_cond=True),
        "none": dict(per_frame_cond=False, cond_attention="none"),
        "cross": dict(per_frame_cond=False, cond_attention="cross-attention",
                      cond_attention_tokens=4)}
FOCUS = np.array([True, False])
# float32 on both sides: summation order only
F32_SHARE = 1e-4


def _max_share(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _random_params(model, args, seed):
    """A random tree of the JAX model's structure: LeCun-scaled kernels,
    scales near 1 and biases near 0 but not equal."""
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


def _inputs(kw, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (2, FRAMES, IMG, IMG, 3)).astype(np.float32)
    time = np.array([3, 250], np.int32)
    width = FRAMES if kw.get("per_frame_cond", True) else CURVE
    cond = rng.uniform(-1, 1, (2, width)).astype(np.float32)
    return x, time, cond, np.array([False, True])


def _port(kw, params, fused, **extra):
    model = UNet3D(compute_dtype=torch.float32, num_frames=FRAMES,
                   use_fused_linear_block=fused,
                   use_fused_temporal_block=fused, cond_length=CURVE,
                   **TINY, **kw, **extra)
    model.load_state_dict(flax_to_torch_state_dict(params), strict=True)
    return model.eval()


class _Count:
    """Counts the calls of a module attribute, calling it through."""

    def __init__(self, monkeypatch, module, name):
        self.n, inner = 0, getattr(module, name)

        def wrapped(*a, **kw):
            self.n += 1
            return inner(*a, **kw)

        monkeypatch.setattr(module, name, wrapped)


# ------------------------------------------------------------ focus mask


@pytest.fixture(scope="module", params=sorted(ARMS))
def focus_arm(request):
    kw = ARMS[request.param]
    j_model = JUNet3D(compute_dtype="float32", **TINY, **kw)
    x, time, cond, null = _inputs(kw)
    params = _random_params(j_model, (x, time, cond), 2)
    apply = jax.jit(lambda p, *a: j_model.apply(
        p, *a[:3], null_cond_mask=a[3], focus_present_mask=a[4]))
    want = np.asarray(apply(params, x, time, cond, null, FOCUS))
    return request.param, kw, params, (x, time, cond, null), want


@pytest.mark.parametrize("fused", [False, "all"])
def test_focus_mask_matches_jax(focus_arm, fused, monkeypatch):
    """The UNet3D under the mask [True, False] against the JAX UNet3D; with
    the fused flag on, no temporal block takes the fused kernel (the JAX
    unet3d.py:705) while the linear blocks keep theirs."""
    name, kw, params, (x, time, cond, null), want = focus_arm
    model = _port(kw, params, fused)
    temporal = _Count(monkeypatch, t_unet, "fused_temporal_block")
    linear = _Count(monkeypatch, t_unet, "fused_linear_block")
    args = [torch.tensor(a) for a in (x, time, cond)]
    with torch.no_grad():
        got = model(*args, null_cond_mask=torch.tensor(null),
                    focus_present_mask=torch.tensor(FOCUS)).numpy()
        assert temporal.n == 0
        free = model(*args, null_cond_mask=torch.tensor(null)).numpy()
    assert _max_share(got, want) <= F32_SHARE, name
    # the mask changes the output (the init block is masked in every arm)
    assert _max_share(got, free) > 1e-3, name
    if fused and name != "cross":
        # the unmasked forward's 6 temporal blocks; the linear blocks of
        # both forwards
        assert temporal.n == 6 and linear.n == 8
    elif fused:
        assert temporal.n == 0 and linear.n == 0


def test_focus_mask_attention_core_matches_jax():
    rng = np.random.default_rng(3)
    b, s, h, n, d = 2, 3, 2, 5, 4
    q, k, v = (rng.normal(size=(b, s, h, n, d)).astype(np.float32)
               for _ in range(3))
    bias = rng.normal(size=(h, n, n)).astype(np.float32)
    kw = dict(scale=0.5, num_video_tokens=n)
    want = j_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       pos_bias=jnp.asarray(bias),
                       focus_present_mask=jnp.asarray(FOCUS), **kw)
    got = stacked_softmax_attention(
        torch.tensor(q), torch.tensor(k), torch.tensor(v),
        pos_bias=torch.tensor(bias), focus_present_mask=torch.tensor(FOCUS),
        **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    # a focused sample's queries see their own token only: out = v
    np.testing.assert_allclose(got[0].numpy(), v[0], rtol=1e-6, atol=1e-6)


def test_focus_mask_raises_where_jax_refuses_it():
    """Stacked conditioning keys (the JAX assert) and the CFG-tiled pair."""
    q = torch.zeros(2, 1, 1, 3, 4)
    kv = torch.zeros(2, 1, 1, 5, 4)
    with pytest.raises(ValueError, match="unstacked"):
        stacked_softmax_attention(q, kv, kv, scale=1.0, num_video_tokens=3,
                                  focus_present_mask=torch.tensor(FOCUS))
    model = UNet3D(compute_dtype=torch.float32, num_frames=FRAMES, **TINY)
    x = torch.zeros(1, FRAMES, IMG, IMG, 3)
    with pytest.raises(ValueError, match="focus"):
        model(x, torch.zeros(2), torch.zeros(2, FRAMES),
              focus_present_mask=torch.tensor(FOCUS), cfg_tiled_pair=True)


# ---------------------------------------------------------- s-tiled plan


@pytest.mark.parametrize("s_tile", [64, 96])
def test_s_tiled_plan_matches_jax(s_tile, monkeypatch):
    """temporal_s_tile 64 tiles the level-0 blocks (256 positions, 4 tiles)
    and leaves level 1 (64 positions) untiled; 96 does not divide 256, so
    every block falls back to temporal_xla, as in the JAX model."""
    kw = ARMS["per-frame"]
    j_model = JUNet3D(compute_dtype="float32", temporal_s_tile=s_tile,
                      **TINY, **kw)
    x, time, cond, null = _inputs(kw, seed=4)
    params = _random_params(j_model, (x, time, cond), 5)
    want = np.asarray(jax.jit(lambda p: j_model.apply(
        p, x, time, cond, null_cond_mask=null))(params))
    model = _port(kw, params, False, temporal_s_tile=s_tile)
    tiles = _Count(monkeypatch, t_unet, "reference_temporal_block")
    with torch.no_grad():
        got = model(*(torch.tensor(a) for a in (x, time, cond)),
                    null_cond_mask=torch.tensor(null)).numpy()
    assert _max_share(got, want) <= F32_SHARE
    # level 0: the init, down-0 and up-1 blocks, 4 tiles each
    assert tiles.n == (12 if s_tile == 64 else 0)


def test_s_tiled_block_is_the_untiled_block():
    """temporal_stiled over 4 tiles against one call over all 256
    positions (a tile that does not divide them), float32."""
    model = UNet3D(compute_dtype=torch.float32, num_frames=FRAMES, **TINY)
    model.init_weights(torch.Generator().manual_seed(0))
    attn = model.downs[0][3].fn.fn.fn
    gen = torch.Generator().manual_seed(1)
    x4 = torch.randn(2, FRAMES, IMG * IMG, 8, generator=gen)
    gamma = 1 + 0.1 * torch.randn(8, generator=gen)
    bias = model.time_rel_pos_bias(FRAMES)
    tokens = torch.randn(2, FRAMES, 32, generator=gen)
    with torch.no_grad():
        tiled = attn.temporal_stiled(x4, gamma, bias, tokens, s_tile=64)
        whole = attn.temporal_stiled(x4, gamma, bias, tokens, s_tile=96)
        xla = attn.temporal_xla(x4, gamma, bias, tokens)
    torch.testing.assert_close(tiled, whole, rtol=0, atol=1e-6)
    torch.testing.assert_close(whole, xla, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------ remat


def _remat_grads(dtype, remat):
    model = UNet3D(compute_dtype=dtype, num_frames=FRAMES,
                   remat_blocks=remat, **TINY)
    model.init_weights(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():               # biases off zero, off the bf16 grid
        for name, p in model.named_parameters():
            if name.endswith("bias") and p.dim() == 1:
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    diff = GaussianDiffusion(model, image_size=IMG, num_frames=FRAMES,
                             channels=3, timesteps=16)
    videos = torch.rand(2, FRAMES, IMG, IMG, 3, generator=gen)
    labels = torch.randn(2, FRAMES, generator=gen)
    loss = diff.loss(videos, labels, t=torch.tensor([3, 9]),
                     noise=torch.randn(videos.shape, generator=gen),
                     null_cond_mask=torch.tensor([False, True]))
    loss.backward()
    return loss.detach(), {n: p.grad for n, p in model.named_parameters()}


def _bit_equal(a, b):
    loss_a, grads_a = a
    loss_b, grads_b = b
    return torch.equal(loss_a, loss_b) and all(
        (grads_a[n] is None and grads_b[n] is None)
        or torch.equal(grads_a[n], grads_b[n]) for n in grads_a)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_remat_gives_bit_equal_gradients(dtype):
    off = _remat_grads(dtype, False)
    # the init temporal block takes no conditioning tokens
    assert [n for n, g in off[1].items() if g is None] == [
        "init_temporal_attn.fn.fn.fn.to_k.weight",
        "init_temporal_attn.fn.fn.fn.to_v.weight"]
    assert _bit_equal(_remat_grads(dtype, True), off)


def test_reentrant_remat_would_not(monkeypatch):
    """The reentrant checkpoint runs its first pass under no_grad, where
    ops/conv.py rounds a bf16 convolution with its float32 bias once; the
    recompute under grad adds the bias rounded to bf16: the loss and the
    gradients then belong to two different forwards."""
    off = _remat_grads(torch.bfloat16, False)
    real = t_unet.checkpoint

    def reentrant(fn, *args, use_reentrant, **kw):
        return real(fn, *args, use_reentrant=True, **kw)

    monkeypatch.setattr(t_unet, "checkpoint", reentrant)
    assert not _bit_equal(_remat_grads(torch.bfloat16, True), off)


# ------------------------------------------------------------- MultiSteps

K = 3
SHAPES = {"a": (4, 3), "b": (5,)}
TCFG = t_config.TrainerConfig(ema_start_step=2, ema_update_every=2,
                              ema_decay=0.9)


def _micro_grads(n, seed=0):
    rng = np.random.default_rng(seed)
    scales = [4.0, 0.05, 1.0, 3.0, 0.2, 0.5][:n]
    return [{k: (rng.normal(size=s) * sc).astype(np.float32)
             for k, s in SHAPES.items()} for sc in scales]


# the flagship's learning rate (model.yaml). optax's adam computes its bias
# corrections 1 - b^t in float32 (1 - 0.999^2 carries a relative error of
# ~3e-5), torch.optim.Adam in float64, so their updates differ by ~1e-5 of
# an update: ~1e-9 here, far inside 1e-7
LR = 1e-4


@pytest.mark.parametrize("max_norm", [None, 1.0])
def test_multisteps_matches_optax(max_norm):
    """2k micro-steps of k = 3 against optax.MultiSteps((clip +) adam):
    the accumulated mean bit for bit, the parameters and the EMA after
    every micro-step to 1e-7 (unchanged bit for bit on micro-steps 1, 2,
    4, 5), the EMA rule on the micro-step count, and Adam's count."""
    rng = np.random.default_rng(1)
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    grads = _micro_grads(2 * K)
    chain = [optax.adam(LR)]
    if max_norm is not None:
        chain.insert(0, optax.clip_by_global_norm(max_norm))
    tx = optax.MultiSteps(optax.chain(*chain), every_k_schedule=K)
    j_state, j_params, j_ema = tx.init(p0), p0, p0

    module = torch.nn.ParameterDict(
        {k: torch.nn.Parameter(torch.tensor(v)) for k, v in p0.items()})
    state = TrainState.create(module, LR, accumulate_every=K)
    tcfg = TCFG.replace(max_grad_norm=max_norm, gradient_accumulate_every=K)
    for step, g in enumerate(grads):
        updates, j_state = tx.update(g, j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        do, reset = step % 2 == 0, step < 2
        j_ema = jax.tree.map(lambda e, p: jnp.where(
            do, jnp.where(reset, p, e * 0.9 + 0.1 * p), e), j_ema, j_params)
        before = {k: p.detach().clone() for k, p in module.items()}
        for k, p in module.items():
            p.grad = torch.tensor(g[k])
        moved = apply_gradients(state, tcfg)
        assert moved == (step % K == K - 1)
        ema = state.ema_state_dict()
        for k, p in module.items():
            if not moved:
                assert torch.equal(p.detach(), before[k])
            np.testing.assert_allclose(p.detach().numpy(), j_params[k],
                                       rtol=0, atol=1e-7, err_msg=k)
            np.testing.assert_allclose(ema[k].numpy(), j_ema[k], rtol=0,
                                       atol=1e-7, err_msg=k)
            np.testing.assert_array_equal(
                state.accum.acc_grads[list(module).index(k)].numpy(),
                j_state.acc_grads[k])
        assert state.accum.mini_step == int(j_state.mini_step)
        assert state.accum.gradient_step == int(j_state.gradient_step)
    inner = j_state.inner_opt_state[-1][0]
    assert int(inner.count) == 2
    assert int(state.optimizer.state[module["a"]]["step"]) == 2


def _tiny_model():
    """One level: a tree of every kind of leaf, half the leaves of TINY's
    (what optax's jit compiles scales with)."""
    model = UNet3D(compute_dtype=torch.float32, num_frames=FRAMES,
                   **dict(TINY, dim_mults=(1,)))
    model.init_weights(torch.Generator().manual_seed(0))
    return model


def _seeded_grads(model, seed):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(p.shape, generator=gen) * (0.1 + seed)
            for p in model.parameters()]


def _run(state, tcfg, seeds):
    for seed in seeds:
        for p, g in zip(state.model.parameters(),
                        _seeded_grads(state.model, seed)):
            p.grad = g
        apply_gradients(state, tcfg)


def _same_tree(a, b, path=""):
    """Equal structure, dtypes, shapes and bits."""
    if isinstance(a, dict) or isinstance(b, dict):
        assert isinstance(a, dict) and isinstance(b, dict), path
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            _same_tree(a[k], b[k], f"{path}/{k}")
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, path
    assert a.tobytes() == b.tobytes(), path


def _optax_step(tx, g, state, params):
    updates, state = tx.update(g, state, params)
    return state, optax.apply_updates(params, updates)


@pytest.mark.parametrize("clipped", [False, True])
def test_multisteps_checkpoint_is_flax_layout(clipped, tmp_path):
    """The port's tree after 3 micro-steps of k = 2 (mid-accumulation),
    through msgpack, restores into optax.MultiSteps' state with flax and
    comes back bit for bit; flax's state dict of optax's own state after
    the same gradients loads into the port and is written back bit for
    bit."""
    tcfg = TCFG.replace(gradient_accumulate_every=2,
                        max_grad_norm=1.0 if clipped else None)
    model = _tiny_model()
    named = list(model.named_parameters())
    state = TrainState.create(model, 1e-3, accumulate_every=2)
    p0 = torch_to_flax_tree({n: p.detach() for n, p in named})
    _run(state, tcfg, [0, 1, 2])
    path = tmp_path / "opt.msgpack"
    write_msgpack(path, ckpt.optimizer_state_tree(
        state.optimizer, named, clipped, accum=state.accum))
    tree = read_msgpack(path)
    assert int(tree["mini_step"]) == 1 and int(tree["gradient_step"]) == 1

    chain = [optax.adam(1e-3)]
    if clipped:
        chain.insert(0, optax.clip_by_global_norm(1.0))
    tx = optax.MultiSteps(optax.chain(*chain), every_k_schedule=2)
    template = tx.init(p0)
    restored = flax.serialization.from_state_dict(template, tree)
    _same_tree(flax.serialization.to_state_dict(
        jax.tree.map(np.asarray, restored)), tree)

    # the other way: optax's state after the same micro-gradients
    step = jax.jit(lambda g, st, p: _optax_step(tx, g, st, p))
    j_state, j_params = template, p0
    for seed in (0, 1, 2):
        g = torch_to_flax_tree({n: t for (n, _), t in zip(
            named, _seeded_grads(model, seed))})
        j_state, j_params = step(g, j_state, j_params)
    flax_tree = jax.tree.map(np.asarray,
                             flax.serialization.to_state_dict(j_state))
    fresh = TrainState.create(_tiny_model(), 1e-3, accumulate_every=2)
    fresh_named = list(fresh.model.named_parameters())
    count = ckpt.load_optimizer_state(flax_tree, fresh.optimizer,
                                      fresh_named, clipped,
                                      accum=fresh.accum)
    assert count == 1 and fresh.accum.mini_step == 1
    _same_tree(ckpt.optimizer_state_tree(fresh.optimizer, fresh_named,
                                         clipped, accum=fresh.accum),
               flax_tree)
    # a tree of the wrong kind names what was expected
    with pytest.raises(ValueError, match="MultiSteps"):
        ckpt.load_optimizer_state(flax_tree["inner_opt_state"],
                                  fresh.optimizer, fresh_named, clipped,
                                  accum=fresh.accum)
    with pytest.raises(ValueError, match="state of (clip_by_global_norm "
                                         r"\+ )?adam"):
        ckpt.load_optimizer_state(flax_tree, fresh.optimizer, fresh_named,
                                  clipped)


def test_resume_mid_accumulation_is_bit_equal(tmp_path):
    """Micro-steps 1-3 of k = 2, a checkpoint (parameters, EMA, MultiSteps
    state with its accumulated gradients) through msgpack, a fresh state
    resumed from it, micro-step 4: bit-equal to the unbroken run."""
    tcfg = TCFG.replace(gradient_accumulate_every=2)
    unbroken = TrainState.create(_tiny_model(), 1e-3, accumulate_every=2)
    _run(unbroken, tcfg, [0, 1, 2, 3])

    first = TrainState.create(_tiny_model(), 1e-3, accumulate_every=2)
    _run(first, tcfg, [0, 1, 2])
    named = list(first.model.named_parameters())
    path = tmp_path / "ckpt.msgpack"
    write_msgpack(path, {
        "step": np.asarray(first.step, np.int32),
        "params": torch_to_flax_tree({n: p.detach() for n, p in named}),
        "opt_state": ckpt.optimizer_state_tree(first.optimizer, named, False,
                                               accum=first.accum),
        "ema_params": torch_to_flax_tree(first.ema_state_dict())})
    raw = read_msgpack(path)
    resumed = TrainState.create(_tiny_model(), 1e-3, accumulate_every=2)
    resumed.model.load_state_dict(flax_to_torch_state_dict(raw["params"]))
    ema = flax_to_torch_state_dict(raw["ema_params"])
    for (name, _), e in zip(resumed.model.named_parameters(), resumed.ema):
        e.copy_(ema[name])
    ckpt.load_optimizer_state(raw["opt_state"], resumed.optimizer,
                              list(resumed.model.named_parameters()), False,
                              accum=resumed.accum)
    resumed.step = int(raw["step"])
    assert any(a.abs().sum() > 0 for a in resumed.accum.acc_grads)
    _run(resumed, tcfg, [3])

    for a, b in ((unbroken.model.parameters(), resumed.model.parameters()),
                 (unbroken.ema, resumed.ema),
                 (unbroken.accum.acc_grads, resumed.accum.acc_grads)):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    for p, q in zip(unbroken.model.parameters(),
                    resumed.model.parameters()):
        sa, sb = unbroken.optimizer.state[p], resumed.optimizer.state[q]
        assert float(sa["step"]) == float(sb["step"]) == 2
        assert torch.equal(sa["exp_avg"], sb["exp_avg"])
        assert torch.equal(sa["exp_avg_sq"], sb["exp_avg_sq"])


# ------------------------------------------------------------- switches


def _jax_vjp_mode(monkeypatch, temporal_vjp, bwd_kernel):
    """The backward plan the JAX entry point resolves (its dispatch
    captured, nothing run)."""
    seen = []
    monkeypatch.setattr(j_tmp, "fused_temporal_block_savedp",
                        lambda *a: seen.append("saved"))
    monkeypatch.setattr(
        j_tmp, "fused_temporal_block_core",
        lambda *a: seen.append("kernel" if a[10] else "recompute"))
    j_tmp.fused_temporal_block(*[None] * 7, heads=2, bwd_kernel=bwd_kernel,
                               vjp_mode=temporal_vjp, interpret=True)
    return seen[0]


@pytest.mark.parametrize("env", [None, "recompute", "kernel", "saved"])
def test_temporal_vjp_switch_resolves_as_jax(env, monkeypatch):
    if env is None:
        monkeypatch.delenv("VMT_TEMPORAL_VJP", raising=False)
    else:
        monkeypatch.setenv("VMT_TEMPORAL_VJP", env)
    for explicit in (None, "recompute", "kernel", "saved"):
        for bwd_kernels in (False, True):
            assert t_config.temporal_bwd_mode(explicit, bwd_kernels) == \
                _jax_vjp_mode(monkeypatch, explicit, bwd_kernels), \
                (env, explicit, bwd_kernels)
    model = UNet3D(compute_dtype=torch.float32, num_frames=FRAMES, **TINY)
    assert {m.bwd for m in model.modules()
            if isinstance(m, t_unet.TemporalAttentionBlock)} == \
        {env or "recompute"}


def _fused_step_calls(monkeypatch):
    """Which backward each fused block took in one train step of the
    fused plan with neither fused_bwd_kernels nor temporal_vjp set."""
    spies = {"temporal_bwd": _Count(monkeypatch, t_tmp, "temporal_block_bwd"),
             "from_p": _Count(monkeypatch, t_tmp, "temporal_bwd_from_p"),
             "linear_bwd": _Count(monkeypatch, t_lin, "linear_block_bwd")}
    model = UNet3D(compute_dtype=torch.float32, num_frames=FRAMES, **TINY)
    model.init_weights(torch.Generator().manual_seed(0))
    diff = GaussianDiffusion(model, image_size=8, num_frames=FRAMES,
                             channels=3, timesteps=16)
    gen = torch.Generator().manual_seed(1)
    diff.loss(torch.rand(1, FRAMES, 8, 8, 3, generator=gen),
              torch.randn(1, FRAMES, generator=gen),
              generator=gen).backward()
    return {k: v.n for k, v in spies.items()}


@pytest.mark.parametrize("switch", [None, "VMT_TEMPORAL_BWD_KERNEL",
                                    "VMT_LINEAR_BWD_KERNEL",
                                    "VMT_TEMPORAL_VJP"])
def test_backward_switches_select_the_kernels(switch, monkeypatch):
    """VMT_TEMPORAL_BWD_KERNEL=1 and VMT_LINEAR_BWD_KERNEL=1 send the
    recompute plan's backward to the backward kernels (their twins here),
    as the JAX _bwd_kernel_env does; VMT_TEMPORAL_VJP=saved the temporal
    blocks to the saved plan."""
    for name in ("VMT_TEMPORAL_BWD_KERNEL", "VMT_LINEAR_BWD_KERNEL",
                 "VMT_TEMPORAL_VJP"):
        monkeypatch.delenv(name, raising=False)
    if switch:
        monkeypatch.setenv(switch, "saved" if switch == "VMT_TEMPORAL_VJP"
                           else "1")
    calls = _fused_step_calls(monkeypatch)
    assert calls == {"temporal_bwd": 6 * (switch == "VMT_TEMPORAL_BWD_KERNEL"),
                     "from_p": 6 * (switch == "VMT_TEMPORAL_VJP"),
                     "linear_bwd": 4 * (switch == "VMT_LINEAR_BWD_KERNEL")}
    assert j_tmp._bwd_kernel_env() == t_tmp.bwd_kernel_env() == \
        (switch == "VMT_TEMPORAL_BWD_KERNEL")
    assert j_lin._bwd_kernel_env() == t_lin.bwd_kernel_env() == \
        (switch == "VMT_LINEAR_BWD_KERNEL")


def test_temporal_softmax_switch_is_validated(monkeypatch):
    """'split' and 'merged' run the same forward here (row 1 where nothing
    reads p); anything else raises, as the JAX assert does."""
    model = UNet3D(compute_dtype=torch.float32, num_frames=FRAMES, **TINY)
    model.init_weights(torch.Generator().manual_seed(0))
    args = (torch.rand(1, FRAMES, 8, 8, 3), torch.tensor([3]),
            torch.randn(1, FRAMES))
    outs = {}
    for layout in ("split", "merged"):
        monkeypatch.setenv("VMT_TEMPORAL_SOFTMAX", layout)
        with torch.no_grad():
            outs[layout] = model(*args)
    assert torch.equal(outs["split"], outs["merged"])
    monkeypatch.setenv("VMT_TEMPORAL_SOFTMAX", "rows")
    with pytest.raises(ValueError, match="VMT_TEMPORAL_SOFTMAX"):
        with torch.no_grad():
            model(*args)
    with pytest.raises(AssertionError):
        j_tmp.fused_temporal_block(*[None] * 7, heads=2, interpret=True)


def test_onepass_norms_switch_in_a_subprocess():
    """VMT_ONEPASS_NORMS=0, read at import as in the JAX package: both
    packages' default statistics two-pass (tests/test_torch_port_ops.py
    holds each form against the JAX norms)."""
    code = (
        "import numpy as np, torch\n"
        "from videometamaterials_tpu.ops import norms as j\n"
        "from videometamaterials_tpu_torch.ops import norms as t\n"
        "assert not j.ONE_PASS_STATS and not t.ONE_PASS_STATS\n"
        "x = torch.tensor((np.random.default_rng(0).normal(\n"
        "    size=(2, 3, 4, 4, 16)) * 50 + 300).astype(np.float32))\n"
        "g, b = torch.linspace(0.5, 1.5, 16), torch.linspace(-0.1, 0.1, 16)\n"
        "for fn, args in ((t.channel_layer_norm, (g,)),\n"
        "                 (t.group_norm, (g, b, 4))):\n"
        "    one = fn(x, *args, one_pass=True)\n"
        "    assert torch.equal(fn(x, *args), fn(x, *args, one_pass=False))\n"
        "    assert not torch.equal(fn(x, *args), one)\n"
        "print('two-pass')\n")
    env = dict(os.environ, VMT_ONEPASS_NORMS="0", JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT))
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert run.returncode == 0, run.stderr
    assert run.stdout.strip() == "two-pass"
    from videometamaterials_tpu_torch.ops import norms
    assert norms.ONE_PASS_STATS == (os.environ.get("VMT_ONEPASS_NORMS", "1")
                                    not in ("", "0"))
