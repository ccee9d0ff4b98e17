"""PyTorch port, the train step on the CPU: the diffusion loss and every
parameter's gradient against the JAX package (jax.grad of
GaussianDiffusion.loss) on weights from the JAX init carried over by
convert.py, under the four plans (unfused; fused with the recompute
backward; fused with the backward kernels, whose twins run here; fused
with the backward kernels and `temporal_vjp: saved`); Adam,
the global-norm clip and the EMA rule against optax and the JAX train
step; the batch sampler's index streams; and the wiring (the plan split,
what raises, the training CLI)."""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from videometamaterials_tpu.data.loader import (
    InfiniteBatchSampler as JSampler,
)
from videometamaterials_tpu.diffusion import GaussianDiffusion as JDiffusion
from videometamaterials_tpu.models import UNet3D as JUNet3D
from videometamaterials_tpu_torch import config as t_config
from videometamaterials_tpu_torch import train as t_train
from videometamaterials_tpu_torch.convert import flax_to_torch_state_dict
from videometamaterials_tpu_torch.data.loader import InfiniteBatchSampler
from videometamaterials_tpu_torch.diffusion.gaussian import GaussianDiffusion
from videometamaterials_tpu_torch.models import unet3d as t_unet
from videometamaterials_tpu_torch.models.unet3d import UNet3D
from videometamaterials_tpu_torch.ops.cuda import fused_linear_block as t_lin
from videometamaterials_tpu_torch.ops.cuda import fused_temporal_block as t_tmp
from videometamaterials_tpu_torch.training.optim import clip_by_global_norm_
from videometamaterials_tpu_torch.training.trainer import (
    StepTrainer,
    TrainState,
    apply_gradients,
    array_batches,
    train_step,
)

torch.set_num_threads(1)

# a tiny model of the flagship family; 11 frames (the JAX model's
# per-frame null token has 11)
TINY = dict(dim=8, dim_mults=(1, 2), channels=3, attn_heads=2,
            attn_dim_head=8, use_temporal_attention_cond=True,
            per_frame_cond=True)
FRAMES, IMG, T = 11, 8, 16
BATCH = 2
DIFF = dict(image_size=IMG, num_frames=FRAMES, channels=3, timesteps=T)
NULL_P = 0.5
# float32 on both sides: the sums differ in order only (the fused twins'
# two-pass LN against the unfused one-pass: ~1e-6 relative)
F32_GRAD_TOL = 1e-4
# bf16 activations, one attention block: the JAX rule for its module-level
# fused gradients (tests/test_fused_temporal_block.py:322-358). A whole
# bf16 model is no place for it: its gradients are up to 13% (this port)
# and 84% (the JAX package) of their largest element away from the float32
# ones, in conv and norm parameters that no kernel touches
BF16_GRAD_TOL = 5e-2
PLANS = {"unfused": dict(use_fused_linear_block=False,
                         use_fused_temporal_block=False),
         "fused_recompute": dict(fused_bwd_kernels=False),
         "fused_kernel": dict(fused_bwd_kernels=True),
         "fused_saved": dict(fused_bwd_kernels=True, temporal_vjp="saved")}


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    videos = rng.uniform(0, 1, (BATCH, FRAMES, IMG, IMG, 3)).astype(
        np.float32)
    labels = rng.normal(size=(BATCH, FRAMES)).astype(np.float32)
    return videos, labels


@functools.lru_cache(maxsize=None)
def _jax_side(dtype):
    """The JAX model in `dtype`, its diffusion and params from its init."""
    j_model = JUNet3D(compute_dtype=dtype, **TINY)
    videos, labels = _batch()
    params = j_model.init(jax.random.PRNGKey(0), jnp.asarray(videos),
                          jnp.zeros((BATCH,), jnp.int32),
                          jnp.asarray(labels))
    return dtype, j_model, JDiffusion(model=j_model, **DIFF), params


def _draws(rng, b):
    """The t, noise and null mask that GaussianDiffusion.loss draws from
    rng (videometamaterials_tpu/diffusion/gaussian.py:491-539)."""
    t_rng, loss_rng = jax.random.split(rng)
    t = jax.random.randint(t_rng, (b,), 0, T)
    noise_rng, mask_rng, _ = jax.random.split(loss_rng, 3)
    noise = jax.random.normal(noise_rng, (b, FRAMES, IMG, IMG, 3))
    mask = jax.random.bernoulli(mask_rng, NULL_P, (b,))
    return (torch.tensor(np.asarray(t), dtype=torch.long),
            torch.tensor(np.asarray(noise)), torch.tensor(np.asarray(mask)))


def _port(params, dtype, plan, **kw):
    model = UNet3D(num_frames=FRAMES, compute_dtype=getattr(torch, dtype),
                   **TINY, **PLANS[plan])
    model.load_state_dict(flax_to_torch_state_dict(params), strict=True)
    return GaussianDiffusion(model, **DIFF, **kw)


@pytest.mark.parametrize("loss_type", ["l1", "l2"])
def test_loss_matches_jax(loss_type):
    dtype, j_model, _, params = _jax_side("float32")
    j_diff = JDiffusion(model=j_model, loss_type=loss_type, **DIFF)
    videos, labels = _batch()
    rng = jax.random.PRNGKey(7)
    want = j_diff.loss(params, rng, jnp.asarray(videos), jnp.asarray(labels),
                       null_cond_prob=NULL_P)
    t, noise, mask = _draws(rng, BATCH)
    diff = _port(params, dtype, "unfused", loss_type=loss_type)
    with torch.no_grad():
        got = diff.loss(torch.tensor(videos), torch.tensor(labels), t=t,
                        noise=noise, null_cond_mask=mask)
        per = diff.loss(torch.tensor(videos), torch.tensor(labels), t=t,
                        noise=noise, null_cond_mask=mask, per_sample=True)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(float(per.mean()), float(want), rtol=1e-5)


class _Spy:
    def __init__(self, monkeypatch, module, name):
        self.calls = 0
        fn = getattr(module, name)

        def wrapped(*a, **kw):
            self.calls += 1
            return fn(*a, **kw)

        monkeypatch.setattr(module, name, wrapped)


@functools.lru_cache(maxsize=None)
def _jax_grads(seed):
    """jax.grad of the float32 JAX loss on _batch() at PRNGKey(seed), as a
    state dict (one trace for every plan's test)."""
    _, _, j_diff, params = _jax_side("float32")
    rng = jax.random.PRNGKey(seed)
    videos, labels = _batch()
    want = jax.jit(jax.grad(lambda p: j_diff.loss(
        p, rng, jnp.asarray(videos), jnp.asarray(labels),
        null_cond_prob=NULL_P)))(params)
    return flax_to_torch_state_dict(want)


@pytest.mark.parametrize("plan", list(PLANS))
def test_gradients_match_jax(plan, monkeypatch):
    """Off the TPU the JAX model runs every block on its XLA plan, whatever
    its fused-block and backward settings: that is the reference of every
    plan here."""
    dtype, _, _, params = _jax_side("float32")
    videos, labels = _batch()
    rng = jax.random.PRNGKey(3)
    want = _jax_grads(3)
    t, noise, mask = _draws(rng, BATCH)

    spies = {"temporal_bwd": _Spy(monkeypatch, t_tmp, "temporal_block_bwd"),
             "linear_bwd": _Spy(monkeypatch, t_lin, "linear_block_bwd"),
             "linear_recompute": _Spy(monkeypatch, t_lin,
                                      "linear_block_recompute"),
             "temporal_from_p": _Spy(monkeypatch, t_tmp,
                                     "temporal_bwd_from_p")}
    diff = _port(params, dtype, plan)
    loss = diff.loss(torch.tensor(videos), torch.tensor(labels), t=t,
                     noise=noise, null_cond_mask=mask)
    loss.backward()
    # 6 temporal blocks (init, 2 down, mid, 2 up) and 4 linear blocks
    calls = {k: s.calls for k, s in spies.items()}
    assert calls == {
        "unfused": dict(temporal_bwd=0, linear_bwd=0, linear_recompute=0,
                        temporal_from_p=0),
        "fused_recompute": dict(temporal_bwd=0, linear_bwd=0,
                                linear_recompute=4, temporal_from_p=0),
        "fused_kernel": dict(temporal_bwd=6, linear_bwd=4,
                             linear_recompute=0, temporal_from_p=0),
        "fused_saved": dict(temporal_bwd=0, linear_bwd=4,
                            linear_recompute=0, temporal_from_p=6)}[plan]
    tol = F32_GRAD_TOL
    for name, p in diff.model.named_parameters():
        w = want[name].numpy()
        if p.grad is None:       # the init temporal block's cond projections
            assert not np.abs(w).any(), name
            continue
        scale = max(np.abs(w).max(), 1e-3)
        np.testing.assert_allclose(p.grad.numpy() / scale, w / scale,
                                   rtol=tol, atol=tol, err_msg=name)


@pytest.mark.parametrize("block", ["temporal", "linear"])
def test_bf16_block_gradients_match_jax(block):
    """One attention block in bf16 (the shapes of the JAX module test): the
    port's fused plan with the backward kernel (its twin here) against
    jax.grad of the JAX block, for the parameters, x and the position
    bias."""
    from videometamaterials_tpu.models.unet3d import (
        SpatialLinearAttentionBlock as JLinear,
        TemporalAttentionBlock as JTemporal,
    )
    from videometamaterials_tpu_torch.convert import (
        _attention,
        _linear_attention,
    )

    b, f, hw, c, heads, d, cond_dim = 2, 5, 16, 8, 4, 32, 32
    rng = np.random.default_rng(11)
    x = (rng.normal(size=(b, f, hw, hw, c)) * 0.5).astype(np.float32)
    label = (rng.normal(size=(b, f, cond_dim)) * 0.5).astype(np.float32)
    pos_bias = (rng.normal(size=(heads, f, f)) * 0.3).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    kw = dict(dim=c, heads=heads, dim_head=d, cond_attention="self-stacked",
              cond_dim=cond_dim, per_frame_cond=True, dtype=jnp.bfloat16)
    if block == "temporal":
        j_blk = JTemporal(use_rotary=True, **kw)
        call = dict(pos_bias=jnp.asarray(pos_bias))
        names = _attention("blk", ())
        t_blk = t_unet.TemporalAttentionBlock(c, heads, d, cond_dim,
                                              torch.bfloat16, True, "kernel")
    else:
        j_blk = JLinear(**kw)
        call = {}
        names = _linear_attention("blk", ())
        t_blk = t_unet.SpatialLinearAttentionBlock(
            c, heads, d, cond_dim, torch.bfloat16, True, "kernel")
    variables = j_blk.init(jax.random.PRNGKey(0), xj, label_emb=label, **call)
    # norm scales near 1 and not equal, so dgamma is seen
    variables["params"]["norm_gamma"] = jnp.asarray(
        1.0 + 0.2 * rng.normal(size=(c,)), jnp.float32)

    def j_loss(v, xx, pb):
        kw_ = dict(pos_bias=pb) if block == "temporal" else {}
        out = j_blk.apply(v, xx, label_emb=label, **kw_)
        return jnp.sum(out.astype(jnp.float32) ** 2)

    gv, gx, gb = jax.grad(j_loss, argnums=(0, 1, 2))(
        variables, xj, jnp.asarray(pos_bias))
    state, want = {}, {}
    for key, (path, fn) in names.items():
        leaf, gleaf = variables["params"], gv["params"]
        for part in path:
            if part not in leaf:
                break       # a projection of another conditioning mode
            leaf, gleaf = leaf[part], gleaf[part]
        if isinstance(leaf, dict):
            continue
        name = key.removeprefix("blk.")
        state[name] = torch.tensor(np.ascontiguousarray(fn(np.asarray(leaf))))
        want[name] = np.ascontiguousarray(fn(np.asarray(gleaf, np.float32)))
    t_blk.load_state_dict(state, strict=True)
    xt = torch.tensor(x).to(torch.bfloat16).requires_grad_(True)
    pbt = torch.tensor(pos_bias).requires_grad_(True)
    if block == "temporal":
        out = t_blk(xt, pbt, label_emb=torch.tensor(label))
    else:
        out = t_blk(xt, label_emb=torch.tensor(label))
    out.float().square().sum().backward()
    got = {n: p.grad for n, p in t_blk.named_parameters()}
    got["x"], want["x"] = xt.grad, np.asarray(gx, np.float32)
    if block == "temporal":
        got["pos_bias"], want["pos_bias"] = pbt.grad, np.asarray(gb)
    assert set(got) == set(want)
    for name, w in want.items():
        a = got[name].float().numpy()
        scale = np.abs(w).max()
        assert scale > 0, name
        np.testing.assert_allclose(a / scale, w / scale, rtol=0,
                                   atol=BF16_GRAD_TOL, err_msg=name)
        assert np.abs(a).max() > 0, name


# ----------------------------------------------------- optimizer and EMA
TCFG = t_config.TrainerConfig(ema_start_step=1, ema_update_every=2,
                              ema_decay=0.9)


def _optax_trajectory(p0, grads, lr, max_norm):
    """optax (clip +) adam and the EMA rule of
    videometamaterials_tpu/training/trainer.py:236-246, over the given
    per-step gradients."""
    chain = [optax.adam(lr)]
    if max_norm is not None:
        chain.insert(0, optax.clip_by_global_norm(max_norm))
    tx = optax.chain(*chain)
    params, ema = p0, p0
    state = tx.init(params)
    for step, g in enumerate(grads):
        updates, state = tx.update(g, state, params)
        params = optax.apply_updates(params, updates)
        do = step % TCFG.ema_update_every == 0
        reset = step < TCFG.ema_start_step
        beta = TCFG.ema_decay
        ema = jax.tree.map(
            lambda e, p: jnp.where(do, jnp.where(reset, p, e * beta
                                                 + (1.0 - beta) * p), e),
            ema, params)
    return params, ema


@pytest.mark.parametrize("max_norm", [None, 1.0])
def test_adam_clip_and_ema_match_optax(max_norm):
    """Three steps on the same gradients: the reset (step 0), the skip
    (step 1) and the lerp (step 2) of the EMA all happen; with max_norm
    the clip triggers on step 0 (norm ~8) and not on step 1 (~0.1)."""
    rng = np.random.default_rng(0)
    shapes = {"a": (4, 3), "b": (5,)}
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    scales = (4.0, 0.05, 1.0)
    grads = [{k: (rng.normal(size=s) * sc).astype(np.float32)
              for k, s in shapes.items()} for sc in scales]
    lr = 1e-2
    want_p, want_e = _optax_trajectory(p0, grads, lr, max_norm)

    module = torch.nn.ParameterDict(
        {k: torch.nn.Parameter(torch.tensor(v)) for k, v in p0.items()})
    state = TrainState.create(module, lr)
    tcfg = TCFG.replace(max_grad_norm=max_norm)
    for g in grads:
        for k, p in module.items():
            p.grad = torch.tensor(g[k])
        apply_gradients(state, tcfg)
    assert state.step == 3
    ema = state.ema_state_dict()
    for k, p in module.items():
        np.testing.assert_allclose(p.detach().numpy(), want_p[k], rtol=1e-6,
                                   atol=1e-7, err_msg=k)
        np.testing.assert_allclose(ema[k].numpy(), want_e[k], rtol=1e-6,
                                   atol=1e-7, err_msg=k)


@pytest.mark.parametrize("norm_scale", [0.5, 3.0])
def test_clip_is_optax_global_norm_clip(norm_scale):
    rng = np.random.default_rng(1)
    grads = [rng.normal(size=s).astype(np.float32) for s in ((3, 4), (7,))]
    norm = np.sqrt(sum((g.astype(np.float64) ** 2).sum() for g in grads))
    max_norm = float(norm / norm_scale)
    want, _ = optax.clip_by_global_norm(max_norm).update(
        [jnp.asarray(g) for g in grads], None)
    got = [torch.tensor(g) for g in grads]
    clip_by_global_norm_(got, max_norm)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
    if norm_scale < 1:              # below the limit: untouched
        for a, g in zip(got, grads):
            np.testing.assert_array_equal(a.numpy(), g)


def test_three_train_steps_match_jax():
    """Three steps of the port's train_step (unfused plan) against the JAX
    train step (trainer.py:217-254: value_and_grad of the loss, optax adam,
    the EMA rule) with the same per-step draws: the losses, and the EMA
    holding the reset parameters, then the lerp."""
    dtype, _, j_diff, params = _jax_side("float32")
    videos, labels = _batch(1)
    jv, jl = jnp.asarray(videos), jnp.asarray(labels)
    lr = 1e-4
    tx = optax.adam(lr)

    @jax.jit
    def j_step(p, opt_state, rng):
        loss, g = jax.value_and_grad(lambda q: j_diff.loss(
            q, rng, jv, jl, null_cond_prob=NULL_P))(p)
        updates, opt_state = tx.update(g, opt_state, p)
        return optax.apply_updates(p, updates), opt_state, loss

    diff = _port(params, dtype, "unfused")
    state = TrainState.create(diff.model, lr)
    p, opt_state = params, tx.init(params)
    ema_want = None
    for step in range(3):
        rng = jax.random.fold_in(jax.random.PRNGKey(5), step)
        p, opt_state, j_loss = j_step(p, opt_state, rng)
        t, noise, mask = _draws(rng, BATCH)
        loss = train_step(state, diff, torch.tensor(videos),
                          torch.tensor(labels), TCFG, fused_in_training=False,
                          t=t, noise=noise, null_cond_mask=mask)
        np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-4,
                                   err_msg=f"step {step}")
        cur = {k: v.detach().clone()
               for k, v in diff.model.named_parameters()}
        if step == 0:
            ema_want = cur
        elif step == 2:
            ema_want = {k: e * 0.9 + 0.1 * cur[k]
                        for k, e in ema_want.items()}
        for k, e in state.ema_state_dict().items():
            torch.testing.assert_close(e, ema_want[k], rtol=1e-6, atol=1e-7)
    assert state.step == 3
    # Adam moves an element by lr * m_hat / sqrt(v_hat), at most about
    # sqrt(t) lr after t steps (Cauchy-Schwarz over the moment sums). Where
    # a gradient sits at float32 noise (|g| ~ 1e-7 of the largest) the two
    # sides may step in opposite directions: up to 2 sqrt(3) lr apart. Every
    # other element follows the same trajectory.
    want = flax_to_torch_state_dict(p)
    n_far = n_all = 0
    for k, v in diff.model.named_parameters():
        err = (v.detach() - want[k]).abs()
        assert err.max() <= 2 * 3 ** 0.5 * lr, k
        n_far += int((err > 0.1 * lr).sum())
        n_all += err.numel()
    assert n_far <= 0.01 * n_all, (n_far, n_all)


def test_batch_sampler_streams_match_jax():
    cases = [dict(num_examples=10, batch_size=4, seed=0),
             dict(num_examples=10, batch_size=4, seed=3),
             dict(num_examples=9, batch_size=2, seed=1),
             dict(num_examples=8, batch_size=4, seed=2),
             dict(num_examples=3, batch_size=4, seed=4)]
    for kw in cases:
        ours, ref = iter(InfiniteBatchSampler(**kw)), iter(JSampler(**kw))
        for i in range(12):
            np.testing.assert_array_equal(next(ours), next(ref),
                                          err_msg=f"{kw} batch {i}")


# ---------------------------------------------------------------- wiring


def test_unported_options_raise(monkeypatch):
    """The trainer options that raised until they were ported (the focus
    mask, MultiSteps) are accepted; temporal_vjp 'saved' is ported and
    resolves, an unknown plan still raises, and the plan resolves as the
    JAX package's does (VMT_TEMPORAL_VJP unset here)."""
    monkeypatch.delenv("VMT_TEMPORAL_VJP", raising=False)
    assert t_config.ModelConfig(temporal_vjp="saved").temporal_vjp == "saved"
    assert t_config.temporal_bwd_mode("saved", False) == "saved"
    model = UNet3D(num_frames=FRAMES, temporal_vjp="saved", **TINY)
    assert {m.bwd for m in model.modules()
            if isinstance(m, t_unet.TemporalAttentionBlock)} == {"saved"}
    with pytest.raises(ValueError):
        t_config.ModelConfig(temporal_vjp="other")
    with pytest.raises(ValueError):
        UNet3D(num_frames=FRAMES, temporal_vjp="other", **TINY)
    assert t_config.TrainerConfig(
        prob_focus_present=0.1).prob_focus_present == 0.1
    tcfg = t_config.TrainerConfig(gradient_accumulate_every=2)
    state = TrainState.create(torch.nn.Linear(2, 2), 1e-3,
                              tcfg.gradient_accumulate_every)
    assert state.accum is not None and state.accum.k == 2
    assert t_config.temporal_bwd_mode(None, True) == "kernel"
    assert t_config.temporal_bwd_mode(None, False) == "recompute"
    assert t_config.temporal_bwd_mode("recompute", True) == "recompute"


@pytest.mark.parametrize("in_training", [False, True])
def test_train_plan_split_on_the_same_parameters(in_training, monkeypatch):
    """By default (fused_blocks_in_training false, as model.yaml) the train
    step runs every block on its unfused plan and sampling keeps the fused
    plans, on the same parameter objects; with the flag set the train step
    runs the fused plans."""
    cfg = t_config.ModelConfig(
        unet_dim=8, dim_mults=(1, 2), unet_attn_heads=2, unet_attn_dim_head=8,
        image_size=IMG, compute_dtype="float32", train_timesteps=T,
        sampling_timesteps=T, batch_size=BATCH,
        fused_blocks_in_training=in_training)
    assert cfg.use_fused_temporal_block == "all"
    model = t_unet.build_unet(cfg, device="cpu", seed=0)
    diff = GaussianDiffusion.from_config(model, cfg, "cpu")
    videos, labels = _batch()
    trainer = StepTrainer(diff, cfg, t_config.TrainerConfig(),
                          array_batches(videos, labels, cfg.batch_size))
    assert trainer.state.model is model
    opt_params = trainer.state.optimizer.param_groups[0]["params"]
    assert [id(p) for p in opt_params] == [id(p) for p in model.parameters()]

    spies = [_Spy(monkeypatch, t_unet, "fused_temporal_block"),
             _Spy(monkeypatch, t_unet, "fused_linear_block")]
    before = [p.detach().clone() for p in model.parameters()]
    loss = trainer.step()
    assert torch.isfinite(loss)
    assert [s.calls for s in spies] == ([6, 4] if in_training else [0, 0])
    assert any(not torch.equal(a, p) for a, p in zip(before,
                                                     model.parameters()))
    with torch.no_grad():                 # sampling: the fused plans
        diff.model(torch.zeros((1, FRAMES, IMG, IMG, 3)),
                   torch.zeros(1, dtype=torch.long),
                   torch.zeros((1, FRAMES)))
    assert [s.calls for s in spies] == ([6, 4] if not in_training
                                        else [12, 8])


def test_train_cli_runs_on_the_cpu(tmp_path, capsys):
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(
        "batch_size: 2\nlearning_rate: 1.e-4\nselected_channels: [0, 1, 3]\n"
        "train_timesteps: 8\nsampling_timesteps: 8\nunet_dim: 8\n"
        "dim_mults: [1, 2]\nunet_attn_heads: 2\nunet_attn_dim_head: 8\n"
        f"image_size: {IMG}\ncompute_dtype: float32\n"
        "fused_blocks_in_training: true\nfused_bwd_kernels: true\n")
    out = t_train.main(["--config", str(cfg), "--steps", "2",
                        "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split(":")[0] for ln in lines[:2]] == ["step 0", "step 1"]
    meta = json.loads(lines[-1])
    assert meta["steps"] == 2 and meta["device"] == "cpu"
    assert meta["fused_bwd_kernels"] is True
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()


def test_train_cli_runs_the_saved_plan_on_the_cpu(tmp_path, capsys,
                                                  monkeypatch):
    """temporal_vjp: saved in the YAML runs the train step with every
    temporal block backed through temporal_bwd_from_p."""
    spy = _Spy(monkeypatch, t_tmp, "temporal_bwd_from_p")
    cfg = tmp_path / "tiny_saved.yaml"
    cfg.write_text(
        "batch_size: 2\nlearning_rate: 1.e-4\nselected_channels: [0, 1, 3]\n"
        "train_timesteps: 8\nsampling_timesteps: 8\nunet_dim: 8\n"
        "dim_mults: [1, 2]\nunet_attn_heads: 2\nunet_attn_dim_head: 8\n"
        f"image_size: {IMG}\ncompute_dtype: float32\n"
        "fused_blocks_in_training: true\nfused_bwd_kernels: true\n"
        "temporal_vjp: saved\n")
    out = t_train.main(["--config", str(cfg), "--steps", "1",
                        "--device", "cpu"])
    meta = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert meta["temporal_vjp"] == "saved" and meta["device"] == "cpu"
    assert spy.calls == 6       # init, 2 down, mid, 2 up
    assert np.isfinite(out["losses"]).all()
