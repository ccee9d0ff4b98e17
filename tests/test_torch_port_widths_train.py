"""PyTorch port, the training kernels (rows 2, 3, 6 and 7) at every shape
the TPU kernels take, on the CPU: the twins that the any-shape CUDA
instances follow against the JAX Pallas kernels in interpret mode at 4
heads of 64, 16 heads of 32 and 3 frames, and against the JAX reference
VJP above 69 conditioning tokens; and one train step's loss and gradients
of a tiny 4 x 64-head UNet3D on the kernel and saved plans against the JAX
model (VMT_PALLAS_INTERPRET=1), and of a 96-token model against the JAX
XLA plan, on weights bridged by convert.py. The CUDA instances are held
against the same twins on the card (tests/test_torch_port_cuda.py,
chip_smoke.py phase 14)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videometamaterials_tpu.diffusion import GaussianDiffusion as JDiffusion
from videometamaterials_tpu.models import UNet3D as JUNet3D
from videometamaterials_tpu.ops.pallas.fused_linear_block import (
    fused_linear_block as j_linear,
)
from videometamaterials_tpu.ops.pallas.fused_temporal_block import (
    _run_kernel as j_run_kernel,
    fused_temporal_block as j_temporal,
    reference_temporal_block,
)
from videometamaterials_tpu_torch.convert import flax_to_torch_state_dict
from videometamaterials_tpu_torch.diffusion.gaussian import GaussianDiffusion
from videometamaterials_tpu_torch.models.unet3d import UNet3D
from videometamaterials_tpu_torch.ops.cuda import _build
from videometamaterials_tpu_torch.ops.cuda import fused_linear_block as lin
from videometamaterials_tpu_torch.ops.cuda import fused_temporal_block as tmp

torch.set_num_threads(1)

# each cotangent within 5e-2 of the oracle's largest |element|, rtol 0,
# and nonzero somewhere: the JAX package's rule for its backward kernels
# (tests/test_fused_temporal_block.py:277,
# tests/test_fused_linear_block.py:205-211), as
# tests/test_torch_port_train_kernels.py holds the flagship's twins
GRAD_TOL = 5e-2
# bf16 outputs: the JAX kernel test's tolerance
# (tests/test_fused_temporal_block.py:50)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)
# the softmax weights in bf16 sum to one within 2^-8 (8 significant bits),
# and float32 sums besides
P_SUM_TOL = 2.0 ** -7
T_NAMES = ("dx", "dgamma", "dw_all", "dw_out", "dek", "dev", "dbias")
L_NAMES = ("dx", "dgamma", "dw_qkv", "dw_out", "dout_bias", "dek", "dev")
# (heads, d): only the any-shape instances take these on the card
HEAD_SHAPES = [(4, 64), (16, 32)]
B, F, S, C = 2, 3, 128, 8


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def _assert_cotangents(names, got, want, tol=GRAD_TOL):
    for name, a, b in zip(names, got, want):
        if b is None:
            assert a is None, name
            continue
        a32 = a.float().numpy() if isinstance(a, torch.Tensor) \
            else np.asarray(a, np.float32)
        b32 = np.asarray(b, np.float32)
        scale = np.abs(b32).max()
        assert scale > 0, name
        np.testing.assert_allclose(a32 / scale, b32 / scale, rtol=0,
                                   atol=tol, err_msg=name)
        assert np.abs(a32).max() > 0, name


def _jax_vjp(fn, args, g):
    """Cotangents of fn at args (None operands stay None)."""
    present = [i for i, a in enumerate(args) if a is not None]

    def f(*xs):
        full = list(args)
        for i, v in zip(present, xs):
            full[i] = v
        return fn(*full)

    @jax.jit
    def cotangents(xs, g_):
        return jax.vjp(f, *xs)[1](g_)

    out = [None] * len(args)
    for i, v in zip(present, cotangents([args[i] for i in present], g)):
        out[i] = v
    return out


# ------------------------------------------------------ temporal (rows 2, 3)


def _temporal_args(heads, d, t_tok, f=F, s=S):
    hd = heads * d
    return (_rand((B, f, s, C), 0), _rand((C,), 1, 0.2) + 1.0,
            _rand((f, C, 3 * hd), 2, 0.1), _rand((hd, C), 3, 0.1),
            _rand((B, t_tok, hd), 5, 0.5) if t_tok else None,
            _rand((B, t_tok, hd), 6, 0.5) if t_tok else None,
            _rand((f, f + t_tok, heads), 7, 0.3))


def _bf16(args, lib):
    """x, w_all, w_out, ek, ev in bf16; gamma and the bias float32."""
    x, gamma, w_all, w_out, ek, ev, bias = args
    if lib == "jax":
        cast = (lambda a: None if a is None else jnp.asarray(a, jnp.bfloat16))
        return [cast(x), jnp.asarray(gamma), cast(w_all), cast(w_out),
                cast(ek), cast(ev), jnp.asarray(bias)]
    cast = (lambda a: None if a is None else torch.tensor(a).to(
        torch.bfloat16))
    return [cast(x), torch.tensor(gamma), cast(w_all), cast(w_out), cast(ek),
            cast(ev), torch.tensor(bias)]


@pytest.mark.parametrize("heads,d", HEAD_SHAPES)
def test_emit_p_twin_matches_the_jax_kernel(heads, d):
    """Row 2: the wrapper's (out, p) on CPU tensors against the JAX
    merged-layout kernel with emit_p in interpret mode, 3 frames and 3
    tokens; p sums to one per position and head."""
    t_tok = F
    args = _temporal_args(heads, d, t_tok)
    assert tmp.forward_instance(F, heads, d, C, t_tok) == tmp.ANY_SHAPE
    before = dict(_build.LAUNCH_COUNTS)
    out, p = tmp.temporal_block_fwd(*_bf16(args, "torch"), heads=heads,
                                    emit_p=True)
    assert _build.LAUNCH_COUNTS == before     # CPU tensor: the twin ran
    want_out, want_p = j_run_kernel(*_bf16(args, "jax"), heads=heads,
                                    tile=128, interpret=True,
                                    softmax_layout="merged", emit_p=True)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want_out, np.float32), **BF16_TOL)
    np.testing.assert_allclose(p.float().numpy(),
                               np.asarray(want_p, np.float32), **BF16_TOL)
    sums = p.float().reshape(B, F, S, F + t_tok, heads).sum(dim=3)
    assert (sums - 1).abs().max() <= P_SUM_TOL


@pytest.mark.parametrize("heads,d", HEAD_SHAPES)
def test_temporal_bwd_twin_matches_the_jax_kernel(heads, d):
    """Row 3: the wrapper's cotangents on CPU tensors against jax.vjp of
    the JAX fused_temporal_block with its backward kernel, interpret mode,
    bf16, 3 frames and 3 tokens."""
    args = _temporal_args(heads, d, F)
    g = _rand((B, F, S, C), 8)
    got = tmp.temporal_block_bwd(*_bf16(args, "torch"),
                                 torch.tensor(g).to(torch.bfloat16),
                                 heads=heads)

    def fn(*a):
        return j_temporal(*a, heads=heads, tile=128, interpret=True,
                          bwd_kernel=True)

    want = _jax_vjp(fn, _bf16(args, "jax"), jnp.asarray(g, jnp.bfloat16))
    _assert_cotangents(T_NAMES, got, want)


@pytest.mark.parametrize("t_tok", [70, 96])
def test_training_rows_above_69_tokens_match_the_reference_vjp(t_tok):
    """Rows 2 and 3 at more tokens than the specialised kernels take (2
    frames, 4 heads of 32, bf16), against jax.vjp of the JAX XLA reference:
    the backward twin's cotangents, and the saved plan's (the twin's p
    through temporal_bwd_from_p); out against the reference forward."""
    f = 2
    args = _temporal_args(4, 32, t_tok, f=f, s=64)
    g = _rand((B, f, 64, C), 8)
    t_args = _bf16(args, "torch")
    g_t = torch.tensor(g).to(torch.bfloat16)
    jargs = _bf16(args, "jax")

    def fn(*a):
        return reference_temporal_block(*a, heads=4)

    want = _jax_vjp(fn, jargs, jnp.asarray(g, jnp.bfloat16))
    _assert_cotangents(T_NAMES, tmp.temporal_block_bwd(*t_args, g_t, heads=4),
                       want)
    out, p = tmp.temporal_block_fwd(*t_args, heads=4, emit_p=True)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(fn(*jargs), np.float32), **BF16_TOL)
    sums = p.float().reshape(B, f, 64, f + t_tok, 4).sum(dim=3)
    assert (sums - 1).abs().max() <= P_SUM_TOL
    _assert_cotangents(T_NAMES, tmp.temporal_bwd_from_p(*t_args, p, g_t,
                                                        heads=4), want)


# ------------------------------------------------------ linear (rows 6, 7)


def _linear_args(heads, d, n_cond, bf=2, n=16):
    hd = heads * d
    return (_rand((bf, n, C), 0), _rand((C,), 1, 0.2) + 1.0,
            _rand((C, 3 * hd), 2, 0.1), _rand((hd, C), 3, 0.1),
            _rand((C,), 4, 0.1), _rand((bf, n_cond, hd), 5, 0.5),
            _rand((bf, n_cond, hd), 6, 0.5))


@pytest.mark.parametrize("route", ["head", "merged"])
@pytest.mark.parametrize("heads,d", HEAD_SHAPES)
def test_linear_bwd_twin_matches_the_jax_kernel(heads, d, route):
    """Rows 6 (per-head) and 7 (merged): the wrapper's cotangents on CPU
    tensors against jax.vjp of the JAX fused_linear_block with the backward
    kernel of the same route, interpret mode, float32 (the JAX linear
    kernel tests' dtype), 3 conditioning tokens."""
    args = _linear_args(heads, d, F)
    g = _rand(args[0].shape, 8)
    kw = dict(heads=heads, scale=d ** -0.5, spatial_size=args[0].shape[1])
    assert lin.forward_instance(heads, d, C) == lin.ANY_SHAPE
    before = dict(_build.LAUNCH_COUNTS)
    got = lin.linear_block_bwd(*(torch.tensor(a) for a in args),
                               torch.tensor(g), **kw, route=route)
    assert _build.LAUNCH_COUNTS == before

    def fn(*a):
        return j_linear(*a, **kw, interpret=True, bwd_kernel=True,
                        layout=route)

    want = _jax_vjp(fn, [jnp.asarray(a) for a in args], jnp.asarray(g))
    _assert_cotangents(L_NAMES, got, want)


# ------------------------------------------------------ rows 6-7's plan
# `fused_linear_block.bwd_any_plan`, the mirror of csrc/any_linear_bwd.cu's
# bwd_plan (chip_smoke.py holds the two equal on the card at every launch)


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_plan", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _phase14_linear_shapes(tmp_path):
    """(BF, N, C, heads, d) of every rows 6-7 any-shape launch of
    chip_smoke.py phase 14 (a): the heads4x64 and wide train paths, the
    grid, the ragged shapes and WTRAIN_PLAN_LINEAR."""
    import itertools

    from videometamaterials_tpu_torch.config import load_model_yaml

    cs = _chip_smoke()
    shapes = {(22, cs.WIDTH_S, c, h, d) for (h, d), c in itertools.product(
        cs.WIDTH_HEADS, cs.WIDTH_C)}
    shapes |= {(22, 9191, c, h, d) for (h, d), c, _ in cs.WIDTH_RAGGED_LINEAR}
    shapes |= {(bf, n, c, h, d) for bf, n, c, _, h, d in cs.WTRAIN_PLAN_LINEAR}
    paths = set()
    for name in ("heads4x64", "wide"):
        cfg = load_model_yaml(cs.width_yaml(tmp_path, name))
        for batch in cs.WTRAIN_PATH_BATCHES[name]:
            path = cs.train_path(cfg, batch)
            for plan in cs.WTRAIN_PLANS:
                for key in ("linear_bwd_head_any", "linear_bwd_merged_any"):
                    paths |= {(bf, n, c, h, d) for bf, n, c, _, h, d, _ in
                              path[plan][1].get(key, ())}
    assert paths, "the train paths launch rows 6-7 any-shape"
    return shapes | paths


def test_bwd_any_plan_fits_every_phase14_shape(tmp_path):
    """Every rows 6-7 launch of phase 14 (a) is planned within 227 KB of
    shared memory a block; d pads to 16 ceil(d / 16) (d = 40 to 48); the
    passes are resident at C <= 64 (pass 2 to C = 128 where its two
    groups' weights fit) and streamed above C = 128, with 3 to 6 stages;
    a pass-2 group is at most 64 / rows heads and 128 padded columns; a
    streamed pass 2 and only it is followed by pass 3."""
    for bf, n, c, heads, d in sorted(_phase14_linear_shapes(tmp_path)):
        plan = lin.bwd_any_plan(bf, n, c, heads, d)
        assert plan["dp"] == -(-d // 16) * 16, plan
        for stage in ("sums", "tok"):
            assert 0 < plan[f"{stage}_smem"] <= lin.MAX_SMEM
            if plan[f"{stage}_res"]:
                assert c <= 128 and plan[f"{stage}_stages"] == 0, plan
            else:
                assert (lin.ANY_MIN_STAGES <= plan[f"{stage}_stages"]
                        <= lin.ANY_MAX_STAGES), plan
        if c <= 64:
            assert plan["sums_res"] and plan["tok_res"], (c, plan)
        if c <= 128 and plan["dp"] <= 48:
            assert plan["tok_res"], (c, plan)
        assert plan["sums_tile"] in (64, 256, 1024)
        assert plan["tok_rows"] in (16, 32, 64)
        group = plan["tok_group"]
        assert 1 <= group <= 64 // plan["tok_rows"]
        assert group * plan["dp"] <= 128
        if plan["tok_res"]:
            assert plan["dx_rows"] == plan["dx_stages"] == plan["dx_smem"] == 0
        else:
            assert plan["dx_rows"] in (16, 32, 64)
            assert 0 < plan["dx_smem"] <= lin.MAX_SMEM
            assert (lin.ANY_MIN_STAGES <= plan["dx_stages"]
                    <= lin.ANY_MAX_STAGES)
    assert lin.bwd_any_plan(22, 144, 96, 4, 40)["dp"] == 48


def test_bwd_any_plan_reaches_every_mode(tmp_path):
    """Phase 14 (a)'s shapes take every mode of the plan: pass-1 tiles of
    64, 256 and 1024 tokens, resident and streamed passes, pass-2 tiles of
    64, 32 and 16 tokens, head groups of 1, 2 and 4, pass-3 tiles of 64,
    32 and 16 tokens, d padded to 16, 32, 48 and 64, ragged N (a last tile
    of other rows)."""
    shapes = sorted(_phase14_linear_shapes(tmp_path))
    plans = [lin.bwd_any_plan(*shape) for shape in shapes]
    want = dict(sums_tile={64, 256, 1024}, sums_res={0, 1},
                tok_rows={16, 32, 64}, tok_group={1, 2, 4}, tok_res={0, 1},
                dx_rows={16, 32, 64}, dp={16, 32, 48, 64})
    for key, values in want.items():
        assert {p[key] for p in plans} >= values, key
    assert any(n % p["tok_rows"] for (_, n, _, _, _), p in zip(shapes, plans))


@pytest.mark.parametrize("heads", [1, 3, 4, 16, 64])
def test_bwd_any_plan_fits_every_d(heads):
    """Over d up to 64, C from 8 to 4096 and N from 1 to 9216 the plan
    fits 227 KB a block, or refuses with ValueError: d > 64, or a streamed
    pass 2 (always above C = 128, never at C <= 64) whose 3 x heads x d
    dqkv columns (padded to 64) pass BWD_MAX_DQKV, what pass 3's rows of
    16 tokens leave room for."""
    for d in range(1, lin.ANY_MAX_D + 1, 3):
        for c in (8, 40, 128, 1024, 4096):
            for n in (1, 144, 9216):
                kp = -(-3 * heads * d // lin.BWD_DX_K) * lin.BWD_DX_K
                try:
                    plan = lin.bwd_any_plan(22, n, c, heads, d)
                except ValueError:
                    assert c > 64 and kp > lin.BWD_MAX_DQKV, (c, heads, d)
                    continue
                if c > 128:
                    assert kp <= lin.BWD_MAX_DQKV and not plan["tok_res"]
                assert max(plan["sums_smem"], plan["tok_smem"],
                           plan["dx_smem"]) <= lin.MAX_SMEM
    with pytest.raises(ValueError):
        lin.bwd_any_plan(22, 144, 64, heads, 65)


# ------------------------------------------------------ one train step

IMG, T_STEPS, CURVE = 8, 16, 50
# one level (init, down, mid and up temporal blocks): the JAX kernels'
# interpret mode compiles each block's forward and backward
TINY = dict(dim=8, dim_mults=(1,), channels=3, init_kernel_size=3,
            use_temporal_attention_cond=True)
DIFF = dict(image_size=IMG, channels=3, timesteps=T_STEPS)
# (frames, UNet3D keywords). Every plan is held against the JAX model's
# XLA plan (its off-TPU plan, the reference of tests/test_torch_port_train.py)
# at XLA_SHARE of each parameter's largest gradient, float32 on both sides:
# the sums' order differs, nothing rounds. The 4 x 64-head model's loss is
# also held against the JAX model with its temporal kernels in interpret
# mode (VMT_PALLAS_INTERPRET=1), within INTERPRET_LOSS: those kernels round
# their softmax weights and value sums to bf16 in a float32 model too
# (fused_temporal_block.py:226, :235). Its gradients are no oracle at any
# useful bound: they lie up to 17% of a parameter's max away from the JAX
# XLA plan's (a resnet norm's, measured on this model), where the port's
# float32 twins round nowhere and lie within 1e-5; the kernels' own
# cotangents are held against the interpret-mode kernels above
MODELS = {
    # 4 heads of 64 in the temporal blocks, 4 x 32 = 128 in the linear ones
    "heads4x64": (2, dict(attn_heads=4, attn_dim_head=64,
                          per_frame_cond=True)),
    # the CNN hidden broadcast to 96 tokens: 98 keys a position
    "tokens96": (2, dict(attn_heads=2, attn_dim_head=4, per_frame_cond=False,
                         cond_attention="self-stacked",
                         cond_attention_tokens=96)),
}
XLA_SHARE = 1e-4
INTERPRET_LOSS = 1e-3
PLANS = {"kernel": dict(fused_bwd_kernels=True),
         "saved": dict(fused_bwd_kernels=True, temporal_vjp="saved")}


def _random_params(model, args, seed):
    """A random parameter tree of the JAX model's structure (its init
    would run the interpret-mode kernels): LeCun-scaled kernels, norm
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


def _train_batch(frames, width):
    rng = np.random.default_rng(0)
    videos = rng.uniform(0, 1, (2, frames, IMG, IMG, 3)).astype(np.float32)
    labels = rng.uniform(-1, 1, (2, width)).astype(np.float32)
    return videos, labels


def _jax_draws(rng, frames, b=2, null_p=0.5):
    """The t, noise and null mask that the JAX loss draws from rng
    (videometamaterials_tpu/diffusion/gaussian.py:491-539)."""
    t_rng, loss_rng = jax.random.split(rng)
    t = jax.random.randint(t_rng, (b,), 0, T_STEPS)
    noise_rng, mask_rng, _ = jax.random.split(loss_rng, 3)
    noise = jax.random.normal(noise_rng, (b, frames, IMG, IMG, 3))
    mask = jax.random.bernoulli(mask_rng, null_p, (b,))
    return (torch.tensor(np.asarray(t), dtype=torch.long),
            torch.tensor(np.asarray(noise)), torch.tensor(np.asarray(mask)))


def _jax_loss(frames, kw, batch, interpret):
    """The JAX train step's loss function of the parameters, on its XLA
    plan or (interpret) its temporal kernels in interpret mode."""
    j_model = JUNet3D(compute_dtype="float32", use_fused_temporal_block=True,
                      use_fused_linear_block=True, fused_bwd_kernels=True,
                      **TINY, **kw)
    j_diff = JDiffusion(model=j_model, num_frames=frames, **DIFF)
    videos, labels, rng = batch

    def loss(p):
        with pytest.MonkeyPatch.context() as mp:
            if interpret:
                mp.setenv("VMT_PALLAS_INTERPRET", "1")
            return j_diff.loss(p, rng, jnp.asarray(videos),
                               jnp.asarray(labels), null_cond_prob=0.5)
    return loss


@pytest.fixture(scope="module", params=sorted(MODELS))
def jax_steps(request):
    """(model, frames, keywords, flax params, batch, the JAX XLA plan's
    loss and gradients (a state dict), the interpret-mode loss (the 4 x
    64-head model) or None)."""
    name = request.param
    frames, kw = MODELS[name]
    videos, labels = _train_batch(frames, frames if kw["per_frame_cond"]
                                  else CURVE)
    j_model = JUNet3D(compute_dtype="float32", **TINY, **kw)
    params = _random_params(j_model, (videos, np.zeros((2,), np.int32),
                                      labels), 2)
    batch = (videos, labels, jax.random.PRNGKey(3))
    loss, grads = jax.jit(jax.value_and_grad(
        _jax_loss(frames, kw, batch, False)))(params)
    interp = (float(jax.jit(_jax_loss(frames, kw, batch, True))(params))
              if name == "heads4x64" else None)
    return (name, frames, kw, params, batch,
            (float(loss), flax_to_torch_state_dict(grads)), interp)


@pytest.mark.parametrize("plan", list(PLANS))
def test_train_step_at_other_widths_matches_jax(jax_steps, plan):
    """One step's loss and every parameter's gradient of the port's fused
    plan (the twins of rows 1-3 and 4-7 here; the linear blocks of 4 x 32
    on the kernel backward, as the JAX gate passes them) against the JAX
    train step on the same weights, draws and batch."""
    name, frames, kw, params, (videos, labels, rng), (want_loss, want), \
        interp_loss = jax_steps
    model = UNet3D(compute_dtype=torch.float32, num_frames=frames,
                   cond_length=CURVE, use_fused_linear_block="all",
                   use_fused_temporal_block="all", **TINY, **kw,
                   **PLANS[plan])
    model.load_state_dict(flax_to_torch_state_dict(params), strict=True)
    temporal = [m for m in model.modules()
                if type(m).__name__ == "TemporalAttentionBlock"]
    assert temporal and all(m.use_fused_block for m in temporal)
    diff = GaussianDiffusion(model, num_frames=frames, **DIFF)
    t, noise, mask = _jax_draws(rng, frames)
    calls = {"bwd": 0, "from_p": 0}
    bwd, from_p = tmp.temporal_block_bwd, tmp.temporal_bwd_from_p

    def count(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmp, "temporal_block_bwd", count("bwd", bwd))
        mp.setattr(tmp, "temporal_bwd_from_p", count("from_p", from_p))
        loss = diff.loss(torch.tensor(videos), torch.tensor(labels), t=t,
                         noise=noise, null_cond_mask=mask)
        loss.backward()
    # 4 temporal blocks: init, down, mid, up
    assert calls == ({"bwd": 4, "from_p": 0} if plan == "kernel"
                     else {"bwd": 0, "from_p": 4}), calls
    np.testing.assert_allclose(loss.item(), want_loss, rtol=XLA_SHARE)
    if interp_loss is not None:
        np.testing.assert_allclose(loss.item(), interp_loss,
                                   rtol=INTERPRET_LOSS)
    for pname, p in model.named_parameters():
        w = want[pname].numpy()
        if p.grad is None:       # the init temporal block's cond projections
            assert not np.abs(w).any(), pname
            continue
        scale = max(np.abs(w).max(), 1e-3)
        got = p.grad.numpy()
        np.testing.assert_allclose(got / scale, w / scale, rtol=0,
                                   atol=XLA_SHARE, err_msg=pname)
