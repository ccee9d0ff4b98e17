"""PyTorch port, DDIM and latent interpolation on the CPU, against the JAX
GaussianDiffusion on the same tiny float32 model: the DDIM time pairs, the
DDIM steps (guided, w = 5, eta 0 and 0.5, CFG rescale, the t_next = -1
last step) against `_ddim_scan` one step at a time with its noise
replayed from its key, the chain and `sample()`'s dispatch, and
`interpolate` on JAX's noises, replayed from its `jax.random.split`
sequence."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videometamaterials_tpu.diffusion import GaussianDiffusion as JDiffusion
from videometamaterials_tpu.models import UNet3D as JUNet3D
from videometamaterials_tpu_torch.convert import flax_to_torch_state_dict
from videometamaterials_tpu_torch.diffusion.gaussian import GaussianDiffusion
from videometamaterials_tpu_torch.models.unet3d import UNet3D

torch.set_num_threads(1)

TINY = dict(dim=16, dim_mults=(1, 2), channels=3, attn_heads=2,
            attn_dim_head=8, init_kernel_size=3,
            use_temporal_attention_cond=True, per_frame_cond=True)
FRAMES, IMG, T, STEPS = 11, 8, 16, 4
DIFF = dict(image_size=IMG, num_frames=FRAMES, channels=3, timesteps=T,
            use_dynamic_thres=True)
# as tests/test_torch_port_sampler.py: the model's float32 error (2e-4
# relative) scaled by the step's coefficients
STEP_TOL = dict(rtol=1e-3, atol=1e-3)


class _ZeroModel:
    def apply(self, params, x, t, cond, null_cond_mask=None,
              cfg_tiled_pair=False):
        return jnp.zeros((t.shape[0],) + x.shape[1:], jnp.float32)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


@pytest.fixture(scope="module")
def models():
    j_model = JUNet3D(compute_dtype="float32", **TINY)
    x = np.zeros((1, FRAMES, IMG, IMG, 3), np.float32)
    shapes = jax.eval_shape(j_model.init, jax.random.PRNGKey(0), x,
                            np.zeros((1,), np.int32),
                            np.zeros((1, FRAMES), np.float32))
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda s: (rng.standard_normal(s.shape)
                   / np.sqrt(np.prod(s.shape[:-1]) if len(s.shape) > 1
                             else 20.0)).astype(np.float32)
        + np.float32(len(s.shape) == 1), shapes)
    t_model = UNet3D(compute_dtype=torch.float32, num_frames=FRAMES,
                     use_fused_linear_block="all",
                     use_fused_temporal_block="all", **TINY)
    t_model.load_state_dict(flax_to_torch_state_dict(params), strict=True)
    return j_model, jax.tree.map(jnp.asarray, params), t_model.eval()


@pytest.mark.parametrize("total,steps", [(16, 4), (256, 64), (256, 50)])
def test_ddim_pairs_equal_jax(total, steps, monkeypatch):
    """The pairs ddim_sample hands _ddim_scan, against the port's."""
    seen = []

    def scan(self, params, img, rng, pairs, cond, guidance_scale,
             cfg_rescale=None):
        seen.append(np.asarray(pairs))
        return img, rng

    monkeypatch.setattr(JDiffusion, "_ddim_scan", scan)
    j = JDiffusion(model=_ZeroModel(), image_size=4, num_frames=2,
                   channels=1, timesteps=total, sampling_timesteps=steps,
                   scan_chunk_size=None)
    j.ddim_sample(None, jax.random.PRNGKey(0), (1, 2, 4, 4, 1), None, 1.0)
    port = GaussianDiffusion(None, image_size=4, num_frames=2, channels=1,
                             timesteps=total, sampling_timesteps=steps)
    assert port.is_ddim_sampling
    assert [tuple(p) for p in seen[0].tolist()] == port.ddim_pairs()
    assert len(port.ddim_pairs()) == steps
    assert port.ddim_pairs()[-1][1] == -1


def _ddim_gain(port, t, t_next):
    """d img_next / d eps of a DDIM step."""
    root = np.sqrt(1.0 / port._abar[t] - 1.0)
    if t_next < 0:
        return -root
    sqrt_next, c, _ = port.ddim_coeffs(t, t_next)
    return c - sqrt_next * root


@pytest.mark.parametrize("eta,phi", [(0.0, 0.0), (0.5, 0.7)])
def test_ddim_steps_match_jax(models, eta, phi, monkeypatch):
    """Each pair's step from the same unit-normal image on both sides
    (the chain of an untrained model leaves that scale after its first
    step), on the noise _ddim_scan draws (key, sub = split(key);
    normal(sub)): the guided eps at STEP_TOL (the model's float32 error
    times the 2w - 1 of CFG), the step on JAX's eps, and the step on the
    port's own eps wherever |d img / d eps| <= 2, at STEP_TOL. The first
    step's gain is about 390 (its x0 divides by sqrt(alphas_cumprod[T-1])
    ~ 1e-3): the model's float32 error, 2e-5 here, becomes 1e-2 there in
    either package, so that step is held through its two parts."""
    j_model, params, t_model = models
    j = JDiffusion(model=j_model, sampling_timesteps=STEPS,
                   ddim_sampling_eta=eta, cfg_rescale=phi, **DIFF)
    port = GaussianDiffusion(t_model, sampling_timesteps=STEPS,
                             ddim_sampling_eta=eta, cfg_rescale=phi, **DIFF)
    b, w = 2, 5.0
    shape = (b, FRAMES, IMG, IMG, 3)
    cond = np.random.default_rng(1).uniform(-1, 1, (b, FRAMES)).astype(
        np.float32)
    t_cond = torch.tensor(cond)
    scan = jax.jit(lambda p, i, r, pr, c: j._ddim_scan(p, i, r, pr, c, w))
    eps_fn = jax.jit(lambda p, i, t, c: j.guided_eps(p, i, t, c, w))
    pairs = port.ddim_pairs()
    assert pairs[-1][1] == -1
    gains = [_ddim_gain(port, t, t_next) for t, t_next in pairs]
    assert abs(gains[0]) > 100 and max(map(abs, gains[1:])) <= 2

    key = jax.random.PRNGKey(3)
    own_eps = port.guided_eps
    for i, (t, t_next) in enumerate(pairs):
        j_img = jnp.asarray(_rand(shape, 2 + i))
        _, sub = jax.random.split(key)
        noise = torch.tensor(np.asarray(
            jax.random.normal(sub, shape, jnp.float32)))
        j_next, key = scan(params, j_img, key,
                           jnp.asarray([[t, t_next]], jnp.int32),
                           jnp.asarray(cond))
        x = torch.tensor(np.asarray(j_img))
        j_eps = eps_fn(params, j_img, jnp.full((b,), t), jnp.asarray(cond))
        with torch.no_grad():
            eps = own_eps(x, torch.full((b,), t), t_cond, w)
            np.testing.assert_allclose(eps.numpy(), np.asarray(j_eps),
                                       **STEP_TOL, err_msg=f"eps step {i}")
            monkeypatch.setattr(port, "guided_eps", lambda *a: torch.tensor(
                np.asarray(j_eps)))
            on_jax_eps = port.ddim_step(x, t, t_next, t_cond, w, noise)
            monkeypatch.setattr(port, "guided_eps", own_eps)
            got = port.ddim_step(x, t, t_next, t_cond, w, noise)
        where = f"step {i} ({t} -> {t_next})"
        np.testing.assert_allclose(on_jax_eps.numpy(), np.asarray(j_next),
                                   **STEP_TOL, err_msg=where)
        if abs(gains[i]) <= 2:
            np.testing.assert_allclose(got.numpy(), np.asarray(j_next),
                                       **STEP_TOL, err_msg=where)


def test_ddim_chain_is_its_steps_and_replays_jax(models):
    """sample() runs ddim_step over the pairs with x_T and noise_fn(i);
    on a model JAX and the port compute alike (zero eps), the port's
    chain from JAX's x_T and replayed noises (split(key) a step) gives
    ddim_sample's result, the eta noise included."""
    *_, t_model = models
    port = GaussianDiffusion(t_model, sampling_timesteps=STEPS,
                             ddim_sampling_eta=0.5, **DIFF)
    shape = (2, FRAMES, IMG, IMG, 3)
    cond = torch.tensor(np.random.default_rng(1).uniform(
        -1, 1, (2, FRAMES)).astype(np.float32))
    x_t = torch.tensor(_rand(shape, 2))
    noises = [torch.tensor(_rand(shape, 20 + i)) for i in range(STEPS)]
    img = x_t
    with torch.no_grad():
        for i, (t, t_next) in enumerate(port.ddim_pairs()):
            img = port.ddim_step(img, t, t_next, cond, 5.0, noises[i])
    out = port.sample(cond, 5.0, x_T=x_t, noise_fn=lambda i: noises[i])
    assert torch.equal(out, (img + 1) * 0.5)

    j = JDiffusion(model=_ZeroModel(), sampling_timesteps=STEPS,
                   ddim_sampling_eta=0.5, **DIFF)
    zero = GaussianDiffusion(lambda x, t, *a, **k: torch.zeros(
        (t.shape[0],) + tuple(x.shape[1:])), sampling_timesteps=STEPS,
        ddim_sampling_eta=0.5, **DIFF)
    want = j.ddim_sample(None, jax.random.PRNGKey(4), shape,
                         jnp.asarray(cond.numpy()), 5.0)
    rng, init = jax.random.split(jax.random.PRNGKey(4))
    replay = []
    for _ in range(STEPS):
        rng, sub = jax.random.split(rng)
        replay.append(torch.tensor(np.asarray(
            jax.random.normal(sub, shape, jnp.float32))))
    got = zero.sample(cond, 5.0, x_T=torch.tensor(np.asarray(
        jax.random.normal(init, shape, jnp.float32))),
        noise_fn=lambda i: replay[i])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_ddpm_when_sampling_timesteps_equal_train_timesteps(models):
    *_, t_model = models
    port = GaussianDiffusion(t_model, **DIFF)
    assert not port.is_ddim_sampling and port.sampling_timesteps == T
    calls = []
    port.p_sample_loop = lambda *a, **k: calls.append("ddpm")
    port.ddim_sample = lambda *a, **k: calls.append("ddim")
    port.sample(torch.zeros(1, FRAMES), 5.0)
    assert calls == ["ddpm"]
    with pytest.raises(ValueError, match="sampling_timesteps"):
        GaussianDiffusion(None, sampling_timesteps=T + 1, **DIFF)


@pytest.mark.parametrize("with_cond,w", [(True, 5.0), (False, 1.0)])
def test_interpolate_matches_jax(models, with_cond, w):
    """JAX's interpolate(rng): rng, n1, n2 = split(rng, 3), the two
    noises from n1 and n2, then a p_sample a step, each from
    split(key)[1]; the port gets the same noises. cond None is zeros."""
    j_model, params, t_model = models
    j = JDiffusion(model=j_model, **DIFF)
    port = GaussianDiffusion(t_model, **DIFF)
    b, t, lam = 2, 5, 0.3
    shape = (b, FRAMES, IMG, IMG, 3)
    x1 = np.clip(_rand(shape, 5, 0.5), -1, 1)
    x2 = np.clip(_rand(shape, 6, 0.5), -1, 1)
    cond = (np.random.default_rng(7).uniform(-1, 1, (b, FRAMES))
            .astype(np.float32) if with_cond else None)
    rng = jax.random.PRNGKey(8)
    want = j.interpolate(params, rng, jnp.asarray(x1), jnp.asarray(x2), t=t,
                         lam=lam, guidance_scale=w,
                         cond=None if cond is None else jnp.asarray(cond))

    key, n1, n2 = jax.random.split(rng, 3)
    noise1 = np.asarray(jax.random.normal(n1, shape, jnp.float32))
    noise2 = np.asarray(jax.random.normal(n2, shape, jnp.float32))
    steps = []
    for _ in range(t):
        key, sub = jax.random.split(key)
        steps.append(np.asarray(jax.random.normal(sub, shape, jnp.float32)))
    got = port.interpolate(
        torch.tensor(x1), torch.tensor(x2), t=t, lam=lam, guidance_scale=w,
        cond=None if cond is None else torch.tensor(cond),
        noise1=torch.tensor(noise1), noise2=torch.tensor(noise2),
        noise_fn=lambda i: torch.tensor(steps[i]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **STEP_TOL)


def test_q_mean_variance_matches_jax():
    x = _rand((3, FRAMES, IMG, IMG, 3), 9)
    t = np.array([0, 7, 15])
    j = JDiffusion(model=_ZeroModel(), **DIFF)
    port = GaussianDiffusion(None, **DIFF)
    for got, want in zip(port.q_mean_variance(torch.tensor(x),
                                              torch.tensor(t)),
                         j.q_mean_variance(jnp.asarray(x), jnp.asarray(t))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-7)
