"""PyTorch port, sampler on the CPU: guided DDPM steps (w = 5, bisect
dynamic thresholding) against the JAX GaussianDiffusion driven through
p_mean_variance with the same injected x_T and per-step noise, plus the
thresholding and CFG-rescale pieces on their own."""

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
            attn_dim_head=8, init_kernel_size=3, use_temporal_attention_cond=True,
            per_frame_cond=True)
FRAMES, IMG, T = 11, 8, 16
DIFF = dict(image_size=IMG, num_frames=FRAMES, channels=3, timesteps=T,
            use_dynamic_thres=True)
# float32 both sides; the step's error is the model's (2e-4 relative)
# scaled by the posterior coefficients, and a bisection round can move the
# threshold by max|x0| / 4096 when the two sides' x0 straddle a midpoint
STEP_TOL = dict(rtol=1e-3, atol=1e-3)


class _ZeroModel:
    def apply(self, params, x, t, cond, null_cond_mask=None,
              cfg_tiled_pair=False):
        b = t.shape[0]
        return jnp.zeros((b,) + x.shape[1:], jnp.float32)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    j_model = JUNet3D(compute_dtype="float32", **TINY)
    x = np.zeros((1, FRAMES, IMG, IMG, 3), np.float32)
    t = np.zeros((1,), np.int32)
    c = np.zeros((1, FRAMES), np.float32)
    shapes = jax.eval_shape(j_model.init, jax.random.PRNGKey(0), x, t, c)
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
    return (JDiffusion(model=j_model, **DIFF), params,
            GaussianDiffusion(t_model.eval(), **DIFF))


def test_guided_steps_match_jax(pair):
    j_diff, params, t_diff = pair
    b, w = 2, 5.0
    shape = (b, FRAMES, IMG, IMG, 3)
    cond = np.random.default_rng(1).uniform(-1, 1, (b, FRAMES)).astype(
        np.float32)
    x_t = _rand(shape, 2)
    noises = [_rand(shape, 10 + i) for i in range(4)]
    pmv = jax.jit(lambda p, x, t, c: j_diff.p_mean_variance(p, x, t, c, w))

    j_img, t_img = jnp.asarray(x_t), torch.tensor(x_t)
    for i in range(4):
        t_scalar = T - 1 - i
        mean, _, log_var = pmv(params, j_img, jnp.full((b,), t_scalar),
                               jnp.asarray(cond))
        j_img = mean + jnp.exp(0.5 * log_var) * noises[i]
        with torch.no_grad():
            t_img = t_diff.p_sample(t_img, torch.full((b,), t_scalar),
                                    torch.tensor(cond), w,
                                    torch.tensor(noises[i]))
        np.testing.assert_allclose(t_img.numpy(), np.asarray(j_img),
                                   **STEP_TOL, err_msg=f"step {i}")

    # the loop entry point runs the same chain from the same numbers
    out = t_diff.p_sample_loop(torch.tensor(cond), w, x_T=torch.tensor(x_t),
                               noise_fn=lambda i: torch.tensor(noises[i]),
                               num_steps=4)
    np.testing.assert_allclose(out.numpy(), (np.asarray(j_img) + 1) / 2,
                               **STEP_TOL)


@pytest.mark.parametrize("method", ["bisect", "sort"])
def test_threshold_matches_jax(method):
    x = _rand((2, 3, 16, 16, 3), 3, 2.0)
    j = JDiffusion(model=_ZeroModel(), dynamic_thres_method=method, **DIFF)
    t = GaussianDiffusion(None, dynamic_thres_method=method, **DIFF)
    np.testing.assert_allclose(t.threshold(torch.tensor(x)).numpy(),
                               np.asarray(j._maybe_threshold(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)


def test_cfg_rescale_matches_jax():
    """guided_eps with phi > 0, through models whose cond/null halves
    differ (the JAX side's model gets the same outputs)."""
    eps2 = _rand((4, FRAMES, IMG, IMG, 3), 4)

    class _J:
        def apply(self, params, x, t, cond, null_cond_mask=None,
                  cfg_tiled_pair=False):
            return jnp.asarray(eps2)

    j = JDiffusion(model=_J(), cfg_rescale=0.7, **DIFF)
    t = GaussianDiffusion(lambda *a, **k: torch.tensor(eps2),
                          cfg_rescale=0.7, **DIFF)
    x = _rand((2, FRAMES, IMG, IMG, 3), 5)
    cond = np.zeros((2, FRAMES), np.float32)
    tt = np.array([3, 3])
    want = j.guided_eps(None, jnp.asarray(x), jnp.asarray(tt),
                        jnp.asarray(cond), 5.0)
    got = t.guided_eps(torch.tensor(x), torch.tensor(tt), torch.tensor(cond),
                       5.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_shared_init_stage_equals_the_doubled_batch(pair):
    """cfg_shared_init runs the conditioning-free init stage once per CFG
    pair; the plain doubled-batch forward gives the same eps (float32:
    identical operations per sample, 1e-6)."""
    _, _, t_diff = pair
    plain = GaussianDiffusion(t_diff.model, cfg_shared_init=False, **DIFF)
    x = torch.tensor(_rand((2, FRAMES, IMG, IMG, 3), 6))
    t = torch.tensor([9, 9])
    cond = torch.tensor(_rand((2, FRAMES), 7))
    with torch.no_grad():
        shared = t_diff.guided_eps(x, t, cond, 5.0)
        doubled = plain.guided_eps(x, t, cond, 5.0)
    torch.testing.assert_close(shared, doubled, rtol=1e-6, atol=1e-6)
