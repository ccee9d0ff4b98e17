"""Gaussian diffusion: classifier-free guidance, dynamic thresholding, the
DDPM ancestral chain, the DDIM chain, latent interpolation and the
training loss.

Port of videometamaterials_tpu/diffusion/gaussian.py. The chains are plain
Python loops over timesteps; randomness comes from an explicit
`torch.Generator`, or is injected (x_T and per-step noise; the loss's t,
noise and null-conditioning mask; interpolate's two noises) so that a test
can drive the JAX functions with the same numbers. Videos are (B, F, H, W,
C), [0, 1] at the sampling API and [-1, 1] inside.

`sample` runs DDIM when sampling_timesteps is below the train timesteps
(vddp.py:909-911), as the JAX package does: its DDIM step takes the raw x0
of the guided eps (no thresholding), steps between the timesteps numpy's
float64 linspace gives, draws a noise every step (eta = 0 included) and
returns x0 at the last step.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from videometamaterials_tpu_torch.config import CURVE_POINTS
from videometamaterials_tpu_torch.ops.schedules import extract, make_schedule


def normalize_img(x):
    return x * 2.0 - 1.0


def unnormalize_img(x):
    return (x + 1.0) * 0.5


class GaussianDiffusion:
    def __init__(self, model, *, image_size: int, num_frames: int,
                 channels: int = 3, timesteps: int = 256,
                 use_dynamic_thres: bool = True,
                 dynamic_thres_percentile: float = 0.9,
                 dynamic_thres_method: str = "bisect",
                 cfg_rescale: float = 0.0, cfg_shared_init: bool = True,
                 loss_type: str = "l1",
                 sampling_timesteps: Optional[int] = None,
                 ddim_sampling_eta: float = 0.0,
                 device: torch.device | str = "cpu"):
        sampling_timesteps = sampling_timesteps or timesteps
        if not 0 < sampling_timesteps <= timesteps:
            raise ValueError(f"sampling_timesteps {sampling_timesteps} not "
                             f"in [1, {timesteps}]")
        if dynamic_thres_method not in ("bisect", "sort"):
            raise ValueError(f"unknown threshold method "
                             f"{dynamic_thres_method!r}")
        if loss_type not in ("l1", "l2"):
            raise ValueError(f"unknown loss_type {loss_type!r}")
        self.loss_type = loss_type
        self.model = model
        self.image_size = image_size
        self.num_frames = num_frames
        self.channels = channels
        self.timesteps = timesteps
        self.use_dynamic_thres = use_dynamic_thres
        self.dynamic_thres_percentile = dynamic_thres_percentile
        self.dynamic_thres_method = dynamic_thres_method
        self.cfg_rescale = cfg_rescale
        self.cfg_shared_init = cfg_shared_init
        self.sampling_timesteps = sampling_timesteps
        self.ddim_sampling_eta = ddim_sampling_eta
        self.device = torch.device(device)
        self.schedule = make_schedule(timesteps, self.device)
        # the float32 alphas_cumprod on the host, for the DDIM coefficients
        self._abar = self.schedule.alphas_cumprod.cpu().numpy()

    @classmethod
    def from_config(cls, model, cfg, device) -> "GaussianDiffusion":
        return cls(model, image_size=cfg.image_size,
                   num_frames=cfg.num_frames, channels=cfg.channels,
                   timesteps=cfg.train_timesteps,
                   use_dynamic_thres=cfg.use_dynamic_thres,
                   dynamic_thres_percentile=cfg.dynamic_thres_percentile,
                   dynamic_thres_method=cfg.dynamic_thres_method,
                   cfg_rescale=cfg.cfg_rescale,
                   cfg_shared_init=cfg.cfg_shared_init,
                   loss_type=cfg.loss_type,
                   sampling_timesteps=cfg.sampling_timesteps,
                   ddim_sampling_eta=cfg.ddim_sampling_eta, device=device)

    @property
    def is_ddim_sampling(self) -> bool:
        return self.sampling_timesteps < self.timesteps

    def video_shape(self, batch: int) -> tuple:
        return (batch, self.num_frames, self.image_size, self.image_size,
                self.channels)

    # ------------------------------------------------------------ q process
    def q_sample(self, x_start, t, noise):
        """Forward noising q(x_t | x_0)."""
        s = self.schedule
        nd = x_start.ndim
        return (extract(s.sqrt_alphas_cumprod, t, nd) * x_start
                + extract(s.sqrt_one_minus_alphas_cumprod, t, nd) * noise)

    def q_mean_variance(self, x_start, t):
        """Mean, variance and log variance of q(x_t | x_0)."""
        s = self.schedule
        nd = x_start.ndim
        return (extract(s.sqrt_alphas_cumprod, t, nd) * x_start,
                extract(1.0 - s.alphas_cumprod, t, nd),
                extract(s.log_one_minus_alphas_cumprod, t, nd))

    def predict_start_from_noise(self, x_t, t, noise):
        s = self.schedule
        return (extract(s.sqrt_recip_alphas_cumprod, t, x_t.ndim) * x_t
                - extract(s.sqrt_recipm1_alphas_cumprod, t, x_t.ndim) * noise)

    def q_posterior(self, x_start, x_t, t):
        s = self.schedule
        nd = x_t.ndim
        mean = (extract(s.posterior_mean_coef1, t, nd) * x_start
                + extract(s.posterior_mean_coef2, t, nd) * x_t)
        return (mean, extract(s.posterior_variance, t, nd),
                extract(s.posterior_log_variance_clipped, t, nd))

    # ---------------------------------------------------------------- model
    def guided_eps(self, x, t, cond, guidance_scale: float,
                   cfg_rescale: Optional[float] = None):
        """CFG noise prediction: the conditional and the null forward as
        one model call on a doubled batch; with cfg_shared_init the UNet
        runs its conditioning-free init stage once per latent."""
        phi = self.cfg_rescale if cfg_rescale is None else cfg_rescale
        b = x.shape[0]
        if guidance_scale == 1.0:
            return self.model(x, t, cond, null_cond_mask=torch.zeros(
                b, dtype=torch.bool, device=x.device))
        t2 = torch.cat([t, t])
        cond2 = torch.cat([cond, cond])
        mask2 = torch.cat([torch.zeros(b, dtype=torch.bool, device=x.device),
                           torch.ones(b, dtype=torch.bool, device=x.device)])
        if self.cfg_shared_init:
            eps2 = self.model(x, t2, cond2, null_cond_mask=mask2,
                              cfg_tiled_pair=True)
        else:
            eps2 = self.model(torch.cat([x, x]), t2, cond2,
                              null_cond_mask=mask2)
        eps_cond, eps_null = eps2.chunk(2)
        eps = eps_null + (eps_cond - eps_null) * guidance_scale
        if phi > 0.0:
            # CFG rescale (Lin et al. 2023, section 3.4): restore the
            # conditional prediction's per-sample std, blend by phi
            dims = tuple(range(1, eps.ndim))
            std_cond = eps_cond.float().std(dim=dims, keepdim=True,
                                            unbiased=False)
            std_cfg = eps.float().std(dim=dims, keepdim=True, unbiased=False)
            rescaled = eps * (std_cond / std_cfg.clamp_min(1e-8)).to(eps.dtype)
            eps = phi * rescaled + (1.0 - phi) * eps
        return eps

    def threshold(self, x_recon):
        """Static clip to [-1, 1], or dynamic (Imagen) thresholding at the
        per-sample `dynamic_thres_percentile` quantile of |x0|: 'bisect'
        finds it with 12 rounds of counting, 'sort' is torch.quantile."""
        if not self.use_dynamic_thres:
            return x_recon.clamp(-1.0, 1.0)
        flat = x_recon.reshape(x_recon.shape[0], -1).abs()
        q = self.dynamic_thres_percentile
        if self.dynamic_thres_method == "sort":
            s = torch.quantile(flat, q, dim=-1)
        else:
            n = flat.shape[-1]
            lo = torch.zeros(flat.shape[0], dtype=torch.float32,
                             device=flat.device)
            hi = flat.amax(dim=-1)
            for _ in range(12):
                mid = 0.5 * (lo + hi)
                frac_below = (flat <= mid[:, None]).float().sum(dim=-1) / n
                take_hi = frac_below < q
                lo = torch.where(take_hi, mid, lo)
                hi = torch.where(take_hi, hi, mid)
            s = 0.5 * (lo + hi)
        s = s.clamp_min(1.0).reshape(-1, *((1,) * (x_recon.ndim - 1)))
        return torch.maximum(torch.minimum(x_recon, s), -s) / s

    def p_mean_variance(self, x, t, cond, guidance_scale: float,
                        cfg_rescale: Optional[float] = None):
        eps = self.guided_eps(x, t, cond, guidance_scale, cfg_rescale)
        x_recon = self.threshold(self.predict_start_from_noise(x, t, eps))
        return self.q_posterior(x_recon, x, t)

    def p_sample(self, x, t, cond, guidance_scale: float, noise,
                 cfg_rescale: Optional[float] = None):
        """One ancestral step with the given standard-normal noise."""
        mean, _, log_var = self.p_mean_variance(x, t, cond, guidance_scale,
                                                cfg_rescale)
        nonzero = (t > 0).to(x.dtype).reshape(-1, *((1,) * (x.ndim - 1)))
        return mean + nonzero * torch.exp(0.5 * log_var) * noise

    # -------------------------------------------------------------- sampler
    @torch.no_grad()
    def p_sample_loop(self, cond, guidance_scale: float, *,
                      generator: Optional[torch.Generator] = None,
                      x_T: Optional[torch.Tensor] = None,
                      noise_fn: Optional[Callable[[int], torch.Tensor]] = None,
                      num_steps: Optional[int] = None,
                      cfg_rescale: Optional[float] = None):
        """The DDPM chain from t = T-1 down. Starting noise is x_T, or
        drawn from `generator`; step i's noise is noise_fn(i), or drawn.
        num_steps runs only the first steps of the same chain (a partial
        chain for time-bounded checks). Returns videos in [0, 1]."""
        def step(img, t, noise):
            t = torch.full((img.shape[0],), t, dtype=torch.long,
                           device=self.device)
            return self.p_sample(img, t, cond, guidance_scale, noise,
                                 cfg_rescale)

        return self._chain(cond, range(self.timesteps - 1, -1, -1), step,
                           generator, x_T, noise_fn, num_steps)

    def _chain(self, cond, steps, step, generator, x_T, noise_fn, num_steps):
        """img <- step(img, s, noise) over the first num_steps of `steps`
        (all without it), from x_T or a drawn start; step i's noise is
        noise_fn(i) or drawn from `generator`. Returns videos in [0, 1]."""
        shape = self.video_shape(cond.shape[0])

        def draw():
            return torch.randn(shape, generator=generator,
                               device=self.device, dtype=torch.float32)

        img = draw() if x_T is None else x_T.to(self.device, torch.float32)
        if num_steps is not None:
            steps = steps[:num_steps]
        for i, s in enumerate(steps):
            img = step(img, s, draw() if noise_fn is None else noise_fn(i))
        return unnormalize_img(img)

    def ddim_pairs(self) -> list[tuple[int, int]]:
        """The DDIM chain's (t, t_next) pairs: sampling_timesteps + 1 times
        from numpy's float64 linspace over [-1, T - 1], truncated toward
        zero, reversed; the last pair's t_next is -1."""
        times = np.linspace(-1, self.timesteps - 1,
                            num=self.sampling_timesteps + 1).astype(np.int64)
        times = list(reversed(times.tolist()))
        return list(zip(times[:-1], times[1:]))

    def ddim_coeffs(self, t: int, t_next: int) -> tuple[float, float, float]:
        """(sqrt(alpha_next), c, sigma) of one DDIM step, in float32 as the
        JAX step computes them (alpha_next = 1 past the end)."""
        alpha = self._abar[t]
        alpha_next = self._abar[t_next] if t_next >= 0 else np.float32(1.0)
        one = np.float32(1.0)
        sigma = np.float32(self.ddim_sampling_eta) * np.sqrt(
            (one - alpha / alpha_next) * (one - alpha_next) / (one - alpha))
        c = np.sqrt(np.maximum(one - alpha_next - sigma * sigma,
                               np.float32(0.0)))
        return float(np.sqrt(alpha_next)), float(c), float(sigma)

    def ddim_step(self, x, t: int, t_next: int, cond, guidance_scale: float,
                  noise, cfg_rescale: Optional[float] = None):
        """One DDIM step from t to t_next (x0 at t_next < 0) with the given
        standard-normal noise; x0 is not thresholded."""
        b = x.shape[0]
        t_vec = torch.full((b,), t, dtype=torch.long, device=x.device)
        eps = self.guided_eps(x, t_vec, cond, guidance_scale,
                              cfg_rescale).float()
        x_start = self.predict_start_from_noise(x, t_vec, eps)
        if t_next < 0:
            return x_start
        sqrt_next, c, sigma = self.ddim_coeffs(t, t_next)
        return x_start * sqrt_next + c * eps + sigma * noise

    @torch.no_grad()
    def ddim_sample(self, cond, guidance_scale: float, *,
                    generator: Optional[torch.Generator] = None,
                    x_T: Optional[torch.Tensor] = None,
                    noise_fn: Optional[Callable[[int], torch.Tensor]] = None,
                    num_steps: Optional[int] = None,
                    cfg_rescale: Optional[float] = None):
        """The DDIM chain over ddim_pairs(), with the hooks of
        p_sample_loop (x_T, noise_fn(i) of step i, num_steps). Returns
        videos in [0, 1]."""
        def step(img, pair, noise):
            return self.ddim_step(img, *pair, cond, guidance_scale, noise,
                                  cfg_rescale)

        return self._chain(cond, self.ddim_pairs(), step, generator, x_T,
                           noise_fn, num_steps)

    def sample(self, cond, guidance_scale: float = 1.0, **kw):
        """Guided sampling of len(cond) videos in [0, 1]: DDIM when
        sampling_timesteps is below the train timesteps, else DDPM."""
        fn = self.ddim_sample if self.is_ddim_sampling else self.p_sample_loop
        return fn(cond.to(self.device, torch.float32), guidance_scale, **kw)

    @torch.no_grad()
    def interpolate(self, x1, x2, t: Optional[int] = None, lam: float = 0.5,
                    guidance_scale: float = 1.0, cond=None, *,
                    generator: Optional[torch.Generator] = None,
                    noise1=None, noise2=None,
                    noise_fn: Optional[Callable[[int], torch.Tensor]] = None):
        """Latent interpolation (vddp.py:1020-1034): x1 and x2 (in the
        model's [-1, 1] space) noised to step t (default T - 1) with noise1
        and noise2, mixed as (1 - lam) x1_t + lam x2_t, then t ancestral
        steps from t - 1 down (step i's noise noise_fn(i)); the noises are
        drawn from `generator` unless given. cond defaults to zeros of the
        model's conditioning width: (b, F) as in the JAX package, or the
        curve tail's (b, 50) for a whole-curve model. Returns the result in
        [-1, 1]."""
        t = self.timesteps - 1 if t is None else t
        b = x1.shape[0]
        x1 = x1.to(self.device, torch.float32)
        x2 = x2.to(self.device, torch.float32)

        def draw():
            return torch.randn(x1.shape, generator=generator,
                               device=self.device, dtype=torch.float32)

        t_b = torch.full((b,), t, dtype=torch.long, device=self.device)
        xt1 = self.q_sample(x1, t_b, draw() if noise1 is None else noise1)
        xt2 = self.q_sample(x2, t_b, draw() if noise2 is None else noise2)
        img = (1 - lam) * xt1 + lam * xt2
        if cond is None:
            width = (self.num_frames if getattr(self.model, "per_frame_cond",
                                                True)
                     else CURVE_POINTS - 1)
            cond = torch.zeros((b, width), device=self.device)
        cond = cond.to(self.device, torch.float32)
        for i, t_scalar in enumerate(range(t - 1, -1, -1)):
            t_vec = torch.full((b,), t_scalar, dtype=torch.long,
                               device=self.device)
            noise = draw() if noise_fn is None else noise_fn(i)
            img = self.p_sample(img, t_vec, cond, guidance_scale, noise)
        return img

    # ----------------------------------------------------------------- loss
    def p_losses(self, x_start, t, cond, noise, null_cond_mask,
                 per_sample: bool = False):
        """Epsilon-prediction loss (l1 or l2) of x_start in [-1, 1] at
        timesteps t with the given noise and null-conditioning mask: the
        batch mean, or per_sample=True the (b,) per-sample means."""
        x_noisy = self.q_sample(x_start, t, noise)
        eps_hat = self.model(x_noisy, t, cond, null_cond_mask=null_cond_mask)
        diff = noise - eps_hat
        err = diff.abs() if self.loss_type == "l1" else diff.square()
        if per_sample:
            return err.reshape(err.shape[0], -1).mean(dim=-1)
        return err.mean()

    def loss(self, x, cond, *, null_cond_prob: float = 0.0,
             generator: Optional[torch.Generator] = None, t=None, noise=None,
             null_cond_mask=None, per_sample: bool = False):
        """Training objective on [0, 1] videos: t ~ U[0, T), standard
        normal noise and a Bernoulli(null_cond_prob) null-conditioning mask,
        each drawn from `generator` unless given."""
        b = x.shape[0]
        if tuple(x.shape[1:]) != self.video_shape(b)[1:]:
            raise ValueError(f"bad video shape {tuple(x.shape)}")
        dev = x.device
        if t is None:
            t = torch.randint(0, self.timesteps, (b,), generator=generator,
                              device=dev)
        if noise is None:
            noise = torch.randn(x.shape, generator=generator, device=dev,
                                dtype=torch.float32)
        if null_cond_mask is None:
            null_cond_mask = torch.rand(b, generator=generator,
                                        device=dev) < null_cond_prob
        return self.p_losses(normalize_img(x.float()), t, cond, noise,
                             null_cond_mask, per_sample=per_sample)
