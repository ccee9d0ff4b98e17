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

The latency mode (`sample_spatial_sharding`, the JAX field of that name):
a plan of parallel/latency.py splits one video's DDPM or DDIM chain by
height or by frames across the ranks of a process group. Every rank
draws the whole start and step noise from the same generator and keeps
its part, so the draws are one process's; the dynamic threshold gathers
|x0| (the quantile of the whole video), the CFG-rescale std all-reduces
its sums, and the result is gathered whole on every rank. As in JAX it
runs the unfused plans only. A plan of one rank takes the unsplit code.
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
                 sample_spatial_sharding=None,
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
        # the latency mode's plan bound to the model; None for one rank
        self.latency = None
        if sample_spatial_sharding is not None:
            # the JAX guard reads the model's flags (gaussian.py:98-106)
            if any(bool(getattr(model, flag, False)) for flag in (
                    "use_fused_linear_block", "use_fused_temporal_block")):
                raise ValueError(
                    "sample_spatial_sharding runs the unfused plans "
                    "(temporal_xla and the plain linear attention): build "
                    "the model with use_fused_temporal_block=False and "
                    "use_fused_linear_block=False")
            bound = sample_spatial_sharding.bind(image_size, num_frames,
                                                 len(model.downs))
            self.latency = bound if bound.world > 1 else None

    @classmethod
    def from_config(cls, model, cfg, device,
                    sample_spatial_sharding=None) -> "GaussianDiffusion":
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
                   ddim_sampling_eta=cfg.ddim_sampling_eta,
                   sample_spatial_sharding=sample_spatial_sharding,
                   device=device)

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
                   cfg_rescale: Optional[float] = None, latency=None):
        """CFG noise prediction: the conditional and the null forward as
        one model call on a doubled batch; with cfg_shared_init the UNet
        runs its conditioning-free init stage once per latent. `latency`:
        the bound plan of a split chain (x is this rank's part)."""
        phi = self.cfg_rescale if cfg_rescale is None else cfg_rescale
        b = x.shape[0]
        kw = {} if latency is None else {"latency": latency}
        if guidance_scale == 1.0:
            return self.model(x, t, cond, null_cond_mask=torch.zeros(
                b, dtype=torch.bool, device=x.device), **kw)
        t2 = torch.cat([t, t])
        cond2 = torch.cat([cond, cond])
        mask2 = torch.cat([torch.zeros(b, dtype=torch.bool, device=x.device),
                           torch.ones(b, dtype=torch.bool, device=x.device)])
        if self.cfg_shared_init:
            eps2 = self.model(x, t2, cond2, null_cond_mask=mask2,
                              cfg_tiled_pair=True, **kw)
        else:
            eps2 = self.model(torch.cat([x, x]), t2, cond2,
                              null_cond_mask=mask2, **kw)
        eps_cond, eps_null = eps2.chunk(2)
        eps = eps_null + (eps_cond - eps_null) * guidance_scale
        if phi > 0.0:
            # CFG rescale (Lin et al. 2023, section 3.4): restore the
            # conditional prediction's per-sample std, blend by phi
            if latency is None:
                dims = tuple(range(1, eps.ndim))
                std_cond = eps_cond.float().std(dim=dims, keepdim=True,
                                                unbiased=False)
                std_cfg = eps.float().std(dim=dims, keepdim=True,
                                          unbiased=False)
            else:
                std_cond, std_cfg = _split_std(
                    torch.stack([eps_cond, eps]).float(), latency.levels[0])
            rescaled = eps * (std_cond / std_cfg.clamp_min(1e-8)).to(eps.dtype)
            eps = phi * rescaled + (1.0 - phi) * eps
        return eps

    def threshold(self, x_recon, latency=None):
        """Static clip to [-1, 1], or dynamic (Imagen) thresholding at the
        per-sample `dynamic_thres_percentile` quantile of |x0|: 'bisect'
        finds it with 12 rounds of counting, 'sort' is torch.quantile.
        Under a split chain's `latency` the quantile is the whole video's:
        x0 is gathered and the quantile taken as one process takes it."""
        if not self.use_dynamic_thres:
            return x_recon.clamp(-1.0, 1.0)
        whole = x_recon if latency is None else latency.gather(x_recon)
        flat = whole.reshape(whole.shape[0], -1).abs()
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
                        cfg_rescale: Optional[float] = None, latency=None):
        eps = self.guided_eps(x, t, cond, guidance_scale, cfg_rescale,
                              latency)
        x_recon = self.threshold(self.predict_start_from_noise(x, t, eps),
                                 latency)
        return self.q_posterior(x_recon, x, t)

    def p_sample(self, x, t, cond, guidance_scale: float, noise,
                 cfg_rescale: Optional[float] = None, latency=None):
        """One ancestral step with the given standard-normal noise."""
        mean, _, log_var = self.p_mean_variance(x, t, cond, guidance_scale,
                                                cfg_rescale, latency)
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
        split = self._split_kw()

        def step(img, t, noise):
            t = torch.full((img.shape[0],), t, dtype=torch.long,
                           device=self.device)
            return self.p_sample(img, t, cond, guidance_scale, noise,
                                 cfg_rescale, **split)

        return self._chain(cond, range(self.timesteps - 1, -1, -1), step,
                           generator, x_T, noise_fn, num_steps)

    def _split_kw(self) -> dict:
        """The step's `latency` argument of a split chain; none unsplit, so
        an unsplit step is called as before the latency mode."""
        return {} if self.latency is None else {"latency": self.latency}

    def _chain(self, cond, steps, step, generator, x_T, noise_fn, num_steps):
        """img <- step(img, s, noise) over the first num_steps of `steps`
        (all without it), from x_T or a drawn start; step i's noise is
        noise_fn(i) or drawn from `generator`. Returns videos in [0, 1].
        A split chain (self.latency) steps this rank's part of the whole
        start and noises and gathers the result."""
        shape = self.video_shape(cond.shape[0])
        lat = self.latency

        def draw():
            return torch.randn(shape, generator=generator,
                               device=self.device, dtype=torch.float32)

        def part(video):
            return video if lat is None else lat.local(video)

        img = part(draw() if x_T is None
                   else x_T.to(self.device, torch.float32))
        if num_steps is not None:
            steps = steps[:num_steps]
        for i, s in enumerate(steps):
            img = step(img, s, part(draw() if noise_fn is None
                                    else noise_fn(i)))
        if lat is not None:
            img = lat.gather(img)
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
                  noise, cfg_rescale: Optional[float] = None, latency=None):
        """One DDIM step from t to t_next (x0 at t_next < 0) with the given
        standard-normal noise; x0 is not thresholded."""
        b = x.shape[0]
        t_vec = torch.full((b,), t, dtype=torch.long, device=x.device)
        eps = self.guided_eps(x, t_vec, cond, guidance_scale,
                              cfg_rescale, latency).float()
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
        split = self._split_kw()

        def step(img, pair, noise):
            return self.ddim_step(img, *pair, cond, guidance_scale, noise,
                                  cfg_rescale, **split)

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
                 focus_present_mask=None, per_sample: bool = False):
        """Epsilon-prediction loss (l1 or l2) of x_start in [-1, 1] at
        timesteps t with the given noise, null-conditioning mask and
        focus-present mask (None: none): the batch mean, or per_sample=True
        the (b,) per-sample means."""
        x_noisy = self.q_sample(x_start, t, noise)
        eps_hat = self.model(x_noisy, t, cond, null_cond_mask=null_cond_mask,
                             focus_present_mask=focus_present_mask)
        diff = noise - eps_hat
        err = diff.abs() if self.loss_type == "l1" else diff.square()
        if per_sample:
            return err.reshape(err.shape[0], -1).mean(dim=-1)
        return err.mean()

    def loss(self, x, cond, *, null_cond_prob: float = 0.0,
             generator: Optional[torch.Generator] = None, t=None, noise=None,
             null_cond_mask=None, focus_present_mask=None,
             prob_focus_present: float = 0.0, per_sample: bool = False):
        """Training objective on [0, 1] videos: t ~ U[0, T), standard
        normal noise and a Bernoulli(null_cond_prob) null-conditioning mask,
        each drawn from `generator` unless given; then, when no
        focus_present_mask is given and prob_focus_present > 0, a
        Bernoulli(prob_focus_present) focus-present mask (JAX
        gaussian.py:506-508: drawn, so never None, whenever the
        probability is positive)."""
        b = x.shape[0]
        if tuple(x.shape[1:]) != self.video_shape(b)[1:]:
            raise ValueError(f"bad video shape {tuple(x.shape)}")
        draws = self.loss_draws(
            b, x.device, generator=generator, null_cond_prob=null_cond_prob,
            prob_focus_present=prob_focus_present, t=t, noise=noise,
            null_cond_mask=null_cond_mask,
            focus_present_mask=focus_present_mask)
        return self.p_losses(normalize_img(x.float()), cond=cond,
                             per_sample=per_sample, **draws)

    def loss_draws(self, b: int, device, *,
                   generator: Optional[torch.Generator] = None,
                   null_cond_prob: float = 0.0,
                   prob_focus_present: float = 0.0, t=None, noise=None,
                   null_cond_mask=None, focus_present_mask=None) -> dict:
        """The random inputs of `loss` for a batch of b videos: t, noise,
        null_cond_mask and focus_present_mask, each drawn from `generator`
        in this order unless given (the focus mask only when
        prob_focus_present > 0; None otherwise)."""
        if t is None:
            t = torch.randint(0, self.timesteps, (b,), generator=generator,
                              device=device)
        if noise is None:
            noise = torch.randn(self.video_shape(b), generator=generator,
                                device=device, dtype=torch.float32)
        if null_cond_mask is None:
            null_cond_mask = torch.rand(b, generator=generator,
                                        device=device) < null_cond_prob
        if focus_present_mask is None and prob_focus_present > 0:
            focus_present_mask = torch.rand(b, generator=generator,
                                            device=device) < prob_focus_present
        return dict(t=t, noise=noise, null_cond_mask=null_cond_mask,
                    focus_present_mask=focus_present_mask)


def _split_std(x32: torch.Tensor, shard) -> tuple[torch.Tensor, ...]:
    """The per-sample population std of each of the tensors stacked on
    x32's axis 0, (n, b, ...) split across the ranks: two all-reduces (the
    sums, then the squared deviations), over the whole element count."""
    dims = tuple(range(2, x32.ndim))
    count = shard.whole(x32[0, 0].numel())
    mean = shard.all_reduce(x32.sum(dim=dims, keepdim=True)) / count
    var = shard.all_reduce((x32 - mean).square().sum(dim=dims,
                                                     keepdim=True)) / count
    return tuple(var.sqrt())
