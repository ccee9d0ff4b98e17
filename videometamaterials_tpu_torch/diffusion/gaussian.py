"""Gaussian diffusion: classifier-free guidance, dynamic thresholding, the
DDPM ancestral chain and the training loss.

Port of videometamaterials_tpu/diffusion/gaussian.py:132-364 and :491-539.
The chain is a plain Python loop over timesteps; randomness comes from an
explicit `torch.Generator`, or is injected (x_T and per-step noise; the
loss's t, noise and null-conditioning mask) so that a test can drive the
JAX functions with the same numbers. Videos are (B, F, H, W, C), [0, 1] at
the API and [-1, 1] inside. DDIM and latent interpolation wait for later
slices.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

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
                 loss_type: str = "l1", device: torch.device | str = "cpu"):
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
        self.device = torch.device(device)
        self.schedule = make_schedule(timesteps, self.device)

    @classmethod
    def from_config(cls, model, cfg, device) -> "GaussianDiffusion":
        if cfg.sampling_timesteps < cfg.train_timesteps:
            raise NotImplementedError("DDIM sampling is not ported yet "
                                      "(ROADMAP.md Queue 1 item 5)")
        return cls(model, image_size=cfg.image_size,
                   num_frames=cfg.num_frames, channels=cfg.channels,
                   timesteps=cfg.train_timesteps,
                   use_dynamic_thres=cfg.use_dynamic_thres,
                   dynamic_thres_percentile=cfg.dynamic_thres_percentile,
                   dynamic_thres_method=cfg.dynamic_thres_method,
                   cfg_rescale=cfg.cfg_rescale,
                   cfg_shared_init=cfg.cfg_shared_init,
                   loss_type=cfg.loss_type, device=device)

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
        shape = self.video_shape(cond.shape[0])

        def draw():
            return torch.randn(shape, generator=generator,
                               device=self.device, dtype=torch.float32)

        img = draw() if x_T is None else x_T.to(self.device, torch.float32)
        steps = range(self.timesteps - 1, -1, -1)
        if num_steps is not None:
            steps = steps[:num_steps]
        for i, t_scalar in enumerate(steps):
            t = torch.full((shape[0],), t_scalar, dtype=torch.long,
                           device=self.device)
            noise = draw() if noise_fn is None else noise_fn(i)
            img = self.p_sample(img, t, cond, guidance_scale, noise,
                                cfg_rescale)
        return unnormalize_img(img)

    def sample(self, cond, guidance_scale: float = 1.0, **kw):
        """Guided DDPM sampling of len(cond) videos in [0, 1]."""
        return self.p_sample_loop(cond.to(self.device, torch.float32),
                                  guidance_scale, **kw)

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
