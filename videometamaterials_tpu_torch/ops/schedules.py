"""Cosine noise schedule and its derived coefficient tables.

Port of videometamaterials_tpu/ops/schedules.py: every table is computed in
float64 with numpy and stored once as a float32 tensor.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


def cosine_beta_schedule(timesteps: int, s: float = 0.008) -> np.ndarray:
    """Nichol & Dhariwal cosine schedule, float64, betas clipped to
    [0, 0.9999]."""
    steps = timesteps + 1
    x = np.linspace(0, timesteps, steps, dtype=np.float64)
    alphas_cumprod = np.cos(((x / timesteps) + s) / (1 + s) * np.pi * 0.5) ** 2
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1.0 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    return np.clip(betas, 0.0, 0.9999)


@dataclass(frozen=True)
class DiffusionSchedule:
    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    log_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor

    @property
    def num_timesteps(self) -> int:
        return int(self.betas.shape[0])


def make_schedule(timesteps: int, device: torch.device | str,
                  s: float = 0.008) -> DiffusionSchedule:
    betas = cosine_beta_schedule(timesteps, s)
    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas, axis=0)
    alphas_cumprod_prev = np.concatenate([[1.0], alphas_cumprod[:-1]])
    posterior_variance = (betas * (1.0 - alphas_cumprod_prev)
                          / (1.0 - alphas_cumprod))

    def f32(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    return DiffusionSchedule(
        betas=f32(betas),
        alphas_cumprod=f32(alphas_cumprod),
        alphas_cumprod_prev=f32(alphas_cumprod_prev),
        sqrt_alphas_cumprod=f32(np.sqrt(alphas_cumprod)),
        sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - alphas_cumprod)),
        log_one_minus_alphas_cumprod=f32(np.log(1.0 - alphas_cumprod)),
        sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod)),
        sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod - 1.0)),
        posterior_variance=f32(posterior_variance),
        posterior_log_variance_clipped=f32(
            np.log(np.clip(posterior_variance, 1e-20, None))),
        posterior_mean_coef1=f32(betas * np.sqrt(alphas_cumprod_prev)
                                 / (1.0 - alphas_cumprod)),
        posterior_mean_coef2=f32((1.0 - alphas_cumprod_prev) * np.sqrt(alphas)
                                 / (1.0 - alphas_cumprod)),
    )


def extract(table: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Per-sample coefficients of timesteps `t` (b,), shaped to broadcast
    against a rank-`ndim` batch."""
    return table[t].reshape(t.shape[0], *((1,) * (ndim - 1)))
