"""The train step and a trainer over a stream of batches.

Port of videometamaterials_tpu/training/trainer.py:_build_train_step
(:217-254): loss and gradient of the diffusion objective, optax adam (with
the optional global-norm clip), then the EMA of the parameters with the
pre-increment step: do = step % ema_update_every == 0,
reset = step < ema_start_step, e <- do ? (reset ? p : beta e + (1-beta) p) : e,
on the updated parameters.

The plan split of the JAX Trainer (:76-95): unless the model config sets
fused_blocks_in_training, the loss runs every attention block on its
unfused plan, on the same parameters (UNet3D.fused_plans); sampling keeps
the fused plans. Folders of GIFs, checkpoints and milestones wait for the
data and checkpoint slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch

from videometamaterials_tpu_torch.config import ModelConfig, TrainerConfig
from videometamaterials_tpu_torch.data.loader import InfiniteBatchSampler
from videometamaterials_tpu_torch.diffusion.gaussian import GaussianDiffusion
from videometamaterials_tpu_torch.training.optim import (
    clip_by_global_norm_,
    make_adam,
)


@dataclass
class TrainState:
    """step (the number of steps taken), the model (its parameters are the
    trained ones), the optimizer over them, and the EMA parameters in the
    order of model.named_parameters()."""

    step: int
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    ema: list[torch.Tensor]

    @classmethod
    def create(cls, model: torch.nn.Module, lr: float) -> "TrainState":
        params = list(model.parameters())
        return cls(step=0, model=model, optimizer=make_adam(params, lr),
                   ema=[p.detach().clone() for p in params])

    def ema_state_dict(self) -> dict[str, torch.Tensor]:
        return {name: e for (name, _), e in
                zip(self.model.named_parameters(), self.ema)}


@torch.no_grad()
def apply_gradients(state: TrainState, tcfg: TrainerConfig) -> None:
    """Clip (optax clip_by_global_norm, when max_grad_norm is set), take the
    Adam step, update the EMA with the pre-increment step, count the step.
    The gradients are the parameters' .grad."""
    params = list(state.model.parameters())
    if tcfg.max_grad_norm is not None:
        clip_by_global_norm_([p.grad for p in params], tcfg.max_grad_norm)
    state.optimizer.step()
    if state.step % tcfg.ema_update_every == 0:
        fresh = [p.detach() for p in params]
        if state.step < tcfg.ema_start_step:
            torch._foreach_copy_(state.ema, fresh)
        else:
            beta = tcfg.ema_decay
            torch._foreach_mul_(state.ema, beta)
            torch._foreach_add_(state.ema, fresh, alpha=1.0 - beta)
    state.step += 1


def train_step(state: TrainState, diffusion: GaussianDiffusion, videos,
               labels, tcfg: TrainerConfig, *, fused_in_training: bool,
               generator: torch.Generator | None = None, t=None, noise=None,
               null_cond_mask=None) -> torch.Tensor:
    """One step on a batch of [0, 1] videos (b, F, H, W, C) and labels
    (b, F). t, noise and the null-conditioning mask are drawn from
    `generator` unless given. Returns the loss (detached, on the device)."""
    state.optimizer.zero_grad(set_to_none=True)
    with state.model.fused_plans(fused_in_training):
        loss = diffusion.loss(videos, labels,
                              null_cond_prob=tcfg.null_cond_prob,
                              generator=generator, t=t, noise=noise,
                              null_cond_mask=null_cond_mask)
    loss.backward()
    apply_gradients(state, tcfg)
    return loss.detach()


def array_batches(videos: np.ndarray, labels: np.ndarray, batch_size: int,
                  seed: int = 0) -> Iterator[tuple[torch.Tensor, torch.Tensor]]:
    """Batches of in-memory videos (N, F, H, W, C) in [0, 1] and labels
    (N, F), drawn by InfiniteBatchSampler."""
    if len(videos) != len(labels):
        raise ValueError("videos and labels differ in length")
    videos = torch.as_tensor(videos, dtype=torch.float32)
    labels = torch.as_tensor(labels, dtype=torch.float32)
    for idx in InfiniteBatchSampler(len(videos), batch_size, seed=seed):
        idx = torch.as_tensor(idx)
        yield videos[idx], labels[idx]


class Trainer:
    """Trains `diffusion.model` on a stream of (videos, labels) batches,
    e.g. array_batches. t, noise and the null-conditioning mask come from
    `generator` (by default one seeded with trainer_cfg.seed)."""

    def __init__(self, diffusion: GaussianDiffusion, model_cfg: ModelConfig,
                 trainer_cfg: TrainerConfig,
                 batches: Iterator[tuple[torch.Tensor, torch.Tensor]],
                 generator: torch.Generator | None = None):
        self.diffusion = diffusion
        self.mcfg, self.tcfg = model_cfg, trainer_cfg
        self.device = diffusion.device
        self.batches = batches
        self.state = TrainState.create(diffusion.model,
                                       model_cfg.learning_rate)
        self.generator = generator or torch.Generator(
            device=self.device).manual_seed(trainer_cfg.seed)

    def step(self) -> torch.Tensor:
        """Draw the next batch and take one train step; returns the loss
        (detached, on the device)."""
        videos, labels = next(self.batches)
        return train_step(
            self.state, self.diffusion, videos.to(self.device),
            labels.to(self.device), self.tcfg,
            fused_in_training=self.mcfg.fused_blocks_in_training,
            generator=self.generator)
