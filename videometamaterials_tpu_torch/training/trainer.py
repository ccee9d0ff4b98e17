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
the fused plans.

Target evaluation (JAX trainer.py:456-570): `sample_videos` samples a
conditioning batch in chunks under CFG, `eval_target` samples every target
curve num_preds times and writes the artifacts under
runs/<name>/eval_target_w_<w>[_phi_<phi>]_<i>/step_<step>/. Folders of
GIFs, milestones and the training loop wait for the training slice.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator

import numpy as np
import torch

from videometamaterials_tpu_torch.config import ModelConfig, TrainerConfig
from videometamaterials_tpu_torch.data.loader import InfiniteBatchSampler
from videometamaterials_tpu_torch.data.normalization import (
    Normalization,
    interpolate_labels,
)
from videometamaterials_tpu_torch.diffusion.gaussian import GaussianDiffusion
from videometamaterials_tpu_torch.training.artifacts import save_preds
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


# ----------------------------------------------------------- target eval


def sampling_chunk(test_batch_size: int) -> int:
    """Videos a sampling call takes: half the test batch, as the JAX
    trainer (and the reference, vddp.py:1460) halves it on one device."""
    return max(test_batch_size // 2, 1)


def chunk_generator(seed: int, index: int, device) -> torch.Generator:
    """The random stream of sampling chunk `index` under `seed`."""
    state = np.random.SeedSequence([seed, index]).generate_state(2)
    return torch.Generator(device=device).manual_seed(
        int(state[0]) << 32 | int(state[1]))


def sample_videos(diffusion: GaussianDiffusion, cond: np.ndarray,
                  guidance_scale: float, *, chunk: int, seed: int = 0,
                  cfg_rescale: float | None = None) -> np.ndarray:
    """Guided DDPM samples (n, F, H, W, C) in [0, 1] of a conditioning batch
    (n, F): chunks of `chunk` curves (the last padded by repeating its last
    curve, the padding dropped), each from its own generator."""
    cond = np.asarray(cond, np.float32)
    n = len(cond)
    rem = (-n) % chunk
    if rem:
        cond = np.concatenate([cond, np.repeat(cond[-1:], rem, axis=0)])
    outs = []
    for i in range(0, len(cond), chunk):
        gen = chunk_generator(seed, i // chunk, diffusion.device)
        videos = diffusion.sample(torch.from_numpy(cond[i:i + chunk]),
                                  guidance_scale, generator=gen,
                                  cfg_rescale=cfg_rescale)
        outs.append(videos.float().cpu().numpy())
    return np.concatenate(outs)[:n]


def eval_target_dir(results_folder: str | Path, step: int,
                    guidance_scale: float, cfg_rescale: float) -> Path:
    """runs/<name>/eval_target_w_<w>[_phi_<phi>]_<i>/step_<step> with the
    first index i whose step directory does not exist yet (phi in the name
    only when it is not 0)."""
    mode = f"eval_target_w_{guidance_scale}"
    phi = float(f"{float(cfg_rescale):.6g}")
    if phi != 0.0:
        mode += f"_phi_{phi}"
    i = 0
    while (Path(results_folder) / f"{mode}_{i}" / f"step_{step}").exists():
        i += 1
    return Path(results_folder) / f"{mode}_{i}" / f"step_{step}"


def eval_target(diffusion: GaussianDiffusion, cfg: ModelConfig,
                results_folder: str | Path, step: int,
                target_labels: str | Path, labels_scaling: Normalization,
                zero_u_2: float | None, *, guidance_scale: float,
                num_preds: int, chunk: int, seed: int = 0,
                cfg_rescale: float | None = None):
    """Guided generation for the target curves of a CSV (one 51-point
    curve a row, or one value a frame): each curve num_preds times,
    artifacts (gifs/prediction_channel_<c>.gif, geometries.csv) written to
    a new eval_target directory. Returns (that directory, the videos, the
    sampling seconds), or None when the targets cannot be read."""
    phi = diffusion.cfg_rescale if cfg_rescale is None else cfg_rescale
    mode_dir = eval_target_dir(results_folder, step, guidance_scale, phi)
    (mode_dir / "gifs").mkdir(parents=True, exist_ok=True)
    try:
        targets = np.genfromtxt(target_labels, delimiter=",")
    except OSError:
        print("Could not load target labels.")
        return None
    if targets.ndim == 1:
        targets = targets[None, :]
    if cfg.per_frame_cond:
        if targets.shape[1] != cfg.num_frames:
            targets = interpolate_labels(targets, cfg.num_frames)
    else:
        targets = targets[:, 1:]
    cond = labels_scaling.normalize(targets.astype(np.float32)
                                    ).astype(np.float32)
    t0 = time.perf_counter()
    videos = sample_videos(diffusion, np.repeat(cond, num_preds, axis=0),
                           guidance_scale, chunk=chunk, seed=seed,
                           cfg_rescale=cfg_rescale)
    seconds = time.perf_counter() - t0
    save_preds(videos, mode_dir, list(cfg.selected_channels),
               num_samples=len(cond), reference_frame=cfg.reference_frame,
               num_frames=cfg.num_frames, zero_u_2=zero_u_2)
    return mode_dir, videos, seconds
