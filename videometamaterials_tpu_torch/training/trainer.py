"""The train step, the trainer on a GIF folder, and target evaluation.

Port of videometamaterials_tpu/training/trainer.py. The train step
(:217-254): loss and gradient of the diffusion objective, optax adam (with
the optional global-norm clip), then the EMA of the parameters with the
pre-increment step: do = step % ema_update_every == 0,
reset = step < ema_start_step, e <- do ? (reset ? p : beta e + (1-beta) p) : e,
on the updated parameters. With gradient_accumulate_every = k > 1 the
chain is wrapped in optax.MultiSteps (`optim.MultiSteps`): a step is a
micro-step, the parameters move on every k-th, and the step count, the
EMA rule and the milestones count micro-steps, as in the JAX Trainer
(:145-152), so the EMA lerps on micro-steps whose parameters did not
move. prob_focus_present draws a focus-present mask in the loss of the
train step and of the validation loss (:194, :229).

The plan split of the JAX Trainer (:76-95): unless the model config sets
fused_blocks_in_training, the loss runs every attention block on its
unfused plan, on the same parameters (UNet3D.fused_plans); sampling keeps
the fused plans.

`StepTrainer` trains on a stream of batches (the benchmark workload of
train.py). `Trainer` (:59-216, :278-455, :573-640) trains on a data
folder: the training and validation `VideoDataset`s, batches prefetched
by a producer thread, milestones every save_and_sample_every steps (the
checkpoint first, then the validation loss, the fidelity probe and
samples of validation curves), one final save, resume from a checkpoint,
metrics.jsonl with the JAX keys. Each step's t, noise and null mask come
from a generator seeded by (seed, step), as the JAX step folds the step
into its key, and a resumed run continues the batch and flip streams
where the checkpoint left them: it takes the steps the unbroken run takes.
Milestones sample from a bf16 copy of the EMA weights; the trained
parameters stay float32.

Target evaluation (JAX trainer.py:456-570): `sample_videos` samples a
conditioning batch in chunks under CFG (DDPM or DDIM, as the sampler's
config says; milestones and the probe too), `eval_target` samples every
target curve num_preds times and writes the artifacts under
runs/<name>/eval_target_w_<w>[_phi_<phi>]_<i>/step_<step>/.
`Trainer.load_torch_checkpoint` imports a reference checkpoint.pt.

Data parallelism (JAX :127-137, :380-397, :553-581), under a process
group of W ranks (`parallel.initialize_distributed`), one device each:
the global batch is batch_size x W and each rank trains on its own stripe
of every epoch (batch_size rows); a step's draws are taken at the global
batch's shape and sliced, and the gradients averaged over the ranks
before the clip, Adam and the EMA, so the ranks take the steps one
process takes on the global batch and hold the same state. The
validation batches and the sampling chunks are padded to a multiple of W
and split, their draws taken at the padded shape, and the rows gathered:
every rank returns the same loss and videos. Rank 0 alone writes
metrics.jsonl, checkpoints and artifacts. Without a process group none of
this runs and no collective is called.

`profile_dir` (JAX :103-104, :305-325): a torch.profiler trace of steps
start+10 to start+13 (CPU activity, and the card's), written as
profile_dir/trace_rank<r>.json (chrome trace format).
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, Optional

import numpy as np
import torch

from videometamaterials_tpu_torch import parallel
from videometamaterials_tpu_torch.config import ModelConfig, TrainerConfig
from videometamaterials_tpu_torch.data.dataset import VideoDataset
from videometamaterials_tpu_torch.data.loader import (
    InfiniteBatchSampler,
    prefetch_batches,
)
from videometamaterials_tpu_torch.data.normalization import (
    Normalization,
    interpolate_labels,
)
from videometamaterials_tpu_torch.diffusion.gaussian import GaussianDiffusion
from videometamaterials_tpu_torch.sample import build_sampler
from videometamaterials_tpu_torch.training import checkpoint as ckpt
from videometamaterials_tpu_torch.training.artifacts import save_preds
from videometamaterials_tpu_torch.training.fidelity import score_gifs_dir
from videometamaterials_tpu_torch.training.optim import (
    MultiSteps,
    clip_by_global_norm_,
    make_adam,
)
from videometamaterials_tpu_torch.training.torch_import import (
    load_reference_weights,
)

# streams of seeded_generator besides the eval's sampling chunks
_TRAIN_STEP, _VALIDATION, _MILESTONE_SAMPLES, _PROBE_SAMPLES = 1, 2, 3, 4


def seeded_generator(device, *key: int) -> torch.Generator:
    """A generator on `device` whose stream is fixed by the integers of
    `key` (numpy's SeedSequence of them)."""
    state = np.random.SeedSequence([int(k) for k in key]).generate_state(2)
    return torch.Generator(device=device).manual_seed(
        int(state[0]) << 32 | int(state[1]))


@dataclass
class TrainState:
    """step (the number of (micro-)steps taken), the model (its parameters
    are the trained ones), the optimizer over them, the EMA parameters in
    the order of model.named_parameters(), and the gradient accumulation
    (None without it)."""

    step: int
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    ema: list[torch.Tensor]
    accum: Optional[MultiSteps] = None

    @classmethod
    def create(cls, model: torch.nn.Module, lr: float,
               accumulate_every: int = 1) -> "TrainState":
        params = list(model.parameters())
        accum = (MultiSteps(params, accumulate_every)
                 if accumulate_every > 1 else None)
        return cls(step=0, model=model, optimizer=make_adam(params, lr),
                   ema=[p.detach().clone() for p in params], accum=accum)

    def ema_state_dict(self) -> dict[str, torch.Tensor]:
        return {name: e for (name, _), e in
                zip(self.model.named_parameters(), self.ema)}


@torch.no_grad()
def apply_gradients(state: TrainState, tcfg: TrainerConfig) -> bool:
    """Clip (optax clip_by_global_norm, when max_grad_norm is set), take the
    Adam step, update the EMA with the pre-increment step, count the step.
    The gradients are the parameters' .grad. Under gradient accumulation
    they join the running mean, and clip and Adam run on the mean on every
    k-th micro-step only. Returns whether the parameters were updated."""
    params = list(state.model.parameters())
    emit = True
    if state.accum is not None:
        emit = state.accum.accumulate([p.grad for p in params])
        if emit:
            for p, acc in zip(params, state.accum.acc_grads):
                if p.grad is None:
                    p.grad = acc.clone()
                else:
                    p.grad.copy_(acc)
    if emit:
        if tcfg.max_grad_norm is not None:
            clip_by_global_norm_([p.grad for p in params],
                                 tcfg.max_grad_norm)
        state.optimizer.step()
    if state.accum is not None:
        state.accum.advance(emit)
    if state.step % tcfg.ema_update_every == 0:
        fresh = [p.detach() for p in params]
        if state.step < tcfg.ema_start_step:
            torch._foreach_copy_(state.ema, fresh)
        else:
            beta = tcfg.ema_decay
            torch._foreach_mul_(state.ema, beta)
            torch._foreach_add_(state.ema, fresh, alpha=1.0 - beta)
    state.step += 1
    return emit


def train_step(state: TrainState, diffusion: GaussianDiffusion, videos,
               labels, tcfg: TrainerConfig, *, fused_in_training: bool,
               generator: torch.Generator | None = None, t=None, noise=None,
               null_cond_mask=None, focus_present_mask=None) -> torch.Tensor:
    """One (micro-)step on a batch of [0, 1] videos (b, F, H, W, C) and
    labels (b, F). t, noise, the null-conditioning mask and, with
    prob_focus_present > 0, the focus-present mask are drawn from
    `generator` unless given. Returns the loss (detached, on the device).

    Under a process group of W ranks the batch is this rank's rows
    r*b .. (r+1)*b - 1 of a global batch of W*b: the draws are taken (or
    given) at the global shape and sliced to those rows, the gradients
    are averaged over the ranks before the optimizer, and the loss
    returned is the global batch's."""
    state.optimizer.zero_grad(set_to_none=True)
    draws = dict(t=t, noise=noise, null_cond_mask=null_cond_mask,
                 focus_present_mask=focus_present_mask)
    if parallel.active():
        b, r = videos.shape[0], parallel.rank()
        draws = diffusion.loss_draws(
            b * parallel.world_size(), videos.device, generator=generator,
            null_cond_prob=tcfg.null_cond_prob,
            prob_focus_present=tcfg.prob_focus_present, **draws)
        draws = {k: None if v is None else v[r * b:(r + 1) * b]
                 for k, v in draws.items()}
    with state.model.fused_plans(fused_in_training):
        loss = diffusion.loss(videos, labels,
                              null_cond_prob=tcfg.null_cond_prob,
                              generator=generator,
                              prob_focus_present=tcfg.prob_focus_present,
                              **draws)
    loss.backward()
    (loss,) = parallel.all_reduce_mean_(state.model.parameters(),
                                        loss.detach())
    apply_gradients(state, tcfg)
    return loss


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


class StepTrainer:
    """Trains `diffusion.model` on a stream of (videos, labels) batches,
    e.g. array_batches. t, noise and the null-conditioning mask come from
    `generator`, or (by default) from a generator seeded by
    (trainer_cfg.seed, the step)."""

    def __init__(self, diffusion: GaussianDiffusion, model_cfg: ModelConfig,
                 trainer_cfg: TrainerConfig,
                 batches: Iterator[tuple[torch.Tensor, torch.Tensor]] | None,
                 generator: torch.Generator | None = None):
        self.diffusion = diffusion
        self.mcfg, self.tcfg = model_cfg, trainer_cfg
        self.device = diffusion.device
        self.batches = batches
        self.state = TrainState.create(
            diffusion.model, model_cfg.learning_rate,
            trainer_cfg.gradient_accumulate_every)
        self.generator = generator

    def step(self) -> torch.Tensor:
        """Draw the next batch and take one train step; returns the loss
        (detached, on the device)."""
        videos, labels = next(self.batches)
        gen = self.generator or seeded_generator(
            self.device, self.tcfg.seed, _TRAIN_STEP, self.state.step)
        return train_step(
            self.state, self.diffusion,
            videos.to(self.device, non_blocking=True),
            labels.to(self.device, non_blocking=True), self.tcfg,
            fused_in_training=self.mcfg.fused_blocks_in_training,
            generator=gen)


class Trainer(StepTrainer):
    """Trains on the GIF folder `folder` (validation on
    `validation_folder`, which takes the training folder's labels_scaling)
    and writes checkpoints, milestone artifacts and metrics.jsonl under
    `results_folder`. `timings` collects the seconds of each save and of
    each milestone's parts. Under a process group each rank holds one
    (and the same) trainer; see the module docstring. With `profile_dir`
    steps start+10 to start+13 of `train` are traced."""

    def __init__(self, diffusion: GaussianDiffusion, model_cfg: ModelConfig,
                 trainer_cfg: TrainerConfig, folder: str | Path,
                 validation_folder: str | Path,
                 results_folder: str | Path = "./results",
                 profile_dir: str | Path | None = None):
        super().__init__(diffusion, model_cfg, trainer_cfg, batches=None)
        self.results_folder = Path(results_folder)
        self.results_folder.mkdir(parents=True, exist_ok=True)
        self.profile_dir = Path(profile_dir) if profile_dir else None
        self.world, self.rank = parallel.world_size(), parallel.rank()
        self.selected_channels = list(model_cfg.selected_channels)
        data = dict(selected_channels=self.selected_channels,
                    num_frames=model_cfg.num_frames,
                    per_frame_cond=model_cfg.per_frame_cond,
                    reference_frame=model_cfg.reference_frame)
        # rank 0 builds the folders' caches, the other ranks read them
        with parallel.rank0_first():
            self.ds = VideoDataset(
                folder, model_cfg.image_size,
                horizontal_flip=trainer_cfg.horizontal_flip, **data)
            self.ds_test = VideoDataset(
                validation_folder, model_cfg.image_size,
                labels_scaling=self.ds.labels_scaling, **data)
        print(f"found {len(self.ds)} videos as gif files in {folder}")
        # each rank a stripe of every epoch, batch_size rows a step: a
        # global batch of batch_size x the ranks
        self.sampler = InfiniteBatchSampler(
            len(self.ds), model_cfg.batch_size, seed=trainer_cfg.seed,
            process_index=self.rank, process_count=self.world)
        self.test_batch = sampling_chunk(trainer_cfg.test_batch_size) \
            * self.world
        self._metrics_path = self.results_folder / "metrics.jsonl"
        self.timings: list[dict] = []

    def _log(self, record: dict) -> None:
        if self.rank != 0:              # one metrics stream
            return
        with open(self._metrics_path, "a") as f:
            f.write(json.dumps(record) + "\n")

    def _start_profile(self):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
        return prof

    def _stop_profile(self, prof) -> Path:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        self.profile_dir.mkdir(parents=True, exist_ok=True)
        path = self.profile_dir / f"trace_rank{self.rank}.json"
        prof.export_chrome_trace(str(path))
        print(f"profile written to {path}")
        return path

    # ------------------------------------------------------------- train
    def train(self, load_model_step: Optional[int] = None,
              num_samples: Optional[int] = None,
              num_preds: Optional[int] = None) -> None:
        """Steps from the start (or load_model_step, resumed) to
        train_num_steps; a milestone every save_and_sample_every steps
        saves, then evaluates; the final step is saved once."""
        tcfg = self.tcfg
        num_samples = tcfg.num_samples if num_samples is None else num_samples
        num_preds = tcfg.num_preds if num_preds is None else num_preds
        start = 0
        if load_model_step is not None:
            self.load(load_model_step)
            start = load_model_step
            if start >= tcfg.train_num_steps:
                print("training completed")
                return
        self.ds.skip_flips(start * self.mcfg.batch_size)
        self.batches = prefetch_batches(self.ds, self.sampler, start=start,
                                        pin=self.device.type == "cuda")
        t_start = time.time()
        pending = None
        step = start
        prof = None
        try:
            while step < tcfg.train_num_steps:
                if self.profile_dir and step == start + 10:
                    prof = self._start_profile()
                loss = self.step()
                # the previous step's loss, read while this one runs
                if pending is not None:
                    self._log({"step": pending[0],
                               "training loss": float(pending[1])})
                pending = (step, loss)
                step += 1
                if prof is not None and step >= start + 13:
                    self._stop_profile(prof)
                    prof = None
                if step % tcfg.save_and_sample_every == 0:
                    elapsed = time.strftime(
                        "%H:%M:%S", time.gmtime(time.time() - t_start))
                    print(f"current step: {step}, total time elapsed: "
                          f"{elapsed}")
                    t0 = time.time()
                    # the checkpoint first: a kill during the evaluation
                    # keeps the weights
                    self.save(step)
                    self.eval_network(num_samples=num_samples,
                                      num_preds=num_preds)
                    print("time elapsed for validation: " + time.strftime(
                        "%H:%M:%S", time.gmtime(time.time() - t0)))
        finally:
            self.batches.close()
            if prof is not None:
                self._stop_profile(prof)
        if pending is not None:
            self._log({"step": pending[0],
                       "training loss": float(pending[1])})
        if tcfg.train_num_steps % tcfg.save_and_sample_every:
            self.save(tcfg.train_num_steps)
        print("training completed")

    # -------------------------------------------------------- validation
    def eval_network(self, guidance_scale: Optional[float] = None,
                     num_samples: int = 1, num_preds: int = 1) -> float:
        """The milestone: the validation loss, the fidelity probe (with
        fidelity_probe_targets), and num_preds samples of each of
        num_samples validation curves written to training/step_<N>/."""
        w = self.tcfg.guidance_scale if guidance_scale is None \
            else guidance_scale
        step = self.state.step
        mode_dir = self.results_folder / "training" / f"step_{step}"
        if self.rank == 0:
            (mode_dir / "gifs").mkdir(parents=True, exist_ok=True)
        times = {"step": step}
        t0 = time.perf_counter()
        val_loss = self.validation_loss()
        times["validation_loss"] = time.perf_counter() - t0
        self._log({"step": step, "validation loss": val_loss})
        if self.tcfg.fidelity_probe_targets:
            t0 = time.perf_counter()
            self.fidelity_probe()
            times["fidelity_probe"] = time.perf_counter() - t0
        n_val = len(self.ds_test)
        if num_samples > 0:
            t0 = time.perf_counter()
            rng = np.random.default_rng(self.tcfg.seed + step)
            pick = rng.choice(n_val, size=min(num_samples, n_val),
                              replace=False)
            videos = self.sample_videos(
                np.repeat(self.ds_test.labels[pick], num_preds, axis=0), w,
                stream=_MILESTONE_SAMPLES)
            if self.rank == 0:          # artifacts written once
                save_preds(videos, mode_dir, self.selected_channels,
                           num_samples=len(pick),
                           reference_frame=self.mcfg.reference_frame,
                           num_frames=self.mcfg.num_frames,
                           zero_u_2=self.ds.zero_u_2)
            times["sampling"] = time.perf_counter() - t0
        self.timings.append(times)
        return val_loss

    @torch.no_grad()
    def validation_loss(self, draws=None) -> float:
        """The mean per-sample loss over the validation folder on the
        trained parameters and the train plan, in batches of the sampling
        chunk. Batch i's t, noise and null mask come from a generator
        seeded by (seed, i), or from draws[i] (a dict of loss keywords).
        Under a process group a batch is padded to a multiple of the ranks
        and split, its draws taken at the padded shape and sliced, and the
        per-sample losses gathered with the padding left out: every rank
        returns the same value."""
        n_val = len(self.ds_test)
        bs = min(self.test_batch, n_val)
        total, count = 0.0, 0
        model = self.state.model
        with model.fused_plans(self.mcfg.fused_blocks_in_training):
            for i, lo in enumerate(range(0, n_val, max(bs, 1))):
                v, c = self.ds_test.get_batch(np.arange(lo, min(lo + bs,
                                                                n_val)))
                kw = draws[i] if draws is not None else {
                    "generator": seeded_generator(
                        self.device, self.tcfg.seed, _VALIDATION, i)}
                n = len(v)
                if parallel.active():
                    v, c, kw = self._local_batch(v, c, kw)
                per_sample = self.diffusion.loss(
                    torch.from_numpy(v).to(self.device),
                    torch.from_numpy(c).to(self.device),
                    null_cond_prob=self.tcfg.null_cond_prob,
                    prob_focus_present=self.tcfg.prob_focus_present,
                    per_sample=True, **kw)
                per_sample = parallel.gather_rows(per_sample)[:n]
                total += float(per_sample.sum())
                count += n
        return total / count if count else float("nan")

    def _local_batch(self, v, c, kw):
        """This rank's rows of a validation batch padded to a multiple of
        the ranks, and of its loss draws taken at the padded shape."""
        v, _ = parallel.local_rows(v, self.world, self.rank)
        c, _ = parallel.local_rows(c, self.world, self.rank)
        per, lo = len(v), self.rank * len(v)
        kw = dict(kw)
        gen = kw.pop("generator", None)
        full = self.diffusion.loss_draws(
            per * self.world, self.device, generator=gen,
            null_cond_prob=self.tcfg.null_cond_prob,
            prob_focus_present=self.tcfg.prob_focus_present, **kw)
        return v, c, {k: None if d is None else d[lo:lo + per]
                      for k, d in full.items()}

    def fidelity_probe(self) -> Optional[float]:
        """Guided samples of the first fidelity_probe_n_targets curves of
        fidelity_probe_targets, fidelity_probe_preds each, written to
        training/step_<N>/fidelity_probe/ and scored: the best-of-N
        pixel-curve NRMSE (and per target) go to metrics.jsonl. Every rank
        samples; rank 0 writes, scores and returns the NRMSE (None
        elsewhere)."""
        tcfg = self.tcfg
        step = self.state.step
        targets = np.genfromtxt(tcfg.fidelity_probe_targets, delimiter=",")
        if targets.ndim == 1:
            targets = targets[None, :]
        targets = targets[:tcfg.fidelity_probe_n_targets]
        # scored at frame resolution; conditioning in the model's labels
        score_targets = targets if targets.shape[1] == self.mcfg.num_frames \
            else interpolate_labels(targets, self.mcfg.num_frames)
        cond_src = score_targets if self.mcfg.per_frame_cond \
            else targets[:, 1:]
        cond = self.ds.labels_scaling.normalize(
            cond_src.astype(np.float32)).astype(np.float32)
        t0 = time.time()
        videos = self.sample_videos(
            np.repeat(cond, tcfg.fidelity_probe_preds, axis=0),
            tcfg.guidance_scale, stream=_PROBE_SAMPLES)
        if self.rank != 0:              # files written and scored once
            return None
        mode_dir = (self.results_folder / "training" / f"step_{step}"
                    / "fidelity_probe")
        (mode_dir / "gifs").mkdir(parents=True, exist_ok=True)
        save_preds(videos, mode_dir, self.selected_channels,
                   num_samples=len(targets),
                   reference_frame=self.mcfg.reference_frame,
                   num_frames=self.mcfg.num_frames, zero_u_2=self.ds.zero_u_2)
        nrmse, per_target = score_gifs_dir(
            mode_dir / "gifs", self.ds.folder / "frame_range_data.csv",
            score_targets, tcfg.fidelity_probe_preds,
            self.mcfg.reference_frame)
        self._log({"step": step, "fidelity probe NRMSE": nrmse,
                   "fidelity probe per target": per_target})
        print(f"fidelity probe: best-of-{tcfg.fidelity_probe_preds} NRMSE "
              f"{nrmse:.3f} over {len(targets)} targets "
              f"({time.time() - t0:.0f}s)")
        return nrmse

    def sampling_diffusion(self) -> GaussianDiffusion:
        """A sampler on a bf16 copy (the inference cast) of the EMA weights:
        the trained model is not cast."""
        return build_sampler(self.mcfg, device=self.device,
                             weights=self.state.ema_state_dict())

    def sample_videos(self, cond: np.ndarray,
                      guidance_scale: Optional[float] = None,
                      stream: int = _MILESTONE_SAMPLES) -> np.ndarray:
        """EMA samples (n, F, H, W, C) in [0, 1] of a conditioning batch, in
        chunks of half the test batch (times the ranks), from the random
        stream (seed, stream, step): a resumed run samples what the
        unbroken one did."""
        w = self.tcfg.guidance_scale if guidance_scale is None \
            else guidance_scale
        return sample_videos(self.sampling_diffusion(), cond, w,
                             chunk=self.test_batch,
                             seed=(self.tcfg.seed, stream, self.state.step))

    # -------------------------------------------------------- checkpoints
    def save(self, step: Optional[int] = None) -> Optional[Path]:
        """Rank 0 writes the checkpoint of the state (the ranks hold the
        same one); every rank waits for it. Returns its path on rank 0."""
        step = self.state.step if step is None else step
        if self.rank != 0:
            parallel.barrier()
            return None
        t0 = time.perf_counter()
        named = list(self.state.model.named_parameters())
        payload = {
            "step": np.asarray(self.state.step, np.int32),
            "params": ckpt.torch_to_flax_tree(dict(named)),
            "opt_state": ckpt.optimizer_state_tree(
                self.state.optimizer, named,
                clipped=self.tcfg.max_grad_norm is not None,
                accum=self.state.accum),
            "ema_params": ckpt.torch_to_flax_tree(
                self.state.ema_state_dict())}
        aux = {"labels_scaling": self.ds.labels_scaling.to_dict(),
               "step": step}
        path = ckpt.save_checkpoint(
            self.results_folder, step, payload, aux,
            backend=self.tcfg.checkpoint_backend,
            keep_last=self.tcfg.keep_last_checkpoints)
        self.timings.append({"step": step,
                             "save": time.perf_counter() - t0})
        print(f"checkpoint saved to {path}")
        parallel.barrier()
        return path

    @torch.no_grad()
    def load_torch_checkpoint(self, path: str | Path,
                              which: str = "both") -> None:
        """Import a reference checkpoint.pt: its online weights ('model')
        into the trained parameters and its EMA ('ema') into the EMA, or
        one of them; Adam's state and the step are kept."""
        if which not in ("both", "model", "ema"):
            raise ValueError(f"which must be 'both', 'model' or 'ema', not "
                             f"{which!r}")
        model = self.state.model
        template = model.state_dict()
        if which in ("both", "model"):
            model.load_state_dict(load_reference_weights(path, template,
                                                         "model"),
                                  strict=True)
        if which in ("both", "ema"):
            ema = load_reference_weights(path, template, "ema")
            for (name, _), e in zip(model.named_parameters(),
                                    self.state.ema):
                e.copy_(ema[name])
        print(f"imported torch checkpoint from {path}")

    @torch.no_grad()
    def load(self, step: int) -> None:
        """Resume from runs/<name>/model/step_<step>: parameters, Adam
        state, EMA and step, strictly (a tree that does not fit the model
        raises); a cache-restored step is refused."""
        raw, _ = ckpt.read_train_checkpoint(self.results_folder, step)
        model = self.state.model
        model.load_state_dict(ckpt.flax_to_torch_state_dict(raw["params"]),
                              strict=True)
        ema = ckpt.flax_to_torch_state_dict(raw["ema_params"])
        named = list(model.named_parameters())
        if set(ema) != {n for n, _ in named}:
            raise ValueError("the checkpoint's EMA does not fit the model")
        for (name, _), e in zip(named, self.state.ema):
            e.copy_(ema[name])
        accum = self.state.accum
        count = ckpt.load_optimizer_state(
            raw["opt_state"], self.state.optimizer, named,
            clipped=self.tcfg.max_grad_norm is not None, accum=accum)
        self.state.step = int(np.asarray(raw["step"]))
        # Adam counts inner steps; under accumulation the step counts
        # micro-steps: gradient_step * k + mini_step
        inner = self.state.step if accum is None else accum.gradient_step
        if count != inner or (accum is not None and self.state.step != (
                accum.gradient_step * accum.k + accum.mini_step)):
            raise ValueError(f"optimizer count {count} does not fit the "
                             f"checkpoint's step {self.state.step}")
        print(f"checkpoint loaded from step {step}")


# ----------------------------------------------------------- target eval


def sampling_chunk(test_batch_size: int) -> int:
    """Videos a sampling call takes: half the test batch, as the JAX
    trainer (and the reference, vddp.py:1460) halves it on one device."""
    return max(test_batch_size // 2, 1)


def chunk_generator(seed, index: int, device) -> torch.Generator:
    """The random stream of sampling chunk `index` under `seed` (an int or
    a tuple of ints)."""
    return seeded_generator(device, *np.atleast_1d(seed), index)


def sample_videos(diffusion: GaussianDiffusion, cond: np.ndarray,
                  guidance_scale: float, *, chunk: int, seed=0,
                  cfg_rescale: float | None = None) -> np.ndarray:
    """Guided samples (n, F, H, W, C) in [0, 1] of a conditioning batch
    (n, F), DDPM or DDIM as `diffusion.sample` dispatches: chunks of
    `chunk` curves (the last padded by repeating its last curve, the
    padding dropped), each from its own generator. Under a process group
    of W ranks the chunk is at least W and a multiple of W; each chunk's
    generator draws the whole chunk's noise, each rank samples its rows,
    and the rows are gathered: every rank returns the same videos."""
    if parallel.active():
        world = parallel.world_size()
        chunk = -(-max(chunk, world) // world) * world
    cond, n = parallel.pad_to_multiple(np.asarray(cond, np.float32), chunk)
    outs = []
    for i in range(0, len(cond), chunk):
        gen = chunk_generator(seed, i // chunk, diffusion.device)
        c = torch.from_numpy(cond[i:i + chunk])
        if parallel.active():
            videos = _sample_rows(diffusion, c, guidance_scale, gen,
                                  cfg_rescale)
        else:
            videos = diffusion.sample(c, guidance_scale, generator=gen,
                                      cfg_rescale=cfg_rescale)
        outs.append(videos.float().cpu().numpy())
    return np.concatenate(outs)[:n]


def _sample_rows(diffusion: GaussianDiffusion, cond: torch.Tensor,
                 guidance_scale: float, gen: torch.Generator,
                 cfg_rescale: float | None) -> torch.Tensor:
    """This rank's rows of one chunk's chain, every noise drawn at the
    chunk's shape in the chain's order and sliced; the ranks' rows
    gathered."""
    per = len(cond) // parallel.world_size()
    rows = slice(parallel.rank() * per, (parallel.rank() + 1) * per)
    shape = diffusion.video_shape(len(cond))

    def draw(_=None):
        return torch.randn(shape, generator=gen, device=diffusion.device,
                           dtype=torch.float32)[rows]

    videos = diffusion.sample(cond[rows], guidance_scale, x_T=draw(),
                              noise_fn=draw, cfg_rescale=cfg_rescale)
    return parallel.gather_rows(videos.float())


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
                cfg_rescale: float | None = None,
                w_label: float | None = None):
    """Guided generation for the target curves of a CSV (one 51-point
    curve a row, or one value a frame): each curve num_preds times,
    artifacts (gifs/prediction_channel_<c>.gif, geometries.csv) written to
    a new eval_target directory, named by w_label (default the guidance
    scale). Returns (that directory, the videos, the sampling seconds), or
    None when the targets cannot be read."""
    phi = diffusion.cfg_rescale if cfg_rescale is None else cfg_rescale
    mode_dir = eval_target_dir(results_folder, step,
                               guidance_scale if w_label is None else w_label,
                               phi)
    # every rank names the directory before rank 0 makes it
    parallel.barrier()
    if parallel.rank() == 0:
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
    if parallel.rank() == 0:            # artifacts written once
        save_preds(videos, mode_dir, list(cfg.selected_channels),
                   num_samples=len(cond), reference_frame=cfg.reference_frame,
                   num_frames=cfg.num_frames, zero_u_2=zero_u_2)
    return mode_dir, videos, seconds
