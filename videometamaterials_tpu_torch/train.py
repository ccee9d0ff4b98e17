"""Training entry point of the port.

    python -m videometamaterials_tpu_torch.train --config model.yaml
        --steps N [--seed 0] [--device cuda]

Trains the UNet3D of the config from seeded random weights on the JAX
package's benchmark train workload (bench.py:117-145): each step a batch of
`batch_size` videos drawn U[0, 1) and labels drawn N(0, 1) from a seeded
generator, null-conditioning probability 0.1, Adam and the EMA of the
train step. The fused blocks run under grad only with
fused_blocks_in_training in the config (their backward kernels with
fused_bwd_kernels; the temporal blocks' backward from the saved softmax
weights with temporal_vjp: saved). Prints each step's loss, then one JSON line with the
median step time (the device synchronised around each step, which draws
its batch on the device) and, on a GPU, the peak device memory. Runs on
the GPU unless --device names another device.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import time

import torch

from videometamaterials_tpu_torch.config import (
    TrainerConfig,
    load_model_yaml,
    resolve_device,
)
from videometamaterials_tpu_torch.diffusion.gaussian import GaussianDiffusion
from videometamaterials_tpu_torch.models.unet3d import build_unet
from videometamaterials_tpu_torch.training.trainer import StepTrainer


def bench_batches(cfg, generator: torch.Generator, device):
    """Train batches of the benchmark workload, drawn as they are taken:
    videos U[0, 1), labels N(0, 1) of the model's conditioning width."""
    shape = (cfg.batch_size, cfg.num_frames, cfg.image_size, cfg.image_size,
             cfg.channels)
    while True:
        videos = torch.rand(shape, generator=generator, device=device)
        labels = torch.randn((cfg.batch_size, cfg.cond_length),
                             generator=generator, device=device)
        yield videos, labels


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cfg, steps: int, *, device=None, seed: int = 0,
        tcfg: TrainerConfig | None = None, log=print) -> dict:
    """Train `steps` steps; returns the losses, step times and peak
    memory (None off the GPU)."""
    dev = resolve_device(device)
    tcfg = tcfg or TrainerConfig(seed=seed)
    model = build_unet(cfg, device=dev, seed=seed)
    diffusion = GaussianDiffusion.from_config(model, cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    trainer = StepTrainer(diffusion, cfg, tcfg, bench_batches(cfg, gen, dev),
                      generator=gen)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    losses, times = [], []
    for i in range(steps):
        _sync(dev)
        t0 = time.perf_counter()
        loss = trainer.step()
        _sync(dev)
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
        log(f"step {i}: loss {losses[-1]:.6f} ({times[-1] * 1e3:.1f} ms)")
    return {"losses": losses, "step_ms": [t * 1e3 for t in times],
            "median_step_ms": statistics.median(times) * 1e3,
            "peak_mem_bytes": (torch.cuda.max_memory_allocated(dev)
                               if dev.type == "cuda" else None)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="model.yaml")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)

    cfg = load_model_yaml(args.config)
    dev = resolve_device(args.device)
    out = run(cfg, args.steps, device=dev, seed=args.seed)
    if not all(math.isfinite(v) for v in out["losses"]):
        raise RuntimeError(f"non-finite loss: {out['losses']}")
    meta = {"steps": args.steps, "batch": cfg.batch_size,
            "median_step_ms": out["median_step_ms"],
            "peak_mem_bytes": out["peak_mem_bytes"],
            "fused_blocks_in_training": cfg.fused_blocks_in_training,
            "fused_bwd_kernels": cfg.fused_bwd_kernels,
            "temporal_vjp": cfg.temporal_vjp,
            "device": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else str(dev))}
    print(json.dumps(meta))
    return {**meta, "losses": out["losses"]}


if __name__ == "__main__":
    main()
