#!/usr/bin/env python3
"""Time one guided video's chain split across W cards (the port's latency
mode, videometamaterials_tpu_torch/parallel/latency.py) against the same
chain on one card.

    torchrun --nproc_per_node 4 scripts/torch_latency_chain.py \
        [--out latency_chain.json]

Under torchrun's process group of W ranks (NCCL, one rank a card): rank 0
runs the unsplit chain alone while the others wait, then all W ranks run
the chain split by height, then split by frames, every chain from the
same x_T and step noises (each rank's generator seeded alike). The model
is model.yaml's flagship with the fused plans off (the latency mode runs
the unfused plans), seeded weights, batch 1, w = 5: the config's whole
chain, after WARMUP steps of it untimed. Rank 0 prints one JSON line: the
card (nvidia-smi's name and power limit), W, the steps, each chain's
seconds, the split chains' collectives a step and their relative L2 and
largest absolute error against the unsplit chain. With --config (a small
model.yaml) and --device cpu it runs on gloo CPU processes, for a
rehearsal.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from videometamaterials_tpu_torch import parallel  # noqa: E402
from videometamaterials_tpu_torch.config import load_model_yaml  # noqa: E402
from videometamaterials_tpu_torch.diffusion.gaussian import (  # noqa: E402
    GaussianDiffusion,
)
from videometamaterials_tpu_torch.sample import build_sampler  # noqa: E402

SEED = 12
WARMUP = 2


def card() -> str:
    if not torch.cuda.is_available():
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default=str(ROOT / "model.yaml"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", help="also write the JSON line to this file")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("torch_latency_chain: no CUDA device", file=sys.stderr)
        return 2
    if not parallel.initialize_distributed():
        print("torch_latency_chain: run it under torchrun", file=sys.stderr)
        return 2
    try:
        return run(args)
    finally:
        parallel.mesh.destroy()


def run(args) -> int:
    rank, world = parallel.rank(), parallel.world_size()
    dev = (torch.device("cuda", torch.cuda.current_device())
           if args.device == "cuda" else torch.device("cpu"))
    cfg = load_model_yaml(args.config).replace(
        use_fused_linear_block=False, use_fused_temporal_block=False)
    steps = cfg.train_timesteps
    model = build_sampler(cfg, device=dev, seed=0).model
    cond = torch.rand((1, cfg.cond_length),
                      generator=torch.Generator().manual_seed(2)) * 2 - 1

    def chain(diffusion, n):
        gen = torch.Generator(device=dev).manual_seed(SEED)
        return diffusion.sample(cond, 5.0, generator=gen, num_steps=n)

    def timed(diffusion, together: bool):
        chain(diffusion, WARMUP)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        if together:
            parallel.barrier()
        t0 = time.perf_counter()
        video = chain(diffusion, steps)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return video, time.perf_counter() - t0

    result = {"card": card(), "world": world, "steps": steps,
              "device": str(dev)}
    if rank == 0:
        want, result["unsplit_s"] = timed(
            GaussianDiffusion.from_config(model, cfg, dev), False)
    else:
        result["unsplit_s"] = None
    parallel.barrier()
    for mode, make in (("height", parallel.spatial_video_sharding),
                       ("frames", parallel.frame_video_sharding)):
        plan = make()
        diffusion = GaussianDiffusion.from_config(
            model, cfg, dev, sample_spatial_sharding=plan)
        plan.reset_counts()
        chain(diffusion, 1)
        per_step = {k: v - (k == "all_gather") for k, v in
                    plan.counts.items()}          # less the result's gather
        video, seconds = timed(diffusion, True)
        if rank == 0:
            diff = (video - want).float()
            result[mode] = {
                "s": seconds, "collectives_a_step": per_step,
                "rel_l2": (diff.norm() / want.float().norm()).item(),
                "max_abs": diff.abs().max().item(),
                "speedup": result["unsplit_s"] / seconds,
                "finite": bool(torch.isfinite(video).all())}
    if rank == 0:
        line = json.dumps(result)
        print(line, flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
