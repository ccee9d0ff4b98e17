"""Driver entry points of the port: the counterparts of the JAX package's
root __graft_entry__.py.

entry()             -> (fn, args): the flagship denoiser's guided forward
                       (CFG, w = 5) on seeded weights, on the card.
dryrun_multichip(n) -> one data-parallel train step (loss, gradients
                       averaged over n ranks, Adam, EMA) of a tiny model,
                       one example a rank, one guided sampling chunk of n
                       at w = 5 split over the ranks, then the latency
                       mode: one video's w = 5 chain split by height over
                       the n ranks; prints one line.

    python -m videometamaterials_tpu_torch.graft_entry --dryrun N

dryrun_multichip runs in the caller's process group when it has n ranks,
in a group of one it opens itself on the card for n = 1, and otherwise in
n processes it starts: one a card (NCCL) when there are n cards, else n
gloo processes on the CPU, as the JAX function re-runs on a virtual CPU
mesh when the host has fewer devices (__graft_entry__.py:51-98). The line
names the backend and the device it ran on.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist

from videometamaterials_tpu_torch import parallel
from videometamaterials_tpu_torch.config import ModelConfig, TrainerConfig

ROOT = Path(__file__).resolve().parent.parent


def entry(device=None):
    """The flagship's guided forward on seeded weights: (fn, (x, t, cond))
    with fn(x, t, cond) the CFG-folded eps at w = 5 of a batch of one."""
    from videometamaterials_tpu_torch.sample import build_sampler

    cfg = ModelConfig()
    diffusion = build_sampler(cfg, device=device, seed=0)
    dev = diffusion.device
    x = torch.zeros((1, cfg.num_frames, cfg.image_size, cfg.image_size,
                     cfg.channels), device=dev)
    t = torch.zeros((1,), dtype=torch.long, device=dev)
    cond = torch.zeros((1, cfg.cond_length), device=dev)

    @torch.no_grad()
    def fn(x, t, cond):
        return diffusion.guided_eps(x, t, cond, 5.0)

    return fn, (x, t, cond)


# the JAX dry run's model (__graft_entry__.py:113-117); the kernels take the
# flagship's widths (8 heads of 32, 11 frames), so its blocks run unfused
DRYRUN_CONFIG = ModelConfig(
    image_size=16, num_frames=3, unet_dim=8, dim_mults=(1, 2),
    unet_attn_heads=2, unet_attn_dim_head=4, train_timesteps=8,
    sampling_timesteps=8, compute_dtype="float32", batch_size=1,
    use_fused_linear_block=False, use_fused_temporal_block=False)


def dryrun_multichip(n_devices: int, timeout: float = 600.0) -> None:
    """One data-parallel train step and one guided sampling chunk over
    n_devices ranks; see the module docstring for where they run. A
    started process that fails or outlives `timeout` seconds raises."""
    if parallel.active():
        if parallel.world_size() != n_devices:
            raise ValueError(f"the process group has "
                             f"{parallel.world_size()} ranks, not "
                             f"{n_devices}")
        _dryrun_body(n_devices)
        return
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n_devices == 1 and cards >= 1:
        parallel.initialize_distributed(
            f"tcp://127.0.0.1:{free_port()}", world_size=1, rank=0,
            backend="nccl")
        try:
            _dryrun_body(1)
        finally:
            parallel.mesh.destroy()
        return
    _spawn(n_devices, "nccl" if cards >= n_devices else "gloo", timeout)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(n: int, backend: str, timeout: float) -> None:
    """Run _dryrun_body in n processes of `backend`; rank 0's output is
    printed, every rank's when one fails."""
    init = f"tcp://127.0.0.1:{free_port()}"
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    if backend == "gloo":
        env["CUDA_VISIBLE_DEVICES"] = ""       # CPU processes
    procs = [subprocess.Popen(
        [sys.executable, "-m", "videometamaterials_tpu_torch.graft_entry",
         "--worker", "--init-method", init, "--world", str(n), "--rank",
         str(r), "--backend", backend],
        env={**env, "LOCAL_RANK": str(r)}, cwd=ROOT, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(n)]
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(deadline - time.monotonic(), 1.0))[0])
    except subprocess.TimeoutExpired:
        raise RuntimeError(f"dryrun_multichip({n}) on {backend}: no end "
                           f"within {timeout:.0f}s") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    sys.stdout.write(outs[0] if not failed else "".join(
        f"--- rank {r} ---\n{o}" for r, o in enumerate(outs)))
    sys.stdout.flush()
    if failed:
        raise RuntimeError(f"dryrun_multichip({n}) on {backend}: ranks "
                           f"{failed} failed")


def _dryrun_body(n: int) -> str:
    """The dry run on this rank of a group of n; rank 0 prints the line
    and every rank returns it."""
    from videometamaterials_tpu_torch.diffusion.gaussian import (
        GaussianDiffusion,
    )
    from videometamaterials_tpu_torch.models.unet3d import build_unet
    from videometamaterials_tpu_torch.sample import build_sampler
    from videometamaterials_tpu_torch.training.trainer import (
        StepTrainer,
        sample_videos,
    )

    backend = dist.get_backend()
    dev = (torch.device("cuda", torch.cuda.current_device())
           if backend == "nccl" else torch.device("cpu"))
    r = parallel.rank()
    cfg = DRYRUN_CONFIG
    shape = (n, cfg.num_frames, cfg.image_size, cfg.image_size, cfg.channels)
    # the global batch, the same on every rank; one example a rank
    videos = torch.rand(shape, generator=torch.Generator().manual_seed(0))
    labels = torch.zeros((n, cfg.cond_length))
    model = build_unet(cfg, device=dev, seed=0)
    trainer = StepTrainer(GaussianDiffusion.from_config(model, cfg, dev),
                          cfg, TrainerConfig(seed=0),
                          iter([(videos[r:r + 1], labels[r:r + 1])]))
    loss = float(trainer.step())
    flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()]
                     + [e.reshape(-1) for e in trainer.state.ema])
    if not all(torch.equal(flat, f) for f in parallel.gather_rows(
            flat[None]).unbind(0)):
        raise AssertionError("the ranks' states differ after the step")
    sampler = build_sampler(cfg, device=dev,
                            weights=trainer.state.ema_state_dict())
    vids = sample_videos(sampler, torch.zeros(shape[0], cfg.cond_length)
                         .numpy(), 5.0, chunk=n, seed=1)
    if vids.shape != shape:
        raise AssertionError(f"sampled {vids.shape}, expected {shape}")
    # the latency mode (__graft_entry__.py:180-195): one video's chain, its
    # height split over the ranks, the whole video on every rank
    latency = GaussianDiffusion.from_config(
        sampler.model, cfg, dev,
        sample_spatial_sharding=parallel.spatial_video_sharding())
    one = latency.sample(torch.zeros((1, cfg.cond_length)), 5.0,
                         generator=torch.Generator(dev).manual_seed(2))
    if tuple(one.shape) != (1, *shape[1:]) or not torch.isfinite(one).all():
        raise AssertionError(f"latency mode: {tuple(one.shape)}, expected "
                             f"{(1, *shape[1:])} and finite")
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    line = (f"dryrun_multichip({n}): loss={loss:.4f} sample={vids.shape} "
            f"latency_mode={tuple(one.shape)} backend={backend} "
            f"device={where} OK")
    if r == 0:
        print(line, flush=True)
    return line


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dryrun", type=int, metavar="N",
                    help="run dryrun_multichip(N)")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--init-method", help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--backend", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        if args.backend == "gloo":
            torch.set_num_threads(1)
        parallel.initialize_distributed(args.init_method, args.world,
                                        args.rank, args.backend)
        try:
            _dryrun_body(args.world)
        finally:
            parallel.mesh.destroy()
    elif args.dryrun:
        dryrun_multichip(args.dryrun)
    else:
        ap.error("nothing to do: pass --dryrun N")


if __name__ == "__main__":
    main()
