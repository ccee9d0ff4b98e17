"""Data parallelism across processes: the port's copy of
videometamaterials_tpu/parallel/mesh.py.

One process (a rank) drives one device: NCCL between cards, gloo between
CPU processes. A run with W ranks takes the steps one process takes on the
W ranks' rows as one global batch, as the JAX SPMD step over a 1-D data
mesh does:
  - initialize_distributed (JAX :40-73) joins a process group when one is
    asked for, explicitly or by a launcher (torchrun, SLURM);
  - world_size / rank are jax.process_count / jax.process_index;
  - pad_to_multiple (:84-92) is the JAX function; local_rows is
    shard_cond_batch (:95-102): pad to a multiple of W, keep this rank's
    contiguous rows;
  - gather_rows is the Trainer's _gather_for_host: every rank gets the
    whole batch;
  - all_reduce_mean_ is the psum XLA inserts for the gradients of a
    replicated state: one all_reduce over a flat float32 bucket of the
    gradients, divided by W. Not DistributedDataParallel: its wrapper
    prefixes every parameter name with `module.` (the checkpoint tree
    would change) and refuses parameters a step leaves unused (the
    fused_plans switch, the focus mask's bypassed blocks), where JAX
    psums every leaf.

make_mesh, batch_sharding and replicated_sharding have no counterpart
here: they are GSPMD objects, and the port places one rank on one device
with explicit collectives. The two video shardings of the latency mode
(one chain's height or frames split across devices, :105-129) are
parallel/latency.py's spatial_video_sharding and frame_video_sharding,
with the halo exchanges and collectives GSPMD would insert written by
hand.

Without a process group every function here is the one-process identity
and calls no collective.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist

# launcher variables that ask for a process group: torchrun's, SLURM's
_TORCHRUN = ("WORLD_SIZE", "RANK")
_SLURM = ("SLURM_NTASKS", "SLURM_PROCID")


def initialize_distributed(init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None,
                           backend: Optional[str] = None) -> bool:
    """Join a process group when one is asked for: explicit arguments, or
    a launcher's environment (torchrun's WORLD_SIZE / RANK / LOCAL_RANK /
    MASTER_ADDR, or SLURM's SLURM_NTASKS / SLURM_PROCID with more than one
    task, and MASTER_ADDR / MASTER_PORT). The backend is NCCL when CUDA is present
    and the caller did not name gloo, gloo otherwise; on CUDA the process
    binds cuda:LOCAL_RANK (the rank modulo the visible cards without it).
    With nothing asked for it returns False and does nothing. An error in
    an asked-for initialisation propagates: a run asked to be
    multi-process never carries on as one process. Returns True when the
    group was initialised here."""
    explicit = any(v is not None for v in (init_method, world_size, rank))
    env = os.environ
    if not explicit:
        if all(k in env for k in _TORCHRUN):
            world_size, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
        elif all(k in env for k in _SLURM) and int(env["SLURM_NTASKS"]) > 1:
            # a one-task allocation runs as one process
            world_size = int(env["SLURM_NTASKS"])
            rank = int(env["SLURM_PROCID"])
        else:
            return False
        init_method = "env://"
    if world_size is None or rank is None:
        raise ValueError("a process group needs its world size and rank")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        local = env.get("LOCAL_RANK", env.get("SLURM_LOCALID"))
        local = int(local) if local is not None \
            else rank % torch.cuda.device_count()
        torch.cuda.set_device(local)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    return True


def active() -> bool:
    """Whether this process is in a process group."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """The number of ranks (jax.process_count); 1 without a group."""
    return dist.get_world_size() if active() else 1


def rank() -> int:
    """This process's rank (jax.process_index); 0 without a group."""
    return dist.get_rank() if active() else 0


def barrier() -> None:
    """Wait for every rank; nothing without a group."""
    if active():
        dist.barrier()


@contextlib.contextmanager
def rank0_first():
    """Rank 0 runs the block, then the other ranks: for a block that
    writes a file the others read (a dataset's cache)."""
    if rank() != 0:
        barrier()
    try:
        yield
    finally:
        if rank() == 0:
            barrier()


def pad_to_multiple(x: np.ndarray, multiple: int) -> tuple[np.ndarray, int]:
    """Pad the leading axis up to a multiple (repeating the last row so
    padded work is well-conditioned); returns (padded, original_length)."""
    n = x.shape[0]
    rem = (-n) % multiple
    if rem == 0:
        return x, n
    pad = np.repeat(x[-1:], rem, axis=0)
    return np.concatenate([x, pad], axis=0), n


def local_rows(x: np.ndarray, world: int, rank: int) -> tuple[np.ndarray,
                                                              int]:
    """Rank `rank`'s contiguous rows of x padded to a multiple of
    `world`, and x's original length."""
    padded, n = pad_to_multiple(np.asarray(x), world)
    per = len(padded) // world
    return padded[rank * per:(rank + 1) * per], n


def gather_rows(t: torch.Tensor) -> torch.Tensor:
    """The ranks' tensors concatenated along dim 0, in rank order, on every
    rank (each rank's tensor of the same shape); t itself without a
    group."""
    if not active():
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t)
    return torch.cat(parts)


@torch.no_grad()
def all_reduce_mean_(params: Iterable[torch.Tensor],
                     *scalars: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Set every parameter's .grad to its mean over the ranks, with one
    all_reduce of a flat float32 bucket. A gradient that is None is read
    as zeros, on every rank alike, as JAX psums every leaf: a parameter no
    rank reached gets a zero gradient, with which Adam leaves it as it is
    (zero moments, a zero update). No value goes to the host, so the step
    runs on without a sync. `scalars` (the loss) ride in the same bucket;
    returns their means. Without a group nothing changes and the scalars
    come back as they are."""
    if not active():
        return scalars
    params = list(params)
    grads = [p.grad for p in params]
    device = params[0].device
    flat = [torch.zeros(p.numel(), dtype=torch.float32, device=device)
            if g is None else g.reshape(-1).float()
            for p, g in zip(params, grads)]
    tail = [s.detach().reshape(1).float() for s in scalars]
    bucket = torch.cat(flat + tail)
    dist.all_reduce(bucket)
    bucket /= dist.get_world_size()
    pieces = bucket.split([f.numel() for f in flat] + [1] * len(tail))
    means = [m.view_as(p) for m, p in zip(pieces, params)]
    have = [i for i, g in enumerate(grads) if g is not None]
    if have:                            # one foreach copy, not one a tensor
        torch._foreach_copy_([grads[i] for i in have],
                             [means[i] for i in have])
    for i, g in enumerate(grads):
        if g is None:
            params[i].grad = means[i].to(params[i].dtype).clone()
    return tuple(s.reshape(()).to(x.dtype)
                 for s, x in zip(pieces[len(params):], scalars))


def destroy() -> None:
    """Leave the process group, if any."""
    if active():
        dist.destroy_process_group()
