"""The latency mode: ONE video's sampling chain split across the ranks of
a process group, by height or by frames. Port of the JAX package's
spatial_video_sharding and frame_video_sharding (parallel/mesh.py:105-129)
and of the collectives GSPMD derives from them.

In JAX one sharding constraint on the scan carry is enough: GSPMD inserts
every halo exchange and collective. Torch has no GSPMD, so a plan here is
an object the sampler passes down to the ops, and each op that needs
another rank's data calls one of three collectives written by hand:
  halo        the edge rows a spatial convolution reaches on the
              neighbouring ranks (`dist.batch_isend_irecv`);
  all_reduce  GroupNorm's statistics, the linear attention's key max, exp
              sum and context, the CFG-rescale std;
  all_gather  the mid attention's keys and values, the temporal keys and
              values of frame mode, |x0| for the dynamic threshold, and
              the result.
Each call adds one to the plan's count of its kind (`LatencyPlan.counts`).

Height mode ('height'): every UNet level whose rows split into whole
blocks, one a rank, and all levels above it, run split; a level below
runs whole on every rank (gathered on the way down, sliced again on the
way up). Time, conditioning and the temporal blocks stay local: each
pixel's frames live on one rank. Frame mode ('frames'): contiguous
near-even blocks of frames; convolutions and the spatial attentions are
frame-local (no halo), the temporal blocks gather keys and values.

A gloo group whose tensors live on a card (two ranks on one card, which
NCCL refuses) stages every collective through host memory.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

AXES = ("height", "frames")
COLLECTIVES = ("halo", "all_reduce", "all_gather")


# ---------------------------------------------------------------- layout


def even_blocks(size: int, world: int) -> tuple[tuple[int, int], ...]:
    """Each rank's [start, stop) of `size` rows in `world` equal blocks."""
    if size % world:
        raise ValueError(f"{size} rows do not split into {world} blocks")
    per = size // world
    return tuple((r * per, (r + 1) * per) for r in range(world))


def frame_blocks(frames: int, world: int) -> tuple[tuple[int, int], ...]:
    """Contiguous near-even blocks of frames, the larger ones first (11
    over 2 ranks: 6 + 5)."""
    if world > frames:
        raise ValueError(f"{frames} frames do not split over {world} ranks")
    per, extra = divmod(frames, world)
    starts = [r * per + min(r, extra) for r in range(world + 1)]
    return tuple(zip(starts[:-1], starts[1:]))


def level_layout(image_size: int, levels: int, world: int) -> tuple:
    """Height mode's split of each UNet level (image_size, image_size / 2,
    ...): every rank's row blocks, or None where the level runs whole on
    every rank. A level splits when its rows divide into `world` whole
    blocks and every level above it splits; then each block above it
    holds an even number of rows, starting on an even row, as the
    stride-2 Downsample between them needs."""
    if image_size % world:
        raise ValueError(f"height mode needs the world ({world}) to divide "
                         f"image_size ({image_size})")
    out, split = [], True
    for i in range(levels):
        rows = image_size >> i
        split = split and rows % world == 0
        out.append(even_blocks(rows, world) if split else None)
    return tuple(out)


def halo_rows(kernel: int, stride: int, padding: int,
              transposed: bool = False) -> tuple[int, int]:
    """(rows above, rows below) a rank's block that a convolution of this
    kernel, stride and padding reads to give the block's outputs: output
    row o reads input rows s o - p .. s o - p + k - 1; the transposed
    convolution's output row o reads the inputs i with s i in
    [o - (k - 1 - p), o + p]."""
    if transposed:
        return (kernel - 1 - padding) // stride, (padding - 1) // stride + 1
    return padding, kernel - padding - stride


def halo_sources(blocks, size: int, above: int, below: int, wrap: bool):
    """Where each rank's halo rows come from: for each rank, the pieces of
    its `above` rows and of its `below` rows, in row order, each (src, lo,
    hi): rank src's global rows [lo, hi), or (None, 0, n): n zero rows
    past the global edge. With wrap (the 'circular' mode) rows past an
    edge are the other edge's."""
    def owner(g):
        return next(r for r, (a, b) in enumerate(blocks) if a <= g < b)

    def pieces(rows):
        out = []
        for g in rows:
            if wrap:
                g %= size
            src = owner(g) if 0 <= g < size else None
            last = out[-1] if out else None
            if last and last[0] == src and (src is None or last[2] == g):
                out[-1] = (src, last[1], last[2] + 1)
            else:
                out.append((None, 0, 1) if src is None else (src, g, g + 1))
        return out

    return [(pieces(range(start - above, start)),
             pieces(range(stop, stop + below))) for start, stop in blocks]


# ------------------------------------------------------------------ plan


@dataclasses.dataclass(frozen=True, eq=False)
class LatencyPlan:
    """The latency mode's split: the axis ('height' or 'frames'), the
    process group (None: the default group), this rank, the world size,
    and, once bound to a model (`bind`), each UNet level's `Shard` (None
    where a level runs whole on every rank). `counts` holds the
    collectives called, by kind; a bound plan shares its plan's."""

    axis: str
    group: Optional[object]
    rank: int
    world: int
    backend: Optional[str] = None
    levels: tuple = ()
    counts: dict = dataclasses.field(
        default_factory=lambda: dict.fromkeys(COLLECTIVES, 0))

    @classmethod
    def of(cls, axis: str, group=None) -> "LatencyPlan":
        if axis not in AXES:
            raise ValueError(f"unknown axis {axis!r}")
        if not (dist.is_available() and dist.is_initialized()):
            return cls(axis, None, 0, 1)
        return cls(axis, group, dist.get_rank(group),
                   dist.get_world_size(group), dist.get_backend(group))

    def bind(self, image_size: int, num_frames: int,
             levels: int) -> "LatencyPlan":
        """This plan with each level's Shard for a model of `levels`
        levels on image_size x image_size videos of num_frames frames.
        Height mode raises unless the world divides image_size."""
        if self.axis == "height":
            shards = tuple(
                None if b is None else Shard(self, image_size >> i, b)
                for i, b in enumerate(level_layout(image_size, levels,
                                                   self.world)))
        else:
            shards = (Shard(self, num_frames,
                            frame_blocks(num_frames, self.world)),) * levels
        return dataclasses.replace(self, levels=shards)

    def reset_counts(self) -> None:
        for k in self.counts:
            self.counts[k] = 0

    # -- the collectives: each counts itself and stages through the host
    # where a gloo group holds card tensors

    def _device(self, t: torch.Tensor) -> torch.device:
        """Where the collective takes t: the host for a gloo group's card
        tensor, else t's device."""
        staged = self.backend == "gloo" and t.is_cuda
        return torch.device("cpu") if staged else t.device

    def _host(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self._device(t))

    def _peer(self, r: int) -> int:
        return r if self.group is None else dist.get_global_rank(
            self.group, r)

    def all_reduce(self, t: torch.Tensor,
                   op=dist.ReduceOp.SUM) -> torch.Tensor:
        """t reduced over the ranks (a new tensor on t's device)."""
        self.counts["all_reduce"] += 1
        buf = t.to(self._device(t), copy=True)
        dist.all_reduce(buf, op, group=self.group)
        return buf.to(t.device)

    def all_gather(self, t: torch.Tensor, dim: int,
                   lengths) -> torch.Tensor:
        """The ranks' tensors joined along `dim` in rank order; rank r's
        has lengths[r] entries there (padded to the largest for the
        collective, trimmed after)."""
        self.counts["all_gather"] += 1
        most = max(lengths)
        src = self._host(t)
        if src.shape[dim] < most:
            pad = list(src.shape)
            pad[dim] = most - src.shape[dim]
            src = torch.cat([src, src.new_zeros(pad)], dim=dim)
        parts = [torch.empty_like(src) for _ in range(self.world)]
        dist.all_gather(parts, src.contiguous(), group=self.group)
        return torch.cat([p.narrow(dim, 0, n) for p, n in
                          zip(parts, lengths)], dim=dim).to(t.device)

    def halo(self, x: torch.Tensor, dim: int, blocks, size: int,
             above: int, below: int, wrap: bool) -> torch.Tensor:
        """x (this rank's block of `size` rows along `dim`) with `above`
        rows before it and `below` after it from the ranks that hold them,
        zeros past the global edges, or the other edge's rows under wrap:
        one batch_isend_irecv of the edge rows. Every rank walks the same
        list of pieces in the same order, so sends and receives pair up
        (by tag on gloo, by order on NCCL)."""
        self.counts["halo"] += 1
        me = self.rank
        ops, mine, tag = [], ([], []), 0

        def rows_like(n, device):
            shape = list(x.shape)
            shape[dim] = n
            return torch.empty(shape, dtype=x.dtype, device=device)

        for dst, sides in enumerate(halo_sources(blocks, size, above, below,
                                                 wrap)):
            for side, pieces in enumerate(sides):
                for src, lo, hi in pieces:
                    if src is None:
                        if dst == me:
                            mine[side].append(rows_like(hi - lo, x.device)
                                              .zero_())
                        continue
                    if src == me:
                        rows = x.narrow(dim, lo - blocks[me][0], hi - lo)
                        if dst == me:
                            mine[side].append(rows)
                        else:
                            ops.append(dist.P2POp(
                                dist.isend, self._host(rows).contiguous(),
                                self._peer(dst), self.group, tag))
                    elif dst == me:
                        buf = rows_like(hi - lo, self._device(x))
                        ops.append(dist.P2POp(dist.irecv, buf,
                                              self._peer(src), self.group,
                                              tag))
                        mine[side].append(buf)
                    tag += 1
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        top, bottom = ([p.to(x.device) for p in m] for m in mine)
        return torch.cat(top + [x] + bottom, dim=dim)

    # -- level 0's split of a whole video, for the sampler

    def local(self, video: torch.Tensor) -> torch.Tensor:
        return self.levels[0].local(video)

    def gather(self, video: torch.Tensor) -> torch.Tensor:
        return self.levels[0].gather(video)


@dataclasses.dataclass(frozen=True, eq=False)
class Shard:
    """One UNet level's split as the ops see it: the plan, the level's
    whole length along the split axis (rows or frames) and every rank's
    [start, stop). An op takes the Shard of its level, or None for a whole
    tensor, and acts on the axis the shard splits: rows (dim 2 of a (B, F,
    H, W, C) tensor) in height mode, frames (dim 1) in frame mode."""

    plan: LatencyPlan
    size: int
    blocks: tuple

    @property
    def splits_height(self) -> bool:
        return self.plan.axis == "height"

    @property
    def splits_frames(self) -> bool:
        return self.plan.axis == "frames"

    @property
    def dim(self) -> int:
        return 2 if self.splits_height else 1

    @property
    def start(self) -> int:
        return self.blocks[self.plan.rank][0]

    @property
    def stop(self) -> int:
        return self.blocks[self.plan.rank][1]

    def whole(self, n: int) -> int:
        """The whole count of something this rank holds n of in
        proportion to its block (tokens, elements)."""
        return n * self.size // (self.stop - self.start)

    def local(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of a whole (B, F, H, W, ...) tensor."""
        return t.narrow(self.dim, self.start, self.stop - self.start)

    def gather(self, t: torch.Tensor, dim: Optional[int] = None,
               unit: int = 1) -> torch.Tensor:
        """The whole tensor from every rank's block along `dim` (the
        split axis by default), each block `unit` entries a row or frame
        (the tokens of a flattened row)."""
        return self.plan.all_gather(
            t, self.dim if dim is None else dim,
            [(b - a) * unit for a, b in self.blocks])

    def all_reduce(self, t: torch.Tensor,
                   op=dist.ReduceOp.SUM) -> torch.Tensor:
        return self.plan.all_reduce(t, op)

    def halo(self, x: torch.Tensor, above: int, below: int,
             wrap: bool) -> torch.Tensor:
        """This rank's rows of x with `above` and `below` rows of halo."""
        return self.plan.halo(x, 2, self.blocks, self.size, above, below,
                              wrap)


def spatial_video_sharding(group=None) -> LatencyPlan:
    """Latency mode split by HEIGHT across `group` (None: the default
    group; without a process group a plan of one rank): pass it as
    GaussianDiffusion(sample_spatial_sharding=...). The world must divide
    image_size (96 = 12 rows x 8 ranks for the flagship)."""
    return LatencyPlan.of("height", group)


def frame_video_sharding(group=None) -> LatencyPlan:
    """Latency mode split by FRAMES across `group`: contiguous near-even
    blocks of frames; used as spatial_video_sharding is."""
    return LatencyPlan.of("frames", group)
