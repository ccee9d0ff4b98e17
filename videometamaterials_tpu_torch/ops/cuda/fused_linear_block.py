"""Whole spatial linear-attention block: stats, apply, head-layout and
backward kernel wrappers, their plain twins and the differentiable entry
point.

Replaces videometamaterials_tpu/ops/pallas/fused_linear_block.py:
_merged_stats_kernel and _merged_apply_kernel, and _kernel, the "head"
layout (csrc/fused_linear_block.cu, the apply's head mode after the
backward's stats pass; csrc/any_shape_bwd.cu off the flagship's shapes),
and both
backward kernels, _bwd_kernel (per-head) and _bwd_kernel_merged
(csrc/fused_linear_block_bwd.cu and csrc/any_linear_bwd.cu, each one source
with a clip flag); each source note gives the bounds and the design.
`fused_linear_block` is the JAX package's custom VJP as a
torch.autograd.Function: the forward of the
layout ('merged': stats + apply; 'head': the head-layout kernel) on the
primals, which are saved, and a backward that is autograd through the JAX
package's reference_linear_block ('recompute', the JAX default) or the
backward kernel ('kernel'), routed per-head or merged by the JAX rule
(`bwd_route`). VMT_LINEAR_LAYOUT picks the layout and
VMT_LINEAR_BWD_KERNEL=1 the backward kernel under 'recompute' too, read
where the JAX package reads them (fused_linear_block.py:569, :906).

    stats:  z[a] = sum_tok exp(clip(k, +-60))[a]
            ctx[h, a, e] = sum_tok bf16(exp(clip(k)))[h, a] * bf16(v / HW)[h, e]
            (the conditioning tokens counted once)
    apply:  out = x + out_bias + bf16(qn_h @ bf16(ctx_h)) @ W_out with
            qn = bf16(softmax_head(q) * scale / z) (per-head max shift)
    head:   out = bf16(x + out_bias + sum_h (softmax_d(q_h) scale)
                  (softmax_tok(k_h)^T v_h / HW) W_out_h), unclamped and
            max-shifted, float32 after the bf16 LN output (the kernel's
            products past q on the tensor cores to a bf16 hi + lo split)

Only the eight diagonal (32 x 32) blocks of the TPU kernel's masked
(256 x 256) context are computed: ctx is (B, heads, d, d).

Rows 4 and 5 (stats and apply), 6 and 7 (the backward) and 8 (the head
layout) have two instances each, picked from the shape alone
(`forward_instance`): the specialised kernels at the flagship's shapes (8
heads of 32, C in CHANNELS; any N and Mc) and the any-shape kernels
(csrc/any_shape.cu, csrc/any_shape_bwd.cu, csrc/any_linear_bwd.cu: any
heads, d up to 64, any N and Mc, C as far as the plans fit; rows 4-5
launch as `any_plan` says, rows 6-7 as `bwd_any_plan`) at every other.
"""

from __future__ import annotations

import functools
import os

import torch

from videometamaterials_tpu_torch.ops.attention import (
    linear_attention_tokens_first,
)
from videometamaterials_tpu_torch.ops.cuda import _build
from videometamaterials_tpu_torch.ops.norms import channel_layer_norm

K_CLAMP = 60.0
CHANNELS = (64, 128, 256, 512)
HEADS = 8
HIDDEN = 256
# tokens an apply block (the M of its tensor-core products); the stats
# tiles are multiples of it, walked in sub-tiles of 64
APPLY_TILE = 64
# the JAX _core_bwd route (fused_linear_block.py:580-586): the merged
# backward is untiled there, so it takes only shapes whose ~12 live
# (N, hidden) f32 arrays fit in 40 MiB; larger ones go per-head
ROUTE_BYTES = 40 * 2 ** 20
LAYOUTS = ("merged", "head")
# the instances of rows 4 and 5 (`forward_instance`)
SPECIALISED, ANY_SHAPE = "specialised", "any"
# the any-shape rows 4-5 (`any_plan`, csrc/any_shape.cu's lin_plan): d up
# to ANY_MAX_D; K-chunks of ANY_KC; at most ANY_MAX_COLS weight columns a
# chunk; 64 tokens a stats sub-tile; 3 to 6 ring stages; out-projection
# columns a warp at most ANY_WARP_COLS
ANY_MAX_D, ANY_KC, ANY_MAX_COLS, ANY_STAT_M = 64, 32, 256, 64
ANY_MIN_STAGES, ANY_MAX_STAGES, ANY_WARP_COLS = 3, 6, 64
# dynamic shared memory: what a block can ask, and what two blocks an SM
# leave each (the resident modes' limit)
MAX_SMEM, RES_SMEM = 232448, 115712
# blocks that keep an H100's 132 SMs busy: one a SM for the stats' head
# groups, two for the resident apply's span (of at most ANY_SPAN_TILES
# 64-token tiles); the streamed apply's largest token tile with
# ANY_APPLY_BLOCKS (each block reads all of W_q and W_out: smaller tiles
# read them more often)
ANY_GRID_BLOCKS, ANY_SPAN_BLOCKS, ANY_SPAN_TILES = 132, 264, 4
ANY_APPLY_BLOCKS = 3 * ANY_GRID_BLOCKS // 4


def stats_tile(n: int) -> int:
    """Tokens per block of the stats pass, a multiple of APPLY_TILE: large
    tiles keep the partials scratch small at full resolution, small ones
    give the low-resolution levels enough blocks."""
    return 256 if n >= 4096 else 64


def forward_instance(heads: int, dim_head: int, c: int) -> str:
    """The instance of rows 4-8 a launch at this shape takes: SPECIALISED
    (LAUNCH_COUNTS 'linear_stats', 'linear_apply', 'linear_bwd_head',
    'linear_bwd_merged', 'linear_head') at the flagship's shapes,
    ANY_SHAPE (the same names with '_any') at every other. A pure function
    of the shape."""
    if heads == HEADS and dim_head * heads == HIDDEN and c in CHANNELS:
        return SPECIALISED
    return ANY_SHAPE


@functools.lru_cache(maxsize=256)
def any_plan(bf: int, n: int, c: int, heads: int, d: int) -> dict:
    """The launch plan of the any-shape rows 4 and 5 at a shape, the mirror
    of csrc/any_shape.cu's lin_plan (vmt_linear_any_plan), which
    chip_smoke.py holds it to. Keys:
    - dp: d padded to k-steps of 16;
    - stats_tile (`stats_tile`), stats_group (heads a stats block: one or
      an even number, at most 128 k and 128 v columns, halved while the
      grid has fewer than ANY_GRID_BLOCKS blocks), stats_res (1: C <= 128
      and the weights and two sub-tiles of x rows stay in shared memory
      beside two blocks an SM), stats_stages (else the ring's stages: as
      many as fit two blocks an SM where the grid has more blocks than
      SMs, else one), stats_smem (bytes);
    - apply_tile (tokens a pass), apply_span (tokens a block), apply_group
      (heads a q pass), apply_res, apply_stages, apply_smem. The resident
      apply takes every head in one q pass (at most 64 q columns a warp)
      and every column in one out-projection block, 64-token passes, up to
      ANY_SPAN_TILES a block while the grid keeps ANY_SPAN_BLOCKS blocks;
      the streamed apply takes the largest of 64, 32, 16 tokens whose oh
      tile of heads x dp columns fits and whose grid has ANY_APPLY_BLOCKS
      blocks, else the smallest that fits.
    C streams through both in K-chunks. Raises ValueError where no plan
    takes the shape (d > ANY_MAX_D)."""
    if min(bf, n, c, heads, d) <= 0:
        raise ValueError(f"no any-shape plan for {(bf, n, c, heads, d)}")
    if d > ANY_MAX_D:
        raise ValueError(f"the any-shape stats and apply take d up to "
                         f"{ANY_MAX_D}, got {d}")
    dp = -(-d // 16) * 16
    nkc = -(-c // ANY_KC)
    xchunk = lambda rows: rows * (ANY_KC + 8) * 2        # bytes

    def stage(rows, wp):
        return xchunk(rows) + ANY_KC * 4 + ANY_KC * wp * 2

    def stages(smem, limit):
        s = ANY_MIN_STAGES
        while s < ANY_MAX_STAGES and smem(s + 1) <= limit:
            s += 1
        return s

    def stats_smem(group, res, s):
        half = group * dp
        wp = 2 * half + 8
        tail = ANY_STAT_M * wp * 2 + 4 * half * 4 + ANY_STAT_M * 8
        if res:
            return (nkc * ANY_KC * (wp * 2 + 4) + 2 * nkc * xchunk(ANY_STAT_M)
                    + tail)
        return s * stage(ANY_STAT_M, wp) + tail

    hpk = -(-heads * dp // ANY_KC) * ANY_KC

    def wc_of(tile):
        """The out-projection's columns a warp."""
        parts = 8 // (tile // 16)
        per = -(-c // parts)
        return min(-(-per // 16) * 16, ANY_MAX_COLS // parts, ANY_WARP_COLS)

    def apply_smem(tile, ga, res, s):
        parts = 8 // (tile // 16)
        cb = parts * wc_of(tile)
        tail = (ga * dp * (dp + 8) * 2 + ga * dp * 4 + tile * 8
                + tile * (hpk + 8) * 2)
        if res:
            return (nkc * ANY_KC * ((ga * dp + 8) * 2 + 4) + hpk * (cb + 8) * 2
                    + 3 * nkc * xchunk(tile) + tail)
        return s * stage(tile, max(ga * dp, cb) + 8) + tail

    tile = stats_tile(n)
    # one head or an even number: a column half of the block holds the k
    # and v of half the group's heads
    even = lambda g: g - 1 if g > 1 and g % 2 else g
    group = even(min(heads, 128 // dp))
    blocks = lambda g: -(-n // tile) * -(-heads // g) * bf
    while group > 1 and blocks(group) < ANY_GRID_BLOCKS:
        group = even(group // 2)
    res = int(c <= 128 and stats_smem(group, True, 0) <= RES_SMEM)
    limit = RES_SMEM if blocks(group) > ANY_GRID_BLOCKS else MAX_SMEM
    s = 0 if res else stages(lambda k: stats_smem(group, False, k), limit)
    plan = dict(dp=dp, stats_tile=tile, stats_group=group, stats_res=res,
                stats_stages=s, stats_smem=stats_smem(group, res, s))
    ga = min(heads, 2 * (64 // dp))
    if (ga == heads and 2 * wc_of(64) >= c
            and apply_smem(64, ga, True, 0) <= RES_SMEM):
        span = ANY_SPAN_TILES
        while span > 1 and -(-n // (64 * span)) * bf < ANY_SPAN_BLOCKS:
            span //= 2
        return dict(plan, apply_tile=64, apply_span=64 * span,
                    apply_group=ga, apply_res=1, apply_stages=0,
                    apply_smem=apply_smem(64, ga, True, 0))
    apply = None
    for tile in (64, 32, 16):
        parts = 8 // (tile // 16)
        ga = min(parts * (128 // dp), ANY_MAX_COLS // dp, heads)
        if apply_smem(tile, ga, False, ANY_MIN_STAGES) > MAX_SMEM:
            continue
        nblocks = -(-n // tile) * bf
        s = stages(lambda k: apply_smem(tile, ga, False, k),
                   RES_SMEM if nblocks > ANY_GRID_BLOCKS else MAX_SMEM)
        apply = dict(apply_tile=tile, apply_span=tile, apply_group=ga,
                     apply_res=0, apply_stages=s,
                     apply_smem=apply_smem(tile, ga, False, s))
        if nblocks >= ANY_APPLY_BLOCKS:
            break
    if apply is None:
        raise ValueError(f"no any-shape apply plan fits {heads} heads of {d}")
    return dict(plan, **apply)


@functools.lru_cache(maxsize=256)
def head_any_plan(bf: int, n: int, c: int, heads: int, d: int) -> dict:
    """The launch plan of the any-shape row 8 (the head layout) at a shape,
    the mirror of csrc/any_linear_head.cu's head_plan
    (vmt_linear_head_any_plan), which chip_smoke.py holds it to. Keys:
    - dp: d padded to k-steps of 16;
    - stats_tile (`stats_tile`), stats_group (heads a stats block: one or
      an even number, at most 128 k and 128 v columns, halved while the
      grid has fewer than ANY_GRID_BLOCKS blocks, then while neither mode
      fits), stats_res (1: C <= 128 and the weights and two sub-tiles of x
      rows stay in shared memory beside two blocks an SM), stats_stages
      (else the ring's stages: as many as fit two blocks an SM where the
      grid has more blocks than SMs, else one), stats_smem (bytes; the
      P || v tiles as bf16 hi and lo, one part of the group at a time);
    - apply_tile, apply_span, apply_group, apply_res, apply_stages,
      apply_smem as `any_plan`'s (the resident apply's oh hi and lo tiles
      over its spent y tile), but where the grid of 64-token tiles has
      more than ANY_GRID_BLOCKS blocks the streamed apply takes the
      largest token tile, then head group (halved), that fits two blocks
      an SM; and apply_ohg: 1 where the streamed apply's oh tiles of every
      head (heads x dp columns, hi and lo) fit no token tile, so they hold
      one head group at a time;
    - workspace: the bytes of vmt_linear_head_any_workspace, the stats'
      partials m, z (bf, tiles, heads d) and ctx (bf, tiles, heads, d, d)
      float32 and ctxn's hi and lo blocks (bf, heads, 2, dp, dp + 8) bf16,
      each rounded up to 256 bytes.
    Raises ValueError at d > ANY_MAX_D and at no other shape."""
    if min(bf, n, c, heads, d) <= 0:
        raise ValueError(f"no any-shape head plan for {(bf, n, c, heads, d)}")
    if d > ANY_MAX_D:
        raise ValueError(f"the any-shape head layout takes d up to "
                         f"{ANY_MAX_D}, got {d}")
    dp = -(-d // 16) * 16
    nkc = -(-c // ANY_KC)
    xchunk = lambda rows: rows * (ANY_KC + 8) * 2        # bytes
    r32 = lambda v: -(-v // ANY_KC) * ANY_KC
    hpk = r32(heads * dp)

    def stage(rows, wp):
        return xchunk(rows) + ANY_KC * 4 + ANY_KC * wp * 2

    def stages(smem, limit):
        s = ANY_MIN_STAGES
        while s < ANY_MAX_STAGES and smem(s + 1) <= limit:
            s += 1
        return s

    def stats_smem(group, res, s):
        half = group * dp
        wp = 2 * half + 8
        pitch = (2 if group == 1 else group) * dp + 8    # one part's P || v
        tail = 2 * ANY_STAT_M * pitch * 2 + 11 * half * 4 + ANY_STAT_M * 8
        if res:
            return (nkc * ANY_KC * (wp * 2 + 4) + 2 * nkc * xchunk(ANY_STAT_M)
                    + tail)
        return s * stage(ANY_STAT_M, wp) + tail

    def wc_of(tile):
        """The out-projection's columns a warp."""
        parts = 8 // (tile // 16)
        per = -(-c // parts)
        return min(-(-per // 16) * 16, ANY_MAX_COLS // parts, ANY_WARP_COLS)

    def apply_smem(tile, ga, res, s, ohw):
        cb = 8 // (tile // 16) * wc_of(tile)
        common = ga * 2 * dp * (dp + 8) * 2 + tile * 8
        if res:
            return (nkc * ANY_KC * ((ga * dp + 8) * 2 + 4) + hpk * (cb + 8) * 2
                    + 2 * nkc * xchunk(tile)
                    + max(nkc * xchunk(tile), 2 * tile * (hpk + 8) * 2)
                    + common)
        return (s * stage(tile, max(ga * dp, cb) + 8)
                + 2 * tile * (ohw + 8) * 2 + common)

    tile = stats_tile(n)
    even = lambda g: g - 1 if g > 1 and g % 2 else g
    sblocks = lambda g: -(-n // tile) * -(-heads // g) * bf
    slimit = lambda g: RES_SMEM if sblocks(g) > ANY_GRID_BLOCKS else MAX_SMEM
    res_fits = lambda g: c <= 128 and stats_smem(g, True, 0) <= RES_SMEM
    group = even(min(heads, 128 // dp))
    while group > 1 and sblocks(group) < ANY_GRID_BLOCKS:
        group = even(group // 2)
    while (group > 1 and not res_fits(group)
           and stats_smem(group, False, ANY_MIN_STAGES) > slimit(group)):
        group = even(group // 2)
    res = int(res_fits(group))
    s = 0 if res else stages(lambda k: stats_smem(group, False, k),
                             slimit(group))
    tiles = -(-n // tile)
    a256 = lambda v: -(-v // 256) * 256
    parts = bf * tiles * heads
    plan = dict(dp=dp, stats_tile=tile, stats_group=group, stats_res=res,
                stats_stages=s, stats_smem=stats_smem(group, res, s),
                workspace=(2 * a256(parts * d * 4) + a256(parts * d * d * 4)
                           + a256(bf * heads * 2 * dp * (dp + 8) * 2)))
    ga = min(heads, 2 * (64 // dp))
    if (ga == heads and 2 * wc_of(64) >= c
            and apply_smem(64, ga, True, 0, hpk) <= RES_SMEM):
        span = ANY_SPAN_TILES
        while span > 1 and -(-n // (64 * span)) * bf < ANY_SPAN_BLOCKS:
            span //= 2
        return dict(plan, apply_tile=64, apply_span=64 * span,
                    apply_group=ga, apply_res=1, apply_stages=0,
                    apply_smem=apply_smem(64, ga, True, 0, hpk), apply_ohg=0)
    many = -(-n // 64) * bf > ANY_GRID_BLOCKS
    for ohg in (0, 1):
        for tile in (64, 32, 16) if many else ():
            parts = 8 // (tile // 16)
            g = min(parts * (128 // dp), ANY_MAX_COLS // dp, heads)
            while True:
                ohw = r32(g * dp) if ohg else hpk
                if apply_smem(tile, g, False, ANY_MIN_STAGES, ohw) <= RES_SMEM:
                    s = stages(lambda k: apply_smem(tile, g, False, k, ohw),
                               RES_SMEM)
                    return dict(plan, apply_tile=tile, apply_span=tile,
                                apply_group=g, apply_res=0, apply_stages=s,
                                apply_smem=apply_smem(tile, g, False, s, ohw),
                                apply_ohg=ohg)
                if g == 1:
                    break
                g = -(-g // 2)
        apply = None
        for tile in (64, 32, 16):
            parts = 8 // (tile // 16)
            ga = min(parts * (128 // dp), ANY_MAX_COLS // dp, heads)
            ohw = r32(ga * dp) if ohg else hpk
            if apply_smem(tile, ga, False, ANY_MIN_STAGES, ohw) > MAX_SMEM:
                continue
            nblocks = -(-n // tile) * bf
            s = stages(lambda k: apply_smem(tile, ga, False, k, ohw),
                       RES_SMEM if nblocks > ANY_GRID_BLOCKS else MAX_SMEM)
            apply = dict(apply_tile=tile, apply_span=tile, apply_group=ga,
                         apply_res=0, apply_stages=s,
                         apply_smem=apply_smem(tile, ga, False, s, ohw),
                         apply_ohg=ohg)
            if nblocks >= ANY_APPLY_BLOCKS:
                break
        if apply is not None:
            return dict(plan, **apply)
    raise AssertionError("the oh tiles of one head group fit every shape")


# the any-shape rows 6-7 (`bwd_any_plan`, csrc/any_linear_bwd.cu's
# bwd_plan): two warps a head and row group; pass 1 in 64-token sub-tiles
# of a tile of BWD_SUM_TILES tokens, a head a block; pass 2 in tiles of 64,
# 32 or 16 tokens and head groups of at most BWD_GROUP_COLS padded columns;
# after a streamed pass 2, pass 3 (dy and the LN backward)
BWD_SUM_TILES, BWD_GROUP_COLS = (1024, 256), 128
# pass 3 (after a streamed pass 2): 256-channel tiles, 64 dqkv columns a
# ring stage
BWD_DX_N, BWD_DX_K = 256, 64
# the dqkv columns (3 heads d, padded to BWD_DX_K) pass 3 takes: its rows
# of 16 tokens and the ring beside them within MAX_SMEM
BWD_MAX_DQKV = 3456


@functools.lru_cache(maxsize=256)
def bwd_any_plan(bf: int, n: int, c: int, heads: int, d: int) -> dict:
    """The launch plan of the any-shape rows 6 and 7 at a shape, the mirror
    of csrc/any_linear_bwd.cu's bwd_plan (vmt_linear_bwd_any_plan), which
    chip_smoke.py holds it to. Keys:
    - dp: d padded to k-steps of 16;
    - sums_tile (tokens a pass-1 block, in 64-token sub-tiles; resident:
      the largest of BWD_SUM_TILES whose grid of tiles x heads x BF has
      two blocks an SM, else 64; streamed: the smallest of 64 and
      BWD_SUM_TILES that takes a frame in at most 9 tiles), sums_res (1:
      C <= 128 and the weights and two sub-tiles of x and g stay in shared
      memory beside two blocks an SM), sums_stages (else the ring's
      stages: as many as fit two blocks an SM where the grid has more
      blocks than SMs, else one), sums_smem (bytes);
    - tok_rows (tokens a pass-2 block), tok_group (heads a group: two
      warps a head), tok_res, tok_stages, tok_smem: resident (64 rows, a
      head a group; two groups' weights and context blocks, the next
      group's arriving during this one's work) where C <= 128 and it fits;
      else streamed at the rows of 64, 32, 16, with the full group
      (min(64 // rows, BWD_GROUP_COLS // dp) heads), that fits with the
      least ceil(blocks / (SMs x blocks an SM)) x (rows + 8), the first on
      ties, dy left to pass 3;
    - dx_rows, dx_stages, dx_smem: pass 3 after a streamed pass 2 (the
      tile's dqkv rows resident, W_qkv in BWD_DX_N x BWD_DX_K stages; its
      token tile by the same rule), else 0.
    Raises ValueError where no plan takes the shape (d > ANY_MAX_D, or a
    3 x heads x d whose dqkv rows of 16 tokens leave pass 3 no room)."""
    if min(bf, n, c, heads, d) <= 0:
        raise ValueError(f"no any-shape backward plan for "
                         f"{(bf, n, c, heads, d)}")
    if d > ANY_MAX_D:
        raise ValueError(f"the any-shape backward takes d up to "
                         f"{ANY_MAX_D}, got {d}")
    dp = -(-d // 16) * 16
    nkc = -(-c // ANY_KC)
    xchunk = ANY_KC + 8                                  # bf16 a row

    def stage(rows, wp):
        return 2 * rows * xchunk * 2 + ANY_KC * 4 + ANY_KC * wp * 2

    def stages(smem, limit):
        s = ANY_MIN_STAGES
        while s < ANY_MAX_STAGES and smem(s + 1) <= limit:
            s += 1
        return s

    def sums_smem(res, s):
        wp = 4 * dp + 8
        tail = ANY_STAT_M * wp * 2 + 11 * dp * 4 + 2 * ANY_STAT_M * 4
        if res:
            return (nkc * ANY_KC * (wp * 2 + 4)
                    + 4 * nkc * ANY_STAT_M * xchunk * 2 + tail)
        return s * stage(ANY_STAT_M, wp) + tail

    def tok_smem(rows, g, res, s):
        wp = 4 * g * dp + 8
        nbuf = 2 if res else 1
        tail = ((rows * (nkc * ANY_KC + 4) * 4 if res else 0)
                + rows * (3 * g * dp + 8) * 2
                + rows * (g * dp + 8) * 2
                + nbuf * (g * 2 * dp * (dp + 8) * 2 + 3 * g * dp * 4)
                + 2 * rows * 4)
        if res:
            return (nbuf * nkc * ANY_KC * wp * 2 + nkc * ANY_KC * 4
                    + 2 * nkc * rows * xchunk * 2 + tail)
        return s * stage(rows, wp) + tail

    sblocks = lambda t: -(-n // t) * heads * bf
    res = int(c <= 128 and sums_smem(True, 0) <= RES_SMEM)
    if res:
        tile = next((t for t in BWD_SUM_TILES
                     if sblocks(t) >= 2 * ANY_GRID_BLOCKS), ANY_STAT_M)
    else:
        tile = next((t for t in (ANY_STAT_M, *BWD_SUM_TILES[::-1])
                     if -(-n // t) <= 9), BWD_SUM_TILES[0])
    limit = RES_SMEM if sblocks(tile) > ANY_GRID_BLOCKS else MAX_SMEM
    s = 0 if res else stages(lambda k: sums_smem(False, k), limit)
    plan = dict(dp=dp, sums_tile=tile, sums_res=res, sums_stages=s,
                sums_smem=sums_smem(res, s))
    if plan["sums_smem"] > MAX_SMEM:
        raise ValueError(f"no any-shape backward plan fits C = {c}")
    gmax = lambda m: min(64 // m, BWD_GROUP_COLS // dp)

    def pick(smem):
        """The token tile (64, 32, 16) of the least waves x (rows + 8) whose
        smem(rows) at ANY_MIN_STAGES stages fits (ties: the first), and its
        stages' limit."""
        best = None
        for m in (64, 32, 16):
            sm = smem(m)
            if sm > MAX_SMEM:
                continue
            bps = 2 if sm <= RES_SMEM else 1
            cost = -(-(-(-n // m) * bf) // (ANY_GRID_BLOCKS * bps)) * (m + 8)
            if best is None or cost < best[0]:
                best = (cost, m, RES_SMEM if bps == 2 else MAX_SMEM)
        return best[1:] if best else (0, MAX_SMEM)

    if c <= 128 and tok_smem(64, 1, True, 0) <= MAX_SMEM:
        r, m, g, s = 1, 64, 1, 0
    else:
        m, lim = pick(lambda k: tok_smem(k, gmax(k), False, ANY_MIN_STAGES))
        r, g = 0, gmax(m)
        s = stages(lambda k: tok_smem(m, g, False, k), lim)
    plan = dict(plan, tok_rows=m, tok_group=g, tok_res=r, tok_stages=s,
                tok_smem=tok_smem(m, g, r, s), dx_rows=0, dx_stages=0,
                dx_smem=0)
    if r:
        return plan
    kp = -(-3 * heads * d // BWD_DX_K) * BWD_DX_K

    def dx_smem(rows, s):
        return (rows * (kp + 8) * 2 + s * BWD_DX_N * (BWD_DX_K + 8) * 2
                + (4 * rows + 8 * rows * 2 + 4 * 2 * BWD_DX_N) * 4)

    m3, lim3 = pick(lambda k: dx_smem(k, ANY_MIN_STAGES))
    if not m3:
        raise ValueError(f"the any-shape backward's pass 3 takes 3 x heads "
                         f"x d up to {BWD_MAX_DQKV} dqkv columns (padded to "
                         f"{BWD_DX_K}), got {3 * heads * d}")
    s3 = stages(lambda k: dx_smem(m3, k), lim3)
    return dict(plan, dx_rows=m3, dx_stages=s3, dx_smem=dx_smem(m3, s3))


def _instance(x, w_qkv, heads: int) -> str:
    return forward_instance(heads, w_qkv.shape[1] // (3 * heads), x.shape[-1])


def _stats_terms(x, gamma, w_qkv, ek, ev, *, heads: int, spatial_size: int):
    """The stats' summands: bf16(exp(clip(k))) and bf16(v / HW), each
    (B, N + Mc, heads, d) over the tokens and then the conditioning tokens,
    and exp(clip(k)) unrounded (B, N + Mc, hidden). Roundings follow x's
    dtype."""
    b = x.shape[0]
    hidden = w_qkv.shape[1] // 3
    cdt = x.dtype
    y = channel_layer_norm(x, gamma, one_pass=False).to(cdt)
    kv = y.float() @ w_qkv[:, hidden:].float()
    k, v = kv[..., :hidden], kv[..., hidden:]
    if ek is not None:
        k = torch.cat([k, ek.float()], dim=1)
        v = torch.cat([v, ev.float()], dim=1)
    pk = torch.exp(k.clamp(-K_CLAMP, K_CLAMP))
    v = (v * (1.0 / spatial_size)).to(cdt).float()
    return (pk.to(cdt).float().reshape(b, -1, heads, hidden // heads),
            v.reshape(b, -1, heads, hidden // heads), pk)


def linear_stats_plain(x, gamma, w_qkv, ek, ev, *, heads: int,
                       spatial_size: int):
    """Plain twin of the stats kernel. x: (B, N, C); w_qkv (C, 3*hidden);
    ek/ev (B, Mc, hidden) or None. Returns ctx (B, heads, d, d) and
    z (B, hidden), float32. Roundings follow x's dtype."""
    pk_r, v, pk = _stats_terms(x, gamma, w_qkv, ek, ev, heads=heads,
                               spatial_size=spatial_size)
    return torch.einsum("bnha,bnhe->bhae", pk_r, v), pk.sum(dim=1)


def linear_stats_magnitude(x, gamma, w_qkv, ek, ev, *, heads: int,
                           spatial_size: int) -> torch.Tensor:
    """sum_tok |bf16(exp(clip(k)))| * |bf16(v / HW)|, (B, heads, d, d): the
    scale of ctx's summands. The kernel's and the twin's f32 projections
    differ in summation order, so a summand's factor near a bf16 rounding
    boundary can round one ulp (2^-7 of it) apart; ctx then differs by a
    share of this, not of |ctx|, which cancellation can make small."""
    pk_r, v, _ = _stats_terms(x, gamma, w_qkv, ek, ev, heads=heads,
                              spatial_size=spatial_size)
    return torch.einsum("bnha,bnhe->bhae", pk_r, v.abs())


def linear_apply_plain(x, gamma, w_qkv, w_out, out_bias, ctx, z, *,
                       heads: int, scale: float) -> torch.Tensor:
    """Plain twin of the apply kernel; returns x + block(x) in x's dtype."""
    b, n, c = x.shape
    hidden = w_out.shape[0]
    d = hidden // heads
    cdt = x.dtype
    y = channel_layer_norm(x, gamma, one_pass=False).to(cdt)
    q = (y.float() @ w_qkv[:, :hidden].float()).reshape(b, n, heads, d)
    e = torch.exp(q - q.amax(dim=-1, keepdim=True))
    brd = scale / e.sum(dim=-1, keepdim=True)
    qn = ((e * brd).reshape(b, n, hidden) * (1.0 / z)[:, None, :]).to(cdt)
    oh = torch.einsum("bnha,bhae->bnhe", qn.float().reshape(b, n, heads, d),
                      ctx.to(cdt).float())
    oh = oh.to(cdt).float().reshape(b, n, hidden)
    out = x.float() + out_bias.float() + oh @ w_out.float()
    return out.to(x.dtype)


def linear_block_plain(x, gamma, w_qkv, w_out, out_bias, ek, ev, *,
                       heads: int, scale: float, spatial_size: int):
    ctx, z = linear_stats_plain(x, gamma, w_qkv, ek, ev, heads=heads,
                                spatial_size=spatial_size)
    return linear_apply_plain(x, gamma, w_qkv, w_out, out_bias, ctx, z,
                              heads=heads, scale=scale)


def _check_common(x, gamma, w_qkv, heads) -> tuple[int, int]:
    """x, gamma and w_qkv of a launch (the instance comes from the shape,
    `forward_instance`). Returns (hidden, d)."""
    req = _build.require
    req(x.is_cuda, "the kernels take CUDA tensors")
    req(x.dtype == torch.bfloat16 and x.dim() == 3 and x.is_contiguous(),
        "x must be contiguous bf16 (B, N, C)")
    c = x.shape[2]
    hidden = w_qkv.shape[1] // 3
    req(heads > 0 and hidden > 0 and hidden % heads == 0,
        f"hidden {hidden} is not a multiple of {heads} heads")
    req(gamma.dtype == torch.float32 and tuple(gamma.shape) == (c,)
        and gamma.is_contiguous(), "gamma must be contiguous float32 (C,)")
    req(w_qkv.dtype == torch.bfloat16 and w_qkv.is_contiguous()
        and tuple(w_qkv.shape) == (c, 3 * hidden),
        "w_qkv must be contiguous bf16 (C, 3*hidden)")
    for t in (gamma, w_qkv):
        req(t.device == x.device, "all operands on x's device")
    return hidden, hidden // heads


def _check_cond(ek, ev, x, hidden: int = HIDDEN) -> int:
    """Check the conditioning K/V of a kernel launch; returns Mc."""
    req = _build.require
    req((ek is None) == (ev is None), "ek and ev come together")
    if ek is None:
        return 0
    for t in (ek, ev):
        req(t.dtype == torch.bfloat16 and t.is_contiguous()
            and tuple(t.shape) == (x.shape[0], ek.shape[1], hidden)
            and t.device == x.device,
            "ek/ev must be contiguous bf16 (B, Mc, hidden) on x's device")
    return ek.shape[1]


def linear_stats(x, gamma, w_qkv, ek, ev, *, heads: int, spatial_size: int):
    """(ctx, z) of the block. A CPU tensor takes the plain twin; a CUDA
    tensor launches the instance `forward_instance` names (partials pass +
    ordered reduce) or raises."""
    if x.device.type == "cpu":
        return linear_stats_plain(x, gamma, w_qkv, ek, ev, heads=heads,
                                  spatial_size=spatial_size)
    if _instance(x, w_qkv, heads) == ANY_SHAPE:
        return _stats_any(x, gamma, w_qkv, ek, ev, heads=heads,
                          spatial_size=spatial_size)
    _check_common(x, gamma, w_qkv, heads)
    b, n, c = x.shape
    m_c = _check_cond(ek, ev, x)
    _build.require_aligned(x, w_qkv)
    tile = stats_tile(n)
    n_tiles = -(-n // tile)
    f32 = dict(dtype=torch.float32, device=x.device)
    part_ctx = torch.empty((b, n_tiles, 32, HIDDEN), **f32)
    part_z = torch.empty((b, n_tiles, HIDDEN), **f32)
    ctx = torch.empty((b, HEADS, 32, 32), **f32)
    z = torch.empty((b, HIDDEN), **f32)
    lib = _build.load_library()
    p = _build.ptr
    err = lib.vmt_linear_stats(
        p(x), p(gamma), p(w_qkv), p(ek), p(ev), p(part_ctx), p(part_z),
        p(ctx), p(z), b, n, c, m_c, heads, tile, 1.0 / spatial_size,
        _build.stream_handle(x.device))
    _build.check_launch(lib, err, "linear_stats")
    _build.LAUNCH_COUNTS["linear_stats"] += 1
    return ctx, z


def linear_apply(x, gamma, w_qkv, w_out, out_bias, ctx, z, *, heads: int,
                 scale: float) -> torch.Tensor:
    """x + block(x) from the stats. A CPU tensor takes the plain twin; a
    CUDA tensor launches the instance `forward_instance` names or
    raises."""
    if x.device.type == "cpu":
        return linear_apply_plain(x, gamma, w_qkv, w_out, out_bias, ctx, z,
                                  heads=heads, scale=scale)
    if _instance(x, w_qkv, heads) == ANY_SHAPE:
        return _apply_any(x, gamma, w_qkv, w_out, out_bias, ctx, z,
                          heads=heads, scale=scale)
    _check_common(x, gamma, w_qkv, heads)
    b, n, c = x.shape
    req = _build.require
    req(w_out.dtype == torch.bfloat16 and w_out.is_contiguous()
        and tuple(w_out.shape) == (HIDDEN, c),
        "w_out must be contiguous bf16 (hidden, C)")
    req(out_bias.dtype == torch.float32 and out_bias.is_contiguous()
        and tuple(out_bias.shape) == (c,), "out_bias must be float32 (C,)")
    req(ctx.dtype == torch.float32 and ctx.is_contiguous()
        and tuple(ctx.shape) == (b, HEADS, 32, 32),
        "ctx must be contiguous float32 (B, heads, d, d)")
    req(z.dtype == torch.float32 and z.is_contiguous()
        and tuple(z.shape) == (b, HIDDEN), "z must be float32 (B, hidden)")
    for t in (w_out, out_bias, ctx, z):
        req(t.device == x.device, "all operands on x's device")
    _build.require_aligned(x, w_qkv, w_out, out_bias, ctx, z)
    out = torch.empty_like(x)
    lib = _build.load_library()
    p = _build.ptr
    err = lib.vmt_linear_apply(
        p(x), p(gamma), p(w_qkv), p(w_out), p(out_bias), p(ctx), p(z),
        p(out), b, n, c, heads, APPLY_TILE, scale,
        _build.stream_handle(x.device))
    _build.check_launch(lib, err, "linear_apply")
    _build.LAUNCH_COUNTS["linear_apply"] += 1
    return out


def _stats_any(x, gamma, w_qkv, ek, ev, *, heads: int, spatial_size: int):
    """Row 4 through the any-shape kernel (csrc/any_shape.cu): LN, k || v
    and the tile's ctx and z in one kernel on the tensor cores, partial
    sums over `any_plan`'s stats tiles, then the ordered reduce; only the
    partials are scratch, allocated here."""
    hidden, d = _check_common(x, gamma, w_qkv, heads)
    b, n, c = x.shape
    plan = any_plan(b, n, c, heads, d)
    m_c = _check_cond(ek, ev, x, hidden)
    tiles = -(-n // plan["stats_tile"])
    f32 = dict(dtype=torch.float32, device=x.device)
    part_ctx = torch.empty((b, tiles, heads, d, d), **f32)
    part_z = torch.empty((b, tiles, hidden), **f32)
    ctx = torch.empty((b, heads, d, d), **f32)
    z = torch.empty((b, hidden), **f32)
    lib = _build.load_library()
    p = _build.ptr
    err = lib.vmt_linear_stats_any(
        p(x), p(gamma), p(w_qkv), p(ek), p(ev), p(part_ctx), p(part_z),
        p(ctx), p(z), b, n, c, m_c, heads, d, plan["stats_tile"],
        1.0 / spatial_size, _build.stream_handle(x.device))
    _build.check_launch(lib, err, "linear_stats_any")
    _build.LAUNCH_COUNTS["linear_stats_any"] += 1
    return ctx, z


def _apply_any(x, gamma, w_qkv, w_out, out_bias, ctx, z, *, heads: int,
               scale: float):
    """Row 5 through the any-shape kernel (csrc/any_shape.cu): LN, q, the
    per-head softmax, q ctx, the out-projection with out_bias and the
    residual in one kernel on the tensor cores, without scratch."""
    hidden, d = _check_common(x, gamma, w_qkv, heads)
    b, n, c = x.shape
    any_plan(b, n, c, heads, d)
    req = _build.require
    req(w_out.dtype == torch.bfloat16 and w_out.is_contiguous()
        and tuple(w_out.shape) == (hidden, c),
        "w_out must be contiguous bf16 (hidden, C)")
    req(out_bias.dtype == torch.float32 and out_bias.is_contiguous()
        and tuple(out_bias.shape) == (c,), "out_bias must be float32 (C,)")
    req(ctx.dtype == torch.float32 and ctx.is_contiguous()
        and tuple(ctx.shape) == (b, heads, d, d),
        "ctx must be contiguous float32 (B, heads, d, d)")
    req(z.dtype == torch.float32 and z.is_contiguous()
        and tuple(z.shape) == (b, hidden), "z must be float32 (B, hidden)")
    for t in (w_out, out_bias, ctx, z):
        req(t.device == x.device, "all operands on x's device")
    out = torch.empty_like(x)
    lib = _build.load_library()
    p = _build.ptr
    err = lib.vmt_linear_apply_any(
        p(x), p(gamma), p(w_qkv), p(w_out), p(out_bias), p(ctx), p(z),
        p(out), b, n, c, heads, d, scale, _build.stream_handle(x.device))
    _build.check_launch(lib, err, "linear_apply_any")
    _build.LAUNCH_COUNTS["linear_apply_any"] += 1
    return out


def linear_block_fwd(x, gamma, w_qkv, w_out, out_bias, ek, ev, *,
                     heads: int, scale: float, spatial_size: int):
    """x: (B, N, C) with frames folded into B; w_qkv (C, 3*hidden);
    w_out (hidden, C); out_bias (C,); ek/ev (B, Mc, hidden) or None.
    Returns x + block(x): the stats and apply kernels (their twins on a CPU
    tensor)."""
    ctx, z = linear_stats(x, gamma, w_qkv, ek, ev, heads=heads,
                          spatial_size=spatial_size)
    return linear_apply(x, gamma, w_qkv, w_out, out_bias, ctx, z,
                        heads=heads, scale=scale)


def linear_block_head_plain(x, gamma, w_qkv, w_out, out_bias, ek, ev, *,
                            heads: int, scale: float, spatial_size: int):
    """Plain twin of the head-layout kernel (the JAX _kernel, :336-411):
    y = LN(x) gamma (two-pass) rounded to x's dtype; then float32
    throughout: q, k, v from w_qkv rounded to x's dtype, the q feature
    softmax times scale, the token softmax over [cond || tokens] max-shifted
    and unclamped, ctx = pk^T (v / HW) per head, oh = q ctx, and
    x + out_bias + oh @ W_out with W_out as given (float32 there); one
    rounding to x's dtype at the end."""
    b, n, _ = x.shape
    hidden = w_out.shape[0]
    d = hidden // heads
    y = channel_layer_norm(x, gamma, one_pass=False).to(x.dtype).float()
    q, k, v = (y @ w_qkv.to(x.dtype).float()).split(hidden, dim=-1)
    q = q.reshape(b, n, heads, d)
    q = torch.exp(q - q.amax(dim=-1, keepdim=True))
    q = q * (scale / q.sum(dim=-1, keepdim=True))
    if ek is not None:
        k = torch.cat([ek.float(), k], dim=1)
        v = torch.cat([ev.float(), v], dim=1)
    m = k.shape[1]
    k = k.reshape(b, m, heads, d)
    pk = torch.exp(k - k.amax(dim=1, keepdim=True))
    pk = pk / pk.sum(dim=1, keepdim=True)
    ctx = torch.einsum("bmha,bmhe->bhae", pk,
                       v.reshape(b, m, heads, d) * (1.0 / spatial_size))
    oh = torch.einsum("bnha,bhae->bnhe", q, ctx).reshape(b, n, hidden)
    out = x.float() + out_bias.float() + oh @ w_out.float()
    return out.to(x.dtype)


def linear_block_head(x, gamma, w_qkv, w_out, out_bias, ek, ev, *,
                      heads: int, scale: float, spatial_size: int):
    """x + block(x) through the head-layout kernel (its operands as
    linear_block_fwd's). A CPU tensor takes the plain twin; a CUDA tensor
    launches the instance `forward_instance` names (online-max stats,
    ordered merge, apply) or raises. W_out is bf16 here: the JAX model
    hands its kernel a weight cast to the compute dtype, which it then
    reads in float32; the kernel's out-projection takes those bf16 values
    exactly against the hi and lo bf16 parts of the float32 oh."""
    if x.device.type == "cpu":
        return linear_block_head_plain(x, gamma, w_qkv, w_out, out_bias, ek,
                                       ev, heads=heads, scale=scale,
                                       spatial_size=spatial_size)
    if _instance(x, w_qkv, heads) == ANY_SHAPE:
        return _head_any(x, gamma, w_qkv, w_out, out_bias, ek, ev,
                         heads=heads, scale=scale, spatial_size=spatial_size)
    _check_common(x, gamma, w_qkv, heads)
    b, n, c = x.shape
    req = _build.require
    req(w_out.dtype == torch.bfloat16 and w_out.is_contiguous()
        and tuple(w_out.shape) == (HIDDEN, c) and w_out.device == x.device,
        "w_out must be contiguous bf16 (hidden, C)")
    req(out_bias.dtype == torch.float32 and out_bias.is_contiguous()
        and tuple(out_bias.shape) == (c,) and out_bias.device == x.device,
        "out_bias must be float32 (C,)")
    m_c = _check_cond(ek, ev, x)
    _build.require_aligned(x, w_qkv, w_out, out_bias, ek, ev)
    lib = _build.load_library()
    out = torch.empty_like(x)
    ws = _build.workspace(lib.vmt_linear_head_workspace(b, n), x.device)
    p = _build.ptr
    err = lib.vmt_linear_head(
        p(x), p(gamma), p(w_qkv), p(w_out), p(out_bias), p(ek), p(ev),
        p(out), p(ws), b, n, c, m_c, heads, APPLY_TILE, scale,
        1.0 / spatial_size, _build.stream_handle(x.device))
    _build.check_launch(lib, err, "linear_block_head")
    _build.LAUNCH_COUNTS["linear_head"] += 1
    return out


def _head_any(x, gamma, w_qkv, w_out, out_bias, ek, ev, *, heads: int,
              scale: float, spatial_size: int):
    """Row 8 through the any-shape kernels (csrc/any_linear_head.cu and
    csrc/any_linear_head_apply.cu): the fused token sums (LN, k || v and
    the running-max softmax sums on the tensor cores, bf16 hi + lo
    products), the ordered merge into ctxn's hi and lo blocks, and the
    fused apply (LN, q, Q ctxn and oh W_out as split products, the
    residual in the epilogue), as `head_any_plan` says; one workspace, the
    stats' partials and ctxn's blocks, allocated here."""
    hidden, d = _check_common(x, gamma, w_qkv, heads)
    _build.require(d <= 64,
                   f"the any-shape head layout takes d up to 64, got {d}")
    b, n, c = x.shape
    req = _build.require
    req(w_out.dtype == torch.bfloat16 and w_out.is_contiguous()
        and tuple(w_out.shape) == (hidden, c) and w_out.device == x.device,
        "w_out must be contiguous bf16 (hidden, C)")
    req(out_bias.dtype == torch.float32 and out_bias.is_contiguous()
        and tuple(out_bias.shape) == (c,) and out_bias.device == x.device,
        "out_bias must be float32 (C,)")
    m_c = _check_cond(ek, ev, x, hidden)
    lib = _build.load_library()
    out = torch.empty_like(x)
    ws = _build.workspace(lib.vmt_linear_head_any_workspace(b, n, c, heads,
                                                            d), x.device)
    p = _build.ptr
    err = lib.vmt_linear_head_any(
        p(x), p(gamma), p(w_qkv), p(w_out), p(out_bias), p(ek), p(ev),
        p(out), p(ws), b, n, c, m_c, heads, d, scale, 1.0 / spatial_size,
        _build.stream_handle(x.device))
    _build.check_launch(lib, err, "linear_head_any")
    _build.LAUNCH_COUNTS["linear_head_any"] += 1
    return out


def bwd_route(n: int, hidden: int = HIDDEN, layout: str = "merged") -> str:
    """The backward kernel the JAX package takes (_core_bwd, :574-588): for
    the merged layout 'head' where 12 * N * hidden * 4 B is above 40 MiB
    (the merged backward is untiled there), else 'merged'; for the head
    layout 'head' at every N."""
    if layout == "head":
        return "head"
    return "head" if 12 * n * hidden * 4 > ROUTE_BYTES else "merged"


def linear_block_softmax_plain(x, gamma, w_qkv, w_out, out_bias, ek, ev, *,
                               heads: int, scale: float, spatial_size: int):
    """The block in the form the merged backward kernel differentiates: y
    rounded to x's dtype, then float32 with a max-shifted token softmax of
    k clamped to +-60, with no gradient where |k| >= 60 (the JAX merged
    backward's where form, fused_linear_block.py:311, :315). The per-head
    backward differentiates the head layout's forward
    (linear_block_head_plain), as the JAX _bwd_kernel mirrors _kernel."""
    b, n, _ = x.shape
    hidden = w_out.shape[0]
    d = hidden // heads
    y = channel_layer_norm(x, gamma, one_pass=False).to(x.dtype).float()
    q, k, v = (y @ w_qkv.float()).split(hidden, dim=-1)
    if ek is not None:
        k = torch.cat([ek.float(), k], dim=1)
        v = torch.cat([ev.float(), v], dim=1)
    k = torch.where(k.abs() < K_CLAMP, k, k.detach().clamp(-K_CLAMP, K_CLAMP))
    m = k.shape[1]
    pk = torch.softmax(k.reshape(b, m, heads, d), dim=1)
    ctx = torch.einsum("bmha,bmhe->bhae", pk,
                       v.reshape(b, m, heads, d) / spatial_size)
    qs = torch.softmax(q.reshape(b, n, heads, d), dim=-1) * scale
    oh = torch.einsum("bnha,bhae->bnhe", qs, ctx).reshape(b, n, hidden)
    out = x.float() + out_bias.float() + oh @ w_out.float()
    return out.to(x.dtype)


def linear_block_bwd_plain(x, gamma, w_qkv, w_out, out_bias, ek, ev, g, *,
                           heads: int, scale: float, spatial_size: int,
                           route: str):
    """Plain twin of the backward kernel: autograd through the forward it
    differentiates, linear_block_softmax_plain (clamped) on the merged
    route and linear_block_head_plain (unclamped) on the per-head one, at
    the weights rounded to x's dtype. Returns (dx, dgamma, dw_qkv, dw_out,
    dout_bias, dek, dev); dx in x's dtype, the rest float32, dek/dev None
    without conditioning tokens."""
    cdt = x.dtype
    fwd = (linear_block_softmax_plain if route == "merged"
           else linear_block_head_plain)
    return _build.plain_cotangents(fwd, x, g,
                  (gamma, w_qkv.to(cdt), w_out.to(cdt), out_bias,
                   None if ek is None else ek.to(cdt),
                   None if ev is None else ev.to(cdt)),
                  heads=heads, scale=scale, spatial_size=spatial_size)


def reference_linear_block(x, gamma, w_qkv, w_out, out_bias, ek, ev, *,
                           heads: int, scale: float, spatial_size: int):
    """Own copy of the JAX package's reference_linear_block
    (fused_linear_block.py:518-547), with its roundings: y = one-pass
    LN(x) gamma in x's dtype, qkv in that dtype, the conditioning K/V
    stacked in front, linear_attention_tokens_first (max-shifted and
    unclamped; its out in the compute dtype), the out-projection and
    out_bias in the compute dtype, then the residual. It is the function
    the JAX 'recompute' backward differentiates, for both layouts; the
    forward kernels and their twins keep the stats' +-60 clamp."""
    b, n, _ = x.shape
    hidden = w_out.shape[0]
    d = hidden // heads
    y = channel_layer_norm(x, gamma)
    qkv = torch.einsum("bnc,ce->bne", y, w_qkv.to(y.dtype))
    q, k, v = (t.reshape(b, n, heads, d) for t in qkv.split(hidden, dim=-1))
    if ek is not None:
        k = torch.cat([ek.to(k.dtype).reshape(b, -1, heads, d), k], dim=1)
        v = torch.cat([ev.to(v.dtype).reshape(b, -1, heads, d), v], dim=1)
    out = linear_attention_tokens_first(q, k, v, scale=scale,
                                        spatial_size=spatial_size)
    out = torch.einsum("bnh,hc->bnc", out.reshape(b, n, hidden),
                       w_out.to(out.dtype))
    out = out + out_bias.to(out.dtype)
    return x + out.to(x.dtype)


def linear_block_recompute(x, gamma, w_qkv, w_out, out_bias, ek, ev, g, *,
                           heads: int, scale: float, spatial_size: int):
    """The default backward: autograd through reference_linear_block, as
    the JAX 'recompute' _core_bwd (:589-594) takes jax.vjp of it, in
    linear_block_bwd_plain's result order."""
    cdt = x.dtype
    return _build.plain_cotangents(reference_linear_block, x, g,
                  (gamma, w_qkv.to(cdt), w_out.to(cdt), out_bias,
                   None if ek is None else ek.to(cdt),
                   None if ev is None else ev.to(cdt)),
                  heads=heads, scale=scale, spatial_size=spatial_size)


def linear_block_bwd(x, gamma, w_qkv, w_out, out_bias, ek, ev, g, *,
                     heads: int, scale: float, spatial_size: int,
                     route: str):
    """All cotangents of the block (linear_block_bwd_plain's order) on the
    given route ('head' or 'merged'). A CPU tensor takes the plain twin; a
    CUDA tensor launches the backward kernel or raises."""
    if route not in ("head", "merged"):
        raise ValueError(f"unknown backward route {route!r}")
    if x.device.type == "cpu":
        return linear_block_bwd_plain(x, gamma, w_qkv, w_out, out_bias, ek,
                                      ev, g, heads=heads, scale=scale,
                                      spatial_size=spatial_size, route=route)
    if _instance(x, w_qkv, heads) == ANY_SHAPE:
        return _bwd_any(x, gamma, w_qkv, w_out, ek, ev, g, heads=heads,
                        scale=scale, spatial_size=spatial_size, route=route)
    _check_common(x, gamma, w_qkv, heads)
    b, n, c = x.shape
    _check_bwd_operands(x, w_out, g, HIDDEN)
    m_c = _check_cond(ek, ev, x)
    lib = _build.load_library()
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    dgamma = torch.empty((c,), **f32)
    dw_qkv = torch.empty((c, 3 * HIDDEN), **f32)
    dw_out = torch.empty((HIDDEN, c), **f32)
    dout_bias = torch.empty((c,), **f32)
    dek = torch.empty((b, m_c, HIDDEN), **f32) if m_c else None
    dev = torch.empty((b, m_c, HIDDEN), **f32) if m_c else None
    ws = _build.workspace(lib.vmt_linear_block_bwd_workspace(b, n, c),
                          x.device)
    w_out_t = w_out.t().contiguous()
    _build.require_aligned(x, w_qkv, w_out_t, g, ek, ev)
    p = _build.ptr
    err = lib.vmt_linear_block_bwd(
        p(x), p(gamma), p(w_qkv), p(w_out_t), p(ek), p(ev), p(g), p(dx),
        p(dgamma), p(dw_qkv), p(dw_out), p(dout_bias), p(dek), p(dev), p(ws),
        b, n, c, m_c, heads, scale, 1.0 / spatial_size,
        int(route == "merged"), _build.stream_handle(x.device))
    _build.check_launch(lib, err, f"linear_block_bwd ({route})")
    _build.LAUNCH_COUNTS[f"linear_bwd_{route}"] += 1
    return dx, dgamma, dw_qkv, dw_out, dout_bias, dek, dev


def _check_bwd_operands(x, w_out, g, hidden: int) -> None:
    req = _build.require
    req(w_out.dtype == torch.bfloat16 and tuple(w_out.shape) == (hidden,
                                                                  x.shape[2])
        and w_out.device == x.device, "w_out must be bf16 (hidden, C)")
    req(g.dtype == x.dtype and g.shape == x.shape and g.is_contiguous()
        and g.device == x.device, "g must be contiguous, of x's shape and dtype")


def _bwd_any(x, gamma, w_qkv, w_out, ek, ev, g, *, heads: int, scale: float,
             spatial_size: int, route: str):
    """Rows 6 (route 'head', clip 0) and 7 ('merged', clip 1) through the
    any-shape kernels (csrc/any_linear_bwd.cu): two token passes that
    recompute the projections from x and g on the tensor cores (the token
    sums, then the per-token cotangents, dy and the LN backward), launched
    as `bwd_any_plan` says, then the weight sums; one workspace allocated
    here, W_out handed transposed for g_oh."""
    hidden, d = _check_common(x, gamma, w_qkv, heads)
    b, n, c = x.shape
    bwd_any_plan(b, n, c, heads, d)
    _check_bwd_operands(x, w_out, g, hidden)
    m_c = _check_cond(ek, ev, x, hidden)
    lib = _build.load_library()
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    dgamma = torch.empty((c,), **f32)
    dw_qkv = torch.empty((c, 3 * hidden), **f32)
    dw_out = torch.empty((hidden, c), **f32)
    dout_bias = torch.empty((c,), **f32)
    dek = torch.empty((b, m_c, hidden), **f32) if m_c else None
    dev = torch.empty((b, m_c, hidden), **f32) if m_c else None
    ws = _build.workspace(lib.vmt_linear_block_bwd_any_workspace(
        b, n, c, heads, d), x.device)
    w_out_t = w_out.t().contiguous()
    p = _build.ptr
    err = lib.vmt_linear_block_bwd_any(
        p(x), p(gamma), p(w_qkv), p(w_out_t), p(ek), p(ev), p(g), p(dx),
        p(dgamma), p(dw_qkv), p(dw_out), p(dout_bias), p(dek), p(dev), p(ws),
        b, n, c, m_c, heads, d, scale, 1.0 / spatial_size,
        int(route == "merged"), _build.stream_handle(x.device))
    name = f"linear_bwd_{route}_any"
    _build.check_launch(lib, err, name)
    _build.LAUNCH_COUNTS[name] += 1
    return dx, dgamma, dw_qkv, dw_out, dout_bias, dek, dev


def bwd_kernel_env() -> bool:
    """VMT_LINEAR_BWD_KERNEL=1: the backward kernel under the 'recompute'
    plan too (the JAX _bwd_kernel_env, read when the backward runs)."""
    return os.environ.get("VMT_LINEAR_BWD_KERNEL", "") == "1"


class _FusedLinearBlock(torch.autograd.Function):
    """The JAX custom VJP (fused_linear_block.py:550-745): the layout's
    forward on the primals, which are saved; the backward recomputes
    through reference_linear_block or runs the backward kernel on the JAX
    route."""

    @staticmethod
    def forward(ctx, x, gamma, w_qkv, w_out, out_bias, ek, ev, heads, scale,
                spatial_size, bwd, layout):
        cdt = x.dtype
        w_qkv, w_out = w_qkv.to(cdt).contiguous(), w_out.to(cdt).contiguous()
        ctx.kw = dict(heads=heads, scale=scale, spatial_size=spatial_size)
        ctx.bwd, ctx.layout = bwd, layout
        ctx.save_for_backward(x, gamma, w_qkv, w_out, out_bias, ek, ev)
        fwd = linear_block_head if layout == "head" else linear_block_fwd
        return fwd(x, gamma, w_qkv, w_out, out_bias, ek, ev, **ctx.kw)

    @staticmethod
    def backward(ctx, g):
        args = ctx.saved_tensors
        if ctx.bwd == "kernel" or bwd_kernel_env():
            route = bwd_route(args[0].shape[1], hidden=args[3].shape[0],
                              layout=ctx.layout)
            grads = linear_block_bwd(*args, g.contiguous(), **ctx.kw,
                                     route=route)
        else:
            grads = linear_block_recompute(*args, g, **ctx.kw)
        return (*grads, None, None, None, None, None)


def fused_linear_block(x, gamma, w_qkv, w_out, out_bias, ek, ev, *,
                       heads: int, scale: float, spatial_size: int,
                       bwd: str = "recompute", layout: str | None = None):
    """x + block(x), differentiable in every operand. x: (B, N, C) in the
    compute dtype; w_qkv/w_out in any float dtype (cast to x's inside, so
    float32 weights get float32 gradients); bwd: 'recompute' (autograd
    through reference_linear_block) or 'kernel' (the backward kernel; its
    twin on the CPU); layout: 'merged' (stats + apply) or 'head' (the
    head-layout kernel), None resolving VMT_LINEAR_LAYOUT, then 'merged',
    as the JAX entry point does (fused_linear_block.py:904-906)."""
    if bwd not in ("recompute", "kernel"):
        raise ValueError(f"unknown backward plan {bwd!r}")
    if layout is None:
        layout = os.environ.get("VMT_LINEAR_LAYOUT", "merged")
    if layout not in LAYOUTS:
        raise ValueError(f"unknown linear layout {layout!r}")
    return _FusedLinearBlock.apply(x, gamma, w_qkv, w_out, out_bias, ek, ev,
                                   heads, scale, spatial_size, bwd, layout)
