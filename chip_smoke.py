#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (videometamaterials_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--steps N]

Phases, each printing its wall time as it finishes:
  0 device   card name and power limit (nvidia-smi), torch/CUDA versions
  1 build    the sm_90a kernels: one nvcc process per source, all started
             together, and a link (seconds, not minutes); the tensor-core
             kernels' ptxas registers and spills, dynamic shared memory and
             SASS HMMA and atomic counts (none without HMMA, no atomic)
  2 kernels  each kernel against its plain PyTorch twin at every shape the
             main path gives it (temporal block at every level with and
             without conditioning tokens, linear stats + apply at every
             level and at token counts off their tiles, stats bit-equal
             over two launches, the per-head-shift NaN case), with
             kernel/twin times;
             the emit_p temporal forward at every training-path shape (out
             bit-equal to the plain forward kernel's, out and p against the
             twin, p's rows summing to one) and the head-layout linear
             forward at every sampling- and training-path shape and with
             |k| across the merged stats' clamp
  2b backward  each backward kernel against its twin at every shape of the
             training path (batch 4, 44 folded frames): every cotangent,
             with kernel/twin times and bounds, the linear backward
             bit-equal over two launches; then the linear backward at a
             ragged N with |k| across 60 on both routes (the merged one
             against its clamped twin, the per-head one against its
             unclamped twin)
  3 model    one guided forward of the flagship UNet3D, fused plans against
             the unfused plans, on the same input
  3b model   the same with the linear blocks on the head layout
             (VMT_LINEAR_LAYOUT=head)
  4 chain    the main path: guided DDPM sampling (w = 5, bisect dynamic
             thresholding) of one video at 96x96x11 through `sample()`,
             the launch counters proving every step went through the
             kernels
  4b chain   the same chain with the linear blocks on the head layout
             (counters: 8 head-layout launches a step, no stats/apply)
  5 train    the flagship train step at batch 4 with the fused blocks and
             their backward kernels under grad: one step's gradients of the
             kernel plan and of the saved plan (temporal_vjp: saved) against
             the recompute backward and the unfused plan, then
             --train-steps steps under each of the four plans (median step
             ms, peak memory, finite losses, parameters that moved, the EMA
             rule, launch counters 10/10/8/8/2/6 per kernel-plan step and
             10 emit_p forwards, no temporal backward kernel, 8/8/2/6 per
             saved-plan step)
  6 eval     the checkpoint-to-artifacts path: the flagship's seeded
             weights written as a run checkpoint (flax's msgpack format,
             bf16 leaves where the committed trees have them) and read
             back bit for bit, a seeded data folder and two target curves,
             one guided eps at the eval chunk of 4 videos (CFG 8) against
             the unfused plans, then the eval CLI in-process
             (videometamaterials_tpu_torch.main --skip-train: 2 targets x
             2 predictions, --test-batch-size 8 = one chunk of 4, w = 5,
             the full chain; counters 10/8/8 a step), its GIFs decoded and
             held to the returned videos, geometries.csv's 4 rows, and a
             second run writing eval_target_w_5.0_1
  7 train    the train CLI (videometamaterials_tpu_torch.main) on a seeded
             GIF folder it writes (8 training and 4 validation videos of
             11x96x96, every lagrangian channel folder and topo, the two
             CSVs, two target curves) with the flagship config and
             fused_blocks_in_training + fused_bwd_kernels, batch 4: run A,
             20 steps with milestones at 10 and 20 (validation loss, the
             fidelity probe on 1 target x 2 predictions, 1 validation
             curve sampled; each sampling call one chunk of 4 through the
             full chain): launch counters 10/10/8/8/2/6 a train step and
             10/8/8 a sampling step and a validation batch, finite
             losses, float32 parameters after each milestone, both
             milestone directories with their GIFs, metrics.jsonl with
             the validation loss and the probe NRMSE at 10 and 20, steps
             10 and 20 written once each; then run B, run A's step 10
             resumed to 20, its parameters, Adam moments and EMA within
             RESUME_TOL of run A's; and a cache-restored step refused.
             Prints step ms, the milestone's parts and the checkpoint's
             seconds, and peak memory
  8 ddim     the flagship's seeded weights written as the reference's
             checkpoint.pt (denoise_fn. keys, 4-d Conv2d weights, the
             schedule buffers, online and EMA weights) and imported bit
             for bit; the eval CLI in-process on it (--skip-train
             --torch-checkpoint --sampling-timesteps 64 --guidance-arms
             5,2:0.7, 2 targets x 2 predictions, one chunk of 4): each
             arm one sampling call of exactly 64 DDIM steps at 10/8/8
             launches a step, its sampler the imported EMA (bf16 where
             the inference cast casts), eval_target_w_5.0_0 and
             eval_target_w_2.0_phi_0.7_0 with GIFs equal to the videos
             and 4-row geometries.csv, each arm's chain seconds beside
             phase 6's DDPM-256; then interpolate at batch 2 from t = 32
             on that sampler (32 steps of 10/8/8 launches, finite, the
             right shape)
  9 ablations  the paper's conditioning ablations (per_frame_cond: false,
             model.yaml:27-29) at the flagship's widths, seeded weights:
             (a) rows 1-3 at T = 6, 16 and 50 conditioning tokens at every
             level shape of both paths and at the largest count the
             kernels take, rows 4-7 at Mc = 16 and 50 (the training
             shapes and N = 100 on both backward routes), row 8 at Mc =
             16, each against its twin, with kernel and twin ms and the
             bound; row 1 at T = 11 bit-equal to phase 2's launch;
             (b) one guided eps of each arm (ablation-CNN: 16 tokens of
             the CNN hidden; ablation-GRU: 50 GRU tokens; no-cond; and
             cross-attention, unfused only), fused plans against unfused
             at 10/8/8 launches; (c) the ablation-CNN's guided DDPM-256
             chain through `sample()` at 10/8/8 launches a step, its
             seconds beside phase 4's; (d) 5 kernel-plan train steps of
             ablation-CNN at batch 4 (10/10/8/8/2/6 a step, finite losses,
             the CNN embedder's parameters moved); (e) the eval CLI on an
             ablation-GRU checkpoint it writes, whole-curve targets, one
             chunk of 4, the full chain (10/8/8 a step), GIFs equal to
             the videos and geometries.csv
  10 variants  the training-side variants on the flagship at batch 4 with
             the kernel plan (fused_blocks_in_training + fused_bwd_kernels):
             (a) focus: gradients under the explicit mask [T, F, T, F]
             against the unfused plan under the same mask (loss within
             MODEL_TOL, each fused-block gradient within GRAD_TOL of its
             own max, as phase 5 holds them), then
             a step with prob_focus_present 1.0 and one with the explicit
             mask: 0/0/8/8/2/6 launches a step (no temporal kernel: the
             masked temporal blocks take the unfused plan, as in the JAX
             model); (b) accumulation, k = 2 over 4 micro-steps: the
             parameters bit-unchanged after micro-steps 1 and 3 and moved
             after 2 and 4, Adam's count 2, micro-step 2's update within
             GRAD_TOL of one Adam step on the mean of the two micro-batches'
             gradients computed outside, the MultiSteps state written after
             micro-step 3 (msgpack) and read back bit for bit, 10/10/8/8/2/6
             a micro-step; (c) remat_blocks: one step's gradients against
             remat off (bit-equal or not, within GRAD_TOL), then 10 steps
             each, median ms and peak memory; (d) one guided eps on the
             unfused plan with temporal_s_tile 1152 against the untiled
             unfused plan, within MODEL_TOL; (e) one step under
             VMT_TEMPORAL_VJP=saved and VMT_LINEAR_BWD_KERNEL=1 without
             fused_bwd_kernels: phase 5's saved-plan counters (10 emit_p,
             no temporal backward, 8/8/2/6); (f) the rendering CLI
             (videometamaterials_tpu_torch.gif_visualization) in-process on
             phase 6's eval GIFs and its data folder's frame ranges: the
             four artifacts, each GIF 11x96x96x4 through the port's reader,
             visualization.gif's alpha the solid mask, and matplotlib, PIL
             and imageio never imported
  11 parallel  the data-parallel paths (videometamaterials_tpu_torch.parallel)
             under an NCCL process group of one rank on the card (NCCL takes
             one rank a card; two ranks are proven by the CPU tests on
             gloo): (a) 20 kernel-plan train steps at batch 4 on phase 5's
             seeded batches, 10/10/8/8/2/6 launches a step, parameters,
             Adam moments, EMA and losses bit-equal to the same 20 steps
             without a group, the median step ms beside phase 5's (a gap
             over 10% flagged); (b) the train CLI in-process under the
             group with --profile-dir, 14 steps on phase 7's GIF folder, no
             milestone: trace_rank0.json written with every ported kernel
             family among its device events, rank 0's one checkpoint,
             byte-equal to the same run's without --profile-dir;
             (c) one guided DDIM-64 chunk of 4 through the Trainer's
             sample_videos under the group at 10/8/8 a step; (d)
             dryrun_multichip(1) on an NCCL group it opens and
             dryrun_multichip(2) on two gloo CPU processes, each under a
             timeout. The kernels line gains launches_phase11 ((a) with
             the group, (b) and (c))
Then a JSON line of per-kernel numbers, the nvidia-smi line, and as the
last line {"ok": true, "device": {...}}. Any failure raises: non-zero exit
and no "ok" line. Without a GPU, or outside a checkout, it exits non-zero
before printing any result. Budget: the whole script in under 10 minutes
on an H100, the build included.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM rate and the dense bf16
# tensor-core rate (the type of the kernels' operands)
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOP_PER_S = 989e12

# main-path shapes per guided step at batch 1 (the CFG pair is batch 2):
# temporal (batch, spatial, channels, cond tokens) in path order
TEMPORAL_PATH = [(1, 9216, 64, 0),
                 (2, 9216, 64, 11), (2, 2304, 128, 11), (2, 576, 256, 11),
                 (2, 144, 512, 11), (2, 144, 512, 11),
                 (2, 144, 256, 11), (2, 576, 128, 11), (2, 2304, 64, 11),
                 (2, 9216, 64, 11)]
# linear (folded frames, tokens, channels): 4 down, then 4 up
LINEAR_PATH = [(22, 9216, 64), (22, 2304, 128), (22, 576, 256),
               (22, 144, 512), (22, 144, 256), (22, 576, 128),
               (22, 2304, 64), (22, 9216, 64)]
# token counts off the kernels' tiles (64 tokens an apply block and a stats
# sub-tile, 256 a stats block at N >= 4096): a ragged last stats tile and
# sub-tile, and a frame shorter than two sub-tiles
LINEAR_RAGGED = [(22, 9191, 64), (22, 100, 512)]
FRAMES, HIDDEN, HEADS = 11, 256, 8
# bf16 outputs: one bf16 ulp at |out| ~ 4 is 0.016, and a qkv or weight
# element that rounds the other way moves an output by about as much --
# the JAX kernel test's bf16 tolerance (tests/test_fused_temporal_block.py:50)
BF16_TOL = (3e-2, 3e-2)
# float32 z: summation order of the projection and of the token sum
STATS_TOL = (1e-3, 1e-3)
# ctx sums bf16(exp(k)) * bf16(v / HW). A summand's factor whose f32 value
# sits near a bf16 rounding boundary can round one ulp (at most 2^-7 of it)
# apart in the kernel and the twin, whose projections sum in different
# orders. So ctx may differ by up to 2^-7 of the sum of its summands'
# magnitudes (linear_stats_magnitude), however much the summands cancel
CTX_SHARE = 2.0 ** -7
# linear apply: max |update - twin's update| over max |twin's update|, the
# update being out - x - out_bias; bf16 rounding of qn, oh and out keeps
# it under 1% at an O(1) update, a kernel that drops or garbles the
# attention term misses by O(1)
APPLY_TOL = 3e-2
# apply's stats inputs at O(1) scale: z = 1 + |N(0, 1)|, ctx ~ 32 N(0, 1)
# make the update about as large as x (rms ~1). The main path's own stats
# (v / HW, z ~ HW E[exp k]) make it ~1e-5 of |x|, below one bf16 ulp of
# the output, where no comparison of outputs can see the attention term
APPLY_CTX_SCALE = 32.0
# the softmax weights p sum to one per (position, head): bf16 keeps 8
# significant bits, so each of the F+T weights is within 2^-8 of its
# float32 value relative to it and their sum within 2^-8 of one; 2^-7
# leaves room for the float32 sums. A p that is off by a factor misses by
# O(1)
P_SUM_TOL = 2.0 ** -7
# head-layout inputs with an O(1) update beside x (check_update): the v
# columns of w_qkv times HW (undoing the layout's v / HW) and 32, and the
# key columns times 8, so the token softmax picks few tokens and ctx is not
# an average near zero. At the path's own v / HW the attention term is
# ~1e-5 of |x|, below one bf16 ulp of the output
HEAD_V_SCALE, HEAD_K_SCALE = 32.0, 8.0
# keys times 40: |k| on both sides of 60, where the merged stats' clamp
# changes the function and the head layout must not clamp
HEAD_CLAMP_K_SCALE = 40.0
# relative L2 error of the guided eps, fused plans against unfused plans
MODEL_TOL = 0.15
# backward: each cotangent within 5e-2 of the twin's largest |element|,
# rtol 0, and nonzero somewhere -- the JAX package's rule for its backward
# kernels (tests/test_fused_temporal_block.py:277,
# tests/test_fused_linear_block.py:205-211) and for its module-level fused
# gradients (tests/test_fused_temporal_block.py:322-358), which phase 5
# applies to every parameter of a fused block. Without those tests' 1e-3
# floor on the max: at the flagship shapes some cotangents (the linear
# dek/dev, the conditioning projections' gradients) lie far below it, and
# the floor would make their limit larger than the values themselves
GRAD_TOL = 5e-2


def cond_key_shift(n: int) -> float:
    """The shift of the linear backward's conditioning key in phase 2b:
    log N + 1/2, about log sum_n exp(k_n) for k ~ N(0, 1), so the token
    takes about half of each feature's token softmax. At the path's own
    keys its weight is ~1/N: dek and dev are then tiny, and S (the
    softmax's sum_e dctx ctx) is a percent of dek, where a kernel that
    dropped it would still pass."""
    return math.log(n) + 0.5


# the training path: batch 4 (bench.py's train workload), the init block at
# batch 4 without conditioning (no CFG pair in training)
TRAIN_BATCH = 4
TRAIN_TEMPORAL = [(TRAIN_BATCH, s, c, t) for _, s, c, t in TEMPORAL_PATH]
TRAIN_LINEAR = [(TRAIN_BATCH * 11, n, c) for _, n, c in LINEAR_PATH]
# device functions of the port's hand-written kernels (profile summary)
# (linear_apply_kernel<C, true> is the head layout's apply, row 8)
PORTED_KERNELS = ("temporal_attn_kernel", "temporal_outproj_kernel",
                  "temporal_bwd_attn_kernel", "temporal_bwd_dx_kernel",
                  "linear_stats_", "linear_apply_kernel", "linear_bwd_",
                  "contract_partial", "colsum_kernel")
# the device functions of the tensor-core kernels (rows 1-8 of PERF.md's
# kernel table: linear_apply_kernel<C, false> row 5, <C, true> row 8's
# apply, whose stats pass it shares with rows 6-7; and the contraction of
# rows 3, 6 and 7): their ptxas resources are printed and their SASS must
# hold tensor-core instructions (HMMA) and no atomics
TENSOR_CORE_KERNELS = ("temporal_attn_kernel", "temporal_outproj_kernel",
                       "temporal_bwd_attn_kernel", "temporal_bwd_dx_kernel",
                       "contract_partial", "linear_stats_partial",
                       "linear_apply_kernel", "linear_bwd_stats_kernel",
                       "linear_bwd_dx_kernel")


def log(msg: str) -> None:
    print(msg, flush=True)


def check_close(name, got, want, rtol_atol):
    import torch

    rtol, atol = rtol_atol
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: kernel output is not finite")
    err = (got - want).abs()
    worst = (err - rtol * want.abs()).max().item()
    if worst > atol:
        raise AssertionError(
            f"{name}: max |kernel - twin| {err.max().item():.3e} beyond "
            f"atol {atol} + rtol {rtol} * |twin|")
    return err.max().item()


def check_ctx(name, got, want, magnitude):
    """|kernel - twin| within CTX_SHARE of the summands' magnitude, element
    by element; returns the max error and the largest share it reached."""
    import torch

    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: kernel output is not finite")
    err = (got - want).abs()
    share = (err / magnitude.clamp_min(1e-30)).max().item()
    if share > CTX_SHARE:
        raise AssertionError(
            f"{name}: |kernel - twin| reaches {share:.3e} of the summands' "
            f"magnitude, beyond {CTX_SHARE}")
    return err.max().item(), share


def check_update(name, got, want, x, out_bias):
    """Hold the block's update, out - x - out_bias, against the twin's,
    relative to the size of the twin's update; returns the max error."""
    import torch

    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: kernel output is not finite")
    base = x.float() + out_bias
    upd_k, upd_p = got.float() - base, want.float() - base
    if upd_p.pow(2).mean() < 0.25 * x.float().pow(2).mean():
        raise AssertionError(f"{name}: the update is too small beside x for "
                             "the comparison to see it")
    err = (upd_k - upd_p).abs().max().item()
    size = upd_p.abs().max().item()
    if not err <= APPLY_TOL * size:
        raise AssertionError(
            f"{name}: max |update - twin's update| {err:.3e} beyond "
            f"{APPLY_TOL} * max |twin's update| {size:.3e}")
    return err


def rate(ms: float, flops: float, bound_ms: float) -> str:
    """Achieved TFLOP/s and the share of the bound a kernel time reaches."""
    return (f"{flops / ms * 1e-9:.1f} TFLOP/s, {100 * bound_ms / ms:.1f}% of "
            "its bound")


def kernel_resources(info: dict) -> None:
    """Print ptxas's registers, static shared memory and spills of the
    tensor-core kernels (from the build log), the dynamic shared memory
    their launches ask for, and the HMMA and atomic instructions in their
    SASS (cuobjdump of the built library). Raises if one of them has no
    tensor-core instruction or any atomic."""
    import re

    from videometamaterials_tpu_torch.ops.cuda import _build

    def demangle(names):
        filt = Path(_build._nvcc()).with_name("cu++filt")
        if not filt.exists():
            return names
        out = subprocess.run([str(filt)], input="\n".join(names),
                             capture_output=True, text=True, timeout=60)
        got = out.stdout.splitlines()
        return got if len(got) == len(names) else names

    func, res = None, {}
    for line in info["log"].splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            func = m.group(1)
            continue
        if func and any(k in func for k in TENSOR_CORE_KERNELS):
            if "spill" in line or "Used" in line:
                res.setdefault(func, []).append(line.split(":", 1)[-1].strip())
    def short(pretty):
        """The demangled name with its template arguments, without its
        parameter list."""
        return pretty[:pretty.rfind(">") + 1] if "<" in pretty else (
            pretty.split("(")[0])

    names = sorted(res)
    for pretty, name in zip(demangle(names), names):
        log(f"  ptxas {short(pretty)}: {'; '.join(res[name])}")
    lib = _build.load_library()
    for c in (64, 128, 256, 512):
        log(f"  dynamic shared memory at C={c} (T=11 / T=0): forward "
            f"attention {lib.vmt_temporal_block_fwd_smem(c, 11, 0)} / "
            f"{lib.vmt_temporal_block_fwd_smem(c, 0, 0)} B, out-projection "
            f"{lib.vmt_temporal_block_fwd_smem(c, 11, 1)} B; backward "
            f"attention {lib.vmt_temporal_block_bwd_smem(c, 11, 0)} / "
            f"{lib.vmt_temporal_block_bwd_smem(c, 0, 0)} B, dy + LN "
            f"{lib.vmt_temporal_block_bwd_smem(c, 11, 1)} B; linear stats "
            f"{lib.vmt_linear_block_fwd_smem(c, 0)} B, apply "
            f"{lib.vmt_linear_block_fwd_smem(c, 1)} B, head-layout apply "
            f"{lib.vmt_linear_block_fwd_smem(c, 2)} B; linear backward stats "
            f"{lib.vmt_linear_block_bwd_smem(c, 0)} B (head layout "
            f"{lib.vmt_linear_block_bwd_smem(c, 2)} B), dx "
            f"{lib.vmt_linear_block_bwd_smem(c, 1)} B")
    dump = Path(_build._nvcc()).with_name("cuobjdump")
    if not dump.exists():
        log("  cuobjdump not in the toolkit: SASS not counted")
        return
    sass = subprocess.run([str(dump), "-sass", info["path"]],
                          capture_output=True, text=True, timeout=300).stdout
    counts, func = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            func = m.group(1)
            counts[func] = [0, 0]
        elif func:
            counts[func][0] += bool(re.search(r"\bH(G)?MMA\b", line))
            counts[func][1] += bool(re.search(r"\b(RED|ATOM|ATOMG|ATOMS)\b",
                                              line))
    mine = sorted(f for f in counts if any(k in f for k in TENSOR_CORE_KERNELS))
    if not mine:
        raise AssertionError("no tensor-core kernel found in the SASS")
    for pretty, name in zip(demangle(mine), mine):
        hmma, atomics = counts[name]
        log(f"  SASS {short(pretty)}: {hmma} HMMA, {atomics} atomic "
            "instructions")
        if hmma == 0 or atomics:
            raise AssertionError(f"{pretty}: {hmma} HMMA, {atomics} atomics")


def cuda_ms(fn, reps: int = 5, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """The least time for the work: its bytes at the HBM rate against its
    operations at the bf16 tensor-core rate."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_BF16_FLOP_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# ----------------------------------------------------------------- inputs


def temporal_inputs(b, s, c, t_tok, gen):
    import torch

    dev, bf = "cuda", torch.bfloat16

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    w_all = rnd(FRAMES, c, 3 * HIDDEN, scale=c ** -0.5)
    w_all[..., :HIDDEN] *= 32 ** -0.5           # the folded q scale
    return dict(
        x=rnd(b, FRAMES, s, c).to(bf), gamma=1 + rnd(c, scale=0.1),
        w_all=w_all.to(bf), w_out=rnd(HIDDEN, c, scale=HIDDEN ** -0.5).to(bf),
        ek=rnd(b, t_tok, HIDDEN).to(bf) if t_tok else None,
        ev=rnd(b, t_tok, HIDDEN).to(bf) if t_tok else None,
        bias_all=rnd(FRAMES, FRAMES + t_tok, HEADS, scale=0.5))


def linear_inputs(bf_, n, c, gen, m_c=1):
    import torch

    dev, bf = "cuda", torch.bfloat16

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    return dict(
        x=rnd(bf_, n, c).to(bf), gamma=1 + rnd(c, scale=0.1),
        w_qkv=rnd(c, 3 * HIDDEN, scale=c ** -0.5).to(bf),
        w_out=rnd(HIDDEN, c, scale=HIDDEN ** -0.5).to(bf),
        out_bias=rnd(c, scale=0.1), ek=rnd(bf_, m_c, HIDDEN).to(bf),
        ev=rnd(bf_, m_c, HIDDEN).to(bf),
        ctx=rnd(bf_, HEADS, 32, 32, scale=APPLY_CTX_SCALE),
        z=1 + rnd(bf_, HIDDEN).abs())


def check_cotangents(name, names, got, want):
    """Each cotangent within GRAD_TOL of its own twin's largest |element|
    and nonzero somewhere; returns the largest abs error, the largest share
    of its cotangent's max and the cotangent that reached it."""
    import torch

    worst, share, at = 0.0, 0.0, ""
    for n, a, b in zip(names, got, want):
        if b is None:
            if a is not None:
                raise AssertionError(f"{name} {n}: kernel gave a cotangent "
                                     "the twin does not have")
            continue
        a32, b32 = a.float(), b.float()
        if not torch.isfinite(a32).all():
            raise AssertionError(f"{name} {n}: not finite")
        scale = b32.abs().max().item()
        if scale == 0:
            raise AssertionError(f"{name} {n}: the twin's cotangent is zero "
                                 "everywhere, nothing to compare")
        err = (a32 - b32).abs().max().item()
        if err > GRAD_TOL * scale:
            raise AssertionError(f"{name} {n}: max |kernel - twin| {err:.3e} "
                                 f"beyond {GRAD_TOL} * {scale:.3e}")
        if a32.abs().max().item() == 0:
            raise AssertionError(f"{name} {n}: zero everywhere")
        worst = max(worst, err)
        share, at = max((share, at), (err / scale, n))
    return worst, share, at


def temporal_cost(b, s, c, t_tok):
    """(bytes, flops): x read and out written once, weights once; QKV
    projection, out-projection, scores and value sums."""
    act = b * FRAMES * s * c * 2
    weights = (FRAMES * c * 3 * HIDDEN + HIDDEN * c + 2 * b * t_tok * HIDDEN
               ) * 2 + FRAMES * (FRAMES + t_tok) * HEADS * 4 + c * 4
    flops = 2 * b * FRAMES * s * (c * 3 * HIDDEN + HIDDEN * c
                                  + 2 * (FRAMES + t_tok) * HIDDEN)
    return 2 * act + weights, flops


def temporal_p_cost(b, s, c, t_tok):
    """temporal_cost plus the bf16 softmax weights written once."""
    nbytes, flops = temporal_cost(b, s, c, t_tok)
    return nbytes + b * FRAMES * s * (FRAMES + t_tok) * HEADS * 2, flops


def head_cost(bf_, n, c, m_c=1):
    """(bytes, flops): x read and out written once, the weights and cond
    tokens read once; on the tensor cores, in bf16 products: the QKV
    projection and ctx = P^T v (2 H d a token; the stats pass shared with
    the linear backward), and the apply's float32 products, each operand
    split into bf16 hi + lo: Q ctx as three products (3 x 2 H d a token)
    and the out-projection as two (2 x 2 H C)."""
    rows = bf_ * n
    nbytes = (2 * rows * c * 2 + (c * 3 * HIDDEN + HIDDEN * c) * 2
              + 2 * bf_ * m_c * HIDDEN * 2 + c * 8)
    return nbytes, rows * (2 * c * 3 * HIDDEN + 2 * HIDDEN * 32
                           + 3 * 2 * HIDDEN * 32 + 2 * 2 * HIDDEN * c)


def stats_cost(bf_, n, c, m_c=1):
    nbytes = (bf_ * n * c * 2 + c * 2 * HIDDEN * 2 + 2 * bf_ * m_c * HIDDEN * 2
              + bf_ * (HEADS * 32 * 32 + HIDDEN) * 4)
    flops = 2 * bf_ * (n * c * 2 * HIDDEN + (n + m_c) * HEADS * 32 * 32)
    return nbytes, flops


def temporal_bwd_cost(b, s, c, t_tok):
    """(bytes, flops): x and g read, dx written, weights read once, the f32
    parameter cotangents written once; the recomputed QKV, dy and dw_all
    (3 x 2 C 3H a row), g_acc and dw_out (2 x 2 H C), and the attention
    backward (scores, dp, values, dq, dk, dv: 12 (F+T) H a row)."""
    rows = b * FRAMES * s
    weights = (FRAMES * c * 3 * HIDDEN + HIDDEN * c + 2 * b * t_tok * HIDDEN
               ) * 2 + FRAMES * (FRAMES + t_tok) * HEADS * 4 + c * 4
    grads = (FRAMES * c * 3 * HIDDEN + HIDDEN * c + c + 2 * b * t_tok * HIDDEN
             + FRAMES * (FRAMES + t_tok) * HEADS) * 4
    flops = rows * (3 * 2 * c * 3 * HIDDEN + 2 * 2 * HIDDEN * c
                    + 12 * (FRAMES + t_tok) * HIDDEN)
    return 3 * rows * c * 2 + weights + grads, flops


def linear_bwd_cost(bf_, n, c, m_c=1):
    """(bytes, flops): x and g read, dx written, weights and cond tokens
    read, the f32 cotangents written; the QKV projection, dy and dW_qkv
    (3 x 2 C 3H a token), g_oh and dW_out (2 x 2 H C), and six per-head
    32 x 32 products (stats, oh, dQ, dctx, dP, dV), the cond tokens in the
    stats and key-side ones."""
    rows = bf_ * n
    nbytes = (3 * rows * c * 2 + (c * 3 * HIDDEN + HIDDEN * c) * 2
              + 2 * bf_ * m_c * HIDDEN * 2 + c * 8
              + (c * 3 * HIDDEN + HIDDEN * c + 2 * c
                 + 2 * bf_ * m_c * HIDDEN) * 4)
    flops = (rows * (3 * 2 * c * 3 * HIDDEN + 2 * 2 * HIDDEN * c
                     + 6 * 2 * HIDDEN * 32)
             + bf_ * m_c * 3 * 2 * HIDDEN * 32)
    return nbytes, flops


def apply_cost(bf_, n, c):
    nbytes = (2 * bf_ * n * c * 2 + (c * HIDDEN + HIDDEN * c) * 2
              + bf_ * (HEADS * 32 * 32 + HIDDEN) * 4 + c * 8)
    flops = 2 * bf_ * n * (c * HIDDEN + HEADS * 32 * 32 + HIDDEN * c)
    return nbytes, flops


# ----------------------------------------------------------------- phases


def phase_kernels(report, keep=None):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    temporal_kernels(report, gen, keep)
    linear_kernels(report, gen)


def temporal_kernels(report, gen, keep=None):
    """The temporal forward against its twin at every main-path shape;
    `keep` (a dict), if given, takes the inputs and the output of each
    shape with 11 conditioning tokens."""
    from videometamaterials_tpu_torch.ops.cuda import fused_temporal_block as tmp

    shapes = sorted(set(TEMPORAL_PATH), key=lambda s: (-s[1], s[0], s[3]))
    shapes += [(b, s, c, 0) for b, s, c, t in shapes if t]
    for b, s, c, t_tok in shapes:
        a = temporal_inputs(b, s, c, t_tok, gen)

        def kernel():
            return tmp.fused_temporal_block(**a, heads=HEADS)

        def plain():
            return tmp.temporal_block_plain(**a, heads=HEADS)

        out = kernel()
        if keep is not None and t_tok == FRAMES:
            keep[(b, s, c, t_tok)] = (a, out)
        err = check_close(f"temporal {b, s, c, t_tok}", out, plain(),
                          BF16_TOL)
        ms, plain_ms = cuda_ms(kernel), cuda_ms(plain, reps=2, warmup=1)
        nbytes, flops = temporal_cost(b, s, c, t_tok)
        log(f"  temporal B'={b} S={s} C={c} T={t_tok}: max_abs_err {err:.3e} "
            f"(tol {BF16_TOL}) kernel {ms:.3f} ms ("
            f"{rate(ms, flops, bound(nbytes, flops)[0])}), twin "
            f"{plain_ms:.3f} ms")
        if (b, s, c, t_tok) == (2, 9216, 64, 11):
            report["fused_temporal_block"].update(
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                **dict(zip(("bound_ms", "bound_by"),
                           bound(*temporal_cost(b, s, c, t_tok)))),
                shape=[b, FRAMES, s, c, t_tok])


def linear_kernels(report, gen):
    """Linear stats and apply against their twins at every main-path shape
    and at LINEAR_RAGGED (stats bit-equal over two launches), then the
    per-head shift case."""
    import torch

    from videometamaterials_tpu_torch.ops.cuda import fused_linear_block as lin

    for bf_, n, c in (sorted(set(LINEAR_PATH), key=lambda s: -s[1])
                      + LINEAR_RAGGED):
        a = linear_inputs(bf_, n, c, gen)
        kw = dict(heads=HEADS, spatial_size=n)
        ctx_p, z_p = lin.linear_stats_plain(a["x"], a["gamma"], a["w_qkv"],
                                            a["ek"], a["ev"], **kw)
        ctx_k, z_k = lin.linear_stats(a["x"], a["gamma"], a["w_qkv"],
                                      a["ek"], a["ev"], **kw)
        again = lin.linear_stats(a["x"], a["gamma"], a["w_qkv"], a["ek"],
                                 a["ev"], **kw)
        if not (torch.equal(ctx_k, again[0]) and torch.equal(z_k, again[1])):
            raise AssertionError(f"stats {bf_, n, c}: two launches give "
                                 "different bits")
        mag = lin.linear_stats_magnitude(a["x"], a["gamma"], a["w_qkv"],
                                         a["ek"], a["ev"], **kw)
        err_c, share = check_ctx(f"stats ctx {bf_, n, c}", ctx_k, ctx_p, mag)
        err_s = max(err_c, check_close(f"stats z {bf_, n, c}", z_k, z_p,
                                       STATS_TOL))
        akw = dict(heads=HEADS, scale=32 ** -0.5)
        args = (a["x"], a["gamma"], a["w_qkv"], a["w_out"], a["out_bias"],
                a["ctx"], a["z"])
        want = lin.linear_apply_plain(*args, **akw)
        err_a = check_update(f"apply {bf_, n, c}", lin.linear_apply(*args, **akw),
                             want, a["x"], a["out_bias"])
        upd_rms = (want.float() - a["x"].float() - a["out_bias"]).pow(2).mean(
            ).sqrt().item()
        sms = cuda_ms(lambda: lin.linear_stats(
            a["x"], a["gamma"], a["w_qkv"], a["ek"], a["ev"], **kw))
        splain = cuda_ms(lambda: lin.linear_stats_plain(
            a["x"], a["gamma"], a["w_qkv"], a["ek"], a["ev"], **kw),
            reps=2, warmup=1)
        ams = cuda_ms(lambda: lin.linear_apply(*args, **akw))
        aplain = cuda_ms(lambda: lin.linear_apply_plain(*args, **akw),
                         reps=2, warmup=1)
        log(f"  linear BF={bf_} N={n} C={c}"
            f"{' (ragged)' if (bf_, n, c) in LINEAR_RAGGED else ''}: stats "
            f"bit-equal over two launches, err {err_s:.3e} (ctx "
            f"{share:.2e} of its summands' magnitude, tol {CTX_SHARE:.2e}; z "
            f"tol {STATS_TOL}) {sms:.3f} ms / twin {splain:.3f} ms; apply "
            f"update err {err_a:.3e} (update rms {upd_rms:.3f}, tol "
            f"{APPLY_TOL} of its max) {ams:.3f} ms / twin {aplain:.3f} ms")
        if (bf_, n, c) == (22, 9216, 64):
            report["linear_stats"].update(
                max_abs_err=err_s, ms=sms, plain_ms=splain,
                **dict(zip(("bound_ms", "bound_by"),
                           bound(*stats_cost(bf_, n, c)))),
                shape=[bf_, n, c])
            report["linear_apply"].update(
                max_abs_err=err_a, ms=ams, plain_ms=aplain,
                **dict(zip(("bound_ms", "bound_by"),
                           bound(*apply_cost(bf_, n, c)))),
                shape=[bf_, n, c])

    # per-head max shift of the q softmax: head 0's logits ~1000x the
    # others' (tests/test_fused_linear_block.py:288) at the level-0 shape.
    # A one-ulp bf16 flip of an LN output moves head 0's logits by ~0.5,
    # which reorders its near-ties, so head 0's context is zero: the other
    # seven heads must come out exact, and a max shared across heads would
    # underflow their softmax sums (inf, NaN)
    a = linear_inputs(22, 9216, 64, gen)
    w = a["w_qkv"].float()
    w[:, :32] *= 1000.0
    a["w_qkv"] = w.to(torch.bfloat16)
    a["ctx"][:, 0] = 0.0
    args = (a["x"], a["gamma"], a["w_qkv"], a["w_out"], a["out_bias"],
            a["ctx"], a["z"])
    akw = dict(heads=HEADS, scale=32 ** -0.5)
    err = check_update("apply, extreme q scale", lin.linear_apply(*args, **akw),
                       lin.linear_apply_plain(*args, **akw), a["x"],
                       a["out_bias"])
    log(f"  linear per-head shift, head-0 q logits x1000: finite, "
        f"update err {err:.3e}")


def phase_emit_p(report):
    """The emit_p temporal forward at every training-path shape: out
    bit-equal to the plain forward kernel's on the same inputs, out and p
    within BF16_TOL of the twin's, p's rows summing to one."""
    import torch

    from videometamaterials_tpu_torch.ops.cuda import fused_temporal_block as tmp

    gen = torch.Generator(device="cuda").manual_seed(8)
    for b, s, c, t_tok in sorted(set(TRAIN_TEMPORAL),
                                 key=lambda v: (-v[1], v[3])):
        a = temporal_inputs(b, s, c, t_tok, gen)
        name = f"emit_p {b, s, c, t_tok}"
        out, p_w = tmp.temporal_block_fwd(**a, heads=HEADS, emit_p=True)
        plain_out = tmp.temporal_block_fwd(**a, heads=HEADS)
        if not torch.equal(out, plain_out):
            raise AssertionError(f"{name}: out is not bit-equal to the plain "
                                 "forward kernel's")
        want_out, want_p = tmp.temporal_block_plain_p(**a, heads=HEADS)
        err = max(check_close(f"{name} out", out, want_out, BF16_TOL),
                  check_close(f"{name} p", p_w, want_p, BF16_TOL))
        groups = FRAMES + t_tok
        sums = p_w.float().reshape(b, FRAMES, s, groups, HEADS).sum(dim=3)
        sum_err = (sums - 1).abs().max().item()
        if not sum_err <= P_SUM_TOL:
            raise AssertionError(f"{name}: p sums to one within {sum_err:.3e}"
                                 f", beyond {P_SUM_TOL:.3e}")
        del want_out, want_p, sums
        ms = cuda_ms(lambda: tmp.temporal_block_fwd(**a, heads=HEADS,
                                                    emit_p=True))
        fwd_ms = cuda_ms(lambda: tmp.temporal_block_fwd(**a, heads=HEADS))
        plain_ms = cuda_ms(lambda: tmp.temporal_block_plain_p(
            **a, heads=HEADS), reps=2, warmup=1)
        nbytes, flops = temporal_p_cost(b, s, c, t_tok)
        bms, by = bound(nbytes, flops)
        fwd_nbytes, fwd_flops = temporal_cost(b, s, c, t_tok)
        log(f"  emit_p B={b} S={s} C={c} T={t_tok}: out bit-equal to the "
            f"plain kernel's; max_abs_err {err:.3e} (tol {BF16_TOL}); p row "
            f"sums within {sum_err:.2e} of 1 (tol {P_SUM_TOL:.2e}); kernel "
            f"{ms:.3f} ms ({rate(ms, flops, bms)}), twin {plain_ms:.3f} ms, "
            f"bound {bms:.4f} ms ({by}); the forward without p at this "
            f"training shape {fwd_ms:.3f} ms ("
            f"{rate(fwd_ms, fwd_flops, bound(fwd_nbytes, fwd_flops)[0])})")
        if (b, s, c, t_tok) == (TRAIN_BATCH, 9216, 64, 11):
            report["temporal_fwd_p"].update(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, shape=[b, FRAMES, s, c, t_tok])


def head_inputs(bf_, n, c, gen, k_scale=HEAD_K_SCALE, m_c=1):
    """linear_inputs with an O(1) update: the v columns of w_qkv times
    HW * HEAD_V_SCALE, the key columns times k_scale."""
    import torch

    a = linear_inputs(bf_, n, c, gen, m_c=m_c)
    del a["ctx"], a["z"]
    w = a["w_qkv"].float()
    w[:, HIDDEN:2 * HIDDEN] *= k_scale
    w[:, 2 * HIDDEN:] *= n * HEAD_V_SCALE
    a["w_qkv"] = w.to(torch.bfloat16)
    return a


def phase_head(report):
    """The head-layout linear forward at every shape of the sampling (22
    folded frames) and training (44) paths, its update against the twin's;
    then |k| on both sides of 60, where it must follow its unclamped twin
    and miss the clamped merged twin."""
    import torch

    from videometamaterials_tpu_torch.ops.cuda import fused_linear_block as lin
    from videometamaterials_tpu_torch.ops.norms import channel_layer_norm

    gen = torch.Generator(device="cuda").manual_seed(9)
    kw = dict(heads=HEADS, scale=32 ** -0.5)
    log("  head layout bounds: bf16 products at the tensor-core rate, the "
        "float32 ones as the kernel takes them, split into bf16 hi + lo: the "
        "QKV projection, ctx, Q ctx three times, the out-projection twice")
    for bf_, n, c in sorted(set(LINEAR_PATH) | set(TRAIN_LINEAR),
                            key=lambda v: (-v[1], v[0])):
        a = head_inputs(bf_, n, c, gen)
        want = lin.linear_block_head_plain(**a, **kw, spatial_size=n)
        err = check_update(f"head {bf_, n, c}", lin.linear_block_head(
            **a, **kw, spatial_size=n), want, a["x"], a["out_bias"])
        upd_rms = (want.float() - a["x"].float() - a["out_bias"]).pow(2
                                                                      ).mean(
            ).sqrt().item()
        ms = cuda_ms(lambda: lin.linear_block_head(**a, **kw, spatial_size=n))
        plain_ms = cuda_ms(lambda: lin.linear_block_head_plain(
            **a, **kw, spatial_size=n), reps=2, warmup=1)
        bms, by = bound(*head_cost(bf_, n, c))
        log(f"  head BF={bf_} N={n} C={c}: update err {err:.3e} (update rms "
            f"{upd_rms:.3f}, tol {APPLY_TOL} of its max) kernel {ms:.3f} ms, "
            f"twin {plain_ms:.3f} ms, bound {bms:.4f} ms ({by})")
        if (bf_, n, c) == (22, 9216, 64):
            report["linear_head"].update(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, shape=[bf_, n, c])

    a = head_inputs(22, 9216, 64, gen, k_scale=HEAD_CLAMP_K_SCALE)
    y = channel_layer_norm(a["x"], a["gamma"], one_pass=False)
    keys = y.float() @ a["w_qkv"][:, HIDDEN:2 * HIDDEN].float()
    if not ((keys.abs() > 60).any() and (keys.abs() < 60).any()):
        raise AssertionError("the clamp case has no |k| on both sides of 60")
    del y, keys
    got = lin.linear_block_head(**a, **kw, spatial_size=9216)
    want = lin.linear_block_head_plain(**a, **kw, spatial_size=9216)
    err = check_update("head, |k| across 60", got, want, a["x"],
                       a["out_bias"])
    clamped = lin.linear_block_plain(**a, **kw, spatial_size=9216)
    base = a["x"].float() + a["out_bias"]
    gap = ((clamped.float() - base) - (got.float() - base)).abs().max().item()
    size = (want.float() - base).abs().max().item()
    if not gap > APPLY_TOL * size:
        raise AssertionError(f"head, |k| across 60: the clamped merged twin is "
                             f"within {gap:.3e} of the kernel, inside "
                             f"{APPLY_TOL} * {size:.3e}: the case cannot tell "
                             "a clamp")
    log(f"  head BF=22 N=9216 C=64, keys x{HEAD_CLAMP_K_SCALE:g} (|k| across "
        f"60): update err {err:.3e} against the unclamped twin; the clamped "
        f"merged twin is {gap:.3e} away ({gap / size:.2f} of the update's "
        f"max)")


def phase_bwd_kernels(report):
    """Each backward kernel against its twin at every training-path shape;
    times and bounds at level 0 (the merged linear row: its largest shape,
    level 1, since level 0 takes the per-head row)."""
    import torch

    from videometamaterials_tpu_torch.ops.cuda import fused_linear_block as lin
    from videometamaterials_tpu_torch.ops.cuda import fused_temporal_block as tmp

    gen = torch.Generator(device="cuda").manual_seed(5)
    t_names = ("dx", "dgamma", "dw_all", "dw_out", "dek", "dev", "dbias")
    for b, s, c, t_tok in sorted(set(TRAIN_TEMPORAL),
                                 key=lambda v: (-v[1], v[3])):
        a = temporal_inputs(b, s, c, t_tok, gen)
        g = torch.randn(a["x"].shape, generator=gen, device="cuda").to(
            torch.bfloat16)
        err, share, at = check_cotangents(
            f"temporal bwd {b, s, c, t_tok}", t_names,
            tmp.temporal_block_bwd(**a, g=g, heads=HEADS),
            tmp.temporal_block_bwd_plain(**a, g=g, heads=HEADS))
        ms = cuda_ms(lambda: tmp.temporal_block_bwd(**a, g=g, heads=HEADS),
                     reps=3, warmup=1)
        plain_ms = cuda_ms(lambda: tmp.temporal_block_bwd_plain(
            **a, g=g, heads=HEADS), reps=2, warmup=1)
        nbytes, flops = temporal_bwd_cost(b, s, c, t_tok)
        bms, by = bound(nbytes, flops)
        log(f"  temporal bwd B={b} S={s} C={c} T={t_tok}: max_abs_err "
            f"{err:.3e} (worst {at}, {share:.2e} of its max, tol {GRAD_TOL}) "
            f"kernel {ms:.3f} ms ({rate(ms, flops, bms)}), twin "
            f"{plain_ms:.3f} ms, bound {bms:.4f} ms ({by})")
        if (b, s, c, t_tok) == (TRAIN_BATCH, 9216, 64, 11):
            report["temporal_bwd"].update(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, shape=[b, FRAMES, s, c, t_tok])

    linear_bwd_kernels(report, gen)


def linear_bwd_kernels(report, gen):
    """The linear backward (rows 6-7) against its twin at every training-path
    shape on the route bwd_route gives it, bit-equal over two launches;
    then |k| across the merged route's clamp at a ragged N on both routes."""
    import torch

    from videometamaterials_tpu_torch.ops.cuda import fused_linear_block as lin

    l_names = ("dx", "dgamma", "dw_qkv", "dw_out", "dout_bias", "dek", "dev")
    for bf_, n, c in sorted(set(TRAIN_LINEAR), key=lambda v: -v[1]):
        a = linear_inputs(bf_, n, c, gen)
        del a["ctx"], a["z"]
        a["ek"] = (a["ek"].float() + cond_key_shift(n)).to(torch.bfloat16)
        g = torch.randn(a["x"].shape, generator=gen, device="cuda").to(
            torch.bfloat16)
        route = lin.bwd_route(n)
        kw = dict(heads=HEADS, scale=32 ** -0.5, spatial_size=n, route=route)
        got = lin.linear_block_bwd(**a, g=g, **kw)
        err, share, at = check_cotangents(
            f"linear bwd {route} {bf_, n, c}", l_names, got,
            lin.linear_block_bwd_plain(**a, g=g, **kw))
        if not all(torch.equal(u, v) for u, v in zip(
                got, lin.linear_block_bwd(**a, g=g, **kw)) if u is not None):
            raise AssertionError(f"linear bwd {route} {bf_, n, c}: two launches "
                                 "differ")
        del got
        ms = cuda_ms(lambda: lin.linear_block_bwd(**a, g=g, **kw), reps=3,
                     warmup=1)
        plain_ms = cuda_ms(lambda: lin.linear_block_bwd_plain(**a, g=g, **kw),
                           reps=2, warmup=1)
        nbytes, flops = linear_bwd_cost(bf_, n, c)
        bms, by = bound(nbytes, flops)
        log(f"  linear bwd ({route}) BF={bf_} N={n} C={c}: max_abs_err "
            f"{err:.3e} (worst {at}, {share:.2e} of its max, tol {GRAD_TOL}) "
            f"kernel {ms:.3f} ms ({rate(ms, flops, bms)}), twin "
            f"{plain_ms:.3f} ms, bound {bms:.4f} ms ({by})")
        key = f"linear_bwd_{route}"
        if (n, c) in ((9216, 64), (2304, 128)):
            report[key].update(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                               bound_ms=bms, bound_by=by, shape=[bf_, n, c])

    # |k| across 60: N = 100 (a ragged last tile), head 0's key columns
    # times HEAD_CLAMP_K_SCALE and its conditioning keys ~ 60 N(0, 1). The
    # merged route must follow its clamped twin (dk, dek zero where
    # |k| >= 60), the per-head route its unclamped twin, and the twins must
    # differ by more than the tolerance, or the case could not see a clamp
    n = 100
    a = linear_inputs(TRAIN_BATCH * FRAMES, n, 64, gen)
    del a["ctx"], a["z"]
    w = a["w_qkv"].float()
    w[:, HIDDEN:HIDDEN + 32] *= HEAD_CLAMP_K_SCALE
    a["w_qkv"] = w.to(torch.bfloat16)
    ek = a["ek"].float() + cond_key_shift(n)
    ek[..., :32] = torch.randn(ek[..., :32].shape, generator=gen,
                               device="cuda") * 60.0
    a["ek"] = ek.to(torch.bfloat16)
    from videometamaterials_tpu_torch.ops.norms import channel_layer_norm
    keys = (channel_layer_norm(a["x"], a["gamma"], one_pass=False).float()
            @ a["w_qkv"][:, HIDDEN:HIDDEN + 32].float())
    if not ((keys.abs() > 60).any() and (keys.abs() < 60).any()
            and (a["ek"][..., :32].float().abs() > 60).any()):
        raise AssertionError("the backward clamp case has no |k| on both "
                             "sides of 60")
    g = torch.randn(a["x"].shape, generator=gen, device="cuda").to(
        torch.bfloat16)
    twins = {}
    for route in ("merged", "head"):
        kw = dict(heads=HEADS, scale=32 ** -0.5, spatial_size=n, route=route)
        twins[route] = lin.linear_block_bwd_plain(**a, g=g, **kw)
        err, share, at = check_cotangents(
            f"linear bwd {route}, |k| across 60", l_names,
            lin.linear_block_bwd(**a, g=g, **kw), twins[route])
        log(f"  linear bwd ({route}) BF={TRAIN_BATCH * FRAMES} N={n} C=64, "
            f"keys x{HEAD_CLAMP_K_SCALE:g} (|k| across 60): max_abs_err "
            f"{err:.3e} (worst {at}, {share:.2e} of its max, tol {GRAD_TOL}) "
            f"against its {'clamped' if route == 'merged' else 'unclamped'} "
            "twin")
    gaps = {name: (u - v).abs().max().item() / v.abs().max().item()
            for name, u, v in zip(l_names, twins["merged"], twins["head"])
            if name in ("dw_qkv", "dek")}
    if not gaps["dw_qkv"] > GRAD_TOL:
        raise AssertionError(f"linear bwd, |k| across 60: the routes' twins "
                             f"differ by {gaps} of their max, inside "
                             f"{GRAD_TOL}: the case cannot tell a clamp")
    log("  linear bwd, |k| across 60: the clamped and unclamped twins differ "
        "by " + ", ".join(f"{k} {v:.3f}" for k, v in gaps.items())
        + " of their max")


# ------------------------------------------------------- phase 9 ablations

# conditioning tokens of the paper's ablation (model.yaml:26-29): the JAX
# UNet3D's default 6, model.yaml's cond_attention_tokens 16 (the CNN arm,
# its hidden broadcast), and the GRU arm's token a curve point (the 50 of
# the 51-point curves' tail)
ABLATION_T = (6, 16, 50)
ABLATION_MC = (16, 50)
ABLATION_TRAIN_STEPS = 5
# the level shapes (spatial, channels) of both paths
LEVELS = sorted({(s, c) for _, s, c, _ in TEMPORAL_PATH},
                key=lambda v: (-v[0], v[1]))


def ablation_kernels(report, kept=None):
    """9 (a): rows 1-3 at every level shape of the sampling (batch 2) and
    training (batch 4) paths at ABLATION_T tokens, each against its twin
    (row 2's out bit-equal to row 1's); rows 4-7 at ABLATION_MC
    conditioning tokens (the training shapes on their backward route, and
    N = 100 on both routes), row 8 at 16, against their twins; and, with
    `kept` (phase 2's T = 11 inputs and outputs), row 1 at T = 11
    bit-equal to phase 2's launch. The level-0 numbers go to the report's
    `ablation` entries."""
    import torch

    from videometamaterials_tpu_torch.ops.cuda import _build
    from videometamaterials_tpu_torch.ops.cuda import fused_linear_block as lin
    from videometamaterials_tpu_torch.ops.cuda import fused_temporal_block as tmp

    lib = _build.load_library()
    for t_tok in ABLATION_T + (tmp.MAX_COND_TOKENS,):
        log(f"  T={t_tok}: dynamic shared memory, forward attention "
            + ", ".join(f"C={c} {lib.vmt_temporal_block_fwd_smem(c, t_tok, 0)}"
                        for c in (64, 128, 256, 512))
            + " B; backward attention "
            + ", ".join(f"C={c} {lib.vmt_temporal_block_bwd_smem(c, t_tok, 0)}"
                        for c in (64, 128, 256, 512)) + " B")
    for shape, (a, out) in (kept or {}).items():
        if not torch.equal(tmp.fused_temporal_block(**a, heads=HEADS), out):
            raise AssertionError(f"temporal {shape}: T = 11 output is not "
                                 "bit-equal to phase 2's")
    if kept:
        log(f"  row 1 at T=11: bit-equal to phase 2's launch at {len(kept)} "
            "shapes")

    def entry(name, key, **kw):
        report[name].setdefault("ablation", {})[key] = kw

    gen = torch.Generator(device="cuda").manual_seed(21)
    t_names = ("dx", "dgamma", "dw_all", "dw_out", "dek", "dev", "dbias")
    for t_tok in ABLATION_T + (tmp.MAX_COND_TOKENS,):
        for s, c in LEVELS:
            for b in (2, TRAIN_BATCH):
                if t_tok == tmp.MAX_COND_TOKENS and (b, s) != (TRAIN_BATCH,
                                                                576):
                    continue          # the largest count: one shape
                a = temporal_inputs(b, s, c, t_tok, gen)
                shape = (b, s, c, t_tok)
                out = tmp.fused_temporal_block(**a, heads=HEADS)
                err = check_close(f"temporal {shape}", out,
                                  tmp.temporal_block_plain(**a, heads=HEADS),
                                  BF16_TOL)
                ms = cuda_ms(lambda: tmp.temporal_block_fwd(**a, heads=HEADS),
                             reps=3, warmup=1)
                plain_ms = cuda_ms(lambda: tmp.temporal_block_plain(
                    **a, heads=HEADS), reps=1, warmup=0)
                bms, by = bound(*temporal_cost(*shape))
                msg = (f"  T={t_tok} B={b} S={s} C={c}: row 1 err {err:.3e} "
                       f"(tol {BF16_TOL}) {ms:.3f} ms, twin {plain_ms:.3f} ms,"
                       f" bound {bms:.4f} ms ({by})")
                if (b, s, c) == (2, 9216, 64):
                    entry("fused_temporal_block", f"T={t_tok}",
                          shape=[b, FRAMES, s, c, t_tok], max_abs_err=err,
                          ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by)
                if b == TRAIN_BATCH:
                    o_p, p_w = tmp.temporal_block_fwd(**a, heads=HEADS,
                                                      emit_p=True)
                    if not torch.equal(o_p, out):
                        raise AssertionError(f"emit_p {shape}: out is not "
                                             "bit-equal to row 1's")
                    want_out, want_p = tmp.temporal_block_plain_p(**a,
                                                                  heads=HEADS)
                    err_p = max(check_close(f"emit_p {shape} out", o_p,
                                            want_out, BF16_TOL),
                                check_close(f"emit_p {shape} p", p_w, want_p,
                                            BF16_TOL))
                    sums = p_w.float().reshape(b, FRAMES, s, FRAMES + t_tok,
                                               HEADS).sum(dim=3)
                    sum_err = (sums - 1).abs().max().item()
                    if not sum_err <= P_SUM_TOL:
                        raise AssertionError(f"emit_p {shape}: p sums to one "
                                             f"within {sum_err:.3e}")
                    del o_p, p_w, want_out, want_p, sums
                    ms_p = cuda_ms(lambda: tmp.temporal_block_fwd(
                        **a, heads=HEADS, emit_p=True), reps=3, warmup=1)
                    plain_p = cuda_ms(lambda: tmp.temporal_block_plain_p(
                        **a, heads=HEADS), reps=1, warmup=0)
                    bms_p, by_p = bound(*temporal_p_cost(*shape))
                    g = torch.randn(a["x"].shape, generator=gen,
                                    device="cuda").to(torch.bfloat16)
                    err_b, share, at = check_cotangents(
                        f"temporal bwd {shape}", t_names,
                        tmp.temporal_block_bwd(**a, g=g, heads=HEADS),
                        tmp.temporal_block_bwd_plain(**a, g=g, heads=HEADS))
                    ms_b = cuda_ms(lambda: tmp.temporal_block_bwd(
                        **a, g=g, heads=HEADS), reps=3, warmup=1)
                    plain_b = cuda_ms(lambda: tmp.temporal_block_bwd_plain(
                        **a, g=g, heads=HEADS), reps=1, warmup=0)
                    bms_b, by_b = bound(*temporal_bwd_cost(*shape))
                    msg += (f"; row 2 err {err_p:.3e}, p sums {sum_err:.1e}, "
                            f"{ms_p:.3f} ms, twin {plain_p:.3f} ms, bound "
                            f"{bms_p:.4f} ms ({by_p}); row 3 err {err_b:.3e} "
                            f"(worst {at}, {share:.2e} of its max, tol "
                            f"{GRAD_TOL}) {ms_b:.3f} ms, twin {plain_b:.3f} "
                            f"ms, bound {bms_b:.4f} ms ({by_b})")
                    if (s, c) == (9216, 64):
                        entry("temporal_fwd_p", f"T={t_tok}",
                              shape=[b, FRAMES, s, c, t_tok],
                              max_abs_err=err_p, ms=ms_p, plain_ms=plain_p,
                              bound_ms=bms_p, bound_by=by_p)
                        entry("temporal_bwd", f"T={t_tok}",
                              shape=[b, FRAMES, s, c, t_tok],
                              max_abs_err=err_b, ms=ms_b, plain_ms=plain_b,
                              bound_ms=bms_b, bound_by=by_b)
                    del g
                log(msg)
                del a, out

    akw = dict(heads=HEADS, scale=32 ** -0.5)
    for m_c in ABLATION_MC:
        for bf_, n, c in (sorted(set(LINEAR_PATH), key=lambda v: -v[1])
                          + LINEAR_RAGGED):
            a = linear_inputs(bf_, n, c, gen, m_c=m_c)
            kw = dict(heads=HEADS, spatial_size=n)
            stats = (a["x"], a["gamma"], a["w_qkv"], a["ek"], a["ev"])
            ctx_k, z_k = lin.linear_stats(*stats, **kw)
            again = lin.linear_stats(*stats, **kw)
            if not (torch.equal(ctx_k, again[0])
                    and torch.equal(z_k, again[1])):
                raise AssertionError(f"stats {bf_, n, c} Mc={m_c}: two "
                                     "launches differ")
            ctx_p, z_p = lin.linear_stats_plain(*stats, **kw)
            err_c, share = check_ctx(f"stats ctx {bf_, n, c} Mc={m_c}", ctx_k,
                                     ctx_p, lin.linear_stats_magnitude(
                                         *stats, **kw))
            err_s = max(err_c, check_close(f"stats z {bf_, n, c} Mc={m_c}",
                                           z_k, z_p, STATS_TOL))
            args = (a["x"], a["gamma"], a["w_qkv"], a["w_out"],
                    a["out_bias"], a["ctx"], a["z"])
            err_a = check_update(f"apply {bf_, n, c} Mc={m_c}",
                                 lin.linear_apply(*args, **akw),
                                 lin.linear_apply_plain(*args, **akw),
                                 a["x"], a["out_bias"])
            sms = cuda_ms(lambda: lin.linear_stats(*stats, **kw), reps=3,
                          warmup=1)
            splain = cuda_ms(lambda: lin.linear_stats_plain(*stats, **kw),
                             reps=1, warmup=0)
            ams = cuda_ms(lambda: lin.linear_apply(*args, **akw), reps=3,
                          warmup=1)
            aplain = cuda_ms(lambda: lin.linear_apply_plain(*args, **akw),
                             reps=1, warmup=0)
            sb, sby = bound(*stats_cost(bf_, n, c, m_c))
            ab, aby = bound(*apply_cost(bf_, n, c))
            log(f"  Mc={m_c} BF={bf_} N={n} C={c}: stats (row 4) bit-equal "
                f"over two launches, err {err_s:.3e} (ctx {share:.2e} of its "
                f"summands' magnitude) {sms:.3f} ms, twin {splain:.3f} ms, "
                f"bound {sb:.4f} ms ({sby}); apply (row 5, O(1) stats) update"
                f" err {err_a:.3e} {ams:.3f} ms, twin {aplain:.3f} ms, bound "
                f"{ab:.4f} ms ({aby})")
            if (bf_, n, c) == (22, 9216, 64):
                entry("linear_stats", f"Mc={m_c}", shape=[bf_, n, c, m_c],
                      max_abs_err=err_s, ms=sms, plain_ms=splain, bound_ms=sb,
                      bound_by=sby)
                entry("linear_apply", f"Mc={m_c}", shape=[bf_, n, c, m_c],
                      max_abs_err=err_a, ms=ams, plain_ms=aplain, bound_ms=ab,
                      bound_by=aby)
            del a, ctx_p, z_p, ctx_k, z_k, again

    l_names = ("dx", "dgamma", "dw_qkv", "dw_out", "dout_bias", "dek", "dev")
    for m_c in ABLATION_MC:
        shapes = [(bf_, n, c, lin.bwd_route(n))
                  for bf_, n, c in sorted(set(TRAIN_LINEAR),
                                          key=lambda v: -v[1])]
        shapes += [(TRAIN_BATCH * FRAMES, 100, 64, r)
                   for r in ("merged", "head")]
        for bf_, n, c, route in shapes:
            a = linear_inputs(bf_, n, c, gen, m_c=m_c)
            del a["ctx"], a["z"]
            # the Mc tokens together take about half of each feature's
            # token softmax (cond_key_shift's rule over N / Mc)
            a["ek"] = (a["ek"].float() + cond_key_shift(max(n // m_c, 1))
                       ).to(torch.bfloat16)
            g = torch.randn(a["x"].shape, generator=gen, device="cuda").to(
                torch.bfloat16)
            kw = dict(heads=HEADS, scale=32 ** -0.5, spatial_size=n,
                      route=route)
            got = lin.linear_block_bwd(**a, g=g, **kw)
            err, share, at = check_cotangents(
                f"linear bwd {route} {bf_, n, c} Mc={m_c}", l_names, got,
                lin.linear_block_bwd_plain(**a, g=g, **kw))
            if not all(torch.equal(u, v) for u, v in zip(
                    got, lin.linear_block_bwd(**a, g=g, **kw))
                    if u is not None):
                raise AssertionError(f"linear bwd {route} {bf_, n, c} "
                                     f"Mc={m_c}: two launches differ")
            del got
            ms = cuda_ms(lambda: lin.linear_block_bwd(**a, g=g, **kw), reps=3,
                         warmup=1)
            plain_ms = cuda_ms(lambda: lin.linear_block_bwd_plain(
                **a, g=g, **kw), reps=1, warmup=0)
            bms, by = bound(*linear_bwd_cost(bf_, n, c, m_c))
            log(f"  Mc={m_c} linear bwd (row {6 if route == 'head' else 7}, "
                f"{route}) BF={bf_} N={n} C={c}: max_abs_err {err:.3e} (worst"
                f" {at}, {share:.2e} of its max, tol {GRAD_TOL}) bit-equal "
                f"over two launches, {ms:.3f} ms, twin {plain_ms:.3f} ms, "
                f"bound {bms:.4f} ms ({by})")
            if (n, c) in ((9216, 64), (2304, 128)):
                entry(f"linear_bwd_{route}", f"Mc={m_c}",
                      shape=[bf_, n, c, m_c], max_abs_err=err, ms=ms,
                      plain_ms=plain_ms, bound_ms=bms, bound_by=by)
            del a, g

    m_c = ABLATION_MC[0]
    for bf_, n, c in sorted(set(LINEAR_PATH), key=lambda v: -v[1]):
        a = head_inputs(bf_, n, c, gen, m_c=m_c)
        want = lin.linear_block_head_plain(**a, **akw, spatial_size=n)
        err = check_update(f"head {bf_, n, c} Mc={m_c}",
                           lin.linear_block_head(**a, **akw, spatial_size=n),
                           want, a["x"], a["out_bias"])
        ms = cuda_ms(lambda: lin.linear_block_head(**a, **akw,
                                                   spatial_size=n),
                     reps=3, warmup=1)
        plain_ms = cuda_ms(lambda: lin.linear_block_head_plain(
            **a, **akw, spatial_size=n), reps=1, warmup=0)
        bms, by = bound(*head_cost(bf_, n, c, m_c))
        log(f"  Mc={m_c} head layout (row 8) BF={bf_} N={n} C={c}: update "
            f"err {err:.3e} (tol {APPLY_TOL} of its max) {ms:.3f} ms, twin "
            f"{plain_ms:.3f} ms, bound {bms:.4f} ms ({by})")
        if (bf_, n, c) == (22, 9216, 64):
            entry("linear_head", f"Mc={m_c}", shape=[bf_, n, c, m_c],
                  max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                  bound_by=by)
        del a, want


def phase_model(diffusion, cfg, batch: int = 1):
    """One guided forward of `batch` latents (the CFG pair doubles it):
    the fused plans (the kernels) against the unfused plans on the same
    weights and input."""
    import torch

    model = diffusion.model
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((batch, FRAMES, cfg.image_size, cfg.image_size, 3),
                    generator=gen, device="cuda")
    t = torch.full((batch,), 128, device="cuda")
    cond = torch.rand((batch, cfg.cond_length), generator=gen,
                      device="cuda") * 2 - 1
    with torch.no_grad():
        fused = diffusion.guided_eps(x, t, cond, 5.0)
        with model.fused_plans(False):
            unfused = diffusion.guided_eps(x, t, cond, 5.0)
    if not torch.isfinite(fused).all():
        raise AssertionError("fused-plan eps is not finite")
    rel = ((fused - unfused).norm() / unfused.norm()).item()
    # bf16 activations through ~60 layers, two plans that round in
    # different places: a few percent; a wrong kernel gives O(1)
    if rel > MODEL_TOL:
        raise AssertionError(f"fused vs unfused plan: relative error {rel}")
    return rel


def _param_groups(model):
    """Parameter name -> group: the fused temporal blocks, the fused linear
    blocks, the relative position bias table, and the rest."""
    from videometamaterials_tpu_torch.models.unet3d import (
        SpatialLinearAttentionBlock,
        TemporalAttentionBlock,
    )

    groups = {n: "rest" for n, _ in model.named_parameters()}
    groups["time_rel_pos_bias.relative_attention_bias.weight"] = "bias table"
    for prefix, m in model.named_modules():
        kind = {TemporalAttentionBlock: "temporal blocks",
                SpatialLinearAttentionBlock: "linear blocks"}.get(type(m))
        if kind:
            for n, _ in m.named_parameters():
                groups[f"{prefix}.{n}"] = kind
    return groups


def phase_train(cfg, train_steps: int, report, profile: int = 0,
                profile_out: str | None = None) -> dict:
    """The train step under the four plans: 'kernel' (fused blocks, their
    backward kernels), 'saved' (the same with temporal_vjp: saved: the
    emit_p forward and the backward from the saved softmax weights),
    'recompute' (fused blocks, autograd through the twins) and 'unfused'.
    One step's gradients compared on the same batch (kernel and saved
    against recompute and unfused), then `train_steps` timed steps each."""
    import torch

    from videometamaterials_tpu_torch.config import TrainerConfig
    from videometamaterials_tpu_torch.diffusion.gaussian import (
        GaussianDiffusion,
    )
    from videometamaterials_tpu_torch.models.unet3d import build_unet
    from videometamaterials_tpu_torch.ops.cuda import _build
    from videometamaterials_tpu_torch.train import bench_batches
    from videometamaterials_tpu_torch.training.trainer import StepTrainer

    plans = {"kernel": cfg,
             "saved": cfg.replace(temporal_vjp="saved"),
             "recompute": cfg.replace(fused_bwd_kernels=False),
             "unfused": cfg.replace(fused_blocks_in_training=False)}

    def build(plan_cfg):
        model = build_unet(plan_cfg, device="cuda", seed=0)
        return GaussianDiffusion.from_config(model, plan_cfg, "cuda")

    # ---- one step's gradients, the four plans on the same numbers
    gen = torch.Generator(device="cuda").manual_seed(6)
    videos, labels = next(bench_batches(cfg, gen, "cuda"))
    b = cfg.batch_size
    t = torch.randint(0, cfg.train_timesteps, (b,), generator=gen,
                      device="cuda")
    noise = torch.randn(videos.shape, generator=gen, device="cuda")
    mask = torch.tensor([False, True] + [False] * (b - 2), device="cuda")
    grads, groups = {}, None
    for name, plan_cfg in plans.items():
        diff = build(plan_cfg)
        with diff.model.fused_plans(plan_cfg.fused_blocks_in_training):
            loss = diff.loss(videos, labels, t=t, noise=noise,
                             null_cond_mask=mask)
        loss.backward()
        grads[name] = {n: p.grad for n, p in diff.model.named_parameters()
                       if p.grad is not None}
        groups = groups or _param_groups(diff.model)
        del diff
    for plan, ref in (("kernel", "recompute"), ("kernel", "unfused"),
                      ("saved", "recompute"), ("saved", "unfused")):
        rel = {}
        for g in ("temporal blocks", "linear blocks", "bias table", "rest"):
            names = [n for n in grads[plan] if groups[n] == g]
            num = sum((grads[plan][n] - grads[ref][n]).float().pow(2).sum()
                      for n in names)
            den = sum(grads[ref][n].float().pow(2).sum() for n in names)
            rel[g] = (num / den).sqrt().item()
        worst, worst_name, smallest = 0.0, "", {}
        for n, g in grads[plan].items():
            if groups[n] == "rest":
                continue
            w = grads[ref][n].float()
            size = w.abs().max().item()
            if size == 0:
                raise AssertionError(f"gradient of {n} under the {ref} plan "
                                     "is zero")
            share = (g.float() - w).abs().max().item() / size
            if not share <= GRAD_TOL:
                raise AssertionError(
                    f"gradient of {n}, {plan} plan against {ref}: "
                    f"{share:.3e} of its max, beyond {GRAD_TOL}")
            if g.abs().max().item() == 0:
                raise AssertionError(f"gradient of {n} is zero")
            worst, worst_name = max((worst, worst_name), (share, n))
            smallest[groups[n]] = min((size, n), smallest.get(groups[n],
                                                              (size, n)))
        log(f"  grads, {plan} plan vs {ref}: relative L2 " + ", ".join(
            f"{k} {v:.3e}" for k, v in rel.items()) + f"; every fused-block "
            f"parameter within {worst:.3e} of its own max (worst "
            f"{worst_name}, limit {GRAD_TOL}); smallest max " + ", ".join(
                f"{k} {v:.3e} ({n})" for k, (v, n) in smallest.items()))
    del grads

    # ---- train_steps steps under each plan
    # EMA every 2 steps from step 4: the reset, the skip and the lerp
    tcfg = TrainerConfig(ema_update_every=2, ema_start_step=4)
    per_step = {"kernel": dict(fused_temporal_block=10, linear_stats=8,
                               linear_apply=8, temporal_bwd=10,
                               linear_bwd_head=2, linear_bwd_merged=6),
                "saved": dict(temporal_fwd_p=10, linear_stats=8,
                              linear_apply=8, linear_bwd_head=2,
                              linear_bwd_merged=6),
                "recompute": dict(fused_temporal_block=10, linear_stats=8,
                                  linear_apply=8, temporal_bwd=0,
                                  linear_bwd_head=0, linear_bwd_merged=0),
                "unfused": {}}
    out = {}
    for name, plan_cfg in plans.items():
        diff = build(plan_cfg)
        model = diff.model
        gen = torch.Generator(device="cuda").manual_seed(7)
        trainer = StepTrainer(diff, plan_cfg, tcfg,
                              bench_batches(plan_cfg, gen, "cuda"),
                              generator=gen)
        start = [p.detach().clone() for p in model.parameters()]
        shadow = [p.detach().clone() for p in model.parameters()]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        losses, times = [], []
        for step in range(train_steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = trainer.step()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(loss.item())
            with torch.no_grad():       # the EMA rule, written out
                if step % tcfg.ema_update_every == 0:
                    for e, p in zip(shadow, model.parameters()):
                        if step < tcfg.ema_start_step:
                            e.copy_(p)
                        else:
                            e.mul_(tcfg.ema_decay).add_(
                                p, alpha=1.0 - tcfg.ema_decay)
        counts = dict(_build.LAUNCH_COUNTS)
        peak = torch.cuda.max_memory_allocated()
        want = {k: per_step[name].get(k, 0) * train_steps for k in counts}
        if counts != want:
            raise AssertionError(f"{name} plan: launch counts {counts}, "
                                 f"expected {want}")
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"{name} plan: losses {losses}")
        if not any(not torch.equal(a, p)
                   for a, p in zip(start, model.parameters())):
            raise AssertionError(f"{name} plan: no parameter moved")
        for e, want_e in zip(trainer.state.ema, shadow):
            torch.testing.assert_close(e, want_e, rtol=1e-6, atol=1e-7)
        med = statistics.median(times) * 1e3
        out[name] = dict(median_ms=med, peak_bytes=peak, losses=losses,
                         counts=counts)
        log(f"  {name} plan: {train_steps} steps, median {med:.1f} ms a "
            f"step (min {min(times) * 1e3:.1f}, first {times[0] * 1e3:.1f}),"
            f" peak memory {peak / 2 ** 30:.2f} GiB, loss {losses[0]:.4f} -> "
            f"{losses[-1]:.4f}; launches {counts}")
        if name == "saved":
            report["temporal_fwd_p"]["launches"] = counts["temporal_fwd_p"]
        if name == "kernel":
            for k in ("temporal_bwd", "linear_bwd_head",
                      "linear_bwd_merged"):
                report[k]["launches"] = counts[k]
            if profile:
                profile_steps(
                    lambda: [trainer.step() for _ in range(profile)],
                    f"{profile} train steps, kernel plan", profile_out)
        del diff, model, trainer, start, shadow
        torch.cuda.empty_cache()
    return out


EVAL_CHUNK = 4          # videos a sampling call takes in phase 6
EVAL_PER_STEP = dict(fused_temporal_block=10, linear_stats=8, linear_apply=8)


def eval_data(root: Path, seed: int = 6) -> Path:
    """A seeded data root of the eval path: lagrangian/training with
    16 51-point stress-strain curves and 8-column frame ranges (u_2
    through zero), and two target curves."""
    import numpy as np

    rng = np.random.default_rng(seed)
    train = root / "lagrangian" / "training"
    train.mkdir(parents=True)
    strains = np.linspace(0.0, 0.2, 51)
    slopes = rng.uniform(0.5, 2.0, 18)
    curves = slopes[:, None] * strains * (1 + rng.uniform(-1, 1, (18, 1))
                                          * strains)
    np.savetxt(train / "stress_strain_data.csv", curves[:16], delimiter=",")
    ranges = np.stack([-rng.uniform(0.01, 0.05, 16),
                       rng.uniform(0.01, 0.05, 16),
                       -rng.uniform(0.1, 0.3, 16),
                       rng.uniform(0.0, 0.02, 16),
                       rng.uniform(0.5, 2.0, 16),
                       -rng.uniform(0.5, 2.0, 16),
                       rng.uniform(0.0, 0.5, 16),
                       rng.uniform(0.1, 1.0, 16)], axis=1)
    np.savetxt(train / "frame_range_data.csv", ranges, delimiter=",")
    np.savetxt(root / "target_responses.csv", curves[16:], delimiter=",")
    return root


def phase_eval(smi: str, report: dict) -> dict:
    """6 eval: checkpoint -> bit-equal state dict -> the kernels at the
    eval chunk -> the eval CLI -> GIFs and geometries.csv."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from videometamaterials_tpu_torch import main as cli
    from videometamaterials_tpu_torch.config import (
        ModelConfig,
        snapshot_run_config,
    )
    from videometamaterials_tpu_torch.convert import (
        flax_to_torch_state_dict,
        torch_to_flax_tree,
    )
    from videometamaterials_tpu_torch.data.gif_io import gif_to_array
    from videometamaterials_tpu_torch.models.unet3d import build_unet
    from videometamaterials_tpu_torch.ops.cuda import _build
    from videometamaterials_tpu_torch.sample import build_sampler
    from videometamaterials_tpu_torch.training import checkpoint as ckpt
    from videometamaterials_tpu_torch.training import msgpack_io
    from videometamaterials_tpu_torch.training.artifacts import (
        make_grid_video,
    )
    from videometamaterials_tpu_torch.utils import inference_cast_keys

    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="smoke_eval_", dir=ROOT / "build"))
    try:
        # (a) the flagship's seeded weights as a run checkpoint
        t0 = time.perf_counter()
        cfg = ModelConfig()
        model = build_unet(cfg, device="cpu", seed=5)
        state = {k: v.detach().clone() for k, v in model.state_dict().items()}
        bf16 = inference_cast_keys(model)
        del model
        tree = torch_to_flax_tree(state, bf16)
        run_dir = tmp / "runs" / "smoke"
        snapshot_run_config(cfg, run_dir)
        path = ckpt.save_checkpoint(run_dir, 0, {
            "step": np.asarray(0, np.int32), "params": tree,
            "ema_params": tree}, aux={"step": 0})
        # (b) the data folder and the targets
        data = eval_data(tmp / "data")
        # (c) read back: the bf16-rounded weights, bit for bit
        back = flax_to_torch_state_dict(
            msgpack_io.read_msgpack(path)["ema_params"])
        for k, v in state.items():
            want = v.to(torch.bfloat16).float() if k in bf16 else v
            if not torch.equal(back[k], want):
                raise AssertionError(f"checkpoint round trip: {k} differs")
        log(f"  checkpoint {path.stat().st_size / 1e6:.1f} MB, {len(state)} "
            f"tensors ({len(bf16)} bf16) read back bit-equal | "
            f"{time.perf_counter() - t0:.1f}s")

        # (d) the kernels at the eval chunk: one guided eps against the
        # unfused plans
        t0 = time.perf_counter()
        diffusion = build_sampler(cfg, device="cuda", weights=back)
        _build.reset_launch_counts()
        rel = phase_model(diffusion, cfg, batch=EVAL_CHUNK)
        counts = dict(_build.LAUNCH_COUNTS)
        want = {k: EVAL_PER_STEP.get(k, 0) for k in counts}
        if counts != want:
            raise AssertionError(f"eval-chunk eps: launch counts {counts}")
        del diffusion, back
        torch.cuda.empty_cache()
        log(f"  guided eps at {EVAL_CHUNK} videos (CFG {2 * EVAL_CHUNK}), "
            f"fused vs unfused plans: relative error {rel:.3e} (limit "
            f"{MODEL_TOL}) | {time.perf_counter() - t0:.1f}s")

        # (e) the CLI: 2 targets x 2 predictions, one chunk of 4
        argv = ["--run-name", "smoke", "--runs-root", str(tmp / "runs"),
                "--data-root", str(data), "--config", str(ROOT / "model.yaml"),
                "--load-model-step", "0", "--skip-train",
                "--guidance-scale", "5", "--device", "cuda"]
        _build.reset_launch_counts()
        out = cli.main(argv + ["--num-preds", "2", "--test-batch-size",
                               str(2 * EVAL_CHUNK)])
        counts = dict(_build.LAUNCH_COUNTS)
        steps = cfg.train_timesteps
        want = {k: EVAL_PER_STEP.get(k, 0) * steps for k in counts}
        if counts != want:
            raise AssertionError(f"eval CLI: launch counts {counts}, "
                                 f"expected {want}")
        for k, v in counts.items():
            report[k]["eval_launches"] = v

        # (f) the artifacts
        videos, eval_dir = out["videos"], out["eval_dir"]
        if eval_dir != run_dir / "eval_target_w_5.0_0" / "step_0":
            raise AssertionError(f"eval directory {eval_dir}")
        if videos.shape != (4, FRAMES, cfg.image_size, cfg.image_size, 3) \
                or not np.isfinite(videos).all() or videos.min() < 0 \
                or videos.max() > 1:
            raise AssertionError(f"eval videos {videos.shape} in "
                                 f"[{videos.min()}, {videos.max()}]")
        grid = make_grid_video(videos, rows=2)
        side = 2 * (cfg.image_size + 4)
        for j, ch in enumerate(cfg.selected_channels):
            frames = gif_to_array(eval_dir / "gifs"
                                  / f"prediction_channel_{ch}.gif")
            quant = np.clip(np.round(grid[j] * 255.0), 0, 255
                            ).astype(np.uint8)
            if frames.shape != (FRAMES, side, side) or not np.array_equal(
                    frames, quant):
                raise AssertionError(f"prediction_channel_{ch}.gif: "
                                     f"{frames.shape} differs from the "
                                     "videos")
        geoms = np.loadtxt(eval_dir / "geometries.csv", delimiter=",")
        half = cfg.image_size // 2
        if geoms.shape != (4, half * half) or not np.isin(geoms,
                                                          (0, 1)).all():
            raise AssertionError(f"geometries.csv: {geoms.shape}")
        one = tmp / "one_target.csv"
        one.write_text((data / "target_responses.csv").read_text()
                       .splitlines()[0] + "\n")
        again = cli.main(argv + ["--target-labels", str(one)])
        if again["eval_dir"] != run_dir / "eval_target_w_5.0_1" / "step_0":
            raise AssertionError(f"second eval directory "
                                 f"{again['eval_dir']}")
        # (g) the chain at the eval chunk
        secs = out["sample_seconds"]
        log(f"[6 eval] eval CLI, 2 targets x 2 predictions, chunk "
            f"{EVAL_CHUNK} (CFG {2 * EVAL_CHUNK}), w=5, DDPM-{steps}: "
            f"chain {secs:.2f}s, {4 * 60.0 / secs:.3f} videos/min on {smi}; "
            f"launches {counts}; 3 GIFs {FRAMES}x{side}x{side} equal to the "
            f"videos, geometries.csv {geoms.shape[0]} rows of "
            f"{geoms.shape[1]} (solid share {geoms.mean():.3f}); second run "
            f"{again['eval_dir'].parent.name}")
        # (h) phase 10's rendering input: the GIFs and the frame ranges
        render_src = ROOT / "build" / "smoke_render_src"
        shutil.rmtree(render_src, ignore_errors=True)
        shutil.copytree(eval_dir / "gifs", render_src / "gifs")
        shutil.copy(data / "lagrangian" / "training"
                    / "frame_range_data.csv", render_src)
        return {"chain_s": secs, "rel": rel, "counts": counts,
                "render_src": render_src}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


TRAIN_CLI_STEPS, TRAIN_CLI_EVERY = 20, 10
TRAIN_PER_STEP = dict(fused_temporal_block=10, linear_stats=8,
                      linear_apply=8, temporal_bwd=10, linear_bwd_head=2,
                      linear_bwd_merged=6)
# run B's step-20 state against run A's: the largest |difference| of a
# tensor over that tensor's largest |element|, for the parameters, the
# Adam moments and the EMA. The kernels are deterministic (ordered sums, no
# atomics), so what a resume can change is what a rerun changes: the
# convolutions' backward, which cuDNN may sum in another order in another
# process. On an H100 (torch 2.11, CUDA 12.8) the resumed run's step-20
# state was bit-equal to the unbroken run's; RESUME_TOL leaves room for a
# cuDNN backward that sums with atomics on another card or version.
RESUME_TOL = 1e-3


def train_data(root: Path, seed: int = 8) -> Path:
    """A seeded GIF folder of the train path, written with the port's
    array_to_gif: lagrangian/training (8 videos) and lagrangian/validation
    (4 videos) of 11 x 96 x 96 in every lagrangian channel folder (u_1,
    u_2, s_mises, s_22) plus topo, each with stress_strain_data.csv and
    frame_range_data.csv; and two target curves."""
    import numpy as np

    from videometamaterials_tpu_torch.data.gif_io import array_to_gif

    rng = np.random.default_rng(seed)
    strains = np.linspace(0.0, 0.2, 51)
    for split, n in (("training", 8), ("validation", 4)):
        folder = root / "lagrangian" / split
        for name in ("topo", "u_1", "u_2", "s_mises", "s_22"):
            (folder / "gifs" / name).mkdir(parents=True)
        for i in range(n):
            quarter = rng.random((6, 6)) < 0.6
            half = np.concatenate([quarter, quarter[::-1]], axis=0)
            topo = np.kron(np.concatenate([half, half[:, ::-1]], axis=1),
                           np.ones((8, 8)))
            array_to_gif(np.repeat(topo[None], FRAMES, 0),
                         folder / "gifs" / "topo" / f"{i}.gif")
            for name in ("u_1", "u_2", "s_mises", "s_22"):
                coarse = rng.random((FRAMES, 12, 12))
                field = np.kron(coarse, np.ones((8, 8))) * topo
                array_to_gif(field, folder / "gifs" / name / f"{i}.gif")
        slopes = rng.uniform(0.5, 2.0, n)
        np.savetxt(folder / "stress_strain_data.csv",
                   slopes[:, None] * strains, delimiter=",")
        np.savetxt(folder / "frame_range_data.csv", np.stack([
            -rng.uniform(0.01, 0.05, n), rng.uniform(0.01, 0.05, n),
            -rng.uniform(0.1, 0.3, n), rng.uniform(0.0, 0.02, n),
            rng.uniform(0.5, 2.0, n), -rng.uniform(0.5, 2.0, n),
            rng.uniform(0.0, 0.5, n), rng.uniform(0.1, 1.0, n)], axis=1),
            delimiter=",")
    np.savetxt(root / "target_responses.csv",
               rng.uniform(0.5, 2.0, (2, 1)) * strains, delimiter=",")
    return root


def phase_train_cli(smi: str, report: dict, step_ms_phase5: float) -> dict:
    """7 train: the train CLI on a GIF folder (run A), a resume of its
    step 10 (run B) against it, and the refusal of a cache-restored
    step."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from videometamaterials_tpu_torch import main as cli
    from videometamaterials_tpu_torch.config import (
        load_model_yaml,
        save_model_yaml,
    )
    from videometamaterials_tpu_torch.ops.cuda import _build
    from videometamaterials_tpu_torch.training.msgpack_io import read_msgpack
    from videometamaterials_tpu_torch.training.trainer import Trainer

    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="smoke_train_", dir=ROOT / "build"))
    step_times, saves, float32_after = [], [], []
    step, save, milestone = Trainer.step, Trainer.save, Trainer.eval_network

    def timed_step(self):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(self)
        torch.cuda.synchronize()
        step_times.append(time.perf_counter() - t0)
        return loss

    def counted_save(self, s=None):
        saves.append(self.state.step if s is None else s)
        return save(self, s)

    def checked_milestone(self, *a, **kw):
        out = milestone(self, *a, **kw)
        bad = [n for n, p in self.state.model.named_parameters()
               if p.dtype != torch.float32]
        if bad:
            raise AssertionError(f"parameters cast by the milestone: "
                                 f"{bad[:3]}")
        float32_after.append(self.state.step)
        return out

    Trainer.step, Trainer.save = timed_step, counted_save
    Trainer.eval_network = checked_milestone
    try:
        t0 = time.perf_counter()
        data = train_data(tmp / "data")
        cfg = load_model_yaml(ROOT / "model.yaml").replace(
            fused_blocks_in_training=True, fused_bwd_kernels=True)
        cfg_path = tmp / "model_train.yaml"
        save_model_yaml(cfg, cfg_path)
        log(f"  data folder (12 videos of {FRAMES}x96x96 in 5 channel "
            f"folders) and config | {time.perf_counter() - t0:.1f}s")
        common = ["--config", str(cfg_path), "--data-root", str(data),
                  "--num-samples", "1", "--num-preds", "1",
                  "--fidelity-probe", str(data / "target_responses.csv"),
                  "--fidelity-probe-targets", "1",
                  "--fidelity-probe-preds", "2", "--test-batch-size", "8",
                  "--skip-eval-target", "--train-num-steps",
                  str(TRAIN_CLI_STEPS), "--save-and-sample-every",
                  str(TRAIN_CLI_EVERY), "--device", "cuda"]

        # ---- run A: 20 steps, milestones at 10 and 20
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        out = cli.main(["--run-name", "A", "--runs-root", str(tmp / "runs"),
                        *common])
        counts = dict(_build.LAUNCH_COUNTS)
        peak = torch.cuda.max_memory_allocated()
        wall_a = time.perf_counter() - t0
        trainer = out["trainer"]
        timings = trainer.timings
        del out, trainer
        torch.cuda.empty_cache()
        run_a = tmp / "runs" / "A"
        milestones = TRAIN_CLI_STEPS // TRAIN_CLI_EVERY
        # each milestone: one validation batch (4 videos) on the train plan
        # and two sampling calls (1 curve, 2 probe curves), each one chunk
        # of 4 through the 256-step chain
        sampling_steps = milestones * 2 * cfg.train_timesteps
        val_batches = milestones
        want = {k: TRAIN_PER_STEP.get(k, 0) * TRAIN_CLI_STEPS
                + EVAL_PER_STEP.get(k, 0) * (sampling_steps + val_batches)
                for k in counts}
        if counts != want:
            raise AssertionError(f"train CLI: launch counts {counts}, "
                                 f"expected {want}")
        for k, v in counts.items():
            report[k]["train_cli_launches"] = v
        if saves != [10, 20]:
            raise AssertionError(f"run A saved steps {saves}")
        if float32_after != [10, 20]:
            raise AssertionError(f"float32 checked after {float32_after}")
        records = [json.loads(line) for line in
                   (run_a / "metrics.jsonl").read_text().splitlines()]
        losses = [r["training loss"] for r in records
                  if "training loss" in r]
        if len(losses) != TRAIN_CLI_STEPS or not all(
                math.isfinite(v) for v in losses):
            raise AssertionError(f"training losses {losses}")
        for s in (10, 20):
            keys = {k for r in records if r["step"] == s for k in r}
            if not {"validation loss", "fidelity probe NRMSE"} <= keys:
                raise AssertionError(f"metrics.jsonl at step {s}: {keys}")
            for sub in ("", "fidelity_probe/"):
                for ch in cfg.selected_channels:
                    gif = (run_a / "training" / f"step_{s}" / f"{sub}gifs"
                           / f"prediction_channel_{ch}.gif")
                    if not gif.exists():
                        raise AssertionError(f"missing {gif}")
        probe = [r["fidelity probe NRMSE"] for r in records
                 if "fidelity probe NRMSE" in r]
        if not all(math.isfinite(v) for v in probe):
            raise AssertionError(f"probe NRMSE {probe}")
        step_ms = statistics.median(step_times) * 1e3
        ms = {k: [t[k] for t in timings if k in t]
              for k in ("save", "validation_loss", "fidelity_probe",
                        "sampling")}
        log(f"  run A: {TRAIN_CLI_STEPS} steps in {wall_a:.1f}s, median "
            f"{step_ms:.1f} ms a step (phase 5's kernel plan "
            f"{step_ms_phase5:.1f}; first {step_times[0] * 1e3:.1f}), loss "
            f"{losses[0]:.4f} -> {losses[-1]:.4f}; a milestone: validation "
            f"loss {statistics.mean(ms['validation_loss']):.2f}s, probe "
            f"{statistics.mean(ms['fidelity_probe']):.2f}s (NRMSE "
            + ", ".join(f"{v:.3f}" for v in probe) + "), samples "
            f"{statistics.mean(ms['sampling']):.2f}s; checkpoint "
            f"{statistics.mean(ms['save']):.2f}s; peak memory "
            f"{peak / 2 ** 30:.2f} GiB; launches {counts}")

        # ---- run B: run A's step 10 resumed to step 20
        t0 = time.perf_counter()
        run_b = tmp / "runs_b" / "A"
        (run_b / "model").mkdir(parents=True)
        shutil.copy(run_a / "model" / "model.yaml", run_b / "model")
        shutil.copytree(run_a / "model" / "step_10",
                        run_b / "model" / "step_10")
        saves.clear()
        step_times.clear()
        cli.main(["--run-name", "A", "--runs-root", str(tmp / "runs_b"),
                  "--load-model-step", "10", *common])
        if saves != [20]:
            raise AssertionError(f"run B saved steps {saves}")
        a = read_msgpack(run_a / "model" / "step_20" / "checkpoint.msgpack")
        b = read_msgpack(run_b / "model" / "step_20" / "checkpoint.msgpack")
        worst = {}
        for section, tree_a, tree_b in (
                ("params", a["params"], b["params"]),
                ("ema", a["ema_params"], b["ema_params"]),
                ("adam mu", a["opt_state"]["0"]["0"]["mu"],
                 b["opt_state"]["0"]["0"]["mu"]),
                ("adam nu", a["opt_state"]["0"]["0"]["nu"],
                 b["opt_state"]["0"]["0"]["nu"])):
            flat_a = dict(_flat(tree_a))
            flat_b = dict(_flat(tree_b))
            if flat_a.keys() != flat_b.keys():
                raise AssertionError(f"run B's {section} tree differs")
            rel = {k: float(np.abs(flat_a[k] - flat_b[k]).max()
                            / max(np.abs(flat_a[k]).max(), 1e-30))
                   for k in flat_a}
            name = max(rel, key=rel.get)
            worst[section] = (rel[name], "/".join(name))
        if int(np.asarray(b["step"])) != 20 or int(np.asarray(
                b["opt_state"]["0"]["0"]["count"])) != 20:
            raise AssertionError("run B's step or Adam count is not 20")
        over = {k: v for k, v in worst.items() if v[0] > RESUME_TOL}
        log(f"  run B: step 10 resumed to 20, largest relative difference "
            f"from run A (bound RESUME_TOL {RESUME_TOL}): " + "; ".join(
                f"{k} {v:.3e} ({n})" for k, (v, n) in worst.items())
            + f" | {time.perf_counter() - t0:.1f}s")
        if over:
            raise AssertionError(f"resume differs from the unbroken run: "
                                 f"{over}")

        # ---- a cache-restored step is refused
        aux = run_b / "model" / "step_10" / "aux.json"
        aux.write_text(json.dumps({**json.loads(aux.read_text()),
                                   "restored_from_cache": True}))
        try:
            cli.main(["--run-name", "A", "--runs-root", str(tmp / "runs_b"),
                      "--load-model-step", "10", *common])
        except ValueError as e:
            if "step 10" not in str(e) or "restored_from_cache" not in str(e):
                raise
        else:
            raise AssertionError("a cache-restored step was resumed")
        log(f"[7 train] train CLI on a GIF folder: {TRAIN_CLI_STEPS} steps "
            f"at batch {cfg.batch_size}, median {step_ms:.1f} ms a step, "
            f"peak {peak / 2 ** 30:.2f} GiB on {smi}; resume within "
            f"{RESUME_TOL}; cache-restored step refused")
        return {"step_ms": step_ms, "peak_bytes": peak, "worst": worst,
                "timings": timings, "counts": counts}
    finally:
        Trainer.step, Trainer.save = step, save
        Trainer.eval_network = milestone
        shutil.rmtree(tmp, ignore_errors=True)


DDIM_STEPS = 64         # phase 8's DDIM chain
INTERP_T = 32           # phase 8's interpolate: noised to t, t steps back
# the reference's SpatialLinearAttention holds its 1x1 projections as
# Conv2d weights (O, I, 1, 1); the port's are (O, I, 1, 1, 1)
_CONV2D_KEY = r"(downs|ups)\.\d+\.2\.fn\.fn\.to_(qkv|out)\.weight"


def reference_checkpoint(path: Path, cfg, seed: int = 9) -> dict:
    """Write the flagship's seeded weights as the reference's
    checkpoint.pt ({model, ema, optimizer, steps}; keys under denoise_fn.,
    the Conv2d weights 4-d, the diffusion's schedule buffers beside them;
    the online weights the EMA's negated) and return the EMA's state
    dict."""
    import re

    import torch

    from videometamaterials_tpu_torch.models.unet3d import build_unet
    from videometamaterials_tpu_torch.ops.schedules import make_schedule

    model = build_unet(cfg, device="cpu", seed=seed)
    ema = {k: v.detach().clone() for k, v in model.state_dict().items()}
    del model
    schedule = make_schedule(cfg.train_timesteps, "cpu")
    buffers = {f"denoise_fn.{k}": v for k, v in vars(schedule).items()}

    def reference(state):
        out = {}
        for k, v in state.items():
            if re.fullmatch(_CONV2D_KEY, k):
                v = v.reshape(v.shape[:4])
            out[f"denoise_fn.{k}"] = v
        return {**out, **buffers}

    torch.save({"model": reference({k: -v for k, v in ema.items()}),
                "ema": reference(ema),
                "optimizer": {"state": {}, "param_groups": []},
                "steps": 0}, path)
    return ema


def phase_ddim(smi: str, report: dict, ddpm_chain_s: float) -> dict:
    """8 ddim: a reference checkpoint.pt imported bit for bit, the eval
    CLI on it with two guidance arms of the DDIM-64 chain, then
    interpolate on its bf16 sampler."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from videometamaterials_tpu_torch import main as cli
    from videometamaterials_tpu_torch.config import ModelConfig
    from videometamaterials_tpu_torch.data.gif_io import gif_to_array
    from videometamaterials_tpu_torch.diffusion.gaussian import (
        GaussianDiffusion,
    )
    from videometamaterials_tpu_torch.models.unet3d import (
        state_dict_template,
    )
    from videometamaterials_tpu_torch.ops.cuda import _build
    from videometamaterials_tpu_torch.training.artifacts import (
        make_grid_video,
    )
    from videometamaterials_tpu_torch.training.torch_import import (
        load_reference_weights,
    )
    from videometamaterials_tpu_torch.utils import inference_cast_keys

    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="smoke_ddim_", dir=ROOT / "build"))
    cfg = ModelConfig()
    calls, samplers, step_log = [], [], []
    ddim_sample, ddim_step = GaussianDiffusion.ddim_sample, \
        GaussianDiffusion.ddim_step
    build = cli.build_sampler

    def counted_sample(self, *a, **kw):
        steps0, before = len(step_log), dict(_build.LAUNCH_COUNTS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = ddim_sample(self, *a, **kw)
        torch.cuda.synchronize()
        calls.append({"seconds": time.perf_counter() - t0,
                      "steps": len(step_log) - steps0,
                      "launches": {k: _build.LAUNCH_COUNTS[k] - before[k]
                                   for k in before}})
        return out

    def counted_step(self, *a, **kw):
        step_log.append(a[1:3])
        return ddim_step(self, *a, **kw)

    GaussianDiffusion.ddim_sample = counted_sample
    GaussianDiffusion.ddim_step = counted_step
    cli.build_sampler = lambda *a, **kw: samplers.append(build(*a, **kw)) \
        or samplers[-1]
    try:
        # (a) the reference checkpoint.pt, imported bit for bit
        t0 = time.perf_counter()
        path = tmp / "checkpoint.pt"
        ema = reference_checkpoint(path, cfg)
        got = load_reference_weights(path, state_dict_template(cfg), "ema")
        if got.keys() != ema.keys() or not all(
                torch.equal(got[k], v) for k, v in ema.items()):
            raise AssertionError("checkpoint.pt import differs from the "
                                 "weights written")
        online = load_reference_weights(path, state_dict_template(cfg),
                                        "model")
        if not all(torch.equal(online[k], -v) for k, v in ema.items()):
            raise AssertionError("checkpoint.pt's online weights differ")
        log(f"  checkpoint.pt {path.stat().st_size / 1e6:.1f} MB, "
            f"{len(ema)} tensors a state dict, imported bit-equal | "
            f"{time.perf_counter() - t0:.1f}s")

        # (b) the eval CLI: two arms of DDIM-64, 2 targets x 2 predictions
        t0 = time.perf_counter()
        data = eval_data(tmp / "data", seed=10)
        argv = ["--run-name", "ddim", "--runs-root", str(tmp / "runs"),
                "--data-root", str(data), "--config", str(ROOT / "model.yaml"),
                "--skip-train", "--torch-checkpoint", str(path),
                "--sampling-timesteps", str(DDIM_STEPS),
                "--guidance-arms", "5,2:0.7", "--num-preds", "2",
                "--test-batch-size", str(2 * EVAL_CHUNK), "--device", "cuda"]
        _build.reset_launch_counts()
        out = cli.main(argv)
        counts = dict(_build.LAUNCH_COUNTS)
        per_call = {k: EVAL_PER_STEP.get(k, 0) * DDIM_STEPS for k in counts}
        if len(calls) != 2 or any(c["steps"] != DDIM_STEPS
                                  or c["launches"] != per_call
                                  for c in calls):
            raise AssertionError(f"DDIM sampling calls {calls}, expected "
                                 f"2 of {DDIM_STEPS} steps with {per_call}")
        if counts != {k: 2 * v for k, v in per_call.items()}:
            raise AssertionError(f"DDIM eval CLI: launch counts {counts}")
        for k, v in per_call.items():
            report[k]["ddim_launches"] = v
        sampler = samplers[0]
        cast = inference_cast_keys(sampler.model)
        weights = sampler.model.state_dict()
        for k, v in ema.items():
            want = v.to(torch.bfloat16) if k in cast else v
            if not torch.equal(weights[k].cpu(), want):
                raise AssertionError(f"the CLI's sampler: {k} is not the "
                                     "imported EMA")
        run_dir = tmp / "runs" / "ddim"
        names = ["eval_target_w_5.0_0", "eval_target_w_2.0_phi_0.7_0"]
        side = 2 * (cfg.image_size + 4)
        for arm, name in zip(out["arms"], names):
            d, videos = arm["eval_dir"], arm["videos"]
            if d != run_dir / name / "step_0":
                raise AssertionError(f"arm directory {d}")
            if videos.shape != (4, FRAMES, cfg.image_size, cfg.image_size,
                                3) or not np.isfinite(videos).all():
                raise AssertionError(f"arm videos {videos.shape}")
            grid = make_grid_video(videos, rows=2)
            for j, ch in enumerate(cfg.selected_channels):
                frames = gif_to_array(d / "gifs"
                                      / f"prediction_channel_{ch}.gif")
                quant = np.clip(np.round(grid[j] * 255.0), 0, 255
                                ).astype(np.uint8)
                if frames.shape != (FRAMES, side, side) or \
                        not np.array_equal(frames, quant):
                    raise AssertionError(f"{name}: prediction_channel_{ch}"
                                         ".gif differs from the videos")
            geoms = np.loadtxt(d / "geometries.csv", delimiter=",")
            if geoms.shape != (4, (cfg.image_size // 2) ** 2):
                raise AssertionError(f"{name}: geometries.csv {geoms.shape}")
        chain = [c["seconds"] for c in calls]
        log(f"  eval CLI, --guidance-arms 5,2:0.7, DDIM-{DDIM_STEPS} (eta "
            f"{cfg.ddim_sampling_eta}), chunk {EVAL_CHUNK} (CFG "
            f"{2 * EVAL_CHUNK}): chains " + " / ".join(
                f"{s:.2f}s ({4 * 60.0 / s:.3f} videos/min)" for s in chain)
            + f" against phase 6's DDPM-{cfg.train_timesteps} "
            f"{ddpm_chain_s:.2f}s ({chain[0] / ddpm_chain_s:.3f} of it) on "
            f"{smi}; {DDIM_STEPS} steps and {per_call} launches a call; "
            f"{', '.join(names)} with GIFs equal to the videos | "
            f"{time.perf_counter() - t0:.1f}s")

        # (c) interpolate on the CLI's bf16 sampler, batch 2, from t = 32
        t0 = time.perf_counter()
        videos = torch.from_numpy(out["arms"][0]["videos"]).cuda() * 2 - 1
        gen = torch.Generator(device="cuda").manual_seed(11)
        cond = torch.rand((2, FRAMES), generator=gen, device="cuda") * 2 - 1
        steps0 = len(step_log)
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        mixed = sampler.interpolate(videos[:2], videos[2:], t=INTERP_T,
                                    lam=0.5, guidance_scale=5.0, cond=cond,
                                    generator=gen)
        torch.cuda.synchronize()
        interp_s = time.perf_counter() - t0
        counts = dict(_build.LAUNCH_COUNTS)
        want = {k: EVAL_PER_STEP.get(k, 0) * INTERP_T for k in counts}
        if counts != want or len(step_log) != steps0:
            raise AssertionError(f"interpolate: launch counts {counts}, "
                                 f"expected {want}")
        if tuple(mixed.shape) != (2, FRAMES, cfg.image_size, cfg.image_size,
                                  3) or not torch.isfinite(mixed).all():
            raise AssertionError(f"interpolate: {tuple(mixed.shape)}, "
                                 "finite values expected")
        log(f"  interpolate, batch 2 (CFG 4), from t = {INTERP_T}: "
            f"{INTERP_T} steps in {interp_s:.2f}s, launches {counts}, "
            f"values in [{mixed.min().item():.3f}, {mixed.max().item():.3f}]")
        log(f"[8 ddim] checkpoint.pt import, DDIM-{DDIM_STEPS} arms "
            f"{chain[0]:.2f} / {chain[1]:.2f}s against DDPM-"
            f"{cfg.train_timesteps} {ddpm_chain_s:.2f}s, interpolate "
            f"{interp_s:.2f}s on {smi}")
        return {"chain_s": chain, "interp_s": interp_s}
    finally:
        GaussianDiffusion.ddim_sample = ddim_sample
        GaussianDiffusion.ddim_step = ddim_step
        cli.build_sampler = build
        shutil.rmtree(tmp, ignore_errors=True)


def _flat(tree, prefix=()):
    """(path, float64 array) of every leaf of a nested dict."""
    import numpy as np

    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v, np.float64)


def profile_steps(run, what: str, out_path: str | None) -> None:
    """Device time by kernel over run() (warmed by one call first), and the
    share of the wall time the device was busy (sum of kernel times /
    wall)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    # kernel rows only: an operator's row repeats its kernels' device time
    rows = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in rows)
    ported_us = sum(e.self_device_time_total for e in rows
                    if any(k in e.key for k in PORTED_KERNELS))
    by_kernel = {k: sum(e.self_device_time_total for e in rows if k in e.key)
                 for k in PORTED_KERNELS}
    # the host's side: aten operator calls and their own CPU time
    ops = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU
           and e.key.startswith("aten::")]
    # each fused block's backward with every kernel its autograd node
    # launches (the contraction and column sums it shares included)
    node = "autograd::engine::evaluate_function: "
    by_node = {e.key[len(node):]: e.device_time_total for e in events
               if e.key.startswith(node) and "Fused" in e.key}
    table = events.table(sort_by="self_device_time_total", row_limit=40,
                         max_name_column_width=60)
    if out_path:
        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        Path(out_path).write_text(table)
    log(table[:6000])
    log(f"[profile] {what}: wall {wall_ms:.1f} ms, device busy "
        f"{device_us / 1e3:.1f} ms ({100 * device_us / 1e3 / wall_ms:.1f}%), "
        f"of which the port's kernels {ported_us / 1e3:.1f} ms "
        f"({100 * ported_us / max(device_us, 1):.1f}%): " + ", ".join(
            f"{k} {v / 1e3:.2f}" for k, v in by_kernel.items() if v)
        + f" ms; host: {sum(e.count for e in ops)} aten operator calls, "
        f"{sum(e.self_cpu_time_total for e in ops) / 1e3:.1f} ms of their own "
        "CPU time")
    if by_node:
        log(f"[profile] {what}, device ms by fused backward node, all its "
            "kernels: " + ", ".join(f"{k} {v / 1e3:.2f}"
                                    for k, v in sorted(by_node.items())))


@contextlib.contextmanager
def environ(**values):
    """Environment variables (the JAX package's VMT_* switches) set for the
    block's duration."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v


def linear_layout(layout: str):
    """VMT_LINEAR_LAYOUT, the JAX package's switch of the fused linear
    blocks' layout, set for the block's duration."""
    return environ(VMT_LINEAR_LAYOUT=layout)


def run_chain(diffusion, cfg, steps: int, per_step: dict, smi: str,
              what: str) -> tuple[dict, float]:
    """The guided DDPM chain of one video from the counters at zero;
    checks the launch counters against per_step (launches a step, absent
    ones 0), the videos' shape, finiteness and range. Returns the
    counters and the chain's seconds."""
    import torch

    from videometamaterials_tpu_torch.ops.cuda import _build

    t0 = time.perf_counter()
    cond = torch.rand((1, cfg.cond_length),
                      generator=torch.Generator().manual_seed(2)) * 2 - 1
    gen = torch.Generator(device="cuda").manual_seed(3)
    _build.reset_launch_counts()
    videos = diffusion.sample(cond, 5.0, generator=gen, num_steps=steps)
    torch.cuda.synchronize()
    chain_s = time.perf_counter() - t0
    counts = dict(_build.LAUNCH_COUNTS)
    want = {k: per_step.get(k, 0) * steps for k in counts}
    if counts != want:
        raise AssertionError(f"{what}: launch counts {counts}, expected "
                             f"{want}")
    if tuple(videos.shape) != (1, FRAMES, cfg.image_size, cfg.image_size, 3):
        raise AssertionError(f"{what}: videos shape {tuple(videos.shape)}")
    if not torch.isfinite(videos).all():
        raise AssertionError(f"{what}: sampled videos are not finite")
    lo, hi = videos.min().item(), videos.max().item()
    if steps == cfg.train_timesteps and (lo < 0.0 or hi > 1.0):
        # the last step (t = 0) returns the thresholded x0 in [-1, 1]
        raise AssertionError(f"{what}: videos outside [0, 1]: [{lo}, {hi}]")
    rate = (f"{60.0 / chain_s:.3f} videos/min" if steps == cfg.train_timesteps
            else f"{chain_s / steps * 1e3:.1f} ms a step (partial chain)")
    log(f"[{what}] guided DDPM, {steps} steps, batch 1 (CFG pair 2), w=5: "
        f"{chain_s:.2f}s, {rate} on {smi}; launches {counts}; videos "
        f"{tuple(videos.shape)} in [{lo:.3f}, {hi:.3f}]")
    return counts, chain_s


def ablation_configs() -> dict:
    """The paper's conditioning ablations at the flagship's widths:
    model.yaml with per_frame_cond: false and the conditioning keys of
    each arm (model.yaml:19-29), seeded weights (no trained ablation
    checkpoint exists)."""
    from videometamaterials_tpu_torch.config import load_model_yaml

    base = load_model_yaml(ROOT / "model.yaml").replace(per_frame_cond=False)
    cnn = base.replace(unet_cond_attention="self-stacked",
                       unet_cond_attention_tokens=16, unet_cond_att_GRU=False)
    return {"ablation-CNN": cnn,
            "ablation-GRU": cnn.replace(unet_cond_att_GRU=True),
            "no-cond": base.replace(unet_cond_attention="none"),
            "cross-attention": cnn.replace(
                unet_cond_attention="cross-attention")}


def ablation_models(arms: dict) -> None:
    """9 (b): one guided forward of each arm, the fused plans (10/8/8
    launches) against the unfused plans on the same input; the
    cross-attention arm has only the unfused plans (no launch)."""
    import torch

    from videometamaterials_tpu_torch.ops.cuda import _build
    from videometamaterials_tpu_torch.sample import build_sampler

    for name, cfg in arms.items():
        t0 = time.perf_counter()
        diffusion = build_sampler(cfg, device="cuda", seed=0)
        _build.reset_launch_counts()
        rel = phase_model(diffusion, cfg)
        torch.cuda.synchronize()
        counts = dict(_build.LAUNCH_COUNTS)
        cross = cfg.unet_cond_attention == "cross-attention"
        want = {k: 0 if cross else EVAL_PER_STEP.get(k, 0) for k in counts}
        if counts != want:
            raise AssertionError(f"{name} eps: launch counts {counts}, "
                                 f"expected {want}")
        model = diffusion.model
        log(f"  {name}: {model.num_tokens} conditioning tokens "
            f"({'the GRU' if model.cond_att_GRU else 'the CNN hidden'}"
            f"{', none' if not model.num_tokens else ''}), guided eps "
            + ("unfused plans only (cross-attention), finite"
               if cross else f"fused vs unfused plans: relative error "
               f"{rel:.3e} (limit {MODEL_TOL}); launches {counts}")
            + f" | {time.perf_counter() - t0:.1f}s")
        del diffusion, model
        torch.cuda.empty_cache()


def ablation_train(cfg, steps: int, kernel_ms: float) -> float:
    """9 (d): `steps` kernel-plan train steps of the CNN arm at batch 4:
    10/10/8/8/2/6 launches a step, finite losses, moved parameters (the
    CNN embedder's among them). Returns the median step ms."""
    import torch

    from videometamaterials_tpu_torch.config import TrainerConfig
    from videometamaterials_tpu_torch.diffusion.gaussian import (
        GaussianDiffusion,
    )
    from videometamaterials_tpu_torch.models.unet3d import build_unet
    from videometamaterials_tpu_torch.ops.cuda import _build
    from videometamaterials_tpu_torch.train import bench_batches
    from videometamaterials_tpu_torch.training.trainer import StepTrainer

    cfg = cfg.replace(fused_blocks_in_training=True, fused_bwd_kernels=True)
    diff = GaussianDiffusion.from_config(build_unet(cfg, device="cuda",
                                                    seed=0), cfg, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(7)
    trainer = StepTrainer(diff, cfg, TrainerConfig(),
                          bench_batches(cfg, gen, "cuda"), generator=gen)
    start = {n: p.detach().clone() for n, p in diff.model.named_parameters()}
    _build.reset_launch_counts()
    losses, times = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(trainer.step().item())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    counts = dict(_build.LAUNCH_COUNTS)
    want = {k: TRAIN_PER_STEP.get(k, 0) * steps for k in counts}
    if counts != want:
        raise AssertionError(f"ablation train: launch counts {counts}, "
                             f"expected {want}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"ablation train: losses {losses}")
    moved = {n for n, p in diff.model.named_parameters()
             if not torch.equal(p, start[n])}
    cnn = {n for n in start if n.startswith("sign_emb_CNN.")}
    if not cnn or not cnn <= moved:
        raise AssertionError(f"ablation train: the CNN embedder's "
                             f"parameters {sorted(cnn - moved)} did not move")
    med = statistics.median(times) * 1e3
    log(f"  ablation-CNN train, kernel plan, batch {cfg.batch_size}: "
        f"{steps} steps, median {med:.1f} ms a step (phase 5's flagship "
        f"kernel plan {kernel_ms:.1f}), loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}; {len(moved)} of {len(start)} parameters moved "
        f"(all {len(cnn)} of sign_emb_CNN); launches {counts}")
    del diff, trainer, start
    return med


def ablation_eval(cfg, smi: str, phase6_s: float) -> dict:
    """9 (e): the eval CLI on the GRU arm: a run checkpoint of its seeded
    weights and its config snapshot, two whole-curve targets x 2
    predictions in one chunk of 4, w = 5, the full DDPM chain: 10/8/8
    launches a step, the GIFs equal to the videos, geometries.csv."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from videometamaterials_tpu_torch import main as cli
    from videometamaterials_tpu_torch.config import snapshot_run_config
    from videometamaterials_tpu_torch.convert import torch_to_flax_tree
    from videometamaterials_tpu_torch.data.gif_io import gif_to_array
    from videometamaterials_tpu_torch.models.unet3d import build_unet
    from videometamaterials_tpu_torch.ops.cuda import _build
    from videometamaterials_tpu_torch.training import checkpoint as ckpt
    from videometamaterials_tpu_torch.training.artifacts import (
        make_grid_video,
    )
    from videometamaterials_tpu_torch.utils import inference_cast_keys

    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="smoke_ablation_", dir=ROOT / "build"))
    try:
        model = build_unet(cfg, device="cpu", seed=11)
        tree = torch_to_flax_tree(model.state_dict(),
                                  inference_cast_keys(model))
        del model
        run_dir = tmp / "runs" / "gru"
        snapshot_run_config(cfg, run_dir)
        ckpt.save_checkpoint(run_dir, 0, {
            "step": np.asarray(0, np.int32), "params": tree,
            "ema_params": tree}, aux={"step": 0})
        data = eval_data(tmp / "data")
        _build.reset_launch_counts()
        out = cli.main(["--run-name", "gru", "--runs-root", str(tmp / "runs"),
                        "--data-root", str(data), "--load-model-step", "0",
                        "--skip-train", "--guidance-scale", "5",
                        "--num-preds", "2", "--test-batch-size",
                        str(2 * EVAL_CHUNK), "--device", "cuda"])
        torch.cuda.synchronize()
        counts = dict(_build.LAUNCH_COUNTS)
        steps = cfg.train_timesteps
        want = {k: EVAL_PER_STEP.get(k, 0) * steps for k in counts}
        if counts != want:
            raise AssertionError(f"ablation eval CLI: launch counts {counts},"
                                 f" expected {want}")
        videos, eval_dir = out["videos"], out["eval_dir"]
        if eval_dir != run_dir / "eval_target_w_5.0_0" / "step_0":
            raise AssertionError(f"eval directory {eval_dir}")
        if videos.shape != (4, FRAMES, cfg.image_size, cfg.image_size, 3) \
                or not np.isfinite(videos).all():
            raise AssertionError(f"ablation eval videos {videos.shape}")
        grid = make_grid_video(videos, rows=2)
        side = 2 * (cfg.image_size + 4)
        for j, ch in enumerate(cfg.selected_channels):
            frames = gif_to_array(eval_dir / "gifs"
                                  / f"prediction_channel_{ch}.gif")
            quant = np.clip(np.round(grid[j] * 255.0), 0, 255
                            ).astype(np.uint8)
            if not np.array_equal(frames, quant):
                raise AssertionError(f"prediction_channel_{ch}.gif differs "
                                     "from the videos")
        geoms = np.loadtxt(eval_dir / "geometries.csv", delimiter=",")
        half = cfg.image_size // 2
        if geoms.shape != (4, half * half):
            raise AssertionError(f"geometries.csv: {geoms.shape}")
        secs = out["sample_seconds"]
        log(f"  ablation-GRU eval CLI (--skip-train), 2 whole-curve targets "
            f"x 2 predictions, chunk {EVAL_CHUNK} "
            f"(CFG {2 * EVAL_CHUNK}), w=5, DDPM-{steps}: chain {secs:.2f}s "
            f"(phase 6's flagship {phase6_s:.2f}s), {4 * 60.0 / secs:.3f} "
            f"videos/min on {smi}; launches {counts}; GIFs equal to the "
            f"videos, geometries.csv {geoms.shape[0]} rows of "
            f"{geoms.shape[1]}")
        return {"chain_s": secs, "counts": counts}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ------------------------------------------------------- phase 10 variants

FOCUS_PER_STEP = dict(linear_stats=8, linear_apply=8, linear_bwd_head=2,
                      linear_bwd_merged=6)
SAVED_PER_STEP = dict(temporal_fwd_p=10, linear_stats=8, linear_apply=8,
                      linear_bwd_head=2, linear_bwd_merged=6)
VARIANT_STEPS = 10      # timed steps of (c) under each remat setting
FOCUS_STEPS = 5         # timed steps of (a) with prob_focus_present 1.0
MICRO_STEPS = 10        # timed micro-steps of (b) after the 4 checked
S_TILE = 1152           # (d): 8 tiles at level 0, 2 at level 1
# (d): reference_temporal_block calls in one guided eps of the flagship:
# 3 level-0 blocks (init, down 0, up 3) x 8 tiles + 2 level-1 blocks x 2
S_TILE_CALLS = 3 * 8 + 2 * 2


def _counts_of(per_step: dict, steps: int = 1) -> dict:
    from videometamaterials_tpu_torch.ops.cuda import _build

    return {k: per_step.get(k, 0) * steps for k in _build.LAUNCH_COUNTS}


def _check_counts(what: str, want: dict, totals: dict) -> dict:
    from videometamaterials_tpu_torch.ops.cuda import _build

    counts = dict(_build.LAUNCH_COUNTS)
    if counts != want:
        raise AssertionError(f"{what}: launch counts {counts}, expected "
                             f"{want}")
    for k, v in counts.items():
        totals[k] = totals.get(k, 0) + v
    return counts


def _draws(cfg, gen, n: int):
    """n seeded micro-batches with their t, noise and null masks."""
    import torch

    from videometamaterials_tpu_torch.train import bench_batches

    batches = bench_batches(cfg, gen, "cuda")
    out = []
    for _ in range(n):
        videos, labels = next(batches)
        b = videos.shape[0]
        out.append(dict(
            videos=videos, labels=labels,
            t=torch.randint(0, cfg.train_timesteps, (b,), generator=gen,
                            device="cuda"),
            noise=torch.randn(videos.shape, generator=gen, device="cuda"),
            null_cond_mask=torch.rand(b, generator=gen, device="cuda") < 0.1))
    return out


def _raw_leaves(tree, prefix=()) -> dict:
    """path -> numpy leaf (its own dtype) of a nested dict."""
    import numpy as np

    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_raw_leaves(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(
                v.cpu() if hasattr(v, "cpu") else v)
    return out


def _grad_shares(what: str, got: dict, want: dict, names=None) -> float:
    """The largest |got - want| of each parameter (of `names`, default
    all) as a share of want's largest |element|; raises past GRAD_TOL.
    Returns the worst share."""
    worst = 0.0
    for n, w in want.items():
        if names is not None and n not in names:
            continue
        size = w.float().abs().max().item()
        if size == 0:
            continue
        share = (got[n].float() - w.float()).abs().max().item() / size
        if not share <= GRAD_TOL:
            raise AssertionError(f"{what}: {n} at {share:.3e} of its max, "
                                 f"beyond {GRAD_TOL}")
        worst = max(worst, share)
    return worst


def phase_variants(smi: str, report: dict, kernel_plan: dict | None,
                   render_src: Path) -> dict:
    """10: the training-side variants on the flagship's kernel plan at
    batch 4 and the rendering (see the module docstring)."""
    import shutil

    import numpy as np
    import torch

    from videometamaterials_tpu_torch import gif_visualization
    from videometamaterials_tpu_torch.config import ModelConfig, TrainerConfig
    from videometamaterials_tpu_torch.data.gif_io import gif_to_rgba
    from videometamaterials_tpu_torch.diffusion.gaussian import (
        GaussianDiffusion,
    )
    from videometamaterials_tpu_torch.models import unet3d
    from videometamaterials_tpu_torch.models.unet3d import build_unet
    from videometamaterials_tpu_torch.ops.cuda import _build
    from videometamaterials_tpu_torch.postproc.visualization import (
        load_cell_fields,
    )
    from videometamaterials_tpu_torch.sample import build_sampler
    from videometamaterials_tpu_torch.train import bench_batches
    from videometamaterials_tpu_torch.training import checkpoint as ckpt
    from videometamaterials_tpu_torch.training.msgpack_io import (
        read_msgpack,
        write_msgpack,
    )
    from videometamaterials_tpu_torch.training.optim import make_adam
    from videometamaterials_tpu_torch.training.trainer import (
        StepTrainer,
        TrainState,
        train_step,
    )

    cfg = ModelConfig().replace(fused_blocks_in_training=True,
                                fused_bwd_kernels=True)
    kernel = _counts_of(TRAIN_PER_STEP)
    phase5_ms = ("not run" if kernel_plan is None
                 else f"{kernel_plan['median_ms']:.1f} ms, "
                 f"{kernel_plan['peak_bytes'] / 2 ** 30:.2f} GiB")
    totals: dict = {}
    out = {}

    def build(plan_cfg):
        return GaussianDiffusion.from_config(
            build_unet(plan_cfg, device="cuda", seed=0), plan_cfg, "cuda")

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        return result, (time.perf_counter() - t0) * 1e3

    def grads_of(model):
        return {n: p.grad.detach().clone()
                for n, p in model.named_parameters() if p.grad is not None}

    # ---- (a) focus
    t0 = time.perf_counter()
    diff = build(cfg)
    model = diff.model
    d = _draws(cfg, torch.Generator(device="cuda").manual_seed(11), 1)[0]
    mask = torch.tensor([True, False, True, False], device="cuda")
    loss_of, grads = {}, {}
    for plan in ("kernel", "unfused"):
        model.zero_grad(set_to_none=True)
        _build.reset_launch_counts()
        with model.fused_plans(plan == "kernel"):
            loss = diff.loss(d["videos"], d["labels"], t=d["t"],
                             noise=d["noise"],
                             null_cond_mask=d["null_cond_mask"],
                             focus_present_mask=mask)
        loss.backward()
        if plan == "kernel":
            _check_counts("focus-mask gradients", _counts_of(FOCUS_PER_STEP),
                          totals)
        loss_of[plan], grads[plan] = loss.item(), grads_of(model)
    if not math.isfinite(loss_of["kernel"]):
        raise AssertionError(f"focus-mask loss {loss_of['kernel']}")
    loss_rel = abs(loss_of["kernel"] - loss_of["unfused"]) / abs(
        loss_of["unfused"])
    if loss_rel > MODEL_TOL:
        raise AssertionError(f"focus-mask loss, kernel plan against "
                             f"unfused: relative {loss_rel}")
    # as phase 5: every parameter of the blocks the plans differ in (the
    # fused ones) within GRAD_TOL; the rest (convs, norms) in bf16 only
    # by their relative L2
    groups = _param_groups(model)
    worst = _grad_shares("focus-mask gradients, kernel plan against "
                         "unfused", grads["kernel"], grads["unfused"],
                         {n for n, g in groups.items() if g != "rest"})
    rest = [n for n, g in groups.items() if g == "rest"]
    rest_rel = (sum((grads["kernel"][n] - grads["unfused"][n]).float()
                    .pow(2).sum() for n in rest)
                / sum(grads["unfused"][n].float().pow(2).sum()
                      for n in rest)).sqrt().item()
    del grads
    gen = torch.Generator(device="cuda").manual_seed(12)
    trainer = StepTrainer(diff, cfg, TrainerConfig(prob_focus_present=1.0),
                          bench_batches(cfg, gen, "cuda"), generator=gen)
    focus_ms = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(FOCUS_STEPS):
        _build.reset_launch_counts()
        loss, ms = timed(trainer.step)
        _check_counts("a step with prob_focus_present 1.0",
                      _counts_of(FOCUS_PER_STEP), totals)
        focus_ms.append(ms)
        if not math.isfinite(loss.item()):
            raise AssertionError(f"focus step loss {loss.item()}")
    _build.reset_launch_counts()
    loss = train_step(trainer.state, diff, d["videos"], d["labels"],
                      trainer.tcfg, fused_in_training=True, t=d["t"],
                      noise=d["noise"], null_cond_mask=d["null_cond_mask"],
                      focus_present_mask=mask)
    _check_counts("a step under the explicit mask [T, F, T, F]",
                  _counts_of(FOCUS_PER_STEP), totals)
    out["focus_ms"] = statistics.median(focus_ms)
    out["focus_peak"] = torch.cuda.max_memory_allocated()
    del diff, model, trainer
    torch.cuda.empty_cache()
    log(f"  (a) focus: loss kernel plan {loss_of['kernel']:.5f} vs unfused "
        f"{loss_of['unfused']:.5f} (relative {loss_rel:.3e}, limit "
        f"{MODEL_TOL}), every fused-block gradient within {worst:.3e} of "
        f"its own max (limit {GRAD_TOL}), the rest at relative L2 "
        f"{rest_rel:.3e}; prob_focus_present 1.0: median "
        f"{out['focus_ms']:.1f} ms a step of {FOCUS_STEPS}, peak "
        f"{out['focus_peak'] / 2 ** 30:.2f} GiB (phase 5's kernel plan "
        f"{phase5_ms}), explicit mask step loss "
        f"{loss.item():.4f}; launches 0/0/8/8/2/6 a step | "
        f"{time.perf_counter() - t0:.1f}s")

    # ---- (b) accumulation, k = 2 over 4 micro-steps
    t0 = time.perf_counter()
    tcfg = TrainerConfig(gradient_accumulate_every=2)
    draws = _draws(cfg, torch.Generator(device="cuda").manual_seed(13), 4)
    diff = build(cfg)
    model = diff.model
    p0 = [p.detach().clone() for p in model.parameters()]
    state = TrainState.create(model, cfg.learning_rate,
                              tcfg.gradient_accumulate_every)
    micro_ms, p2 = [], None
    tmp = ROOT / "build" / "smoke_variants"
    tmp.mkdir(parents=True, exist_ok=True)
    written = None
    for i, dr in enumerate(draws, 1):
        before = [p.detach().clone() for p in model.parameters()]
        _build.reset_launch_counts()
        loss, ms = timed(lambda: train_step(
            state, diff, dr["videos"], dr["labels"], tcfg,
            fused_in_training=True, t=dr["t"], noise=dr["noise"],
            null_cond_mask=dr["null_cond_mask"]))
        _check_counts(f"micro-step {i}", kernel, totals)
        micro_ms.append(ms)
        same = all(torch.equal(a, p) for a, p in zip(before,
                                                     model.parameters()))
        if same != (i % 2 == 1) or not math.isfinite(loss.item()):
            raise AssertionError(f"micro-step {i}: parameters "
                                 f"{'unchanged' if same else 'moved'}, "
                                 f"loss {loss.item()}")
        if i == 2:
            p2 = [p.detach().clone() for p in model.parameters()]
        if i == 3:
            named = list(model.named_parameters())
            written = ckpt.optimizer_state_tree(state.optimizer, named,
                                                clipped=False,
                                                accum=state.accum)
            path = tmp / "opt_state.msgpack"
            write_msgpack(path, written)
            back = read_msgpack(path)
            fresh = TrainState.create(build_unet(cfg, device="cuda", seed=0),
                                      cfg.learning_rate, 2)
            fresh_named = list(fresh.model.named_parameters())
            ckpt.load_optimizer_state(back, fresh.optimizer, fresh_named,
                                      clipped=False, accum=fresh.accum)
            want = _raw_leaves(written)
            for tree in (back, ckpt.optimizer_state_tree(
                    fresh.optimizer, fresh_named, clipped=False,
                    accum=fresh.accum)):
                got = _raw_leaves(tree)
                if set(got) != set(want) or any(
                        got[k].dtype != v.dtype or got[k].shape != v.shape
                        or got[k].tobytes() != v.tobytes()
                        for k, v in want.items()):
                    raise AssertionError("the MultiSteps state did not read "
                                         "back bit for bit")
            size = path.stat().st_size
            del fresh, back
    counts_adam = {int(st["step"]) for st in state.optimizer.state.values()}
    if counts_adam != {2} or state.accum.gradient_step != 2:
        raise AssertionError(f"Adam's count {counts_adam}, gradient_step "
                             f"{state.accum.gradient_step}")
    # timed micro-steps, warm: every second one runs Adam
    timed_ms = {True: [], False: []}
    for i in range(MICRO_STEPS):
        dr = draws[i % 4]
        _build.reset_launch_counts()
        _, ms = timed(lambda: train_step(
            state, diff, dr["videos"], dr["labels"], tcfg,
            fused_in_training=True, t=dr["t"], noise=dr["noise"],
            null_cond_mask=dr["null_cond_mask"]))
        _check_counts(f"timed micro-step {i}", kernel, totals)
        timed_ms[i % 2 == 1].append(ms)
    # micro-step 2's update against one Adam step on the mean, outside
    ref = build(cfg)
    sums = None
    for dr in draws[:2]:
        ref.model.zero_grad(set_to_none=True)
        with ref.model.fused_plans(True):
            ref.loss(dr["videos"], dr["labels"], t=dr["t"], noise=dr["noise"],
                     null_cond_mask=dr["null_cond_mask"]).backward()
        # no gradient (the init temporal block's unused to_k / to_v):
        # zeros, as MultiSteps accumulates it
        g = [torch.zeros_like(p) if p.grad is None else p.grad.float()
             for p in ref.model.parameters()]
        sums = g if sums is None else [a + b for a, b in zip(sums, g)]
    for p, g in zip(ref.model.parameters(), sums):
        p.grad = g / 2
    make_adam(list(ref.model.parameters()), cfg.learning_rate).step()
    names = [n for n, _ in ref.model.named_parameters()]
    worst_upd = _grad_shares(
        "micro-step 2's update against an Adam step on the mean",
        {n: a - b for n, a, b in zip(names, p2, p0)},
        {n: p.detach() - b for n, p, b in zip(names, ref.model.parameters(),
                                               p0)})
    out["micro_ms"] = statistics.median(timed_ms[True] + timed_ms[False])
    del diff, model, state, ref, sums, p0, p2
    shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    log(f"  (b) accumulation k=2: parameters unchanged after micro-steps 1 "
        f"and 3, moved after 2 and 4, Adam's count 2; micro-step 2's update "
        f"within {worst_upd:.3e} of an Adam step on the mean (limit "
        f"{GRAD_TOL}); MultiSteps state after micro-step 3 "
        f"({size / 1e6:.1f} MB msgpack) read back bit for bit; micro-steps "
        "1-4 " + ", ".join(f"{m:.1f}" for m in micro_ms) + f" ms; then "
        f"{MICRO_STEPS} more: median {out['micro_ms']:.1f} ms (with Adam "
        f"{statistics.median(timed_ms[True]):.1f}, without "
        f"{statistics.median(timed_ms[False]):.1f}; phase 5's step "
        f"{phase5_ms}); launches 10/10/8/8/2/6 a micro-step | "
        f"{time.perf_counter() - t0:.1f}s")

    # ---- (c) remat_blocks against remat off
    t0 = time.perf_counter()
    d = _draws(cfg, torch.Generator(device="cuda").manual_seed(14), 1)[0]
    one, runs = {}, {}
    for remat in (False, True):
        plan_cfg = cfg.replace(remat_blocks=remat)
        diff = build(plan_cfg)
        diff.model.zero_grad(set_to_none=True)
        with diff.model.fused_plans(True):
            diff.loss(d["videos"], d["labels"], t=d["t"], noise=d["noise"],
                      null_cond_mask=d["null_cond_mask"]).backward()
        one[remat] = grads_of(diff.model)
        diff.model.zero_grad(set_to_none=True)
        gen = torch.Generator(device="cuda").manual_seed(15)
        trainer = StepTrainer(diff, plan_cfg, TrainerConfig(),
                              bench_batches(plan_cfg, gen, "cuda"),
                              generator=gen)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        ms = [timed(trainer.step)[1] for _ in range(VARIANT_STEPS)]
        _check_counts(f"remat_blocks {remat}: {VARIANT_STEPS} steps",
                      _counts_of(TRAIN_PER_STEP, VARIANT_STEPS), totals)
        runs[remat] = dict(median_ms=statistics.median(ms),
                           peak_bytes=torch.cuda.max_memory_allocated())
        del diff, trainer
        torch.cuda.empty_cache()
    bit_equal = all(torch.equal(one[True][n], g)
                    for n, g in one[False].items())
    worst_remat = _grad_shares("remat_blocks gradients against remat off",
                               one[True], one[False])
    out["remat"] = runs
    del one
    log(f"  (c) remat_blocks: one step's gradients "
        f"{'bit-equal to' if bit_equal else 'not bit-equal to'} remat off "
        f"(every one within {worst_remat:.3e} of its max, limit {GRAD_TOL}); "
        f"{VARIANT_STEPS} steps each: median {runs[True]['median_ms']:.1f} ms "
        f"and peak {runs[True]['peak_bytes'] / 2 ** 30:.2f} GiB with remat, "
        f"{runs[False]['median_ms']:.1f} ms and "
        f"{runs[False]['peak_bytes'] / 2 ** 30:.2f} GiB without, on {smi} | "
        f"{time.perf_counter() - t0:.1f}s")

    # ---- (d) the s-tiled plan against the untiled one, unfused
    t0 = time.perf_counter()
    tiled_cfg = ModelConfig().replace(temporal_s_tile=S_TILE)
    diffusion = build_sampler(tiled_cfg, device="cuda", seed=0)
    blocks = [m for m in diffusion.model.modules()
              if isinstance(m, unet3d.TemporalAttentionBlock)]
    calls = [0]
    real = unet3d.reference_temporal_block

    def counted(*a, **kw):
        calls[0] += 1
        return real(*a, **kw)

    g = torch.Generator(device="cuda").manual_seed(16)
    x = torch.randn((1, FRAMES, 96, 96, 3), generator=g, device="cuda")
    t = torch.full((1,), 128, device="cuda")
    cond = torch.rand((1, FRAMES), generator=g, device="cuda") * 2 - 1
    _build.reset_launch_counts()
    unet3d.reference_temporal_block = counted
    try:
        with torch.no_grad(), diffusion.model.fused_plans(False):
            tiled = diffusion.guided_eps(x, t, cond, 5.0)
            for m in blocks:
                m.s_tile = None
            untiled = diffusion.guided_eps(x, t, cond, 5.0)
    finally:
        unet3d.reference_temporal_block = real
    _check_counts("the s-tiled eps", _counts_of({}), totals)
    if calls[0] != S_TILE_CALLS or not torch.isfinite(tiled).all():
        raise AssertionError(f"s-tiled eps: {calls[0]} tiles (expected "
                             f"{S_TILE_CALLS})")
    rel_tile = ((tiled - untiled).norm() / untiled.norm()).item()
    if rel_tile > MODEL_TOL:
        raise AssertionError(f"s-tiled eps against untiled: relative "
                             f"{rel_tile}")
    out["s_tile_rel"] = rel_tile
    del diffusion, blocks, tiled, untiled
    torch.cuda.empty_cache()
    log(f"  (d) temporal_s_tile {S_TILE}: guided eps on the unfused plan "
        f"({calls[0]} tiles of the reference block) against the untiled "
        f"plan: relative error {rel_tile:.3e} (limit {MODEL_TOL}) | "
        f"{time.perf_counter() - t0:.1f}s")

    # ---- (e) the switches: the saved plan and the linear backward kernels
    t0 = time.perf_counter()
    plain_cfg = cfg.replace(fused_bwd_kernels=False)
    with environ(VMT_TEMPORAL_VJP="saved", VMT_LINEAR_BWD_KERNEL="1"):
        diff = build(plain_cfg)
        gen = torch.Generator(device="cuda").manual_seed(17)
        trainer = StepTrainer(diff, plain_cfg, TrainerConfig(),
                              bench_batches(plain_cfg, gen, "cuda"),
                              generator=gen)
        _build.reset_launch_counts()
        loss = trainer.step()
        counts = _check_counts("a step under VMT_TEMPORAL_VJP=saved and "
                               "VMT_LINEAR_BWD_KERNEL=1",
                               _counts_of(SAVED_PER_STEP), totals)
    if not math.isfinite(loss.item()):
        raise AssertionError(f"switch step loss {loss.item()}")
    del diff, trainer
    torch.cuda.empty_cache()
    log(f"  (e) VMT_TEMPORAL_VJP=saved, VMT_LINEAR_BWD_KERNEL=1 (no "
        f"fused_bwd_kernels): launches {counts}, loss {loss.item():.4f} | "
        f"{time.perf_counter() - t0:.1f}s")

    # ---- (f) the rendering, in-process, without matplotlib or Pillow
    t0 = time.perf_counter()
    gifs = str(render_src / "gifs") + "/"
    frame_ranges = str(render_src / "frame_range_data.csv")
    vis_dir = Path(gif_visualization.main(["--path", gifs, "--frame-ranges",
                                           frame_ranges]))
    names = sorted(p.name for p in vis_dir.iterdir())
    if names != ["stress_strain_estimate.csv", "visualization.gif",
                 "visualization_conv_euler.gif", "visualization_legend.png"]:
        raise AssertionError(f"rendering artifacts {names}")
    for name in ("visualization.gif", "visualization_conv_euler.gif"):
        shape = gif_to_rgba(vis_dir / name).shape
        if shape != (FRAMES, 96, 96, 4):
            raise AssertionError(f"{name}: {shape}")
    solid = load_cell_fields(gifs, frame_ranges, 0, 0, "lagrangian")["mask"]
    alpha = gif_to_rgba(vis_dir / "visualization.gif")[..., 3]
    if not np.array_equal(alpha != 0, solid):
        raise AssertionError("visualization.gif's alpha is not the solid "
                             "mask")
    loaded = {m for m in ("matplotlib", "PIL", "imageio") if m in sys.modules}
    if loaded:
        raise AssertionError(f"the rendering imported {sorted(loaded)}")
    shutil.rmtree(render_src, ignore_errors=True)
    log(f"  (f) rendering: {len(names)} artifacts, GIFs {FRAMES}x96x96x4, "
        f"visualization.gif's alpha the solid mask ({solid.mean():.3f} "
        f"solid); matplotlib, PIL, imageio not imported | "
        f"{time.perf_counter() - t0:.1f}s")
    for k, v in totals.items():
        report[k]["launches_phase10"] = v
    return out


def run_variants(smi: str, report: dict, kernel_plan: dict | None,
                 render_src: Path) -> None:
    t0 = time.perf_counter()
    phase_variants(smi, report, kernel_plan, render_src)
    log(f"[10 variants] passed | {time.perf_counter() - t0:.1f}s")


# ------------------------------------------------------- phase 11 parallel

PARALLEL_STEPS = 20     # phase 11 (a): kernel-plan steps with and without
PROFILE_STEPS = 14      # (b): the trace covers steps 10 to 12
DP_DDIM_STEPS = 64      # (c): one guided DDIM-64 chunk of EVAL_CHUNK


def _dp_steps(cfg, steps: int) -> dict:
    """Phase 5's kernel plan: `steps` train steps on its seeded batches
    (generator 7, the EMA every 2 steps from step 4), from the counters
    at zero. Returns the state's tensors as the checkpoint holds them
    (parameters, Adam moments, zeros where Adam holds none, EMA), the step
    seconds and the counters."""
    import torch

    from videometamaterials_tpu_torch.config import TrainerConfig
    from videometamaterials_tpu_torch.diffusion.gaussian import (
        GaussianDiffusion,
    )
    from videometamaterials_tpu_torch.models.unet3d import build_unet
    from videometamaterials_tpu_torch.ops.cuda import _build
    from videometamaterials_tpu_torch.train import bench_batches
    from videometamaterials_tpu_torch.training.trainer import StepTrainer

    model = build_unet(cfg, device="cuda", seed=0)
    gen = torch.Generator(device="cuda").manual_seed(7)
    trainer = StepTrainer(
        GaussianDiffusion.from_config(model, cfg, "cuda"), cfg,
        TrainerConfig(ema_update_every=2, ema_start_step=4),
        bench_batches(cfg, gen, "cuda"), generator=gen)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    times, losses = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(trainer.step())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    counts = dict(_build.LAUNCH_COUNTS)
    state = trainer.state
    adam = state.optimizer.state
    tensors = {f"param {n}": p.detach().clone()
               for n, p in model.named_parameters()}
    tensors.update({f"adam {k} {n}": adam[p][k].clone() if p in adam
                    else torch.zeros_like(p)
                    for n, p in model.named_parameters()
                    for k in ("exp_avg", "exp_avg_sq")})
    tensors.update({f"ema {n}": e.clone() for (n, _), e in
                    zip(model.named_parameters(), state.ema)})
    del trainer, model, state
    torch.cuda.empty_cache()
    return {"tensors": tensors, "times": times, "counts": counts,
            "losses": [float(v) for v in losses]}


@contextlib.contextmanager
def deadline(seconds: int, what: str):
    """Raise TimeoutError in the block after `seconds` (SIGALRM)."""
    import signal

    def expire(signum, frame):
        raise TimeoutError(f"{what}: no end within {seconds}s")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def phase_parallel(smi: str, report: dict,
                   step_ms_phase5: float | None) -> None:
    """11 parallel: the data-parallel paths under an NCCL process group of
    one rank on this card (NCCL takes one rank a card): (a) the kernel
    plan's train steps bit-equal to the same steps without a group; (b)
    the train CLI with --profile-dir; (c) a guided DDIM-64 chunk through
    the Trainer's sample_videos; (d) the dry runs, dryrun_multichip(1) on
    NCCL and dryrun_multichip(2) on two gloo CPU processes."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from videometamaterials_tpu_torch import main as cli
    from videometamaterials_tpu_torch import parallel
    from videometamaterials_tpu_torch.config import (
        load_model_yaml,
        save_model_yaml,
    )
    from videometamaterials_tpu_torch.graft_entry import (
        dryrun_multichip,
        free_port,
    )
    from videometamaterials_tpu_torch.ops.cuda import _build

    cfg = load_model_yaml(ROOT / "model.yaml").replace(
        fused_blocks_in_training=True, fused_bwd_kernels=True)
    totals = {k: 0 for k in _build.LAUNCH_COUNTS}

    # ---- (a) train steps with and without the group
    t0 = time.perf_counter()
    alone = _dp_steps(cfg, PARALLEL_STEPS)
    parallel.initialize_distributed(f"tcp://127.0.0.1:{free_port()}",
                                    world_size=1, rank=0, backend="nccl")
    try:
        grouped = _dp_steps(cfg, PARALLEL_STEPS)
        counts = grouped["counts"]
        want = _counts_of(TRAIN_PER_STEP, PARALLEL_STEPS)
        if counts != want or alone["counts"] != want:
            raise AssertionError(f"11a: launch counts {counts} (without the "
                                 f"group {alone['counts']}), expected {want}")
        for k, v in counts.items():
            totals[k] += v
        if alone["tensors"].keys() != grouped["tensors"].keys():
            raise AssertionError("11a: the state's tensors differ in name")
        differ = [n for n, v in alone["tensors"].items()
                  if not torch.equal(v, grouped["tensors"][n])]
        if differ:
            worst = max(((alone["tensors"][n] - grouped["tensors"][n]).abs()
                         .max().item(), n) for n in differ)
            raise AssertionError(
                f"11a: {len(differ)} of {len(alone['tensors'])} state "
                f"tensors differ from the steps without a group; the "
                f"largest |difference| {worst[0]:.3e} ({worst[1]})")
        if alone["losses"] != grouped["losses"]:
            raise AssertionError("11a: the losses differ from the steps "
                                 "without a group")
        ms = {k: statistics.median(v["times"]) * 1e3
              for k, v in (("group", grouped), ("alone", alone))}
        if step_ms_phase5 is None:
            beside = "phase 5 not run"
        else:
            gap = ms["group"] / step_ms_phase5 - 1
            beside = (f"phase 5's kernel plan {step_ms_phase5:.1f} "
                      f"({100 * gap:+.1f}%"
                      + ("; FLAG: more than 10% from phase 5"
                         if abs(gap) > 0.10 else "") + ")")
        log(f"  (a) {PARALLEL_STEPS} kernel-plan steps in an NCCL group of "
            f"1: parameters, Adam moments and EMA (all "
            f"{len(alone['tensors'])} tensors) and losses bit-equal to the "
            f"steps without a group; median {ms['group']:.1f} ms a "
            f"step, {ms['alone']:.1f} without the group, {beside}; "
            f"launches {counts} | {time.perf_counter() - t0:.1f}s")
        del alone, grouped
        torch.cuda.empty_cache()

        # ---- (b) the train CLI under the group, traced
        t0 = time.perf_counter()
        (ROOT / "build").mkdir(exist_ok=True)
        tmp = Path(tempfile.mkdtemp(prefix="smoke_dp_", dir=ROOT / "build"))
        try:
            data = train_data(tmp / "data")
            cfg_path = tmp / "model_train.yaml"
            save_model_yaml(cfg, cfg_path)
            trace_dir = tmp / "trace"
            args = ["--run-name", "dp", "--config", str(cfg_path),
                    "--data-root", str(data), "--train-num-steps",
                    str(PROFILE_STEPS), "--save-and-sample-every", "1000",
                    "--test-batch-size", "8", "--sampling-timesteps",
                    str(DP_DDIM_STEPS), "--skip-eval-target", "--device",
                    "cuda"]
            _build.reset_launch_counts()
            out = cli.main(args + ["--runs-root", str(tmp / "runs"),
                                   "--profile-dir", str(trace_dir)])
            counts = dict(_build.LAUNCH_COUNTS)
            want = _counts_of(TRAIN_PER_STEP, PROFILE_STEPS)
            if counts != want:
                raise AssertionError(f"11b: launch counts {counts}, "
                                     f"expected {want}")
            for k, v in counts.items():
                totals[k] += v
            trainer = out["trainer"]
            run = tmp / "runs" / "dp"
            steps_written = sorted(p.name for p in (run / "model").iterdir()
                                   if p.name.startswith("step_"))
            if steps_written != [f"step_{PROFILE_STEPS}"]:
                raise AssertionError(f"11b: checkpoints {steps_written}")
            trace_path = trace_dir / "trace_rank0.json"
            size = trace_path.stat().st_size
            events = json.loads(trace_path.read_text())["traceEvents"]
            kernels = [e.get("name", "") for e in events
                       if e.get("cat") == "kernel"]
            seen = {k for k in PORTED_KERNELS
                    if any(k in name for name in kernels)}
            missing = set(PORTED_KERNELS) - seen
            if missing:
                raise AssertionError(f"11b: the trace's device events lack "
                                     f"{sorted(missing)}")
            losses = [json.loads(line)["training loss"] for line in
                      (run / "metrics.jsonl").read_text().splitlines()]
            if len(losses) != PROFILE_STEPS or not all(
                    math.isfinite(v) for v in losses):
                raise AssertionError(f"11b: training losses {losses}")
            # the same run untraced: the trace changes no result
            cli.main(args + ["--runs-root", str(tmp / "runs_plain")])
            ckpt = Path("model") / f"step_{PROFILE_STEPS}" / \
                "checkpoint.msgpack"
            if (run / ckpt).read_bytes() != (
                    tmp / "runs_plain" / "dp" / ckpt).read_bytes():
                raise AssertionError("11b: the traced run's checkpoint "
                                     "differs from the untraced run's")
            log(f"  (b) train CLI under the group, {PROFILE_STEPS} steps "
                f"with --profile-dir: trace_rank0.json {size / 2 ** 20:.1f} "
                f"MiB, {len(kernels)} kernel events, every ported kernel "
                f"family in them; one checkpoint ({steps_written[0]}), "
                f"written by rank 0, byte-equal to the same run's without "
                f"the trace; launches {counts} | "
                f"{time.perf_counter() - t0:.1f}s")

            # ---- (c) a guided DDIM-64 chunk through the Trainer
            t0 = time.perf_counter()
            cond = (torch.rand((EVAL_CHUNK, cfg.cond_length),
                               generator=torch.Generator().manual_seed(11))
                    * 2 - 1).numpy()
            if trainer.test_batch != EVAL_CHUNK:
                raise AssertionError(f"11c: the sampling chunk is "
                                     f"{trainer.test_batch}")
            _build.reset_launch_counts()
            videos = trainer.sample_videos(cond, 5.0)
            torch.cuda.synchronize()
            chain_s = time.perf_counter() - t0
            counts = dict(_build.LAUNCH_COUNTS)
            want = _counts_of(EVAL_PER_STEP, DP_DDIM_STEPS)
            if counts != want:
                raise AssertionError(f"11c: launch counts {counts}, "
                                     f"expected {want}")
            for k, v in counts.items():
                totals[k] += v
            shape = (EVAL_CHUNK, FRAMES, cfg.image_size, cfg.image_size, 3)
            if videos.shape != shape or not np.isfinite(videos).all():
                raise AssertionError(f"11c: videos {videos.shape}, not the "
                                     "shape or not finite")
            log(f"  (c) Trainer.sample_videos under the group: one chunk "
                f"of {EVAL_CHUNK}, DDIM-{DP_DDIM_STEPS}, w = 5: "
                f"{chain_s:.2f}s; videos {videos.shape}; launches {counts}")
            del out, trainer
            torch.cuda.empty_cache()
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    finally:
        parallel.mesh.destroy()

    # ---- (d) the dry runs: n = 1 opens its own NCCL group here
    t0 = time.perf_counter()
    with deadline(120, "dryrun_multichip(1)"):
        dryrun_multichip(1)
    log(f"  (d) dryrun_multichip(1): an NCCL group of one it opened | "
        f"{time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    dryrun_multichip(2, timeout=300)
    log(f"  (d) dryrun_multichip(2): two gloo CPU processes (one card) | "
        f"{time.perf_counter() - t0:.1f}s")
    for k, v in totals.items():
        report[k]["launches_phase11"] = v
    log(f"[11 parallel] world 1 on NCCL on {smi}, world 2 on gloo CPU "
        f"processes; launches {totals}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=256,
                    help="steps of the DDPM-256 chain to run (default all)")
    ap.add_argument("--train-steps", type=int, default=20,
                    help="timed train steps under each plan (phase 5)")
    ap.add_argument("--profile", type=int, default=0, metavar="STEPS",
                    help="after the checks, trace STEPS guided steps on "
                         "each linear layout and STEPS train steps (kernel "
                         "plan) with torch.profiler and print device time "
                         "by kernel")
    ap.add_argument("--profile-out", metavar="PATH",
                    help="also write the whole profile tables to PATH "
                         "(.sample, .sample_head and .train suffixes)")
    ap.add_argument("--variants-only", action="store_true",
                    help="run phases 0, 1, 6 (the rendering's input) and 10 "
                         "only, and print no result line")
    ap.add_argument("--parallel-only", action="store_true",
                    help="run phases 0, 1 and 11 only (no phase 5 step to "
                         "compare with), and print no result line")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device")
        return 2
    if not (ROOT / "videometamaterials_tpu_torch" / "ops" / "cuda"
            / "csrc").is_dir():
        log("chip_smoke: run from the root of a checkout of the repository")
        return 2
    sys.path.insert(0, str(ROOT))

    from videometamaterials_tpu_torch.config import ModelConfig
    from videometamaterials_tpu_torch.ops.cuda import _build
    from videometamaterials_tpu_torch.sample import build_sampler

    # ---- 0 device
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(f"[0 device] {smi} | torch {torch.__version__} CUDA "
        f"{torch.version.cuda} | {time.perf_counter() - t0:.1f}s")

    # ---- 1 build
    t0 = time.perf_counter()
    info = _build.build_info()
    _build.load_library()
    kernel_resources(info)
    log(f"[1 build] {'built' if info['built'] else 'cached'} "
        f"{info['path']} (nvcc {info['seconds']:.1f}s) | "
        f"{time.perf_counter() - t0:.1f}s")

    if args.parallel_only:
        report = {k: {} for k in _build.LAUNCH_COUNTS}
        t0 = time.perf_counter()
        phase_parallel(smi, report, None)
        log(f"[11 parallel] passed | {time.perf_counter() - t0:.1f}s")
        log(f"total {time.perf_counter() - t_start:.1f}s (phases 0, 1 and "
            "11 only: no result line)")
        return 0

    if args.variants_only:
        report = {k: {} for k in _build.LAUNCH_COUNTS}
        t0 = time.perf_counter()
        evaluated = phase_eval(smi, report)
        log(f"[6 eval] passed | {time.perf_counter() - t0:.1f}s")
        torch.cuda.empty_cache()
        run_variants(smi, report, None, evaluated["render_src"])
        log(f"total {time.perf_counter() - t_start:.1f}s (phases 0, 1, 6 "
            "and 10 only: no result line)")
        return 0

    # ---- 2 kernels against their twins
    t0 = time.perf_counter()
    report = {k: {"name": k, "route": "cuda"} for k in _build.LAUNCH_COUNTS}
    report["fused_temporal_block"].update(
        source="videometamaterials_tpu_torch/ops/cuda/csrc/fused_temporal_block.cu",
        replaces="videometamaterials_tpu/ops/pallas/fused_temporal_block.py:82")
    report["linear_stats"].update(
        source="videometamaterials_tpu_torch/ops/cuda/csrc/fused_linear_block.cu",
        replaces="videometamaterials_tpu/ops/pallas/fused_linear_block.py:102")
    report["linear_apply"].update(
        source="videometamaterials_tpu_torch/ops/cuda/csrc/fused_linear_block.cu",
        replaces="videometamaterials_tpu/ops/pallas/fused_linear_block.py:146")
    report["temporal_bwd"].update(
        source="videometamaterials_tpu_torch/ops/cuda/csrc/fused_temporal_block_bwd.cu",
        replaces="videometamaterials_tpu/ops/pallas/fused_temporal_block.py:240")
    report["linear_bwd_head"].update(
        source="videometamaterials_tpu_torch/ops/cuda/csrc/fused_linear_block_bwd.cu",
        replaces="videometamaterials_tpu/ops/pallas/fused_linear_block.py:414")
    report["linear_bwd_merged"].update(
        source="videometamaterials_tpu_torch/ops/cuda/csrc/fused_linear_block_bwd.cu",
        replaces="videometamaterials_tpu/ops/pallas/fused_linear_block.py:196")
    report["temporal_fwd_p"].update(
        source="videometamaterials_tpu_torch/ops/cuda/csrc/fused_temporal_block.cu",
        replaces="videometamaterials_tpu/ops/pallas/fused_temporal_block.py:150")
    report["linear_head"].update(
        source="videometamaterials_tpu_torch/ops/cuda/csrc/fused_linear_block.cu",
        replaces="videometamaterials_tpu/ops/pallas/fused_linear_block.py:336")
    phase2_t11 = {}
    phase_kernels(report, phase2_t11)
    phase_emit_p(report)
    phase_head(report)
    torch.cuda.synchronize()
    log(f"[2 kernels] all kernels match their twins | "
        f"{time.perf_counter() - t0:.1f}s")

    # ---- 2b backward kernels against their twins
    t0 = time.perf_counter()
    phase_bwd_kernels(report)
    torch.cuda.synchronize()
    log(f"[2b backward] all backward kernels match their twins | "
        f"{time.perf_counter() - t0:.1f}s")

    # ---- 3 model: fused plans against unfused plans
    t0 = time.perf_counter()
    cfg = ModelConfig()
    diffusion = build_sampler(cfg, device="cuda", seed=0)
    rel = phase_model(diffusion, cfg)
    torch.cuda.synchronize()
    log(f"[3 model] flagship UNet3D guided eps, fused vs unfused plans: "
        f"relative error {rel:.3e} (limit {MODEL_TOL}) | "
        f"{time.perf_counter() - t0:.1f}s")

    # ---- 3b model: the linear blocks on the head layout
    t0 = time.perf_counter()
    _build.reset_launch_counts()
    with linear_layout("head"):
        rel_head = phase_model(diffusion, cfg)
    torch.cuda.synchronize()
    counts = dict(_build.LAUNCH_COUNTS)
    if counts["linear_head"] != 8 or counts["linear_stats"] != 0:
        raise AssertionError(f"head-layout eps: launch counts {counts}")
    log(f"[3b model] guided eps with VMT_LINEAR_LAYOUT=head, fused vs "
        f"unfused plans: relative error {rel_head:.3e} (limit {MODEL_TOL}); "
        f"launches {counts} | {time.perf_counter() - t0:.1f}s")

    # ---- 4 main path
    steps = args.steps
    if steps != cfg.train_timesteps:
        log(f"  running the first {steps} steps of the DDPM-"
            f"{cfg.train_timesteps} chain")
    counts, chain4_s = run_chain(diffusion, cfg, steps,
                                 dict(fused_temporal_block=10, linear_stats=8,
                                      linear_apply=8), smi, "4 chain")
    for k in report:
        report[k]["launches"] = counts[k]
        report[k]["library_ms"] = None

    # ---- 4b the chain with the linear blocks on the head layout
    with linear_layout("head"):
        counts, _ = run_chain(diffusion, cfg, steps,
                              dict(fused_temporal_block=10, linear_head=8),
                              smi, "4b chain, head layout")
    report["linear_head"]["launches"] = counts["linear_head"]

    if args.profile:
        gen = torch.Generator(device="cuda").manual_seed(4)
        cond = torch.rand((1, FRAMES), generator=gen, device="cuda") * 2 - 1
        profile_steps(lambda: diffusion.sample(cond, 5.0, generator=gen,
                                               num_steps=args.profile),
                      f"{args.profile} guided steps",
                      args.profile_out and args.profile_out + ".sample")
        with linear_layout("head"):
            profile_steps(lambda: diffusion.sample(
                cond, 5.0, generator=gen, num_steps=args.profile),
                f"{args.profile} guided steps, head layout",
                args.profile_out and args.profile_out + ".sample_head")
    del diffusion
    torch.cuda.empty_cache()

    # ---- 5 train: the flagship train step with the backward kernels
    t0 = time.perf_counter()
    train_cfg = cfg.replace(fused_blocks_in_training=True,
                            fused_bwd_kernels=True)
    train = phase_train(train_cfg, args.train_steps, report, args.profile,
                        args.profile_out and args.profile_out + ".train")
    log(f"[5 train] batch {train_cfg.batch_size}, {args.train_steps} steps a "
        "plan: median ms a step " + ", ".join(
            f"{k} {v['median_ms']:.1f}" for k, v in train.items())
        + "; peak memory " + ", ".join(
            f"{k} {v['peak_bytes'] / 2 ** 30:.2f} GiB"
            for k, v in train.items())
        + f" on {smi} | {time.perf_counter() - t0:.1f}s")
    torch.cuda.empty_cache()

    # ---- 6 eval: checkpoint -> CLI -> GIFs and geometries.csv
    t0 = time.perf_counter()
    evaluated = phase_eval(smi, report)
    log(f"[6 eval] passed | {time.perf_counter() - t0:.1f}s")
    torch.cuda.empty_cache()

    # ---- 7 train: the train CLI on a GIF folder, resume, refusal
    t0 = time.perf_counter()
    phase_train_cli(smi, report, train["kernel"]["median_ms"])
    log(f"[7 train] passed | {time.perf_counter() - t0:.1f}s")
    torch.cuda.empty_cache()

    # ---- 8 ddim: checkpoint.pt import, DDIM arms, interpolate
    t0 = time.perf_counter()
    phase_ddim(smi, report, evaluated["chain_s"])
    log(f"[8 ddim] passed | {time.perf_counter() - t0:.1f}s")
    torch.cuda.empty_cache()

    # ---- 9 ablations: the conditioning ablations' kernels and paths
    t0 = time.perf_counter()
    ablation_kernels(report, phase2_t11)
    del phase2_t11
    torch.cuda.synchronize()
    log(f"[9a kernels] rows 1-3 at T in {ABLATION_T} and the largest "
        f"count, rows 4-7 at Mc in {ABLATION_MC}, row 8 at Mc = "
        f"{ABLATION_MC[0]}: all match their twins | "
        f"{time.perf_counter() - t0:.1f}s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    arms = ablation_configs()
    ablation_models(arms)
    log(f"[9b model] guided eps of the four arms | "
        f"{time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    cnn = arms["ablation-CNN"]
    diffusion = build_sampler(cnn, device="cuda", seed=0)
    counts, chain9_s = run_chain(diffusion, cnn, steps,
                                 dict(fused_temporal_block=10,
                                      linear_stats=8, linear_apply=8),
                                 smi, "9c chain, ablation-CNN")
    for k in report:
        report[k]["launches_ablation_chain"] = counts[k]
    del diffusion
    torch.cuda.empty_cache()
    log(f"[9c chain] ablation-CNN (16 tokens) chain {chain9_s:.2f}s beside "
        f"phase 4's flagship {chain4_s:.2f}s | "
        f"{time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    ablation_train(cnn, ABLATION_TRAIN_STEPS, train["kernel"]["median_ms"])
    torch.cuda.empty_cache()
    log(f"[9d train] passed | {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    ablation_eval(arms["ablation-GRU"], smi, evaluated["chain_s"])
    log(f"[9e eval] passed | {time.perf_counter() - t0:.1f}s")
    torch.cuda.empty_cache()

    # ---- 10 variants: focus mask, accumulation, remat, s-tile, switches,
    # rendering
    run_variants(smi, report, train["kernel"], evaluated["render_src"])
    torch.cuda.empty_cache()

    # ---- 11 parallel: the data-parallel paths, the trace, the dry runs
    t0 = time.perf_counter()
    phase_parallel(smi, report, train["kernel"]["median_ms"])
    log(f"[11 parallel] passed | {time.perf_counter() - t0:.1f}s")
    log(f"total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": list(report.values())}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
