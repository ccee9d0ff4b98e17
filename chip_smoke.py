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


def linear_inputs(bf_, n, c, gen):
    import torch

    dev, bf = "cuda", torch.bfloat16

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    return dict(
        x=rnd(bf_, n, c).to(bf), gamma=1 + rnd(c, scale=0.1),
        w_qkv=rnd(c, 3 * HIDDEN, scale=c ** -0.5).to(bf),
        w_out=rnd(HIDDEN, c, scale=HIDDEN ** -0.5).to(bf),
        out_bias=rnd(c, scale=0.1), ek=rnd(bf_, 1, HIDDEN).to(bf),
        ev=rnd(bf_, 1, HIDDEN).to(bf),
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


def stats_cost(bf_, n, c):
    nbytes = (bf_ * n * c * 2 + c * 2 * HIDDEN * 2 + 2 * bf_ * HIDDEN * 2
              + bf_ * (HEADS * 32 * 32 + HIDDEN) * 4)
    flops = 2 * bf_ * n * (c * 2 * HIDDEN + HEADS * 32 * 32)
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


def linear_bwd_cost(bf_, n, c):
    """(bytes, flops): x and g read, dx written, weights and cond tokens
    read, the f32 cotangents written; the QKV projection, dy and dW_qkv
    (3 x 2 C 3H a token), g_oh and dW_out (2 x 2 H C), and six per-head
    32 x 32 products (stats, oh, dQ, dctx, dP, dV)."""
    rows = bf_ * n
    nbytes = (3 * rows * c * 2 + (c * 3 * HIDDEN + HIDDEN * c) * 2
              + 2 * bf_ * HIDDEN * 2 + c * 8
              + (c * 3 * HIDDEN + HIDDEN * c + 2 * c + 2 * bf_ * HIDDEN) * 4)
    flops = rows * (3 * 2 * c * 3 * HIDDEN + 2 * 2 * HIDDEN * c
                    + 6 * 2 * HIDDEN * 32)
    return nbytes, flops


def apply_cost(bf_, n, c):
    nbytes = (2 * bf_ * n * c * 2 + (c * HIDDEN + HIDDEN * c) * 2
              + bf_ * (HEADS * 32 * 32 + HIDDEN) * 4 + c * 8)
    flops = 2 * bf_ * n * (c * HIDDEN + HEADS * 32 * 32 + HIDDEN * c)
    return nbytes, flops


# ----------------------------------------------------------------- phases


def phase_kernels(report):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    temporal_kernels(report, gen)
    linear_kernels(report, gen)


def temporal_kernels(report, gen):
    """The temporal forward against its twin at every main-path shape."""
    from videometamaterials_tpu_torch.ops.cuda import fused_temporal_block as tmp

    shapes = sorted(set(TEMPORAL_PATH), key=lambda s: (-s[1], s[0], s[3]))
    shapes += [(b, s, c, 0) for b, s, c, t in shapes if t]
    for b, s, c, t_tok in shapes:
        a = temporal_inputs(b, s, c, t_tok, gen)

        def kernel():
            return tmp.fused_temporal_block(**a, heads=HEADS)

        def plain():
            return tmp.temporal_block_plain(**a, heads=HEADS)

        err = check_close(f"temporal {b, s, c, t_tok}", kernel(), plain(),
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


def head_inputs(bf_, n, c, gen, k_scale=HEAD_K_SCALE):
    """linear_inputs with an O(1) update: the v columns of w_qkv times
    HW * HEAD_V_SCALE, the key columns times k_scale."""
    import torch

    a = linear_inputs(bf_, n, c, gen)
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


def phase_model(diffusion, cfg):
    """One guided forward: the fused plans (the kernels) against the
    unfused plans on the same weights and input."""
    import torch

    model = diffusion.model
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((1, FRAMES, cfg.image_size, cfg.image_size, 3),
                    generator=gen, device="cuda")
    t = torch.full((1,), 128, device="cuda")
    cond = torch.rand((1, FRAMES), generator=gen, device="cuda") * 2 - 1
    with torch.no_grad():
        fused = diffusion.guided_eps(x, t, cond, 5.0)
        blocks = [m for m in model.modules() if hasattr(m, "use_fused_block")]
        for m in blocks:
            m.use_fused_block = False
        try:
            unfused = diffusion.guided_eps(x, t, cond, 5.0)
        finally:
            for m in blocks:
                m.use_fused_block = True
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
    from videometamaterials_tpu_torch.training.trainer import Trainer

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
        trainer = Trainer(diff, plan_cfg, tcfg,
                          bench_batches(plan_cfg, gen, "cuda"), generator=gen)
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
def linear_layout(layout: str):
    """VMT_LINEAR_LAYOUT, the JAX package's switch of the fused linear
    blocks' layout, set for the block's duration."""
    old = os.environ.get("VMT_LINEAR_LAYOUT")
    os.environ["VMT_LINEAR_LAYOUT"] = layout
    try:
        yield
    finally:
        if old is None:
            del os.environ["VMT_LINEAR_LAYOUT"]
        else:
            os.environ["VMT_LINEAR_LAYOUT"] = old


def run_chain(diffusion, cfg, steps: int, per_step: dict, smi: str,
              what: str) -> dict:
    """The guided DDPM chain of one video from the counters at zero;
    checks the launch counters against per_step (launches a step, absent
    ones 0), the videos' shape, finiteness and range. Returns the
    counters."""
    import torch

    from videometamaterials_tpu_torch.ops.cuda import _build

    t0 = time.perf_counter()
    cond = torch.rand((1, FRAMES), generator=torch.Generator().manual_seed(2)
                      ) * 2 - 1
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
    return counts


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
    phase_kernels(report)
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
    counts = run_chain(diffusion, cfg, steps,
                       dict(fused_temporal_block=10, linear_stats=8,
                            linear_apply=8), smi, "4 chain")
    for k in report:
        report[k]["launches"] = counts[k]
        report[k]["library_ms"] = None

    # ---- 4b the chain with the linear blocks on the head layout
    with linear_layout("head"):
        counts = run_chain(diffusion, cfg, steps,
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
    log(f"total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": list(report.values())}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
