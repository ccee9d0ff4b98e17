#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (videometamaterials_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--steps N]

Phases, each printing its wall time as it finishes:
  0 device   card name and power limit (nvidia-smi), torch/CUDA versions
  1 build    the sm_90a kernels, one nvcc command (seconds, not minutes)
  2 kernels  each kernel against its plain PyTorch twin at every shape the
             main path gives it (temporal block at every level with and
             without conditioning tokens, linear stats + apply at every
             level, the per-head-shift NaN case), with kernel/twin times
  3 model    one guided forward of the flagship UNet3D, fused plans against
             the unfused plans, on the same input
  4 chain    the main path: guided DDPM sampling (w = 5, bisect dynamic
             thresholding) of one video at 96x96x11 through `sample()`,
             the launch counters proving every step went through the
             kernels
Then a JSON line of per-kernel numbers, the nvidia-smi line, and as the
last line {"ok": true, "device": {...}}. Any failure raises: non-zero exit
and no "ok" line. Without a GPU, or outside a checkout, it exits non-zero
before printing any result. Budget: the whole script in under 10 minutes
on an H100, the build included.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM rate and the dense bf16
# tensor-core rate, the type of the kernels' operands
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
# relative L2 error of the guided eps, fused plans against unfused plans
MODEL_TOL = 0.15


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


def temporal_cost(b, s, c, t_tok):
    """(bytes, flops): x read and out written once, weights once; QKV
    projection, out-projection, scores and value sums."""
    act = b * FRAMES * s * c * 2
    weights = (FRAMES * c * 3 * HIDDEN + HIDDEN * c + 2 * b * t_tok * HIDDEN
               ) * 2 + FRAMES * (FRAMES + t_tok) * HEADS * 4 + c * 4
    flops = 2 * b * FRAMES * s * (c * 3 * HIDDEN + HIDDEN * c
                                  + 2 * (FRAMES + t_tok) * HIDDEN)
    return 2 * act + weights, flops


def stats_cost(bf_, n, c):
    nbytes = (bf_ * n * c * 2 + c * 2 * HIDDEN * 2 + 2 * bf_ * HIDDEN * 2
              + bf_ * (HEADS * 32 * 32 + HIDDEN) * 4)
    flops = 2 * bf_ * n * (c * 2 * HIDDEN + HEADS * 32 * 32)
    return nbytes, flops


def apply_cost(bf_, n, c):
    nbytes = (2 * bf_ * n * c * 2 + (c * HIDDEN + HIDDEN * c) * 2
              + bf_ * (HEADS * 32 * 32 + HIDDEN) * 4 + c * 8)
    flops = 2 * bf_ * n * (c * HIDDEN + HEADS * 32 * 32 + HIDDEN * c)
    return nbytes, flops


# ----------------------------------------------------------------- phases


def phase_kernels(report):
    import torch

    from videometamaterials_tpu_torch.ops.cuda import fused_linear_block as lin
    from videometamaterials_tpu_torch.ops.cuda import fused_temporal_block as tmp

    gen = torch.Generator(device="cuda").manual_seed(0)
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
        log(f"  temporal B'={b} S={s} C={c} T={t_tok}: max_abs_err {err:.3e} "
            f"(tol {BF16_TOL}) kernel {ms:.3f} ms, twin {plain_ms:.3f} ms")
        if (b, s, c, t_tok) == (2, 9216, 64, 11):
            report["fused_temporal_block"].update(
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                **dict(zip(("bound_ms", "bound_by"),
                           bound(*temporal_cost(b, s, c, t_tok)))),
                shape=[b, FRAMES, s, c, t_tok])

    for bf_, n, c in sorted(set(LINEAR_PATH), key=lambda s: -s[1]):
        a = linear_inputs(bf_, n, c, gen)
        kw = dict(heads=HEADS, spatial_size=n)
        ctx_p, z_p = lin.linear_stats_plain(a["x"], a["gamma"], a["w_qkv"],
                                            a["ek"], a["ev"], **kw)
        ctx_k, z_k = lin.linear_stats(a["x"], a["gamma"], a["w_qkv"],
                                      a["ek"], a["ev"], **kw)
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
        log(f"  linear BF={bf_} N={n} C={c}: stats err {err_s:.3e} (ctx "
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


def profile_steps(diffusion, cond, steps: int, out_path: str | None) -> None:
    """Device time by kernel over `steps` guided steps, and the share of
    the wall time the device was busy (sum of kernel times / wall)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda").manual_seed(4)
    diffusion.sample(cond, 5.0, generator=gen, num_steps=1)     # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        diffusion.sample(cond, 5.0, generator=gen, num_steps=steps)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    # kernel rows only: an operator's row repeats its kernels' device time
    device_us = sum(e.self_device_time_total for e in events
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    table = events.table(sort_by="self_device_time_total", row_limit=40,
                         max_name_column_width=60)
    if out_path:
        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        Path(out_path).write_text(table)
    log(table[:6000])
    log(f"[profile] {steps} steps: wall {wall_ms:.1f} ms, device busy "
        f"{device_us / 1e3:.1f} ms ({100 * device_us / 1e3 / wall_ms:.1f}%)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=256,
                    help="steps of the DDPM-256 chain to run (default all)")
    ap.add_argument("--profile", type=int, default=0, metavar="STEPS",
                    help="after the checks, trace STEPS guided steps with "
                         "torch.profiler and print device time by kernel")
    ap.add_argument("--profile-out", metavar="PATH",
                    help="also write the whole profile table to PATH")
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
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line and "0 bytes spill" not in line:
            log(f"  ptxas: {line.strip()}")
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
    phase_kernels(report)
    log(f"[2 kernels] all kernels match their twins | "
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

    # ---- 4 main path
    t0 = time.perf_counter()
    steps = args.steps
    if steps != cfg.train_timesteps:
        log(f"  running the first {steps} steps of the DDPM-"
            f"{cfg.train_timesteps} chain")
    cond = torch.rand((1, FRAMES), generator=torch.Generator().manual_seed(2)
                      ) * 2 - 1
    gen = torch.Generator(device="cuda").manual_seed(3)
    _build.reset_launch_counts()
    videos = diffusion.sample(cond, 5.0, generator=gen, num_steps=steps)
    torch.cuda.synchronize()
    chain_s = time.perf_counter() - t0
    counts = dict(_build.LAUNCH_COUNTS)
    want = {"fused_temporal_block": 10 * steps, "linear_stats": 8 * steps,
            "linear_apply": 8 * steps}
    if counts != want:
        raise AssertionError(f"launch counts {counts}, expected {want}")
    if tuple(videos.shape) != (1, FRAMES, cfg.image_size, cfg.image_size, 3):
        raise AssertionError(f"videos shape {tuple(videos.shape)}")
    if not torch.isfinite(videos).all():
        raise AssertionError("sampled videos are not finite")
    lo, hi = videos.min().item(), videos.max().item()
    if steps == cfg.train_timesteps and (lo < 0.0 or hi > 1.0):
        # the last step (t = 0) returns the thresholded x0 in [-1, 1]
        raise AssertionError(f"videos outside [0, 1]: [{lo}, {hi}]")
    for k in report:
        report[k]["launches"] = counts[k]
        report[k]["library_ms"] = None
    rate = (f"{60.0 / chain_s:.3f} videos/min" if steps == cfg.train_timesteps
            else f"{chain_s / steps * 1e3:.1f} ms a step (partial chain)")
    log(f"[4 chain] guided DDPM, {steps} steps, batch 1 (CFG pair 2), w=5: "
        f"{chain_s:.2f}s, {rate} on {smi}; launches {counts}; videos "
        f"{tuple(videos.shape)} in [{lo:.3f}, {hi:.3f}]")

    if args.profile:
        profile_steps(diffusion, cond, args.profile, args.profile_out)
    log(f"total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": list(report.values())}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
