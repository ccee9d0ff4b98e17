"""The fused-block gradient gaps between the training plans of the widths
configurations (chip_smoke.py's WIDTH_CONFIGS edits of model.yaml), one
step at batch 2 on the same weights, batch and draws: the kernel, saved
and recompute plans, the unfused plan in bf16 and the unfused plan in
float32 (the closest to exact). Prints each plan's loss and, for each
pair, the largest per-parameter share of the second plan's max gradient
over the fused blocks' parameters, and the parameter at it.

Run on one GPU from the root of a checkout:

    python scripts/torch_train_plan_gaps.py wide heads4x64 tokens96
"""
import shutil
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

PAIRS = (("kernel", "unfused"), ("saved", "unfused"), ("recompute", "unfused"),
         ("kernel", "recompute"), ("saved", "recompute"),
         ("kernel", "unfused_f32"), ("saved", "unfused_f32"),
         ("recompute", "unfused_f32"), ("unfused", "unfused_f32"))


def gaps(name: str, root: Path) -> None:
    import torch

    import chip_smoke as cs
    from videometamaterials_tpu_torch.config import load_model_yaml
    from videometamaterials_tpu_torch.diffusion.gaussian import (
        GaussianDiffusion,
    )
    from videometamaterials_tpu_torch.models.unet3d import build_unet
    from videometamaterials_tpu_torch.train import bench_batches

    cfg = load_model_yaml(cs.width_yaml(root, name)).replace(
        fused_blocks_in_training=True, fused_bwd_kernels=True, batch_size=2)
    gen = torch.Generator(device="cuda").manual_seed(141)
    videos, labels = next(bench_batches(cfg, gen, "cuda"))
    t = torch.randint(0, cfg.train_timesteps, (2,), generator=gen,
                      device="cuda")
    noise = torch.randn(videos.shape, generator=gen, device="cuda")
    mask = torch.tensor([False, True], device="cuda")
    plans = {"kernel": cfg, "saved": cfg.replace(temporal_vjp="saved"),
             "recompute": cfg.replace(fused_bwd_kernels=False),
             "unfused": cfg.replace(fused_blocks_in_training=False),
             "unfused_f32": cfg.replace(fused_blocks_in_training=False,
                                        compute_dtype="float32")}
    grads, groups = {}, None
    for plan, plan_cfg in plans.items():
        model = build_unet(plan_cfg, device="cuda", seed=0)
        diff = GaussianDiffusion.from_config(model, plan_cfg, "cuda")
        with model.fused_plans(plan_cfg.fused_blocks_in_training):
            loss = diff.loss(videos, labels, t=t, noise=noise,
                             null_cond_mask=mask)
            loss.backward()
        groups = groups or cs._param_groups(model)
        grads[plan] = {n: p.grad.float() for n, p in model.named_parameters()
                       if p.grad is not None and groups[n] != "rest"}
        print(name, plan, "loss", loss.item(), flush=True)
        del model, diff
        torch.cuda.empty_cache()
    for a, b in PAIRS:
        share, at = max(
            ((grads[a][n] - w).abs().max().item() / w.abs().max().item(), n)
            for n, w in grads[b].items())
        print(f"{name} {a} vs {b}: {share:.3e} ({at})", flush=True)


def main(names) -> None:
    (ROOT / "build").mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="plan_gaps_", dir=ROOT / "build"))
    try:
        for name in names:
            gaps(name, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main(sys.argv[1:])
