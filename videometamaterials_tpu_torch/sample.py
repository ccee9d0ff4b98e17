"""Guided sampling entry point of the port.

    python -m videometamaterials_tpu_torch.sample --out-dir OUT
        [--config model.yaml] [--checkpoint X.msgpack | --weights W.npz]
        [--targets T.csv --labels-scaling CKPT.aux.json] [--batch B]
        [--guidance-scale 5] [--seed 0] [--num-steps N] [--device cuda]

Builds the UNet3D of the config (the flagship model.yaml by default), with
the EMA weights of a `.msgpack` checkpoint (a run checkpoint or a
`ckpt_cache` tree), a converted state dict (`convert.save_state_dict_npz`)
or seeded random weights, and samples one video per conditioning curve
under classifier-free guidance on the full DDPM chain with dynamic
thresholding. Conditioning is a CSV of target stress-strain curves
(normalised with the checkpoint's labels_scaling; 51-point curves are
interpolated to the frame count) or, without targets, B seeded uniform
curves in [-1, 1] (the JAX bench's conditioning). Writes videos.npy (B, F,
H, W, C) in [0, 1], cond.npy and sample.json into OUT; the GIFs and
geometries.csv of a run come from `videometamaterials_tpu_torch.main`.
Runs on the GPU unless --device names another device.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from videometamaterials_tpu_torch.config import (
    ModelConfig,
    load_model_yaml,
    resolve_device,
)
from videometamaterials_tpu_torch.convert import (
    flax_to_torch_state_dict,
    load_msgpack_tree,
    load_state_dict_npz,
)
from videometamaterials_tpu_torch.data.normalization import (
    Normalization,
    interpolate_labels,
)
from videometamaterials_tpu_torch.diffusion.gaussian import GaussianDiffusion
from videometamaterials_tpu_torch.models.unet3d import build_unet
from videometamaterials_tpu_torch.utils import cast_params_for_inference


def build_sampler(cfg: ModelConfig, *, device=None, weights=None,
                  seed: int = 0) -> GaussianDiffusion:
    """Model (weights from a state dict or from `seed`) wrapped in its
    diffusion process, ready to sample on `device`."""
    dev = resolve_device(device)
    model = build_unet(cfg, device=dev,
                       seed=None if weights is not None else seed)
    if weights is not None:
        model.load_state_dict(weights, strict=True)
    if cfg.bf16_inference_weights and cfg.compute_dtype == "bfloat16":
        cast_params_for_inference(model)
    return GaussianDiffusion.from_config(model, cfg, dev)


def target_cond(targets_csv, labels_scaling: dict,
                num_frames: int) -> np.ndarray:
    targets = np.genfromtxt(targets_csv, delimiter=",")
    if targets.ndim == 1:
        targets = targets[None, :]
    if targets.shape[1] != num_frames:
        targets = interpolate_labels(targets, num_frames)
    norm = Normalization.from_dict(labels_scaling)
    return norm.normalize(targets.astype(np.float32)).astype(np.float32)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--config", help="model.yaml (default: the flagship)")
    weights_arg = ap.add_mutually_exclusive_group()
    weights_arg.add_argument("--checkpoint",
                             help="run checkpoint or ckpt_cache tree "
                                  "(.msgpack): its EMA weights")
    weights_arg.add_argument("--weights", help="converted state dict (.npz)")
    ap.add_argument("--targets", help="CSV of target stress-strain curves")
    ap.add_argument("--labels-scaling",
                    help="checkpoint aux.json holding labels_scaling")
    ap.add_argument("--batch", type=int, default=1,
                    help="videos to sample without --targets")
    ap.add_argument("--guidance-scale", type=float, default=5.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--num-steps", type=int, default=None,
                    help="run only the first N steps of the chain")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)

    cfg = load_model_yaml(args.config) if args.config else ModelConfig()
    dev = resolve_device(args.device)
    weights = None
    if args.checkpoint:
        weights = flax_to_torch_state_dict(load_msgpack_tree(args.checkpoint))
    elif args.weights:
        weights = load_state_dict_npz(args.weights)
    diffusion = build_sampler(cfg, device=dev, weights=weights,
                              seed=args.seed)
    if args.targets:
        if not args.labels_scaling:
            ap.error("--targets needs --labels-scaling")
        scaling = json.loads(Path(args.labels_scaling).read_text())
        cond = target_cond(args.targets, scaling["labels_scaling"],
                           cfg.num_frames)
    else:
        cond = np.random.default_rng(args.seed).uniform(
            -1.0, 1.0, (args.batch, cfg.num_frames)).astype(np.float32)

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    t0 = time.perf_counter()
    videos = diffusion.sample(torch.as_tensor(cond), args.guidance_scale,
                              generator=gen, num_steps=args.num_steps)
    videos = videos.cpu().numpy()
    seconds = time.perf_counter() - t0
    if not np.isfinite(videos).all():
        raise RuntimeError("sampled videos are not finite")

    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    np.save(out / "videos.npy", videos)
    np.save(out / "cond.npy", cond)
    meta = {"videos": list(videos.shape), "seconds": seconds,
            "guidance_scale": args.guidance_scale, "seed": args.seed,
            "num_steps": args.num_steps or cfg.train_timesteps,
            "device": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else str(dev)),
            "weights": (args.checkpoint or args.weights
                        or f"seed {args.seed}")}
    (out / "sample.json").write_text(json.dumps(meta, indent=1))
    print(json.dumps(meta))
    return meta


if __name__ == "__main__":
    main()
