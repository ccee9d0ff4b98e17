#!/usr/bin/env python
"""How bf16 compute moves the classifier-free-guidance difference of a
checkpoint's model: eps(cond) - eps(null) of the bf16 plans (fused
kernels, plain ops, plain ops without cuBLAS's reduced-precision bf16
reductions) against the float32 plain plan on the same inputs.

    python scripts/torch_cfg_precision_probe.py --cache ckpt_cache/demo_euler_step_20000.msgpack
        --config model_euler.yaml --targets data_demo4x_euler/target_responses.csv
        [--size 96] [--batch 2] [--times 50,128,200] [--device cuda] [--jax]

The model is the one --config describes (its widths, frames and
channels), built as the eval CLI builds it, with each plan's compute
dtype and fused-kernel switches. For each plan it prints the relative L2
error of eps and of d = eps(cond) - eps(null), |d| / |d_ref| and the
projection <d, d_ref> / |d_ref|^2: a projection off 1 is a systematic
change of the guidance direction's size, which CFG multiplies by w every
step. --jax adds the JAX package's float32 and bf16 forwards of the same
config without its Pallas kernels (on the CPU, where JAX is installed; use
a reduced --size there).
"""

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from videometamaterials_tpu_torch.config import (  # noqa: E402
    load_model_yaml,
    resolve_device,
)
from videometamaterials_tpu_torch.convert import (  # noqa: E402
    flax_to_torch_state_dict,
    load_msgpack_tree,
)
from videometamaterials_tpu_torch.data.normalization import (  # noqa: E402
    Normalization,
    interpolate_labels,
)
from videometamaterials_tpu_torch.sample import build_sampler  # noqa: E402


def port_eps(cfg, state, dtype, fused, inputs, device):
    """eps of the port's model of cfg in `dtype` ('float32' or
    'bfloat16'), with both fused kernel families on or off."""
    plan = dataclasses.replace(
        cfg, compute_dtype=dtype,
        use_fused_linear_block="all" if fused else False,
        use_fused_temporal_block="all" if fused else False)
    model = build_sampler(plan, device=device, weights=state).model
    with torch.no_grad():
        eps = model(*[torch.as_tensor(a, device=device) for a in inputs[:3]],
                    null_cond_mask=torch.as_tensor(inputs[3], device=device))
    return eps.float().cpu().numpy()


def jax_eps(config_path, tree, dtype, inputs):
    import jax

    from videometamaterials_tpu.config import load_model_yaml as j_load
    from videometamaterials_tpu.models import UNet3D as JUNet3D
    from videometamaterials_tpu.utils import cast_params_for_inference as cast

    cfg = dataclasses.replace(j_load(config_path), compute_dtype=dtype,
                              use_fused_linear_block=False,
                              use_fused_temporal_block=False)
    model = JUNet3D.from_config(cfg)
    params = jax.tree.map(lambda a: np.asarray(a, np.float32), tree)
    if dtype == "bfloat16" and cfg.bf16_inference_weights:
        params = cast(params)
    x, t, c, m = inputs
    return np.asarray(jax.jit(model.apply)(params, x, t, c,
                                           null_cond_mask=m), np.float32)


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cache", required=True)
    p.add_argument("--config", required=True,
                   help="the tree's model.yaml (model_euler.yaml for the "
                        "eulerian trees)")
    p.add_argument("--targets", required=True)
    p.add_argument("--size", type=int, default=96)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--times", default="50,128,200")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None)
    p.add_argument("--jax", action="store_true")
    args = p.parse_args()

    dev = resolve_device(args.device)
    cfg = load_model_yaml(args.config)
    frames, channels = cfg.num_frames, cfg.channels
    cache = Path(args.cache)
    tree = load_msgpack_tree(cache)
    state = flax_to_torch_state_dict(tree)
    scaling = Normalization.from_dict(json.loads(
        cache.with_suffix(".aux.json").read_text())["labels_scaling"])
    targets = np.genfromtxt(args.targets, delimiter=",")[:args.batch]
    cond = scaling.normalize(interpolate_labels(targets, frames).astype(
        np.float32)).astype(np.float32)
    rng = np.random.default_rng(args.seed)
    b, s = args.batch, args.size
    print(f"device {torch.cuda.get_device_name(dev) if dev.type == 'cuda' else dev}, "
          f"size {s}, batch {b}")
    for t in (int(v) for v in args.times.split(",")):
        x = rng.standard_normal((b, frames, s, s, channels)).astype(np.float32)
        inputs = (np.concatenate([x, x]), np.full(2 * b, t, np.int32),
                  np.concatenate([cond, cond]),
                  np.array([False] * b + [True] * b))
        ref = port_eps(cfg, state, "float32", False, inputs, dev)
        runs = {"bf16 fused": port_eps(cfg, state, "bfloat16", True,
                                       inputs, dev),
                "bf16 plain": port_eps(cfg, state, "bfloat16", False,
                                       inputs, dev)}
        if dev.type == "cuda":
            flag = torch.backends.cuda.matmul
            old = flag.allow_bf16_reduced_precision_reduction
            flag.allow_bf16_reduced_precision_reduction = False
            runs["bf16 plain, full reductions"] = port_eps(
                cfg, state, "bfloat16", False, inputs, dev)
            flag.allow_bf16_reduced_precision_reduction = old
        if args.jax:
            runs["jax float32"] = jax_eps(args.config, tree, "float32",
                                          inputs)
            runs["jax bf16"] = jax_eps(args.config, tree, "bfloat16", inputs)
        d_ref = ref[:b] - ref[b:]
        for name, eps in runs.items():
            d = eps[:b] - eps[b:]
            print(f"t={t:3d} {name:28s} eps rel "
                  f"{np.linalg.norm(eps - ref) / np.linalg.norm(ref):.3e}  "
                  f"d rel {np.linalg.norm(d - d_ref) / np.linalg.norm(d_ref):.3e}"
                  f"  |d|/|d_ref| {np.linalg.norm(d) / np.linalg.norm(d_ref):.4f}"
                  f"  projection {np.sum(d * d_ref) / np.sum(d_ref ** 2):.4f}",
                  flush=True)


if __name__ == "__main__":
    main()
