"""Entry point of the port: guided target evaluation of a run's checkpoint.

    python -m videometamaterials_tpu_torch.main --run-name NAME
        --load-model-step S --skip-train [--config model.yaml]
        [--data-root ./data] [--runs-root ./runs] [--target-labels T.csv]
        [--num-preds P] [--guidance-scale W] [--cfg-rescale PHI]
        [--dynamic-thres-method bisect|sort] [--test-batch-size B]
        [--seed 0] [--device cuda]

The JAX package's main.py (:110-178) with --skip-train: the run directory
runs/NAME with its config snapshot (model/model.yaml, written from
--config for a new run, re-read for an existing one), the EMA weights of
model/step_S/checkpoint.msgpack (loaded strictly: the sampler's model
takes the converted tree with load_state_dict(strict=True)),
labels_scaling and zero_u_2 from the training folder
<data-root>/<reference_frame>/training
(whose min_max_values.csv it writes), then every target curve sampled P
times under classifier-free guidance with the fused kernels, in chunks of
B // 2 videos, and the artifacts written to
runs/NAME/eval_target_w_<W>_<i>/step_S/ (gifs/prediction_channel_<c>.gif,
geometries.csv). Runs on the GPU unless --device names another device.

Training (without --skip-train), --guidance-arms, DDIM (--sampling-timesteps
below the train steps), --fidelity-probe, --torch-checkpoint and the
orbax checkpoints raise: they are not ported yet.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

from videometamaterials_tpu_torch.config import (
    load_model_yaml,
    resolve_device,
    snapshot_run_config,
)
from videometamaterials_tpu_torch.convert import flax_to_torch_state_dict
from videometamaterials_tpu_torch.data.dataset import (
    fit_labels_scaling,
    global_ranges,
    write_min_max_values,
    zero_u_2,
)
from videometamaterials_tpu_torch.sample import build_sampler
from videometamaterials_tpu_torch.training import checkpoint as ckpt
from videometamaterials_tpu_torch.training.trainer import (
    eval_target,
    sampling_chunk,
)

_NOT_PORTED = {
    "guidance_arms": "--guidance-arms (several (w, phi) arms of one "
                     "program): ROADMAP.md Queue 1 item 5",
    "fidelity_probe": "--fidelity-probe (the milestone fidelity probe): "
                      "ROADMAP.md Queue 1 item 4",
    "torch_checkpoint": "--torch-checkpoint (reference checkpoint.pt "
                        "import): ROADMAP.md Queue 1 item 4",
}


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--run-name", default="pretrained")
    p.add_argument("--load-model-step", type=int, default=None)
    p.add_argument("--num-preds", type=int, default=1)
    p.add_argument("--guidance-scale", type=float, default=5.0)
    p.add_argument("--guidance-arms", default=None)
    p.add_argument("--cfg-rescale", type=float, default=None)
    p.add_argument("--sampling-timesteps", type=int, default=None)
    p.add_argument("--dynamic-thres-method", default=None,
                   choices=["bisect", "sort"])
    p.add_argument("--data-root", default="./data")
    p.add_argument("--runs-root", default="./runs")
    p.add_argument("--config", default="model.yaml")
    p.add_argument("--target-labels", default=None,
                   help="CSV of target responses (default "
                        "<data-root>/target_responses.csv)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--test-batch-size", type=int, default=2,
                   help="eval batch; each sampling call takes half of it, "
                        "as in the JAX package")
    p.add_argument("--fidelity-probe", default=None)
    p.add_argument("--skip-train", action="store_true")
    p.add_argument("--skip-eval-target", action="store_true")
    p.add_argument("--torch-checkpoint", default=None)
    p.add_argument("--device", default=None)
    return p


def main(argv=None) -> dict:
    """Run the CLI; returns {'eval_dir', 'videos', 'step',
    'sample_seconds'} (None but the step with --skip-eval-target)."""
    args = _parser().parse_args(argv)
    for name, what in _NOT_PORTED.items():
        if getattr(args, name):
            raise NotImplementedError(f"{what} is not ported yet")
    if not args.skip_train:
        raise NotImplementedError(
            "training (the loop with milestones and the GIF-folder "
            "dataset) is not ported yet: ROADMAP.md Queue 1 item 4; pass "
            "--skip-train")
    dev = resolve_device(args.device)

    run_dir = Path(args.runs_root) / args.run_name
    cfg_snapshot = run_dir / "model" / "model.yaml"
    fresh = not (run_dir.exists() and cfg_snapshot.exists())
    if not fresh and args.load_model_step is None:
        print("Directory already exists, please change run_name to train "
              "new model or provide load_model_step")
        raise SystemExit(1)
    config = load_model_yaml(args.config if fresh else cfg_snapshot)
    overrides = {k: v for k, v in (
        ("cfg_rescale", args.cfg_rescale),
        ("sampling_timesteps", args.sampling_timesteps),
        ("dynamic_thres_method", args.dynamic_thres_method)) if v is not None}
    cfg = dataclasses.replace(config, **overrides)
    if cfg.sampling_timesteps < cfg.train_timesteps:
        raise NotImplementedError(
            "DDIM sampling (sampling_timesteps below train_timesteps) is "
            "not ported yet: ROADMAP.md Queue 1 item 5")
    if fresh:
        snapshot_run_config(config, run_dir)

    data_dir = Path(args.data_root) / cfg.reference_frame / "training"
    labels_scaling = fit_labels_scaling(data_dir, cfg.num_frames,
                                        cfg.per_frame_cond)
    ranges = global_ranges(data_dir, cfg.reference_frame)
    write_min_max_values(data_dir, ranges)

    step, weights = 0, None
    if args.load_model_step is not None:
        raw = ckpt.read_checkpoint(run_dir, args.load_model_step)
        step = int(np.asarray(raw["step"]))
        weights = flax_to_torch_state_dict(raw["ema_params"])
        print(f"checkpoint loaded from step {step}")
    # the sampler's own model, its weights cast to bf16 where the forward
    # casts them anyway
    diffusion = build_sampler(cfg, device=dev, weights=weights,
                              seed=args.seed)

    out = {"eval_dir": None, "videos": None, "step": step,
           "sample_seconds": None}
    if not args.skip_eval_target:
        targets = args.target_labels or str(Path(args.data_root)
                                            / "target_responses.csv")
        result = eval_target(
            diffusion, cfg, run_dir, step, targets, labels_scaling,
            zero_u_2(ranges), guidance_scale=args.guidance_scale,
            num_preds=args.num_preds,
            chunk=sampling_chunk(args.test_batch_size), seed=args.seed)
        if result is not None:
            out["eval_dir"], out["videos"], out["sample_seconds"] = result
            print(json.dumps({
                "eval_dir": str(out["eval_dir"]), "step": step,
                "videos": list(out["videos"].shape),
                "sample_seconds": out["sample_seconds"],
                "device": (torch.cuda.get_device_name(dev)
                           if dev.type == "cuda" else str(dev))}))
    return out


if __name__ == "__main__":
    main()
