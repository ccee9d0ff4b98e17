"""Entry point of the port: training on a data folder and guided target
evaluation.

    python -m videometamaterials_tpu_torch.main --run-name NAME
        [--config model.yaml] [--data-root ./data] [--runs-root ./runs]
        [--train-num-steps N] [--save-and-sample-every M]
        [--num-samples S] [--num-preds P] [--guidance-scale W]
        [--fidelity-probe T.csv [--fidelity-probe-targets K]
         [--fidelity-probe-preds Q]] [--load-model-step STEP]
        [--skip-train] [--skip-eval-target] [--target-labels T.csv]
        [--cfg-rescale PHI] [--dynamic-thres-method bisect|sort]
        [--sampling-timesteps S] [--guidance-arms W[:PHI],...]
        [--torch-checkpoint checkpoint.pt]
        [--test-batch-size B] [--seed 0] [--no-log] [--device cuda]
        [--profile-dir DIR]

The JAX package's main.py (:57-187): the run directory runs/NAME with its
config snapshot (model/model.yaml, written from --config for a new run,
re-read for an existing one, which needs --load-model-step). Without
--skip-train the model trains on <data-root>/<reference_frame>/training
(validation on .../validation) for N steps, from seeded weights or resumed
from model/step_STEP: every M steps a checkpoint (model/step_<k>/), then
the validation loss, the fidelity probe on the first K curves of T.csv
(Q predictions each) and P samples of S validation curves
(training/step_<k>/), with the losses in metrics.jsonl; the last step is
saved once. With --skip-train the EMA weights of model/step_STEP are read
strictly (or seeded weights without a step). --torch-checkpoint imports a
reference checkpoint.pt first: its online and EMA weights into the
trainer, or with --skip-train its EMA weights into the sampler; a
--load-model-step given as well overrides it. Then, unless
--skip-eval-target, every target curve is sampled P times under
classifier-free guidance with the fused kernels, in chunks of B // 2
videos, from a bf16 copy of the EMA weights, and the artifacts are written
to runs/NAME/eval_target_w_<W>[_phi_<PHI>]_<i>/step_<k>/
(gifs/prediction_channel_<c>.gif, geometries.csv). --sampling-timesteps S
below the config's train_timesteps samples with the S-step DDIM chain
(eta = the config's ddim_sampling_eta), milestones included.
--guidance-arms '5,2:0.7' evaluates each (w, phi) arm in turn (phi 0
where not given, not the config's cfg_rescale), one directory and one
printed line an arm, every arm from the same seed. --profile-dir DIR
writes a torch.profiler trace of training steps start+10 to start+13 to
DIR/trace_rank<r>.json. Runs on the GPU unless --device names another
device.

Under a launcher (torchrun --nproc_per_node N -m
videometamaterials_tpu_torch.main ..., or SLURM) the N processes train
data-parallel, one device each (NCCL on the cards, gloo with --device
cpu): the global batch is batch_size x N, rank 0 alone writes the run
directory, and every rank samples its share of each chunk. Without one it
is one process.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

from videometamaterials_tpu_torch import parallel
from videometamaterials_tpu_torch.config import (
    TrainerConfig,
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
from videometamaterials_tpu_torch.diffusion.gaussian import GaussianDiffusion
from videometamaterials_tpu_torch.models.unet3d import (
    build_unet,
    state_dict_template,
)
from videometamaterials_tpu_torch.sample import build_sampler
from videometamaterials_tpu_torch.training import checkpoint as ckpt
from videometamaterials_tpu_torch.training.torch_import import (
    load_reference_weights,
)
from videometamaterials_tpu_torch.training.trainer import (
    Trainer,
    eval_target,
    sampling_chunk,
)


def parse_arms(spec: str) -> list[tuple[float, float, float]]:
    """--guidance-arms 'w[:phi],...' -> [(w, phi, w_label)]: w and phi
    rounded to float32 (the JAX CLI's traced operands), phi 0 where not
    given, and the directory's w as the JAX Trainer writes it (6
    significant digits)."""
    arms = []
    for arm in spec.split(","):
        try:
            values = [float(np.float32(float(v))) for v in arm.split(":")]
        except ValueError:
            values = []
        if not 1 <= len(values) <= 2:
            raise ValueError(f"guidance arm {arm!r}: not w or w:phi")
        w, phi = values[0], values[1] if len(values) == 2 else 0.0
        arms.append((w, phi, float(f"{w:.6g}")))
    return arms


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
                   help="eval and validation batch; each sampling call "
                        "takes half of it, as in the JAX package")
    p.add_argument("--train-num-steps", type=int, default=200_000)
    p.add_argument("--save-and-sample-every", type=int, default=10_000)
    p.add_argument("--num-samples", type=int, default=3)
    p.add_argument("--fidelity-probe", default=None,
                   help="target_responses.csv: guided samples of its first "
                        "curves at every milestone, their best-of-N "
                        "pixel-curve NRMSE logged beside the val loss")
    p.add_argument("--fidelity-probe-targets", type=int, default=2)
    p.add_argument("--fidelity-probe-preds", type=int, default=2)
    p.add_argument("--no-log", action="store_true")
    p.add_argument("--skip-train", action="store_true")
    p.add_argument("--skip-eval-target", action="store_true")
    p.add_argument("--torch-checkpoint", default=None)
    p.add_argument("--device", default=None)
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of training steps "
                        "start+10 to start+13 here")
    return p


def main(argv=None) -> dict:
    """Run the CLI; returns {'eval_dir', 'videos', 'step',
    'sample_seconds', 'trainer', 'arms'}: 'arms' a dict an evaluated arm
    (guidance_scale, cfg_rescale, eval_dir, videos, sample_seconds), the
    eval keys the last arm's (None with --skip-eval-target), the trainer
    None with --skip-train. Under a launcher the process joins its group
    for the run and leaves it at the end."""
    args = _parser().parse_args(argv)
    arms = parse_arms(args.guidance_arms) if args.guidance_arms else None
    if args.torch_checkpoint and not Path(args.torch_checkpoint).is_file():
        raise FileNotFoundError(f"--torch-checkpoint {args.torch_checkpoint}"
                                ": no such file")
    # a launcher's environment joins a process group; without one a no-op
    joined = not parallel.active() and parallel.initialize_distributed(
        backend="gloo" if args.device == "cpu" else None)
    try:
        return _run(args, arms)
    finally:
        if joined:
            parallel.mesh.destroy()


def _run(args, arms) -> dict:
    dev = resolve_device(args.device)
    if dev.type == "cuda" and dev.index is None and parallel.active():
        dev = torch.device("cuda", torch.cuda.current_device())

    run_dir = Path(args.runs_root) / args.run_name
    cfg_snapshot = run_dir / "model" / "model.yaml"
    fresh = not (run_dir.exists() and cfg_snapshot.exists())
    # every rank checks before any rank writes
    parallel.barrier()
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
    if not 0 < cfg.sampling_timesteps <= cfg.train_timesteps:
        raise ValueError(f"sampling_timesteps {cfg.sampling_timesteps} not "
                         f"in [1, {cfg.train_timesteps}]")
    tcfg = TrainerConfig(
        train_num_steps=args.train_num_steps,
        save_and_sample_every=args.save_and_sample_every,
        guidance_scale=args.guidance_scale, num_preds=args.num_preds,
        num_samples=args.num_samples, seed=args.seed, log=not args.no_log,
        test_batch_size=args.test_batch_size,
        fidelity_probe_targets=args.fidelity_probe,
        fidelity_probe_n_targets=args.fidelity_probe_targets,
        fidelity_probe_preds=args.fidelity_probe_preds)
    if fresh and parallel.rank() == 0:
        snapshot_run_config(config, run_dir)

    data_root = Path(args.data_root)
    data_dir = data_root / cfg.reference_frame / "training"
    out = {"eval_dir": None, "videos": None, "step": 0,
           "sample_seconds": None, "trainer": None, "arms": []}
    if args.skip_train:
        labels_scaling = fit_labels_scaling(data_dir, cfg.num_frames,
                                            cfg.per_frame_cond)
        ranges = global_ranges(data_dir, cfg.reference_frame)
        if parallel.rank() == 0:
            write_min_max_values(data_dir, ranges)
        zero = zero_u_2(ranges)
        weights = None
        if args.torch_checkpoint:
            weights = load_reference_weights(args.torch_checkpoint,
                                             state_dict_template(cfg), "ema")
            print(f"imported torch checkpoint from {args.torch_checkpoint}")
        if args.load_model_step is not None:
            raw = ckpt.read_checkpoint(run_dir, args.load_model_step)
            out["step"] = int(np.asarray(raw["step"]))
            weights = flax_to_torch_state_dict(raw["ema_params"])
            print(f"checkpoint loaded from step {out['step']}")
        # the sampler's own model (it reads the tree strictly), its weights
        # cast to bf16 where the forward casts them anyway
        diffusion = build_sampler(cfg, device=dev, weights=weights,
                                  seed=args.seed)
    else:
        model = build_unet(cfg, device=dev, seed=args.seed)
        trainer = Trainer(GaussianDiffusion.from_config(model, cfg, dev),
                          cfg, tcfg, data_dir,
                          data_root / cfg.reference_frame / "validation",
                          results_folder=run_dir,
                          profile_dir=args.profile_dir)
        if args.torch_checkpoint:
            trainer.load_torch_checkpoint(args.torch_checkpoint)
        trainer.train(load_model_step=args.load_model_step,
                      num_samples=args.num_samples,
                      num_preds=args.num_preds)
        out["trainer"], out["step"] = trainer, trainer.state.step
        labels_scaling, zero = trainer.ds.labels_scaling, trainer.ds.zero_u_2
        diffusion = None if args.skip_eval_target \
            else trainer.sampling_diffusion()

    if not args.skip_eval_target:
        targets = args.target_labels or str(data_root /
                                            "target_responses.csv")
        for w, phi, w_label in arms or [(args.guidance_scale, None, None)]:
            result = eval_target(
                diffusion, cfg, run_dir, out["step"], targets, labels_scaling,
                zero, guidance_scale=w, num_preds=args.num_preds,
                chunk=sampling_chunk(args.test_batch_size)
                * parallel.world_size(), seed=args.seed,
                cfg_rescale=phi, w_label=w_label)
            if result is None:
                break
            eval_dir, videos, seconds = result
            if arms:
                print(f"guidance arm w={w_label} phi={float(f'{phi:.6g}')} "
                      f"-> {eval_dir}")
            out["arms"].append({"guidance_scale": w, "cfg_rescale": phi,
                                "eval_dir": eval_dir, "videos": videos,
                                "sample_seconds": seconds})
            out["eval_dir"], out["videos"], out["sample_seconds"] = result
            print(json.dumps({
                "eval_dir": str(eval_dir), "step": out["step"],
                "videos": list(videos.shape), "sample_seconds": seconds,
                "device": (torch.cuda.get_device_name(dev)
                           if dev.type == "cuda" else str(dev))}))
    return out


if __name__ == "__main__":
    main()
