#!/usr/bin/env python
"""Guided evaluation of a committed ckpt_cache tree through the PyTorch
port, for the fidelity protocol of BENCH_NOTES.md (8 targets x 10
predictions, best-of-10 NRMSE).

    python scripts/torch_eval_demo.py --cache ckpt_cache/demo4x_step_8000.msgpack
        --data-root data_demo4x --out OUT [--guidance-scale 1]
        [--num-preds 10] [--test-batch-size 40] [--seed 0]
        [--sampling-timesteps S] [--device cuda]

Restores the tree into <work>/runs/<run>/model/step_<N>/ (params := EMA,
no optimizer state; checkpoint.restore_from_cache), runs the port's eval
CLI on it (`videometamaterials_tpu_torch.main --skip-train` with the
flagship model.yaml; labels_scaling and zero_u_2 from
<data-root>/lagrangian/training), and copies the eval directory's gifs/ and
geometries.csv to OUT with a summary.json (chain seconds, videos, the
card's name and power limit); --sampling-timesteps S below the config's
train_timesteps samples with the S-step DDIM chain. The data root needs
only the training folder's stress_strain_data.csv and
frame_range_data.csv and target_responses.csv. Score OUT with
scripts/eval_demo_quality.py --eval-dir OUT --num-preds 10 (it needs the
JAX package).
"""

import argparse
import json
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from videometamaterials_tpu_torch import main as cli  # noqa: E402
from videometamaterials_tpu_torch.training.checkpoint import (  # noqa: E402
    restore_from_cache,
)


def main() -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cache", required=True)
    p.add_argument("--data-root", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--config", default=str(ROOT / "model.yaml"))
    p.add_argument("--guidance-scale", type=float, default=1.0)
    p.add_argument("--num-preds", type=int, default=10)
    p.add_argument("--test-batch-size", type=int, default=40)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sampling-timesteps", type=int, default=None)
    p.add_argument("--device", default=None)
    args = p.parse_args()

    cache = Path(args.cache)
    m = re.fullmatch(r"(.+)_step_(\d+)\.msgpack", cache.name)
    if not m:
        raise SystemExit(f"{cache.name}: not a <run>_step_<N>.msgpack tree")
    run, step = m.group(1), int(m.group(2))
    (ROOT / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="eval_demo_", dir=ROOT / "build"))
    try:
        restore_from_cache(cache, work / "runs" / run, step)
        t0 = time.perf_counter()
        out = cli.main([
            "--run-name", run, "--runs-root", str(work / "runs"),
            "--data-root", args.data_root, "--config", args.config,
            "--load-model-step", str(step), "--skip-train",
            "--guidance-scale", str(args.guidance_scale),
            "--num-preds", str(args.num_preds),
            "--test-batch-size", str(args.test_batch_size),
            "--seed", str(args.seed)]
            + (["--sampling-timesteps", str(args.sampling_timesteps)]
               if args.sampling_timesteps else [])
            + (["--device", args.device] if args.device else []))
        total = time.perf_counter() - t0
        dest = Path(args.out)
        dest.mkdir(parents=True, exist_ok=True)
        shutil.copytree(out["eval_dir"] / "gifs", dest / "gifs",
                        dirs_exist_ok=True)
        shutil.copy(out["eval_dir"] / "geometries.csv", dest)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip() if shutil.which("nvidia-smi") else "no GPU"
    summary = {"cache": cache.name, "step": out["step"],
               "guidance_scale": args.guidance_scale,
               "sampling_timesteps": args.sampling_timesteps,
               "num_preds": args.num_preds,
               "chunk": cli.sampling_chunk(args.test_batch_size),
               "videos": list(out["videos"].shape),
               "sample_seconds": out["sample_seconds"],
               "cli_seconds": total, "card": smi}
    (dest / "summary.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
