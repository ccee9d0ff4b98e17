"""Worker of tests/test_torch_port_parallel.py: one rank of a two-process
gloo group on the CPU, running the port only (no JAX).

    python _torch_port_parallel_worker.py steps|trainer INIT RANK WORLD DIR

steps:   three train_steps of the tiny model on this rank's rows of the
         global batch and draws in DIR/inputs.pt; writes DIR/rank<r>.pt
         (losses, state digest, parameters).
trainer: the GIF-folder Trainer on DIR/data for three steps, its
         checkpoint reloaded, sample_videos of three curves and the
         validation loss; writes DIR/rank<r>.json and DIR/videos<r>.npy.
"""

import hashlib
import json
import sys
from pathlib import Path

import numpy as np
import torch

from videometamaterials_tpu_torch.config import TrainerConfig

# the Trainer's run: tests/_multihost_train_worker.py's settings
TRAINER_TCFG = TrainerConfig(train_num_steps=3, save_and_sample_every=1000,
                             test_batch_size=2, ema_start_step=1,
                             ema_update_every=1, log=False, seed=0)


def three_curves(cfg) -> np.ndarray:
    """Three conditioning curves: not a multiple of two ranks."""
    return np.linspace(-1, 1, 3 * cfg.cond_length, dtype=np.float32
                       ).reshape(3, cfg.cond_length)


def digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def state_digest(state) -> str:
    """The parameters, the EMA and Adam's moments (zeros where Adam holds
    none yet, as the optax state read back from a checkpoint has them)."""
    params = list(state.model.parameters())
    opt = state.optimizer.state
    moments = [opt[p][k] if p in opt else torch.zeros_like(p)
               for p in params for k in ("exp_avg", "exp_avg_sq")]
    return digest(params + state.ema + moments)


def steps(out: Path, rank: int, world: int) -> None:
    from videometamaterials_tpu_torch.diffusion.gaussian import (
        GaussianDiffusion,
    )
    from videometamaterials_tpu_torch.models.unet3d import build_unet
    from videometamaterials_tpu_torch.training.trainer import (
        TrainState,
        train_step,
    )

    inp = torch.load(out / "inputs.pt", weights_only=False)
    cfg, tcfg = inp["cfg"], inp["tcfg"]
    model = build_unet(cfg, device="cpu", seed=None)
    model.load_state_dict(inp["weights"], strict=True)
    diffusion = GaussianDiffusion.from_config(model, cfg, "cpu")
    state = TrainState.create(model, cfg.learning_rate)
    b = len(inp["videos"]) // world
    rows = slice(rank * b, (rank + 1) * b)
    losses = []
    for draws in inp["draws"]:
        loss = train_step(state, diffusion, inp["videos"][rows],
                          inp["labels"][rows], tcfg, fused_in_training=False,
                          **draws)
        losses.append(float(loss))
    torch.save({"losses": losses, "digest": state_digest(state),
                "params": {k: v.detach() for k, v in
                           model.named_parameters()}},
               out / f"rank{rank}.pt")


def trainer(out: Path, rank: int, world: int) -> None:
    from videometamaterials_tpu_torch.diffusion.gaussian import (
        GaussianDiffusion,
    )
    from videometamaterials_tpu_torch.graft_entry import DRYRUN_CONFIG
    from videometamaterials_tpu_torch.models.unet3d import build_unet
    from videometamaterials_tpu_torch.training.trainer import Trainer

    cfg = DRYRUN_CONFIG
    model = build_unet(cfg, device="cpu", seed=0)
    tr = Trainer(GaussianDiffusion.from_config(model, cfg, "cpu"), cfg,
                 TRAINER_TCFG, out / "data" / "train", out / "data" / "val",
                 results_folder=out / "run")
    tr.train()
    trained = state_digest(tr.state)
    before = [p.detach().clone() for p in model.parameters()]
    tr.load(3)
    reload_ok = all(torch.equal(a, p) for a, p in zip(before,
                                                      model.parameters()))
    videos = tr.sample_videos(three_curves(cfg), 5.0)
    np.save(out / f"videos{rank}.npy", videos)
    result = {"digest": trained, "reload_ok": reload_ok,
              "reloaded_digest": state_digest(tr.state),
              "saves": sum("save" in t for t in tr.timings),
              "videos": hashlib.sha256(videos.tobytes()).hexdigest(),
              "val_loss": tr.validation_loss(),
              "test_batch": tr.test_batch}
    (out / f"rank{rank}.json").write_text(json.dumps(result))


def main():
    mode, init, rank, world, out = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    from videometamaterials_tpu_torch import parallel

    assert parallel.initialize_distributed(init, world, rank, "gloo")
    try:
        {"steps": steps, "trainer": trainer}[mode](Path(out), rank, world)
    finally:
        parallel.mesh.destroy()


if __name__ == "__main__":
    main()
