"""Worker of tests/test_torch_port_latency.py: one rank of a two-process
gloo group on the CPU running the port's latency mode (no JAX).

    python _torch_port_latency_worker.py INIT RANK WORLD DIR

For each case of DIR/inputs.pt (a config, converted weights, the
conditioning, x_T and the step noises, the axis): the first step's guided
eps, without and with CFG rescale (phi 0.7), and the guided chain split
over the group, all whole on every rank, and the plan's collective counts
before each step's noise and after the chain; and for each case's split,
group_norm of DIR/inputs.pt's "norm_input" in the one-pass and the
two-pass form. Writes DIR/rank<r>.pt: {case: {"video", "eps",
"eps_rescaled", "norm", "before_step", "total"}}.
"""

import sys
from pathlib import Path

import torch


def run(inputs: dict) -> dict:
    from videometamaterials_tpu_torch import parallel
    from videometamaterials_tpu_torch.diffusion.gaussian import (
        GaussianDiffusion,
    )
    from videometamaterials_tpu_torch.models.unet3d import build_unet
    from videometamaterials_tpu_torch.ops.norms import group_norm

    out = {}
    norm_x, norm_scale, norm_bias = inputs.pop("norm_input")
    for name, case in inputs.items():
        cfg = case["cfg"]
        model = build_unet(cfg, device="cpu", seed=None)
        model.load_state_dict(case["weights"], strict=True)
        plan = (parallel.spatial_video_sharding() if case["axis"] == "height"
                else parallel.frame_video_sharding())
        diffusion = GaussianDiffusion.from_config(
            model, cfg, "cpu", sample_spatial_sharding=plan)
        lat = diffusion.latency
        t = torch.full((1,), cfg.train_timesteps - 1)
        with torch.no_grad():
            eps, eps_rescaled = (lat.gather(diffusion.guided_eps(
                lat.local(case["x_T"]), t, case["cond"], 5.0, phi,
                latency=lat)) for phi in (0.0, 0.7))
        norm = [lat.gather(group_norm(
            lat.local(norm_x), norm_scale, norm_bias, 4, one_pass=one_pass,
            shard=lat.levels[0])) for one_pass in (True, False)]
        plan.reset_counts()
        before = []

        def noise(i, noises=case["noises"]):
            before.append(dict(plan.counts))
            return noises[i]

        video = diffusion.sample(case["cond"], 5.0, x_T=case["x_T"],
                                 noise_fn=noise)
        out[name] = {"video": video, "eps": eps,
                     "eps_rescaled": eps_rescaled, "norm": norm,
                     "before_step": before,
                     "total": dict(plan.counts)}
    return out


def main():
    init, rank, world, out = sys.argv[1:5]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    from videometamaterials_tpu_torch import parallel

    assert parallel.initialize_distributed(init, world, rank, "gloo")
    try:
        inputs = torch.load(Path(out) / "inputs.pt", weights_only=False)
        torch.save(run(inputs), Path(out) / f"rank{rank}.pt")
    finally:
        parallel.mesh.destroy()


if __name__ == "__main__":
    main()
