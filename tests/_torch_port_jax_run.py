"""A run written by the JAX package for the port's tests: the tiny config
(dim 8, 11 x 16 x 16, float32), its snapshot, and a trainer checkpoint
(step, params, Adam state, EMA) through the JAX `save_checkpoint`; a
synthetic data folder with target curves."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax

from videometamaterials_tpu.config import ModelConfig, snapshot_run_config
from videometamaterials_tpu.data.synthetic import make_synthetic_dataset
from videometamaterials_tpu.models import UNet3D
from videometamaterials_tpu.training.checkpoint import save_checkpoint

TINY = dict(batch_size=2, image_size=16, num_frames=11, unet_dim=8,
            dim_mults=(1, 2), unet_attn_heads=2, unet_attn_dim_head=4,
            compute_dtype="float32", train_timesteps=8,
            sampling_timesteps=8, use_fused_linear_block="all",
            use_fused_temporal_block="all")


def tiny_config(**kw) -> ModelConfig:
    return ModelConfig(**{**TINY, **kw})


def init_params(cfg: ModelConfig, seed: int = 0):
    model = UNet3D.from_config(cfg)
    x = jnp.zeros((1, cfg.num_frames, cfg.image_size, cfg.image_size,
                   cfg.channels), jnp.float32)
    return model, jax.jit(model.init)(
        jax.random.PRNGKey(seed), x, jnp.zeros((1,), jnp.int32),
        jnp.zeros((1, cfg.num_frames), jnp.float32))


def write_run(run_dir: Path, step: int, cfg: ModelConfig, seed: int = 0):
    """The JAX trainer's files for `cfg` at `step`: model/model.yaml and
    model/step_<step>/{checkpoint.msgpack, aux.json}. The EMA differs from
    the online parameters, so a loader that takes the wrong one shows.
    Returns (the JAX model, its EMA tree, the payload written)."""
    snapshot_run_config(cfg, run_dir)
    model, params = init_params(cfg, seed)
    rng = np.random.default_rng(seed)
    ema = jax.tree.map(
        lambda a: np.asarray(a) + np.float32(0.05) * rng.standard_normal(
            a.shape).astype(np.float32), params)
    payload = jax.device_get({
        "step": jnp.asarray(step, jnp.int32), "params": params,
        "opt_state": optax.adam(cfg.learning_rate).init(params),
        "ema_params": ema})
    save_checkpoint(run_dir, step, payload, {"step": step})
    return model, ema, payload


def write_data(root: Path, cfg: ModelConfig, num_targets: int = 2,
               seed: int = 0) -> Path:
    """<root>/<reference_frame>/training (synthetic GIFs and CSVs) and
    <root>/target_responses.csv (51-point curves)."""
    make_synthetic_dataset(root / cfg.reference_frame / "training",
                           num_samples=4, image_size=cfg.image_size,
                           num_frames=cfg.num_frames, seed=seed)
    strains = np.linspace(0.0, 0.2, 51)
    slopes = np.random.default_rng(seed).uniform(0.5, 2.0, num_targets)
    np.savetxt(root / "target_responses.csv", slopes[:, None] * strains,
               delimiter=",")
    return root
