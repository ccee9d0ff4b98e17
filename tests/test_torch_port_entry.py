"""PyTorch port, entry points and package rules: the GPU is the default
device (no quiet CPU fallback), the sampler CLI runs end to end on the CPU
when asked to, and no source of the port imports JAX, flax, yaml, msgpack,
PIL, imageio or the JAX package."""

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from videometamaterials_tpu_torch import config, sample
from videometamaterials_tpu_torch.config import (
    ModelConfig,
    TrainerConfig,
    load_model_yaml,
)
from videometamaterials_tpu_torch.convert import (
    load_state_dict_npz,
    save_state_dict_npz,
)
from videometamaterials_tpu_torch.models.unet3d import build_unet

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "flax", "yaml", "msgpack", "PIL", "imageio",
             "videometamaterials_tpu")
TINY_YAML = """
selected_channels: [0, 1, 3]
train_timesteps: 8
sampling_timesteps: 8
unet_dim: 16
dim_mults: [1, 2]
unet_attn_heads: 2
unet_attn_dim_head: 8
image_size: 8
compute_dtype: float32
"""


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_need_a_gpu_unless_told_otherwise(no_cuda, tmp_path):
    cfg = ModelConfig(unet_dim=16, dim_mults=(1, 2), unet_attn_heads=2,
                      unet_attn_dim_head=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        config.resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_unet(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        sample.build_sampler(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        sample.main(["--out-dir", str(tmp_path)])
    assert not any(tmp_path.iterdir())
    model = build_unet(cfg, device="cpu")
    assert next(model.parameters()).device.type == "cpu"


def test_sample_cli_on_the_cpu(tmp_path, monkeypatch):
    """The CLI with converted weights (npz), target curves normalised by
    the checkpoint's labels_scaling and a partial chain."""
    yaml_path = tmp_path / "tiny.yaml"
    yaml_path.write_text(TINY_YAML)
    cfg = config.load_model_yaml(yaml_path)
    monkeypatch.setattr(sample, "ModelConfig", lambda: cfg)
    weights = tmp_path / "w.npz"
    save_state_dict_npz(build_unet(cfg, device="cpu", seed=3).state_dict(),
                        weights)
    targets = tmp_path / "targets.csv"
    np.savetxt(targets, np.stack([np.linspace(0, -1.2, 51),
                                  np.linspace(0, -0.6, 51)]) * -0.1,
               delimiter=",")
    out = tmp_path / "out"
    meta = sample.main([
        "--out-dir", str(out), "--weights", str(weights), "--targets",
        str(targets), "--labels-scaling",
        str(ROOT / "ckpt_cache/demo4x_step_8000.aux.json"),
        "--num-steps", "2", "--device", "cpu"])
    videos = np.load(out / "videos.npy")
    assert videos.shape == (2, 11, 8, 8, 3) == tuple(meta["videos"])
    assert np.isfinite(videos).all()
    assert np.load(out / "cond.npy").shape == (2, 11)
    assert json.loads((out / "sample.json").read_text())["num_steps"] == 2
    state = load_state_dict_npz(weights)
    assert set(state) == set(build_unet(cfg, device="cpu").state_dict())


@pytest.mark.parametrize("field,value", [
    ("remat_blocks", True), ("temporal_s_tile", 32),
    ("prob_focus_present", 0.5), ("gradient_accumulate_every", 2)])
def test_unported_variants_raise(field, value, tmp_path):
    """The training-side variants that raised until they were ported
    (ROADMAP.md Queue 1 item 8) now train on a tiny config: the model.yaml
    keys read by load_model_yaml (a tile of 32 splits the 8 x 8 level into
    two), the trainer's keys taken by TrainerConfig, two steps each with
    finite losses; the model variants of the conditioning ablation build
    (tests/test_torch_port_train_variants.py and
    tests/test_torch_port_variants.py hold them against the JAX model)."""
    from videometamaterials_tpu_torch import train as t_train

    path = tmp_path / "model.yaml"
    trainer_keys = ("prob_focus_present", "gradient_accumulate_every")
    path.write_text(TINY_YAML + ("" if field in trainer_keys else
                                 f"{field}: {str(value).lower()}\n"))
    cfg = load_model_yaml(path).replace(batch_size=2)
    tcfg = TrainerConfig(**({field: value} if field in trainer_keys
                            else {}))
    assert getattr(tcfg if field in trainer_keys else cfg, field) == value
    out = t_train.run(cfg, 2, device="cpu", tcfg=tcfg, log=lambda _: None)
    assert np.isfinite(out["losses"]).all() and len(out["losses"]) == 2
    for variant in (dict(per_frame_cond=False),
                    dict(unet_use_sparse_linear_attn=False),
                    dict(unet_cond_to_time="concat"),
                    dict(padding_mode="circular")):
        build_unet(ModelConfig().replace(unet_dim=8, dim_mults=(1, 2),
                                         **variant), device="cpu", seed=None)


def _imports(path: Path):
    """(module, enclosing function) for every import in a source file."""
    tree = ast.parse(path.read_text())
    out = []

    def visit(node, func):
        for child in ast.iter_child_nodes(node):
            f = child.name if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef)) else func
            if isinstance(child, ast.Import):
                out.extend((a.name, f) for a in child.names)
            elif isinstance(child, ast.ImportFrom) and child.module:
                out.append((child.module, f))
            visit(child, f)

    visit(tree, None)
    return out


def test_port_imports_nothing_of_jax_or_the_jax_package():
    sources = sorted((ROOT / "videometamaterials_tpu_torch").rglob("*.py"))
    sources.append(ROOT / "chip_smoke.py")
    assert len(sources) > 15
    for path in sources:
        for module, _ in _imports(path):
            top = module.split(".")[0]
            assert top not in FORBIDDEN, f"{path}: imports {module}"
