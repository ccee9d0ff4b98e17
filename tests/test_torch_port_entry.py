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
from videometamaterials_tpu_torch.config import ModelConfig
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
    ("per_frame_cond", False), ("unet_use_sparse_linear_attn", False),
    ("unet_cond_to_time", "concat"), ("padding_mode", "circular")])
def test_unported_variants_raise(field, value):
    with pytest.raises(NotImplementedError):
        build_unet(ModelConfig().replace(**{field: value}), device="cpu",
                   seed=None)


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
