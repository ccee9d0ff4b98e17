"""PyTorch port, config files on the CPU: the stdlib reader and writer of
the YAML subset against yaml.safe_load (the repo's model.yaml and
model_euler.yaml, the tiny drive config, the JAX package's saved
configs), the run snapshot, and the forms it refuses."""

import dataclasses
import math
from pathlib import Path

import pytest
import yaml
from hypothesis import given, settings
from hypothesis import strategies as st

from videometamaterials_tpu import config as j_config
from videometamaterials_tpu_torch import config

ROOT = Path(__file__).resolve().parents[1]
# the tiny drive config of the verify recipe (block and flow lists)
TINY = """\
batch_size: 2
learning_rate: 1.e-4
selected_channels: [0, 1, 3]
train_timesteps: 8
sampling_timesteps: 8
use_dynamic_thres: true
reference_frame: 'lagrangian'
padding_mode: 'zeros'
unet_dim: 8
dim_mults:
  - 1
  - 2
unet_attn_heads: 2   # trailing comment
unet_attn_dim_head: 4
unet_resnet_groups: 8
unet_cond_attention: 'self-stacked'
unet_cond_to_time: "add"
unet_temporal_att_cond: true
unet_use_sparse_linear_attn: True
per_frame_cond: true
image_size: 16
num_frames: 3
compute_dtype: float32
temporal_vjp:
sample_scan_chunk: ~
"""


def _jax_saved(tmp_path, cfg, name):
    path = tmp_path / name
    j_config.save_model_yaml(cfg, path)
    return path.read_text()


@pytest.fixture
def texts(tmp_path):
    return {
        "model.yaml": (ROOT / "model.yaml").read_text(),
        "model_euler.yaml": (ROOT / "model_euler.yaml").read_text(),
        "tiny": TINY,
        "jax saved default": _jax_saved(tmp_path, j_config.ModelConfig(),
                                        "a.yaml"),
        "jax saved euler": _jax_saved(
            tmp_path, j_config.load_model_yaml(ROOT / "model_euler.yaml"),
            "b.yaml"),
        "jax saved tiny": _jax_saved(
            tmp_path, j_config.ModelConfig(unet_dim=8, dim_mults=(1, 2),
                                           learning_rate=1e-5,
                                           temporal_s_tile=128,
                                           temporal_vjp="saved"), "c.yaml"),
    }


def test_reader_equals_safe_load(texts):
    for name, text in texts.items():
        want = yaml.safe_load(text)
        got = config.load_yaml(text, name)
        assert got == want, name
        assert [type(v) for v in got.values()] == \
            [type(v) for v in want.values()], name


def test_model_yamls_and_jax_snapshots_load(tmp_path):
    assert config.load_model_yaml(ROOT / "model.yaml") == config.ModelConfig()
    euler = config.load_model_yaml(ROOT / "model_euler.yaml")
    assert euler.reference_frame == "eulerian"
    assert euler.selected_channels == (0, 1, 2)
    j_euler = j_config.load_model_yaml(ROOT / "model_euler.yaml")
    # the tiny JAX snapshot of the `texts` fixture: temporal_s_tile 128
    # (and remat_blocks) round-trip since they are ported
    j_tiny = j_config.ModelConfig(unet_dim=8, dim_mults=(1, 2),
                                  learning_rate=1e-5, temporal_s_tile=128,
                                  temporal_vjp="saved", remat_blocks=True)
    for j_cfg in (j_euler, j_tiny):
        path = tmp_path / "snap.yaml"
        j_config.save_model_yaml(j_cfg, path)
        got = config.load_model_yaml(path)
        for f in dataclasses.fields(got):
            assert getattr(got, f.name) == getattr(j_cfg, f.name), f.name
        back = tmp_path / "back.yaml"
        config.save_model_yaml(got, back)
        assert config.load_model_yaml(back) == got
    assert got.temporal_s_tile == 128 and got.remat_blocks


def test_writer_reads_back_through_safe_load(tmp_path):
    for cfg in (config.ModelConfig(),
                config.load_model_yaml(ROOT / "model_euler.yaml"),
                config.ModelConfig(learning_rate=1e-5, temporal_vjp="saved",
                                   use_fused_linear_block=False)):
        path = tmp_path / "cfg.yaml"
        config.save_model_yaml(cfg, path)
        raw = yaml.safe_load(path.read_text())
        assert raw == config.load_yaml(path.read_text())
        assert config.load_model_yaml(path) == cfg
        # the JAX package reads the port's snapshot too
        j_cfg = j_config.load_model_yaml(path)
        for f in dataclasses.fields(cfg):
            assert getattr(j_cfg, f.name) == getattr(cfg, f.name), f.name


def test_snapshot_is_written_once(tmp_path):
    run = tmp_path / "runs" / "r"
    path = config.snapshot_run_config(config.ModelConfig(unet_dim=8), run)
    assert path == run / "model" / "model.yaml"
    assert (run / "training").is_dir()
    config.snapshot_run_config(config.ModelConfig(), run)
    assert config.load_model_yaml(path).unet_dim == 8


_SCALAR = st.one_of(
    st.none(), st.booleans(), st.integers(-10 ** 20, 10 ** 20),
    st.floats(allow_nan=False),
    st.text(st.characters(blacklist_categories=("Cs", "Cc")), max_size=20))
_MAPPING = st.dictionaries(
    st.from_regex(r"[a-z_][a-z0-9_]{0,12}", fullmatch=True),
    st.one_of(_SCALAR, st.lists(_SCALAR, max_size=5)), max_size=12)


@settings(max_examples=80, deadline=None, derandomize=True)
@given(_MAPPING)
def test_dump_then_read_is_safe_load(d):
    text = config.dump_yaml(d)
    assert yaml.safe_load(text) == (d or None)
    assert config.load_yaml(text) == d


def test_special_floats():
    got = config.load_yaml(config.dump_yaml(
        {"a": math.nan, "b": math.inf, "c": -math.inf, "d": 1e-05,
         "e": 1e16}))
    want = yaml.safe_load(config.dump_yaml(
        {"a": math.nan, "b": math.inf, "c": -math.inf, "d": 1e-05,
         "e": 1e16}))
    assert math.isnan(got["a"]) and math.isnan(want["a"])
    assert [got[k] for k in "bcde"] == [want[k] for k in "bcde"] \
        == [math.inf, -math.inf, 1e-05, 1e16]
    # YAML 1.1: an exponent without a dot is a string, as PyYAML reads it
    assert config.load_yaml("x: 1e-4") == yaml.safe_load("x: 1e-4") \
        == {"x": "1e-4"}


@pytest.mark.parametrize("text", [
    "a:\n  b: 1\n",              # nested mapping
    "a: yes\n",                  # YAML 1.1 boolean
    "a: 0x10\n",                 # hex int
    "a: 017\n",                  # octal int
    "a: 1:30\n",                 # sexagesimal
    "a: &x 1\n",                 # anchor
    "a: {b: 1}\n",               # flow mapping
    "a: [1, [2]]\n",             # nested flow list
    "a: |\n  text\n",            # block scalar
    "---\na: 1\n",               # document marker
    "a: 1\na: 2\n",              # duplicate key
    "- 1\n",                     # list item outside a list
    "a:\n- - 1\n",               # nested block list
    "a:\n- b: 1\n",              # mapping in a list
    "a: 'x\n",                   # open quote
    'a: "x\\ty"\n',              # escape sequence
    "\ta: 1\n",                  # tab indentation
    "a b: 1\n",                  # key with a space
])
def test_unsupported_yaml_raises(text):
    with pytest.raises(ValueError):
        config.load_yaml(text)


def test_unknown_keys_raise(tmp_path):
    path = tmp_path / "bad.yaml"
    path.write_text("unet_dim: 8\nresnet_groups: 8\n")
    with pytest.raises(ValueError, match="resnet_groups"):
        config.load_model_yaml(path)
