"""PyTorch port, checkpoints on the CPU: the stdlib msgpack reader and
writer against flax.serialization (the committed ckpt_cache trees, trees
the port writes, chunked leaves, a JAX trainer checkpoint with its optax
state), the bf16 rounding against jnp, the weight bridge both ways, and
the port's checkpoint module against the JAX one."""

import json
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization
from hypothesis import given, settings
from hypothesis import strategies as st

from _torch_port_jax_run import tiny_config, write_run
from videometamaterials_tpu.training import checkpoint as j_ckpt
from videometamaterials_tpu_torch.config import ModelConfig
from videometamaterials_tpu_torch.convert import (
    flax_to_torch_state_dict,
    load_msgpack_tree,
    torch_to_flax_tree,
)
from videometamaterials_tpu_torch.models.unet3d import build_unet
from videometamaterials_tpu_torch.training import checkpoint as ckpt
from videometamaterials_tpu_torch.training import msgpack_io
from videometamaterials_tpu_torch.utils import inference_cast_keys

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
TREES = sorted((ROOT / "ckpt_cache").glob("*.msgpack"))


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def _assert_same_tree(port, ref):
    """Equal structure, values and dtypes (the port's bf16 leaves against
    flax's bfloat16 arrays by value)."""
    port, ref = dict(_leaves(port)), dict(_leaves(ref))
    assert port.keys() == ref.keys()
    for k, r in ref.items():
        p = port[k]
        r = np.asarray(r)
        if r.dtype == jnp.bfloat16:
            assert isinstance(p, msgpack_io.BFloat16Array), k
            np.testing.assert_array_equal(
                np.asarray(p), r.astype(np.float32), err_msg=str(k))
        else:
            assert np.asarray(p).dtype == r.dtype, k
            np.testing.assert_array_equal(np.asarray(p), r, err_msg=str(k))


def test_four_committed_trees_exist():
    assert [p.name for p in TREES] == [
        "demo4x_step_8000.msgpack", "demo_euler_step_12000.msgpack",
        "demo_euler_step_20000.msgpack", "demo_euler_step_6000.msgpack"]


@pytest.mark.parametrize("path", TREES, ids=lambda p: p.stem)
def test_committed_tree_reads_as_flax_does(path):
    """The port's reader, then the bridge, gives the flax route's state
    dict bit for bit; the bridge back and the writer give the file's
    bytes (bf16 leaves where the inference cast puts them)."""
    data = path.read_bytes()
    tree = msgpack_io.msgpack_restore(data)
    ref = serialization.msgpack_restore(data)
    assert int(tree["step"]) == int(ref["step"])
    ours = flax_to_torch_state_dict(tree["ema_params"])
    want = flax_to_torch_state_dict(jax.tree.map(
        lambda a: np.asarray(a, np.float32), ref["ema_params"]))
    assert ours.keys() == want.keys()
    for k in want:
        assert torch.equal(ours[k], want[k]), k
    assert msgpack_io.msgpack_serialize(tree) == data
    keys = inference_cast_keys(build_unet(ModelConfig(), device="cpu",
                                          seed=None))
    back = {"step": tree["step"],
            "ema_params": torch_to_flax_tree(ours, keys)}
    assert msgpack_io.msgpack_serialize(back) == data
    assert load_msgpack_tree(path).keys() == {"params"}


def _mixed_tree(rng):
    f32 = rng.standard_normal((3, 5)).astype(np.float32)
    return f32, {
        "step": np.asarray(7, np.int32),
        "params": {"w": f32, "b": rng.standard_normal(4).astype(np.float32),
                   "bf": msgpack_io.bfloat16(f32),
                   "ids": rng.integers(-5, 5, (2, 3)).astype(np.int32),
                   "mask": rng.random(6) < 0.5,
                   "scalar_f": np.float32(1.5), "scalar_i": np.int32(-3),
                   "deep": {"x": {"y": np.zeros((0, 2), np.float64)}}},
        "empty": {}, "n": 3, "big": 2 ** 40, "neg": -200, "f": 0.25,
        "flag": True, "none": None, "name": "ema",
        "long_name": "x" * 40, "c": complex(1.0, -2.0)}


def test_written_tree_restores_through_flax():
    rng = np.random.default_rng(0)
    f32, tree = _mixed_tree(rng)
    data = msgpack_io.msgpack_serialize(tree)
    ref = dict(tree)
    ref["params"] = dict(tree["params"], bf=jnp.asarray(f32).astype(
        jnp.bfloat16))
    assert data == serialization.msgpack_serialize(ref, in_place=True)
    restored = serialization.msgpack_restore(data)
    assert restored["params"]["bf"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(restored["params"]["bf"]).view(np.uint16),
        np.asarray(jnp.asarray(f32).astype(jnp.bfloat16)).view(np.uint16))
    for key in ("scalar_f", "scalar_i"):
        assert restored["params"][key].dtype == tree["params"][key].dtype
    assert restored["empty"] == {} and restored["c"] == complex(1.0, -2.0)
    back = msgpack_io.msgpack_restore(data)
    _assert_same_tree(back, restored)
    assert msgpack_io.msgpack_serialize(back) == data


def test_bfloat16_rounds_as_jnp():
    rng = np.random.default_rng(1)
    x = np.concatenate([
        rng.standard_normal(4000).astype(np.float32) * 10.0 ** rng.integers(
            -40, 38, 4000),
        np.array([np.inf, -np.inf, np.nan, 0.0, -0.0, 3.4e38, -3.4e38,
                  1e-45, 1.00390625, 1.01171875, 1.0 + 2 ** -8, 65504.0],
                 np.float32)]).astype(np.float32)
    got = np.asarray(msgpack_io.bfloat16(x)).view(np.uint32) >> 16
    want = np.asarray(jnp.asarray(x).astype(jnp.bfloat16)).view(np.uint16)
    nan = np.isnan(x)
    np.testing.assert_array_equal(got[~nan], want[~nan])
    assert np.isnan(np.asarray(msgpack_io.bfloat16(x))[nan]).all()


def test_computed_bfloat16_leaf_is_written_rounded_as_jnp():
    """A leaf computed from a bf16 leaf keeps the subclass but holds
    values that are not bf16 (an EMA update): the writer rounds them to
    nearest even, as jnp's cast does, and does not truncate them."""
    rng = np.random.default_rng(3)
    w = msgpack_io.bfloat16(rng.standard_normal(4096).astype(np.float32))
    ema = 0.995 * w + 0.005 * rng.standard_normal(4096).astype(np.float32)
    assert isinstance(ema, msgpack_io.BFloat16Array)
    restored = serialization.msgpack_restore(
        msgpack_io.msgpack_serialize({"ema": ema}))["ema"]
    want = jnp.asarray(np.asarray(ema, np.float32)).astype(jnp.bfloat16)
    np.testing.assert_array_equal(np.asarray(restored).view(np.uint16),
                                  np.asarray(want).view(np.uint16))


def test_chunked_leaves_both_ways(monkeypatch):
    rng = np.random.default_rng(2)
    tree = {"a": rng.standard_normal((7, 30)).astype(np.float32),
            "nested": {"b": rng.integers(0, 9, 500).astype(np.int32)},
            "small": np.ones(3, np.float32)}
    bf = rng.standard_normal(400).astype(np.float32)
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 300)
    monkeypatch.setattr(msgpack_io, "MAX_CHUNK_SIZE", 300)
    flax_tree = dict(tree, bf=jnp.asarray(bf).astype(jnp.bfloat16))
    data = serialization.msgpack_serialize(flax_tree, in_place=True)
    assert b"__msgpack_chunked_array__" in data
    got = msgpack_io.msgpack_restore(data)
    _assert_same_tree(got, serialization.msgpack_restore(data))
    ours = msgpack_io.msgpack_serialize(dict(tree,
                                             bf=msgpack_io.bfloat16(bf)))
    assert ours == data


_SCALARS = st.one_of(
    st.none(), st.booleans(), st.integers(-2 ** 63, 2 ** 64 - 1),
    st.floats(allow_nan=False), st.text(max_size=40),
    st.binary(max_size=300))
_TREES = st.recursive(
    _SCALARS, lambda kids: st.dictionaries(st.text(max_size=20), kids,
                                           max_size=20)
    | st.lists(kids, max_size=20), max_leaves=60)


@settings(max_examples=60, deadline=None, derandomize=True)
@given(_TREES)
def test_plain_msgpack_values_match_flax_bytes(tree):
    data = serialization.msgpack_serialize({"t": tree}, in_place=True)
    assert msgpack_io.msgpack_serialize({"t": tree}) == data
    assert msgpack_io.msgpack_restore(data) == serialization.msgpack_restore(
        data)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    run_dir = tmp_path_factory.mktemp("jax_run") / "runs" / "tiny"
    model, ema, payload = write_run(run_dir, 3, tiny_config())
    return run_dir, ema, payload


def test_trainer_checkpoint_with_optax_state(jax_run):
    """A full JAX trainer checkpoint (step, params, Adam state, EMA) reads
    as flax reads it; the port's strict restore gives its EMA."""
    run_dir, ema, payload = jax_run
    data = (run_dir / "model" / "step_3" / "checkpoint.msgpack").read_bytes()
    got = msgpack_io.msgpack_restore(data)
    ref = serialization.msgpack_restore(data)
    _assert_same_tree(got, ref)
    assert set(got["opt_state"]) == {"0", "1"}
    template = torch_to_flax_tree(flax_to_torch_state_dict(ema))
    out, aux = ckpt.load_checkpoint(run_dir, 3, {"params": template,
                                                 "ema_params": template})
    assert aux == {"step": 3} and int(out["step"]) == 3
    _assert_same_tree(out["ema_params"], jax.device_get(ema))
    _assert_same_tree(out["opt_state"], ref["opt_state"])


def test_bridge_round_trip_is_the_identity(jax_run):
    _, ema, _ = jax_run
    state = flax_to_torch_state_dict(ema)
    tree = torch_to_flax_tree(state)
    _assert_same_tree(tree, jax.device_get(ema))
    back = flax_to_torch_state_dict(tree)
    assert all(torch.equal(back[k], state[k]) for k in state)
    with pytest.raises(KeyError):
        torch_to_flax_tree({**state, "extra.weight": torch.zeros(1)})


def _graft_messages(fn, *args):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = fn(*args)
    return out, sorted(str(w.message) for w in caught)


def test_tolerant_and_strict_restore_match_jax(jax_run, tmp_path):
    """A checkpoint with a leaf of another shape, one missing and one
    extra: the tolerant restore grafts and warns as the JAX one does; the
    strict one raises as the JAX one does."""
    _, ema, _ = jax_run
    raw = jax.device_get(ema)
    bad = jax.tree.map(np.asarray, raw)
    p = bad["params"]
    p["init_conv_bias"] = np.zeros(3, np.float32)
    del p["final_conv_bias"]
    p["surplus"] = np.ones(2, np.float32)
    j_ckpt.save_checkpoint(tmp_path, 5, {"step": np.int32(5), "params": bad,
                                         "ema_params": bad})
    template = jax.tree.map(np.asarray, raw)
    (port_out, _), port_warn = _graft_messages(
        ckpt.load_checkpoint, tmp_path, 5,
        {"params": template, "ema_params": template}, False)
    (j_out, _), j_warn = _graft_messages(
        j_ckpt.load_checkpoint, tmp_path, 5,
        {"params": template, "ema_params": template}, False)
    assert port_warn == j_warn and len(port_warn) == 6
    _assert_same_tree(port_out["ema_params"], j_out["ema_params"])
    with pytest.raises(ValueError):
        ckpt.load_checkpoint(tmp_path, 5, {"ema_params": template})
    with pytest.raises(ValueError):
        j_ckpt.load_checkpoint(tmp_path, 5, {"ema_params": template})


def test_save_prune_latest_and_cache_restore(tmp_path):
    rng = np.random.default_rng(3)
    tree = {"params": {"w": rng.standard_normal(3).astype(np.float32)}}
    for step in (1, 2, 3):
        ckpt.save_checkpoint(tmp_path / "run", step, {
            "step": np.asarray(step, np.int32), "params": tree,
            "ema_params": tree}, aux={"step": step}, keep_last=2)
    assert ckpt.latest_checkpoint_step(tmp_path / "run") == 3
    assert sorted(p.name for p in (tmp_path / "run" / "model").iterdir()) \
        == ["step_2", "step_3"]
    assert ckpt.latest_checkpoint_step(tmp_path / "none") is None
    with pytest.raises(FileNotFoundError):
        ckpt.load_checkpoint(tmp_path / "run", 1, {"params": tree})
    with pytest.raises(NotImplementedError, match="orbax"):
        ckpt.save_checkpoint(tmp_path / "run", 4, {}, backend="orbax")

    cache = tmp_path / "cache" / "demo_step_9.msgpack"
    cache.parent.mkdir()
    bf = {"params": {"w": msgpack_io.bfloat16(tree["params"]["w"])}}
    msgpack_io.write_msgpack(cache, {"step": np.asarray(9, np.int32),
                                     "ema_params": bf})
    cache.with_suffix(".aux.json").write_text(json.dumps(
        {"labels_scaling": {"strategy": "none"}, "step": 9}))
    d = ckpt.restore_from_cache(cache, tmp_path / "restored", 9)
    aux = json.loads((d / "aux.json").read_text())
    assert aux == {"labels_scaling": {"strategy": "none"}, "step": 9,
                   "restored_from_cache": True}
    ref = serialization.msgpack_restore(
        (d / "checkpoint.msgpack").read_bytes())
    assert "opt_state" not in ref
    for section in ("params", "ema_params"):
        assert ref[section]["params"]["w"].dtype == jnp.bfloat16
        np.testing.assert_array_equal(
            np.asarray(ref[section]["params"]["w"], np.float32),
            np.asarray(bf["params"]["w"]))
