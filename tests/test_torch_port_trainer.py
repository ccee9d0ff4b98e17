"""PyTorch port, the GIF-folder Trainer on the CPU: the validation loss
against the JAX Trainer's (converted weights, the JAX draws handed over;
the flagship and the conditioning ablation's GRU arm),
checkpoints both ways with the JAX package (the optax state of adam and of
clip + adam), resume (4 steps equal 2 steps and a resume of 2, bit for
bit), the refusal of a cache-restored step, and a single final save.

Tolerances: the validation loss rtol 1e-5 (float32 on both sides, another
summation order); an Adam update from a restored optax state rtol 1e-6;
everything the port writes and reads back bit-equal."""

import dataclasses
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from _torch_port_jax_run import tiny_config
from videometamaterials_tpu.data.synthetic import make_consistent_dataset
from videometamaterials_tpu.diffusion import GaussianDiffusion as JDiffusion
from videometamaterials_tpu.models import UNet3D as JUNet3D
from videometamaterials_tpu.parallel.mesh import make_mesh
from videometamaterials_tpu.training import Trainer as JTrainer
from videometamaterials_tpu.training import checkpoint as j_ckpt
from videometamaterials_tpu.config import TrainerConfig as JTrainerConfig
from videometamaterials_tpu_torch import config as t_config
from videometamaterials_tpu_torch.convert import (
    flax_to_torch_state_dict,
    torch_to_flax_tree,
)
from videometamaterials_tpu_torch.diffusion.gaussian import GaussianDiffusion
from videometamaterials_tpu_torch.models.unet3d import build_unet
from videometamaterials_tpu_torch.training import checkpoint as ckpt
from videometamaterials_tpu_torch.training.optim import (
    clip_by_global_norm_,
    make_adam,
)
from videometamaterials_tpu_torch.training.trainer import Trainer

torch.set_num_threads(1)
SEED = 3


def _port_cfg():
    j = tiny_config()
    return t_config.ModelConfig(**{
        f.name: getattr(j, f.name)
        for f in dataclasses.fields(t_config.ModelConfig)})


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    make_consistent_dataset(root / "training", num_samples=5, image_size=16,
                            num_frames=11, seed=0)
    make_consistent_dataset(root / "validation", num_samples=3,
                            image_size=16, num_frames=11, seed=1)
    return root


def _port_trainer(data, results, **tkw):
    cfg = _port_cfg()
    model = build_unet(cfg, device="cpu", seed=0)
    tcfg = t_config.TrainerConfig(seed=SEED, test_batch_size=4, **tkw)
    return Trainer(GaussianDiffusion.from_config(model, cfg, "cpu"), cfg,
                   tcfg, data / "training", data / "validation",
                   results_folder=results)


@pytest.fixture(scope="module")
def jax_trainer(data, tmp_path_factory):
    cfg = tiny_config()
    model = JUNet3D.from_config(cfg)
    return JTrainer(JDiffusion.from_config(model, cfg), cfg,
                    JTrainerConfig(seed=SEED, test_batch_size=4, log=False),
                    data / "training", data / "validation",
                    results_folder=tmp_path_factory.mktemp("jax_run"),
                    mesh=make_mesh(jax.devices()[:1]))


def _jax_validation_draws(jt):
    """The t, noise and null mask the JAX validation_loss draws for each
    of its batches (its key splits, written out)."""
    rng = jax.random.PRNGKey(jt.tcfg.seed + 1234)
    n_val = len(jt.ds_test)
    bs = min(jt.test_batch, n_val)
    draws = []
    for lo in range(0, n_val, bs):
        v, _ = jt.ds_test.get_batch(np.arange(lo, min(lo + bs, n_val)))
        rng, sub = jax.random.split(rng)
        t_rng, loss_rng = jax.random.split(sub)
        t = jax.random.randint(t_rng, (len(v),), 0,
                               jt.diffusion.timesteps)
        noise_rng, mask_rng, _ = jax.random.split(loss_rng, 3)
        noise = jax.random.normal(noise_rng, v.shape, jnp.float32)
        mask = jax.random.bernoulli(mask_rng, jt.tcfg.null_cond_prob,
                                    (len(v),))
        draws.append({"t": torch.tensor(np.asarray(t), dtype=torch.long),
                      "noise": torch.tensor(np.asarray(noise)),
                      "null_cond_mask": torch.tensor(np.asarray(mask))})
    return draws


def test_validation_loss_equals_jax(jax_trainer, data, tmp_path):
    jt = jax_trainer
    pt = _port_trainer(data, tmp_path)
    pt.state.model.load_state_dict(flax_to_torch_state_dict(
        jax.device_get(jt.state.params)), strict=True)
    want = jt.validation_loss()
    got = pt.validation_loss(draws=_jax_validation_draws(jt))
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # without handed draws: its own seeded ones, the same every call
    assert pt.validation_loss() == pt.validation_loss()


def test_port_checkpoint_loads_strictly_in_jax(jax_trainer, data, tmp_path):
    """Two steps in the port, saved; the JAX Trainer loads the step
    strictly and holds the port's parameters, Adam moments and EMA."""
    pt = _port_trainer(data, tmp_path, train_num_steps=2,
                       save_and_sample_every=10, num_samples=0)
    pt.train()
    jt = jax_trainer
    results = jt.results_folder
    shutil.copytree(tmp_path / "model", results / "model",
                    dirs_exist_ok=True)
    jt.load(2, strict=True)
    assert int(jt.state.step) == 2
    named = dict(pt.state.model.named_parameters())
    for name, tree in (("params", jt.state.params),
                       ("ema", jt.state.ema_params)):
        got = flax_to_torch_state_dict(jax.device_get(tree))
        ref = named if name == "params" else pt.state.ema_state_dict()
        for k, v in ref.items():
            assert torch.equal(got[k], v.detach()), (name, k)
    adam = jax.device_get(jt.state.opt_state)[0][0]
    assert int(adam.count) == 2
    mu = flax_to_torch_state_dict(adam.mu)
    for k, p in named.items():
        # a parameter that never had a gradient (the init temporal block's
        # conditioning projections) has no torch state: optax's zeros
        want = pt.state.optimizer.state[p].get("exp_avg",
                                               torch.zeros_like(p))
        assert torch.equal(mu[k], want), k


@pytest.mark.parametrize("clip", [None, 0.5])
def test_optax_state_round_trip_and_update(clip):
    """An optax state after three updates, in flax's state-dict layout:
    the port's tree of the same torch state has its structure, and one
    more update from the restored state is optax's update."""
    cfg = _port_cfg()
    model = build_unet(cfg, device="cpu", seed=1)
    named = list(model.named_parameters())
    params = torch_to_flax_tree({n: p for n, p in named})
    chain = [optax.adam(1e-3)]
    if clip:
        chain.insert(0, optax.clip_by_global_norm(clip))
    tx = optax.chain(*chain)
    state = tx.init(params)
    rng = np.random.default_rng(0)
    grads = [jax.tree.map(lambda a: rng.normal(size=a.shape).astype(
        np.float32), params) for _ in range(4)]
    @jax.jit
    def update(g, state, p):
        upd, state = tx.update(g, state, p)
        return optax.apply_updates(p, upd), state

    p = params
    for g in grads[:3]:
        p, state = update(g, state, p)
    tree = jax.device_get(serialization.to_state_dict(state))

    opt = make_adam([q for _, q in named], 1e-3)
    restored = flax_to_torch_state_dict(jax.device_get(p))
    with torch.no_grad():
        for name, q in named:
            q.copy_(restored[name])
    assert ckpt.load_optimizer_state(tree, opt, named,
                                     clipped=clip is not None) == 3
    mine = ckpt.optimizer_state_tree(opt, named, clipped=clip is not None)
    assert jax.tree.structure(mine) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    want = flax_to_torch_state_dict(jax.device_get(
        update(grads[3], state, p)[0]))
    g4 = flax_to_torch_state_dict(grads[3])
    for name, q in named:
        q.grad = g4[name].clone()
    if clip:
        clip_by_global_norm_([q.grad for _, q in named], clip)
    opt.step()
    for name, q in named:
        np.testing.assert_allclose(q.detach().numpy(), want[name].numpy(),
                                   rtol=1e-6, atol=1e-7)


def test_resume_is_bit_equal(data, tmp_path):
    """4 steps with milestones every 2 equal 2 steps and a resume of 2:
    checkpoints, metrics and milestone GIFs; step 4 is written once."""
    a = _port_trainer(data, tmp_path / "a", train_num_steps=4,
                      save_and_sample_every=2, num_samples=1,
                      horizontal_flip=True)
    saves = []
    save = a.save
    a.save = lambda step=None: saves.append(step) or save(step)
    a.train()
    assert saves == [2, 4]
    b_dir = tmp_path / "b"
    shutil.copytree(tmp_path / "a", b_dir)
    for d in ("model/step_4", "training/step_4"):
        shutil.rmtree(b_dir / d)
    metrics = (b_dir / "metrics.jsonl").read_text().splitlines()
    (b_dir / "metrics.jsonl").write_text(
        "\n".join(metrics[:3]) + "\n")      # what the run had at step 2
    b = _port_trainer(data, b_dir, train_num_steps=4,
                      save_and_sample_every=2, num_samples=1,
                      horizontal_flip=True)
    b.train(load_model_step=2)
    for rel in ("model/step_4/checkpoint.msgpack", "model/step_4/aux.json",
                "metrics.jsonl", "training/step_4/geometries.csv",
                "training/step_4/gifs/prediction_channel_3.gif"):
        assert (tmp_path / "a" / rel).read_bytes() == \
            (b_dir / rel).read_bytes(), rel
    # the final step is saved once, also when it is no milestone
    c = _port_trainer(data, tmp_path / "c", train_num_steps=3,
                      save_and_sample_every=2, num_samples=0)
    saves.clear()
    save = c.save
    c.save = lambda step=None: saves.append(step) or save(step)
    c.train()
    assert saves == [2, 3]
    assert all(p.dtype == torch.float32 for p in c.state.model.parameters())


def test_resume_in_an_accumulation_is_bit_equal(data, tmp_path):
    """gradient_accumulate_every 2 with prob_focus_present 0.5: 4
    micro-steps with a milestone at 3, in the middle of an accumulation,
    equal 3 micro-steps and a resume of 3 (the checkpoint carries the
    MultiSteps state); a trainer without accumulation refuses that
    checkpoint, naming the state it expected."""
    kw = dict(train_num_steps=4, save_and_sample_every=3, num_samples=0,
              gradient_accumulate_every=2, prob_focus_present=0.5)
    a = _port_trainer(data, tmp_path / "a", **kw)
    a.train()
    opt = ckpt.read_checkpoint(tmp_path / "a", 3)["opt_state"]
    assert (int(opt["mini_step"]), int(opt["gradient_step"])) == (1, 1)
    b_dir = tmp_path / "b"
    shutil.copytree(tmp_path / "a", b_dir)
    shutil.rmtree(b_dir / "model" / "step_4")
    metrics = (b_dir / "metrics.jsonl").read_text().splitlines()
    (b_dir / "metrics.jsonl").write_text(
        "\n".join(metrics[:4]) + "\n")      # what the run had at step 3
    b = _port_trainer(data, b_dir, **kw)
    b.train(load_model_step=3)
    for rel in ("model/step_4/checkpoint.msgpack", "metrics.jsonl"):
        assert (tmp_path / "a" / rel).read_bytes() == \
            (b_dir / rel).read_bytes(), rel
    plain = _port_trainer(data, b_dir, train_num_steps=4)
    with pytest.raises(ValueError, match="state of adam"):
        plain.load(3)


def test_refuses_a_cache_restored_step(data, tmp_path):
    t = _port_trainer(data, tmp_path, train_num_steps=2)
    t.save(1)
    aux = tmp_path / "model" / "step_1" / "aux.json"
    aux.write_text(json.dumps({**json.loads(aux.read_text()),
                               "restored_from_cache": True}))
    with pytest.raises(ValueError, match="step 1 .*restored_from_cache"):
        t.train(load_model_step=1)


def test_validation_loss_of_the_gru_arm_equals_jax(tmp_path):
    """The conditioning ablation's GRU arm (per_frame_cond: false) through
    both Trainers: the dataset's labels are the curves' tails (50 points),
    and the validation loss on the JAX Trainer's weights and draws equals
    the JAX Trainer's (rtol 1e-5, as above)."""
    root = tmp_path / "data"
    make_consistent_dataset(root / "training", num_samples=5, image_size=16,
                            num_frames=11, seed=0)
    make_consistent_dataset(root / "validation", num_samples=3,
                            image_size=16, num_frames=11, seed=1)
    j_cfg = tiny_config(per_frame_cond=False, unet_cond_att_GRU=True)
    jt = JTrainer(JDiffusion.from_config(JUNet3D.from_config(j_cfg), j_cfg),
                  j_cfg, JTrainerConfig(seed=SEED, test_batch_size=4,
                                        log=False),
                  root / "training", root / "validation",
                  results_folder=tmp_path / "jax",
                  mesh=make_mesh(jax.devices()[:1]))
    cfg = t_config.ModelConfig(**{
        f.name: getattr(j_cfg, f.name)
        for f in dataclasses.fields(t_config.ModelConfig)})
    pt = Trainer(GaussianDiffusion.from_config(
        build_unet(cfg, device="cpu", seed=0), cfg, "cpu"), cfg,
        t_config.TrainerConfig(seed=SEED, test_batch_size=4),
        root / "training", root / "validation",
        results_folder=tmp_path / "port")
    assert pt.ds.labels.shape[1] == 50
    np.testing.assert_allclose(pt.ds.labels, jt.ds.labels, rtol=1e-6)
    pt.state.model.load_state_dict(flax_to_torch_state_dict(
        jax.device_get(jt.state.params)), strict=True)
    got = pt.validation_loss(draws=_jax_validation_draws(jt))
    np.testing.assert_allclose(got, jt.validation_loss(), rtol=1e-5)
