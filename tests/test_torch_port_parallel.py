"""PyTorch port, data parallelism on the CPU (gloo): parallel/mesh.py's
helpers against the JAX functions, the sampler's per-process stripes
against the JAX sampler, the no-op initialisation and a step without a
group calling no collective; two ranks' train steps (the state identical
on both, equal to one process on the global batch and to the JAX train
step under the same draws); the GIF-folder Trainer on two ranks (one
metrics stream, one checkpoint reloaded on both, sampling and the
validation loss identical on both and equal to one process's); the
profile_dir trace; and dryrun_multichip(2).

Every multi-process case runs at most two worker processes
(tests/_torch_port_parallel_worker.py), one thread each, under a timeout.

Tolerances: losses of two ranks against one process rtol 1e-5 (another
summation order of the gradient and of the loss); against JAX, and the
parameters after three Adam steps, the bounds of
tests/test_torch_port_train.py::test_three_train_steps_match_jax; sampled
videos atol 1e-5 and the validation loss rtol 1e-6 against one process
(float32, batches of another size)."""

import dataclasses
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_port_jax_run import init_params, tiny_config
from _torch_port_parallel_worker import (
    TRAINER_TCFG,
    digest,
    state_digest,
    three_curves,
)
from videometamaterials_tpu.data.loader import (
    InfiniteBatchSampler as JSampler,
)
from videometamaterials_tpu.diffusion import GaussianDiffusion as JDiffusion
from videometamaterials_tpu.parallel.mesh import (
    pad_to_multiple as j_pad_to_multiple,
)
from videometamaterials_tpu_torch import config as t_config
from videometamaterials_tpu_torch import parallel
from videometamaterials_tpu_torch.convert import flax_to_torch_state_dict
from videometamaterials_tpu_torch.data.loader import InfiniteBatchSampler
from videometamaterials_tpu_torch.data.synthetic import (
    make_synthetic_dataset,
)
from videometamaterials_tpu_torch.diffusion.gaussian import GaussianDiffusion
from videometamaterials_tpu_torch.graft_entry import (
    DRYRUN_CONFIG,
    dryrun_multichip,
)
from videometamaterials_tpu_torch.models.unet3d import build_unet
from videometamaterials_tpu_torch.training.trainer import (
    _MILESTONE_SAMPLES,
    _VALIDATION,
    Trainer,
    TrainState,
    sample_videos,
    seeded_generator,
    train_step,
)

torch.set_num_threads(1)
TESTS = Path(__file__).resolve().parent
REPO = TESTS.parent
WORKER = TESTS / "_torch_port_parallel_worker.py"
TIMEOUT = 300
GLOBAL_BATCH, NULL_P = 4, 0.5
STEP_TCFG = t_config.TrainerConfig(ema_start_step=1, ema_update_every=2,
                                   ema_decay=0.9, null_cond_prob=NULL_P)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(mode: str, out: Path) -> list:
    """The two ranks of a gloo group running the worker's `mode`."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO), str(TESTS), env.get("PYTHONPATH", "")])
    env["CUDA_VISIBLE_DEVICES"] = ""
    init = f"tcp://127.0.0.1:{_free_port()}"
    return [subprocess.Popen(
        [sys.executable, str(WORKER), mode, init, str(r), "2", str(out)],
        env=env, cwd=out, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]


def _wait(procs) -> None:
    try:
        outs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-3000:]}"


# ------------------------------------------------------------- helpers


@pytest.mark.parametrize("n,world", [(1, 1), (3, 2), (4, 2), (5, 4),
                                     (2, 3)])
def test_pad_and_local_rows_match_jax(n, world):
    x = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    want, want_n = j_pad_to_multiple(x, world)
    got, got_n = parallel.pad_to_multiple(x, world)
    assert got_n == want_n == n
    np.testing.assert_array_equal(got, want)
    # shard_cond_batch's even split: rank r holds rows r*per .. of the pad
    per = len(want) // world
    for r in range(world):
        rows, length = parallel.local_rows(x, world, r)
        assert length == n
        np.testing.assert_array_equal(rows, want[r * per:(r + 1) * per])


@pytest.mark.parametrize("kw", [
    dict(num_examples=10, batch_size=2, seed=0, process_index=0,
         process_count=2),
    dict(num_examples=10, batch_size=2, seed=0, process_index=1,
         process_count=2),
    # the last process takes the remainder of its stripe
    dict(num_examples=11, batch_size=2, seed=5, process_index=2,
         process_count=3),
    # per == 0: every process takes the whole order
    dict(num_examples=3, batch_size=2, seed=1, process_index=3,
         process_count=4),
    # a stripe shorter than a batch: drawn with replacement
    dict(num_examples=5, batch_size=4, seed=2, process_index=1,
         process_count=2),
    # fewer examples than a batch
    dict(num_examples=3, batch_size=4, seed=4, process_index=0,
         process_count=2),
], ids=["p0of2", "p1of2", "remainder", "per0", "short_stripe", "n_lt_b"])
def test_sampler_stripes_match_jax(kw):
    ours, ref = iter(InfiniteBatchSampler(**kw)), iter(JSampler(**kw))
    for i in range(12):
        np.testing.assert_array_equal(next(ours), next(ref),
                                      err_msg=f"batch {i}")


def test_initialize_distributed_is_a_noop_without_a_launcher(monkeypatch):
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT", "SLURM_NTASKS", "SLURM_PROCID"):
        monkeypatch.delenv(var, raising=False)
    assert parallel.initialize_distributed() is False
    # a one-task SLURM allocation is one process too
    monkeypatch.setenv("SLURM_NTASKS", "1")
    monkeypatch.setenv("SLURM_PROCID", "0")
    assert parallel.initialize_distributed() is False
    assert not parallel.active()
    assert (parallel.world_size(), parallel.rank()) == (1, 0)


def test_no_collective_without_a_group(monkeypatch):
    """Without a process group a train step and a sampling call run
    today's code: no collective is called."""
    def refuse(*a, **kw):
        raise AssertionError("a collective was called")

    for name in ("all_reduce", "all_gather", "barrier", "broadcast"):
        monkeypatch.setattr(torch.distributed, name, refuse)
    cfg = DRYRUN_CONFIG
    model = build_unet(cfg, device="cpu", seed=0)
    diffusion = GaussianDiffusion.from_config(model, cfg, "cpu")
    state = TrainState.create(model, cfg.learning_rate)
    videos = torch.rand((2, *diffusion.video_shape(2)[1:]),
                        generator=torch.Generator().manual_seed(0))
    loss = train_step(state, diffusion, videos, torch.zeros(2, 3),
                      STEP_TCFG, fused_in_training=False,
                      generator=torch.Generator().manual_seed(1))
    assert torch.isfinite(loss)
    out = sample_videos(diffusion, three_curves(cfg), 5.0, chunk=2)
    assert out.shape == (3, *diffusion.video_shape(1)[1:])


# ------------------------------------------------- train steps, two ranks


def _port_cfg():
    j = tiny_config()
    return t_config.ModelConfig(**{
        f.name: getattr(j, f.name)
        for f in dataclasses.fields(t_config.ModelConfig)})


def _jax_draws(rng, shape, timesteps):
    """The t, noise and null mask GaussianDiffusion.loss draws from rng
    (videometamaterials_tpu/diffusion/gaussian.py:491-539)."""
    t_rng, loss_rng = jax.random.split(rng)
    t = jax.random.randint(t_rng, (shape[0],), 0, timesteps)
    noise_rng, mask_rng, _ = jax.random.split(loss_rng, 3)
    noise = jax.random.normal(noise_rng, shape)
    mask = jax.random.bernoulli(mask_rng, NULL_P, (shape[0],))
    return {"t": torch.tensor(np.asarray(t), dtype=torch.long),
            "noise": torch.tensor(np.asarray(noise)),
            "null_cond_mask": torch.tensor(np.asarray(mask))}


@pytest.fixture(scope="module")
def dp_steps(tmp_path_factory):
    """Three train steps on a global batch of 4: two gloo ranks of 2 rows,
    one process on the 4 rows, and the JAX train step, all under the
    same global draws from the same weights."""
    out = tmp_path_factory.mktemp("dp_steps")
    j_cfg = tiny_config()
    cfg = _port_cfg()
    j_model, params = init_params(j_cfg)
    rng = np.random.default_rng(0)
    videos = rng.uniform(0, 1, (GLOBAL_BATCH, j_cfg.num_frames,
                                j_cfg.image_size, j_cfg.image_size,
                                j_cfg.channels)).astype(np.float32)
    labels = rng.normal(size=(GLOBAL_BATCH, j_cfg.num_frames)).astype(
        np.float32)
    keys = [jax.random.fold_in(jax.random.PRNGKey(5), s) for s in range(3)]
    draws = [_jax_draws(k, videos.shape, j_cfg.train_timesteps)
             for k in keys]
    weights = flax_to_torch_state_dict(params)
    torch.save({"cfg": cfg, "tcfg": STEP_TCFG, "weights": weights,
                "videos": torch.tensor(videos),
                "labels": torch.tensor(labels), "draws": draws},
               out / "inputs.pt")
    procs = _start("steps", out)
    try:
        # meanwhile: one process on the global batch ...
        model = build_unet(cfg, device="cpu", seed=None)
        model.load_state_dict(weights, strict=True)
        diffusion = GaussianDiffusion.from_config(model, cfg, "cpu")
        state = TrainState.create(model, cfg.learning_rate)
        one = [float(train_step(state, diffusion, torch.tensor(videos),
                                torch.tensor(labels), STEP_TCFG,
                                fused_in_training=False, **d))
               for d in draws]
        one_params = {k: v.detach() for k, v in model.named_parameters()}
        # ... and the JAX train step (trainer.py:222-234) on it
        j_diff = JDiffusion.from_config(j_model, j_cfg)
        tx = optax.adam(j_cfg.learning_rate)
        jv, jl = jnp.asarray(videos), jnp.asarray(labels)

        @jax.jit
        def j_step(p, opt_state, key):
            loss, g = jax.value_and_grad(lambda q: j_diff.loss(
                q, key, jv, jl, null_cond_prob=NULL_P))(p)
            updates, opt_state = tx.update(g, opt_state, p)
            return optax.apply_updates(p, updates), opt_state, loss

        p, opt_state, jax_losses = params, tx.init(params), []
        for k in keys:
            p, opt_state, loss = j_step(p, opt_state, k)
            jax_losses.append(float(loss))
    finally:
        _wait(procs)
    ranks = [torch.load(out / f"rank{r}.pt") for r in range(2)]
    return {"ranks": ranks, "one": one, "one_params": one_params,
            "jax": jax_losses, "jax_params": flax_to_torch_state_dict(p),
            "lr": cfg.learning_rate}


def _within_adam_bound(got: dict, want: dict, lr: float, steps: int = 3):
    """test_torch_port_train.py:386-402: every element within 2 sqrt(t) lr
    of the other trajectory, at most 1% beyond 0.1 lr."""
    n_far = n_all = 0
    for k, v in got.items():
        err = (v - want[k]).abs()
        assert err.max() <= 2 * steps ** 0.5 * lr, k
        n_far += int((err > 0.1 * lr).sum())
        n_all += err.numel()
    assert n_far <= 0.01 * n_all, (n_far, n_all)


def test_two_ranks_hold_the_same_state(dp_steps):
    a, b = dp_steps["ranks"]
    assert a["digest"] == b["digest"]
    assert a["losses"] == b["losses"]


def test_two_ranks_equal_one_process_on_the_global_batch(dp_steps):
    got = dp_steps["ranks"][0]
    np.testing.assert_allclose(got["losses"], dp_steps["one"], rtol=1e-5)
    _within_adam_bound(got["params"], dp_steps["one_params"],
                       dp_steps["lr"])


def test_two_ranks_equal_the_jax_train_step(dp_steps):
    got = dp_steps["ranks"][0]
    np.testing.assert_allclose(got["losses"], dp_steps["jax"], rtol=1e-4)
    _within_adam_bound(got["params"], dp_steps["jax_params"], dp_steps["lr"])


# ------------------------------------------------- the Trainer, two ranks


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """6 training and 3 validation videos (tests/test_multihost.py:61-62)
    at the dry run's size."""
    root = tmp_path_factory.mktemp("dp_trainer")
    cfg = DRYRUN_CONFIG
    make_synthetic_dataset(root / "data" / "train", 6, cfg.image_size,
                           cfg.num_frames, seed=0)
    make_synthetic_dataset(root / "data" / "val", 3, cfg.image_size,
                           cfg.num_frames, seed=1)
    return root


@pytest.fixture(scope="module")
def dp_trainer(data):
    _wait(_start("trainer", data))
    ranks = [json.loads((data / f"rank{r}.json").read_text())
             for r in range(2)]
    videos = [np.load(data / f"videos{r}.npy") for r in range(2)]
    return ranks, videos


def _world1_trainer(data) -> Trainer:
    """One process on the checkpoint the two ranks wrote."""
    cfg = DRYRUN_CONFIG
    model = build_unet(cfg, device="cpu", seed=0)
    tr = Trainer(GaussianDiffusion.from_config(model, cfg, "cpu"), cfg,
                 TRAINER_TCFG, data / "data" / "train", data / "data" / "val",
                 results_folder=data / "run")
    tr.load(3)
    return tr


def test_trainer_two_ranks_one_stream_one_checkpoint(dp_trainer, data):
    ranks, _ = dp_trainer
    assert ranks[0]["digest"] == ranks[1]["digest"]
    # rank 0 wrote the checkpoint once; both reloaded it bit for bit
    assert [r["saves"] for r in ranks] == [1, 0]
    assert sorted(p.name for p in (data / "run" / "model").iterdir()) == [
        "step_3"]
    for r in ranks:
        assert r["reload_ok"] and r["reloaded_digest"] == r["digest"]
    lines = (data / "run" / "metrics.jsonl").read_text().splitlines()
    steps = [json.loads(ln)["step"] for ln in lines
             if "training loss" in ln]
    assert steps == [0, 1, 2]


def test_trainer_two_ranks_sample_the_same_videos(dp_trainer, data):
    ranks, videos = dp_trainer
    assert ranks[0]["videos"] == ranks[1]["videos"]
    np.testing.assert_array_equal(videos[0], videos[1])
    cfg = DRYRUN_CONFIG
    assert videos[0].shape == (3, cfg.num_frames, cfg.image_size,
                               cfg.image_size, cfg.channels)
    assert ranks[0]["test_batch"] == 2
    # one process at the same chunk and streams: the chunk generators draw
    # the same noises
    tr = _world1_trainer(data)
    want = sample_videos(tr.sampling_diffusion(), three_curves(cfg), 5.0,
                         chunk=2, seed=(TRAINER_TCFG.seed,
                                        _MILESTONE_SAMPLES, 3))
    np.testing.assert_allclose(videos[0], want, rtol=0, atol=1e-5)


def test_trainer_two_ranks_validation_loss(dp_trainer, data):
    ranks, _ = dp_trainer
    assert ranks[0]["val_loss"] == ranks[1]["val_loss"]
    assert np.isfinite(ranks[0]["val_loss"])
    # one process on the same batches (2 and 1 of the 3 videos) and the
    # same draws: the two ranks take them at the padded shape (2, 2)
    tr = _world1_trainer(data)
    tr.test_batch = 2
    draws = []
    for i, n in enumerate((2, 1)):
        full = tr.diffusion.loss_draws(
            2, "cpu", generator=seeded_generator("cpu", TRAINER_TCFG.seed,
                                                 _VALIDATION, i),
            null_cond_prob=TRAINER_TCFG.null_cond_prob)
        draws.append({k: v[:n] for k, v in full.items() if v is not None})
    want = tr.validation_loss(draws=draws)
    np.testing.assert_allclose(ranks[0]["val_loss"], want, rtol=1e-6)


def test_train_cli_under_torchrun(data, tmp_path):
    """python -m torch.distributed.run --nproc_per_node 2 -m
    videometamaterials_tpu_torch.main ... --device cpu: the launcher's
    environment joins a gloo group; both ranks pass the run-directory
    check, rank 0 writes the run once."""
    root = tmp_path / "data"
    (root / "lagrangian").mkdir(parents=True)
    for split, src in (("training", "train"), ("validation", "val")):
        (root / "lagrangian" / split).symlink_to(data / "data" / src)
    t_config.save_model_yaml(DRYRUN_CONFIG, tmp_path / "tiny.yaml")
    env = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    env["PYTHONPATH"] = os.pathsep.join([str(REPO),
                                         env.get("PYTHONPATH", "")])
    cmd = [sys.executable, "-m", "torch.distributed.run",
           "--nproc_per_node", "2", "--master_addr", "127.0.0.1",
           "--master_port", str(_free_port()),
           "-m", "videometamaterials_tpu_torch.main", "--run-name", "dp",
           "--config", str(tmp_path / "tiny.yaml"), "--data-root", str(root),
           "--runs-root", str(tmp_path / "runs"), "--train-num-steps", "2",
           "--save-and-sample-every", "2", "--num-samples", "1",
           "--num-preds", "1", "--test-batch-size", "2",
           "--skip-eval-target", "--device", "cpu"]
    proc = subprocess.run(cmd, env=env, cwd=tmp_path, capture_output=True,
                          text=True, timeout=TIMEOUT)
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-3000:]
    assert "Directory already exists" not in proc.stdout
    run = tmp_path / "runs" / "dp"
    records = [json.loads(ln) for ln in
               (run / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records if "training loss" in r] == [0, 1]
    assert [r["step"] for r in records if "validation loss" in r] == [2]
    assert sorted(p.name for p in (run / "model").iterdir()) == [
        "model.yaml", "step_2"]
    for ch in DRYRUN_CONFIG.selected_channels:
        assert (run / "training" / "step_2" / "gifs"
                / f"prediction_channel_{ch}.gif").exists()


# ------------------------------------------------------------ profile_dir


def test_profile_dir_writes_a_trace_and_changes_nothing(data, tmp_path):
    cfg = DRYRUN_CONFIG
    tcfg = dataclasses.replace(TRAINER_TCFG, train_num_steps=14)
    params = {}
    for traced in (False, True):
        model = build_unet(cfg, device="cpu", seed=0)
        tr = Trainer(GaussianDiffusion.from_config(model, cfg, "cpu"), cfg,
                     tcfg, data / "data" / "train", data / "data" / "val",
                     results_folder=tmp_path / f"run{traced}",
                     profile_dir=tmp_path / "trace" if traced else None)
        tr.train()
        params[traced] = state_digest(tr.state)
    assert params[True] == params[False]
    trace = json.loads((tmp_path / "trace" / "trace_rank0.json").read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    # the window's three steps ran their convolutions under the profiler
    assert any("conv" in n for n in names), sorted(names)[:20]


# --------------------------------------------------------------- dry run


def test_dryrun_multichip_two_gloo_processes(capsys):
    dryrun_multichip(2, timeout=TIMEOUT)
    out = capsys.readouterr().out
    assert "dryrun_multichip(2): loss=" in out
    assert "sample=(2, 3, 16, 16, 3) backend=gloo device=cpu OK" in out


def test_entry_is_the_flagships_guided_forward():
    """entry(): the flagship's seeded weights and its example inputs; the
    forward runs here at 16 x 16 (the model takes any size the four levels
    divide) to keep the test small."""
    from videometamaterials_tpu_torch.graft_entry import entry

    fn, (x, t, cond) = entry(device="cpu")
    cfg = t_config.ModelConfig()
    assert x.shape == (1, cfg.num_frames, cfg.image_size, cfg.image_size,
                       cfg.channels)
    assert t.shape == (1,) and cond.shape == (1, cfg.cond_length)
    small = torch.randn((1, cfg.num_frames, 16, 16, cfg.channels),
                        generator=torch.Generator().manual_seed(0))
    eps = fn(small, t, cond)
    assert eps.shape == small.shape and torch.isfinite(eps).all()


def test_digest_sees_a_changed_element():
    """The state digests above are not blind: one ulp changes them."""
    a = torch.ones(5)
    b = a.clone()
    b[3] = torch.nextafter(b[3], torch.tensor(2.0))
    assert digest([a]) != digest([b])
