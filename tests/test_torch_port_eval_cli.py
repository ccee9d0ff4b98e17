"""PyTorch port, the slice on the CPU: `python -m
videometamaterials_tpu_torch.main --skip-train` on a run the JAX package
wrote (the tiny config, its snapshot and a trainer checkpoint through the
JAX save_checkpoint): the model it samples with gives the JAX model's eps
on the checkpoint's EMA weights, it writes the eval_target directory
contract (the index counting up), the same videos give the same files
through the JAX save_preds, the kernels' plain versions run (no launch),
and bad values of the sampler's options are refused."""

import shutil

import jax
import numpy as np
import pytest
import torch

from _torch_port_jax_run import tiny_config, write_data, write_run
from videometamaterials_tpu.data import gif_io as j_gif
from videometamaterials_tpu.data.dataset import VideoDataset
from videometamaterials_tpu.training.artifacts import save_preds as j_save
from videometamaterials_tpu_torch import main as cli
from videometamaterials_tpu_torch import sample
from videometamaterials_tpu_torch.convert import flax_to_torch_state_dict
from videometamaterials_tpu_torch.data import gif_io
from videometamaterials_tpu_torch.ops.cuda import _build

torch.set_num_threads(1)
MODEL_TOL = dict(rtol=2e-4, atol=2e-4)     # tests/test_torch_port_model.py
STEP = 3


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval_cli")
    cfg = tiny_config()
    model, ema, _ = write_run(root / "runs" / "tiny", STEP, cfg)
    write_data(root / "data", cfg)
    return root, cfg, model, ema


def _argv(root, *extra):
    return ["--run-name", "tiny", "--runs-root", str(root / "runs"),
            "--data-root", str(root / "data"), "--num-preds", "2",
            "--test-batch-size", "4", "--device", "cpu", *extra]


@pytest.fixture(scope="module")
def first_eval(run):
    root, *_ = run
    samplers = []
    build = cli.build_sampler
    cli.build_sampler = lambda *a, **kw: samplers.append(build(*a, **kw)) \
        or samplers[-1]
    _build.reset_launch_counts()
    try:
        out = cli.main(_argv(root, "--load-model-step", str(STEP),
                             "--skip-train"))
    finally:
        cli.build_sampler = build
    return out, samplers[0], dict(_build.LAUNCH_COUNTS)


def test_loads_the_jax_ema_and_gives_its_eps(run, first_eval):
    root, cfg, model, ema = run
    out, diffusion, _ = first_eval
    assert out["step"] == STEP
    rng = np.random.default_rng(7)
    x = rng.uniform(-1, 1, (2, 11, 16, 16, 3)).astype(np.float32)
    t = np.array([1, 6], np.int32)
    cond = rng.uniform(-1, 1, (2, 11)).astype(np.float32)
    want = jax.jit(model.apply)(ema, x, t, cond)
    with torch.no_grad():
        got = diffusion.model(torch.tensor(x), torch.tensor(t),
                              torch.tensor(cond))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)


def test_writes_the_directory_contract(run, first_eval):
    root, *_ = run
    out, _, counts = first_eval
    d = root / "runs" / "tiny" / "eval_target_w_5.0_0" / f"step_{STEP}"
    assert out["eval_dir"] == d
    assert sorted(p.name for p in (d / "gifs").iterdir()) == [
        "prediction_channel_0.gif", "prediction_channel_1.gif",
        "prediction_channel_3.gif"]
    geoms = np.genfromtxt(d / "geometries.csv", delimiter=",")
    assert geoms.shape == (4, 64)
    assert set(np.unique(geoms)) <= {0.0, 1.0}
    videos = out["videos"]
    assert videos.shape == (4, 11, 16, 16, 3)
    assert np.isfinite(videos).all()
    assert videos.min() >= 0.0 and videos.max() <= 1.0
    # the CPU runs the kernels' plain versions: no kernel launched
    assert not any(counts.values())
    assert (root / "data" / "lagrangian" / "training"
            / "min_max_values.csv").exists()


def test_same_videos_same_files_as_jax(run, first_eval, tmp_path):
    root, cfg, *_ = run
    out, *_ = first_eval
    ds = VideoDataset(root / "data" / "lagrangian" / "training", 16,
                      selected_channels=cfg.selected_channels, num_frames=11,
                      per_frame_cond=True, reference_frame="lagrangian")
    j_save(out["videos"], tmp_path, list(cfg.selected_channels), 2,
           "lagrangian", 11, ds.zero_u_2)
    d = out["eval_dir"]
    assert (d / "geometries.csv").read_bytes() == \
        (tmp_path / "geometries.csv").read_bytes()
    for ch in cfg.selected_channels:
        name = f"gifs/prediction_channel_{ch}.gif"
        np.testing.assert_array_equal(
            gif_io.gif_to_array(d / name),
            j_gif.gif_to_array(tmp_path / name, expected_frames=11))


def test_second_run_counts_up_and_reruns_are_refused(run, first_eval,
                                                     capsys):
    root, *_ = run
    out = cli.main(_argv(root, "--load-model-step", str(STEP),
                         "--skip-train", "--guidance-scale", "5",
                         "--seed", "1"))
    assert out["eval_dir"].parent.name == "eval_target_w_5.0_1"
    phi = cli.main(_argv(root, "--load-model-step", str(STEP),
                         "--skip-train", "--cfg-rescale", "0.5",
                         "--skip-eval-target"))
    assert phi["eval_dir"] is None
    with pytest.raises(SystemExit) as err:
        cli.main(_argv(root, "--skip-train"))
    assert err.value.code == 1
    assert "Directory already exists" in capsys.readouterr().out


def test_cache_restored_run_loads_strictly(run, tmp_path):
    """A ckpt_cache tree restored into a run (no optimizer state) loads
    strictly; a tree that does not fit the run's config raises in the
    sampler's load_state_dict and writes no artifacts."""
    from videometamaterials_tpu_torch.training import checkpoint as ckpt
    from videometamaterials_tpu_torch.training.msgpack_io import (
        read_msgpack,
        write_msgpack,
    )

    root, cfg, _, ema = run
    src = root / "runs" / "tiny" / "model"
    raw = read_msgpack(src / f"step_{STEP}" / "checkpoint.msgpack")
    cache = tmp_path / "tiny_step_3.msgpack"
    write_msgpack(cache, {"step": raw["step"],
                          "ema_params": raw["ema_params"]})
    yaml = (src / "model.yaml").read_text()
    assert "unet_dim: 8\n" in yaml
    argv = ["--runs-root", str(tmp_path / "runs"), "--data-root",
            str(root / "data"), "--load-model-step", str(STEP),
            "--skip-train", "--skip-eval-target", "--device", "cpu"]
    for name, text in (("fits", yaml),
                       ("wider", yaml.replace("unet_dim: 8", "unet_dim: 16"))):
        ckpt.restore_from_cache(cache, tmp_path / "runs" / name, STEP)
        (tmp_path / "runs" / name / "model" / "model.yaml").write_text(text)
    samplers = []
    build = cli.build_sampler
    cli.build_sampler = lambda *a, **kw: samplers.append(build(*a, **kw)) \
        or samplers[-1]
    try:
        assert cli.main(["--run-name", "fits", *argv])["step"] == STEP
        with pytest.raises(RuntimeError, match="size mismatch"):
            cli.main(["--run-name", "wider", *argv])
    finally:
        cli.build_sampler = build
    want = flax_to_torch_state_dict(jax.device_get(ema))
    got = samplers[0].model.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert not any(p.name.startswith("eval_target")
                   for p in (tmp_path / "runs" / "wider").iterdir())


@pytest.mark.parametrize("extra,error,match", [
    (("--torch-checkpoint", "c.pt"), FileNotFoundError, "c.pt"),
    (("--skip-train", "--guidance-arms", "5,x"), ValueError, "guidance arm"),
    (("--skip-train", "--guidance-arms", "5:0.1:2"), ValueError,
     "guidance arm"),
    (("--skip-train", "--sampling-timesteps", "9"), ValueError,
     "sampling_timesteps"),
    (("--sampling-timesteps", "0"), ValueError, "sampling_timesteps"),
    (("--skip-train", "--torch-checkpoint", "c.pt"), FileNotFoundError,
     "c.pt"),
])
def test_unported_options_raise(run, extra, error, match, tmp_path):
    """The sampler's and the import's options refuse a bad value (a
    missing checkpoint.pt, an arm that is not w or w:phi, more DDIM steps
    than train steps) before anything is written."""
    root, *_ = run
    argv = ["--run-name", "new", "--runs-root", str(tmp_path / "runs"),
            "--config", str(root / "runs" / "tiny" / "model" / "model.yaml"),
            "--device", "cpu", *extra]
    with pytest.raises(error, match=match):
        cli.main(argv)
    assert not (tmp_path / "runs").exists()


def test_needs_a_gpu_unless_told_otherwise(run, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--run-name", "x", "--runs-root", str(tmp_path),
                  "--skip-train"])
    assert not any(tmp_path.iterdir())


def test_sample_cli_reads_the_config_and_the_checkpoint(run, tmp_path,
                                                        monkeypatch):
    """sample.py --config (the run's snapshot) --checkpoint (its msgpack):
    the EMA weights, a partial chain."""
    root, cfg, _, ema = run
    seen = {}
    build = sample.build_sampler

    def spy(c, **kw):
        seen.update(cfg=c, weights=kw["weights"])
        return build(c, **kw)

    monkeypatch.setattr(sample, "build_sampler", spy)
    run_dir = root / "runs" / "tiny" / "model"
    meta = sample.main([
        "--out-dir", str(tmp_path), "--config", str(run_dir / "model.yaml"),
        "--checkpoint", str(run_dir / f"step_{STEP}" / "checkpoint.msgpack"),
        "--batch", "2", "--num-steps", "2", "--device", "cpu"])
    assert meta["videos"] == [2, 11, 16, 16, 3]
    assert seen["cfg"].unet_dim == 8 and seen["cfg"].image_size == 16
    want = flax_to_torch_state_dict(jax.device_get(ema))
    assert all(torch.equal(seen["weights"][k], want[k]) for k in want)


def test_sample_videos_chunks_with_a_stream_each(first_eval):
    """Three curves in chunks of 2: the second chunk padded with the last
    curve, each chunk drawn from chunk_generator(seed, i), the padding
    dropped."""
    from videometamaterials_tpu_torch.training.trainer import (
        chunk_generator,
        sample_videos,
    )

    _, diffusion, _ = first_eval
    cond = np.random.default_rng(8).uniform(-1, 1, (3, 11)).astype(
        np.float32)
    got = sample_videos(diffusion, cond, 5.0, chunk=2, seed=4)
    assert got.shape == (3, 11, 16, 16, 3)
    for i, rows in enumerate((cond[:2], cond[[2, 2]])):
        want = diffusion.sample(torch.from_numpy(rows), 5.0,
                                generator=chunk_generator(4, i, "cpu"))
        np.testing.assert_array_equal(got[2 * i:2 * i + 2],
                                      want.numpy()[:len(got) - 2 * i])
    other = sample_videos(diffusion, cond, 5.0, chunk=2, seed=5)
    assert not np.array_equal(got, other)


def test_arm_directories_are_named_as_the_jax_trainer_names_them(tmp_path):
    """The JAX Trainer's eval_target names an arm's directory from its
    traced float32 (w, phi) before it reads the targets."""
    from types import SimpleNamespace

    import jax.numpy as jnp

    from videometamaterials_tpu.training.trainer import Trainer as JTrainer
    from videometamaterials_tpu_torch.training.trainer import eval_target_dir

    spec = "5,2:0.7,1.5,0.1:0.05"
    for w, phi, label in cli.parse_arms(spec):
        fake = SimpleNamespace(
            tcfg=SimpleNamespace(guidance_scale=5.0),
            state=SimpleNamespace(step=STEP),
            diffusion=SimpleNamespace(cfg_rescale=0.3),
            results_folder=tmp_path / "jax")
        assert JTrainer.eval_target(
            fake, tmp_path / "missing.csv", guidance_scale=jnp.float32(w),
            cfg_rescale=jnp.float32(phi)) is None
        eval_target_dir(tmp_path / "port", STEP, label, phi).mkdir(
            parents=True)
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == ["eval_target_w_0.1_phi_0.05_0", "eval_target_w_1.5_0",
                     "eval_target_w_2.0_phi_0.7_0", "eval_target_w_5.0_0"]


def test_ddim_arms_write_the_jax_named_directories(run, monkeypatch,
                                                   capsys):
    """--guidance-arms 5,2:0.7 --sampling-timesteps 4 on the tiny config
    (8 train steps): each arm samples the 4-step DDIM chain (2 chunks of
    2 videos) from the same seed and writes its directory; phi is the
    arm's, not the config's."""
    from videometamaterials_tpu_torch.diffusion.gaussian import (
        GaussianDiffusion,
    )

    root, *_ = run
    calls = []
    step = GaussianDiffusion.ddim_step

    def counted(self, x, t, t_next, cond, w, noise, cfg_rescale=None):
        calls.append((t, t_next, w, cfg_rescale))
        return step(self, x, t, t_next, cond, w, noise, cfg_rescale)

    monkeypatch.setattr(GaussianDiffusion, "ddim_step", counted)
    monkeypatch.setattr(GaussianDiffusion, "p_sample", None)
    run_dir = root / "runs" / "tiny"
    index = len(list(run_dir.glob("eval_target_w_5.0_*")))
    out = cli.main(_argv(root, "--load-model-step", str(STEP),
                         "--skip-train", "--guidance-arms", "5,2:0.7",
                         "--sampling-timesteps", "4", "--cfg-rescale",
                         "0.3"))
    assert [a["eval_dir"] for a in out["arms"]] == [
        run_dir / f"eval_target_w_5.0_{index}" / f"step_{STEP}",
        run_dir / "eval_target_w_2.0_phi_0.7_0" / f"step_{STEP}"]
    assert out["eval_dir"] == out["arms"][1]["eval_dir"]
    pairs = [(7, 5), (5, 3), (3, 1), (1, -1)]
    want = [(t, n, 5.0, 0.0) for _ in range(2) for t, n in pairs] + \
        [(t, n, 2.0, float(np.float32(0.7))) for _ in range(2)
         for t, n in pairs]
    assert calls == want
    for arm in out["arms"]:
        d = arm["eval_dir"]
        assert arm["videos"].shape == (4, 11, 16, 16, 3)
        assert np.isfinite(arm["videos"]).all()
        np.testing.assert_array_equal(
            gif_io.gif_to_array(d / "gifs" / "prediction_channel_0.gif")
            .shape, (11, 2 * 20, 2 * 20))
        assert np.genfromtxt(d / "geometries.csv",
                             delimiter=",").shape == (4, 64)
    printed = capsys.readouterr().out
    assert "guidance arm w=5.0 phi=0.0 -> " in printed
    assert "guidance arm w=2.0 phi=0.7 -> " in printed


def _reference_checkpoint(path, model_sd, ema_sd):
    """checkpoint.pt as the reference writes it: {model, ema, optimizer,
    steps}, keys under denoise_fn., the schedule buffers beside them."""
    def ref(sd):
        out = {f"denoise_fn.{k}": v.clone() for k, v in sd.items()}
        out["betas"] = torch.linspace(1e-4, 0.02, 8)
        return out

    torch.save({"model": ref(model_sd), "ema": ref(ema_sd),
                "optimizer": {"state": {}, "param_groups": []},
                "steps": 11}, path)
    return path


def test_torch_checkpoint_reaches_the_sampler_and_the_trainer(run, tmp_path):
    """--skip-train samples from the imported EMA; without it the trainer
    takes the online weights and the EMA, keeping Adam's state and the
    step; --load-model-step given as well overrides the import."""
    root, cfg, _, ema = run
    rng = np.random.default_rng(9)
    sd = flax_to_torch_state_dict(jax.device_get(ema))
    online = {k: v + torch.tensor(rng.standard_normal(v.shape) * 0.01,
                                  dtype=torch.float32)
              for k, v in sd.items()}
    imported = {k: v * 1.5 for k, v in sd.items()}
    path = _reference_checkpoint(tmp_path / "checkpoint.pt", online,
                                 imported)
    samplers = []
    build = cli.build_sampler
    cli.build_sampler = lambda *a, **kw: samplers.append(build(*a, **kw)) \
        or samplers[-1]
    try:
        out = cli.main(_argv(root, "--skip-train", "--torch-checkpoint",
                             str(path), "--skip-eval-target")
                       [2:] + ["--run-name", "imported", "--config",
                               str(root / "runs" / "tiny" / "model"
                                   / "model.yaml")])
        over = cli.main(_argv(root, "--skip-train", "--torch-checkpoint",
                              str(path), "--load-model-step", str(STEP),
                              "--skip-eval-target"))
    finally:
        cli.build_sampler = build
    assert out["step"] == 0 and over["step"] == STEP
    for sampler, want in ((samplers[0], imported), (samplers[1], sd)):
        got = sampler.model.state_dict()
        assert all(torch.equal(got[k], want[k]) for k in want)

    data = tmp_path / "data"
    shutil.copytree(root / "data", data)
    shutil.copytree(data / "lagrangian" / "training",
                    data / "lagrangian" / "validation")
    out = cli.main(["--run-name", "t", "--runs-root", str(tmp_path / "runs"),
                    "--data-root", str(data), "--config",
                    str(root / "runs" / "tiny" / "model" / "model.yaml"),
                    "--torch-checkpoint", str(path), "--train-num-steps",
                    "0", "--skip-eval-target", "--device", "cpu"])
    state = out["trainer"].state
    assert state.step == 0 and not state.optimizer.state
    params = dict(state.model.named_parameters())
    assert all(torch.equal(params[k], online[k]) for k in online)
    assert all(torch.equal(e, imported[k])
               for k, e in state.ema_state_dict().items())
