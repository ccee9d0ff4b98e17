"""PyTorch port, the latency mode on the CPU (gloo): one guided video's
chain split by height or by frames over two ranks
(videometamaterials_tpu_torch/parallel/latency.py), against one process
of the port and against the JAX sampler with sample_spatial_sharding on a
2-device virtual CPU mesh, from the same converted weights and the same
draws (x_T and the step noises replayed from the JAX key). Cases: height
in 'zeros' and in 'circular', a 12 x 12 model of mults (1, 2, 4) whose
bottom level (3 rows) runs whole on both ranks, DDIM, and 11 frames over
2 ranks (6 + 5). Then the refusals, no collective without a split, the
collective counts a step, and the layout and halo rows each convolution
needs for W in {1, 2, 3, 4, 8}, as one-process functions.

The two ranks run once, in two worker processes
(tests/_torch_port_latency_worker.py, one thread each) under a timeout.

Bounds: the JAX test's own (tests/test_spatial_sharding.py:63, :79),
atol = rtol = 2e-3 for height (split GroupNorm sums in the one-pass form
regroup) and 2e-4 for frames; the first step's eps, which no threshold
clips, within 1e-5 of its largest |element| of one process's; `-s`
prints the measured errors."""

import dataclasses
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

from videometamaterials_tpu.config import ModelConfig as JConfig
from videometamaterials_tpu.diffusion import GaussianDiffusion as JDiffusion
from videometamaterials_tpu.models import UNet3D as JUNet3D
from videometamaterials_tpu.parallel.mesh import (
    frame_video_sharding as j_frame_sharding,
)
from videometamaterials_tpu.parallel.mesh import (
    spatial_video_sharding as j_spatial_sharding,
)
from videometamaterials_tpu_torch import config as t_config
from videometamaterials_tpu_torch import parallel
from videometamaterials_tpu_torch.convert import flax_to_torch_state_dict
from videometamaterials_tpu_torch.diffusion.gaussian import GaussianDiffusion
from videometamaterials_tpu_torch.models.unet3d import build_unet
from videometamaterials_tpu_torch.ops.conv import (
    conv2d_spatial,
    conv_transpose2d_spatial,
)
from videometamaterials_tpu_torch.ops.norms import group_norm
from videometamaterials_tpu_torch.parallel.latency import (
    LatencyPlan,
    frame_blocks,
    halo_rows,
    halo_sources,
    level_layout,
)

torch.set_num_threads(1)
TESTS = Path(__file__).resolve().parent
REPO = TESTS.parent
WORKER = TESTS / "_torch_port_latency_worker.py"
TIMEOUT = 300
TOL = {"height": 2e-3, "frames": 2e-4}
# the first eps against one process, relative to its largest |element|:
# float32 sums of up to ~1e3 terms in another order, ~1e-6
EPS_TOL = 1e-5

BASE = dict(image_size=16, num_frames=3, unet_dim=8, dim_mults=(1, 2),
            unet_attn_heads=2, unet_attn_dim_head=4, train_timesteps=6,
            sampling_timesteps=6, compute_dtype="float32",
            sample_scan_chunk=None, use_fused_linear_block=False,
            use_fused_temporal_block=False)
CASES = {
    "height-zeros": ("height", {}),
    "height-circular": ("height", dict(padding_mode="circular")),
    "height-whole-bottom": ("height", dict(image_size=12,
                                           dim_mults=(1, 2, 4))),
    "height-ddim": ("height", dict(sampling_timesteps=3)),
    "frames-11": ("frames", dict(num_frames=11)),
}


def _port_cfg(j):
    return t_config.ModelConfig(**{
        f.name: getattr(j, f.name)
        for f in dataclasses.fields(t_config.ModelConfig)})


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _params(j_cfg, seed: int = 0):
    """The JAX model of j_cfg and seeded weights of its parameter shapes
    (jax.eval_shape: no compile of model.init): kernels N(0, 1/fan_in),
    1-D leaves 1 + N(0, 1/20)."""
    model = JUNet3D.from_config(j_cfg)
    x = np.zeros((1, j_cfg.num_frames, j_cfg.image_size, j_cfg.image_size,
                  j_cfg.channels), np.float32)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), x,
                            np.zeros((1,), np.int32),
                            np.zeros((1, j_cfg.num_frames), np.float32))
    rng = np.random.default_rng(seed)
    return model, jax.tree.map(
        lambda s: (rng.standard_normal(s.shape)
                   / np.sqrt(np.prod(s.shape[:-1]) if len(s.shape) > 1
                             else 20.0)).astype(np.float32)
        + np.float32(len(s.shape) == 1), shapes)


def _jax_draws(key, shape, steps):
    """x_T and the step noises the JAX samplers draw from `key`
    (gaussian.py:355-358, :291-292, :307-308)."""
    rng, init = jax.random.split(key)
    x_t = np.asarray(jax.random.normal(init, shape, jnp.float32))
    noises = []
    for _ in range(steps):
        rng, sub = jax.random.split(rng)
        noises.append(torch.tensor(np.asarray(
            jax.random.normal(sub, shape, jnp.float32))))
    return torch.tensor(x_t), noises


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case: the two ranks' results and counts, one port process,
    and the JAX sharded sampler, from the same weights and draws."""
    out = tmp_path_factory.mktemp("latency")
    inputs, jax_cases = {}, {}
    for name, (axis, kw) in CASES.items():
        j_cfg = JConfig(**{**BASE, **kw})
        j_model, params = _params(j_cfg)
        shape = (1, j_cfg.num_frames, j_cfg.image_size, j_cfg.image_size,
                 j_cfg.channels)
        cond = np.random.default_rng(1).uniform(
            -1, 1, (1, j_cfg.num_frames)).astype(np.float32)
        key = jax.random.PRNGKey(2)
        x_t, noises = _jax_draws(key, shape, j_cfg.sampling_timesteps)
        inputs[name] = {"cfg": _port_cfg(j_cfg), "axis": axis,
                        "weights": flax_to_torch_state_dict(params),
                        "cond": torch.tensor(cond), "x_T": x_t,
                        "noises": noises}
        jax_cases[name] = (j_cfg, j_model, params, key, cond)
    gen = torch.Generator().manual_seed(5)
    norm_input = (torch.randn((2, 11, 16, 16, 8), generator=gen) * 3 + 1,
                  torch.randn(8, generator=gen), torch.randn(8, generator=gen))
    torch.save({**inputs, "norm_input": norm_input}, out / "inputs.pt")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO), str(TESTS), env.get("PYTHONPATH", "")])
    env["CUDA_VISIBLE_DEVICES"] = ""
    init = f"tcp://127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), init, str(r), "2", str(out)],
        env=env, cwd=out, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    try:
        # meanwhile: one process of the port, and the JAX sharded sampler
        one, jx = {}, {}
        for name, case in inputs.items():
            model = build_unet(case["cfg"], device="cpu", seed=None)
            model.load_state_dict(case["weights"], strict=True)
            diffusion = GaussianDiffusion.from_config(model, case["cfg"],
                                                      "cpu")
            one[name] = diffusion.sample(
                case["cond"], 5.0, x_T=case["x_T"],
                noise_fn=lambda i, n=case["noises"]: n[i]).numpy()
            t = torch.full((1,), case["cfg"].train_timesteps - 1)
            with torch.no_grad():
                for key, phi in (("eps", 0.0), ("eps_rescaled", 0.7)):
                    one[name, key] = diffusion.guided_eps(
                        case["x_T"], t, case["cond"], 5.0, phi).numpy()
            j_cfg, j_model, params, key, cond = jax_cases[name]
            axis = case["axis"]
            mesh = Mesh(np.asarray(jax.devices()[:2]),
                        ("space",) if axis == "height" else ("seq",))
            sharding = (j_spatial_sharding(mesh) if axis == "height"
                        else j_frame_sharding(mesh))
            j_diff = dataclasses.replace(
                JDiffusion.from_config(j_model, j_cfg),
                sample_spatial_sharding=sharding)
            # traced whole, as the dry run does (__graft_entry__.py:190):
            # the eager path's device_put refuses 11 frames on 2 devices
            jx[name] = np.asarray(jax.jit(lambda p, k, c, d=j_diff: d.sample(
                p, k, c, guidance_scale=5.0, inside_jit=True))(
                    params, key, jnp.asarray(cond)))
        outs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{o[-3000:]}"
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    return {"ranks": ranks, "one": one, "jax": jx, "norm_input": norm_input}


def _err(a, b) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


@pytest.mark.parametrize("case", list(CASES))
def test_two_ranks_equal_one_process(runs, case):
    a, b = (r[case]["video"].numpy() for r in runs["ranks"])
    np.testing.assert_array_equal(a, b)         # the whole video on both
    tol = TOL[CASES[case][0]]
    print(f"\n{case}: two ranks vs one process, max |diff| "
          f"{_err(a, runs['one'][case]):.3e} (bound {tol})")
    np.testing.assert_allclose(a, runs["one"][case], atol=tol, rtol=tol)


@pytest.mark.parametrize("key", ["eps", "eps_rescaled"])
@pytest.mark.parametrize("case", list(CASES))
def test_two_ranks_eps_equals_one_process(runs, case, key):
    """The first step's guided eps, before any threshold clips, and with
    CFG rescale (phi 0.7: the std of eps over the whole video from split
    sums): only the order of float32 sums differs (the split GroupNorm
    sums, key softmax and context), so within EPS_TOL of the largest
    |eps|."""
    a = runs["ranks"][0][case][key].numpy()
    want = runs["one"][case, key]
    bound = EPS_TOL * np.abs(want).max()
    print(f"\n{case}: first {key}, two ranks vs one process, max |diff| "
          f"{_err(a, want):.3e} (bound {bound:.3e})")
    np.testing.assert_allclose(a, want, atol=bound, rtol=0)


@pytest.mark.parametrize("one_pass", [True, False])
@pytest.mark.parametrize("case", ["height-zeros", "frames-11"])
def test_split_group_norm(runs, case, one_pass):
    """GroupNorm over a tensor split by height (8 + 8 rows) and by frames
    (6 + 5) in both forms (VMT_ONEPASS_NORMS): the all-reduced sums over
    the whole element count give one process's normalisation (float32,
    another summation order; inputs of mean 1 and std 3)."""
    x, scale, bias = runs["norm_input"]
    want = group_norm(x, scale, bias, 4, one_pass=one_pass)
    got = runs["ranks"][0][case]["norm"][0 if one_pass else 1]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", list(CASES))
def test_two_ranks_match_the_jax_sharded_sampler(runs, case):
    a = runs["ranks"][0][case]["video"].numpy()
    tol = TOL[CASES[case][0]]
    print(f"\n{case}: two ranks vs JAX sample_spatial_sharding, max |diff| "
          f"{_err(a, runs['jax'][case]):.3e} (bound {tol})")
    np.testing.assert_allclose(a, runs["jax"][case], atol=tol, rtol=tol)


@pytest.mark.parametrize("case", list(CASES))
def test_collectives_a_step(runs, case):
    """The counterpart of the JAX test's collective structure
    (tests/test_spatial_sharding.py:93-137): the height split exchanges
    halos and gathers; the frame split exchanges no halo and gathers the
    temporal keys and values. Every step calls the same collectives;
    the chain ends with one gather of the result."""
    r = runs["ranks"][0][case]
    marks = r["before_step"] + [r["total"]]
    steps = [{k: b[k] - a[k] for k in a} for a, b in zip(marks, marks[1:])]
    *body, last = steps
    assert all(s == steps[0] for s in body), steps
    assert last == {**steps[0], "all_gather": steps[0]["all_gather"] + 1}
    per = steps[0]
    print(f"\n{case}: collectives a step {per}")
    if CASES[case][0] == "height":
        assert per["halo"] > 0 and per["all_gather"] > 0, per
    else:
        assert per["halo"] == 0 and per["all_gather"] > 0, per
    assert per["all_reduce"] > 0, per             # GroupNorm statistics


# -------------------------------------------------- one-process checks


def _tiny(**kw):
    cfg = _port_cfg(JConfig(**{**BASE, **kw}))
    return cfg, build_unet(cfg, device="cpu", seed=0)


def test_fused_plans_are_refused():
    cfg, model = _tiny(use_fused_temporal_block="all")
    with pytest.raises(ValueError, match="unfused plans"):
        GaussianDiffusion.from_config(
            model, cfg, "cpu",
            sample_spatial_sharding=parallel.spatial_video_sharding())
    cfg, model = _tiny(use_fused_linear_block="all")
    with pytest.raises(ValueError, match="use_fused_linear_block=False"):
        GaussianDiffusion.from_config(
            model, cfg, "cpu",
            sample_spatial_sharding=parallel.frame_video_sharding())


@pytest.mark.parametrize("world", [3, 5])
def test_height_needs_the_world_to_divide_the_image(world):
    cfg, model = _tiny()
    with pytest.raises(ValueError, match="divide image_size"):
        GaussianDiffusion.from_config(
            model, cfg, "cpu",
            sample_spatial_sharding=LatencyPlan("height", None, 0, world))
    # frames split near-evenly, but not over more ranks than frames
    with pytest.raises(ValueError, match="frames do not split"):
        GaussianDiffusion.from_config(
            model, cfg, "cpu",
            sample_spatial_sharding=LatencyPlan("frames", None, 0, 4))


@pytest.mark.parametrize("plan", [None, "height", "frames"])
def test_no_collective_without_a_split(monkeypatch, plan):
    """With no plan, or a plan of one rank (no process group), the chain
    is today's code, bit for bit, and calls no collective."""
    def refuse(*a, **kw):
        raise AssertionError("a collective was called")

    for name in ("all_reduce", "all_gather", "batch_isend_irecv", "isend",
                 "irecv", "send", "recv", "broadcast", "barrier"):
        monkeypatch.setattr(dist, name, refuse)
    cfg, model = _tiny()
    gen = torch.Generator().manual_seed(3)
    cond = torch.rand((1, cfg.num_frames), generator=gen)
    plain = GaussianDiffusion.from_config(model, cfg, "cpu")
    want = plain.sample(cond, 5.0, generator=torch.Generator().manual_seed(4))
    sharding = {None: None, "height": parallel.spatial_video_sharding(),
                "frames": parallel.frame_video_sharding()}[plan]
    diffusion = GaussianDiffusion.from_config(
        model, cfg, "cpu", sample_spatial_sharding=sharding)
    assert diffusion.latency is None
    got = diffusion.sample(cond, 5.0,
                           generator=torch.Generator().manual_seed(4))
    assert torch.equal(got, want)
    if sharding is not None:
        assert sharding.world == 1
        assert set(sharding.counts.values()) == {0}


# ------------------------------------------------------------- layout

# the flagship's four levels (96, 48, 24, 12 rows): whole blocks a rank
FLAGSHIP_ROWS_A_RANK = {1: (96, 48, 24, 12), 2: (48, 24, 12, 6),
                        3: (32, 16, 8, 4), 4: (24, 12, 6, 3),
                        8: (12, 6, 3, None)}


@pytest.mark.parametrize("world", [1, 2, 3, 4, 8])
def test_level_layout(world):
    """Each level splits into whole blocks while the rows allow, and the
    levels below a level that does not run whole; a split level's blocks
    above a split level hold even rows from an even row (the stride-2
    Downsample's), and its halo rows come from the right ranks."""
    layout = level_layout(96, 4, world)
    got = tuple(None if b is None else b[0][1] - b[0][0] for b in layout)
    assert got == FLAGSHIP_ROWS_A_RANK[world]
    for i, blocks in enumerate(layout):
        if blocks is None:
            continue
        rows = 96 >> i
        assert blocks[0][0] == 0 and blocks[-1][1] == rows
        assert all(a[1] == b[0] for a, b in zip(blocks, blocks[1:]))
        if i + 1 < len(layout) and layout[i + 1] is not None:
            assert all(a % 2 == 0 and (b - a) % 2 == 0 for a, b in blocks)
        for wrap in (False, True):
            for above, below in ((3, 3), (1, 1)):
                for r, (top, bottom) in enumerate(
                        halo_sources(blocks, rows, above, below, wrap)):
                    start, stop = blocks[r]
                    want = [*range(start - above, start),
                            *range(stop, stop + below)]
                    want = [g % rows if wrap else g if 0 <= g < rows
                            else None for g in want]
                    have = [g for src, lo, hi in top + bottom
                            for g in ([None] * (hi - lo) if src is None
                                      else range(lo, hi))]
                    assert have == want, (r, wrap, above)
                    for src, lo, hi in top + bottom:
                        assert src is None or (
                            blocks[src][0] <= lo and hi <= blocks[src][1])


def test_frame_blocks():
    assert frame_blocks(11, 2) == ((0, 6), (6, 11))
    assert frame_blocks(11, 4) == ((0, 3), (3, 6), (6, 9), (9, 11))
    assert frame_blocks(3, 3) == ((0, 1), (1, 2), (2, 3))


def test_halo_rows_of_each_convolution():
    """The init conv (7x7) reads 3 rows each way, the 3x3 block convs 1,
    Downsample (4x4, stride 2, pad 1) 1 and Upsample (its transpose) 1."""
    assert halo_rows(7, 1, 3) == (3, 3)
    assert halo_rows(3, 1, 1) == (1, 1)
    assert halo_rows(4, 2, 1) == (1, 1)
    assert halo_rows(4, 2, 1, transposed=True) == (1, 1)


class _RowsOfWhole:
    """Rank `rank` of a height split whose halo rows are read from the
    whole tensor in this process, through halo_sources: the split
    convolutions' arithmetic without a process group."""

    splits_height = True

    def __init__(self, whole, blocks, rank):
        self.whole, self.blocks, self.rank = whole, blocks, rank

    def halo(self, x, above, below, wrap):
        top, bottom = halo_sources(self.blocks, self.whole.shape[2], above,
                                   below, wrap)[self.rank]

        def rows(pieces):
            return [self.whole[:, :, lo:hi] if src is not None
                    else x.new_zeros((*x.shape[:2], hi - lo, *x.shape[3:]))
                    for src, lo, hi in pieces]
        return torch.cat(rows(top) + [x] + rows(bottom), dim=2)


@pytest.mark.parametrize("world", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("mode", ["zeros", "circular", "circular_1d"])
def test_split_convolutions_give_their_rows(world, mode):
    """Every spatial convolution of the model on one rank's rows with
    their halo equals the rows of the whole convolution: the init conv,
    a 3x3 block conv, Downsample and Upsample (whose rank rows are twice
    the input's), on 24 rows, 16 at W = 8: 2 rows a rank, so the init
    conv's 3 halo rows come from two ranks each way."""
    gen = torch.Generator().manual_seed(world)
    size = 16 if world == 8 else 24
    x = torch.randn((1, 2, size, 10, 4), generator=gen)
    blocks = tuple((r * size // world, (r + 1) * size // world)
                   for r in range(world))
    ops = [(lambda t, s, w=w, b=b, st=st, p=p: conv2d_spatial(
        t, w, b, stride=st, padding=p, padding_mode=mode, shard=s), st)
        for k, st, p in ((7, 1, None), (3, 1, None), (4, 2, 1))
        for w, b in [(torch.randn((5, 4, k, k), generator=gen),
                      torch.randn(5, generator=gen))]]
    w_up, b_up = (torch.randn((4, 5, 4, 4), generator=gen),
                  torch.randn(5, generator=gen))
    ops.append((lambda t, s: conv_transpose2d_spatial(
        t, w_up, b_up, padding_mode=mode, shard=s), 0.5))
    for op, stride in ops:
        if any((b - a) % stride for a, b in blocks) and stride == 2:
            continue                    # a stride-2 op needs even blocks
        want = op(x, None)
        for r, (a, b) in enumerate(blocks):
            got = op(x[:, :, a:b], _RowsOfWhole(x, blocks, r))
            lo, hi = int(a / stride), int(b / stride)
            torch.testing.assert_close(got, want[:, :, lo:hi], rtol=1e-5,
                                       atol=1e-5)
