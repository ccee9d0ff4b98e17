"""PyTorch port, the publication rendering on the CPU: the jet table
against matplotlib's; the port's RGBA GIF read by Pillow (exact up to 255
colours, the JAX writer's timing, loop and disposal) and the JAX writer's
GIFs read by the port; the renderer's GIFs against the JAX renderer's
(alpha exact, colours within Pillow's quantisation); create_visualization
in both reference frames (the curve CSV, the GIFs, the legend's strip and
matplotlib's tick values); convert_isolated_pixels_gif; and the whole
renderer in a subprocess where matplotlib, Pillow and imageio cannot be
imported."""

import os
import subprocess
import sys
from pathlib import Path

import imageio.v3 as iio
import matplotlib
import numpy as np
import pytest
from PIL import Image, ImageSequence

from videometamaterials_tpu.postproc import visualization as j_vis
from videometamaterials_tpu.postproc.remap import (
    convert_isolated_pixels_gif as j_convert,
)
from videometamaterials_tpu.training.artifacts import save_preds
from videometamaterials_tpu_torch import gif_visualization
from videometamaterials_tpu_torch.data import gif_io
from videometamaterials_tpu_torch.postproc import visualization as t_vis
from videometamaterials_tpu_torch.postproc.colormap import JET_RGBA
from videometamaterials_tpu_torch.postproc.remap import (
    convert_isolated_pixels_gif,
)

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FRAMES = 3
# Pillow's quantisation of the JAX writer moves a colour by up to 23
# levels a channel on a smooth jet field; the limit leaves room for it
COLOR_TOL = 32
LAGRANGIAN_RANGES = [[-0.1, 0.1, -0.25, 0.02, 3.0, -2.0, 0.5, 1.0]]


def _pillow_rgba(path):
    return np.stack([np.asarray(f.convert("RGBA"))
                     for f in ImageSequence.Iterator(Image.open(path))])


def _hold_to_jax_gif(ours_path, jax_path):
    """The two files decoded by the port's reader: equal alpha, opaque
    colours within COLOR_TOL; and the port's file read by Pillow as the
    port's reader reads it. (Pillow fills a disposed frame that has no
    transparent index, as the JAX writer leaves frames without a void, with
    the background colour, so it reads the JAX file's later voids as
    opaque; disposal 2 clears them, which is what the port's reader
    gives.)"""
    ours, want = gif_io.gif_to_rgba(ours_path), gif_io.gif_to_rgba(jax_path)
    assert ours.shape == want.shape
    np.testing.assert_array_equal(ours[..., 3], want[..., 3])
    opaque = want[..., 3] != 0
    diff = np.abs(ours[..., :3].astype(int) - want[..., :3])[opaque]
    assert diff.size == 0 or diff.max() <= COLOR_TOL, diff.max()
    pillow = iio.imread(ours_path, plugin="pillow", mode="RGBA", index=None)
    np.testing.assert_array_equal(pillow[..., 3], ours[..., 3])
    np.testing.assert_array_equal(pillow[opaque], ours[opaque])


def _smooth_field(f=11, n=96):
    y, x = np.mgrid[0:n, 0:n] / (n - 1)
    t = np.linspace(0, 1, f)[:, None, None]
    return np.sin(3 * x + 2 * t) * np.cos(2 * y - t)


def test_jet_table_equals_matplotlib():
    want = (plt.get_cmap("jet")(np.arange(256, dtype=np.uint8)) * 255
            ).astype(np.uint8)
    np.testing.assert_array_equal(JET_RGBA, want)


@pytest.mark.parametrize("box", [False, True])
def test_rgba_gif_is_exact_in_pillow(tmp_path, box):
    """Frames of up to 255 opaque colours (jet levels 0-199, the grey box)
    decode in Pillow and in the port's reader to the array written: alpha
    everywhere, RGB where opaque."""
    rng = np.random.default_rng(0)
    levels = rng.integers(0, 200, (4, 30, 40)).astype(np.uint8)
    color = JET_RGBA[levels]
    color[levels < 25, 3] = 0
    if box:
        color[:, :5] = (227, 227, 227, 255)
    path = tmp_path / "v.gif"
    gif_io.rgba_to_gif(color, path)
    opaque = color[..., 3] != 0
    for got in (_pillow_rgba(path), gif_io.gif_to_rgba(path)):
        np.testing.assert_array_equal(got[..., 3], color[..., 3])
        np.testing.assert_array_equal(got[..., :3][opaque],
                                      color[..., :3][opaque])
    assert np.all(gif_io.gif_to_rgba(path)[~opaque] == 0)


def test_rgba_gif_merges_past_255_colours(tmp_path):
    """A frame of 300 opaque colours is written with 255: every pixel
    takes a colour of the frame, the same pixels as before keep their
    colours except the merged ones, and the rule is deterministic."""
    rng = np.random.default_rng(1)
    colors = rng.integers(0, 256, (300, 3)).astype(np.uint8)
    pick = np.arange(60 * 50) % 300
    rng.shuffle(pick)
    frame = np.concatenate([colors[pick].reshape(1, 60, 50, 3),
                            np.full((1, 60, 50, 1), 255, np.uint8)], -1)
    a, b = tmp_path / "a.gif", tmp_path / "b.gif"
    gif_io.rgba_to_gif(frame, a)
    gif_io.rgba_to_gif(frame, b)
    assert a.read_bytes() == b.read_bytes()
    got = _pillow_rgba(a)
    np.testing.assert_array_equal(got, gif_io.gif_to_rgba(a))
    packed = got[0, ..., :3].reshape(-1, 3) @ np.array([65536, 256, 1])
    assert len(np.unique(packed)) == 255
    written = {tuple(c) for c in colors}
    assert {tuple(c) for c in got[0, ..., :3].reshape(-1, 3)} <= written
    same = np.all(got[0, ..., :3] == frame[0, ..., :3], axis=-1)
    assert same.mean() > 0.8


def test_rgba_gif_timing_matches_the_jax_writer(tmp_path):
    """Duration, loop and disposal of every frame as the JAX renderer's
    imageio call writes them (visualization.py:217-219)."""
    rng = np.random.default_rng(2)
    color = JET_RGBA[rng.integers(0, 256, (3, 16, 16)).astype(np.uint8)]
    color[:, :4, :4, 3] = 0
    ours, theirs = tmp_path / "ours.gif", tmp_path / "jax.gif"
    gif_io.rgba_to_gif(color, ours)
    iio.imwrite(theirs, list(color), plugin="pillow", mode="RGBA",
                duration=200, loop=0, disposal=2, quantize=256)

    def timing(path):
        im = Image.open(path)
        out = []
        for frame in ImageSequence.Iterator(im):
            out.append((frame.info.get("duration"), frame.info.get("loop"),
                        frame.disposal_method))
        return out

    assert timing(ours) == timing(theirs)
    assert timing(ours)[0] == (200, 0, 2)


def test_render_rgba_gif_against_the_jax_renderer(tmp_path):
    """A smooth 11 x 96 x 96 jet field with a void and the compression box:
    the port's GIF holds the array exactly, the JAX renderer's moves it, and
    the two agree in alpha exactly and in colour within COLOR_TOL."""
    field = _smooth_field()
    void = field < -0.6
    level = t_vis.quantize_levels(field, -1.0, 1.0, zero_mask=void)
    np.testing.assert_array_equal(
        level, j_vis.quantize_levels(field, -1.0, 1.0, zero_mask=void))
    box = np.arange(11) * 3
    ours, theirs = str(tmp_path / "ours.gif"), str(tmp_path / "jax.gif")
    color = t_vis.render_rgba_gif(level, void, ours, compression_box=box)
    j_vis.render_rgba_gif(level, void, theirs, compression_box=box)
    back = gif_io.gif_to_rgba(ours)
    opaque = color[..., 3] != 0
    np.testing.assert_array_equal(back[..., 3], color[..., 3])
    np.testing.assert_array_equal(back[opaque], color[opaque])
    _hold_to_jax_gif(ours, theirs)


@pytest.fixture(scope="module")
def pred_dir(tmp_path_factory):
    """The prediction grid of tests/test_visualization.py."""
    out = tmp_path_factory.mktemp("viz") / "step_1"
    rng = np.random.default_rng(0)
    videos = rng.uniform(0.3, 0.9, size=(4, FRAMES, 96, 96, 3))
    save_preds(videos, out, selected_channels=[0, 1, 3], num_samples=2,
               reference_frame="lagrangian", num_frames=FRAMES,
               zero_u_2=0.45)
    return out


def _jax_colorbar_ticks(lo, hi):
    """The JAX _write_legend's colour bar, its cb.get_ticks()."""
    fig, ax = plt.subplots(figsize=(1, 30))
    fig.subplots_adjust(bottom=0.5)
    cb = plt.colorbar(plt.cm.ScalarMappable(norm=plt.Normalize(lo, hi),
                                            cmap=plt.get_cmap("jet")),
                      cax=ax, orientation="vertical")
    cb.set_label(r"$\sigma_{22}$", rotation=0, labelpad=15, fontsize=30)
    cb.ax.tick_params(labelsize=20)
    fig.canvas.draw()
    ticks = np.asarray(cb.get_ticks())
    plt.close(fig)
    return ticks


def _hold_legend(png, lo, hi):
    """The legend PNG: the jet strip, hi at the top, every level in order;
    its tick values matplotlib's."""
    im = Image.open(png)
    ticks = np.array([float(v) for v in im.text["ticks"].split(",")])
    np.testing.assert_array_equal(ticks, _jax_colorbar_ticks(lo, hi))
    np.testing.assert_array_equal(ticks, t_vis.legend_ticks(lo, hi))
    column = np.asarray(im.convert("RGBA"))[:, 40]
    strip = column[np.any(column[:, :3] != 255, axis=-1)
                   & np.any(column[:, :3] != 0, axis=-1)]
    levels = [np.flatnonzero(np.all(JET_RGBA == c, axis=-1)) for c in strip]
    first = [lv.max() for lv in levels]
    assert first[0] == 255 and first[-1] <= 1
    assert all(a >= b for a, b in zip(first, first[1:]))


def _run_both(pred, frame_ranges, row, col, ref_frame, tmp_path):
    """create_visualization of both packages on copies of the same GIFs."""
    out = {}
    for name, fn in (("jax", j_vis.create_visualization),
                     ("port", t_vis.create_visualization)):
        gifs = tmp_path / name / "gifs"
        gifs.mkdir(parents=True)
        for f in Path(pred).glob("prediction_channel_*.gif"):
            (gifs / f.name).write_bytes(f.read_bytes())
        out[name] = Path(fn(str(gifs) + "/", str(frame_ranges), row, col,
                            ref_frame=ref_frame))
    return out["jax"], out["port"]


def test_create_visualization_lagrangian(pred_dir, tmp_path):
    fr_csv = tmp_path / "frame_range_data.csv"
    np.savetxt(fr_csv, np.array(LAGRANGIAN_RANGES), delimiter=",")
    want, got = _run_both(pred_dir / "gifs", fr_csv, 0, 1, "lagrangian",
                          tmp_path)
    assert sorted(p.name for p in got.iterdir()) == sorted(
        p.name for p in want.iterdir()) == [
        "stress_strain_estimate.csv", "visualization.gif",
        "visualization_conv_euler.gif", "visualization_legend.png"]
    assert (got / "stress_strain_estimate.csv").read_text() == \
        (want / "stress_strain_estimate.csv").read_text()
    for name in ("visualization.gif", "visualization_conv_euler.gif"):
        _hold_to_jax_gif(got / name, want / name)
    hi = max(abs(v) for v in (LAGRANGIAN_RANGES[0][5],
                              LAGRANGIAN_RANGES[0][6]))
    _hold_legend(got / "visualization_legend.png", -hi, hi)


def test_create_visualization_eulerian(tmp_path):
    rng = np.random.default_rng(1)
    videos = rng.uniform(0.0, 1.0, size=(1, FRAMES, 96, 96, 4))
    src = tmp_path / "step_e"
    save_preds(videos, src, selected_channels=[0, 1, 2, 3], num_samples=1,
               reference_frame="eulerian", num_frames=FRAMES, zero_u_2=None)
    fr_csv = tmp_path / "frame_range.csv"
    np.savetxt(fr_csv, np.array([[3.0, -2.0, 0.5, 1.0]]), delimiter=",")
    want, got = _run_both(src / "gifs", fr_csv, 0, 0, "eulerian", tmp_path)
    assert sorted(p.name for p in got.iterdir()) == sorted(
        p.name for p in want.iterdir())
    assert (got / "stress_strain_estimate.csv").read_text() == \
        (want / "stress_strain_estimate.csv").read_text()
    _hold_to_jax_gif(got / "visualization.gif", want / "visualization.gif")
    # the compression box: the top rows of the last frame are grey
    frames = gif_io.gif_to_rgba(got / "visualization.gif")
    assert np.all(frames[-1, :19] == (227, 227, 227, 255))
    _hold_legend(got / "visualization_legend.png", -2.0, 2.0)


@pytest.mark.parametrize("hi", [3.0, 1.234, 0.0457, 250.0, 7.7e-3, 1.0])
def test_legend_ticks_are_matplotlibs(hi):
    np.testing.assert_array_equal(t_vis.legend_ticks(-hi, hi),
                                  _jax_colorbar_ticks(-hi, hi))


def test_convert_isolated_pixels_gif(tmp_path):
    """The port's pass on a GIF the JAX writer wrote equals the JAX pass on
    the same file."""
    rng = np.random.default_rng(0)
    frames = np.zeros((3, 16, 16, 4), np.uint8)
    frames[rng.random((3, 16, 16)) < 0.25] = (255, 0, 0, 255)
    ours, theirs = tmp_path / "ours.gif", tmp_path / "jax.gif"
    for p in (ours, theirs):
        iio.imwrite(p, list(frames), plugin="pillow", mode="RGBA",
                    duration=200, loop=0, disposal=2, quantize=256)
    convert_isolated_pixels_gif(str(ours))
    j_convert(str(theirs))
    got, want = gif_io.gif_to_rgba(ours), gif_io.gif_to_rgba(theirs)
    np.testing.assert_array_equal(got[..., 3], want[..., 3])
    opaque = want[..., 3] != 0
    np.testing.assert_array_equal(got[opaque], want[opaque])
    assert opaque.sum() < (frames[..., 3] != 0).sum()


def test_renderer_runs_without_matplotlib_pillow_or_imageio(pred_dir,
                                                            tmp_path):
    """python -m videometamaterials_tpu_torch.gif_visualization with the
    three packages blocked in sys.modules: the four artifacts, each GIF
    F x 96 x 96 x 4 through the port's reader."""
    gifs = tmp_path / "gifs"
    gifs.mkdir()
    for f in (pred_dir / "gifs").glob("prediction_channel_*.gif"):
        (gifs / f.name).write_bytes(f.read_bytes())
    fr_csv = tmp_path / "frame_range_data.csv"
    np.savetxt(fr_csv, np.array(LAGRANGIAN_RANGES), delimiter=",")
    code = (
        "import runpy, sys\n"
        "for m in ('matplotlib', 'PIL', 'imageio'):\n"
        "    sys.modules[m] = None\n"
        "sys.argv = ['gif_visualization', '--path', sys.argv[1],\n"
        "            '--frame-ranges', sys.argv[2], '--col', '1']\n"
        "runpy.run_module('videometamaterials_tpu_torch.gif_visualization',\n"
        "                 run_name='__main__')\n"
        "assert not {'matplotlib', 'PIL', 'imageio'} & {\n"
        "    k.split('.')[0] for k, v in sys.modules.items() if v}\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    run = subprocess.run([sys.executable, "-c", code, str(gifs), str(fr_csv)],
                         capture_output=True, text=True, env=env, timeout=120)
    assert run.returncode == 0, run.stderr
    out = gifs / "visualization_0-1"
    assert f"visualization written to {out}/" in run.stdout
    for name in ("visualization.gif", "visualization_conv_euler.gif"):
        assert gif_io.gif_to_rgba(out / name).shape == (FRAMES, 96, 96, 4)
    assert (out / "visualization_legend.png").read_bytes()[:8] == \
        b"\x89PNG\r\n\x1a\n"
    assert len((out / "stress_strain_estimate.csv").read_text()
               .splitlines()) == FRAMES + 1
    # the in-process entry point returns the directory
    assert gif_visualization.main(["--path", str(gifs), "--frame-ranges",
                                   str(fr_csv), "--col", "1"]) == \
        str(out) + "/"
