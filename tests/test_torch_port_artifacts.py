"""PyTorch port, geometry cleanup, artifact export and the data folder's
statistics on the CPU, against the JAX package: clean_pred on random
fields, exact 0.5 values, tied components and cascading removals;
save_preds' GIF frames and byte-identical geometries.csv (lagrangian and
eulerian); labels_scaling, zero_u_2 and min_max_values.csv against
VideoDataset on synthetic folders."""

import shutil

import numpy as np
import pytest

from videometamaterials_tpu.data import gif_io as j_gif
from videometamaterials_tpu.data.dataset import VideoDataset
from videometamaterials_tpu.data.synthetic import (
    make_consistent_dataset_eulerian,
    make_synthetic_dataset,
)
from videometamaterials_tpu.postproc import geometry as j_geom
from videometamaterials_tpu.training import artifacts as j_art
from videometamaterials_tpu_torch.data import dataset, gif_io
from videometamaterials_tpu_torch.postproc import geometry
from videometamaterials_tpu_torch.training import artifacts


def _fields():
    rng = np.random.default_rng(0)
    random = rng.random((6, 12, 12))
    halves = np.where(rng.random((4, 12, 12)) < 0.5, 0.5,
                      rng.choice([0.0, 1.0], (4, 12, 12)))
    tie = np.zeros((2, 8, 8))
    tie[:, 0:2, 0:2] = 1.0           # two components of four pixels
    tie[:, 5:7, 5:7] = 1.0
    tie[1, 0:2, 0:2] = 0.0           # then the second one alone
    cascade = np.zeros((2, 8, 8))
    cascade[0, 0, :5] = 1.0          # a bar, kept
    cascade[0, 2, 3] = 1.0           # isolated, removed
    cascade[1] = np.eye(8)           # a diagonal: every pixel isolated
    cascade[1, 3, 4] = 1.0           # a pair on the diagonal
    blobs = (rng.random((5, 48, 48)) < 0.55).astype(float)
    return {"random": random, "halves": halves, "tie": tie,
            "cascade": cascade, "blobs": blobs}


@pytest.mark.parametrize("name", ["random", "halves", "tie", "cascade",
                                  "blobs"])
def test_clean_pred_matches_jax(name):
    raw = _fields()[name]
    p = raw.shape[-1]
    got = geometry.clean_pred(raw.reshape(len(raw), -1), p)
    want = j_geom.clean_pred(raw.reshape(len(raw), -1), p)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype
    for g in raw[:3]:
        b = (g > 0.5).astype(int)
        np.testing.assert_array_equal(geometry.remove_isolated_pixels(b),
                                      j_geom.remove_isolated_pixels(b))
        np.testing.assert_array_equal(geometry.largest_component(b),
                                      j_geom.largest_component(b))


def test_tie_keeps_the_first_component():
    got = geometry.clean_pred(_fields()["tie"].reshape(2, -1), 8)
    assert got[0].reshape(8, 8)[0:2, 0:2].all()
    assert not got[0].reshape(8, 8)[5:7, 5:7].any()


def _videos(rng, n, frames, size, zero_u_2):
    """[0, 1] videos whose u_2 channel sits at zero_u_2 outside a random
    blob in the upper-left quarter (void), so the geometry is not
    trivial; identical consecutive frames in some videos."""
    v = rng.random((n, frames, size, size, 3)).astype(np.float32)
    solid = rng.random((n, size // 2, size // 2)) < 0.6
    u2 = np.where(solid[:, None], rng.uniform(0.3, 0.7, solid[:, None].shape),
                  zero_u_2 + rng.uniform(-0.01, 0.01, solid[:, None].shape))
    v[:, :, :size // 2, :size // 2, 1] = u2
    v[0, 2] = v[0, 1]
    return v


@pytest.mark.parametrize("frame", ["lagrangian", "eulerian"])
def test_save_preds_files_match_jax(tmp_path, frame):
    rng = np.random.default_rng(1)
    frames, rows, cols = 4, 2, 3
    videos = _videos(rng, rows * cols, frames, 16, 0.25)
    z = 0.25 if frame == "lagrangian" else None
    channels = [0, 1, 3]
    ours = artifacts.save_preds(videos, tmp_path / "port", channels, rows,
                                frame, frames, z)
    theirs = j_art.save_preds(videos, tmp_path / "jax", channels, rows,
                              frame, frames, z)
    assert ours.read_bytes() == theirs.read_bytes()
    geoms = np.genfromtxt(ours, delimiter=",")
    assert geoms.shape == (rows * cols, 64)
    assert 0 < geoms.sum() < geoms.size
    grid = artifacts.make_grid_video(videos, rows)
    np.testing.assert_array_equal(grid, j_art.make_grid_video(videos, rows))
    for j, ch in enumerate(channels):
        name = f"gifs/prediction_channel_{ch}.gif"
        want = np.clip(np.round(grid[j] * 255.0), 0, 255).astype(np.uint8)
        np.testing.assert_array_equal(
            j_gif.gif_to_array(tmp_path / "port" / name), want)
        np.testing.assert_array_equal(
            gif_io.gif_to_array(tmp_path / "port" / name), want)
        np.testing.assert_array_equal(
            gif_io.gif_to_array(tmp_path / "jax" / name,
                                expected_frames=frames), want)


def test_topologies_match_jax():
    rng = np.random.default_rng(2)
    videos = _videos(rng, 3, 5, 12, 0.6)
    for frame, frames in (("lagrangian", 5), ("eulerian", 5),
                          ("lagrangian", 1)):
        np.testing.assert_array_equal(
            artifacts.extract_topologies(videos, frame, frames, 0.6),
            j_art.extract_topologies(videos, frame, frames, 0.6))
    with pytest.raises(ValueError):
        artifacts.make_grid_video(videos, 2)


@pytest.mark.parametrize("frame", ["lagrangian", "eulerian"])
@pytest.mark.parametrize("per_frame_cond", [True, False])
def test_data_folder_statistics_match_video_dataset(tmp_path, frame,
                                                    per_frame_cond):
    folder = tmp_path / "train"
    if frame == "lagrangian":
        make_synthetic_dataset(folder, num_samples=5, image_size=16,
                               num_frames=11, seed=3)
    else:
        make_consistent_dataset_eulerian(folder, num_samples=3,
                                         image_size=16, num_frames=11,
                                         seed=3)
    ours = tmp_path / "copy"
    shutil.copytree(folder, ours)
    ds = VideoDataset(folder, 16, selected_channels=(0, 1, 2),
                      num_frames=11, per_frame_cond=per_frame_cond,
                      reference_frame=frame)
    scaling = dataset.fit_labels_scaling(ours, 11, per_frame_cond)
    assert scaling.to_dict() == ds.labels_scaling.to_dict()
    np.testing.assert_array_equal(
        dataset.read_labels(ours, 11, per_frame_cond), ds.raw_labels)
    ranges = dataset.global_ranges(ours, frame)
    assert dataset.zero_u_2(ranges) == ds.zero_u_2
    dataset.write_min_max_values(ours, ranges)
    assert (ours / "min_max_values.csv").read_bytes() == \
        (folder / "min_max_values.csv").read_bytes()
    with pytest.raises(ValueError):
        dataset.global_ranges(ours, "spatial")
