"""Prediction artifacts: the port's copy of
videometamaterials_tpu/training/artifacts.py (contract-frozen with the
reference's vddp.py:1870-1918).

save_preds writes per-channel grid GIFs (gifs/prediction_channel_<c>.gif:
rows = conditionings, columns = predictions, 2-pixel padding) and the
material geometry, cleaned and transposed to the Abaqus convention, as
geometries.csv (one row of (H/2)*(W/2) zeros and ones a video), which
eval_abaqus.py and gif_visualization.py read.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from videometamaterials_tpu_torch.data.gif_io import array_to_gif
from videometamaterials_tpu_torch.postproc.geometry import clean_pred


def make_grid_video(videos: np.ndarray, rows: int, pad: int = 2) -> np.ndarray:
    """(n, F, H, W, C) -> (C, F, rows*(H+2p), cols*(W+2p)), n = rows*cols,
    row-major (row = conditioning, column = prediction)."""
    n, f, h, w, c = videos.shape
    if n % rows:
        raise ValueError(f"{n} videos not divisible into {rows} rows")
    cols = n // rows
    padded = np.pad(videos, ((0, 0), (0, 0), (pad, pad), (pad, pad), (0, 0)))
    ph, pw = h + 2 * pad, w + 2 * pad
    grid = padded.reshape(rows, cols, f, ph, pw, c)
    return grid.transpose(5, 2, 0, 3, 1, 4).reshape(c, f, rows * ph,
                                                    cols * pw)


def extract_topologies(videos: np.ndarray, reference_frame: str,
                       num_frames: int, zero_u_2: float | None,
                       atol: float = 0.02) -> np.ndarray:
    """(n, F, H, W, C) [0, 1] predictions -> (n, H/2, W/2) float topologies
    before cleanup, transposed for Abaqus.

    lagrangian: the upper-left quarter flipped vertically; a pixel is
    material unless its u_2 channel (index 1 of the selected channels) is
    close to the normalised zero displacement in every frame.
    eulerian (or one lagrangian frame): the bottom-left quarter, channel 0
    of frame 0."""
    n, f, h, w, c = videos.shape
    half = h // 2
    if reference_frame == "eulerian" or (reference_frame == "lagrangian"
                                         and num_frames == 1):
        topologies = videos[:, 0, half:, :half, 0]
    elif reference_frame == "lagrangian":
        if zero_u_2 is None:
            raise ValueError("the lagrangian export needs zero_u_2")
        red = videos[:, :, :half, :half, :][:, :, ::-1, :, :]
        close = np.isclose(red[:, :, :, :, 1], zero_u_2, atol=atol)
        topologies = np.logical_not(np.all(close, axis=1)).astype(np.float32)
    else:
        raise ValueError(reference_frame)
    return topologies.transpose(0, 2, 1)


def save_preds(videos: np.ndarray, save_dir: str | Path, selected_channels,
               num_samples: int, reference_frame: str, num_frames: int,
               zero_u_2: float | None) -> Path:
    """videos: (n, F, H, W, C) float in [0, 1], n = num_samples *
    predictions a sample. Returns the path of geometries.csv."""
    save_dir = Path(save_dir)
    (save_dir / "gifs").mkdir(parents=True, exist_ok=True)
    videos = np.asarray(videos)
    grid = make_grid_video(videos, rows=num_samples)
    for j, ch in enumerate(selected_channels):
        array_to_gif(grid[j], save_dir / "gifs" /
                     f"prediction_channel_{ch}.gif")
    topologies = extract_topologies(videos, reference_frame, num_frames,
                                    zero_u_2)
    pixels = topologies.shape[1]
    cleaned = clean_pred(topologies.reshape(len(topologies), -1), pixels)
    np.savetxt(save_dir / "geometries.csv", cleaned, delimiter=",",
               comments="")
    return save_dir / "geometries.csv"
