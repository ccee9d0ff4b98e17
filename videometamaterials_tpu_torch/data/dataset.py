"""The parts of a training data folder the target evaluation reads: the
port's copy of videometamaterials_tpu/data/dataset.py:VideoDataset's labels
(:110-127), physical ranges and zero_u_2 (:170-190) and the
min_max_values.csv it writes (:192-208), as plain functions over the
folder's two CSVs.

Directory contract (the JAX package's):
  <folder>/frame_range_data.csv     per-sample physical ranges (8 columns
                                    lagrangian, 4 eulerian)
  <folder>/stress_strain_data.csv   51-point stress-strain curves
The GIF-folder dataset itself (the videos and their cache) waits for the
training slice.
"""

from __future__ import annotations

import csv
from pathlib import Path

import numpy as np

from videometamaterials_tpu_torch.data.normalization import (
    Normalization,
    interpolate_labels,
)

_RANGE_COLUMNS = {
    # column of frame_range_data.csv -> (name, reduction), in the order of
    # min_max_values.csv
    "lagrangian": (("min_u_1", 0, np.min), ("max_u_1", 1, np.max),
                   ("min_u_2", 2, np.min), ("max_u_2", 3, np.max),
                   ("max_s_mises", 4, np.max), ("min_s_22", 5, np.min),
                   ("max_s_22", 6, np.max), ("max_strain_energy", 7, np.max)),
    "eulerian": (("max_s_mises", 0, np.max), ("min_s_22", 1, np.min),
                 ("max_s_22", 2, np.max), ("max_strain_energy", 3, np.max)),
}


def _csv(path: Path) -> np.ndarray:
    data = np.genfromtxt(path, delimiter=",").astype(np.float64)
    return data[None, :] if data.ndim == 1 else data


def global_ranges(folder: str | Path, reference_frame: str) -> dict:
    """The dataset-global physical extrema of frame_range_data.csv, in the
    order (and with the names) of min_max_values.csv."""
    if reference_frame not in _RANGE_COLUMNS:
        raise ValueError(f"unknown reference_frame: {reference_frame}")
    fr = _csv(Path(folder) / "frame_range_data.csv")
    return {name: reduce(fr[:, col])
            for name, col, reduce in _RANGE_COLUMNS[reference_frame]}


def zero_u_2(ranges: dict) -> float | None:
    """The normalised pixel value of zero vertical displacement, which the
    lagrangian geometry export needs; None for an eulerian folder."""
    if "min_u_2" not in ranges:
        return None
    return float((0.0 - ranges["min_u_2"])
                 / (ranges["max_u_2"] - ranges["min_u_2"]))


def write_min_max_values(folder: str | Path, ranges: dict) -> Path:
    """min_max_values.csv in the JAX package's (the reference's) format."""
    path = Path(folder) / "min_max_values.csv"
    with open(path, "w", newline="") as f:
        csv.writer(f).writerows([[k, float(v)] for k, v in ranges.items()])
    return path


def read_labels(folder: str | Path, num_frames: int,
                per_frame_cond: bool) -> np.ndarray:
    """The folder's raw labels (float32): curves interpolated to the frame
    count with per-frame conditioning, else without their all-zero first
    column."""
    labels = _csv(Path(folder) / "stress_strain_data.csv")
    if per_frame_cond:
        labels = interpolate_labels(labels, num_frames)
    else:
        labels = labels[:, 1:]
    return labels.astype(np.float32)


def fit_labels_scaling(folder: str | Path, num_frames: int,
                       per_frame_cond: bool) -> Normalization:
    """labels_scaling as the JAX trainer fits it on its training folder."""
    return Normalization.fit(read_labels(folder, num_frames, per_frame_cond),
                             strategy="global-min-max-2")
