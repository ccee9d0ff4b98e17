"""Column-wise label normalizer (numpy), the port's own copy of
videometamaterials_tpu/data/normalization.py: target curves are normalised
with the checkpoint's `labels_scaling` (`ckpt_cache/*.aux.json`).

Strategies: min-max-1, min-max-2, global-min-max-1, global-min-max-2 (the
stress-strain labels), mean-std (std with ddof=1), none.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

STRATEGIES = ("min-max-1", "min-max-2", "global-min-max-1",
              "global-min-max-2", "mean-std", "none")


@dataclass(frozen=True)
class Normalization:
    mu: np.ndarray
    std: np.ndarray
    min: np.ndarray
    max: np.ndarray
    globalmin: float
    globalmax: float
    strategy: str

    def normalize(self, data):
        s = self.strategy
        if s == "min-max-1":
            return (data - self.min) / (self.max - self.min)
        if s == "min-max-2":
            return 2.0 * (data - self.min) / (self.max - self.min) - 1.0
        if s == "global-min-max-1":
            return (data - self.globalmin) / (self.globalmax - self.globalmin)
        if s == "global-min-max-2":
            return (2.0 * (data - self.globalmin)
                    / (self.globalmax - self.globalmin) - 1.0)
        if s == "mean-std":
            return (data - self.mu) / self.std
        return data

    def unnormalize(self, data):
        s = self.strategy
        if s == "min-max-1":
            return data * (self.max - self.min) + self.min
        if s == "min-max-2":
            return (0.5 * data + 0.5) * (self.max - self.min) + self.min
        if s == "global-min-max-1":
            return data * (self.globalmax - self.globalmin) + self.globalmin
        if s == "global-min-max-2":
            return ((0.5 * data + 0.5) * (self.globalmax - self.globalmin)
                    + self.globalmin)
        if s == "mean-std":
            return data * self.std + self.mu
        return data

    @classmethod
    def from_dict(cls, d: dict) -> "Normalization":
        f32 = np.float32
        return cls(mu=np.asarray(d["mu"], f32), std=np.asarray(d["std"], f32),
                   min=np.asarray(d["min"], f32), max=np.asarray(d["max"], f32),
                   globalmin=float(d["globalmin"]),
                   globalmax=float(d["globalmax"]), strategy=d["strategy"])


def interpolate_labels(labels: np.ndarray, num_frames: int,
                       strain: float = 0.2) -> np.ndarray:
    """51-point curves -> num_frames points, the first evaluation point at
    1% of the maximal strain (the JAX package's data/dataset.py)."""
    given = np.linspace(0.0, strain, num=labels.shape[1])
    eval_pts = np.linspace(0.0, strain, num=num_frames)
    eval_pts[0] = 0.01 * strain
    return np.stack([np.interp(eval_pts, given, row) for row in labels])
