"""Gaussian-random-field geometry sampling -- the training-data generator
(abaqus/abq_utils.py:6-68).

A GRF with power-law spectrum is thresholded into a binary pixel geometry;
candidates are rejected until every boundary edge carries at least
`pixel_threshold_rel` solid pixels and the solid phase is 4-connected.

The port's copy of videometamaterials_tpu/fem/grf.py.
"""

from __future__ import annotations

import numpy as np
from scipy import fftpack, ndimage

_CROSS = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]], dtype=bool)


def gaussian_random_field(alpha: float = 1.0, size: int = 128,
                          seed=None, flag_normalize: bool = True,
                          rng: np.random.Generator | None = None) -> np.ndarray:
    if rng is None:
        rng = np.random.default_rng(seed)
    k_ind = np.mgrid[:size, :size] - int((size + 1) / 2)
    k_idx = fftpack.fftshift(k_ind)
    amplitude = np.power(k_idx[0] ** 2 + k_idx[1] ** 2 + 1e-10, -alpha / 4.0)
    amplitude[0, 0] = 0
    noise = rng.normal(size=(size, size)) + 1j * rng.normal(size=(size, size))
    gfield = np.fft.ifft2(noise * amplitude).real
    if flag_normalize:
        gfield = gfield - np.mean(gfield)
        gfield = gfield / np.std(gfield)
    return gfield


def _is_connected(geom: np.ndarray) -> bool:
    _, num = ndimage.label(geom, structure=_CROSS)
    return num == 1


def generate_geometry(grf_alpha: float, pixels: int,
                      pixel_threshold_rel: float, grf_threshold_rel: float,
                      rng: np.random.Generator | None = None,
                      max_tries: int = 10_000) -> np.ndarray:
    """Returns a flattened (pixels**2,) int geometry satisfying the boundary
    and connectivity constraints (abq_utils.py:44-68)."""
    if rng is None:
        rng = np.random.default_rng()
    pixel_threshold = int(pixels * pixel_threshold_rel)
    grf_threshold = rng.uniform() * grf_threshold_rel

    for _ in range(max_tries):
        field = gaussian_random_field(alpha=grf_alpha, size=pixels,
                                      rng=rng).reshape(-1)
        filled = (field > grf_threshold).astype(int)
        geom = filled.reshape(pixels, pixels)
        left = geom[:, 0].sum()
        right = geom[:, -1].sum()
        top = geom[0, :].sum()
        bottom = geom[-1, :].sum()
        if min(left, right, top, bottom) >= pixel_threshold and \
                geom.any() and _is_connected(geom):
            return filled
    raise RuntimeError("could not generate a valid geometry")
