"""Geometry cleanup for FEM export: the port's copy of
videometamaterials_tpu/postproc/geometry.py (contract-frozen with the
reference's src/utils.py:11-82).

Binarize a predicted topology with strict thresholds (values of exactly
0.5 pass both and end as 0 through the integer cast), remove speckle
pixels in one scan-order pass that removes in place (so removals cascade
within the pass), and keep the largest 4-connected component:
scipy.ndimage.label with the cross structure labels in raster order, so a
tie keeps the component met first.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage

_CROSS = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]], dtype=bool)


def remove_isolated_pixels(geom: np.ndarray) -> np.ndarray:
    """Scan-order removal of pixels whose 4 neighbours are all void,
    in place on a copy (a removal can isolate a later pixel)."""
    g = geom.copy()
    p = g.shape[0]
    for j in range(p):
        for k in range(p):
            if not g[j, k]:
                continue
            if not ((j != 0 and g[j - 1, k]) or (j != p - 1 and g[j + 1, k])
                    or (k != 0 and g[j, k - 1])
                    or (k != p - 1 and g[j, k + 1])):
                g[j, k] = 0
    return g


def largest_component(geom: np.ndarray) -> np.ndarray:
    """Only the largest 4-connected component (the first on a tie)."""
    labels, num = ndimage.label(geom, structure=_CROSS)
    if num == 0:
        return np.zeros_like(geom)
    counts = np.bincount(labels.ravel())
    counts[0] = 0
    return (labels == counts.argmax()).astype(geom.dtype)


def clean_pred(geom_pred_raw: np.ndarray, pixels: int) -> np.ndarray:
    """(N, pixels*pixels) or (N, pixels, pixels) float predictions ->
    (N, pixels**2) cleaned binary rows."""
    raw = np.array(geom_pred_raw, dtype=np.float64).reshape(-1, pixels, pixels)
    raw[raw < 0.5] = 0
    raw[raw > 0.5] = 1
    geom = raw.astype(int)
    out = np.zeros_like(geom)
    for i in range(geom.shape[0]):
        out[i] = largest_component(remove_isolated_pixels(geom[i]))
    return out.reshape(-1, pixels ** 2)
