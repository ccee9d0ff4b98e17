"""matplotlib's "jet" colour map as a (256, 4) uint8 table, without
matplotlib.

`JET_RGBA[level]` is the JAX renderer's
`(plt.get_cmap("jet")(level) * 255).astype(np.uint8)` for uint8 levels:
integer input indexes matplotlib's 256-entry lookup table directly, and the
x255 is truncated. The table is generated at import from the segments of
matplotlib's `_jet_data` with the arithmetic of its
`colors._create_lookup_table` (float64 linear interpolation between the
segment points, clipped to [0, 1]).
"""

from __future__ import annotations

import numpy as np

# matplotlib/_cm.py: _jet_data, (x, y0, y1) per channel
_JET_SEGMENTS = {
    "red": ((0.00, 0, 0), (0.35, 0, 0), (0.66, 1, 1), (0.89, 1, 1),
            (1.00, 0.5, 0.5)),
    "green": ((0.000, 0, 0), (0.125, 0, 0), (0.375, 1, 1), (0.640, 1, 1),
              (0.910, 0, 0), (1.000, 0, 0)),
    "blue": ((0.00, 0.5, 0.5), (0.11, 1, 1), (0.34, 1, 1), (0.65, 0, 0),
             (1.00, 0, 0)),
}


def _lookup_table(n: int, segments) -> np.ndarray:
    """matplotlib's _create_lookup_table(n, segments) with gamma 1."""
    data = np.array(segments, dtype=float)
    x, y0, y1 = data[:, 0] * (n - 1), data[:, 1], data[:, 2]
    xind = (n - 1) * np.linspace(0, 1, n)
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.concatenate([[y1[0]],
                          distance * (y0[ind] - y1[ind - 1]) + y1[ind - 1],
                          [y0[-1]]])
    return np.clip(lut, 0.0, 1.0)


def _jet_rgba(n: int = 256) -> np.ndarray:
    rgba = np.ones((n, 4))
    for i, channel in enumerate(("red", "green", "blue")):
        rgba[:, i] = _lookup_table(n, _JET_SEGMENTS[channel])
    return (rgba * 255).astype(np.uint8)


JET_RGBA = _jet_rgba()
JET_RGBA.flags.writeable = False
