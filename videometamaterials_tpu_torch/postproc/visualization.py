"""Publication rendering of a prediction grid cell: the port's copy of
videometamaterials_tpu/postproc/visualization.py (the reference's
src/utils.py:309-486), with numpy and the standard library only (no
matplotlib, imageio or Pillow):

  strain_schedule         per-frame strains (1% of the strain first)
  load_frame_ranges       the global ranges the fields were normalised with
  reconstruct_topology    the solid mask from near-zero-u2 pixels
  reconstruct_topology_robust  the temporal-contrast fallback mask
  estimate_stress_strain  the pixel-estimated response curve
  load_cell_fields        one cell's physical fields and solid mask
  quantize_levels         a physical field as uint8 colour-map levels
  render_rgba_gif         jet-coloured RGBA GIF with transparency and the
                          grey compression box (`data/gif_io.rgba_to_gif`)
  legend_ticks            the colour bar's tick values
  create_visualization    the artifact set of one cell

The GIFs carry the JAX renderer's colours (matplotlib's jet,
`postproc/colormap.py`) and transparency; the JAX renderer's own GIF is
quantised by Pillow, which moves colours, so the two files' alpha agrees
exactly and their colours within Pillow's quantisation. The legend PNG has
the jet strip (hi at the top) and matplotlib's tick values, drawn with a
small built-in bitmap font: it is not pixel-equal to matplotlib's figure
(no anti-aliased text; labels in fixed point, where matplotlib switches to
an offset or an exponent for very large or small ranges).
"""

from __future__ import annotations

import math
import os

import numpy as np

from videometamaterials_tpu_torch.data.gif_io import rgba_to_gif, write_png
from videometamaterials_tpu_torch.postproc.colormap import JET_RGBA
from videometamaterials_tpu_torch.postproc.remap import (
    convert_isolated_pixels_gif,
    crop_gif,
    remove_artifacts,
    update_pixel_positions,
)


def _norm(arr, lo, hi):
    return (arr - lo) / (hi - lo)


def _unnorm(arr, lo, hi):
    return arr * (hi - lo) + lo


def strain_schedule(num_frames: int, strain: float = 0.2) -> np.ndarray:
    """Per-frame strains: linspace with the first point at 1% of the
    strain."""
    s = np.linspace(0.0, strain, num=num_frames)
    s[0] = 0.01 * strain
    return s


def load_frame_ranges(frame_ranges: str, ref_frame: str):
    """frame_range_data.csv reduced to the global ranges: (u_ranges | None,
    (s22_min, s22_max)), u_ranges = (min_u_1, max_u_1, min_u_2, max_u_2)
    in the lagrangian frame."""
    fr = np.genfromtxt(frame_ranges, delimiter=",")
    if fr.ndim == 1:
        # a single row is used as it is (a trailing delimiter gives a NaN
        # column)
        fr = fr[None, :]
    else:
        fr = fr[~np.isnan(fr).any(axis=1)]   # trailing blank lines
    u_ranges = None
    if ref_frame == "lagrangian":
        u_ranges = (fr[:, 0].min(), fr[:, 1].max(),
                    fr[:, 2].min(), fr[:, 3].max())
        fr = fr[:, -4:]
    return u_ranges, (np.min(fr[:, 1]), np.max(fr[:, 2]))


def _mirror(quarter: np.ndarray) -> np.ndarray:
    half = np.concatenate([quarter, np.flip(quarter, axis=0)], axis=0)
    return np.concatenate([half, np.flip(half, axis=1)], axis=1)


def reconstruct_topology(u2_uint8: np.ndarray, min_u_2: float,
                         max_u_2: float, atol: float = 0.02) -> np.ndarray:
    """Solid mask: a pixel of the upper-left quarter is solid iff its
    normalised u2 leaves the normalised physical zero (within atol) in any
    frame; the quarter mirrored twofold."""
    zero_u_2 = _norm(np.zeros(1), min_u_2, max_u_2)
    pixels = u2_uint8.shape[-1]
    u2_red = _norm(u2_uint8[:, :pixels // 2, :pixels // 2], 0, 255)
    close = np.isclose(u2_red, zero_u_2, atol=atol)
    return _mirror(np.logical_not(np.all(close, axis=0)).astype(float))


def reconstruct_topology_robust(u2_uint8: np.ndarray) -> np.ndarray:
    """Solid mask by temporal contrast: a pixel of the upper-left quarter
    is solid iff its u2 range over the frames exceeds the midpoint of the
    20th and 80th percentiles of the ranges; all solid when that spread is
    under 5 levels."""
    pixels = u2_uint8.shape[-1]
    q = u2_uint8[:, :pixels // 2, :pixels // 2].astype(np.float64)
    rng = q.max(axis=0) - q.min(axis=0)
    p20, p80 = np.percentile(rng, (20.0, 80.0))
    if p80 - p20 < 5.0:
        return np.ones((pixels, pixels))
    return _mirror((rng > 0.5 * (p20 + p80)).astype(float))


def estimate_stress_strain(pred_phys: np.ndarray,
                           ref_frame: str) -> tuple[np.ndarray, np.ndarray]:
    """(strains, curve) from the physical s22 field (F, H, W) with void
    pixels zeroed: the mean sigma_22 a frame with the nominal-stress
    correction 1 / (1 - strain) (lagrangian) or over the compressed window
    (eulerian), shifted to pass the line through its first two points
    through zero."""
    frames = len(pred_phys)
    strain_list = strain_schedule(frames)
    if ref_frame == "eulerian":
        curve = np.empty(frames)
        for i in range(frames):
            top_row = int(np.floor((1.0 - strain_list[i])
                                   * pred_phys.shape[-1]))
            curve[i] = -np.mean(pred_phys[i, -top_row:, :])
    else:
        curve = -pred_phys.mean(axis=(1, 2)) / (1.0 - strain_list)
    shift = curve[0] - ((curve[1] - curve[0])
                        / (strain_list[1] - strain_list[0])) * strain_list[0]
    return strain_list, curve - shift


def load_cell_fields(path: str, frame_ranges: str, row: int, col: int,
                     ref_frame: str, atol: float = 0.02,
                     topo_mode: str = "auto") -> dict:
    """One grid cell's fields: 's22' (physical sigma_22, void pixels
    zeroed), 'mask' (F, H, W solid), 's22_range', and 'mask255'
    (eulerian) or the integer pixel shifts 'shift_x', 'shift_y'
    (lagrangian). topo_mode (lagrangian): 'reference' the zero-u2 rule,
    'robust' the temporal-contrast rule, 'auto' the reference rule unless
    it finds more than 90% solid."""
    s_22_idx = 2 if ref_frame == "eulerian" else 3
    u_ranges, (s22_min, s22_max) = load_frame_ranges(frame_ranges, ref_frame)
    pred = crop_gif(path + f"prediction_channel_{s_22_idx}.gif", row, col,
                    save=False)
    out = {"s22_range": (s22_min, s22_max)}
    if ref_frame == "eulerian":
        mask255 = crop_gif(path + "prediction_channel_0.gif", row, col,
                           save=False)
        mask = (mask255 >= 255 / 2)
        out["mask255"] = mask255
    else:
        min_u_1, max_u_1, min_u_2, max_u_2 = u_ranges
        u1_uint8 = crop_gif(path + "prediction_channel_0.gif", row, col,
                            save=False)
        u2_uint8 = crop_gif(path + "prediction_channel_1.gif", row, col,
                            save=False)
        topo = reconstruct_topology(u2_uint8, min_u_2, max_u_2, atol)
        if topo_mode == "robust" or (topo_mode == "auto"
                                     and topo.mean() > 0.9):
            topo = reconstruct_topology_robust(u2_uint8)
        mask = np.repeat(topo[None].astype(bool), len(u2_uint8), axis=0)
        u_1 = _unnorm(_norm(u1_uint8, 0, 255), min_u_1, max_u_1)
        u_2 = _unnorm(_norm(u2_uint8, 0, 255), min_u_2, max_u_2)
        out["shift_x"] = np.round(u_1 * 96).astype(int)
        out["shift_y"] = np.round(u_2 * 96).astype(int)
    pred = _unnorm(_norm(pred, 0.0, 255.0), s22_min, s22_max)
    pred[~mask] = 0
    out["s22"] = pred
    out["mask"] = mask
    return out


# ------------------------------------------------------------ rendering


def quantize_levels(field_phys: np.ndarray, lo: float, hi: float,
                    zero_mask: np.ndarray | None = None) -> np.ndarray:
    """A physical field as uint8 colour-map levels over [lo, hi]
    (src/utils.py:429-434), `zero_mask` pixels zeroed after the
    quantisation, as the reference does."""
    level = np.round(_unnorm(_norm(field_phys, lo, hi), 0.0, 255.0)) \
        .astype(np.uint8)
    if zero_mask is not None:
        level[zero_mask] = 0
    return level


def render_rgba_gif(levels: np.ndarray, transparent_mask: np.ndarray,
                    out_path: str,
                    compression_box: np.ndarray | None = None) -> np.ndarray:
    """Jet-colour (F, H, W) uint8 levels into an RGBA GIF: `transparent_mask`
    pixels get alpha 0, and with `compression_box` the top
    compression_box[f] rows of frame f are painted grey (227, 227, 227)
    (src/utils.py:436-466). Returns the RGBA video that was written."""
    color = JET_RGBA[levels]
    color[transparent_mask, 3] = 0
    if compression_box is not None:
        rows = np.arange(color.shape[1])
        box = rows[None, :] < np.asarray(compression_box)[:, None]   # (F, H)
        color[box] = np.array([227, 227, 227, 255], np.uint8)
    rgba_to_gif(color, out_path)
    return color


# ----------------------------------------------------------- the legend


def _nonsingular(vmin: float, vmax: float, expander: float = 1e-13,
                 tiny: float = 1e-14) -> tuple[float, float]:
    """matplotlib.transforms.nonsingular for finite limits."""
    swapped = vmax < vmin
    if swapped:
        vmin, vmax = vmax, vmin
    maxabs = max(abs(vmin), abs(vmax))
    if maxabs < (1e6 / tiny) * np.finfo(float).tiny:
        vmin, vmax = -expander, expander
    elif vmax - vmin <= maxabs * tiny:
        if vmax == 0 and vmin == 0:
            vmin, vmax = -expander, expander
        else:
            vmin -= expander * abs(vmin)
            vmax += expander * abs(vmax)
    return (vmax, vmin) if swapped else (vmin, vmax)


def _edge_le(x: float, step: float) -> float:
    d, m = divmod(x, step)
    return d + 1 if abs(m / step - 1) < 1e-10 else d


def _edge_ge(x: float, step: float) -> float:
    d, m = divmod(x, step)
    return d if abs(m / step) < 1e-10 else d + 1


def legend_ticks(lo: float, hi: float) -> np.ndarray:
    """The colour bar's tick values, what matplotlib's `cb.get_ticks()`
    gives for the JAX legend: on that 30-inch axis its AutoLocator is
    MaxNLocator(nbins=9, steps=[1, 2, 2.5, 5, 10]) with at least 2 ticks
    in range; the values may reach past [lo, hi] by one step (those are
    not drawn). For a range about zero, as the legend's (lo = -hi):
    there matplotlib's scale_range takes no offset."""
    nbins, min_ticks = 9, 2
    vmin, vmax = _nonsingular(float(lo), float(hi))
    scale = 10 ** (math.log10(abs(vmax - vmin) / nbins) // 1)
    base = np.array([1, 2, 2.5, 5, 10])
    steps = np.concatenate([0.1 * base[:-1], base, [10 * base[1]]]) * scale
    raw_step = (vmax - vmin) / nbins
    large = np.nonzero(steps >= raw_step)[0]
    istep = large[0] if len(large) else len(steps) - 1
    for step in steps[:istep + 1][::-1]:
        best_vmin = (vmin // step) * step
        low = _edge_le(vmin - best_vmin, step)
        high = _edge_ge(vmax - best_vmin, step)
        ticks = np.arange(low, high + 1) * step + best_vmin
        if ((ticks <= vmax) & (ticks >= vmin)).sum() >= min_ticks:
            break
    return ticks


# 5 x 7 glyphs, '#' on; 'o' is sigma
_GLYPHS = {
    "0": (".###.", "#...#", "#..##", "#.#.#", "##..#", "#...#", ".###."),
    "1": ("..#..", ".##..", "..#..", "..#..", "..#..", "..#..", ".###."),
    "2": (".###.", "#...#", "....#", "...#.", "..#..", ".#...", "#####"),
    "3": ("#####", "...#.", "..#..", "...#.", "....#", "#...#", ".###."),
    "4": ("...#.", "..##.", ".#.#.", "#..#.", "#####", "...#.", "...#."),
    "5": ("#####", "#....", "####.", "....#", "....#", "#...#", ".###."),
    "6": ("..##.", ".#...", "#....", "####.", "#...#", "#...#", ".###."),
    "7": ("#####", "....#", "...#.", "..#..", ".#...", ".#...", ".#..."),
    "8": (".###.", "#...#", "#...#", ".###.", "#...#", "#...#", ".###."),
    "9": (".###.", "#...#", "#...#", ".####", "....#", "...#.", ".##.."),
    "-": (".....", ".....", ".....", "#####", ".....", ".....", "....."),
    ".": (".....", ".....", ".....", ".....", ".....", ".##..", ".##.."),
    "o": (".....", ".....", ".####", "#..#.", "#...#", "#...#", ".###."),
}


def _draw_text(img: np.ndarray, text: str, x: int, y: int, px: int,
               sub: str = "") -> int:
    """Draw `text` (then `sub` at 3/5 size, lowered) in black with its
    top-left corner at (x, y), `px` image pixels a glyph pixel; returns the
    x after it."""
    for chars, size, dy in ((text, px, 0), (sub, max(1, px * 3 // 5),
                                            px * 4)):
        for ch in chars:
            glyph = np.array([[c == "#" for c in row] for row in _GLYPHS[ch]])
            mask = np.kron(glyph, np.ones((size, size), bool))
            h, w = mask.shape
            img[y + dy:y + dy + h, x:x + w][mask] = (0, 0, 0, 255)
            x += w + size
    return x


def _label(value: float, decimals: int) -> str:
    text = f"{value:.{decimals}f}"
    return "0" + text[2:] if text.startswith("-0") and float(text) == 0 \
        else text


def _write_legend(save_path: str, lo: float, hi: float) -> np.ndarray:
    """visualization_legend.png: the jet strip from hi (top) to lo (bottom),
    a tick and a label at each of matplotlib's tick values in range, and
    the sigma_22 label; white background. Returns the tick values (the
    PNG's tEXt 'ticks' lists them too)."""
    ticks = legend_ticks(lo, hi)
    shown = ticks[(ticks >= min(lo, hi)) & (ticks <= max(lo, hi))]
    step = ticks[1] - ticks[0] if len(ticks) > 1 else 1.0
    decimals = next(d for d in range(12) if abs(round(step, d) - step)
                    <= 1e-9 * abs(step))
    strip_h, strip_w, top, left, px = 1024, 48, 40, 20, 3
    img = np.full((strip_h + 2 * top, 360, 4), 255, np.uint8)
    levels = 255 - (np.arange(strip_h) * 256) // strip_h        # hi on top
    img[top:top + strip_h, left:left + strip_w] = JET_RGBA[levels][:, None]
    img[top - 1, left - 1:left + strip_w + 1] = (0, 0, 0, 255)
    img[top + strip_h, left - 1:left + strip_w + 1] = (0, 0, 0, 255)
    img[top - 1:top + strip_h + 1, left - 1] = (0, 0, 0, 255)
    img[top - 1:top + strip_h + 1, left + strip_w] = (0, 0, 0, 255)
    label_x = left + strip_w + 14
    right = label_x
    for v in shown:
        y = top + int(round((hi - v) / (hi - lo) * (strip_h - 1)))
        img[y, left + strip_w:left + strip_w + 8] = (0, 0, 0, 255)
        right = max(right, _draw_text(img, _label(v, decimals), label_x,
                                      y - 7 * px // 2, px))
    _draw_text(img, "o", right + 4 * px, top + strip_h // 2 - 7 * px, 2 * px,
               sub="22")
    write_png(save_path + "visualization_legend.png", img,
              text={"ticks": ",".join(repr(float(t)) for t in ticks)})
    return ticks


def create_visualization(path: str, frame_ranges: str, row: int, col: int,
                         ref_frame: str, atol: float = 0.02,
                         disp_compression: bool = True) -> str:
    """The artifact set of one grid cell under <path>visualization_<row>-
    <col>/ (src/utils.py:309-486): stress_strain_estimate.csv,
    visualization.gif, visualization_conv_euler.gif (the remapped eulerian
    view, lagrangian frame only) and visualization_legend.png. `path` ends
    with a separator, as the JAX function takes it."""
    fields = load_cell_fields(path, frame_ranges, row, col, ref_frame, atol)
    save_path = path + f"visualization_{row}-{col}/"
    os.makedirs(save_path, exist_ok=True)

    strain_list, curve = estimate_stress_strain(fields["s22"], ref_frame)
    np.savetxt(save_path + "stress_strain_estimate.csv",
               np.stack([strain_list, curve], axis=1), delimiter=",",
               header="strain,pred_pixel_shifted", comments="")

    # the eulerian remap runs in physical space, before the quantisation
    # (src/utils.py:370-380)
    if ref_frame == "lagrangian":
        bin_l = fields["mask"].astype(float)
        bin_euler = update_pixel_positions(fields["shift_x"],
                                           fields["shift_y"], bin_l, bin_l)
        pred_euler = update_pixel_positions(fields["shift_x"],
                                            fields["shift_y"],
                                            fields["s22"], bin_l)
        pred_euler[bin_euler == 0] = 0

    # a colour range symmetric about the largest |s22| of the ranges
    lo, hi = fields["s22_range"]
    hi = max(abs(lo), abs(hi))
    lo = -hi

    level = quantize_levels(fields["s22"], lo, hi, zero_mask=~fields["mask"])
    if ref_frame == "eulerian":
        # transparent only where the mask channel is exactly 0
        # (src/utils.py:466: == 0, not the < 127.5 threshold of the mask)
        box = None
        if disp_compression:
            box = np.asarray([round(s * level.shape[1])
                              for s in strain_list])
        render_rgba_gif(level, fields["mask255"] == 0,
                        save_path + "visualization.gif", compression_box=box)
    else:
        render_rgba_gif(level, ~fields["mask"],
                        save_path + "visualization.gif")
        # quantise, zero the void, then remove artifacts on the uint8
        # levels (src/utils.py:420-427)
        level_e = quantize_levels(pred_euler, lo, hi,
                                  zero_mask=(bin_euler == 0))
        for f in range(len(level_e)):
            level_e[f] = remove_artifacts(level_e[f],
                                          check_isolated_pixels=True)
        box_e = None
        if disp_compression:
            box_e = np.asarray([round(s * level_e.shape[1])
                                for s in strain_list])
        euler_path = save_path + "visualization_conv_euler.gif"
        render_rgba_gif(level_e, bin_euler == 0, euler_path,
                        compression_box=box_e)
        convert_isolated_pixels_gif(euler_path)

    _write_legend(save_path, lo, hi)
    return save_path
