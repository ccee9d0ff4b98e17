"""Grid GIF cells and Lagrangian -> Eulerian pixel remapping: the port's
copy of the parts of videometamaterials_tpu/postproc/remap.py that the
pixel-estimated stress-strain curve and the remap read (the reference's
src/utils.py:164-307). GIFs go through the port's codec
(`data/gif_io.py`), not PIL or imageio.

  crop_gif / grid_gif_to_array  one 96 x 96 cell of a prediction grid
  remove_artifacts              outliers against the 4-neighbour mean, the
                                reference's in-place scan-order sweep
  smooth_frame                  hole filling, then remove_artifacts
  update_pixel_positions        the displacement scatter (last write wins)
  clear_isolated_pixels         transparent pixels with no opaque
                                neighbour, on RGBA frames
  convert_isolated_pixels_gif   the same on an RGBA GIF file, rewritten
                                in place

Every value written comes from the same mean of the same neighbour list
as the reference, so outputs are bit-identical to the JAX package's.
"""

from __future__ import annotations

import heapq

import numpy as np

from videometamaterials_tpu_torch.data.gif_io import (
    array_to_gif,
    gif_to_array,
    gif_to_rgba,
    rgba_to_gif,
)


def _neighbor_sums_counts(a: np.ndarray):
    """Sum and count of the in-bounds 4-neighbours of every pixel."""
    s = np.zeros(a.shape, np.float64)
    n = np.zeros(a.shape, np.float64)
    af = a.astype(np.float64)
    s[1:, :] += af[:-1, :]
    n[1:, :] += 1
    s[:-1, :] += af[1:, :]
    n[:-1, :] += 1
    s[:, 1:] += af[:, :-1]
    n[:, 1:] += 1
    s[:, :-1] += af[:, 1:]
    n[:, :-1] += 1
    return s, n


def _neighbor_list(image: np.ndarray, i: int, j: int):
    """The reference's neighbour order: up, down, left, right."""
    pixels = len(image)
    neighbors = []
    if i > 0:
        neighbors.append(image[i - 1, j])
    if i < pixels - 1:
        neighbors.append(image[i + 1, j])
    if j > 0:
        neighbors.append(image[i, j - 1])
    if j < pixels - 1:
        neighbors.append(image[i, j + 1])
    return neighbors


def remove_artifacts(image: np.ndarray, threshold: float = 10,
                     check_isolated_pixels: bool = False) -> np.ndarray:
    """Replace pixels that deviate from their 4-neighbour mean by more than
    threshold (with check_isolated_pixels: pixels whose neighbours are all
    zero), as the reference's single in-place scan-order sweep does: the
    candidates of one vectorised pass are judged again in scan order
    against the current image, and each change queues its right and lower
    neighbours. Mutates and returns `image`."""
    pixels = len(image)
    s, n = _neighbor_sums_counts(image)
    img_f = image.astype(np.float64)
    if check_isolated_pixels:
        sa, _ = _neighbor_sums_counts(np.abs(image))
        avg = sa / n
        cand = (np.abs(avg - img_f) > threshold) & (avg < 1e-6)
    else:
        avg = s / n
        cand = (n == 4) & (np.abs(avg - img_f) > threshold)

    heap = [(i, j) for i, j in zip(*np.nonzero(cand))]
    heapq.heapify(heap)
    done = set()
    while heap:
        i, j = heapq.heappop(heap)
        if (i, j) in done:
            continue
        done.add((i, j))
        neighbors = _neighbor_list(image, i, j)
        mutated = False
        if check_isolated_pixels:
            avg_abs = np.mean(np.abs(neighbors))
            if np.abs(avg_abs - image[i, j]) > threshold and avg_abs < 1e-6:
                image[i, j] = avg_abs
                mutated = True
        elif len(neighbors) == 4:
            avg1 = np.mean(neighbors)
            if np.abs(avg1 - image[i, j]) > threshold:
                image[i, j] = avg1
                mutated = True
        if mutated:
            if j + 1 < pixels and (i, j + 1) not in done:
                heapq.heappush(heap, (i, j + 1))
            if i + 1 < pixels and (i + 1, j) not in done:
                heapq.heappush(heap, (i + 1, j))
    return image


def smooth_frame(frame: np.ndarray, neighbors_required: int = 3,
                 recursive: bool = True) -> np.ndarray:
    """Fill zero pixels with the mean of their nonzero 4-neighbours where
    at least neighbors_required are nonzero, in Gauss-Seidel scan-order
    passes until nothing changes (one pass unless recursive), then
    remove_artifacts. Only the remaining zeros are visited in each pass;
    the fill order and values are the reference's."""
    if frame.dtype != np.float64:
        out64 = smooth_frame(frame.astype(np.float64), neighbors_required,
                             recursive)
        return out64.astype(frame.dtype)
    pixels = len(frame)
    grid = frame.tolist()
    zeros = [(int(i), int(j)) for i, j in zip(*np.nonzero(
        np.asarray(grid) == 0.0))]
    update = True
    while update:
        update = False
        still_zero = []
        for (i, j) in zeros:
            nz_sum, nz_cnt = 0.0, 0
            for di, dj in ((-1, 0), (1, 0), (0, -1), (0, 1)):
                ii, jj = i + di, j + dj
                if 0 <= ii < pixels and 0 <= jj < pixels:
                    v = grid[ii][jj]
                    if v != 0.0:
                        nz_sum += v
                        nz_cnt += 1
            if nz_cnt >= neighbors_required:
                avg = nz_sum / nz_cnt
                if avg != grid[i][j]:
                    update = True
                    grid[i][j] = avg
                if grid[i][j] == 0.0:
                    still_zero.append((i, j))
            else:
                still_zero.append((i, j))
        zeros = still_zero
        if not recursive:
            break
    return remove_artifacts(np.asarray(grid, dtype=np.float64))


def update_pixel_positions(shift_x: np.ndarray, shift_y: np.ndarray,
                           pixel_values: np.ndarray,
                           bin_data: np.ndarray) -> np.ndarray:
    """Scatter Lagrangian pixel values to their Eulerian positions, frame
    by frame: x wraps around, y is cut at the frame; where targets collide
    the last source pixel in the reference's (x outer, y inner) order
    wins; each frame is then smoothed (smooth_frame)."""
    frames, pixels, _ = shift_x.shape
    result = np.zeros((frames, pixels, pixels))
    ys, xs = np.mgrid[:pixels, :pixels]
    order = (xs * pixels + ys).ravel()
    sort_idx = np.argsort(order, kind="stable")
    for f in range(frames):
        x_e = (xs + shift_x[f]) % pixels
        y_e = ys - shift_y[f]
        valid = (y_e >= 0) & (y_e < pixels) & (bin_data[f] != 0)
        targets = (y_e.astype(np.int64) * pixels + x_e.astype(np.int64)) \
            .ravel()[sort_idx]
        vals = pixel_values[f].ravel()[sort_idx]
        keep = valid.ravel()[sort_idx]
        targets, vals = targets[keep], vals[keep]
        # last write wins: reverse, keep the first occurrence of a target
        _, first = np.unique(targets[::-1], return_index=True)
        flat = result[f].ravel()
        flat[targets[::-1][first]] = vals[::-1][first]
        result[f] = smooth_frame(flat.reshape(pixels, pixels))
    return result


def clear_isolated_pixels(frames: np.ndarray) -> np.ndarray:
    """RGBA frames (F, H, W, 4) with every opaque pixel that has no opaque
    4-neighbour made transparent (alpha 0). Clearing an isolated pixel
    isolates no other, so one mask a frame is the reference's sweep."""
    out = np.array(frames, copy=True)
    opaque = out[..., 3] != 0
    has = np.zeros_like(opaque)
    has[:, 1:, :] |= opaque[:, :-1, :]
    has[:, :-1, :] |= opaque[:, 1:, :]
    has[:, :, 1:] |= opaque[:, :, :-1]
    has[:, :, :-1] |= opaque[:, :, 1:]
    out[..., 3][opaque & ~has] = 0
    return out


def convert_isolated_pixels_gif(gif_path: str) -> None:
    """Make the isolated pixels of an RGBA GIF transparent and write it
    back (the JAX convert_isolated_pixels_gif, src/utils.py:164-196), read
    and written by the port's RGBA codec."""
    rgba_to_gif(clear_isolated_pixels(gif_to_rgba(gif_path)), gif_path)


def grid_gif_to_array(path: str) -> tuple[np.ndarray, int, int]:
    """A (possibly grid-tiled) prediction GIF as uint8 (F, H, W) and its
    extent in 100-pixel cells."""
    frames = gif_to_array(path)
    tot_rows, tot_cols = frames.shape[1] // 100, frames.shape[2] // 100
    if tot_rows == 0 and tot_cols == 0:
        tot_rows, tot_cols = 1, 1
    if len(frames) != 11:
        print("Warning: Number of frames of provided gif is not 11. This is "
              "likely due to convergence problems in the simulation.")
    if not (tot_rows == 1 and tot_cols == 1):
        frames = frames[:, :100 * tot_rows, :100 * tot_cols]
    return frames, tot_rows, tot_cols


def crop_gif(path: str, row: int, col: int, save: bool = True):
    """One 96 x 96 cell (its 2-pixel pad removed) of a grid GIF; with save,
    written beside it as <name>-<row>-<col>.gif instead of returned."""
    frames, tot_rows, tot_cols = grid_gif_to_array(path)
    if row >= tot_rows or col >= tot_cols:
        raise IndexError(
            f"grid cell ({row},{col}) out of range for a {tot_rows}x"
            f"{tot_cols} prediction grid in {path}")
    if not (tot_rows == 1 and tot_cols == 1):
        frames = frames[:, row * 100:(row + 1) * 100,
                        col * 100:(col + 1) * 100][:, 2:-2, 2:-2]
    elif frames.shape[-1] == 100:
        frames = frames[:, 2:-2, 2:-2]
    if save:
        array_to_gif(np.ascontiguousarray(frames),
                     str(path)[:-4] + f"-{row}-{col}.gif")
        return None
    return frames
