"""Synthetic dataset generator exercising the full directory/CSV/GIF contract
of the reference data layout (SURVEY.md §2 M16) without FEM runs.

Generates GRF-derived periodic unit cells and plausible (not physical)
displacement/stress field videos, then writes:
    <folder>/gifs/{topo,u_1,u_2,s_mises,s_22,ener}/<idx>.gif
    <folder>/frame_range_data.csv
    <folder>/stress_strain_data.csv
Used by tests and the minimum end-to-end training slice (SURVEY.md section
7.2).

The port's copy of videometamaterials_tpu/data/synthetic.py, on the port's
GRF sampler and numpy GIF writer (`gif_io.array_to_gif`, every frame
stored): the same seed gives the same CSVs and GIFs that decode to the
frames the JAX generator writes.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from videometamaterials_tpu_torch.data.gif_io import array_to_gif
from videometamaterials_tpu_torch.fem.grf import generate_geometry


def _write_gif(video01: np.ndarray, path) -> None:
    """video01 (F, H, W) in [0, 1] rounded to uint8, every frame kept (a
    writer that merges identical consecutive frames loses some), as the
    reference data pipeline writes channel GIFs (eval_abaqus.py:128-132)."""
    array_to_gif(np.asarray(video01), path, duration=200)


def make_synthetic_dataset(folder: str | Path, num_samples: int = 8,
                           image_size: int = 24, num_frames: int = 5,
                           num_curve_points: int = 51, seed: int = 0) -> Path:
    folder = Path(folder)
    rng = np.random.default_rng(seed)
    half = image_size // 2

    for name in ("topo", "u_1", "u_2", "s_mises", "s_22", "ener"):
        (folder / "gifs" / name).mkdir(parents=True, exist_ok=True)

    frame_ranges = np.zeros((num_samples, 8))
    curves = np.zeros((num_samples, num_curve_points))
    strains = np.linspace(0, 0.2, num_curve_points)

    for i in range(num_samples):
        # smoother fields at higher resolution keep the boundary/connectivity
        # constraints satisfiable (reference uses alpha=6 at 48px,
        # eval_abaqus.py:22)
        grf_alpha = 3.0 if half <= 16 else 6.0
        quarter = generate_geometry(grf_alpha, half, 0.1, 0.4, rng=rng
                                    ).reshape(half, half)
        # 2-fold mirror to the periodic full cell (abaqus_script.py:302-312)
        top = np.concatenate([quarter, np.flip(quarter, axis=0)], axis=0)
        cell = np.concatenate([top, np.flip(top, axis=1)], axis=1)

        yy, xx = np.mgrid[:image_size, :image_size] / image_size
        t = np.linspace(0, 1, num_frames)[:, None, None]
        stiffness = 0.5 + rng.uniform(0, 1.5)
        u_1 = 0.05 * t * np.sin(2 * np.pi * xx)[None] * cell[None]
        u_2 = -0.2 * t * (1 - yy)[None] * cell[None]
        s_22 = -stiffness * t * (0.5 + 0.5 * np.cos(2 * np.pi * xx))[None] \
            * cell[None]
        s_mises = np.abs(s_22) * (0.8 + 0.4 * yy[None])
        ener = 0.5 * np.abs(s_22) * 0.2 * t

        fields = {"u_1": u_1, "u_2": u_2, "s_mises": s_mises, "s_22": s_22,
                  "ener": ener}
        ranges = [u_1.min(), u_1.max(), u_2.min(), u_2.max(),
                  s_mises.max(), s_22.min(), s_22.max(), ener.max()]
        frame_ranges[i] = ranges

        def norm01(a, lo, hi):
            return (a - lo) / (hi - lo) if hi > lo else np.zeros_like(a)

        _write_gif(np.repeat(cell[None].astype(np.float32), num_frames, 0),
                   folder / "gifs" / "topo" / f"{i}.gif")
        _write_gif(norm01(u_1, ranges[0], ranges[1]),
                     folder / "gifs" / "u_1" / f"{i}.gif")
        _write_gif(norm01(u_2, ranges[2], ranges[3]),
                     folder / "gifs" / "u_2" / f"{i}.gif")
        _write_gif(norm01(s_mises, 0, ranges[4]),
                     folder / "gifs" / "s_mises" / f"{i}.gif")
        _write_gif(norm01(s_22, ranges[5], ranges[6]),
                     folder / "gifs" / "s_22" / f"{i}.gif")
        _write_gif(norm01(ener, 0, ranges[7]),
                     folder / "gifs" / "ener" / f"{i}.gif")

        curves[i] = -stiffness * strains * (1 + 0.5 * strains)

    np.savetxt(folder / "frame_range_data.csv", frame_ranges, delimiter=",")
    np.savetxt(folder / "stress_strain_data.csv", curves, delimiter=",")
    return folder


def make_consistent_dataset(folder: str | Path, num_samples: int = 8,
                            image_size: int = 96, num_frames: int = 11,
                            num_curve_points: int = 51, seed: int = 0,
                            grf_alpha: float = 6.0) -> Path:
    """Synthetic dataset whose s_22 pixel fields are CONSISTENT with the
    conditioning stress-strain curve under the pixel-estimation recipe of
    create_visualization (src/utils.py:396-410):

        est(eps_i) = -mean_allpixels(s22_i) / (1 - eps_i)   (+ linear shift)

    Per sample, the target curve sigma(eps) = k*eps*(1 + c*eps) (positive =
    compressive magnitude, the reference plotting convention) with stiffness
    k tied to the geometry's relative density, and the field is

        s22_i(x, y) = -sigma(eps_i)*(1 - eps_i)/rho * cell(x, y) * (1 + psi)

    where rho = mean(cell) and psi is a zero-cell-mean spatial modulation, so
    mean(s22_i) = -sigma(eps_i)*(1 - eps_i) EXACTLY. A perfectly trained
    model therefore achieves pixel-curve NRMSE ~ the uint8 quantization floor,
    making the NRMSE of generated samples a true conditioning-fidelity
    metric (the quality-demonstration protocol of vddp.py:1674-1753 +
    src/utils.py:94-144, with FEM replaced by the analytic field).

    Frame i corresponds to eps_i = linspace(0, 0.2, num_frames) with
    eps_0 = 0.002 (the 1%-of-strain first eval point, vddp.py:1260-1269)."""
    folder = Path(folder)
    rng = np.random.default_rng(seed)
    half = image_size // 2

    for name in ("topo", "u_1", "u_2", "s_mises", "s_22", "ener"):
        (folder / "gifs" / name).mkdir(parents=True, exist_ok=True)

    frame_ranges = np.zeros((num_samples, 8))
    curves = np.zeros((num_samples, num_curve_points))
    strains51 = np.linspace(0, 0.2, num_curve_points)
    eps = np.linspace(0, 0.2, num_frames)
    eps[0] = 0.01 * 0.2

    yy, xx = np.mgrid[:image_size, :image_size] / image_size

    for i in range(num_samples):
        quarter = generate_geometry(grf_alpha, half, 0.1, 0.4, rng=rng
                                    ).reshape(half, half)
        top = np.concatenate([quarter, np.flip(quarter, axis=0)], axis=0)
        cell = np.concatenate([top, np.flip(top, axis=1)], axis=1
                              ).astype(np.float64)
        rho = cell.mean()

        # stiffness correlates with relative density (the learnable
        # geometry <-> response link); curvature varies independently
        k = 2.5 * rho ** 1.5 * (1.0 + rng.uniform(-0.25, 0.25))
        c = rng.uniform(-1.0, 1.5)
        sigma = k * eps * (1.0 + c * eps)             # (F,) positive

        # zero-cell-mean modulation keeps mean(s22) exact while giving the
        # model a non-trivial spatial field to learn
        psi0 = 0.3 * np.sin(2 * np.pi * xx) * np.sin(2 * np.pi * yy) \
            + 0.15 * np.cos(4 * np.pi * xx)
        psi = psi0 - (cell * psi0).sum() / cell.sum()
        s_22 = (-sigma * (1.0 - eps))[:, None, None] / rho \
            * cell[None] * (1.0 + psi)[None]

        u_1 = (0.3 * eps)[:, None, None] * np.sin(2 * np.pi * xx)[None] \
            * cell[None]
        u_2 = (-eps)[:, None, None] * (1.0 - yy)[None] * cell[None]
        s_mises = np.abs(s_22) * (0.85 + 0.3 * yy[None])
        # cumulative strain-energy density proxy
        dsig = k * strains51 * (1.0 + c * strains51)
        w51 = np.concatenate([[0.0], np.cumsum(
            0.5 * (dsig[1:] + dsig[:-1]) * np.diff(strains51))])
        w_f = np.interp(eps, strains51, w51)
        ener = w_f[:, None, None] * cell[None] * (0.9 + 0.2 * psi)[None]

        ranges = [u_1.min(), u_1.max(), u_2.min(), u_2.max(),
                  s_mises.max(), s_22.min(), s_22.max(), ener.max()]
        frame_ranges[i] = ranges

        def norm01(a, lo, hi):
            return (a - lo) / (hi - lo) if hi > lo else np.zeros_like(a)

        _write_gif(np.repeat(cell[None].astype(np.float32), num_frames, 0),
                   folder / "gifs" / "topo" / f"{i}.gif")
        _write_gif(norm01(u_1, ranges[0], ranges[1]),
                   folder / "gifs" / "u_1" / f"{i}.gif")
        _write_gif(norm01(u_2, ranges[2], ranges[3]),
                   folder / "gifs" / "u_2" / f"{i}.gif")
        _write_gif(norm01(s_mises, 0, ranges[4]),
                   folder / "gifs" / "s_mises" / f"{i}.gif")
        _write_gif(norm01(s_22, ranges[5], ranges[6]),
                   folder / "gifs" / "s_22" / f"{i}.gif")
        _write_gif(norm01(ener, 0, ranges[7]),
                   folder / "gifs" / "ener" / f"{i}.gif")

        curves[i] = k * strains51 * (1.0 + c * strains51)

    np.savetxt(folder / "frame_range_data.csv", frame_ranges, delimiter=",")
    np.savetxt(folder / "stress_strain_data.csv", curves, delimiter=",")
    return folder


def make_consistent_dataset_eulerian(folder: str | Path,
                                     num_samples: int = 8,
                                     image_size: int = 96,
                                     num_frames: int = 11,
                                     num_curve_points: int = 51,
                                     seed: int = 0,
                                     grf_alpha: float = 6.0) -> Path:
    """Eulerian-frame sibling of make_consistent_dataset: fields live in the
    DEFORMED configuration (channels topo/s_mises/s_22/ener, 4-column
    frame_range_data.csv — dataset.py:_EULER_CHANNELS/_compute_global_ranges)
    and the s_22 fields are consistent with the conditioning curve under the
    EULERIAN pixel estimate of create_visualization (src/utils.py:396-403):

        est(eps_i) = -mean_{bottom floor((1-eps_i)*H) rows}(s22_i)

    Per frame the cell is nearest-neighbour squished into the bottom
    window rows (plates compress from the top), and

        s22_i = -sigma(eps_i)/rho_i * topo_i * (1 + psi_i)

    with rho_i = window mean of topo_i and psi_i zero-topo-mean over the
    window, so the window mean of s22_i is EXACTLY -sigma(eps_i)."""
    folder = Path(folder)
    rng = np.random.default_rng(seed)
    half = image_size // 2

    for name in ("topo", "s_mises", "s_22", "ener"):
        (folder / "gifs" / name).mkdir(parents=True, exist_ok=True)

    frame_ranges = np.zeros((num_samples, 4))
    curves = np.zeros((num_samples, num_curve_points))
    strains51 = np.linspace(0, 0.2, num_curve_points)
    eps = np.linspace(0, 0.2, num_frames)
    eps[0] = 0.01 * 0.2

    yy, xx = np.mgrid[:image_size, :image_size] / image_size
    psi0 = 0.3 * np.sin(2 * np.pi * xx) * np.sin(2 * np.pi * yy) \
        + 0.15 * np.cos(4 * np.pi * xx)

    for i in range(num_samples):
        quarter = generate_geometry(grf_alpha, half, 0.1, 0.4, rng=rng
                                    ).reshape(half, half)
        top = np.concatenate([quarter, np.flip(quarter, axis=0)], axis=0)
        cell = np.concatenate([top, np.flip(top, axis=1)], axis=1
                              ).astype(np.float64)

        k = 2.5 * cell.mean() ** 1.5 * (1.0 + rng.uniform(-0.25, 0.25))
        c = rng.uniform(-1.0, 1.5)
        sigma = k * eps * (1.0 + c * eps)             # (F,) positive

        H = image_size
        topo = np.zeros((num_frames, H, H))
        s_22 = np.zeros_like(topo)
        for fi in range(num_frames):
            win = int(np.floor((1.0 - eps[fi]) * H))
            src = np.floor(np.arange(win) * H / win).astype(int)
            topo[fi, H - win:] = cell[src]            # NN vertical squish
            psi_w = psi0[H - win:]
            tw = topo[fi, H - win:]
            psi_w = psi_w - (tw * psi_w).sum() / tw.sum()
            rho = tw.sum() / (win * H)
            s_22[fi, H - win:] = -sigma[fi] / rho * tw * (1.0 + psi_w)

        s_mises = np.abs(s_22) * (0.85 + 0.3 * yy[None])
        dsig = k * strains51 * (1.0 + c * strains51)
        w51 = np.concatenate([[0.0], np.cumsum(
            0.5 * (dsig[1:] + dsig[:-1]) * np.diff(strains51))])
        w_f = np.interp(eps, strains51, w51)
        ener = w_f[:, None, None] * topo * (0.9 + 0.2 * psi0)[None]

        ranges = [s_mises.max(), s_22.min(), s_22.max(), ener.max()]
        frame_ranges[i] = ranges

        def norm01(a, lo, hi):
            return (a - lo) / (hi - lo) if hi > lo else np.zeros_like(a)

        _write_gif(topo, folder / "gifs" / "topo" / f"{i}.gif")
        _write_gif(norm01(s_mises, 0, ranges[0]),
                   folder / "gifs" / "s_mises" / f"{i}.gif")
        _write_gif(norm01(s_22, ranges[1], ranges[2]),
                   folder / "gifs" / "s_22" / f"{i}.gif")
        _write_gif(norm01(ener, 0, ranges[3]),
                   folder / "gifs" / "ener" / f"{i}.gif")

        curves[i] = k * strains51 * (1.0 + c * strains51)

    np.savetxt(folder / "frame_range_data.csv", frame_ranges, delimiter=",")
    np.savetxt(folder / "stress_strain_data.csv", curves, delimiter=",")
    return folder
