"""Abaqus FEM verification wrapper (out-of-process side stack).

Re-design of the reference eval_abaqus.py:8-140: pick a geometry row from
geometries.csv (or sample a fresh GRF geometry), launch Abaqus CAE in noGUI
mode on the model-builder script, then convert the per-frame field CSVs the
solver wrote into channel GIFs + frame_range.csv -- the exact artifact set the
visualization and dataset tooling consume.

Abaqus itself is an external commercial solver; this module only shells out
to it (`abaqus cae noGUI=...`) and post-processes its CSVs, so everything here
runs (and is tested) without Abaqus except the actual subprocess call.

The port's copy of videometamaterials_tpu/fem/eval_abaqus.py: the command
runs the port's builder (fem/abaqus_model.py beside this file), and the
GIFs are written by the port's numpy GIF writer (`data/gif_io.array_to_gif`,
every frame stored, duplicates included) instead of imageio.
"""

from __future__ import annotations

import os
import subprocess
from pathlib import Path

import numpy as np

from videometamaterials_tpu_torch.data.gif_io import array_to_gif

_EULER_FIELDS = ("geometry", "s_mises", "s_22", "strain_energy_dens")
_LAGR_FIELDS = ("u_1", "u_2", "s_mises", "s_22", "strain_energy_dens")


def abaqus_command(script_path: str | Path, samples_path: str | Path,
                   sample_index: int, store_frames: bool,
                   pixels: int, **extra) -> str:
    """Build the `abaqus cae noGUI=...` command line. Extra keyword args
    (solver, material, y_periodicity, bounding_box, radius, splined, ...)
    pass through as --key value flags (the reference keeps these as in-file
    toggles, abaqus_script.py:49-59)."""
    cmd = ("abaqus cae noGUI={} -- --samples_path {} --sample_index {} "
           "--store_frames {} --pixels {}".format(
               script_path, samples_path, sample_index, store_frames,
               pixels))
    for key, value in sorted(extra.items()):
        cmd += " --{} {}".format(key, value)
    return cmd


def convert_frames_to_gifs(csv_dir: str | Path, gif_dir: str | Path,
                           reference_frame: str = "eulerian",
                           pixels: int = 96, num_frames: int = 11) -> Path:
    """CSV per-frame fields -> channel GIFs + frame_range.csv
    (eval_abaqus.py:57-135)."""
    csv_dir, gif_dir = Path(csv_dir), Path(gif_dir)
    gif_dir.mkdir(parents=True, exist_ok=True)
    suffix = "eul" if reference_frame == "eulerian" else "lagr"

    if reference_frame == "eulerian":
        fields = {name: np.genfromtxt(
            csv_dir / f"{_map_csv_name(name)}_frames_{suffix}.csv",
            delimiter=",").reshape(-1, pixels, pixels)
            for name in _EULER_FIELDS}
        rng = [fields["s_mises"].max(), fields["s_22"].min(),
               fields["s_22"].max(), fields["strain_energy_dens"].max()]
        header = ["max_s_mises", "min_s_22", "max_s_22", "max_strain_energy"]
        chans = [fields["geometry"],
                 fields["s_mises"] / rng[0] if rng[0] else fields["s_mises"],
                 _norm(fields["s_22"], rng[1], rng[2]),
                 fields["strain_energy_dens"] / rng[3] if rng[3]
                 else fields["strain_energy_dens"]]
    else:
        fields = {name: np.genfromtxt(
            csv_dir / f"{name}_frames_{suffix}.csv",
            delimiter=",").reshape(-1, pixels, pixels)
            for name in _LAGR_FIELDS}
        rng = [fields["u_1"].min(), fields["u_1"].max(),
               fields["u_2"].min(), fields["u_2"].max(),
               fields["s_mises"].max(), fields["s_22"].min(),
               fields["s_22"].max(), fields["strain_energy_dens"].max()]
        header = ["min_u_1", "max_u_1", "min_u_2", "max_u_2", "max_s_mises",
                  "min_s_22", "max_s_22", "max_strain_energy"]
        chans = [_norm(fields["u_1"], rng[0], rng[1]),
                 _norm(fields["u_2"], rng[2], rng[3]),
                 fields["s_mises"] / rng[4] if rng[4] else fields["s_mises"],
                 _norm(fields["s_22"], rng[5], rng[6])]

    for j, chan in enumerate(chans):
        frames = np.stack([(np.clip(chan[k], 0, 1) * 255).astype(np.uint8)
                           for k in range(min(num_frames, len(chan)))])
        array_to_gif(frames, gif_dir / f"prediction_channel_{j}.gif",
                     duration=200)
    np.savetxt(gif_dir / "frame_range.csv", np.array([rng]), delimiter=",",
               comments="", header=",".join(header))
    return gif_dir


def _map_csv_name(name: str) -> str:
    return name


def _norm(a, lo, hi):
    return (a - lo) / (hi - lo) if hi > lo else np.zeros_like(a)


def evaluate_sample(samples_path: str | Path, sample_index: int = 0,
                    sample_grf: bool = False, create_gifs: bool = True,
                    gif_reference_frame: str = "eulerian",
                    pixels: int = 48, script_path: str | Path | None = None,
                    abaqus_runner=None):
    """Main flow of the reference eval_abaqus.py. `abaqus_runner` is
    injectable for tests (defaults to a shell call)."""
    samples_path = Path(samples_path)

    if sample_grf:
        from videometamaterials_tpu_torch.fem.grf import generate_geometry
        geom = generate_geometry(6, pixels, 0.1, 0.5)
        samples_path = Path("grf_sample")
        sample_index = 0
        samples_path.mkdir(parents=True, exist_ok=True)
        np.savetxt(samples_path / "geometries.csv", geom[None], delimiter=",")
    else:
        assert (samples_path / "geometries.csv").is_file(), \
            "geometries.csv not found in samples_path"

    abaqus_path = samples_path / f"abaqus_eval_sample_{sample_index}"
    abaqus_path.mkdir(parents=True, exist_ok=True)

    if script_path is None:
        script_path = Path(__file__).parent / "abaqus_model.py"
    rel_samples = os.path.relpath(samples_path, abaqus_path)
    cmd = abaqus_command(script_path, rel_samples, sample_index,
                         create_gifs, pixels)

    if abaqus_runner is None:
        subprocess.run(cmd, shell=True, cwd=abaqus_path, check=False)
    else:
        abaqus_runner(cmd, abaqus_path)
    print("abaqus simulation finished")

    if create_gifs:
        csv_dir = abaqus_path / "csv"
        probe = csv_dir / "geometry_frames_eul.csv"
        if probe.is_file():
            gif_dir = convert_frames_to_gifs(
                csv_dir, abaqus_path / "gif",
                reference_frame=gif_reference_frame, pixels=2 * pixels)
            print("gif creation successful")
            return gif_dir
        print("gif creation not successful")
    return None
