"""PyTorch port, the FEM-verification stack on the CPU, against the JAX
package's framework-free modules: the GRF geometry sampler on the same
seeds, the sketch plans of random 4-connected geometries, the in-Abaqus
builder run end to end under tests/abq_stub.py (the same recorded calls
and the same CSVs as the JAX builder on the same geometry, for the
implicit, static and explicit solvers), the CSV -> GIF conversion and the
wrapper flow with an injected Abaqus, the best-of-N metrics (NaN
positions included), and a Python-2 lint of the modules Abaqus imports
and of every __init__.py on their route."""

import ast
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest

from tests.abq_stub import install, make_fake_odb, make_structured_mesh
from videometamaterials_tpu.fem import eval_abaqus as j_eval
from videometamaterials_tpu.fem import grf as j_grf
from videometamaterials_tpu.fem import part_geometry as j_part
from videometamaterials_tpu.fem import timepoints as j_time
from videometamaterials_tpu.postproc import metrics as j_metrics
from videometamaterials_tpu_torch import eval_abaqus as cli
from videometamaterials_tpu_torch.data.gif_io import gif_to_array
from videometamaterials_tpu_torch.fem import eval_abaqus, grf, part_geometry
from videometamaterials_tpu_torch.fem import timepoints
from videometamaterials_tpu_torch.postproc import metrics

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "videometamaterials_tpu_torch"
BUILDERS = {"jax": ROOT / "videometamaterials_tpu" / "fem" / "abaqus_model.py",
            "port": PORT / "fem" / "abaqus_model.py"}
# what Abaqus CAE's Python 2.7 imports: the builder, its two modules and
# the package __init__ files on their import route
ABAQUS_ROUTE = [PORT / "__init__.py", PORT / "fem" / "__init__.py",
                PORT / "fem" / "abaqus_model.py",
                PORT / "fem" / "part_geometry.py",
                PORT / "fem" / "timepoints.py"]


@pytest.mark.parametrize("alpha,size,seed", [(4.0, 32, 1), (6.0, 48, 2),
                                             (3.0, 12, 3)])
def test_grf_is_the_jax_grf(alpha, size, seed):
    np.testing.assert_array_equal(
        grf.gaussian_random_field(alpha, size, seed=seed),
        j_grf.gaussian_random_field(alpha, size, seed=seed))
    np.testing.assert_array_equal(
        grf.generate_geometry(alpha, size, 0.1, 0.4,
                              rng=np.random.default_rng(seed)),
        j_grf.generate_geometry(alpha, size, 0.1, 0.4,
                                rng=np.random.default_rng(seed)))


def _assert_same_tree(a, b, where="plan"):
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), where
        for k in a:
            _assert_same_tree(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same_tree(x, y, f"{where}[{i}]")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=where)


@pytest.mark.parametrize("splined,radius", [(True, 0.0), (False, 0.0),
                                            (False, 0.01)])
def test_sketch_plans_equal_jax(splined, radius):
    """Random 4-connected geometries (the GRF sampler's), the bounding box
    and the periodic mirror, then the sketch plan."""
    rng = np.random.default_rng(4)
    for pixels in (6, 8, 8, 10, 12):
        quarter = j_grf.generate_geometry(3.0, pixels, 0.1, 0.4, rng=rng
                                          ).reshape(pixels, pixels)
        for geom in (quarter, j_part.apply_bounding_box(quarter)):
            np.testing.assert_array_equal(
                part_geometry.apply_bounding_box(geom),
                j_part.apply_bounding_box(geom))
            cell = j_part.mirror_periodic(geom)
            np.testing.assert_array_equal(
                part_geometry.mirror_periodic(geom), cell)
            try:
                want = j_part.sketch_plan(cell, splined=splined,
                                          radius=radius)
            except ValueError as err:          # 'Radius too large'
                with pytest.raises(ValueError, match=str(err)[:20]):
                    part_geometry.sketch_plan(cell, splined=splined,
                                              radius=radius)
                continue
            _assert_same_tree(
                part_geometry.sketch_plan(cell, splined=splined,
                                          radius=radius), want)


def test_timepoints_are_the_jax_timepoints():
    assert timepoints.FIELD_TIME_POINTS == j_time.FIELD_TIME_POINTS
    assert timepoints.HISTORY_TIME_POINTS == j_time.HISTORY_TIME_POINTS
    assert len(timepoints.FIELD_TIME_POINTS) == 11
    assert len(timepoints.HISTORY_TIME_POINTS) == 52


def _run_builder(which, root, monkeypatch, geom, extra):
    nodes, elements = make_structured_mesh(4)
    odb = make_fake_odb(nodes, elements)
    log, _ = install(monkeypatch, (nodes, elements), odb)
    root.mkdir()
    pixels = geom.shape[0]
    np.savetxt(root / "geometries.csv", geom.reshape(1, -1), delimiter=",")
    monkeypatch.setattr(sys, "argv", [
        "abaqus_model.py", "--samples_path", str(root), "--sample_index",
        "0", "--pixels", str(pixels), *extra])
    runpy.run_path(str(BUILDERS[which]), run_name="__abaqus_stub_run__")
    csv = root / "abaqus_eval_sample_0" / "csv"
    return log.names(), {p.name: p.read_bytes()
                         for p in sorted(csv.iterdir())}


@pytest.mark.parametrize("extra", [
    (), ("--store_frames", "True"), ("--solver", "static"),
    ("--solver", "explicit", "--splined", "False", "--radius", "0.02")])
def test_builder_makes_the_jax_builders_calls_and_csvs(tmp_path, monkeypatch,
                                                       extra):
    geom = j_grf.generate_geometry(3.0, 4, 0.1, 0.4,
                                   rng=np.random.default_rng(5)
                                   ).reshape(4, 4).astype(float)
    names, csvs = {}, {}
    for which in ("jax", "port"):
        with monkeypatch.context() as m:
            names[which], csvs[which] = _run_builder(
                which, tmp_path / which, m, geom, extra)
    assert names["port"] == names["jax"]
    assert len(names["port"]) > 50 and "job:Job-1.submit" in names["port"]
    assert sorted(csvs["port"]) == sorted(csvs["jax"])
    assert "stress_strain.csv" in csvs["port"]
    for name, data in csvs["jax"].items():
        assert csvs["port"][name] == data, name


def _fake_csvs(csv_dir, pixels=8, frames=3):
    csv_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    for n in ("geometry", "s_mises", "s_22", "strain_energy_dens"):
        np.savetxt(csv_dir / f"{n}_frames_eul.csv",
                   rng.uniform(size=(frames * pixels, pixels)),
                   delimiter=",")
    for n in ("u_1", "u_2", "s_mises", "s_22", "strain_energy_dens",
              "geometry"):
        np.savetxt(csv_dir / f"{n}_frames_lagr.csv",
                   rng.uniform(size=(frames * pixels, pixels)) - 0.5,
                   delimiter=",")
    # two equal frames: a writer that merges them loses one
    eul = csv_dir / "geometry_frames_eul.csv"
    rows = np.genfromtxt(eul, delimiter=",")
    rows[pixels:2 * pixels] = rows[:pixels]
    np.savetxt(eul, rows, delimiter=",")


@pytest.mark.parametrize("frame", ["eulerian", "lagrangian"])
def test_convert_frames_to_gifs_as_jax(tmp_path, frame, monkeypatch):
    """The port's GIFs decode to the frames the JAX function hands
    imageio (captured here), every frame kept, duplicates included;
    frame_range.csv is byte-equal."""
    import imageio.v2 as imageio

    _fake_csvs(tmp_path / "csv")
    handed = {}
    save = imageio.mimsave

    def capture(path, frames, **kw):
        handed[Path(path).name] = np.stack(frames)
        return save(path, frames, **kw)

    monkeypatch.setattr(imageio, "mimsave", capture)
    out = {}
    for name, mod in (("jax", j_eval), ("port", eval_abaqus)):
        out[name] = mod.convert_frames_to_gifs(
            tmp_path / "csv", tmp_path / name, reference_frame=frame,
            pixels=8, num_frames=3)
    assert (out["port"] / "frame_range.csv").read_bytes() == \
        (out["jax"] / "frame_range.csv").read_bytes()
    assert len(handed) == 4
    for name, want in handed.items():
        assert want.shape == (3, 8, 8) and want.dtype == np.uint8
        np.testing.assert_array_equal(gif_to_array(out["port"] / name),
                                      want, err_msg=name)
    if frame == "eulerian":
        got = gif_to_array(out["port"] / "prediction_channel_0.gif")
        np.testing.assert_array_equal(got[0], got[1])


def test_evaluate_sample_with_an_injected_runner(tmp_path):
    """The wrapper flow, through the CLI, with a fake Abaqus that writes
    the CSVs: the command runs the port's builder with the JAX wrapper's
    arguments."""
    samples = tmp_path / "samples"
    samples.mkdir()
    np.savetxt(samples / "geometries.csv", np.ones((2, 64)), delimiter=",")
    seen = []

    def runner(cmd, cwd):
        seen.append((cmd, cwd))
        _fake_csvs(cwd / "csv", pixels=16)

    gif_dir = cli.main(["--samples-path", str(samples), "--sample-index",
                        "1", "--pixels", "8"], abaqus_runner=runner)
    cmd, cwd = seen[0]
    assert cwd == samples / "abaqus_eval_sample_1"
    assert cmd == j_eval.abaqus_command(BUILDERS["port"], "..", 1, True, 8)
    assert gif_dir == cwd / "gif"
    assert sorted(p.name for p in gif_dir.iterdir()) == [
        "frame_range.csv"] + [f"prediction_channel_{j}.gif"
                              for j in range(4)]
    assert gif_to_array(gif_dir / "prediction_channel_1.gif").shape == \
        (3, 16, 16)
    assert eval_abaqus.abaqus_command(
        "abq.py", "s", 3, True, 48, solver="explicit", radius=0.01) == \
        j_eval.abaqus_command("abq.py", "s", 3, True, 48, solver="explicit",
                              radius=0.01)
    # no CSVs from the solver: no GIFs
    assert eval_abaqus.evaluate_sample(
        samples, sample_index=0, pixels=8,
        abaqus_runner=lambda cmd, cwd: None) is None


def test_best_of_n_metrics_equal_jax(tmp_path):
    rng = np.random.default_rng(6)
    targets, per = 4, 5
    data = rng.uniform(0.1, 2.0, (targets * per, 51))
    data[3, 20] = 80.0                    # diverges mid-curve
    data[7, 0] = -60.0                    # diverges at once: NaN
    data[11, :] = 55.0                    # NaN
    full = rng.uniform(0.1, 2.0, (30, 51))
    for kw in ({}, {"closest_match": True, "full_data": full},
               {"closest_match": True, "full_data": full,
                "skip_first": True, "divergence_threshold": 1.5}):
        np.testing.assert_equal(
            metrics.compute_full_error(data, targets, **kw),
            j_metrics.compute_full_error(data, targets, **kw))
    for skip in (False, True):
        np.testing.assert_equal(
            metrics.find_closest_match(data[0], full, skip),
            j_metrics.find_closest_match(data[0], full, skip))
    all_nan = np.stack([data[0], np.full(51, 99.0)])
    with pytest.warns(RuntimeWarning):
        np.testing.assert_equal(metrics.compute_full_error(all_nan, 1),
                                j_metrics.compute_full_error(all_nan, 1))
    for name, mod in (("port.csv", metrics), ("jax.csv", j_metrics)):
        np.savetxt(tmp_path / name, data, delimiter=",")
        mod.reduce_csv_to_first_n_rows(str(tmp_path / name), 3)
    assert (tmp_path / "port.csv").read_bytes() == \
        (tmp_path / "jax.csv").read_bytes()


def test_abaqus_route_parses_as_python_2():
    """Abaqus CAE ships Python 2.7: no f-strings, annotations, keyword-only
    arguments, walrus, async, `yield from` or pathlib on the route, no
    `from __future__ import annotations`, non-ASCII text only under a
    coding line, and an empty fem/__init__.py (so grf.py is not
    imported)."""
    banned = (ast.JoinedStr, ast.NamedExpr, ast.AnnAssign,
              ast.AsyncFunctionDef, ast.AsyncFor, ast.AsyncWith,
              ast.YieldFrom, ast.Await)
    assert (PORT / "fem" / "__init__.py").read_text().strip() == ""
    for path in ABAQUS_ROUTE:
        raw = path.read_bytes()
        head = raw.split(b"\n", 2)[:2]
        if any(b > 127 for b in raw):
            assert any(b"coding" in line for line in head), (
                f"{path.name}: non-ASCII text without a coding line")
        tree = ast.parse(raw.decode("utf-8"))
        for node in ast.walk(tree):
            where = f"{path.name}:{getattr(node, 'lineno', '?')}"
            assert not isinstance(node, banned), (
                f"{where}: {type(node).__name__} is Python 3 only")
            if isinstance(node, (ast.FunctionDef, ast.Lambda)):
                args = node.args
                assert not args.kwonlyargs and not args.posonlyargs, where
                if isinstance(node, ast.FunctionDef):
                    assert node.returns is None, where
                    assert all(a.annotation is None for a in args.args), where
            if isinstance(node, ast.ImportFrom):
                assert node.module != "__future__" or all(
                    a.name != "annotations" for a in node.names), where
                assert not (node.module or "").startswith("pathlib"), where
            if isinstance(node, ast.Import):
                assert all(not a.name.startswith("pathlib")
                           for a in node.names), where


def test_best_of_n_metrics_refuse_bad_groups():
    data = np.ones((5, 4))
    with pytest.raises(ValueError, match="divisor"):
        metrics.compute_full_error(data, 2)
    with pytest.raises(ValueError, match="full_data"):
        metrics.compute_full_error(data, 1, closest_match=True)
    with pytest.raises(ValueError, match="dimensions"):
        metrics.compute_full_error(data, 1, closest_match=True,
                                   full_data=np.ones((3, 5)))
