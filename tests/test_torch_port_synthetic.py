"""PyTorch port, the synthetic dataset generators on the CPU against the
JAX package's: with the same seed the CSVs are byte-equal, the file trees
are the same, and every GIF the port writes decodes to the frames the JAX
generator hands its writer (captured here), duplicates included."""

from pathlib import Path

import numpy as np
import pytest

from videometamaterials_tpu.data import synthetic as j_synthetic
from videometamaterials_tpu_torch.data import synthetic
from videometamaterials_tpu_torch.data.gif_io import gif_to_array

MAKERS = {
    "make_synthetic_dataset": dict(num_samples=3, image_size=24,
                                   num_frames=5),
    "make_consistent_dataset": dict(num_samples=2, image_size=48,
                                    num_frames=11),
    "make_consistent_dataset_eulerian": dict(num_samples=2, image_size=48,
                                             num_frames=11),
}


@pytest.mark.parametrize("name", sorted(MAKERS))
def test_same_folder_as_jax(tmp_path, monkeypatch, name):
    kw = dict(MAKERS[name], seed=3)
    handed = {}
    write = j_synthetic._write_gif

    def capture(video01, path):
        rel = Path(path).relative_to(tmp_path / "jax")
        handed[str(rel)] = np.clip(np.round(video01 * 255.0), 0, 255
                                   ).astype(np.uint8)
        write(video01, path)

    monkeypatch.setattr(j_synthetic, "_write_gif", capture)
    getattr(j_synthetic, name)(tmp_path / "jax", **kw)
    getattr(synthetic, name)(tmp_path / "port", **kw)

    def tree(root):
        return sorted(str(p.relative_to(root)) for p in root.rglob("*"))

    assert tree(tmp_path / "port") == tree(tmp_path / "jax")
    for csv in ("frame_range_data.csv", "stress_strain_data.csv"):
        assert (tmp_path / "port" / csv).read_bytes() == \
            (tmp_path / "jax" / csv).read_bytes(), csv
    eulerian = name.endswith("eulerian")
    channels = 4 if eulerian else 6
    assert len(handed) == kw["num_samples"] * channels
    for rel, want in handed.items():
        got = gif_to_array(tmp_path / "port" / rel)
        assert got.shape == (kw["num_frames"],) + want.shape[1:], rel
        np.testing.assert_array_equal(got, want, err_msg=rel)
    if not eulerian:
        # topo repeats one frame: every copy is stored
        topo = gif_to_array(tmp_path / "port" / "gifs" / "topo" / "0.gif")
        assert len(topo) == kw["num_frames"] and (topo == topo[0]).all()
