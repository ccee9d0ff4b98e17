"""PyTorch port, the numpy GIF codec on the CPU: the port's encoder read by
the JAX package's Pillow decoder and the JAX (Pillow) and imageio encoders
read by the port's decoder give identical frames, including Pillow's
merged identical frames (with and without expected_frames), frames stored
as the box that changed, disposal methods, transparency, local palettes
and interlace."""

import struct

import imageio.v2 as imageio
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from videometamaterials_tpu.data import gif_io as j_gif
from videometamaterials_tpu_torch.data import gif_io


def _quantised(video):
    return np.clip(np.round(video * 255.0), 0, 255).astype(np.uint8)


def _video(rng, f, h, w, pattern):
    """uint8 frames: random, with runs of identical frames ('repeat'),
    or changing in one small box ('box')."""
    v = rng.integers(0, 256, (f, h, w)).astype(np.uint8)
    if pattern == "repeat":
        for i in range(1, f):
            if rng.random() < 0.6:
                v[i] = v[i - 1]
    elif pattern == "box":
        for i in range(1, f):
            v[i] = v[i - 1]
            y, x = rng.integers(0, h), rng.integers(0, w)
            v[i, y:y + 3, x:x + 2] = rng.integers(0, 256)
    return v


@settings(max_examples=25, deadline=None, derandomize=True)
@given(f=st.integers(1, 6), h=st.integers(1, 40), w=st.integers(1, 40),
       pattern=st.sampled_from(["random", "repeat", "box"]),
       seed=st.integers(0, 2 ** 16))
def test_both_ways_against_pillow(tmp_path_factory, f, h, w, pattern, seed):
    rng = np.random.default_rng(seed)
    v = _video(rng, f, h, w, pattern)
    d = tmp_path_factory.mktemp("gif")
    gif_io.array_to_gif(v, d / "port.gif")
    np.testing.assert_array_equal(j_gif.gif_to_array(d / "port.gif"), v)
    np.testing.assert_array_equal(gif_io.gif_to_array(d / "port.gif"), v)
    j_gif.array_to_gif(v, d / "jax.gif")
    for expected in (None, f):
        want = j_gif.gif_to_array(d / "jax.gif", expected_frames=expected)
        got = gif_io.gif_to_array(d / "jax.gif", expected_frames=expected)
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        gif_io.gif_to_array(d / "jax.gif", expected_frames=f), v)


def test_float_videos_quantise_as_jax(tmp_path):
    v = np.random.default_rng(0).random((11, 30, 20))
    v[3] = v[2]
    gif_io.array_to_gif(v, tmp_path / "p.gif")
    j_gif.array_to_gif(v, tmp_path / "j.gif")
    np.testing.assert_array_equal(gif_io.gif_to_array(tmp_path / "p.gif"),
                                  _quantised(v))
    np.testing.assert_array_equal(
        gif_io.gif_to_array(tmp_path / "j.gif", expected_frames=11),
        _quantised(v))


def test_merged_frames_and_sub_rectangles(tmp_path):
    """Pillow stores a changed box and merges identical frames: 4 frames
    become 3, the third with the second's duration summed in."""
    rng = np.random.default_rng(1)
    v = rng.integers(0, 256, (4, 20, 20)).astype(np.uint8)
    v[2] = v[1]
    v[2, 5:8, 5:8] = 7
    v[3] = v[2]
    j_gif.array_to_gif(v, tmp_path / "m.gif")
    assert gif_io.gif_to_array(tmp_path / "m.gif").shape == (3, 20, 20)
    np.testing.assert_array_equal(
        gif_io.gif_to_array(tmp_path / "m.gif", expected_frames=4), v)
    np.testing.assert_array_equal(gif_io.gif_to_array(tmp_path / "m.gif"),
                                  j_gif.gif_to_array(tmp_path / "m.gif"))


@pytest.mark.parametrize("mode,kw,pillow_exact", [
    ("P", dict(disposal=2), False),
    ("L", dict(disposal=[1, 3, 2], duration=[100, 50, 70]), True),
    ("RGB", dict(disposal=[3, 2, 1]), True),
    ("RGB", {}, True),
])
def test_disposal_transparency_and_palettes(tmp_path, mode, kw,
                                            pillow_exact):
    """Pillow's own files with disposal methods, transparent pixels in a
    changed box and per-frame colour palettes (RGB): the port decodes the
    frames that were written (as L), and as Pillow reads them. In a
    grey-palette file whose first frame has disposal 2, Pillow reads the
    second frame one grey level low at values 92 and above (its dispose
    fill labels the L frame P, with no palette); the port reads it as
    written."""
    rng = np.random.default_rng(2)
    v = rng.integers(0, 256, (3, 40, 40)).astype(np.uint8)
    v[1] = v[0]
    v[1, 10:20, 12:30] = 3
    if mode == "RGB":
        ims = [Image.fromarray(np.stack([f, 255 - f, f // 2], -1), "RGB")
               for f in v]
    else:
        ims = [Image.fromarray(f, "L").convert(mode) for f in v]
    ims[0].save(tmp_path / "d.gif", save_all=True, append_images=ims[1:],
                loop=0, **{"duration": 100, **kw})
    written = np.stack([np.asarray(im.convert("L")) for im in ims])
    np.testing.assert_array_equal(
        gif_io.gif_to_array(tmp_path / "d.gif", expected_frames=3), written)
    if pillow_exact:
        for expected in (None, 3):
            np.testing.assert_array_equal(
                gif_io.gif_to_array(tmp_path / "d.gif",
                                    expected_frames=expected),
                j_gif.gif_to_array(tmp_path / "d.gif",
                                   expected_frames=expected))


def _gif(width, height, frames, palette=None, background=0):
    """A GIF89a from frame specs: dict(box=(x0, y0, w, h), idx=(h, w)
    indices, disposal, transparency, palette (local, (256, 3)),
    interlace, duration)."""
    out = [b"GIF89a", struct.pack("<HHBBB", width, height,
                                  0xF7 if palette is not None else 0x70,
                                  background, 0)]
    if palette is not None:
        out.append(palette.astype(np.uint8).tobytes())
    for fr in frames:
        flags = (fr.get("disposal", 0) << 2) | ("transparency" in fr)
        out.append(b"\x21\xf9\x04" + struct.pack(
            "<BHBB", flags, fr.get("duration", 100) // 10,
            fr.get("transparency", 0), 0))
        x0, y0, w, h = fr["box"]
        idx = fr["idx"].astype(np.uint8)
        iflags = 0
        if fr.get("palette") is not None:
            iflags |= 0x87
        if fr.get("interlace"):
            iflags |= 0x40
            order = np.concatenate([np.arange(s, h, step) for s, step in
                                    ((0, 8), (4, 8), (2, 4), (1, 2))])
            idx = idx[order]
        out.append(b"\x2c" + struct.pack("<HHHHB", x0, y0, w, h, iflags))
        if fr.get("palette") is not None:
            out.append(fr["palette"].astype(np.uint8).tobytes())
        out.append(b"\x08" + gif_io._sub_blocks(gif_io._lzw_encode(
            idx.tobytes())))
    return b"".join(out) + b"\x3b"


def _crafted(case, rng):
    grey = np.repeat(np.arange(256), 3).reshape(256, 3)
    colour = rng.integers(0, 256, (256, 3))
    full = dict(box=(0, 0, 24, 20), idx=rng.integers(0, 256, (20, 24)))

    def box(x0, y0, w, h, **kw):
        return dict(box=(x0, y0, w, h), idx=rng.integers(0, 256, (h, w)),
                    **kw)

    if case == "restore background":
        return _gif(24, 20, [full, box(3, 2, 8, 6, disposal=2),
                             box(5, 4, 10, 9)], colour, background=7)
    if case == "restore previous":
        return _gif(24, 20, [full, box(3, 2, 8, 6, disposal=3),
                             box(5, 4, 10, 9), box(0, 0, 4, 4)], colour)
    if case == "sticky disposal":
        return _gif(24, 20, [dict(full, disposal=2), box(3, 2, 8, 6),
                             box(10, 10, 5, 5)], colour, background=9)
    if case == "transparency":
        first = dict(full, transparency=int(full["idx"][0, 0]))
        second = box(2, 2, 12, 12, transparency=5, disposal=2)
        second["idx"][::2] = 5
        return _gif(24, 20, [first, second, box(6, 6, 10, 10,
                                                transparency=9)], colour)
    if case == "local palettes":
        return _gif(24, 20, [dict(full, palette=colour),
                             box(1, 1, 9, 9, palette=grey[::-1]),
                             box(4, 3, 7, 7, palette=colour[::-1])], grey)
    if case == "no global palette":
        return _gif(24, 20, [full, box(2, 3, 6, 6, disposal=3),
                             box(0, 0, 9, 20)])
    if case == "interlace":
        return _gif(24, 20, [dict(full, interlace=True),
                             box(1, 2, 13, 17, interlace=True)], grey)
    raise ValueError(case)


@pytest.mark.parametrize("case", [
    "restore background", "restore previous", "sticky disposal",
    "transparency", "local palettes", "no global palette", "interlace"])
def test_crafted_files_decode_as_pillow_does(tmp_path, case):
    """Sub-rectangle frames after every disposal method, transparent
    pixels, local and missing palettes and interlaced frames, against
    Pillow's reading of the same bytes."""
    (tmp_path / "c.gif").write_bytes(_crafted(case,
                                              np.random.default_rng(6)))
    for expected in (None, 5):
        np.testing.assert_array_equal(
            gif_io.gif_to_array(tmp_path / "c.gif", expected_frames=expected),
            j_gif.gif_to_array(tmp_path / "c.gif", expected_frames=expected))


def test_imageio_files(tmp_path):
    """The data pipeline's writer (imageio keeps identical frames)."""
    v = np.random.default_rng(4).integers(0, 256, (5, 24, 24)).astype(
        np.uint8)
    v[2] = v[1]
    imageio.mimsave(tmp_path / "io.gif", list(v), duration=0.2)
    np.testing.assert_array_equal(
        gif_io.gif_to_array(tmp_path / "io.gif", expected_frames=5),
        j_gif.gif_to_array(tmp_path / "io.gif", expected_frames=5))


def test_long_lzw_streams_clear_the_table(tmp_path):
    """A frame large enough to fill the 4096-code table many times."""
    v = np.random.default_rng(5).integers(0, 256, (1, 300, 257)).astype(
        np.uint8)
    v[0, :150] //= 64                    # a compressible half
    gif_io.array_to_gif(v, tmp_path / "l.gif")
    np.testing.assert_array_equal(j_gif.gif_to_array(tmp_path / "l.gif"), v)
    np.testing.assert_array_equal(gif_io.gif_to_array(tmp_path / "l.gif"), v)


def test_resize_and_bad_files_raise(tmp_path):
    v = np.zeros((2, 8, 8), np.uint8)
    gif_io.array_to_gif(v, tmp_path / "s.gif")
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        gif_io.gif_to_array(tmp_path / "s.gif", image_size=16)
    assert gif_io.gif_to_array(tmp_path / "s.gif", image_size=8).shape == \
        (2, 8, 8)
    (tmp_path / "x.gif").write_bytes(b"PNG...")
    with pytest.raises(ValueError):
        gif_io.gif_to_array(tmp_path / "x.gif")


def test_cast_num_frames():
    v = np.arange(3 * 4).reshape(3, 2, 2)
    np.testing.assert_array_equal(gif_io.cast_num_frames(v, 3), v)
    np.testing.assert_array_equal(gif_io.cast_num_frames(v, 2),
                                  j_gif.cast_num_frames(v, 2))
    np.testing.assert_array_equal(gif_io.cast_num_frames(v, 5),
                                  j_gif.cast_num_frames(v, 5))
