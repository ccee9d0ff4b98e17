"""GIF <-> array in numpy and the standard library: the port's copy of
videometamaterials_tpu/data/gif_io.py (which uses Pillow).

  gif_to_array    every frame as single-channel uint8 (F, H, W), decoded as
                  Pillow decodes it and converted to L as Pillow converts a
                  palette colour (luma (R*19595 + G*38470 + B*7471 +
                  0x8000) >> 16): frames drawn into the logical screen at
                  their offset, the disposal methods, local colour tables,
                  transparency and interlace; Pillow's and imageio's merged
                  identical frames expanded by duration with
                  `expected_frames`; with `image_size`, Pillow's bilinear
                  resize (its fixed-point arithmetic) and a centre crop.
                  Where Pillow's switching of image
                  modes misreads a frame (the frame after a disposal-2
                  frame in a grey-palette file; a colour palette after a
                  palette-less first frame) the frame as written is read.
  array_to_gif    a (F, H, W) float [0, 1] (or uint8) video as a GIF89a with
                  a 256-grey global palette, every frame whole, LZW-coded,
                  looping
  rgba_to_gif     a (F, H, W, 4) uint8 RGBA video as the JAX renderer's
                  imageio call writes it (a delay of 20 cs, disposal 2,
                  NETSCAPE loop 0): per frame a local palette of its opaque
                  colours and one transparent index (alpha 0 is
                  transparent, any other alpha opaque); a frame of more
                  than 255 opaque colours has them merged to 255 (see
                  `_merge_palette`)
  gif_to_rgba     any GIF as (F, H, W, 4) uint8 RGBA: frames composited on
                  a transparent screen with their disposal methods and
                  transparency (transparent pixels read (0, 0, 0, 0))
  write_png       a (H, W, 4) uint8 RGBA image as a PNG (zlib, no filter)
  cast_num_frames truncate or zero-pad the frame axis
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_MAX_CODES = 4096


# ------------------------------------------------------------------ decoder


def _lzw_decode(data: bytes, min_size: int, count: int) -> np.ndarray:
    """The first `count` indices of a GIF LZW stream (a short stream is
    padded with zeros, as Pillow leaves a truncated frame)."""
    clear, end = 1 << min_size, (1 << min_size) + 1
    prefix = [0] * _MAX_CODES
    suffix = [0] * _MAX_CODES
    first = [0] * _MAX_CODES
    for i in range(clear):
        suffix[i] = first[i] = i
    lengths = [1] * clear + [0] * (_MAX_CODES - clear)
    out = bytearray(count)
    n = 0
    width, mask = min_size + 1, (1 << (min_size + 1)) - 1
    nxt, prev = end + 1, -1
    bits = nbits = 0
    for byte in data:
        bits |= byte << nbits
        nbits += 8
        while nbits >= width:
            code = bits & mask
            bits >>= width
            nbits -= width
            if code == clear:
                width, mask = min_size + 1, (1 << (min_size + 1)) - 1
                nxt, prev = end + 1, -1
                continue
            if code == end:
                return np.frombuffer(bytes(out), np.uint8)
            if prev < 0:
                if code >= clear:
                    raise ValueError("GIF LZW: bad first code")
                if n < count:
                    out[n] = code
                n += 1
                prev = code
                continue
            if code < nxt:
                k = first[code]
                cur = code
            elif code == nxt:
                k = first[prev]
                cur = -1                     # prev's string, then k
            else:
                raise ValueError("GIF LZW: code out of range")
            if nxt < _MAX_CODES:
                prefix[nxt], suffix[nxt] = prev, k
                first[nxt] = first[prev]
                lengths[nxt] = lengths[prev] + 1
                if cur < 0:
                    cur = nxt
                nxt += 1
                if nxt == 1 << width and width < 12:
                    width += 1
                    mask = (1 << width) - 1
            elif cur < 0:
                raise ValueError("GIF LZW: code past a full table")
            length = lengths[cur]
            pos = n + length - 1
            c = cur
            while c >= 0 and length:
                if pos < count:
                    out[pos] = suffix[c]
                pos -= 1
                length -= 1
                c = prefix[c] if c >= clear + 2 else -1
            n += lengths[cur]
            prev = code
    return np.frombuffer(bytes(out), np.uint8)


def _deinterlace(rows: np.ndarray) -> np.ndarray:
    h = rows.shape[0]
    order = np.concatenate([np.arange(s, h, step) for s, step in
                            ((0, 8), (4, 8), (2, 4), (1, 2))])
    out = np.empty_like(rows)
    out[order] = rows
    return out


def _luma(palette: np.ndarray) -> np.ndarray:
    """Pillow's conversion of RGB palette entries to L."""
    rgb = palette.astype(np.int64)
    return ((rgb[:, 0] * 19595 + rgb[:, 1] * 38470 + rgb[:, 2] * 7471
             + 0x8000) >> 16).astype(np.uint8)


class _Bytes:
    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated GIF")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def byte(self) -> int:
        return self.take(1)[0]

    def blocks(self) -> bytes:
        parts = []
        while True:
            n = self.byte()
            if n == 0:
                return b"".join(parts)
            parts.append(self.take(n))

    def palette(self, flags: int) -> np.ndarray:
        n = 2 << (flags & 7)
        return np.frombuffer(self.take(3 * n), np.uint8).reshape(n, 3)


def _read_frames(data: bytes) -> list[tuple[np.ndarray, int]]:
    """[(frame (H, W) uint8 L, duration ms)] as Pillow's GIF plugin gives
    them (its default loading strategy: frames after the first composited
    in RGB, then converted to L)."""
    src = _Bytes(data)
    if src.take(6) not in (b"GIF87a", b"GIF89a"):
        raise ValueError("not a GIF file")
    width, height, flags, background, _ = struct.unpack("<HHBBB",
                                                        src.take(7))
    global_lut = None
    if flags & 0x80:
        global_lut = _luma(src.palette(flags))
    else:
        background = 0
    frames: list = []
    canvas = None
    disposal = 0             # the last non-zero disposal method (Pillow's)
    dispose = None           # (box, fill) applied before the next frame
    gce: dict = {}
    while src.pos < len(src.data):
        tag = src.byte()
        if tag == 0x3B:
            break
        if tag == 0x21:
            label = src.byte()
            block = src.blocks()
            if label == 0xF9 and len(block) >= 4:
                gce = {"duration": struct.unpack("<H", block[1:3])[0] * 10}
                if block[0] & 1:
                    gce["transparency"] = block[3]
                disposal = (block[0] >> 2) & 7 or disposal
            continue
        if tag != 0x2C:
            raise ValueError(f"GIF: unexpected block 0x{tag:02x}")
        x0, y0, w, h, iflags = struct.unpack("<HHHHB", src.take(9))
        if x0 + w > width or y0 + h > height:
            raise ValueError("GIF frame outside the logical screen")
        lut = global_lut
        if iflags & 0x80:
            lut = _luma(src.palette(iflags))
        if lut is None:
            lut = np.arange(256, dtype=np.uint8)
        lut = np.concatenate([lut, np.zeros(256 - len(lut), np.uint8)])
        min_size = src.byte()
        if not 1 <= min_size <= 11:
            raise ValueError(f"GIF: LZW minimum code size {min_size}")
        idx = _lzw_decode(src.blocks(), min_size, w * h).reshape(h, w)
        if iflags & 0x40:
            idx = _deinterlace(idx)
        tidx = gce.get("transparency")
        box = (slice(y0, y0 + h), slice(x0, x0 + w))
        if canvas is not None and dispose is not None:
            canvas[dispose[0]] = dispose[1]
        # this frame's disposal, applied before the next frame is drawn
        dispose = None
        if disposal == 2:
            dispose = (box, lut[background if tidx is None else tidx])
        elif disposal == 3 and canvas is not None:
            dispose = (box, canvas[box].copy())
        elif disposal == 3 and tidx is not None:
            dispose = (box, lut[tidx])
        if canvas is None:
            canvas = np.full((height, width), lut[tidx or 0], np.uint8)
            canvas[box] = lut[idx]
        elif tidx is None:
            canvas[box] = lut[idx]
        else:
            canvas[box] = np.where(idx == tidx, canvas[box], lut[idx])
        frames.append((canvas.copy(), gce.get("duration", 0)))
        gce = {}
    if not frames:
        raise ValueError("GIF without frames")
    return frames


# ------------------------------------------------------------------ resize

# Pillow's fixed point for 8-bit resampling (libImaging/Resample.c)
_PRECISION_BITS = 32 - 8 - 2


def _bilinear_coeffs(in_size: int, out_size: int):
    """Pillow's precompute_coeffs for the bilinear filter (support 1,
    widened by the scale when shrinking) and normalize_coeffs_8bpc: per
    output pixel the first input pixel and the int weights of its window,
    as (out_size,) starts and (out_size, k) weights (zero past the
    window)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    starts = np.zeros(out_size, np.int64)
    weights = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        x = (np.arange(xmax) + xmin - center + 0.5) / filterscale
        w = np.maximum(1.0 - np.abs(x), 0.0)
        ww = w.sum()
        if ww != 0.0:
            w = w / ww
        w = w * (1 << _PRECISION_BITS)
        starts[xx] = xmin
        weights[xx, :xmax] = np.where(w < 0, np.trunc(w - 0.5),
                                      np.trunc(w + 0.5))
    return starts, weights


def _resample_rows(img: np.ndarray, out_w: int) -> np.ndarray:
    """One horizontal pass of Pillow's 8-bit resampling: int sums rounded
    at half and clipped to uint8."""
    starts, weights = _bilinear_coeffs(img.shape[1], out_w)
    idx = np.minimum(starts[:, None] + np.arange(weights.shape[1]),
                     img.shape[1] - 1)
    acc = (img.astype(np.int64)[:, idx] * weights).sum(axis=-1)
    acc = (acc + (1 << (_PRECISION_BITS - 1))) >> _PRECISION_BITS
    return np.clip(acc, 0, 255).astype(np.uint8)


def resize_bilinear(frame: np.ndarray, width: int, height: int) -> np.ndarray:
    """Pillow's Image.resize((width, height), BILINEAR) of a uint8 (H, W)
    frame: a horizontal pass, then a vertical one, each only where the size
    changes."""
    out = frame
    if width != out.shape[1]:
        out = _resample_rows(out, width)
    if height != out.shape[0]:
        out = _resample_rows(out.T, height).T
    return np.ascontiguousarray(out)


def resize_and_crop(frame: np.ndarray, image_size: int) -> np.ndarray:
    """The JAX dataset's frame transform: bilinear resize of the shorter
    side to image_size (the other side rounded in proportion), then a
    centre crop to image_size x image_size."""
    h, w = frame.shape
    scale = image_size / min(w, h)
    frame = resize_bilinear(frame, round(w * scale), round(h * scale))
    h, w = frame.shape
    left, top = (w - image_size) // 2, (h - image_size) // 2
    return frame[top:top + image_size, left:left + image_size]


def gif_to_array(path: str | Path, image_size: int | None = None,
                 expected_frames: int | None = None) -> np.ndarray:
    """Decode a single-channel GIF to uint8 (F, H, W). Frames that an
    encoder merged (identical consecutive frames written once with their
    summed duration) are expanded back to `expected_frames` in proportion
    to their durations, as the JAX package does. With image_size, frames of
    another size are resized and centre-cropped to image_size x image_size
    (`resize_and_crop`)."""
    decoded = _read_frames(Path(path).read_bytes())
    frames = [f for f, _ in decoded]
    if image_size is not None and frames[0].shape != (image_size,
                                                      image_size):
        frames = [resize_and_crop(f, image_size) for f in frames]
    if expected_frames is not None and 0 < len(frames) < expected_frames:
        durations = [float(d) for _, d in decoded]
        total = sum(durations)
        if total <= 0:
            reps = [expected_frames // len(frames)] * len(frames)
            reps[-1] += expected_frames - sum(reps)
        else:
            # cumulative rounding: every boundary within half a frame, the
            # total exactly expected_frames
            edges = np.round(np.cumsum(durations) * expected_frames
                             / total).astype(int)
            reps = np.diff(np.concatenate([[0], edges])).tolist()
        frames = [f for f, r in zip(frames, reps) for _ in range(r)]
    return np.stack(frames, axis=0)


# ------------------------------------------------------------------ encoder


def _lzw_encode(pixels: bytes) -> bytes:
    """GIF LZW of 8-bit indices (minimum code size 8), cleared whenever the
    table fills."""
    clear, end = 256, 257
    codes, widths = [clear], [9]
    table: dict = {}
    nxt = end + 1
    w = pixels[0]
    for k in pixels[1:]:
        key = (w << 8) | k
        hit = table.get(key)
        if hit is not None:
            w = hit
            continue
        codes.append(w)
        widths.append(max(9, (nxt - 1).bit_length()))
        table[key] = nxt
        nxt += 1
        w = k
        if nxt == _MAX_CODES:
            codes.append(clear)
            widths.append(12)
            table.clear()
            nxt = end + 1
    codes.append(w)
    widths.append(max(9, (nxt - 1).bit_length()))
    nxt += 1
    codes.append(end)
    widths.append(max(9, (nxt - 1).bit_length()) if nxt <= _MAX_CODES
                  else 12)
    return _pack_codes(np.asarray(codes, np.int64),
                       np.asarray(widths, np.int64))


def _pack_codes(codes: np.ndarray, widths: np.ndarray) -> bytes:
    """Variable-width codes, least significant bit first."""
    bit = np.arange(12)
    bits = (codes[:, None] >> bit) & 1
    return np.packbits(bits[bit < widths[:, None]],
                       bitorder="little").tobytes()


def _sub_blocks(data: bytes) -> bytes:
    return b"".join(bytes((len(data[i:i + 255]),)) + data[i:i + 255]
                    for i in range(0, len(data), 255)) + b"\x00"


def array_to_gif(video: np.ndarray, path: str | Path, duration: int = 200,
                 loop: int = 0) -> None:
    """video: (F, H, W) float in [0, 1] (rounded to uint8 as the JAX package
    rounds it) or uint8. Every frame is stored whole, so a decoder sees F
    frames even where consecutive frames are identical."""
    if video.dtype != np.uint8:
        video = np.clip(np.round(np.asarray(video) * 255.0), 0, 255
                        ).astype(np.uint8)
    f, h, w = video.shape
    grey = np.repeat(np.arange(256, dtype=np.uint8), 3).tobytes()
    out = [b"GIF89a", struct.pack("<HHBBB", w, h, 0xF7, 0, 0), grey,
           b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", loop)
           + b"\x00"]
    for frame in video:
        out.append(b"\x21\xf9\x04\x00" + struct.pack("<H", duration // 10)
                   + b"\x00\x00")
        out.append(b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0) + b"\x08")
        out.append(_sub_blocks(_lzw_encode(frame.tobytes())))
    out.append(b"\x3b")
    Path(path).write_bytes(b"".join(out))


# ------------------------------------------------------------ RGBA codec

# distinct opaque colours of a frame the palette reduction takes: it merges
# one pair at a time over an n x n distance table
MAX_FRAME_COLORS = 1024


def _merge_palette(colors: np.ndarray, counts: np.ndarray,
                   limit: int = 255) -> np.ndarray:
    """Reduce `colors` (n, 3) uint8, sorted, with pixel counts, to at most
    `limit` entries: while there are more, the pair of surviving colours at
    the smallest squared RGB distance merges, the one with fewer pixels
    (on a tie the later in sorted order) taking the other's colour and
    adding its pixels to it. Returns for each colour the index of the
    colour it is drawn with. Deterministic; exact where n <= limit."""
    n = len(colors)
    target = np.arange(n)
    if n <= limit:
        return target
    if n > MAX_FRAME_COLORS:
        raise ValueError(f"a frame of {n} opaque colours: the GIF writer "
                         f"takes at most {MAX_FRAME_COLORS}")
    c = colors.astype(np.int64)
    dist = ((c[:, None, :] - c[None, :, :]) ** 2).sum(-1)
    big = np.iinfo(np.int64).max
    dist[np.arange(n), np.arange(n)] = big
    counts = counts.astype(np.int64).copy()
    for _ in range(n - limit):
        i, j = np.unravel_index(np.argmin(dist), dist.shape)
        i, j = min(i, j), max(i, j)
        keep, drop = (j, i) if counts[j] > counts[i] else (i, j)
        counts[keep] += counts[drop]
        target[target == drop] = keep
        dist[drop, :] = big
        dist[:, drop] = big
    return target


def _rgba_frame(frame: np.ndarray) -> tuple[bytes, bytes, int]:
    """(local palette bytes of 256 entries, indices, transparent index) of
    one (H, W, 4) frame."""
    opaque = frame[..., 3] != 0
    rgb = frame[..., :3].astype(np.int64)
    packed = (rgb[..., 0] << 16) | (rgb[..., 1] << 8) | rgb[..., 2]
    keys, inverse, counts = np.unique(packed[opaque], return_inverse=True,
                                      return_counts=True)
    colors = np.stack([(keys >> 16) & 255, (keys >> 8) & 255, keys & 255],
                      axis=1).astype(np.uint8)
    target = _merge_palette(colors, counts)
    kept, slot = np.unique(target, return_inverse=True)
    index = np.zeros(frame.shape[:2], np.uint8)
    index[opaque] = slot[inverse]
    # a transparent index in every frame, used or not: a decoder that
    # fills a disposed frame with the transparent colour (Pillow) then
    # shows the next frame's transparent pixels as transparent
    tidx = len(kept)
    index[~opaque] = tidx
    palette = np.zeros((256, 3), np.uint8)
    palette[:len(kept)] = colors[kept]
    return palette.tobytes(), index.tobytes(), tidx


def rgba_to_gif(video: np.ndarray, path: str | Path) -> None:
    """video: (F, H, W, 4) uint8 RGBA. Every frame is stored whole with its
    own palette, 20 cs long, looping (see the module docstring); a decoder
    sees F frames."""
    video = np.asarray(video)
    if video.dtype != np.uint8 or video.ndim != 4 or video.shape[-1] != 4:
        raise ValueError(f"expected (F, H, W, 4) uint8, got {video.dtype} "
                         f"{video.shape}")
    f, h, w, _ = video.shape
    out = [b"GIF89a", struct.pack("<HHBBB", w, h, 0x70, 0, 0),
           b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"]
    for frame in video:
        palette, index, tidx = _rgba_frame(frame)
        flags = (2 << 2) | 1                # disposal 2, transparent index
        out.append(b"\x21\xf9\x04" + struct.pack("<BHB", flags, 20, tidx)
                   + b"\x00")
        out.append(b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0x87))
        out.append(palette + b"\x08")
        out.append(_sub_blocks(_lzw_encode(index)))
    out.append(b"\x3b")
    Path(path).write_bytes(b"".join(out))


def gif_to_rgba(path: str | Path) -> np.ndarray:
    """Decode a GIF to (F, H, W, 4) uint8 RGBA: each frame drawn on the
    canvas left by the previous one's disposal (0/1 keep, 2 clear the
    frame's box to transparent, 3 restore it), its transparent index
    leaving the canvas as it was."""
    src = _Bytes(Path(path).read_bytes())
    if src.take(6) not in (b"GIF87a", b"GIF89a"):
        raise ValueError("not a GIF file")
    width, height, flags, _, _ = struct.unpack("<HHBBB", src.take(7))
    global_pal = src.palette(flags) if flags & 0x80 else None
    canvas = np.zeros((height, width, 4), np.uint8)
    frames, gce, restore = [], {}, None
    while src.pos < len(src.data):
        tag = src.byte()
        if tag == 0x3B:
            break
        if tag == 0x21:
            label = src.byte()
            block = src.blocks()
            if label == 0xF9 and len(block) >= 4:
                gce = {"disposal": (block[0] >> 2) & 7}
                if block[0] & 1:
                    gce["transparency"] = block[3]
            continue
        if tag != 0x2C:
            raise ValueError(f"GIF: unexpected block 0x{tag:02x}")
        x0, y0, w, h, iflags = struct.unpack("<HHHHB", src.take(9))
        if x0 + w > width or y0 + h > height:
            raise ValueError("GIF frame outside the logical screen")
        pal = src.palette(iflags) if iflags & 0x80 else global_pal
        if pal is None:
            pal = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)
        lut = np.zeros((256, 4), np.uint8)
        lut[:len(pal), :3] = pal[:256]
        lut[:, 3] = 255
        min_size = src.byte()
        if not 1 <= min_size <= 11:
            raise ValueError(f"GIF: LZW minimum code size {min_size}")
        idx = _lzw_decode(src.blocks(), min_size, w * h).reshape(h, w)
        if iflags & 0x40:
            idx = _deinterlace(idx)
        box = (slice(y0, y0 + h), slice(x0, x0 + w))
        if restore is not None:
            canvas[restore[0]] = restore[1]
        disposal = gce.get("disposal", 0)
        restore = ((box, 0) if disposal == 2
                   else (box, canvas[box].copy()) if disposal == 3 else None)
        tidx = gce.get("transparency")
        drawn = lut[idx]
        if tidx is None:
            canvas[box] = drawn
        else:
            keep = (idx == tidx)[..., None]
            canvas[box] = np.where(keep, canvas[box], drawn)
        frames.append(canvas.copy())
        gce = {}
    if not frames:
        raise ValueError("GIF without frames")
    return np.stack(frames)


def write_png(path: str | Path, rgba: np.ndarray,
              text: dict[str, str] | None = None) -> None:
    """A (H, W, 4) uint8 image as an 8-bit RGBA PNG, rows unfiltered, with
    optional tEXt chunks (Latin-1 keys and values)."""
    rgba = np.ascontiguousarray(rgba, np.uint8)
    h, w, _ = rgba.shape

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           rgba.reshape(h, w * 4)], axis=1)
    parts = [b"\x89PNG\r\n\x1a\n",
             chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0))]
    for key, value in (text or {}).items():
        parts.append(chunk(b"tEXt", key.encode("latin-1") + b"\x00"
                           + value.encode("latin-1")))
    parts += [chunk(b"IDAT", zlib.compress(rows.tobytes(), 9)),
              chunk(b"IEND", b"")]
    Path(path).write_bytes(b"".join(parts))


def cast_num_frames(video: np.ndarray, frames: int) -> np.ndarray:
    """Truncate or zero-pad the leading frame axis."""
    f = video.shape[0]
    if f == frames:
        return video
    if f > frames:
        return video[:frames]
    pad = [(0, frames - f)] + [(0, 0)] * (video.ndim - 1)
    return np.pad(video, pad)
