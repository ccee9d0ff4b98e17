"""GIF <-> array in numpy and the standard library: the port's copy of
videometamaterials_tpu/data/gif_io.py (which uses Pillow).

  gif_to_array    every frame as single-channel uint8 (F, H, W), decoded as
                  Pillow decodes it and converted to L as Pillow converts a
                  palette colour (luma (R*19595 + G*38470 + B*7471 +
                  0x8000) >> 16): frames drawn into the logical screen at
                  their offset, the disposal methods, local colour tables,
                  transparency and interlace; Pillow's and imageio's merged
                  identical frames expanded by duration with
                  `expected_frames`. Where Pillow's switching of image
                  modes misreads a frame (the frame after a disposal-2
                  frame in a grey-palette file; a colour palette after a
                  palette-less first frame) the frame as written is read.
  array_to_gif    a (F, H, W) float [0, 1] (or uint8) video as a GIF89a with
                  a 256-grey global palette, every frame whole, LZW-coded,
                  looping
  cast_num_frames truncate or zero-pad the frame axis
"""

from __future__ import annotations

import struct
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


def gif_to_array(path: str | Path, image_size: int | None = None,
                 expected_frames: int | None = None) -> np.ndarray:
    """Decode a single-channel GIF to uint8 (F, H, W). Frames that an
    encoder merged (identical consecutive frames written once with their
    summed duration) are expanded back to `expected_frames` in proportion
    to their durations, as the JAX package does. Resizing to image_size
    waits for the training slice (the evaluation path never resizes)."""
    decoded = _read_frames(Path(path).read_bytes())
    frames = [f for f, _ in decoded]
    if image_size is not None and frames[0].shape != (image_size,
                                                      image_size):
        raise NotImplementedError(
            f"resizing a {frames[0].shape} GIF to {image_size}: the "
            "dataset's resize waits for ROADMAP.md Queue 1 item 4")
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


def cast_num_frames(video: np.ndarray, frames: int) -> np.ndarray:
    """Truncate or zero-pad the leading frame axis."""
    f = video.shape[0]
    if f == frames:
        return video
    if f > frames:
        return video[:frames]
    pad = [(0, frames - f)] + [(0, 0)] * (video.ndim - 1)
    return np.pad(video, pad)
