"""flax's msgpack checkpoint format, read and written with the standard
library and numpy (no flax, no msgpack package).

The format is flax/serialization.py's `msgpack_serialize` /
`msgpack_restore`, as the JAX package's training/checkpoint.py writes and
reads it: a msgpack map tree whose array leaves are ext type 1 (a nested
msgpack array `(shape, dtype name, C-order bytes)`), numpy scalars ext
type 3 (the same payload, 0-d), complex numbers ext type 2 (a nested
`(real, imag)`), and leaves over 2**30 bytes maps
`{'__msgpack_chunked_array__': True, 'shape': {'0': ...}, 'chunks':
{'0': ...}}` of flat chunks.

bfloat16 leaves (dtype name `bfloat16`; numpy has no such type) are read
as `BFloat16Array`: a float32 array holding the exact values (the 16 bits
put on top of a uint32), which the writer stores as bfloat16 again. The
writer narrows a float32 leaf to bfloat16 only when the caller marks it
with `bfloat16(...)` (round to nearest even, as `jnp.astype` does).
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"
# leaves above this many bytes are written in chunks (flax's limit: a
# msgpack object holds at most 2**31 - 1 bytes)
MAX_CHUNK_SIZE = 2 ** 30


class BFloat16Array(np.ndarray):
    """float32 values of a leaf that is bfloat16 on disk. Read leaves hold
    exact bf16 values; the subclass survives numpy arithmetic, so the
    writer rounds every such leaf to nearest even again."""


def bfloat16(a) -> BFloat16Array:
    """Round a float array to bfloat16 (nearest even; NaN stays NaN) and
    mark it to be written as bfloat16."""
    bits = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    rounded = (bits + (0x7FFF + ((bits >> 16) & 1))) & np.uint32(0xFFFF0000)
    nan = np.isnan(bits.view(np.float32))
    rounded = np.where(nan, (bits | 0x00400000) & 0xFFFF0000, rounded)
    return rounded.astype(np.uint32).view(np.float32).view(BFloat16Array)


def _widen_bf16(raw: np.ndarray) -> BFloat16Array:
    return (raw.astype(np.uint32) << 16).view(np.float32).view(BFloat16Array)


# ------------------------------------------------------------------- reader


class _Reader:
    def __init__(self, buf):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        start = self.pos
        self.pos += n
        if self.pos > len(self.buf):
            raise ValueError("truncated msgpack data")
        return self.buf[start:self.pos]

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in _FIXED:
            return self.unpack(_FIXED[b])
        if b in (0xC4, 0xC5, 0xC6):                      # bin 8/16/32
            return self.take(self.unpack(_LEN[b - 0xC4]))
        if b in (0xD9, 0xDA, 0xDB):                      # str 8/16/32
            return str(self.take(self.unpack(_LEN[b - 0xD9])), "utf-8")
        if b in (0xDC, 0xDD):
            return self.array(self.unpack(_LEN[b - 0xDB]))
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(_LEN[b - 0xDD]))
        if 0xD4 <= b <= 0xD8:                            # fixext 1..16
            code = self.unpack(">b")
            return _ext(code, self.take(1 << (b - 0xD4)))
        if b in (0xC7, 0xC8, 0xC9):                      # ext 8/16/32
            n = self.unpack(_LEN[b - 0xC7])
            return _ext(self.unpack(">b"), self.take(n))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out


_LEN = (">B", ">H", ">I")
_FIXED = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
          0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}


def _ndarray(data: memoryview) -> np.ndarray:
    shape, dtype, buf = _Reader(data).read()
    if dtype == "bfloat16":
        raw = np.frombuffer(buf, dtype=np.uint16)
        return _widen_bf16(raw).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape).copy()


def _ext(code: int, data: memoryview):
    if code == _EXT_NDARRAY:
        return _ndarray(data)
    if code == _EXT_NPSCALAR:
        return _ndarray(data)[()]
    if code == _EXT_COMPLEX:
        real, imag = _Reader(data).read()
        return complex(real, imag)
    raise ValueError(f"unsupported msgpack ext type {code}")


def _unchunk(tree):
    if isinstance(tree, memoryview):
        return bytes(tree)
    if isinstance(tree, list):
        return [_unchunk(v) for v in tree]
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        flat = np.concatenate(chunks)
        if isinstance(chunks[0], BFloat16Array):
            flat = flat.view(BFloat16Array)
        return flat.reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(data) -> dict:
    """The tree of a flax msgpack byte string (flax's msgpack_restore):
    dicts, lists, Python scalars, numpy arrays and numpy scalars."""
    reader = _Reader(data)
    tree = reader.read()
    if reader.pos != len(reader.buf):
        raise ValueError("trailing bytes after the msgpack object")
    return _unchunk(tree)


def read_msgpack(path: str | Path) -> dict:
    return msgpack_restore(Path(path).read_bytes())


# ------------------------------------------------------------------- writer


def _head(out: list, n: int, fix_limit: int, fix: int, codes) -> None:
    """A length header: the fix form below fix_limit, else the 8/16/32-bit
    form (codes of the available widths, smallest first)."""
    if n < fix_limit:
        out.append(bytes((fix | n,)))
        return
    for code, fmt, limit in codes:
        if n < limit:
            out.append(bytes((code,)) + struct.pack(fmt, n))
            return
    raise ValueError(f"msgpack object of {n} elements is too large")


def _pack_int(out: list, v: int) -> None:
    if 0 <= v <= 0x7F or -32 <= v < 0:
        out.append(struct.pack(">b", v) if v < 0 else bytes((v,)))
    elif v >= 0:
        for code, fmt, limit in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                                 (0xCE, ">I", 1 << 32),
                                 (0xCF, ">Q", 1 << 64)):
            if v < limit:
                out.append(bytes((code,)) + struct.pack(fmt, v))
                return
        raise OverflowError(v)
    else:
        for code, fmt, limit in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
                                 (0xD2, ">i", 1 << 31),
                                 (0xD3, ">q", 1 << 63)):
            if v >= -limit:
                out.append(bytes((code,)) + struct.pack(fmt, v))
                return
        raise OverflowError(v)


def _pack_bin(out: list, data: bytes) -> None:
    _head(out, len(data), 0, 0, ((0xC4, ">B", 1 << 8), (0xC5, ">H", 1 << 16),
                                 (0xC6, ">I", 1 << 32)))
    out.append(data)


def _pack_ext(out: list, code: int, data: bytes) -> None:
    n = len(data)
    if n in (1, 2, 4, 8, 16):
        out.append(bytes((0xD4 + n.bit_length() - 1, code)))
    else:
        _head(out, n, 0, 0, ((0xC7, ">B", 1 << 8), (0xC8, ">H", 1 << 16),
                             (0xC9, ">I", 1 << 32)))
        out.append(bytes((code,)))
    out.append(data)


def _ndarray_bytes(a: np.ndarray) -> bytes:
    if isinstance(a, BFloat16Array):
        name = "bfloat16"
        # rounded again: a leaf computed from bf16 values keeps the
        # subclass but may hold values that are not bf16 (an identity on
        # those that are)
        payload = (bfloat16(a).view(np.uint32) >> 16
                   ).astype(np.uint16).tobytes()
    else:
        if a.dtype.hasobject or a.dtype.fields is not None:
            raise ValueError(f"cannot serialize dtype {a.dtype}")
        name, payload = a.dtype.name, a.tobytes("C")
    out: list = []
    _head(out, 3, 16, 0x90, ())
    _head(out, a.ndim, 16, 0x90, ((0xDC, ">H", 1 << 16),))
    for d in a.shape:
        _pack_int(out, int(d))
    _pack(out, name)
    _pack_bin(out, payload)
    return b"".join(out)


def _pack(out: list, x) -> None:
    if x is None:
        out.append(b"\xc0")
    elif x is True or x is False:
        out.append(b"\xc3" if x else b"\xc2")
    elif type(x) is int:
        _pack_int(out, x)
    elif type(x) is float:
        out.append(b"\xcb" + struct.pack(">d", x))
    elif type(x) is str:
        data = x.encode("utf-8")
        _head(out, len(data), 32, 0xA0, ((0xD9, ">B", 1 << 8),
                                         (0xDA, ">H", 1 << 16),
                                         (0xDB, ">I", 1 << 32)))
        out.append(data)
    elif type(x) is bytes:
        _pack_bin(out, x)
    elif type(x) is dict:
        _head(out, len(x), 16, 0x80, ((0xDE, ">H", 1 << 16),
                                      (0xDF, ">I", 1 << 32)))
        for k, v in x.items():
            _pack(out, k)
            _pack(out, v)
    elif type(x) is list:
        _head(out, len(x), 16, 0x90, ((0xDC, ">H", 1 << 16),
                                      (0xDD, ">I", 1 << 32)))
        for v in x:
            _pack(out, v)
    elif isinstance(x, np.ndarray):
        _pack_ext(out, _EXT_NDARRAY, _ndarray_bytes(x))
    elif isinstance(x, np.generic):
        _pack_ext(out, _EXT_NPSCALAR, _ndarray_bytes(np.asarray(x)))
    elif type(x) is complex:
        inner: list = []
        _head(inner, 2, 16, 0x90, ())
        _pack(inner, x.real)
        _pack(inner, x.imag)
        _pack_ext(out, _EXT_COMPLEX, b"".join(inner))
    else:
        raise TypeError(f"cannot serialize {type(x).__name__}")


def _chunk(tree, max_bytes: int):
    """Leaves over max_bytes as flax's chunked-array maps."""
    if isinstance(tree, dict):
        return {k: _chunk(v, max_bytes) for k, v in tree.items()}
    # bytes on disk: two a bfloat16 element
    itemsize = 2 if isinstance(tree, BFloat16Array) else getattr(
        tree, "itemsize", 0)
    if isinstance(tree, np.ndarray) and tree.size * itemsize > max_bytes:
        size = max(1, max_bytes // itemsize)
        flat = tree.reshape(-1)
        chunks = [flat[i:i + size] for i in range(0, flat.size, size)]
        return {_CHUNKED: True,
                "shape": {str(i): int(d) for i, d in enumerate(tree.shape)},
                "chunks": {str(i): c for i, c in enumerate(chunks)}}
    return tree


def msgpack_serialize(tree) -> bytes:
    """flax's msgpack_serialize of a tree of dicts (str keys), lists,
    Python scalars, numpy arrays and scalars, and `BFloat16Array` leaves."""
    out: list = []
    _pack(out, _chunk(tree, MAX_CHUNK_SIZE))
    return b"".join(out)


def write_msgpack(path: str | Path, tree) -> None:
    Path(path).write_bytes(msgpack_serialize(tree))
