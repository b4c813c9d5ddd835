"""A reader for Flax's msgpack parameter blobs, without ``msgpack`` or ``flax``.

The shipped checkpoints (``saved_checkpoints/closure_{sr,pf}/params.msgpack``)
are what ``flax.serialization.msgpack_serialize`` writes: a msgpack map of
maps whose leaves are msgpack ext objects.  This module decodes the subset of
msgpack that such a blob uses and returns the same tree that
``flax.serialization.msgpack_restore`` returns:

  * maps -> dict, arrays -> list, str -> str, bin -> bytes, nil/bool/ints/
    float32/float64 -> their Python values;
  * ext code 1 (an ndarray, packed as the msgpack triple (shape, dtype name,
    raw C-order bytes)) -> a read-only numpy array, like Flax's
    ``np.frombuffer``; a ``bfloat16`` array, which numpy cannot hold, becomes
    a ``torch.bfloat16`` tensor with the same bits;
  * ext code 3 (a numpy scalar, packed as a 0-d ndarray) -> the numpy scalar;
  * ext code 2 (a Python complex) and chunked arrays (Flax's
    ``__msgpack_chunked_array__`` maps, written only for a leaf over 2^30
    bytes) raise ``ValueError``: no checkpoint of this project holds one.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED_MARKER = "__msgpack_chunked_array__"


class _Reader:
    def __init__(self, data, raw: bool):
        self.buf = memoryview(data)
        self.pos = 0
        self.raw = raw  # str objects stay bytes (Flax reads the ndarray triple so)

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack: truncated data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def ext(self, n: int):
        code = self.unpack(">b")
        return _ext(code, self.take(n))

    def obj(self):
        b = self.unpack("B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map_(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.list_(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str_(b & 0x1F)
        if b in _FIXED:
            return _FIXED[b]
        if b in _SCALARS:
            return self.unpack(_SCALARS[b])
        if b in _SIZED:
            kind, fmt = _SIZED[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return self.str_(n)
            if kind == "list":
                return self.list_(n)
            if kind == "map":
                return self.map_(n)
            return self.ext(n)
        if b in _FIXEXT:
            return self.ext(_FIXEXT[b])
        raise ValueError(f"msgpack: unknown type byte 0x{b:02x}")

    def list_(self, n: int):
        return [self.obj() for _ in range(n)]

    def map_(self, n: int):
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out


_FIXED = {0xC0: None, 0xC2: False, 0xC3: True}
_SCALARS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_SIZED = {0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
          0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
          0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
          0xDC: ("list", ">H"), 0xDD: ("list", ">I"), 0xDE: ("map", ">H"), 0xDF: ("map", ">I")}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


def _decode(data, raw: bool):
    r = _Reader(data, raw)
    out = r.obj()
    if r.pos != len(r.buf):
        raise ValueError(f"msgpack: {len(r.buf) - r.pos} trailing bytes")
    return out


def _ndarray(payload):
    shape, dtype_name, buffer = _decode(payload, raw=True)
    name = dtype_name.decode("ascii")
    if name == "bfloat16":
        bits = np.frombuffer(buffer, dtype=np.int16).reshape(shape, order="C")
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return np.frombuffer(buffer, dtype=np.dtype(name)).reshape(shape, order="C")


def _ext(code: int, payload):
    if code == EXT_NDARRAY:
        return _ndarray(payload)
    if code == EXT_NPSCALAR:
        arr = _ndarray(payload)
        return arr.reshape(()) if torch.is_tensor(arr) else arr[()]
    if code == EXT_COMPLEX:
        raise ValueError("msgpack: complex leaves (ext code 2) are not supported")
    raise ValueError(f"msgpack: unknown ext code {code}")


def _refuse_chunked(node):
    if isinstance(node, dict):
        if CHUNKED_MARKER in node:
            raise ValueError("msgpack: chunked array leaves (over 2^30 bytes) are not supported")
        for v in node.values():
            _refuse_chunked(v)
    elif isinstance(node, list):
        for v in node:
            _refuse_chunked(v)


def msgpack_restore(data: bytes):
    """The tree a Flax ``msgpack_serialize`` blob holds (see the module
    docstring for the leaf types)."""
    tree = _decode(data, raw=False)
    _refuse_chunked(tree)
    return tree


def read_msgpack(path: str):
    with open(path, "rb") as fp:
        return msgpack_restore(fp.read())
