"""A reader for Flax's msgpack checkpoints (``flax.serialization.to_bytes``,
the JAX driver's ``model_params.msgpack``) that needs no ``msgpack``
package: the card's machine has none.

It reads the msgpack subset that Flax writes — maps, arrays, str, bin,
ints, floats, nil, bool and ext — and Flax's ext types: ``ndarray`` (1, a
nested msgpack of ``(shape, dtype name, C-order buffer)``),
``native_complex`` (2, ``(real, imag)``) and ``npscalar`` (3, a 0-d
ndarray).  Arrays above Flax's ``MAX_CHUNK_SIZE`` arrive as a dict marked
``__msgpack_chunked_array__`` with ``shape`` and ``chunks`` (each a dict
keyed ``"0"``, ``"1"``, ...) and are joined back.

Leaves come back as numpy arrays and scalars, except ``bfloat16``, which
has no numpy dtype: its buffer is read as uint16 and returned as a
``torch.bfloat16`` tensor.  Lists and tuples of the saved tree arrive as
Flax stores them, as dicts keyed by position.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED = "__msgpack_chunked_array__"

# fixed-width codes: code -> (struct format, size)
_SCALARS = {0xca: (">f", 4), 0xcb: (">d", 8), 0xcc: (">B", 1), 0xcd: (">H", 2),
            0xce: (">I", 4), 0xcf: (">Q", 8), 0xd0: (">b", 1), 0xd1: (">h", 2),
            0xd2: (">i", 4), 0xd3: (">q", 8)}
# codes whose length follows: code -> (kind, struct format of the length)
_SIZED = {0xc4: ("bin", ">B"), 0xc5: ("bin", ">H"), 0xc6: ("bin", ">I"),
          0xc7: ("ext", ">B"), 0xc8: ("ext", ">H"), 0xc9: ("ext", ">I"),
          0xd9: ("str", ">B"), 0xda: ("str", ">H"), 0xdb: ("str", ">I"),
          0xdc: ("array", ">H"), 0xdd: ("array", ">I"),
          0xde: ("map", ">H"), 0xdf: ("map", ">I")}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


def _take(mv: memoryview, pos: int, n: int) -> memoryview:
    if pos + n > len(mv):
        raise IndexError(pos + n)
    return mv[pos:pos + n]


def _unpack(mv: memoryview, pos: int):
    """(the object at ``pos``, the position after it)."""
    b = mv[pos]
    pos += 1
    if b <= 0x7f:
        return b, pos
    if b >= 0xe0:
        return b - 0x100, pos
    if 0x80 <= b <= 0x8f:
        return _container("map", b & 0x0f, mv, pos)
    if 0x90 <= b <= 0x9f:
        return _container("array", b & 0x0f, mv, pos)
    if 0xa0 <= b <= 0xbf:
        n = b & 0x1f
        return str(_take(mv, pos, n), "utf-8"), pos + n
    if b == 0xc0:
        return None, pos
    if b in (0xc2, 0xc3):
        return b == 0xc3, pos
    if b in _SCALARS:
        fmt, size = _SCALARS[b]
        return struct.unpack_from(fmt, mv, pos)[0], pos + size
    if b in _FIXEXT:
        return _ext(mv, pos, _FIXEXT[b])
    if b in _SIZED:
        kind, fmt = _SIZED[b]
        n = struct.unpack_from(fmt, mv, pos)[0]
        pos += struct.calcsize(fmt)
        if kind == "bin":
            return _take(mv, pos, n), pos + n
        if kind == "str":
            return str(_take(mv, pos, n), "utf-8"), pos + n
        if kind == "ext":
            return _ext(mv, pos, n)
        return _container(kind, n, mv, pos)
    raise ValueError(f"msgpack: byte 0x{b:02x} at {pos - 1} is no type code")


def _container(kind: str, n: int, mv: memoryview, pos: int):
    if kind == "array":
        out = []
        for _ in range(n):
            item, pos = _unpack(mv, pos)
            out.append(item)
        return out, pos
    out = {}
    for _ in range(n):
        key, pos = _unpack(mv, pos)
        out[key], pos = _unpack(mv, pos)
    return out, pos


def _ext(mv: memoryview, pos: int, n: int):
    code = struct.unpack_from(">b", mv, pos)[0]
    data = _take(mv, pos + 1, n)
    pos += 1 + n
    if code == EXT_NDARRAY:
        return _ndarray(data), pos
    if code == EXT_NPSCALAR:
        arr = _ndarray(data)
        return (arr if isinstance(arr, torch.Tensor) else arr[()]), pos
    if code == EXT_COMPLEX:
        real, imag = unpackb(data)
        return complex(real, imag), pos
    raise ValueError(f"msgpack: unknown ext type {code}")


def _ndarray(data: memoryview):
    shape, dtype_name, buf = unpackb(data)
    if dtype_name == "bfloat16":
        bits = np.frombuffer(buf, dtype=np.uint16).copy().reshape(shape)
        return torch.from_numpy(bits).view(torch.bfloat16)
    dtype = np.dtype(dtype_name)
    if len(buf) == 0:
        return np.zeros(shape, dtype)
    return np.frombuffer(buf, dtype=dtype).reshape(shape)


def _unchunk(tree):
    if not isinstance(tree, dict):
        return tree
    if CHUNKED in tree:
        shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        if isinstance(chunks[0], torch.Tensor):
            return torch.cat(chunks).reshape(shape)
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def unpackb(data) -> object:
    """One msgpack object from ``data`` (bytes or a buffer); raises on a
    truncated or trailing input.  Bin values are memoryviews into it."""
    mv = memoryview(data).cast("B")
    try:
        obj, pos = _unpack(mv, 0)
    except (IndexError, struct.error) as e:
        raise ValueError("msgpack: truncated input") from e
    if pos != len(mv):
        raise ValueError(f"msgpack: {len(mv) - pos} bytes after the object")
    return obj


def from_bytes(data) -> object:
    """A tree written by ``flax.serialization.to_bytes`` (chunked arrays
    joined back)."""
    return _unchunk(unpackb(data))


def read(path: str) -> object:
    with open(path, "rb") as f:
        return from_bytes(f.read())
