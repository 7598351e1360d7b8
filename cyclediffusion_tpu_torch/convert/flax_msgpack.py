"""A reader and a writer for Flax's msgpack checkpoints
(``flax.serialization.to_bytes`` / ``msgpack_restore``, the JAX driver's
``model_params.msgpack``) that need no ``msgpack`` package: the card's
machine has none.

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

The writer (:func:`write`, :func:`to_bytes`) gives the bytes
``flax.serialization.to_bytes`` gives for the same tree: msgpack-python's
encodings (the smallest int format, float64, ``strict_types``: a numpy
scalar is Flax's ``npscalar`` ext, not a float), Flax's ``ndarray`` ext
for numpy arrays and torch tensors (a ``torch.bfloat16`` tensor as
``bfloat16`` with its bits), arrays above ``MAX_CHUNK_SIZE`` bytes split
as Flax splits them.  :func:`write` streams to the file: an array's bytes
go out from its own buffer, so a model is never held as one ``bytes``.
"""

from __future__ import annotations

import io
import math
import struct

import numpy as np
import torch

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED = "__msgpack_chunked_array__"
MAX_CHUNK_SIZE = 2 ** 30        # flax.serialization's: bytes above which an array is split

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


# ---- the writer ------------------------------------------------------------ #

def _sized(n: int, small: int, fixed: int, codes) -> bytes:
    """The header of a str / bin / array / map / ext of length ``n``:
    ``fixed | n`` below ``small`` (if the type has a fixed form), else the
    8-, 16- or 32-bit length form of ``codes``."""
    if fixed is not None and n < small:
        return bytes([fixed | n])
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= limit:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack: a length of {n} does not fit")


def _int(v: int) -> bytes:
    if 0 <= v < 0x80 or -32 <= v < 0:
        return struct.pack(">b" if v < 0 else ">B", v)
    for lo, hi, code, fmt in ((0, 0xFF, 0xCC, ">B"), (0, 0xFFFF, 0xCD, ">H"),
                              (0, 0xFFFFFFFF, 0xCE, ">I"), (0, 2 ** 64 - 1, 0xCF, ">Q"),
                              (-0x80, -1, 0xD0, ">b"), (-0x8000, -1, 0xD1, ">h"),
                              (-2 ** 31, -1, 0xD2, ">i"), (-2 ** 63, -1, 0xD3, ">q")):
        if lo <= v <= hi:
            return bytes([code]) + struct.pack(fmt, v)
    raise ValueError(f"msgpack: the int {v} does not fit in 64 bits")


def _str(v: str) -> bytes:
    b = v.encode("utf-8")
    return _sized(len(b), 32, 0xA0, (0xD9, 0xDA, 0xDB)) + b


def _bin_header(n: int) -> bytes:
    return _sized(n, 0, None, (0xC4, 0xC5, 0xC6))


def _ext_header(n: int, code: int) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}.get(n)
    head = bytes([fixed]) if fixed else _sized(n, 0, None, (0xC7, 0xC8, 0xC9))
    return head + struct.pack(">b", code)


def _as_array(leaf):
    """A numpy array or a torch tensor -> (its C-order numpy array, the
    dtype name Flax writes); a bfloat16 tensor as its uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), str(t.numpy().dtype)
    arr = np.asarray(leaf, order="C")    # ascontiguousarray would make a 0-d array 1-d
    if arr.dtype.hasobject or arr.dtype.names:
        raise ValueError(f"msgpack: an array of dtype {arr.dtype} cannot be written")
    return arr, arr.dtype.name


def _write_ndarray(out, leaf, code: int = EXT_NDARRAY) -> None:
    """Flax's ndarray ext: a msgpack ``(shape, dtype name, buffer)``; the
    buffer goes out from the array's memory."""
    arr, name = _as_array(leaf)
    shape = arr.shape
    head = (_sized(3, 16, 0x90, (None, 0xDC, 0xDD))
            + _sized(len(shape), 16, 0x90, (None, 0xDC, 0xDD))
            + b"".join(_int(int(d)) for d in shape) + _str(name) + _bin_header(arr.nbytes))
    out.write(_ext_header(len(head) + arr.nbytes, code) + head)
    if arr.nbytes:
        out.write(memoryview(arr.reshape(-1)).cast("B"))


def _itemsize(leaf) -> int:
    return leaf.element_size() if isinstance(leaf, torch.Tensor) else leaf.dtype.itemsize


def _chunked(leaf) -> dict:
    """flax.serialization's ``_chunk``: the flat array in pieces of
    ``MAX_CHUNK_SIZE / itemsize`` elements."""
    step = max(1, int(MAX_CHUNK_SIZE / _itemsize(leaf)))
    flat = leaf.reshape(-1)
    chunks = [flat[i:i + step] for i in range(0, flat.shape[0], step)]
    return {CHUNKED: True, "shape": {str(i): int(d) for i, d in enumerate(leaf.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _pack(out, obj) -> None:
    if obj is None:
        out.write(b"\xc0")
    elif obj is True or obj is False:
        out.write(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, (np.ndarray, torch.Tensor)):
        _write_ndarray(out, obj)
    elif isinstance(obj, np.generic):
        _write_ndarray(out, np.asarray(obj), EXT_NPSCALAR)
    elif type(obj) is int:
        out.write(_int(obj))
    elif type(obj) is float:
        out.write(b"\xcb" + struct.pack(">d", obj))
    elif type(obj) is complex:
        body = b"\x92" + b"".join(b"\xcb" + struct.pack(">d", v) for v in (obj.real, obj.imag))
        out.write(_ext_header(len(body), EXT_COMPLEX) + body)
    elif type(obj) is str:
        out.write(_str(obj))
    elif type(obj) is bytes:
        out.write(_bin_header(len(obj)) + obj)
    elif type(obj) is dict:
        out.write(_sized(len(obj), 16, 0x80, (None, 0xDE, 0xDF)))
        for k, v in obj.items():
            _pack(out, k)
            if (isinstance(v, (np.ndarray, torch.Tensor))
                    and math.prod(v.shape) * _itemsize(v) > MAX_CHUNK_SIZE):
                v = _chunked(v)
            _pack(out, v)
    elif type(obj) in (list, tuple):
        raise ValueError("msgpack: Flax stores a list or tuple as a dict keyed by "
                         "position; pass it so")
    else:
        raise ValueError(f"msgpack: cannot write a {type(obj).__name__}")


def to_bytes(tree) -> bytes:
    """``flax.serialization.to_bytes`` of a tree of dicts (keys str) with
    array, scalar, str, bytes, bool and None leaves."""
    out = io.BytesIO()
    _pack(out, tree)
    return out.getvalue()


def write(path: str, tree) -> int:
    """:func:`to_bytes` of ``tree`` streamed into ``path`` -> its bytes."""
    with open(path, "wb") as f:
        _pack(f, tree)
        return f.tell()
