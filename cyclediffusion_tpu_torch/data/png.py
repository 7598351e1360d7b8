"""A PNG codec in numpy and ``zlib`` (the port has no Pillow).

``decode_png`` reads every PNG that Pillow opens and gives what Pillow's
``Image.open(f).convert("RGB")`` gives: grey, RGB, palette, grey + alpha
and RGBA, at every bit depth the standard allows for the colour type (1,
2, 4, 8 and 16), plain or Adam7-interlaced, with the five row filters.
Pillow's conversions are kept where they are not the obvious ones:

* grey below 8 bits is scaled to 8 (x255, x85, x17), as Pillow's ``1``,
  ``L;2`` and ``L;4`` unpackers do;
* 16-bit grey opens as ``I;16`` and ``convert("RGB")`` clips it at 255
  (it does not scale it);
* 16-bit RGB, RGBA and grey + alpha keep the high byte of each sample;
* a palette index past the ``PLTE`` entries reads black, as Pillow's
  palette holds zeros there;
* alpha and ``tRNS`` are dropped, as ``convert("RGB")`` drops them.

The row filters are undone for all rows at once along anti-diagonals of
the pixel grid (a byte depends only on its left, upper and upper-left
neighbours), so a 512 px image takes about a thousand numpy steps, not a
Python step per byte.  ``encode_png`` writes 8-bit RGB with filter 0.
Any other file raises a ``ValueError`` that names what it is.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> (samples per pixel, the bit depths the standard allows)
_COLOUR_TYPES = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)), 3: (1, (1, 2, 4, 8)),
                 4: (2, (8, 16)), 6: (4, (8, 16))}
# Adam7: (x0, y0, dx, dy) of each of the seven passes
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
          (1, 0, 2, 2), (0, 1, 1, 2))
_GREY_SCALE = {1: 255, 2: 85, 4: 17, 8: 1}


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter_rows(ftypes, data) -> np.ndarray:
    """Rows filtered by none, sub or up only: one vectorised step per row."""
    out = np.empty_like(data)
    prev = np.zeros_like(data[0])
    for y, ftype in enumerate(ftypes):
        if ftype == 1:
            out[y] = data[y].cumsum(axis=0)
        elif ftype == 2:
            out[y] = data[y] + prev
        else:
            out[y] = data[y]
        out[y] &= 255
        prev = out[y]
    return out


def _unfilter_diagonals(ftypes, data) -> np.ndarray:
    """Any filters: pixel (y, x) is undone at step d = x + y, from the
    pixels of steps d - 1 (left, up) and d - 2 (upper left).  Both arrays
    are stored skewed, ``[d, y]``, so each step reads contiguous slices;
    row 0 and steps -2, -1 of the decoded side are the zeros the filters
    see off the image."""
    h, p, bpp = data.shape
    raw = np.zeros((p + h - 1, h, bpp), np.int16)
    for y in range(h):
        raw[y:y + p, y] = data[y]
    dec = np.zeros((p + h + 1, h + 1, bpp), np.int16)
    for d in range(p + h - 1):
        lo, hi = max(0, d - p + 1), min(h - 1, d) + 1
        ft = ftypes[lo:hi, None]
        a = dec[d + 1, lo + 1:hi + 1]       # left
        b = dec[d + 1, lo:hi]               # up
        c = dec[d, lo:hi]                   # upper left
        pred = np.choose(ft, (0, a, b, (a + b) >> 1, _paeth(a, b, c)))
        dec[d + 2, lo + 1:hi + 1] = (raw[d, lo:hi] + pred) & 255
    out = np.empty_like(data)
    for y in range(h):
        out[y] = dec[y + 2:y + 2 + p, y + 1]
    return out


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """``height`` filtered scanlines of ``stride`` bytes -> uint8
    (height, stride)."""
    rows = np.frombuffer(raw, np.uint8).reshape(height, stride + 1)
    ftypes = rows[:, 0].astype(np.intp)
    if (ftypes > 4).any():
        raise ValueError(f"corrupt PNG: unknown row filter {int(ftypes.max())}")
    data = rows[:, 1:].astype(np.int16).reshape(height, stride // bpp, bpp)
    if (ftypes >= 3).any():
        out = _unfilter_diagonals(ftypes, data)
    else:
        out = _unfilter_rows(ftypes, data)
    return out.reshape(height, stride).astype(np.uint8)


def _samples(rows: np.ndarray, width: int, channels: int, depth: int) -> np.ndarray:
    """Unfiltered scanlines -> int32 samples (height, width, channels)."""
    h = rows.shape[0]
    n = width * channels
    if depth == 16:
        pairs = rows.reshape(h, -1, 2).astype(np.int32)
        s = (pairs[..., 0] << 8) | pairs[..., 1]
    elif depth == 8:
        s = rows.astype(np.int32)
    else:
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        s = ((rows[:, :, None] >> shifts) & ((1 << depth) - 1)).reshape(h, -1).astype(np.int32)
    return s[:, :n].reshape(h, width, channels)


def _to_rgb(s: np.ndarray, colour: int, depth: int, palette) -> np.ndarray:
    """Samples -> uint8 RGB as Pillow's mode for the file, then
    ``convert("RGB")``."""
    if colour == 3:
        return palette[s[..., 0]]
    if depth == 16:
        # I;16 -> RGB clips; the other 16-bit unpackers keep the high byte
        s = np.minimum(s, 255) if colour == 0 else s >> 8
    elif colour in (0, 4):
        s = s * _GREY_SCALE[depth]
    if colour in (0, 4):
        return np.repeat(s[..., :1], 3, axis=2).astype(np.uint8)
    return s[..., :3].astype(np.uint8)


def _palette(plte: bytes) -> np.ndarray:
    """``PLTE`` -> a 256-entry uint8 lookup, black past the file's
    entries."""
    if plte is None:
        raise ValueError("corrupt PNG: a palette image without a PLTE chunk")
    if len(plte) % 3 or not 0 < len(plte) <= 768:
        raise ValueError(f"corrupt PNG: a PLTE chunk of {len(plte)} bytes")
    lut = np.zeros((256, 3), np.uint8)
    lut[:len(plte) // 3] = np.frombuffer(plte, np.uint8).reshape(-1, 3)
    return lut


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 (H, W, 3), Pillow's ``convert("RGB")`` of the
    file."""
    if not data.startswith(_SIGNATURE):
        raise ValueError("not a PNG file")
    pos, header, plte, idat = len(_SIGNATURE), None, None, []
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"corrupt PNG: bad CRC in chunk {kind!r}")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + length
    if header is None:
        raise ValueError("corrupt PNG: no IHDR chunk")
    width, height, depth, colour, _, _, interlace = header
    if colour not in _COLOUR_TYPES or depth not in _COLOUR_TYPES[colour][1]:
        raise ValueError(f"unsupported PNG: bit depth {depth} with colour type {colour} "
                         "is not a combination the PNG standard allows")
    if interlace not in (0, 1):
        raise ValueError(f"unsupported PNG: interlace method {interlace}")
    if width == 0 or height == 0:
        raise ValueError(f"corrupt PNG: a {width}x{height} image")
    channels = _COLOUR_TYPES[colour][0]
    palette = _palette(plte) if colour == 3 else None
    bpp = max(1, channels * depth // 8)
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"corrupt PNG: {e}") from None
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    samples = np.empty((height, width, channels), np.int32)
    start = 0
    for x0, y0, dx, dy in passes:
        pw, ph = -(-(width - x0) // dx), -(-(height - y0) // dy)
        if pw <= 0 or ph <= 0:
            continue                            # an empty pass has no scanlines
        stride = -(-pw * channels * depth // 8)
        end = start + ph * (stride + 1)
        if end > len(raw):
            raise ValueError(f"corrupt PNG: {len(raw)} bytes of image data for "
                             f"{width}x{height}, {channels} x {depth}-bit samples")
        rows = _unfilter(raw[start:end], ph, stride, bpp)
        samples[y0::dy, x0::dx] = _samples(rows, pw, channels, depth)
        start = end
    return _to_rgb(samples, colour, depth, palette)


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def encode_png(image: np.ndarray) -> bytes:
    """uint8 (H, W, 3) RGB -> PNG bytes (filter 0 on every row)."""
    image = np.ascontiguousarray(image)
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"encode_png takes uint8 (H, W, 3), got {image.dtype} "
                         f"{image.shape}")
    height, width = image.shape[:2]
    rows = np.concatenate([np.zeros((height, 1), np.uint8),
                           image.reshape(height, width * 3)], axis=1)
    header = struct.pack(">IIBBBBB", width, height, 8, 2, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))


def write_png(path: str, image: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(image))
