"""A small PNG codec in numpy and ``zlib`` (the port has no Pillow).

Decodes non-interlaced 8-bit grey, RGB and RGBA images with the five row
filters of the PNG standard (none, sub, up, average, Paeth); encodes 8-bit
RGB with filter 0.  Every other PNG (palette, grey + alpha, 16-bit,
interlaced) and every other format raises.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}   # PNG colour type -> samples per pixel
_UNSUPPORTED = "ROADMAP §A queue item 8 brings GIF and the other PNG kinds"


def _unfilter_row(ftype: int, line: bytes, prev: bytes, bpp: int) -> bytes:
    """One scanline with its filter undone (PNG spec, section 9)."""
    if ftype == 0:
        return line
    cur = np.frombuffer(line, np.uint8)
    if ftype == 1:      # sub: a running sum per channel, mod 256
        out = cur.reshape(-1, bpp).cumsum(axis=0, dtype=np.uint64) % 256
        return out.astype(np.uint8).tobytes()
    if ftype == 2:      # up
        return (cur + np.frombuffer(prev, np.uint8)).tobytes()   # uint8 wraps
    out = bytearray(line)
    n = len(out)
    if ftype == 3:      # average of left and up
        for i in range(n):
            left = out[i - bpp] if i >= bpp else 0
            out[i] = (out[i] + ((left + prev[i]) >> 1)) & 255
        return bytes(out)
    if ftype == 4:      # Paeth predictor of left, up, upper-left
        for i in range(n):
            if i >= bpp:
                a, c = out[i - bpp], prev[i - bpp]
            else:
                a = c = 0
            b = prev[i]
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            out[i] = (out[i] + pred) & 255
        return bytes(out)
    raise ValueError(f"corrupt PNG: unknown row filter {ftype}")


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 (H, W, C), C the image's own samples per pixel
    (1 grey, 3 RGB, 4 RGBA)."""
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"not a PNG file; {_UNSUPPORTED}")
    pos, header, idat = len(_SIGNATURE), None, []
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"corrupt PNG: bad CRC in chunk {kind!r}")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + length
    if header is None:
        raise ValueError("corrupt PNG: no IHDR chunk")
    width, height, depth, colour, _, _, interlace = header
    if depth != 8 or colour not in _CHANNELS or interlace != 0:
        raise ValueError(f"unsupported PNG (bit depth {depth}, colour type {colour}, "
                         f"interlace {interlace}): only non-interlaced 8-bit grey, "
                         f"RGB and RGBA; {_UNSUPPORTED}")
    bpp = _CHANNELS[colour]
    stride = width * bpp
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != height * (stride + 1):
        raise ValueError(f"corrupt PNG: {len(raw)} bytes of image data for "
                         f"{width}x{height}x{bpp}")
    rows, prev = [], bytes(stride)
    for y in range(height):
        start = y * (stride + 1)
        prev = _unfilter_row(raw[start], raw[start + 1:start + 1 + stride], prev, bpp)
        rows.append(prev)
    return np.frombuffer(b"".join(rows), np.uint8).reshape(height, width, bpp).copy()


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
