"""A GIF decoder in numpy (the port has no Pillow): the first frame, as
Pillow's ``Image.open(f).convert("RGB")`` gives it.

It reads the header and the logical screen, the global and the first
frame's local colour table, the graphic control extension's transparency
index, the variable-width LZW data (clear and end codes, a full 4,096-entry
table kept until the next clear) and interlaced row order; every later
frame is skipped, as ``pil_loader`` skips them.  What the result holds is
Pillow's, where the GIF standard leaves room:

* the image is the logical screen, widened to the first frame if the frame
  runs past it; outside the frame it holds the frame's transparency index,
  or index 0 without one (not the background colour);
* the colours are the frame's table (local, else global), black for an
  index past the table's entries; without a table, or with one that is
  the grey ramp (i, i, i), which Pillow opens as mode ``L``, not ``P``,
  each index is its own grey level.

The LZW decode is the only serial part: one Python step per code.
"""

from __future__ import annotations

import numpy as np

_MAX_CODES = 4096


def _grey_ramp() -> np.ndarray:
    return np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)


def _table(data: bytes, pos: int, flags: int):
    """A colour table after a descriptor with ``flags`` -> (its 256-entry
    lookup, black past its entries; the grey ramp for a table that is
    the ramp, as Pillow reads it as mode ``L``; None without a table),
    the position after it."""
    if not flags & 0x80:
        return None, pos
    n = 3 << ((flags & 7) + 1)
    if pos + n > len(data):
        raise ValueError("GIF: the colour table runs off the end of the file (truncated)")
    table = np.frombuffer(data[pos:pos + n], np.uint8).reshape(-1, 3)
    if np.array_equal(table, _grey_ramp()[:n // 3]):
        return _grey_ramp(), pos + n
    lut = np.zeros((256, 3), np.uint8)
    lut[:n // 3] = table
    return lut, pos + n


def _sub_blocks(data: bytes, pos: int):
    """The data sub-blocks from ``pos`` -> (their bytes joined, the
    position after the terminator)."""
    out = []
    while True:
        if pos >= len(data):
            raise ValueError("GIF: a data block runs off the end of the file (truncated)")
        n = data[pos]
        if n == 0:
            return b"".join(out), pos + 1
        out.append(data[pos + 1:pos + 1 + n])
        pos += 1 + n


def lzw_decode(data: bytes, min_code_size: int, n_pixels: int) -> bytes:
    """GIF's variable-width LZW (least significant bit first) -> the first
    ``n_pixels`` indices.  Raises on a code that is not in the table or
    on data that ends before the image does."""
    if not 1 <= min_code_size <= 11:
        raise ValueError(f"GIF: LZW minimum code size {min_code_size}")
    clear = 1 << min_code_size
    end = clear + 1
    a = np.frombuffer(data + b"\x00" * 4, np.uint8).astype(np.int64)
    win = (a[:-3] | (a[1:-2] << 8) | (a[2:-1] << 16) | (a[3:] << 24)).tolist()
    nbits = 8 * len(data)
    base = [bytes([i]) for i in range(clear)] + [b"", b""]
    table = list(base)
    width = min_code_size + 1
    mask = (1 << width) - 1
    out = bytearray()
    prev = None
    p = 0
    while len(out) < n_pixels:
        if p + width > nbits:
            raise ValueError("GIF: the image data ends before the image (truncated)")
        code = (win[p >> 3] >> (p & 7)) & mask
        p += width
        if code == clear:
            table = list(base)
            width = min_code_size + 1
            mask = (1 << width) - 1
            prev = None
            continue
        if code == end:
            break
        if code < len(table):
            entry = table[code]
            if prev is not None and len(table) < _MAX_CODES:
                table.append(prev + entry[:1])
        elif code == len(table) and prev is not None:
            entry = prev + prev[:1]
            if len(table) < _MAX_CODES:
                table.append(entry)
        else:
            raise ValueError(f"GIF: corrupt LZW data (code {code} with {len(table)} "
                             "table entries)")
        out += entry
        prev = entry
        if len(table) == mask + 1 and width < 12:
            width += 1
            mask = (1 << width) - 1
    if len(out) < n_pixels:
        raise ValueError(f"GIF: {len(out)} pixels of image data for {n_pixels} "
                         "(truncated)")
    return bytes(out[:n_pixels])


def _interlaced_rows(h: int) -> np.ndarray:
    """Row y of the stored order -> its row in the image (passes from rows
    0, 4, 2, 1 every 8, 8, 4, 2)."""
    return np.concatenate([np.arange(start, h, step)
                           for start, step in ((0, 8), (4, 8), (2, 4), (1, 2))])


def decode_gif(data: bytes) -> np.ndarray:
    """GIF bytes -> uint8 (H, W, 3), Pillow's ``convert("RGB")`` of the
    first frame."""
    if data[:6] not in (b"GIF87a", b"GIF89a"):
        raise ValueError("not a GIF file")
    if len(data) < 13:
        raise ValueError("GIF: no logical screen descriptor (truncated)")
    screen_w = data[6] | (data[7] << 8)
    screen_h = data[8] | (data[9] << 8)
    global_lut, pos = _table(data, 13, data[10])
    transparency = None
    while True:
        if pos >= len(data) or data[pos] == 0x3B:
            raise ValueError("GIF: no image in the file")
        kind = data[pos]
        if kind == 0x21:                    # extension
            label = data[pos + 1]
            body, pos = _sub_blocks(data, pos + 2)
            if label == 0xF9 and len(body) >= 4 and body[0] & 1:
                transparency = body[3]      # graphic control extension
            continue
        if kind != 0x2C:
            raise ValueError(f"GIF: unexpected byte 0x{kind:02X} at {pos}")
        if pos + 10 > len(data):
            raise ValueError("GIF: the image descriptor is truncated")
        x0 = data[pos + 1] | (data[pos + 2] << 8)
        y0 = data[pos + 3] | (data[pos + 4] << 8)
        w = data[pos + 5] | (data[pos + 6] << 8)
        h = data[pos + 7] | (data[pos + 8] << 8)
        flags = data[pos + 9]
        local_lut, pos = _table(data, pos + 10, flags)
        if pos >= len(data):
            raise ValueError("GIF: the image data is missing (truncated)")
        min_code_size = data[pos]
        lzw, _ = _sub_blocks(data, pos + 1)
        break
    width, height = max(screen_w, x0 + w), max(screen_h, y0 + h)
    canvas = np.full((height, width), 0 if transparency is None else transparency, np.uint8)
    if w and h:
        frame = np.frombuffer(lzw_decode(lzw, min_code_size, w * h), np.uint8).reshape(h, w)
        if flags & 0x40:
            frame = frame[np.argsort(_interlaced_rows(h))]
        canvas[y0:y0 + h, x0:x0 + w] = frame
    lut = local_lut if local_lut is not None else global_lut
    return (lut if lut is not None else _grey_ramp())[canvas]
