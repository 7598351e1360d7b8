"""Writes the image fixtures under ``tests/data_torch/images/`` and
Pillow's ``Image.open(f).convert("RGB")`` of each, for tests and
``chip_smoke.py`` (whose machine has no Pillow).

    python tests/data_torch/make_image_fixtures.py

Smooth synthetic images made from a seed, at odd sizes, one file per kind
the port's loader reads beyond baseline JPEG and 8-bit PNG, and one 512 px
file for each kind whose decode time ``chip_smoke.py`` reports
(``*_512``).

* Written by Pillow: palette PNGs at 1, 2, 4 and 8 bits, with and without
  ``tRNS``; grey + alpha; 1-bit and 16-bit grey; GIFs (interlaced, with a
  grey palette, two frames); progressive JPEGs at 4:2:0, 4:4:4, in grey
  and with restart markers; a CMYK JPEG.
* Written here, since Pillow writes none of them: Adam7 PNGs (8-bit RGB,
  4-bit palette, 16-bit RGBA, 2-bit grey, and one below 8 px, where
  passes are empty), 2- and 4-bit grey, 16-bit RGB, RGBA and grey + alpha
  PNGs (``zlib`` and the standard's filters, every filter type in turn,
  or Paeth on every row); a GIF whose first frame is smaller than its
  logical screen, with and without a transparency index, and one whose
  first frame carries a local colour table (Pillow's files with their
  descriptors edited); a YCCK JPEG (Pillow's CMYK file with its Adobe
  transform set to 2, which libjpeg then reads as YCCK).

``pillow_rgb.npz`` holds the decode of each, uint8 (H, W, 3), keyed by file
name, and the Pillow version that made it.
"""

from __future__ import annotations

import io
import os
import struct
import zlib

import numpy as np
import PIL
from PIL import Image

HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "images")
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
         (1, 0, 2, 2), (0, 1, 1, 2))


def smooth(rng: np.random.Generator, h: int, w: int, c: int, lo: int = 0, hi: int = 255,
           grid: int = None) -> np.ndarray:
    """A smooth random float image in [lo, hi]: a coarse grid resized
    bicubically (4 x 4 nodes for 512 px, so the files stay small)."""
    g = grid or (4 if max(h, w) >= 256 else max(h, w) // 6 + 2)
    coarse = rng.random((c, g, g)).astype(np.float32)
    planes = [np.asarray(Image.fromarray(p, "F").resize((w, h), Image.BICUBIC)) for p in coarse]
    return lo + (hi - lo) * np.clip(np.stack(planes, axis=-1), 0, 1)


# ---- PNG by hand ------------------------------------------------------------ #

def _pack(samples: np.ndarray, depth: int) -> np.ndarray:
    """int samples (h, w, c) -> scanline bytes (h, stride)."""
    h = samples.shape[0]
    flat = samples.reshape(h, -1).astype(np.int64)
    if depth == 16:
        return flat.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return flat.astype(np.uint8)
    per = 8 // depth
    n = -(-flat.shape[1] // per) * per
    padded = np.zeros((h, n), np.int64)
    padded[:, :flat.shape[1]] = flat
    groups = padded.reshape(h, -1, per)
    shifts = np.arange(8 - depth, -1, -depth)
    return (groups << shifts).sum(axis=2).astype(np.uint8)


def _paeth(a, b, c):
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filter(rows: np.ndarray, bpp: int, ftypes) -> bytes:
    """The standard's forward filters: row y with ``ftypes[y % len]``."""
    x = rows.astype(np.int64)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    ft = np.array([ftypes[y % len(ftypes)] for y in range(len(x))])[:, None]
    pred = np.choose(ft, (0, a, b, (a + b) >> 1, _paeth(a, b, c)))
    out = np.concatenate([ft, (x - pred) % 256], axis=1).astype(np.uint8)
    return out.tobytes()


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def png_bytes(samples: np.ndarray, colour: int, depth: int, ftypes=(0, 1, 2, 3, 4),
              interlace: bool = False, plte: bytes = None) -> bytes:
    h, w, ch = samples.shape
    bpp = max(1, ch * depth // 8)
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    raw = b""
    for x0, y0, dx, dy in passes:
        sub = samples[y0::dy, x0::dx]
        if sub.size:
            raw += _filter(_pack(sub, depth), bpp, ftypes)
    body = _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, int(interlace)))
    if plte is not None:
        body += _chunk(b"PLTE", plte)
    return (b"\x89PNG\r\n\x1a\n" + body + _chunk(b"IDAT", zlib.compress(raw, 9))
            + _chunk(b"IEND", b""))


# ---- Pillow ----------------------------------------------------------------- #

def pil_bytes(img: Image.Image, fmt: str, **opts) -> bytes:
    buf = io.BytesIO()
    img.save(buf, fmt, **opts)
    return buf.getvalue()


def palette_image(rng, h: int, w: int, bits: int) -> Image.Image:
    """A P image of 2**bits random colours over a smooth index field."""
    n = 1 << bits
    idx = np.minimum(smooth(rng, h, w, 1, 0, n)[..., 0], n - 1).astype(np.uint8)
    im = Image.fromarray(idx, "P")
    im.putpalette(rng.integers(0, 256, 3 * n).astype(np.uint8).tobytes())
    return im


# ---- GIF descriptor edits --------------------------------------------------- #

def _gif_parts(data: bytes):
    """(header + screen, global table, blocks before the image, image
    descriptor, local table, the rest) of a GIF's first frame."""
    flags = data[10]
    gct_len = 3 << ((flags & 7) + 1) if flags & 0x80 else 0
    pos = 13 + gct_len
    ext_start = pos
    while data[pos] == 0x21:
        pos += 2
        while data[pos]:
            pos += 1 + data[pos]
        pos += 1
    assert data[pos] == 0x2C
    desc = data[pos:pos + 10]
    lct_len = 3 << ((desc[9] & 7) + 1) if desc[9] & 0x80 else 0
    return (data[:13], data[13:ext_start], data[ext_start:pos], desc,
            data[pos + 10:pos + 10 + lct_len], data[pos + 10 + lct_len:])


def gif_offset_frame(data: bytes, screen, offset) -> bytes:
    """The logical screen set to ``screen`` (w, h), the first frame moved
    to ``offset`` (x, y)."""
    head, gct, ext, desc, lct, rest = _gif_parts(data)
    head = head[:6] + struct.pack("<HH", *screen) + head[10:]
    desc = desc[:1] + struct.pack("<HH", *offset) + desc[5:]
    return head + gct + ext + desc + lct + rest


def gif_local_table(data: bytes) -> bytes:
    """The global colour table moved to the first frame's local table."""
    head, gct, ext, desc, lct, rest = _gif_parts(data)
    assert gct and not lct
    size = head[10] & 7
    head = head[:10] + bytes([head[10] & 0x70]) + head[11:]
    desc = desc[:9] + bytes([(desc[9] & 0x40) | 0x80 | size])
    return head + ext + desc + gct + rest


def jpeg_adobe_transform(data: bytes, transform: int) -> bytes:
    i = data.index(b"\xff\xee") + 4 + 11
    assert data[i - 11:i - 6] == b"Adobe"
    return data[:i] + bytes([transform]) + data[i + 1:]


# ---- the fixtures ----------------------------------------------------------- #

def fixtures() -> dict:
    """File name -> bytes."""
    rng = np.random.default_rng(2025)
    out = {}
    for bits in (1, 2, 4, 8):
        im = palette_image(rng, 37, 29, bits)
        out[f"p{bits}.png"] = pil_bytes(im, "PNG", bits=bits)
        out[f"p{bits}_trns.png"] = pil_bytes(im, "PNG", bits=bits, transparency=1)
    out["p8_alpha.png"] = pil_bytes(palette_image(rng, 21, 33, 8), "PNG",
                                    transparency=bytes(rng.integers(0, 256, 256, np.uint8)))
    out["p8_512.png"] = pil_bytes(palette_image(rng, 512, 512, 8), "PNG")
    out["la.png"] = pil_bytes(Image.fromarray(smooth(rng, 23, 41, 2).astype(np.uint8), "LA"),
                              "PNG")
    out["grey1.png"] = pil_bytes(Image.fromarray(smooth(rng, 19, 45, 1)[..., 0] > 127), "PNG")
    grey16 = Image.frombytes("I;16", (31, 27), smooth(rng, 27, 31, 1, 0, 700)
                             .astype("<u2").tobytes())
    out["grey16.png"] = pil_bytes(grey16, "PNG")

    def by_hand(h, w, ch, depth, colour, **kw):
        hi = (1 << depth) - 1
        return png_bytes(np.rint(smooth(rng, h, w, ch, 0, hi)).astype(np.int64), colour,
                         depth, **kw)

    out["grey2.png"] = by_hand(17, 35, 1, 2, 0)
    out["grey4.png"] = by_hand(29, 13, 1, 4, 0)
    out["rgb16.png"] = by_hand(25, 39, 3, 16, 2)
    out["rgba16.png"] = by_hand(33, 21, 4, 16, 6)
    out["la16.png"] = by_hand(15, 27, 2, 16, 4)
    out["adam7_rgb8.png"] = by_hand(43, 37, 3, 8, 2, interlace=True)
    out["adam7_rgba16.png"] = by_hand(19, 23, 4, 16, 6, interlace=True)
    out["adam7_grey2.png"] = by_hand(21, 11, 1, 2, 0, interlace=True)
    out["adam7_tiny.png"] = by_hand(3, 5, 3, 8, 2, interlace=True)
    pal = rng.integers(0, 256, 48, np.uint8).tobytes()
    idx = np.minimum(smooth(rng, 26, 31, 1, 0, 16), 15).astype(np.int64)
    out["adam7_p4.png"] = png_bytes(idx, 3, 4, interlace=True, plte=pal)
    out["paeth_rgb_512.png"] = by_hand(512, 512, 3, 8, 2, ftypes=(4,))
    out["adam7_rgb_512.png"] = by_hand(512, 512, 3, 8, 2, interlace=True)

    gif = palette_image(rng, 37, 45, 8)
    out["interlaced.gif"] = pil_bytes(gif, "GIF")
    out["grey.gif"] = pil_bytes(Image.fromarray(smooth(rng, 29, 35, 1)[..., 0].astype(np.uint8)),
                                "GIF")
    out["two_frames.gif"] = pil_bytes(gif, "GIF", save_all=True,
                                      append_images=[palette_image(rng, 37, 45, 8)])
    small = palette_image(rng, 18, 22, 4)
    out["offset.gif"] = gif_offset_frame(pil_bytes(small, "GIF"), (31, 27), (5, 7))
    out["offset_trns.gif"] = gif_offset_frame(pil_bytes(small, "GIF", transparency=3),
                                              (31, 27), (6, 2))
    out["local_table.gif"] = gif_local_table(pil_bytes(palette_image(rng, 25, 19, 8), "GIF"))
    out["gif_512.gif"] = pil_bytes(palette_image(rng, 512, 512, 8), "GIF")

    def rgb(h, w):
        return Image.fromarray(smooth(rng, h, w, 3).astype(np.uint8))

    out["prog_420.jpg"] = pil_bytes(rgb(45, 61), "JPEG", quality=80, progressive=True)
    out["prog_444.jpg"] = pil_bytes(rgb(37, 29), "JPEG", quality=90, progressive=True,
                                    subsampling=0)
    out["prog_grey.jpg"] = pil_bytes(Image.fromarray(smooth(rng, 33, 27, 1)[..., 0]
                                                     .astype(np.uint8)),
                                     "JPEG", quality=75, progressive=True)
    out["prog_rst.jpg"] = pil_bytes(rgb(51, 67), "JPEG", quality=95, progressive=True,
                                    restart_marker_blocks=3)
    out["prog_512.jpg"] = pil_bytes(rgb(512, 512), "JPEG", quality=75, progressive=True)
    cmyk = Image.fromarray(smooth(rng, 31, 43, 4).astype(np.uint8), "CMYK")
    out["cmyk.jpg"] = pil_bytes(cmyk, "JPEG", quality=85)
    out["ycck.jpg"] = jpeg_adobe_transform(out["cmyk.jpg"], 2)
    out["cmyk_512.jpg"] = pil_bytes(Image.fromarray(smooth(rng, 512, 512, 4).astype(np.uint8),
                                                    "CMYK"), "JPEG", quality=75)
    for name in ("prog_420", "prog_grey"):
        full = out[f"{name}.jpg"]
        for scans in (1, 2, scan_count(full) - 1):
            out[f"{name}_cut{scans}.jpg"] = progression_cut(full, scans)
    full = out["prog_512.jpg"]
    out[f"prog_512_cut{scan_count(full) - 1}.jpg"] = progression_cut(full, scan_count(full) - 1)
    return out


def progression_cut(data: bytes, scans: int) -> bytes:
    """A progressive file cut after its first ``scans`` scans (EOI added)."""
    starts = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]
    return data[:starts[scans]] + b"\xff\xd9"


def scan_count(data: bytes) -> int:
    return sum(1 for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda")


def pillow_rgb(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


def main() -> None:
    os.makedirs(HERE, exist_ok=True)
    decoded = {"pillow_version": np.array(PIL.__version__)}
    for name, data in fixtures().items():
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        decoded[name] = pillow_rgb(data)
    np.savez_compressed(os.path.join(HERE, "pillow_rgb.npz"), **decoded)


if __name__ == "__main__":
    main()
