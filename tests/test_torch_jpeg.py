"""The port's baseline JPEG decoder (``data/jpeg.py``) against Pillow's
libjpeg-turbo: 0 values differ, in every mode it reads, at qualities 50,
75 and 95; the committed fixtures that ``chip_smoke.py`` decodes on the
card's host against the decode stored beside them; the port's
``load_image`` against the JAX package's loader; the files it refuses.

Pillow writes baseline 4:2:0, 4:4:4, 4:2:2, greyscale and restart-marker
files.  The layouts it cannot write (4:4:0, one scan per component, RGB
without a colour transform) come from :func:`encode_jpeg` below, a plain
baseline encoder that takes Pillow's own quantisation and Huffman tables
at the same quality; Pillow decodes those files as the reference.
"""

from __future__ import annotations

import io
import os

import numpy as np
import pytest
from PIL import Image

from cyclediffusion_tpu.data.transforms import pil_loader
from cyclediffusion_tpu_torch.data import jpeg, transforms

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "data_torch", "jpeg")
QUALITIES = (50, 75, 95)
SIZES = ((37, 53), (16, 16), (9, 3))      # (H, W): off the MCU grid, exact, tiny


def smooth(seed: int, h: int, w: int, c: int = 3) -> np.ndarray:
    """A smooth image with some texture, uint8 (H, W, C)."""
    rng = np.random.default_rng(seed)
    coarse = (rng.random((h // 6 + 2, w // 6 + 2, c)) * 255).astype(np.uint8)
    img = Image.fromarray(coarse[..., 0] if c == 1 else coarse).resize((w, h), Image.BICUBIC)
    arr = np.asarray(img).astype(np.float32).reshape(h, w, c)
    return np.clip(arr + rng.normal(0, 6, arr.shape), 0, 255).astype(np.uint8)


def pillow_jpeg(img: np.ndarray, **opts) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img[..., 0] if img.shape[2] == 1 else img).save(buf, "JPEG", **opts)
    return buf.getvalue()


def pillow_decode(data: bytes) -> np.ndarray:
    arr = np.asarray(Image.open(io.BytesIO(data)))
    return arr[..., None] if arr.ndim == 2 else arr


# ---- a plain baseline encoder for the layouts Pillow does not write ---------- #

def _segments(data: bytes):
    """(marker, body) of each marker segment before the scan."""
    pos, out = 2, []
    while data[pos + 1] != 0xDA:
        marker, length = data[pos + 1], (data[pos + 2] << 8) | data[pos + 3]
        out.append((marker, data[pos + 4:pos + 2 + length]))
        pos += 2 + length
    return out


def _tables(quality: int):
    """Pillow's quantisation tables (zigzag, by id) and Huffman tables
    ((class, id) -> (counts, symbols)) at ``quality``."""
    qt, ht = {}, {}
    for marker, body in _segments(pillow_jpeg(smooth(0, 16, 16), quality=quality)):
        if marker == 0xDB:
            i = 0
            while i < len(body):
                qt[body[i] & 15] = np.frombuffer(body[i + 1:i + 65], np.uint8).astype(int)
                i += 65
        elif marker == 0xC4:
            i = 0
            while i < len(body):
                counts = list(body[i + 1:i + 17])
                ht[(body[i] >> 4, body[i] & 15)] = (counts, list(body[i + 17:i + 17 + sum(counts)]))
                i += 17 + sum(counts)
    return qt, ht


def _codes(counts, symbols):
    codes, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            codes[symbols[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return codes


class _Bits:
    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, value: int, length: int):
        for i in range(length - 1, -1, -1):
            self.acc = (self.acc << 1) | ((value >> i) & 1)
            self.n += 1
            if self.n == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:
                    self.out.append(0)
                self.acc, self.n = 0, 0

    def flush(self):
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)


def _category(v: int) -> int:
    return int(abs(v)).bit_length()


def _dct_matrix() -> np.ndarray:
    d = np.array([[np.cos((2 * x + 1) * u * np.pi / 16) for x in range(8)] for u in range(8)])
    d[0] /= np.sqrt(2)
    return d / 2


def encode_jpeg(img: np.ndarray, quality: int, sampling, *, interleaved=True, restart=0,
                ids=(1, 2, 3), jfif=True, adobe_transform=None, colour="ycc") -> bytes:
    """uint8 (H, W, C) -> baseline JPEG bytes with the given sampling
    factors ``[(h, v)]`` per component, component ids, optional APP0 /
    APP14 markers, one interleaved scan or one scan per component, and a
    restart interval in MCUs (blocks, for a one-component scan)."""
    qt, ht = _tables(quality)
    h, w, nc = img.shape
    x = img.astype(np.float64)
    if nc == 3 and colour == "ycc":
        r, g, b = x[..., 0], x[..., 1], x[..., 2]
        x = np.stack([0.299 * r + 0.587 * g + 0.114 * b,
                      -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
                      0.5 * r - 0.418688 * g - 0.081312 * b + 128], axis=-1)
    hmax, vmax = max(s[0] for s in sampling), max(s[1] for s in sampling)
    mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    dct, comps = _dct_matrix(), []
    for ci, (ch, cv) in enumerate(sampling):
        fx, fy = hmax // ch, vmax // cv
        p = np.pad(x[..., ci], ((0, (-h) % fy), (0, (-w) % fx)), mode="edge")
        p = p.reshape(p.shape[0] // fy, fy, p.shape[1] // fx, fx).mean(axis=(1, 3))
        cw, chh = -(-w * ch // hmax), -(-h * cv // vmax)
        p = np.pad(p, ((0, mcuy * cv * 8 - p.shape[0]), (0, mcux * ch * 8 - p.shape[1])),
                   mode="edge")
        blocks = p.reshape(mcuy * cv, 8, mcux * ch, 8).transpose(0, 2, 1, 3) - 128
        coef = np.einsum("ux,abxy,vy->abuv", dct, blocks, dct)
        tq = 0 if ci == 0 else 1
        q = np.zeros(64)
        q[jpeg.NATURAL_ORDER] = qt[tq]
        zz = np.rint(coef.reshape(*coef.shape[:2], 64) / q)[..., jpeg.NATURAL_ORDER]
        comps.append(dict(id=ids[ci], h=ch, v=cv, tq=tq, zz=zz.astype(int),
                          bw=-(-cw // 8), bh=-(-chh // 8), tab=0 if ci == 0 else 1))
    dc = {t: _codes(*ht[(0, t)]) for t in (0, 1)}
    ac = {t: _codes(*ht[(1, t)]) for t in (0, 1)}

    def put_block(bits, zz, c, pred):
        diff = int(zz[0]) - pred
        s = _category(diff)
        bits.put(*dc[c["tab"]][s])
        if s:
            bits.put(diff if diff >= 0 else diff + (1 << s) - 1, s)
        run = 0
        last = max([k for k in range(1, 64) if zz[k]] or [0])
        for k in range(1, last + 1):
            v = int(zz[k])
            if v == 0:
                run += 1
                continue
            while run > 15:
                bits.put(*ac[c["tab"]][0xF0])
                run -= 16
            s = _category(v)
            bits.put(*ac[c["tab"]][(run << 4) | s])
            bits.put(v if v >= 0 else v + (1 << s) - 1, s)
            run = 0
        if last < 63:
            bits.put(*ac[c["tab"]][0x00])
        return int(zz[0])

    def scan(scomps, units):
        """units: per MCU, [(scan component, block row, block col)]."""
        bits, out, preds = _Bits(), bytearray(), [0] * len(scomps)
        for n, unit in enumerate(units):
            if restart and n and n % restart == 0:
                bits.flush()
                out += bits.out + bytes([0xFF, 0xD0 + (n // restart - 1) % 8])
                bits, preds = _Bits(), [0] * len(scomps)
            for si, by, bx in unit:
                preds[si] = put_block(bits, scomps[si]["zz"][by, bx], scomps[si], preds[si])
        bits.flush()
        out += bits.out
        header = bytes([len(scomps)]) + b"".join(
            bytes([c["id"], (c["tab"] << 4) | c["tab"]]) for c in scomps) + bytes([0, 63, 0])
        return _marker(0xDA, header) + bytes(out)

    out = bytearray(b"\xff\xd8")
    if jfif:
        out += _marker(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    if adobe_transform is not None:
        out += _marker(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00" + bytes([adobe_transform]))
    for t in sorted(qt):
        out += _marker(0xDB, bytes([t]) + bytes(qt[t].astype(np.uint8)))
    out += _marker(0xC0, bytes([8, h >> 8, h & 255, w >> 8, w & 255, nc]) + b"".join(
        bytes([c["id"], (c["h"] << 4) | c["v"], c["tq"]]) for c in comps))
    for (cls, t), (counts, symbols) in sorted(ht.items()):
        out += _marker(0xC4, bytes([(cls << 4) | t] + counts + symbols))
    if restart:
        out += _marker(0xDD, bytes([restart >> 8, restart & 255]))
    if interleaved and nc > 1:
        units = [[(si, my * c["v"] + v, mx * c["h"] + hh) for si, c in enumerate(comps)
                  for v in range(c["v"]) for hh in range(c["h"])]
                 for my in range(mcuy) for mx in range(mcux)]
        out += scan(comps, units)
    else:
        for c in comps:
            out += scan([c], [[(0, by, bx)] for by in range(c["bh"]) for bx in range(c["bw"])])
    return bytes(out + b"\xff\xd9")


def _marker(code: int, body: bytes) -> bytes:
    return bytes([0xFF, code, (len(body) + 2) >> 8, (len(body) + 2) & 255]) + body


# ---- the decode against Pillow's ------------------------------------------- #

MODES = {   # name -> (channels, bytes from an image at a quality)
    "4:2:0": (3, lambda img, q: pillow_jpeg(img, quality=q, subsampling=2)),
    "4:4:4": (3, lambda img, q: pillow_jpeg(img, quality=q, subsampling=0)),
    "4:2:2": (3, lambda img, q: pillow_jpeg(img, quality=q, subsampling=1)),
    "grey": (1, lambda img, q: pillow_jpeg(img, quality=q)),
    "restart": (3, lambda img, q: pillow_jpeg(img, quality=q, subsampling=2,
                                              restart_marker_blocks=1)),
    "4:4:0": (3, lambda img, q: encode_jpeg(img, q, [(1, 2), (1, 1), (1, 1)])),
    "one_scan_per_component": (3, lambda img, q: encode_jpeg(
        img, q, [(2, 2), (1, 1), (1, 1)], interleaved=False, restart=5)),
    "adobe_rgb": (3, lambda img, q: encode_jpeg(img, q, [(1, 1)] * 3, jfif=False,
                                                adobe_transform=0, colour="rgb")),
    "rgb_component_ids": (3, lambda img, q: encode_jpeg(img, q, [(1, 1)] * 3, jfif=False,
                                                        ids=(0x52, 0x47, 0x42),
                                                        colour="rgb")),
}


@pytest.mark.parametrize("quality", QUALITIES)
@pytest.mark.parametrize("mode", list(MODES))
def test_decode_equals_pillow(mode, quality):
    """Tolerance: none (0 differing values), at sizes off the MCU grid, on
    it, and below one block."""
    channels, make = MODES[mode]
    for i, (h, w) in enumerate(SIZES):
        data = make(smooth(10 * quality + i, h, w, channels), quality)
        want = pillow_decode(data)
        got = jpeg.decode_jpeg(data)
        assert got.dtype == np.uint8 and got.shape == want.shape == (h, w, channels), mode
        assert int((got != want).sum()) == 0, (mode, quality, h, w)


@pytest.mark.parametrize("subsampling", [0, 1, 2])
def test_decode_equals_pillow_at_512(subsampling):
    """A 512 px image of the AFHQ release's size, every Pillow sampling."""
    data = pillow_jpeg(smooth(7, 512, 512), quality=90, subsampling=subsampling)
    np.testing.assert_array_equal(jpeg.decode_jpeg(data), pillow_decode(data))


def test_idct_range_limit_wraps_as_libjpeg():
    """jdmaster.c's post-IDCT table: v + 128 clamped for |v| <= 512, taken
    modulo 1024 beyond."""
    table = jpeg._RANGE_LIMIT
    assert table[0] == 128 and table[127] == 255 and table[128] == 255
    assert table[511] == 255 and table[512] == 0 and table[1023] == 127


def test_committed_fixtures_equal_pillow():
    """The fixtures ``chip_smoke.py`` decodes on the card's host: the decode
    equals the one stored beside them (made by the Pillow version the
    archive names), and this Pillow's decode."""
    stored = np.load(os.path.join(FIXTURES, "pillow_decode.npz"))
    stems = sorted(f[:-4] for f in os.listdir(FIXTURES) if f.endswith(".jpg"))
    assert set(stems) | {"pillow_version"} == set(stored.files)
    assert str(stored["pillow_version"])
    for stem in stems:
        with open(os.path.join(FIXTURES, f"{stem}.jpg"), "rb") as f:
            data = f.read()
        got = jpeg.decode_jpeg(data)
        np.testing.assert_array_equal(got, stored[stem])
        np.testing.assert_array_equal(got, pillow_decode(data))
    assert sum(os.path.getsize(os.path.join(FIXTURES, f))
               for f in os.listdir(FIXTURES)) < 2 * 2**20


@pytest.mark.parametrize("channels", [3, 1])
def test_load_image_matches_the_jax_loader(tmp_path, channels):
    """The port's ``load_image`` and the JAX package's ``pil_loader`` (PIL's
    ``convert("RGB")``) give the same uint8 RGB array on a JPEG, a grey one
    repeated over three channels; ``.JPEG`` is read as ``.jpg`` is."""
    path = str(tmp_path / "img.JPEG")
    with open(path, "wb") as f:
        f.write(pillow_jpeg(smooth(3, 45, 61, channels), quality=80))
    got = transforms.load_image(path)
    want = np.asarray(pil_loader(path))
    assert got.shape == want.shape == (45, 61, 3)
    np.testing.assert_array_equal(got, want)


def _patched(data: bytes, offset_from_sof: int, value: int, sof=b"\xff\xc0") -> bytes:
    i = data.index(sof)
    return data[:i + offset_from_sof] + bytes([value]) + data[i + offset_from_sof + 1:]


@pytest.mark.parametrize("kind,match", [
    ("progressive", "progressive"),
    ("cmyk", "CMYK"),
    ("arithmetic", "arithmetic"),
    ("12-bit", "12-bit"),
    ("lossless", "lossless"),
    ("gif", "GIF"),
    ("truncated", "truncated"),
])
def test_unsupported_files_raise_naming_what_they_are(tmp_path, kind, match):
    img = smooth(5, 24, 24)
    base = pillow_jpeg(img, quality=75)
    if kind == "progressive":
        data = pillow_jpeg(img, quality=75, progressive=True)
    elif kind == "cmyk":
        buf = io.BytesIO()
        Image.fromarray(img).convert("CMYK").save(buf, "JPEG")
        data = buf.getvalue()
    elif kind == "arithmetic":
        data = _patched(base, 1, 0xC9)
    elif kind == "12-bit":
        data = _patched(base, 4, 12)
    elif kind == "lossless":
        data = _patched(base, 1, 0xC3)
    elif kind == "gif":
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "GIF")
        data = buf.getvalue()
    else:
        data = base[:len(base) // 2]
    path = str(tmp_path / ("x.gif" if kind == "gif" else "x.jpg"))
    with open(path, "wb") as f:
        f.write(data)
    with pytest.raises(ValueError, match=match):
        transforms.load_image(path)
