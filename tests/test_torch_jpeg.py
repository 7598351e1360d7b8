"""The port's JPEG decoder (``data/jpeg.py``) against Pillow's
libjpeg-turbo: 0 values differ, in every mode it reads, at qualities 50,
75 and 95, baseline and progressive, CMYK and YCCK; progressive files
cut after every scan (a progression that stops early, which libjpeg-turbo
smooths) in eleven layouts; the committed fixtures
that ``chip_smoke.py`` decodes on the card's host against the decode
stored beside them; the port's ``load_image`` against the JAX package's
loader; the files it refuses.

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
from data_torch.make_image_fixtures import jpeg_adobe_transform, progression_cut, scan_count

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


PROGRESSIVE = {   # name -> (channels, Pillow save options)
    "4:2:0": (3, dict(subsampling=2)),
    "4:4:4": (3, dict(subsampling=0)),
    "4:2:2": (3, dict(subsampling=1)),
    "grey": (1, {}),
    "restart": (3, dict(subsampling=2, restart_marker_blocks=1)),
}


@pytest.mark.parametrize("quality", QUALITIES)
@pytest.mark.parametrize("mode", list(PROGRESSIVE))
def test_progressive_decode_equals_pillow(mode, quality):
    """libjpeg's progression (DC first and refinement scans, AC spectral
    bands with end-of-band runs, AC refinement scans), 0 values apart, at
    the sizes of the baseline test."""
    channels, opts = PROGRESSIVE[mode]
    for i, (h, w) in enumerate(SIZES):
        data = pillow_jpeg(smooth(20 * quality + i, h, w, channels), quality=quality,
                           progressive=True, **opts)
        assert b"\xff\xc2" in data
        got = jpeg.decode_jpeg(data)
        assert got.shape == (h, w, channels)
        np.testing.assert_array_equal(got, pillow_decode(data))


def _cmyk_jpeg(img: np.ndarray, quality: int, transform: int = 0) -> bytes:
    """Pillow's CMYK JPEG (stored inverted, an Adobe marker with transform
    0); transform 2 makes libjpeg read the same data as YCCK."""
    buf = io.BytesIO()
    Image.fromarray(img, "CMYK").save(buf, "JPEG", quality=quality)
    data = buf.getvalue()
    i = data.index(b"\xff\xee") + 4 + 11
    return data[:i] + bytes([transform]) + data[i + 1:]


@pytest.mark.parametrize("quality", QUALITIES)
@pytest.mark.parametrize("transform", [0, 2], ids=["cmyk", "ycck"])
def test_four_component_decode_equals_pillow(transform, quality):
    """``decode_jpeg`` is Pillow's CMYK mode value for value, and
    ``load_image`` its ``convert("RGB")`` (``pil_loader``), 0 apart."""
    for i, (h, w) in enumerate(SIZES):
        data = _cmyk_jpeg(smooth(30 * quality + i, h, w, 4), quality, transform)
        got = jpeg.decode_jpeg(data)
        assert got.shape == (h, w, 4)
        np.testing.assert_array_equal(got, pillow_decode(data))
        with Image.open(io.BytesIO(data)) as im:
            np.testing.assert_array_equal(jpeg.cmyk_to_rgb(got), np.asarray(im.convert("RGB")))


def test_cmyk_to_rgb_is_pillows_formula():
    """(C, M, Y, K) = (200, 0, 0, 100) gives R = 33, not 255 - min(255, C + K)."""
    cmyk = np.random.default_rng(5).integers(0, 256, (64, 64, 4)).astype(np.uint8)
    cmyk[0, 0] = (200, 0, 0, 100)
    got = jpeg.cmyk_to_rgb(cmyk)
    assert tuple(got[0, 0]) == (33, 155, 155)
    np.testing.assert_array_equal(got, np.asarray(Image.fromarray(cmyk, "CMYK").convert("RGB")))


@pytest.mark.parametrize("kind", ["progressive", "progressive_cut", "cmyk", "ycck"])
def test_progressive_and_cmyk_files_match_the_jax_loader(tmp_path, kind):
    path = str(tmp_path / "img.jpg")
    img = smooth(9, 45, 61, 4 if kind in ("cmyk", "ycck") else 3)
    with open(path, "wb") as f:
        if kind.startswith("progressive"):
            data = pillow_jpeg(img, quality=85, progressive=True)
            f.write(progression_cut(data, 3) if kind == "progressive_cut" else data)
        else:
            f.write(_cmyk_jpeg(img, 85, 2 if kind == "ycck" else 0))
    got = transforms.load_image(path)
    assert got.shape == (45, 61, 3)
    np.testing.assert_array_equal(got, np.asarray(pil_loader(path)))


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


# progressive files whose progression stops early, which libjpeg-turbo
# smooths: name -> (H, W, channels, Pillow's save options; "ycck" sets the
# Adobe transform of a CMYK file to 2)
CUT_LAYOUTS = {
    "420": (45, 61, 3, {}),
    "444": (37, 29, 3, {"subsampling": 0}),
    "grey": (33, 27, 1, {}),
    "restart": (51, 67, 3, {"restart_marker_blocks": 3}),
    # 3 luma block rows at 4:2:0: the second-last iMCU row reads the last's
    # padding row, the last reads its own rows only; chroma 2 blocks wide
    "420_odd_rows": (17, 40, 3, {}),
    "422_off_grid": (37, 29, 3, {"subsampling": 1}),
    "one_block_row": (5, 37, 3, {}),
    "grey_one_block_row": (8, 64, 1, {}),
    "two_block_columns": (16, 16, 3, {"subsampling": 0}),
    "cmyk": (31, 43, 4, {}),
    "ycck": (29, 22, 4, {}),
}


def _progressive(name: str, quality: int) -> bytes:
    h, w, c, opts = CUT_LAYOUTS[name]
    img = smooth(len(name) + quality, h, w, c)
    if c < 4:
        return pillow_jpeg(img, quality=quality, progressive=True, **opts)
    buf = io.BytesIO()
    Image.fromarray(img, "CMYK").save(buf, "JPEG", quality=quality, progressive=True)
    data = buf.getvalue()
    return jpeg_adobe_transform(data, 2) if name == "ycck" else data


@pytest.mark.parametrize("quality", [50, 90])
@pytest.mark.parametrize("name", list(CUT_LAYOUTS))
def test_progression_cut_after_every_scan_equals_pillow(name, quality):
    """The file cut after each scan from the first to the last but one:
    the decode, smoothed as libjpeg-turbo smooths it, equals Pillow's value
    for value (its ``convert("RGB")`` for CMYK and YCCK)."""
    full = _progressive(name, quality)
    n = scan_count(full)
    assert n >= 6
    changed = 0
    for scans in range(1, n):
        data = progression_cut(full, scans)
        got = jpeg.decode_jpeg(data)
        with Image.open(io.BytesIO(data)) as im:
            want = np.asarray(im)
            rgb = np.asarray(im.convert("RGB"))
        np.testing.assert_array_equal(got, want.reshape(got.shape), err_msg=f"cut {scans}")
        if got.shape[2] == 4:
            np.testing.assert_array_equal(jpeg.cmyk_to_rgb(got), rgb)
        changed += int(not np.array_equal(got, jpeg.decode_jpeg(full)))
    assert changed == n - 1     # each cut decodes to another image than the full file


def test_smoothing_applies_only_where_libjpeg_smooths(monkeypatch):
    """A baseline file and a complete progression are not smoothed; a cut
    one is, and its DC-only cut has its DC interpolated too."""
    frames = []
    reconstruct = jpeg._reconstruct
    monkeypatch.setattr(jpeg, "_reconstruct",
                        lambda frame, *a: frames.append(frame) or reconstruct(frame, *a))

    def frame_of(data):
        jpeg.decode_jpeg(data)
        return frames[-1]

    img = smooth(4, 24, 32)
    assert not jpeg._smoothing_ok(frame_of(pillow_jpeg(img, quality=75)))
    full = pillow_jpeg(img, quality=75, progressive=True)
    assert not jpeg._smoothing_ok(frame_of(full))
    for scans in (1, 2, scan_count(full) - 1):
        frame = frame_of(progression_cut(full, scans))
        assert jpeg._smoothing_ok(frame)
        assert all(b == -1 for b in frame.comps[0].coef_bits[1:10]) == (scans == 1)


def test_neighbourhoods_replicate_edges_as_libjpeg():
    """Columns clamp at the row's ends; rows follow libjpeg-turbo's iMCU
    rows: at 4:2:0 with 3 luma block rows (2 iMCU rows, the last holding
    one real row) row 1 reads the padding row 3 two below, and row 2 reads
    row 1 for both rows above."""
    np.testing.assert_array_equal(jpeg._neighbour_cols(2), [[0, 0, 0, 1, 1], [0, 0, 1, 1, 1]])
    np.testing.assert_array_equal(jpeg._neighbour_rows(3, 2, 2),
                                  [[0, 0, 0, 1, 2], [0, 0, 1, 2, 3], [1, 1, 2, 2, 2]])
    np.testing.assert_array_equal(jpeg._neighbour_rows(4, 1, 4),
                                  [[0, 0, 0, 1, 2], [0, 0, 1, 2, 3], [0, 1, 2, 3, 3],
                                   [1, 2, 3, 3, 3]])
    np.testing.assert_array_equal(jpeg._neighbour_rows(1, 2, 1), [[0, 0, 0, 0, 0]])


@pytest.mark.parametrize("kind,match", [
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
    if kind == "cmyk":            # two components: Pillow has no mode for it
        buf = io.BytesIO()
        Image.fromarray(img).convert("CMYK").save(buf, "JPEG")
        data = _patched(buf.getvalue(), 9, 2)
    elif kind == "arithmetic":
        data = _patched(base, 1, 0xC9)
    elif kind == "12-bit":
        data = _patched(base, 4, 12)
    elif kind == "lossless":
        data = _patched(base, 1, 0xC3)
    elif kind == "gif":             # a GIF without an image
        data = b"GIF89a\x18\x00\x18\x00\x00\x00\x00;"
    else:
        data = base[:len(base) // 2]
    path = str(tmp_path / ("x.gif" if kind == "gif" else "x.jpg"))
    with open(path, "wb") as f:
        f.write(data)
    with pytest.raises(ValueError, match=match):
        transforms.load_image(path)
