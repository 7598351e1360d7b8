"""Every image file the JAX package's loader reads, through the port's
``load_image``, against the JAX package's ``pil_loader`` (Pillow's
``Image.open(f).convert("RGB")``): 0 values apart, no tolerance.

* The committed fixtures of ``tests/data_torch/images/`` (palette PNGs at
  1-8 bits with and without ``tRNS``, grey + alpha, 1/2/4/16-bit grey,
  16-bit RGB, RGBA and grey + alpha, Adam7 PNGs, GIFs, progressive (some
  cut after an early scan, which libjpeg-turbo smooths), CMYK and YCCK
  JPEGs; ``chip_smoke.py`` decodes the same files on the card's
  host) against ``pil_loader`` and against the decode stored beside them.
* PNGs written here of every colour type at every bit depth the standard
  allows, plain and Adam7, every row filter in turn; GIFs Pillow writes at
  every table size, interlaced or not, with a transparency index, and
  noise that fills the 4,096-code LZW table.
* The SD v1 text-editing preprocessor on a data root whose
  ``data/translate-text.json`` names one file of each new kind: the same
  items as the JAX preprocessor's, pixels within 1/255 (the bilinear
  resize's bound in ``test_torch_data.py``).
* The files the loaders still refuse raise a ``ValueError`` naming what
  they are.
"""

from __future__ import annotations

import io
import json
import os
import shutil
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from cyclediffusion_tpu.data.transforms import pil_loader
from cyclediffusion_tpu_torch.data import gif, png, transforms
from data_torch.make_image_fixtures import png_bytes, smooth
from test_torch_common import REPO

FIXTURES = os.path.join(REPO, "tests", "data_torch", "images")
FILES = sorted(f for f in os.listdir(FIXTURES) if not f.endswith(".npz"))
PIXEL_TOL = 1.0 / 255
# (colour type, bit depth) of every PNG kind the standard allows
PNG_KINDS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1), (3, 2),
             (3, 4), (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def pillow_rgb(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


@pytest.mark.parametrize("name", FILES)
def test_fixture_equals_the_jax_loader(name):
    path = os.path.join(FIXTURES, name)
    got = transforms.load_image(path)
    want = np.asarray(pil_loader(path))
    assert got.dtype == np.uint8 and got.shape == want.shape and got.shape[2] == 3
    assert int((got != want).sum()) == 0
    np.testing.assert_array_equal(got, np.load(os.path.join(FIXTURES, "pillow_rgb.npz"))[name])


def test_fixture_archive_is_complete_and_small():
    stored = np.load(os.path.join(FIXTURES, "pillow_rgb.npz"))
    assert set(stored.files) == set(FILES) | {"pillow_version"}
    kinds = {os.path.splitext(f)[1] for f in FILES}
    assert kinds == {".png", ".gif", ".jpg"}
    assert sum(os.path.getsize(os.path.join(FIXTURES, f))
               for f in os.listdir(FIXTURES)) < 3 * 2 ** 20


@pytest.mark.parametrize("interlace", [False, True], ids=["plain", "adam7"])
@pytest.mark.parametrize("colour,depth", PNG_KINDS)
def test_png_kind_equals_pillow(colour, depth, interlace):
    """Odd sizes (one below the Adam7 cell, where passes are empty), the
    five filters in turn; a palette of fewer entries than the depth
    allows, so that an index past it reads black as in Pillow."""
    rng = np.random.default_rng(100 * colour + depth + interlace)
    plte = None
    hi = (1 << depth) - 1
    if colour == 3:
        plte = rng.integers(0, 256, 3 * max(1, (hi + 1) * 3 // 4), np.uint8).tobytes()
    for h, w in ((23, 17), (5, 3)):
        samples = np.rint(smooth(rng, h, w, CHANNELS[colour], 0, hi)).astype(np.int64)
        samples[0, 0] = hi                          # the extremes of the range
        samples[-1, -1] = 0
        data = png_bytes(samples, colour, depth, interlace=interlace, plte=plte)
        got = png.decode_png(data)
        assert got.shape == (h, w, 3)
        np.testing.assert_array_equal(got, pillow_rgb(data))


def test_png_sixteen_bit_grey_clips_as_pillow():
    """``I;16`` -> RGB clips at 255 (values above 255 do not scale)."""
    samples = np.array([[[0], [255], [256], [55745]]], np.int64)
    data = png_bytes(samples, 0, 16)
    np.testing.assert_array_equal(png.decode_png(data)[0, :, 0], [0, 255, 255, 255])
    np.testing.assert_array_equal(png.decode_png(data), pillow_rgb(data))


@pytest.mark.parametrize("bits", range(1, 9))
def test_gif_equals_pillow(bits):
    """Pillow's GIFs of a 2**bits-colour image: interlaced (16 px and up)
    and not, with a transparency index, and 1 x 1."""
    rng = np.random.default_rng(bits)
    n = 1 << bits
    for (h, w), opts in (((41, 27), {}), ((19, 33), {"interlace": 0}),
                         ((17, 16), {"transparency": n - 1}), ((1, 1), {})):
        im = Image.fromarray(rng.integers(0, n, (h, w)).astype(np.uint8), "P")
        im.putpalette(rng.integers(0, 256, 3 * n).astype(np.uint8).tobytes())
        buf = io.BytesIO()
        im.save(buf, "GIF", **opts)
        data = buf.getvalue()
        np.testing.assert_array_equal(gif.decode_gif(data), pillow_rgb(data))


@pytest.mark.parametrize("mode", ["RGB", "L", "1"])
def test_gif_of_noise_fills_the_lzw_table(mode):
    """Noise at 8 bits overflows the 4,096 codes (Pillow's encoder then
    clears the table); grey and 1-bit tables are read as Pillow reads
    them."""
    rng = np.random.default_rng(7)
    im = Image.fromarray(rng.integers(0, 256, (150, 170, 3)).astype(np.uint8)).convert(mode)
    buf = io.BytesIO()
    im.save(buf, "GIF")
    data = buf.getvalue()
    np.testing.assert_array_equal(gif.decode_gif(data), pillow_rgb(data))


def test_gif_skips_later_frames():
    """The first frame of a two-frame GIF, as ``pil_loader`` gives it."""
    path = os.path.join(FIXTURES, "two_frames.gif")
    with Image.open(path) as im:
        assert im.n_frames == 2
    np.testing.assert_array_equal(transforms.load_image(path), np.asarray(pil_loader(path)))


def test_translate_preprocessor_reads_every_kind_as_jax(tmp_path, monkeypatch):
    """The SD v1 task's preprocessor (512 px) on one fixture of each new
    kind, the port's against the JAX package's."""
    from test_torch_data import _dev

    from cyclediffusion_tpu.runtime.config import Args as JArgs
    from cyclediffusion_tpu.runtime.config import get_config as jget_config
    from cyclediffusion_tpu.runtime.registry import get_preprocessor as jget_preprocessor
    from cyclediffusion_tpu_torch.runtime.config import Args, get_config
    from cyclediffusion_tpu_torch.runtime.registry import get_preprocessor

    names = ["p4_trns.png", "rgb16.png", "adam7_rgb8.png", "interlaced.gif", "prog_420.jpg",
             "cmyk.jpg"]
    (tmp_path / "data" / "imgs").mkdir(parents=True)
    for name in names:
        shutil.copy(os.path.join(FIXTURES, name), tmp_path / "data" / "imgs" / name)
    rows = [{"encode_text": f"an image {i}", "decode_text": f"a painting {i}",
             "img_path": f"./data/imgs/{name}"} for i, name in enumerate(names)]
    (tmp_path / "data" / "translate-text.json").write_text(json.dumps(rows))
    monkeypatch.setenv("CYCLEDIFFUSION_DATA_ROOT", str(tmp_path))
    rng = [0, len(names)]
    want = _dev(jget_config, jget_preprocessor, JArgs, "translate_text512", rng)["dev"]
    got = _dev(get_config, get_preprocessor, Args, "translate_text512", rng)["dev"]
    assert len(got) == len(want) == len(names)
    for i in range(len(names)):
        a, b = got[i], want[i]
        assert a["model_kwargs"] == b["model_kwargs"]
        assert a["original_image"].shape == b["original_image"].shape == (512, 512, 3)
        assert float(np.abs(a["original_image"] - b["original_image"]).max()) <= PIXEL_TOL + 1e-7


def _png_with_header(depth: int, colour: int) -> bytes:
    header = struct.pack(">IIBBBBB", 4, 4, depth, colour, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + struct.pack(">I", 13) + b"IHDR" + header
            + struct.pack(">I", zlib.crc32(b"IHDR" + header)))


def _refused(kind: str) -> bytes:
    if kind == "png_rgb_4bit":
        return _png_with_header(4, 2)
    if kind == "png_palette_16bit":
        return _png_with_header(16, 3)
    if kind == "png_palette_without_plte":
        return png_bytes(np.zeros((4, 4, 1), np.int64), 3, 8)
    if kind == "png_bad_crc":
        data = bytearray(png_bytes(np.zeros((4, 4, 3), np.int64), 2, 8))
        data[29] ^= 1
        return bytes(data)
    if kind == "gif_without_image":
        return b"GIF89a" + struct.pack("<HH", 4, 4) + b"\x00\x00\x00;"
    if kind == "gif_truncated":
        buf = io.BytesIO()
        Image.fromarray(np.arange(64, dtype=np.uint8).reshape(8, 8), "L").save(buf, "GIF")
        return buf.getvalue()[:-12]
    return b"BM" + bytes(60)


@pytest.mark.parametrize("kind,match", [
    ("png_rgb_4bit", "bit depth 4 with colour type 2"),
    ("png_palette_16bit", "bit depth 16 with colour type 3"),
    ("png_palette_without_plte", "without a PLTE"),
    ("png_bad_crc", "bad CRC"),
    ("gif_without_image", "no image"),
    ("gif_truncated", "truncated"),
    ("bitmap", "not a PNG, GIF or JPEG"),
])
def test_refused_files_name_what_they_are(tmp_path, kind, match):
    """Pillow refuses the first two too (no mode for them); the port names
    the file and what it is."""
    path = tmp_path / f"x.{kind.split('_')[0]}"
    path.write_bytes(_refused(kind))
    with pytest.raises(ValueError, match=match) as err:
        transforms.load_image(str(path))
    assert str(path) in str(err.value)
