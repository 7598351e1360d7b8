"""The port's data layer against the JAX package's: the PNG codec, the
transforms, the text-editing preprocessors on ``data/translate-text.json``
and the multi-task merge.

The JAX preprocessors decode and resize with Pillow, the port's with its
own PNG codec and ``torch.nn.functional.interpolate`` in Pillow's two
rounded passes.  Ids, texts, ``model_kwargs`` and shapes must be equal;
pixels may differ by at most 1/255 (Pillow's fixed-point uint8 bilinear
against float weights rounded once per pass).  Measured: 0 at every pixel
of the repo's three images, at 512 px (a 2x upscale) and 256 px.
"""

import io
import os

import numpy as np
import pytest
from PIL import Image

from cyclediffusion_tpu.data.preprocess import to_model as jto_model
from cyclediffusion_tpu.runtime.config import Args as JArgs
from cyclediffusion_tpu.runtime.config import get_config as jget_config
from cyclediffusion_tpu.runtime.registry import get_preprocessor as jget_preprocessor
from cyclediffusion_tpu_torch.data import build_raw_datasets
from cyclediffusion_tpu_torch.data import png, transforms
from cyclediffusion_tpu_torch.data.preprocess.to_model import (
    MultiTaskDataset,
    SplitArgpathWrapper,
    StrideWrapper,
    get_multi_task_dataset_splits,
    upsample,
)
from cyclediffusion_tpu_torch.runtime.config import Args, get_config
from cyclediffusion_tpu_torch.runtime.registry import get_preprocessor
from test_torch_common import REPO

PIXEL_TOL = 1.0 / 255
IMAGES = ["bear", "trees", "cat"]


def _dev(get_cfg, get_pre, args_cls, task, rng):
    task_args = get_cfg(f"tasks/{task}.cfg")
    meta = args_cls(raw_data=args_cls(range=rng, upsample_temp=1))
    pre = get_pre(task_args.preprocess.preprocess_program)(task_args, meta)
    return pre.preprocess({"train": [], "validation": [], "test": []}, cache_root="unused")


@pytest.mark.parametrize("task,rng,res", [("translate_text512", [0, 4], 512),
                                          ("translate_text256", [5, 7], 256),
                                          ("tiny_translate_text", [0, 4], 32)])
def test_preprocessor_matches_jax(task, rng, res, monkeypatch):
    monkeypatch.setenv("CYCLEDIFFUSION_DATA_ROOT", REPO)
    want = _dev(jget_config, jget_preprocessor, JArgs, task, rng)
    got = _dev(get_config, get_preprocessor, Args, task, rng)
    assert len(got["train"]) == len(want["train"]) == 0
    assert len(got["dev"]) == len(want["dev"]) == rng[1] - rng[0]
    worst = 0.0
    for i in range(len(want["dev"])):
        a, b = got["dev"][i], want["dev"][i]
        assert a["model_kwargs"] == b["model_kwargs"]
        assert a.keys() == b.keys()
        assert int(a["sample_id"]) == int(b["sample_id"]) == i
        assert (a["encode_text"], a["decode_text"]) == (b["encode_text"], b["decode_text"])
        assert a["original_image"].dtype == np.float32
        assert a["original_image"].shape == b["original_image"].shape == (res, res, 3)
        worst = max(worst, float(np.abs(a["original_image"] - b["original_image"]).max()))
    assert worst <= PIXEL_TOL + 1e-7


@pytest.mark.parametrize("name", IMAGES)
def test_png_decodes_like_pil(name):
    path = os.path.join(REPO, "data", "prompt2prompt", f"{name}.png")
    got = transforms.load_image(path)
    with Image.open(path) as im:
        assert im.mode == "RGBA"
        want = np.asarray(im.convert("RGB"))
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode,channels", [("L", 1), ("RGB", 3), ("RGBA", 4)])
def test_png_colour_types_and_filters(mode, channels, tmp_path):
    """Every colour type decodes to Pillow's RGB (Pillow's encoder picks the
    sub, up and Paeth filters here)."""
    rng = np.random.default_rng(channels)
    base = np.linspace(0, 255, 40)[None, :, None] + np.linspace(0, 60, 23)[:, None, None]
    arr = np.clip(base + rng.integers(0, 40, (23, 40, channels)), 0, 255).astype(np.uint8)
    path = str(tmp_path / "x.png")
    Image.fromarray(arr[..., 0] if channels == 1 else arr, mode).save(path)
    got = transforms.load_image(path)
    with Image.open(path) as im:
        np.testing.assert_array_equal(got, np.asarray(im.convert("RGB")))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filtered_png(img, ftypes):
    """An RGB PNG whose row y is written with filter ``ftypes[y]`` (the
    spec's forward transform, byte by byte)."""
    import struct
    import zlib
    h, w, bpp = img.shape
    rows, prev = [], [0] * (w * bpp)
    for y in range(h):
        cur = [int(v) for v in img[y].reshape(-1)]
        out = []
        for i, x in enumerate(cur):
            a = cur[i - bpp] if i >= bpp else 0
            b, c = prev[i], (prev[i - bpp] if i >= bpp else 0)
            pred = [0, a, b, (a + b) // 2, _paeth(a, b, c)][ftypes[y]]
            out.append((x - pred) % 256)
        rows.append(bytes([ftypes[y]] + out))
        prev = cur

    def chunk(kind, body):
        crc = struct.pack(">I", zlib.crc32(kind + body))
        return struct.pack(">I", len(body)) + kind + body + crc
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))


def test_png_decodes_all_five_row_filters():
    img = np.random.default_rng(4).integers(0, 256, (10, 7, 3), dtype=np.uint8)
    data = _filtered_png(img, [0, 1, 2, 3, 4, 4, 3, 2, 1, 0])
    np.testing.assert_array_equal(png.decode_png(data), img)
    with Image.open(io.BytesIO(data)) as im:
        np.testing.assert_array_equal(np.asarray(im), img)


def test_png_round_trip_and_pil_reads_ours():
    img = np.random.default_rng(0).integers(0, 256, (9, 13, 3), dtype=np.uint8)
    data = png.encode_png(img)
    np.testing.assert_array_equal(png.decode_png(data), img)
    with Image.open(io.BytesIO(data)) as im:
        np.testing.assert_array_equal(np.asarray(im), img)


def test_unsupported_images_raise(tmp_path):
    for mode, shape in (("P", (4, 4)), ("LA", (4, 4, 2))):
        path = str(tmp_path / f"{mode}.png")
        Image.fromarray(np.zeros(shape, np.uint8), mode).save(path)
        with pytest.raises(ValueError, match="ROADMAP"):
            transforms.load_image(path)
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(str(tmp_path / "x.jpg"),
                                                         progressive=True)
    with pytest.raises(ValueError, match="progressive"):
        transforms.load_image(str(tmp_path / "x.jpg"))
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(str(tmp_path / "x.gif"))
    with pytest.raises(ValueError, match="ROADMAP"):
        transforms.load_image(str(tmp_path / "x.gif"))
    with pytest.raises(ValueError, match="not a PNG"):
        png.decode_png(b"GIF89a")


@pytest.mark.parametrize("size,interp", [(512, "bilinear"), (100, "bilinear"),
                                         (256, "bicubic"), (71, "bicubic")])
def test_resize_matches_pil(size, interp):
    """Up- and downscaling; Pillow rounds its fixed-point weights, so a
    pixel may differ by 1."""
    img = transforms.load_image(os.path.join(REPO, "data", "prompt2prompt", "trees.png"))
    crop = transforms.center_crop_long_edge(img[:, 20:])
    assert crop.shape == (236, 236, 3)
    method = {"bilinear": Image.BILINEAR, "bicubic": Image.BICUBIC}[interp]
    want = np.asarray(Image.fromarray(crop).resize((size, size), method)).astype(int)
    got = transforms.resize(crop, size, interp).astype(int)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1


def test_crop_and_short_edge_resize_shapes():
    img = np.zeros((30, 50, 3), np.uint8)
    assert transforms.center_crop_long_edge(img).shape == (30, 30, 3)
    assert transforms.resize(img, 15).shape == (15, 25, 3)
    assert transforms.to_array(np.full((2, 2), 255, np.uint8)).shape == (2, 2, 1)


def test_list_image_files_recursively():
    files = transforms.list_image_files_recursively(os.path.join(REPO, "data"))
    assert [os.path.basename(f) for f in files] == ["bear.png", "cat.png", "trees.png"]


def test_raw_datasets():
    raw = build_raw_datasets("empty")
    assert sorted(raw) == ["test", "train", "validation"] and len(raw["train"]) == 1000
    with pytest.raises(ValueError):
        build_raw_datasets("other")


class _DS(list):
    pass


def _items(n, name="t"):
    return [{"sample_id": i, "model_kwargs": ["sample_id"], "payload": name} for i in range(n)]


def test_upsample_matches_jax():
    import random
    random.seed(3)
    want = jto_model.upsample(_items(4), 2.5)
    random.seed(3)
    data = _items(4)
    got = upsample(data, 2.5)
    assert got == want and len(got) == 10
    got[0]["sample_id"] = 999            # deep copies
    assert data[0]["sample_id"] == 0


def test_stride_and_split_wrappers_match_jax():
    ds = _DS(_items(10))
    for mod in (jto_model, None):
        stride = (mod.StrideWrapper if mod else StrideWrapper)(ds, 3)
        assert len(stride) == 3 and stride[1]["sample_id"] == 3
        tagged = (mod.SplitArgpathWrapper if mod else SplitArgpathWrapper)(ds, "dev", "mytask")
        assert (tagged[0]["split"], tagged[0]["name"]) == ("dev", "mytask")


@pytest.mark.parametrize("eval_num", [None, 3, 20])
def test_multi_task_dataset_matches_jax(eval_num):
    jmeta = JArgs(raw_data=JArgs(upsample_temp=1, eval_num=eval_num))
    meta = Args(raw_data=Args(upsample_temp=1, eval_num=eval_num))
    want = jto_model.MultiTaskDataset(jmeta, {"b": _DS(_items(9, "b")), "a": _DS(_items(2, "a"))},
                                      split="dev")
    got = MultiTaskDataset(meta, {"b": _DS(_items(9, "b")), "a": _DS(_items(2, "a"))},
                           split="dev")
    assert len(got) == len(want)
    assert got.data.dataset == want.data.dataset
    assert [got[i] for i in range(len(got))] == [want[i] for i in range(len(want))]
    assert set(got[0]) == {"sample_id"}


def test_missing_eval_num_means_no_striding():
    """The SD experiments' ``[raw_data]`` has no ``eval_num``."""
    splits = get_multi_task_dataset_splits(
        Args(raw_data=Args(upsample_temp=1, range=[0, 5])),
        {"t": {"train": _DS(), "dev": _DS(_items(5))}})
    assert len(splits["dev"]) == len(splits["test"]) == 5 and len(splits["train"]) == 0
    assert splits["test"].data[0]["split"] == "test"
