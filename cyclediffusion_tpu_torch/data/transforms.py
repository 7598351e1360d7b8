"""Host-side image transforms: file -> uint8 RGB -> float32 HWC in [0, 1]
(counterpart of ``cyclediffusion_tpu.data.transforms``, without Pillow).

Images are numpy uint8 ``(H, W, 3)`` arrays between the steps.  Decoding is
the port's PNG codec (``data/png.py``), GIF decoder (``data/gif.py``) or
JPEG decoder (``data/jpeg.py``), chosen by the file's first bytes as Pillow
chooses, and gives PIL's ``convert("RGB")``: grey is repeated over three
channels, alpha is dropped, a palette is looked up, CMYK goes through
Pillow's ``cmyk2rgb``.  Resizing follows PIL's ``Image.resize`` in its two
passes (horizontal, then vertical), each rounded to uint8 as PIL's 8-bit
path rounds: bilinear, and bicubic with PIL's a = -0.5, by
``torch.nn.functional.interpolate`` (antialiased, so a downscale widens
the filter as PIL's does); Lanczos (a = 3) by PIL's own fixed-point
coefficients (``Resample.c``: 22 fraction bits), so exactly; nearest by
PIL's centre sampling (``Geometry.c``'s ``ImagingScaleAffine``).
"""

from __future__ import annotations

import math
import os
from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from cyclediffusion_tpu_torch.data.gif import decode_gif
from cyclediffusion_tpu_torch.data.jpeg import cmyk_to_rgb, decode_jpeg
from cyclediffusion_tpu_torch.data.png import decode_png

_EXTS = ("jpg", "jpeg", "png", "gif")


def load_image(path: str) -> np.ndarray:
    """An image file -> uint8 (H, W, 3) RGB (``pil_loader``'s counterpart):
    PNG, GIF (its first frame) or JPEG; a file of another format, or one
    of these that the decoders refuse, raises a ``ValueError`` naming it."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        if data.startswith(b"\x89PNG"):
            return decode_png(data)
        if data.startswith(b"GIF8"):
            return decode_gif(data)
        if not data.startswith(b"\xff\xd8"):
            raise ValueError("not a PNG, GIF or JPEG file")
        img = decode_jpeg(data)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None
    if img.shape[2] == 1:          # grey
        return np.repeat(img, 3, axis=2)
    if img.shape[2] == 4:          # CMYK
        return cmyk_to_rgb(img)
    return img


def list_image_files_recursively(data_dir: str) -> List[str]:
    results: List[str] = []
    for entry in sorted(os.listdir(data_dir)):
        full_path = os.path.join(data_dir, entry)
        ext = entry.split(".")[-1]
        if "." in entry and ext.lower() in _EXTS:
            results.append(full_path)
        elif os.path.isdir(full_path):
            results.extend(list_image_files_recursively(full_path))
    return results


def center_crop_long_edge(img: np.ndarray) -> np.ndarray:
    """Square centre crop to the SHORT edge (reference CenterCropLongEdge)."""
    h, w = img.shape[:2]
    size = min(w, h)
    left, top = (w - size) // 2, (h - size) // 2
    return img[top:top + size, left:left + size]


def _round_u8(x: torch.Tensor) -> torch.Tensor:
    return torch.floor(x + 0.5).clamp_(0, 255)


_PRECISION_BITS = 22    # Resample.c: 32 - 8 - 2


def _lanczos(x: float) -> float:
    """Resample.c's ``lanczos_filter``: sinc(x) sinc(x / 3) on [-3, 3)."""
    if not -3.0 <= x < 3.0:
        return 0.0

    def sinc(v):
        return 1.0 if v == 0.0 else math.sin(v * math.pi) / (v * math.pi)
    return sinc(x) * sinc(x / 3.0)


def _lanczos_matrix(in_size: int, out_size: int) -> torch.Tensor:
    """Resample.c's ``precompute_coeffs`` for the Lanczos filter, made
    integers by ``normalize_coeffs_8bpc`` -> float64 (out_size, in_size)
    with the fixed-point weights (exact: every product and sum of them with
    uint8 pixels is an integer below 2**53)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 3.0 * filterscale
    ss = 1.0 / filterscale
    mat = np.zeros((out_size, in_size), np.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [_lanczos((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        total = sum(w)
        for x, wx in enumerate(w):
            k = wx / total if total != 0.0 else wx
            mat[xx, xmin + x] = math.trunc(k * (1 << _PRECISION_BITS) + (0.5 if k >= 0 else -0.5))
    return torch.from_numpy(mat)


def _lanczos_pass(x: torch.Tensor, mat: torch.Tensor, dim: int) -> torch.Tensor:
    """One pass of PIL's 8-bit resample along ``dim`` of float64 (H, W, C)
    pixels: the rounding offset, the weighted sum, ``clip8``."""
    y = torch.tensordot(x, mat, dims=([dim], [1])).movedim(-1, dim)
    return torch.floor((y + (1 << (_PRECISION_BITS - 1))) / (1 << _PRECISION_BITS)).clamp_(0, 255)


def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """Geometry.c's ``ImagingScaleAffine``: the source of output x is
    floor(x0), x0 accumulated from in/out * 0.5 by steps of in/out in
    float64, as PIL adds them."""
    step = in_size / out_size
    return np.cumsum(np.concatenate([[step * 0.5], np.full(out_size - 1, step)])).astype(np.int64)


def resize_to(img: np.ndarray, height: int, width: int,
              interpolation: str = "bilinear") -> np.ndarray:
    """uint8 (H, W, C) -> uint8 (height, width, C), PIL's two rounded passes
    (one gather for nearest)."""
    if interpolation not in ("bilinear", "bicubic", "lanczos", "nearest"):
        raise ValueError(f"interpolation {interpolation!r}: bilinear, bicubic, lanczos or "
                         "nearest")
    img = np.ascontiguousarray(img)
    h, w = img.shape[:2]
    if interpolation == "nearest":
        return img[_nearest_index(h, height)][:, _nearest_index(w, width)]
    if interpolation == "lanczos":
        x = torch.from_numpy(img).to(torch.float64)
        if width != w:
            x = _lanczos_pass(x, _lanczos_matrix(w, width), 1)
        if height != h:
            x = _lanczos_pass(x, _lanczos_matrix(h, height), 0)
        return x.to(torch.uint8).numpy()
    x = torch.from_numpy(img).permute(2, 0, 1)[None].float()
    h, w = x.shape[2:]
    if width != w:
        x = _round_u8(F.interpolate(x, size=(h, width), mode=interpolation,
                                    align_corners=False, antialias=True))
    if height != h:
        x = _round_u8(F.interpolate(x, size=(height, width), mode=interpolation,
                                    align_corners=False, antialias=True))
    return x[0].permute(1, 2, 0).to(torch.uint8).numpy()


def resize(img: np.ndarray, size: int, interpolation: str = "bilinear") -> np.ndarray:
    """torchvision-style Resize: scale the SHORT edge to ``size``."""
    h, w = img.shape[:2]
    if w <= h:
        new_w, new_h = size, int(round(h * size / w))
    else:
        new_w, new_h = int(round(w * size / h)), size
    return resize_to(img, new_h, new_w, interpolation)


def to_array(img: np.ndarray) -> np.ndarray:
    """uint8 HWC -> float32 HWC in [0, 1] (ToTensor without the CHW transpose)."""
    arr = np.asarray(img, dtype=np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[..., None]
    return arr


def data_root() -> str:
    return os.environ.get("CYCLEDIFFUSION_DATA_ROOT", ".")
