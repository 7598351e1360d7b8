"""Host-side image transforms: file -> uint8 RGB -> float32 HWC in [0, 1]
(counterpart of ``cyclediffusion_tpu.data.transforms``, without Pillow).

Images are numpy uint8 ``(H, W, 3)`` arrays between the steps.  Decoding is
the port's PNG codec (``data/png.py``) or baseline JPEG decoder
(``data/jpeg.py``), chosen by the file's first bytes as Pillow chooses, and
keeps RGB as PIL's ``convert("RGB")`` does: grey is repeated over three
channels and alpha is dropped.  Resizing is ``torch.nn.functional.interpolate`` in PIL's two
passes (horizontal, then vertical), each rounded to uint8 as PIL's 8-bit
path rounds: bilinear, and bicubic with PIL's a = -0.5 (antialiased, so a
downscale widens the filter as PIL's does).
"""

from __future__ import annotations

import os
from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from cyclediffusion_tpu_torch.data.jpeg import decode_jpeg
from cyclediffusion_tpu_torch.data.png import decode_png

_EXTS = ("jpg", "jpeg", "png", "gif")


def load_image(path: str) -> np.ndarray:
    """An image file -> uint8 (H, W, 3) RGB (``pil_loader``'s counterpart).
    PNG and baseline JPEG; GIF and any other format raise."""
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(b"\x89PNG"):
        img = decode_png(data)
    elif data.startswith(b"\xff\xd8"):
        img = decode_jpeg(data)
    elif data.startswith(b"GIF8"):
        raise ValueError(f"{path}: GIF is not read yet; ROADMAP §A queue item 8 "
                         "(GIF input)")
    else:
        raise ValueError(f"{path}: not a PNG or JPEG file")
    if img.shape[2] == 1:          # grey
        return np.repeat(img, 3, axis=2)
    return np.ascontiguousarray(img[:, :, :3])


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


def resize_to(img: np.ndarray, height: int, width: int,
              interpolation: str = "bilinear") -> np.ndarray:
    """uint8 (H, W, C) -> uint8 (height, width, C), PIL's two rounded passes."""
    if interpolation not in ("bilinear", "bicubic"):
        raise ValueError(f"interpolation {interpolation!r}: bilinear or bicubic")
    x = torch.from_numpy(np.ascontiguousarray(img)).permute(2, 0, 1)[None].float()
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
