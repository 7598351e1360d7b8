"""Writes the JPEG fixtures under ``tests/data_torch/jpeg/`` and Pillow's
decode of each, for tests and ``chip_smoke.py`` (whose machine has no
Pillow).

    python tests/data_torch/make_jpeg_fixtures.py

Smooth synthetic images made from a seed: three 512x512 "cats" in Pillow's
default format (baseline, 4:2:0, quality 75; the AFHQ release's format) and
one file each at an odd size for 4:4:4, 4:2:2, greyscale and restart
markers.  ``pillow_decode.npz`` holds ``Image.open(f)`` of each as uint8
(H, W, C), keyed by file stem, and the Pillow version that made it.
"""

from __future__ import annotations

import io
import os

import numpy as np
import PIL
from PIL import Image

HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "jpeg")

# stem -> (height, width, channels, Pillow save options)
FIXTURES = {
    "cat_0": (512, 512, 3, dict(quality=75)),
    "cat_1": (512, 512, 3, dict(quality=75)),
    "cat_2": (512, 512, 3, dict(quality=75)),
    "s444_q90": (61, 45, 3, dict(quality=90, subsampling=0)),
    "s422_q50": (37, 70, 3, dict(quality=50, subsampling=1)),
    "grey_q75": (53, 29, 1, dict(quality=75)),
    "rst_q95": (77, 91, 3, dict(quality=95, subsampling=2, restart_marker_blocks=2)),
}


def smooth_image(rng: np.random.Generator, h: int, w: int, c: int) -> np.ndarray:
    """A smooth random image: a coarse random grid resized bicubically (4 x 4
    for a 512 px image, so that its decode stays small in the archive; one
    node per 6 px for the small ones, which carry more detail)."""
    gh, gw = (4, 4) if max(h, w) >= 256 else (h // 6 + 2, w // 6 + 2)
    coarse = (rng.random((gh, gw, c)) * 255).astype(np.uint8)
    img = Image.fromarray(coarse[..., 0] if c == 1 else coarse)
    return np.asarray(img.resize((w, h), Image.BICUBIC))


def main() -> None:
    os.makedirs(HERE, exist_ok=True)
    rng = np.random.default_rng(2024)
    decoded = {"pillow_version": np.array(PIL.__version__)}
    for stem, (h, w, c, opts) in FIXTURES.items():
        buf = io.BytesIO()
        Image.fromarray(smooth_image(rng, h, w, c)).save(buf, "JPEG", **opts)
        with open(os.path.join(HERE, f"{stem}.jpg"), "wb") as f:
            f.write(buf.getvalue())
        arr = np.asarray(Image.open(io.BytesIO(buf.getvalue())))
        decoded[stem] = arr[..., None] if arr.ndim == 2 else arr
    np.savez_compressed(os.path.join(HERE, "pillow_decode.npz"), **decoded)


if __name__ == "__main__":
    main()
