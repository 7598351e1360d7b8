"""Image-grid visualizer: interleave (original, translated[, aux]) rows
(counterpart of ``cyclediffusion_tpu.visualization.multi_image``).

Stacks the k image sets per sample, nearest-upsamples a smaller third set,
keeps at most 100*k tiles, and writes ``{description}_{step:06d}.png`` (8
tiles per row, 2-pixel padding) and a copy of 256 px bicubic tiles,
``{description}_256_{step:06d}.png``.  Images are float HWC [0, 1] numpy.
"""

from __future__ import annotations

import os

import numpy as np

from cyclediffusion_tpu_torch.data.png import write_png
from cyclediffusion_tpu_torch.data.transforms import resize_to
from cyclediffusion_tpu_torch.evaluation.utils import to_uint8


def _make_grid(images: np.ndarray, nrows: int = 8, pad: int = 2) -> np.ndarray:
    """(N, H, W, C) -> one grid array (torchvision make_grid's layout)."""
    n, h, w, c = images.shape
    ncols = nrows  # torchvision's nrow = images per row
    nrow_count = (n + ncols - 1) // ncols
    grid = np.zeros((nrow_count * (h + pad) + pad, ncols * (w + pad) + pad, c),
                    dtype=np.float32)
    for idx in range(n):
        r, col = divmod(idx, ncols)
        y, x = r * (h + pad) + pad, col * (w + pad) + pad
        grid[y:y + h, x:x + w] = images[idx]
    return grid


def save_images(images: np.ndarray, output_dir: str, file_prefix: str, nrows: int,
                iteration: int) -> None:
    grid = _make_grid(np.asarray(images), nrows)
    write_png(os.path.join(output_dir, f"{file_prefix}_{str(iteration).zfill(6)}.png"),
              to_uint8(grid))


class Visualizer:
    def __init__(self, args):
        self.args = args

    def visualize(self, images, model, description: str, save_dir: str, step: int) -> None:
        k = len(images)
        if k < 2:
            raise ValueError(f"visualize needs at least 2 image sets, got {k}")
        images = [np.asarray(im) for im in images]
        bsz, h, w, c = images[0].shape
        if k == 3:
            b2, h2, w2, c2 = images[2].shape
            if not (bsz == b2 and c == c2 and h2 == w2 and h == w and h2 <= h):
                raise ValueError(f"third image set {images[2].shape} vs {images[0].shape}")
            if h2 != h:
                scale = h // h2
                images = [images[0], images[1],
                          np.repeat(np.repeat(images[2], scale, 1), scale, 2)]
        merged = np.stack(images, axis=1).reshape(bsz * k, h, w, c)[:100 * k]

        os.makedirs(save_dir, exist_ok=True)
        save_images(merged, save_dir, description, nrows=8, iteration=step)
        small = np.stack([resize_to(to_uint8(im), 256, 256, "bicubic").astype(np.float32)
                          / 255.0 for im in merged])
        save_images(small, save_dir, f"{description}_256", nrows=8, iteration=step)
