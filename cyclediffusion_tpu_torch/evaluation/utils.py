"""Metric primitives (counterpart of ``cyclediffusion_tpu.evaluation.utils``).

Images are float HWC numpy: PSNR and L2 on [0, 1] arrays, SSIM MATLAB-style
on [0, 255] with an 11x11 Gaussian window of sigma 1.5 and valid cropping
(the window's 5-pixel border is dropped, so the border mode of the filter
does not reach the result).
"""

from __future__ import annotations

import os

import numpy as np
from scipy.ndimage import correlate

from cyclediffusion_tpu_torch.data.png import write_png


def to_uint8(image: np.ndarray) -> np.ndarray:
    """float [0, 1] -> uint8, rounding half up."""
    return np.clip(np.asarray(image) * 255.0 + 0.5, 0, 255).astype(np.uint8)


def save_image(image_path: str, image: np.ndarray) -> None:
    """float HWC [0, 1] -> PNG."""
    if image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"save_image takes (H, W, 3), got {image.shape}")
    write_png(image_path, to_uint8(image))


def _gaussian_window() -> np.ndarray:
    x = np.arange(11) - 5.0
    kernel = np.exp(-(x ** 2) / (2 * 1.5 ** 2))
    kernel /= kernel.sum()
    return np.outer(kernel, kernel)


def _filter_valid(img: np.ndarray, window: np.ndarray) -> np.ndarray:
    return correlate(img, window, mode="reflect")[5:-5, 5:-5]


def ssim(img1: np.ndarray, img2: np.ndarray) -> float:
    if img1.shape != img2.shape or img1.ndim != 2:
        raise ValueError(f"ssim takes two equal 2-D arrays, got {img1.shape}, {img2.shape}")
    c1, c2 = (0.01 * 255) ** 2, (0.03 * 255) ** 2
    img1, img2 = img1.astype(np.float64), img2.astype(np.float64)
    window = _gaussian_window()
    mu1, mu2 = _filter_valid(img1, window), _filter_valid(img2, window)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    sigma1_sq = _filter_valid(img1 ** 2, window) - mu1_sq
    sigma2_sq = _filter_valid(img2 ** 2, window) - mu2_sq
    sigma12 = _filter_valid(img1 * img2, window) - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return float(ssim_map.mean())


def calculate_ssim(img1: np.ndarray, img2: np.ndarray) -> float:
    """MATLAB-style SSIM on [0, 255] HWC (or HW) arrays."""
    if img1.shape != img2.shape:
        raise ValueError("Input images must have the same dimensions.")
    if img1.ndim == 2:
        return ssim(img1, img2)
    if img1.ndim == 3:
        if img1.shape[2] == 3:
            return float(np.mean([ssim(img1[:, :, i], img2[:, :, i]) for i in range(3)]))
        if img1.shape[2] == 1:
            return ssim(np.squeeze(img1), np.squeeze(img2))
    raise ValueError("Wrong input image dimensions.")


def calculate_psnr(img1: np.ndarray, img2: np.ndarray) -> float:
    """PSNR on [0, 1] HWC arrays (100 dB at exact match)."""
    if img1.shape != img2.shape:
        raise ValueError(f"shapes differ: {img1.shape}, {img2.shape}")
    for img in (img1, img2):
        if not ((img >= 0).all() and (img <= 1).all()):
            raise ValueError("PSNR takes images in [0, 1]")
    mse = float(((img1 - img2) ** 2).mean())
    if mse == 0:
        return 100.0
    return float(10 * np.log10(1.0 / mse))


def calculate_l2(img1: np.ndarray, img2: np.ndarray) -> float:
    """sqrt of the summed squared difference."""
    return float(np.sqrt(((img1 - img2) ** 2).sum()))


def ensure_empty_dir(path: str) -> None:
    if os.path.exists(path):
        if os.path.isfile(path):
            os.remove(path)
        else:
            for f in os.listdir(path):
                os.remove(os.path.join(path, f))
    os.makedirs(path, exist_ok=True)
