"""Batched image preprocessing on the card (counterpart of
``cyclediffusion_tpu.data.device_transforms``): centre-crop to the short
edge, resize, clip; images decoded once on the host.

The JAX functions resize with ``jax.image.resize(..., antialias=size <
s)``, which is ``scale_and_translate``: per axis, a weight matrix of the
method's kernel at the half-pixel sample positions, widened by the scale
when downsampling with antialiasing, each output's weights normalised to
sum to 1, outputs whose sample falls outside the input zeroed.
``F.interpolate`` is another function (its bicubic uses a = -0.75, not
Keys' a = -0.5; its edge normalisation and nearest rounding differ), so
:func:`resize_weight_matrix` builds JAX's matrices here (on the host, in
fp32 with ``compute_weight_mat``'s order of operations) and :func:`resize_nhwc`
applies them as two products in full fp32 (``precision=HIGHEST`` in the
JAX function), on the images' device.  Nearest is JAX's gather written as
a one-hot matrix.  The matrices are copied to each device once and kept
there (a host-to-device copy cannot run inside a CUDA graph's capture).
The products' backward is their transposed products, also in full fp32,
and adds no atomics: the gradient of a resize is the same at every call.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

METHODS = {"linear": "linear", "bilinear": "linear", "trilinear": "linear",
           "triangle": "linear", "cubic": "cubic", "bicubic": "cubic", "tricubic": "cubic",
           "lanczos3": "lanczos3", "lanczos5": "lanczos5", "nearest": "nearest"}


def _lanczos(radius: float, x: np.ndarray) -> np.ndarray:
    r, pi = np.float32(radius), np.float32(np.pi)
    y = r * np.sin(pi * x) * np.sin(pi * x / r)
    with np.errstate(divide="ignore", invalid="ignore"):
        out = np.where(x > 1e-3, y / np.where(x != 0, pi ** 2 * x ** 2, 1), 1)
    return np.where(x > r, 0, out)


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    f = np.float32
    out = ((f(1.5) * x - f(2.5)) * x) * x + f(1.0)
    out = np.where(x >= 1, ((f(-0.5) * x + f(2.5)) * x - f(4.0)) * x + f(2.0), out)
    return np.where(x >= 2, 0, out)


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(0, 1 - np.abs(x))


_KERNELS = {"linear": _triangle, "cubic": _keys_cubic,
            "lanczos3": functools.partial(_lanczos, 3.0),
            "lanczos5": functools.partial(_lanczos, 5.0)}


@functools.lru_cache(maxsize=64)
def resize_weight_matrix(in_size: int, out_size: int, method: str,
                         antialias: bool) -> np.ndarray:
    """float32 (in_size, out_size), read-only (cached): ``out = in @ W``
    along one axis, JAX's ``compute_weight_mat`` for a plain resize (scale
    out/in, no translation), or its nearest-neighbour gather as a one-hot
    matrix."""
    method = METHODS[method]
    if method == "nearest":
        offsets = np.floor(((np.arange(out_size, dtype=np.float32) + np.float32(0.5))
                            * np.float32(in_size)) / np.float32(out_size)).astype(np.int64)
        w = np.zeros((in_size, out_size), np.float32)
        w[offsets, np.arange(out_size)] = 1.0
        w.flags.writeable = False
        return w
    f32 = np.float32
    inv_scale = f32(1.0) / f32(out_size / in_size)
    kernel_scale = max(inv_scale, f32(1.0)) if antialias else f32(1.0)
    sample_f = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    weights = _KERNELS[method](x).astype(f32)
    total = weights.sum(axis=0, keepdims=True, dtype=f32)
    weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                       weights / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= f32(in_size) - f32(0.5))
    w = np.where(inside[None, :], weights, f32(0.0)).astype(f32)
    w.flags.writeable = False
    return w


@contextlib.contextmanager
def _full_fp32_matmul():
    """fp32 products without TF32 inside the block (JAX's HIGHEST)."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


@functools.lru_cache(maxsize=None)
def device_weight_matrix(in_size: int, out_size: int, method: str, antialias: bool,
                         device: torch.device, dtype=torch.float32) -> torch.Tensor:
    """:func:`resize_weight_matrix` on ``device``, cast from fp32 to
    ``dtype`` as JAX casts it to the image's, copied there once: a graph's
    warm-up fills the cache that its capture reads."""
    return torch.tensor(resize_weight_matrix(in_size, out_size, method, antialias),
                        device=device).to(dtype)


class _AxisProduct(torch.autograd.Function):
    """``einsum(forward, x, w)`` for a constant matrix ``w``; the gradient
    is ``einsum(backward, grad, w)``.  Both run in full fp32 whatever the
    caller's TF32 flag: autograd runs a backward after the forward's block
    has exited."""

    @staticmethod
    def forward(ctx, x, w, forward, backward):
        ctx.save_for_backward(w)
        ctx.backward_equation = backward
        with _full_fp32_matmul():
            return torch.einsum(forward, x, w)

    @staticmethod
    def backward(ctx, grad):
        (w,) = ctx.saved_tensors
        with _full_fp32_matmul():
            return torch.einsum(ctx.backward_equation, grad, w), None, None, None


def resize_nhwc(images: torch.Tensor, height: int, width: int, method: str = "bilinear",
                antialias: bool = True) -> torch.Tensor:
    """(B, H, W, C) -> (B, height, width, C) in the images' float dtype,
    ``jax.image.resize``'s function: an axis whose size does not change is
    left as it is."""
    if method not in METHODS:
        raise ValueError(f'Unknown resize method "{method}"')
    _, h, w, _ = images.shape
    out = images
    if h != height:
        wh = device_weight_matrix(h, height, method, antialias, out.device, out.dtype)
        out = _AxisProduct.apply(out, wh, "bhwc,hy->bywc", "bywc,hy->bhwc")
    if w != width:
        ww = device_weight_matrix(w, width, method, antialias, out.device, out.dtype)
        out = _AxisProduct.apply(out, ww, "bywc,wx->byxc", "byxc,wx->bywc")
    return out


def preprocess_batch(images: torch.Tensor, size: int, method: str = "bilinear"
                     ) -> torch.Tensor:
    """(B, H, W, C) uint8 or float -> (B, size, size, C) float32 in [0, 1] on
    the images' device: centre-crop the long edge to square
    (CenterCropLongEdge), resize to ``size`` (antialiased when shrinking),
    clip."""
    if images.dtype == torch.uint8:
        images = images.to(torch.float32) / 255.0
    images = images.to(torch.float32)
    _, h, w, _ = images.shape
    s = min(h, w)
    top, left = (h - s) // 2, (w - s) // 2
    cropped = images[:, top:top + s, left:left + s]
    out = resize_nhwc(cropped, size, size, method, antialias=size < s)
    return torch.clip(out, 0.0, 1.0)


def to_model_space(images01: torch.Tensor, size: int) -> torch.Tensor:
    """A [0, 1] batch -> [-1, 1] at the model resolution (the wrappers'
    first normalisation step)."""
    return (preprocess_batch(images01, size) - 0.5) * 2.0
