"""The port's on-device preprocessing (``data/device_transforms.py``)
against the JAX package's ``preprocess_batch`` / ``to_model_space``
(``jax.image.resize``): within 1e-5 absolute on [0, 1] pixels for every
resize method, up- and downscaling, square and non-square inputs, uint8
and float inputs; the weight matrices against JAX's ``compute_weight_mat``
within 1e-6."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.image.scale import _kernels, compute_weight_mat, ResizeMethod

from cyclediffusion_tpu.data import device_transforms as jdt
from cyclediffusion_tpu_torch.data import device_transforms as dt

ATOL = 1e-5
METHODS = ("bilinear", "bicubic", "lanczos3", "lanczos5", "nearest")
CASES = {   # name -> (batch shape, output size)
    "down_nonsquare": ((2, 48, 64, 3), 32),
    "down_tall_odd": ((1, 75, 41, 3), 29),
    "up_square": ((2, 20, 20, 3), 37),
    "up_wide": ((1, 24, 40, 3), 53),
    "crop_only": ((1, 50, 30, 3), 30),
}


def _batch(shape, seed: int, uint8: bool):
    rng = np.random.default_rng(seed)
    if uint8:
        return rng.integers(0, 256, shape, dtype=np.uint8)
    return rng.random(shape, dtype=np.float32)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("method", METHODS)
def test_preprocess_batch_matches_jax(method, case):
    shape, size = CASES[case]
    for uint8 in (True, False):
        x = _batch(shape, hash((method, case)) % 2**31, uint8)
        want = np.asarray(jdt.preprocess_batch(jnp.asarray(x), size, method=method))
        got = dt.preprocess_batch(torch.from_numpy(x), size, method=method)
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        assert np.abs(got.numpy() - want).max() <= ATOL, (method, case, uint8)


def test_to_model_space_matches_jax():
    x = _batch((2, 48, 40, 3), 0, False)
    want = np.asarray(jdt.to_model_space(jnp.asarray(x), 32))
    got = dt.to_model_space(torch.from_numpy(x), 32).numpy()
    assert np.abs(got - want).max() <= 2 * ATOL
    assert got.min() >= -1.0 and got.max() <= 1.0


@pytest.mark.parametrize("method", ["linear", "cubic", "lanczos3", "lanczos5"])
@pytest.mark.parametrize("sizes", [(64, 32), (20, 37), (41, 29)])
def test_weight_matrices_match_jax(method, sizes):
    m, n = sizes
    for antialias in (True, False):
        want = np.asarray(compute_weight_mat(m, n, jnp.float32(n / m), jnp.float32(0.0),
                                             _kernels[ResizeMethod.from_string(method)],
                                             antialias))
        got = dt.resize_weight_matrix(m, n, method, antialias)
        assert got.shape == want.shape == (m, n)
        assert np.abs(got - want).max() <= 1e-6


def test_unknown_method_raises_as_jax():
    x = torch.zeros(1, 8, 8, 3)
    with pytest.raises(ValueError, match="Unknown resize method"):
        dt.preprocess_batch(x, 4, method="area")
    with pytest.raises(ValueError, match="Unknown resize method"):
        jdt.preprocess_batch(jnp.zeros((1, 8, 8, 3)), 4, method="area")


def test_device_matrices_are_copied_once_per_device_and_key(monkeypatch):
    """``resize_nhwc`` reads the cached device copy (the same tensor at every
    call: a graph's capture must not copy from the host)."""
    key = (48, 29, "bicubic", True, torch.device("cpu"), torch.float32)
    first = dt.device_weight_matrix(*key)
    assert dt.device_weight_matrix(*key) is first
    assert dt.device_weight_matrix(48, 29, "bicubic", False, torch.device("cpu"),
                                   torch.float32) is not first
    seen = []
    product = dt._AxisProduct.apply
    monkeypatch.setattr(dt._AxisProduct, "apply",
                        lambda x, w, *eq: seen.append(w) or product(x, w, *eq))
    dt.resize_nhwc(torch.zeros(1, 48, 48, 3), 29, 29, "bicubic")
    dt.resize_nhwc(torch.zeros(2, 48, 48, 3), 29, 29, "bicubic")
    assert len(seen) == 4 and all(w is first for w in seen)


def test_resize_forward_and_backward_run_in_full_fp32(monkeypatch):
    """The products run with TF32 off, the backward's too, whatever the
    caller set; the caller's flag is back afterwards."""
    flags = []
    einsum = torch.einsum
    monkeypatch.setattr(torch, "einsum", lambda *a: flags.append(
        torch.backends.cuda.matmul.allow_tf32) or einsum(*a))
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        x = torch.rand(1, 20, 24, 3, requires_grad=True)
        out = dt.resize_nhwc(x, 13, 37, "bicubic")
        assert flags == [False, False]
        g = torch.autograd.grad(out.square().sum(), x)[0]
        assert flags == [False] * 4
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    # the backward is the transposed products: against float64
    wh = torch.tensor(dt.resize_weight_matrix(20, 13, "bicubic", True), dtype=torch.float64)
    ww = torch.tensor(dt.resize_weight_matrix(24, 37, "bicubic", True), dtype=torch.float64)
    up = 2 * out.detach().double()
    want = torch.einsum("byxc,hy,wx->bhwc", up, wh, ww)
    assert float((g.double() - want).abs().max()) <= 1e-5 * float(want.abs().max())
