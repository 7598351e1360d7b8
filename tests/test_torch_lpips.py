"""The port's LPIPS (``evaluation/lpips.py``) and its weight converter
(``convert/lpips_import.py``) against the JAX package's: the distance on
the same params (the JAX tree carried across by ``convert/from_jax.py``)
within 1e-5 relative, the converter equal to JAX's ``convert_lpips`` on one
seeded ``lpips``-layout state dict, and the seeded random-feature metric's
properties."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cyclediffusion_tpu.convert.lpips_import import convert_lpips as jconvert_lpips
from cyclediffusion_tpu.evaluation import lpips as jlpips
from cyclediffusion_tpu_torch.convert.from_jax import load_flax_lpips
from cyclediffusion_tpu_torch.convert.lpips_import import _SLICE_CONV_IDX, convert_lpips
from cyclediffusion_tpu_torch.evaluation import lpips
from test_torch_common import fill_flax_tree

REL = 1e-5      # fp32 both ways; the convolutions sum in another order


def _images(seed: int, n: int, size: int) -> np.ndarray:
    return np.random.default_rng(seed).uniform(-1, 1, (n, size, size, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def jparams():
    """JAX's random-feature params with every conv bias drawn too, so the
    biases' path is held as well."""
    params = jlpips.random_lpips_params(jax.random.PRNGKey(3), image_size=32)
    params["vgg"] = fill_flax_tree(params["vgg"], 5)
    return params


@pytest.mark.parametrize("size,n", [(32, 3), (48, 2), (37, 2)])
def test_distance_matches_jax(jparams, size, n):
    """Square and odd sizes (the odd one floors at each max-pool, as Flax's
    VALID pooling does)."""
    model = lpips.LPIPS()
    load_flax_lpips(model, jparams)
    a, b = _images(size, n, size), _images(size + 1, n, size)
    want = np.asarray(jlpips.lpips_distance(jparams, jnp.asarray(a), jnp.asarray(b)))
    got = lpips.lpips_distance(model, torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.shape == want.shape == (n,)
    assert np.abs(got - want).max() <= REL * np.abs(want).max()


def _lpips_state_dict(seed: int) -> dict:
    """A seeded state dict in the ``lpips`` package's ``LPIPS(net='vgg')``
    layout (torchvision indices within each slice, the heads' (1, C, 1, 1)
    weights, the scaling layer's buffers)."""
    rng = np.random.default_rng(seed)
    sd, cin = {}, 3
    for s, (idxs, widths) in enumerate(zip(_SLICE_CONV_IDX, lpips.VGG16_STAGES), start=1):
        for idx, w in zip(idxs, widths):
            sd[f"net.slice{s}.{idx}.weight"] = (rng.standard_normal((w, cin, 3, 3))
                                                / np.sqrt(9 * cin)).astype(np.float32)
            sd[f"net.slice{s}.{idx}.bias"] = (0.1 * rng.standard_normal(w)).astype(np.float32)
            cin = w
    for i, c in enumerate(lpips.TAP_WIDTHS):
        sd[f"lin{i}.model.1.weight"] = np.abs(rng.standard_normal((1, c, 1, 1))).astype(
            np.float32) / c
    sd["scaling_layer.shift"] = np.zeros((1, 3, 1, 1), np.float32)
    sd["scaling_layer.scale"] = np.ones((1, 3, 1, 1), np.float32)
    return sd


def test_converter_matches_jax_convert_lpips():
    """The port's converter and JAX's on one state dict give the same
    module, bit for bit (JAX's carried across), and the same distance."""
    sd = _lpips_state_dict(0)
    ours = lpips.LPIPS()
    ours.load_state_dict(convert_lpips({k: torch.from_numpy(v) for k, v in sd.items()}),
                         strict=True)
    jparams = jconvert_lpips(sd)
    theirs = lpips.LPIPS()
    load_flax_lpips(theirs, jparams)
    a, b = ours.state_dict(), theirs.state_dict()
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    x, y = _images(1, 2, 32), _images(2, 2, 32)
    want = np.asarray(jlpips.lpips_distance(jparams, jnp.asarray(x), jnp.asarray(y)))
    got = lpips.lpips_distance(ours, torch.from_numpy(x), torch.from_numpy(y)).numpy()
    assert np.abs(got - want).max() <= REL * np.abs(want).max()
    with pytest.raises(KeyError, match="lin4"):
        convert_lpips({k: v for k, v in sd.items() if not k.startswith("lin4")})


def test_random_metric_separates_images():
    """The seeded random-feature metric: d(a, a) = 0, a small change
    closer than a large one, non-negative heads, the same seed the same
    weights."""
    model = lpips.random_lpips_params(torch.Generator().manual_seed(0), device="cpu")
    again = lpips.random_lpips_params(torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(p, q) for p, q in zip(model.parameters(), again.parameters()))
    assert all(bool((h >= 0).all()) for h in model.lins)
    a = torch.from_numpy(_images(4, 2, 32))
    noise = torch.from_numpy(_images(5, 2, 32))
    d0 = lpips.lpips_distance(model, a, a)
    small = lpips.lpips_distance(model, a, a + 0.01 * noise)
    large = lpips.lpips_distance(model, a, a + 0.5 * noise)
    assert torch.equal(d0, torch.zeros(2))
    assert bool((0 < small).all() and (small < large).all())
    with pytest.raises(ValueError, match="16x16"):
        lpips.lpips_distance(model, a[:, :8, :8], a[:, :8, :8])


def test_load_lpips_params_reads_the_asset(tmp_path, monkeypatch):
    """``CYCLEDIFFUSION_LPIPS`` names a torch-saved ``lpips`` state dict;
    without it (or with a missing file) the loader gives None, as JAX's."""
    monkeypatch.delenv("CYCLEDIFFUSION_LPIPS", raising=False)
    assert lpips.load_lpips_params(device="cpu") is None
    assert jlpips.load_lpips_params() is None
    sd = _lpips_state_dict(1)
    path = tmp_path / "vgg.pth"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    monkeypatch.setenv("CYCLEDIFFUSION_LPIPS", str(path))
    model = lpips.load_lpips_params(device="cpu")
    np.testing.assert_array_equal(model.vgg.conv[12].weight.numpy(),
                                  sd["net.slice5.28.weight"])
    np.testing.assert_array_equal(model.lins[2].numpy(), sd["lin2.model.1.weight"][0, :, 0, 0])
    monkeypatch.setenv("CYCLEDIFFUSION_LPIPS", str(tmp_path / "absent.pth"))
    assert lpips.load_lpips_params(device="cpu") is None
