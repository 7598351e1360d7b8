"""FID / KID and the FID InceptionV3 of the port against the JAX package:
the Frechet distance (its jitter retry too), KID with the same subsets,
the patch-moment features, clean-fid's 299 bicubic resize, the BN fold of a
pytorch-fid state dict, pool3 features against JAX's converted tower, the
asset's whole feature path, and the extractor's order and kinds.

Tolerances: the statistics on the same float64 features 1e-9 relative
(the same numpy and scipy calls); the 299 resize 1e-4 absolute on [0, 1]
against Pillow's float-mode bicubic (``F.interpolate`` with
``antialias=True`` computes Pillow's filter; Pillow accumulates in double,
PyTorch in float); the folded weights within two fp32 ulps (two
roundings, scale then product; the bias, a difference, 1e-7 absolute);
pool3 features 1e-4 of max|JAX| (fp32, ~100 layers of summation order),
and after the resize 2e-4.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from cyclediffusion_tpu.convert.inception_import import convert_inception as jconvert
from cyclediffusion_tpu.evaluation import fid as jfid
from cyclediffusion_tpu.models.inception import inception_pool3_features as jpool3
from cyclediffusion_tpu_torch.convert.inception_import import convert_inception
from cyclediffusion_tpu_torch.evaluation import fid
from cyclediffusion_tpu_torch.models.inception import (
    InceptionV3Features,
    inception_pool3_features,
)
from cyclediffusion_tpu_torch.tools import pixel_assets

FEAT_TOL = 1e-4


@pytest.fixture(scope="module")
def inception_sd():
    return pixel_assets.inception_state_dict(seed=0)


@pytest.mark.parametrize("n,dim", [(40, 8), (3, 16)])     # (3, 16): singular, the retry
def test_fid_and_kid_match_jax(n, dim):
    rng = np.random.default_rng(n)
    a, b = rng.standard_normal((n, dim)), 0.5 + 1.3 * rng.standard_normal((n + 2, dim))
    got, want = fid.compute_fid_from_features(a, b), jfid.compute_fid_from_features(a, b)
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-9)
    np.testing.assert_allclose(fid.compute_kid_from_features(a, b),
                               jfid.compute_kid_from_features(a, b), rtol=1e-9)
    assert fid.compute_fid_from_features(a, a) == pytest.approx(0.0, abs=1e-6)


def test_frechet_distance_retries_with_jitter_as_jax(monkeypatch):
    """A non-finite ``sqrtm`` is retried with 1e-6 on the diagonals, as
    JAX's is (the same ``scipy.linalg`` made to fail once for each)."""
    sigma = np.diag([1.0, 0.0, 2.0])
    calls = []
    real = fid.scipy.linalg.sqrtm

    def sqrtm(m, disp=True):     # the port calls it without disp, JAX with disp=False
        calls.append(m.copy())
        out = np.full_like(m, np.nan) if len(calls) % 2 else real(m)
        return out if disp else (out, 0.0)

    monkeypatch.setattr(fid.scipy.linalg, "sqrtm", sqrtm)
    got = fid.frechet_distance(np.zeros(3), sigma, np.ones(3), sigma)
    want = jfid.frechet_distance(np.zeros(3), sigma, np.ones(3), sigma)
    assert len(calls) == 4 and np.isfinite(got)
    jittered = sigma + 1e-6 * np.eye(3)
    np.testing.assert_allclose(calls[1], jittered @ jittered)
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_moment_features_match_jax():
    img = np.random.default_rng(0).uniform(size=(3, 18, 17, 3)).astype(np.float32)
    got = fid._moment_features(img)
    assert got.shape == (3, 64) and got.dtype == np.float64
    np.testing.assert_array_equal(got, jfid._moment_features(img))


@pytest.mark.parametrize("size", [64, 256, 512])
def test_resize_299_matches_pillows_float_bicubic(size):
    """Up (64, 256) and down (512: the filter widens) to 299 against JAX's
    Pillow mode-F resize; 299 passes through."""
    img = np.random.default_rng(size).uniform(size=(2, size, size, 3)).astype(np.float32)
    got = fid.resize_299_bicubic(torch.as_tensor(img))
    want = jfid._resize_299_bicubic(img)
    assert got.shape == want.shape == (2, 299, 299, 3)
    assert float(np.abs(got.numpy() - want).max()) < 1e-4
    same = torch.rand(1, 299, 299, 3)
    assert fid.resize_299_bicubic(same) is same


def test_bn_fold_matches_jax(inception_sd):
    got = convert_inception(inception_sd)
    jtree = jconvert({k: v.numpy() for k, v in inception_sd.items()})["params"]
    assert not any(k.startswith("fc.") for k in got) and len(got) == 2 * 94
    for key, value in got.items():
        node = jtree
        mod, leaf = key.rsplit(".", 1)
        for part in mod.split("."):
            node = node[part]
        want = node["kernel"].transpose(3, 2, 0, 1) if leaf == "weight" else node["bias"]
        np.testing.assert_allclose(value.numpy(), want, rtol=4e-7, atol=1e-7)
    model = InceptionV3Features()
    model.load_state_dict(got, strict=True)
    assert sum(p.numel() for p in model.parameters()) == 21_768_352


def test_pool3_matches_jax_tower(inception_sd):
    model = InceptionV3Features()
    model.load_state_dict(convert_inception(inception_sd), strict=True)
    img = np.random.default_rng(1).uniform(size=(2, 96, 96, 3)).astype(np.float32)
    got = inception_pool3_features(model, torch.as_tensor(img))
    want = np.asarray(jpool3(jconvert({k: v.numpy() for k, v in inception_sd.items()}),
                             jnp.asarray(img)))
    assert got.shape == want.shape == (2, 2048) and got.dtype == torch.float32
    assert float(np.abs(want[0] - want[1]).max()) > 1e-3       # inputs tell apart
    assert float(np.abs(got.numpy() - want).max()) < FEAT_TOL * float(np.abs(want).max())


def test_feature_extractor_order_and_kinds(inception_sd, tmp_path, monkeypatch):
    """The asset's features (after the resize) as JAX's; without the asset
    a CLIP scorer's, then patch moments; a torchscript archive in the asset
    path goes through ``torch.jit.load``."""
    from cyclediffusion_tpu_torch.pipelines.factory import TINY_CLIP, _tiny_scorer
    from cyclediffusion_tpu_torch.runtime import context

    path = str(tmp_path / "pt_inception.pth")
    torch.save(inception_sd, path)
    monkeypatch.setenv("CYCLEDIFFUSION_INCEPTION_CKPT", path)
    monkeypatch.setattr(fid, "_INCEPTION_CACHE", {})
    monkeypatch.setattr(jfid, "_INCEPTION_CACHE", {})
    img = np.random.default_rng(2).uniform(size=(1, 64, 64, 3)).astype(np.float32)
    extract = fid.get_feature_extractor(device="cpu")
    got = extract(img)
    assert extract.kind == "inception" and got.shape == (1, 2048) and got.dtype == np.float64
    want = jfid._inception_features(img)
    assert float(np.abs(got - want).max()) < 2 * FEAT_TOL * float(np.abs(want).max())

    class Script(torch.nn.Module):
        def forward(self, x):
            return x.mean(dim=(2, 3))

    script_path = str(tmp_path / "inception.pt")
    torch.jit.script(Script()).save(script_path)
    monkeypatch.setenv("CYCLEDIFFUSION_INCEPTION_CKPT", script_path)
    with pytest.warns(UserWarning, match="torchscript"):
        feats = extract(img)
    assert extract.kind == "inception"
    np.testing.assert_allclose(feats, img.mean(axis=(1, 2)) * 255.0, rtol=1e-5)

    monkeypatch.delenv("CYCLEDIFFUSION_INCEPTION_CKPT")
    context.reset()
    context.set_directional_clip(_tiny_scorer(0, None, "cpu"))
    feats = extract(np.random.default_rng(3).uniform(size=(2, 32, 32, 3)).astype(np.float32))
    assert extract.kind == "clip" and feats.shape == (2, TINY_CLIP.embed_dim)
    context.reset()
    context._CACHE["dclip"] = None          # no assets: the optional lookup gives None
    gen = np.random.default_rng(4).uniform(size=(3, 16, 16, 3)).astype(np.float32)
    ref = np.random.default_rng(5).uniform(size=(4, 16, 16, 3)).astype(np.float32)
    got = fid.compute_fid_kid(gen, ref, device="cpu")
    want = jfid.compute_fid_kid(gen, ref)
    assert got[2] == want[2] == "moment"
    np.testing.assert_allclose(got[:2], want[:2], rtol=1e-9)
    context.reset()
