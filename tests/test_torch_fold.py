"""The port's tiled first stage (``ops/fold.py`` and the core's
``split_input_params``) against the JAX package at fp32.

Tolerances: the geometry (border distances, weights, normalisers, unfold)
is exact or within 1e-6 (the same float64 formulas; the overlap-add sums
in another order); the blended outputs of a closed-form per-patch function
within 1e-6 of their largest value.  Through the tiny first stages: one
tile equals the untiled path within 1e-5 of max (weights and normaliser
cancel up to rounding); many tiles agree with JAX within 1e-4 of max (the
convolutions' summation order, as the modules' own parity tests)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cyclediffusion_tpu.ops import fold as jfold
from cyclediffusion_tpu_torch.ops import fold
from test_torch_common import max_abs, tiny_latent_cores, to_torch


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _params(**kw):
    return jfold.SplitInputParams(**kw), fold.SplitInputParams(**kw)


@pytest.mark.parametrize("h,w", [(6, 9), (1, 5), (1, 1), (16, 16)])
def test_delta_border_matches_jax(h, w):
    np.testing.assert_array_equal(fold.delta_border(h, w), jfold.delta_border(h, w))


@pytest.mark.parametrize("tie", [False, True])
def test_patch_weighting_and_normalization_match_jax(tie):
    jp, p = _params(ks=(8, 8), stride=(4, 4), tie_braker=tie)
    w = fold.patch_weighting((8, 8), 3, 3, p)
    np.testing.assert_array_equal(w, jfold.patch_weighting((8, 8), 3, 3, jp))
    norm = fold.fold_normalization((16, 16), (8, 8), (4, 4), w)
    np.testing.assert_allclose(norm, jfold.fold_normalization((16, 16), (8, 8), (4, 4), w),
                               rtol=1e-6)
    assert norm.min() > 0


@pytest.mark.parametrize("ks,stride,hw", [((4, 4), (2, 2), (8, 8)), ((3, 5), (2, 3), (7, 11))])
def test_unfold_and_fold_match_jax(ks, stride, hw):
    x = _rand((2,) + hw + (3,), 0)
    got = fold.unfold_nhwc(to_torch(x), ks, stride)
    want = jfold.unfold_nhwc(jnp.asarray(x), ks, stride)
    assert max_abs(got, want) == 0.0
    np.testing.assert_allclose(fold.fold_nhwc(got, hw, stride).numpy(),
                               np.asarray(jfold.fold_nhwc(want, hw, stride)), rtol=1e-6,
                               atol=1e-6)


def _upsample_mix(mix):
    """A linear stand-in for a decoder: nearest 2x upsampling and a fixed
    channel mix, in either framework."""
    def fn_j(z):
        up = jnp.repeat(jnp.repeat(z, 2, axis=1), 2, axis=2)
        return jnp.einsum("oc,bhwc->bhwo", jnp.asarray(mix), up)

    def fn_t(z):
        up = z.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
        return torch.einsum("oc,bhwc->bhwo", to_torch(mix), up)
    return fn_j, fn_t


def _avg_pool():
    def fn_j(z):
        n, h, w, c = z.shape
        return z.reshape(n, h // 2, 2, w // 2, 2, c).mean(axis=(2, 4))

    def fn_t(z):
        n, h, w, c = z.shape
        return z.reshape(n, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))
    return fn_j, fn_t


@pytest.mark.parametrize("case", ["identity", "upsampling", "downsampling", "tie_braker",
                                  "micro_batch"])
def test_split_first_stage_apply_matches_jax(case):
    kw = dict(ks=(8, 8), stride=(4, 4))
    scale, upsample = 1, True
    fn_j, fn_t = (lambda z: z), (lambda z: z)
    x = _rand((2, 16, 16, 4), 1)
    if case == "upsampling":
        fn_j, fn_t = _upsample_mix(_rand((3, 4), 2))
        scale = 2
    elif case == "downsampling":
        fn_j, fn_t = _avg_pool()
        scale, upsample = 2, False
    elif case == "tie_braker":
        kw["tie_braker"] = True
    elif case == "micro_batch":      # 18 patches, chunks of 4: a padded tail
        kw["micro_batch"] = 4
        fn_j, fn_t = (lambda z: z * 2.0 + 1.0), (lambda z: z * 2.0 + 1.0)
    jp, p = _params(vqf=scale, **kw)
    want = jfold.split_first_stage_apply(fn_j, jnp.asarray(x), jp, scale=scale,
                                         upsample=upsample)
    got = fold.split_first_stage_apply(fn_t, to_torch(x), p, scale=scale, upsample=upsample)
    assert got.shape == want.shape
    assert max_abs(got, want) <= 1e-6 * float(jnp.abs(want).max())
    if case == "micro_batch":
        calls = []
        fold.split_first_stage_apply(lambda z: calls.append(z.shape[0]) or fn_t(z),
                                     to_torch(x), p, scale=1, upsample=True)
        assert calls == [4] * 5
    if case == "identity":            # the blend of an identity is the input
        assert max_abs(got, x) < 1e-6


def test_split_first_stage_apply_refuses_an_uncovered_grid():
    x = torch.zeros(1, 15, 16, 3)
    with pytest.raises(ValueError, match="does not cover"):
        fold.split_first_stage_apply(lambda z: z, x, fold.SplitInputParams(ks=(8, 8),
                                     stride=(4, 4)), scale=1, upsample=True)
    with pytest.raises(ValueError, match="multiples"):
        fold.split_first_stage_apply(lambda z: z, torch.zeros(1, 15, 15, 3),
                                     fold.SplitInputParams(ks=(5, 5), stride=(5, 5)),
                                     scale=2, upsample=False)


@pytest.fixture(scope="module", params=["kl", "vq"])
def cores(request):
    return tiny_latent_cores(None, request.param, seed=11)


def test_core_tiled_decode_and_encode(cores):
    """One tile (ks past the extent) equals the untiled path; 3x3 tiles of
    4x4 latent patches (16x16 image patches for the encode) agree with
    JAX's tiled path; the setting is read at each call."""
    jcore, core = cores
    z = _rand((2, 8, 8, 4), 12) * 0.5
    img = np.random.default_rng(13).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    noise = _rand((2, 8, 8, 4), 14)
    kl = core.spec.fs_kind == "kl"

    def encode(c, j):
        if j:
            return c.encode_first_stage(jnp.asarray(img), jnp.asarray(noise) if kl else None)
        return c.encode_first_stage(to_torch(img), to_torch(noise) if kl else None)

    plain_dec = core.decode_first_stage(to_torch(z))
    plain_enc = encode(core, False)
    core.split_input_params = fold.SplitInputParams(ks=(64, 64), stride=(32, 32))
    try:
        one_dec = core.decode_first_stage(to_torch(z))
        one_enc = encode(core, False)
    finally:
        core.split_input_params = None
    assert max_abs(one_dec, plain_dec) <= 1e-5 * float(plain_dec.abs().max())
    assert max_abs(one_enc, plain_enc) <= 1e-5 * float(plain_enc.abs().max())

    for c, split in ((core, fold.SplitInputParams), (jcore, jfold.SplitInputParams)):
        c.split_input_params = split(ks=(4, 4), stride=(2, 2))
    try:
        dec = core.decode_first_stage(to_torch(z))
        want_dec = jcore.decode_first_stage(jnp.asarray(z))
    finally:
        core.split_input_params = jcore.split_input_params = None
    assert dec.shape == (2, 32, 32, 3)
    assert max_abs(dec, want_dec) <= 1e-4 * float(jnp.abs(want_dec).max())
    assert max_abs(dec, plain_dec) > 1e-3          # the seams blend other patches

    for c, split in ((core, fold.SplitInputParams), (jcore, jfold.SplitInputParams)):
        c.split_input_params = split(ks=(16, 16), stride=(8, 8))
    try:
        enc = encode(core, False)
        want_enc = encode(jcore, True)
    finally:
        core.split_input_params = jcore.split_input_params = None
    assert enc.shape == (2, 8, 8, 4)
    assert max_abs(enc, want_enc) <= 1e-4 * float(jnp.abs(want_enc).max())
