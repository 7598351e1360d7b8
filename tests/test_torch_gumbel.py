"""The port's Gumbel ops (``ops/gumbel.py``) against the JAX package's,
given the same uniform draws: the JAX function's own draws (made from its
key as it makes them) go into the port's ``*_from_uniform`` functions.
Tolerance 1e-6 absolute (fp32 log / logsumexp)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cyclediffusion_tpu.ops import gumbel as jg
from cyclediffusion_tpu_torch.ops import gumbel as g

ATOL = 1e-6
EPS = 1e-20


def _uniform(key, shape):
    """``sample_gumbel``'s draws for ``key``."""
    return np.array(jax.random.uniform(key, shape, minval=EPS, maxval=1.0))


def _logits(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).normal(0, 2, shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(7,), (3, 5), (2, 4, 10)])
def test_sample_gumbel_matches_jax(shape):
    key = jax.random.PRNGKey(sum(shape))
    want = np.asarray(jg.sample_gumbel(key, shape))
    got = g.gumbel_from_uniform(torch.from_numpy(_uniform(key, shape))).numpy()
    assert np.abs(got - want).max() <= ATOL


@pytest.mark.parametrize("shape", [(16,), (8, 12)])
def test_gumbel_max_sample_matches_jax(shape):
    key = jax.random.PRNGKey(7)
    logits = _logits(1, shape)
    want = np.asarray(jg.gumbel_max_sample(key, jnp.asarray(logits)))
    got = g.gumbel_max_from_uniform(torch.from_numpy(logits),
                                    torch.from_numpy(_uniform(key, shape))).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(6,), (4, 9), (2, 3, 5)])
def test_gumbel_with_maximum_matches_jax(shape):
    """The same draws as JAX's (the key split in two: the maximum's, then
    the rest's); the target is the argmax of the result."""
    key = jax.random.PRNGKey(11)
    logits = _logits(2, shape)
    target = np.random.default_rng(3).integers(0, shape[-1], shape[:-1])
    want = np.asarray(jg.gumbel_with_maximum(key, jnp.asarray(logits), jnp.asarray(target)))
    k1, k2 = jax.random.split(key)
    got = g.gumbel_with_maximum_from_uniform(
        torch.from_numpy(logits), torch.from_numpy(np.asarray(target)),
        torch.from_numpy(_uniform(k1, shape[:-1] + (1,))),
        torch.from_numpy(_uniform(k2, shape))).numpy()
    assert np.abs(got - want).max() <= ATOL
    np.testing.assert_array_equal(got.argmax(-1), target)


def test_gumbel_with_maximum_is_finite_when_a_free_gumbel_exceeds_the_maximum():
    """Free Gumbels above the drawn maximum T: by 2 (u = 0.977 against
    u_max = 0.5, zero logits) the truncation stays below T, equal to JAX's
    formula on those numbers, and the target keeps the argmax; by 17 (u
    near 1, u_max near 0) it stays finite and rounds to T in fp32."""
    logits, target = torch.zeros(1, 4), torch.tensor([2])
    out = g.gumbel_with_maximum_from_uniform(logits, target, torch.full((1, 1), 0.5),
                                             torch.full((1, 4), 0.977))
    free = -np.log(-np.log(np.float32(0.977)))
    top = -np.log(-np.log(np.float32(0.5))) + np.log(np.float32(4.0))
    assert free > top + 1.9                              # the case the form exists for
    want = np.minimum(free, top) - np.log1p(np.exp(-abs(free - top)))
    assert np.abs(out[0, [0, 1, 3]].numpy() - want).max() <= ATOL
    assert int(out.argmax()) == 2
    far = g.gumbel_with_maximum_from_uniform(logits, target, torch.full((1, 1), 1e-6),
                                             torch.full((1, 4), 1.0 - 1e-7))
    assert bool(torch.isfinite(far).all()) and bool((far <= far[0, 2]).all())


def test_samplers_draw_from_the_generator():
    """The generator-driven functions: seeded, shaped, argmax on target."""
    logits = torch.from_numpy(_logits(4, (5, 8)))
    target = torch.tensor([0, 7, 3, 3, 1])
    a = g.gumbel_with_maximum(logits, target, torch.Generator().manual_seed(0))
    b = g.gumbel_with_maximum(logits, target, torch.Generator().manual_seed(0))
    assert torch.equal(a, b) and torch.equal(a.argmax(-1), target)
    s = g.gumbel_max_sample(logits, torch.Generator().manual_seed(1))
    assert s.shape == (5,) and s.dtype == torch.int64
    draws = g.sample_gumbel((20000,), torch.Generator().manual_seed(2), device="cpu")
    assert abs(float(draws.mean()) - 0.5772) < 0.03      # the Euler-Mascheroni constant
