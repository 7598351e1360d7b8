"""The port's HashTokenizer against the JAX package's: the same prompts give
the same int32 ids, exactly (both hash the same cleaned words with crc32)."""

import numpy as np
import pytest

from cyclediffusion_tpu.text.tokenizer import HashTokenizer as JHashTokenizer
from cyclediffusion_tpu_torch.text import HashTokenizer

PROMPTS = [
    ["a photo of a cat", "a painting of a house"],
    ["  A Photo\tof a  DOG \n", ""],
    [" ".join(f"word{i}" for i in range(100))],      # truncated, keeps the EOT
    "a single string prompt",
]


@pytest.mark.parametrize("vocab,ctx", [(49408, 77), (96, 16)])
@pytest.mark.parametrize("texts", PROMPTS, ids=["pair", "spacing", "long", "str"])
def test_hash_tokenizer_matches_jax(vocab, ctx, texts):
    got = HashTokenizer(vocab, ctx)(texts)
    want = JHashTokenizer(vocab, ctx)(texts)
    assert got.dtype == np.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
