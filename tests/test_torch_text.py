"""The port's tokenizers against the JAX package's: the same prompts give
the same int32 ids, exactly.  HashTokenizer: both hash the same cleaned
words with crc32.  CLIPBPETokenizer: the same merges file, the same byte
table and merge loop."""

import gzip

import numpy as np
import pytest

from cyclediffusion_tpu.text.tokenizer import CLIPBPETokenizer as JCLIPBPETokenizer
from cyclediffusion_tpu.text.tokenizer import HashTokenizer as JHashTokenizer
from cyclediffusion_tpu_torch.text import CLIPBPETokenizer, HashTokenizer

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


# the synthetic merges files of tests/test_tokenizers.py
MERGES = {
    "synthetic": "#version: synthetic\nh e\nl l\nhe ll\no</w> o</w>\n",
    "hand_derived": "#version: test\nl o\nlo w</w>\ne r</w>\n",
}
BPE_PROMPTS = ["hello hello", "HELLO", "low lower er", "  a Photo of a cat's 2 dogs!? ",
               "lower " * 20, "", "naïve café ünïcode"]


@pytest.mark.parametrize("gz", [True, False], ids=["gz", "txt"])
@pytest.mark.parametrize("name", sorted(MERGES))
def test_clip_bpe_tokenizer_matches_jax(name, gz, tmp_path):
    path = str(tmp_path / ("bpe.txt.gz" if gz else "bpe.txt"))
    with (gzip.open(path, "wt") if gz else open(path, "w")) as f:
        f.write(MERGES[name])
    got, want = CLIPBPETokenizer(path, 16), JCLIPBPETokenizer(path, 16)
    assert (got.sot, got.eot, got.vocab_size) == (want.sot, want.eot, want.vocab_size)
    for text in BPE_PROMPTS:
        assert got.encode_text(text) == want.encode_text(text)
    ids = got(BPE_PROMPTS)
    assert ids.dtype == np.int32
    np.testing.assert_array_equal(ids, want(BPE_PROMPTS))


def test_clip_bpe_tokenizer_missing_asset():
    with pytest.raises(FileNotFoundError):
        CLIPBPETokenizer("/nonexistent/bpe.txt.gz")
