"""Asset-free text tokenization (counterpart of
``cyclediffusion_tpu.text.tokenizer.HashTokenizer``).

The SD-v1 slice runs with random weights and no BPE vocab, so its prompts go
through a hashed vocabulary: stable ids across processes, no linguistic
meaning, and the same ids as the JAX package's ``HashTokenizer``.
"""

from __future__ import annotations

import re
import zlib
from typing import Sequence

import numpy as np


def _basic_clean(text: str) -> str:
    text = re.sub(r"\s+", " ", text)
    return text.strip().lower()


class HashTokenizer:
    """Deterministic hashed tokenizer for runs without vocab assets.

    Each whitespace-separated word of the cleaned, lower-cased text maps to
    ``crc32(word) % (vocab_size - 3) + 1``, wrapped in start / end tokens
    (``vocab_size - 2`` / ``vocab_size - 1``) and zero-padded.  NOT
    compatible with any pretrained checkpoint.
    """

    def __init__(self, vocab_size: int = 49408, context_length: int = 77,
                 sot: int | None = None, eot: int | None = None):
        self.vocab_size = vocab_size
        self.context_length = context_length
        self.sot = vocab_size - 2 if sot is None else sot
        self.eot = vocab_size - 1 if eot is None else eot

    def __call__(self, texts: Sequence[str] | str) -> np.ndarray:
        """``(len(texts), context_length)`` int32 token ids."""
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), self.context_length), dtype=np.int32)
        for i, text in enumerate(texts):
            words = _basic_clean(text).split()
            ids = [self.sot] + [
                (zlib.crc32(w.encode()) % (self.vocab_size - 3)) + 1
                for w in words
            ][: self.context_length - 2] + [self.eot]
            out[i, : len(ids)] = ids
        return out
