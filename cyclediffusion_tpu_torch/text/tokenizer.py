"""Text tokenization (counterpart of ``cyclediffusion_tpu.text.tokenizer``).

* :class:`CLIPBPETokenizer` — OpenAI CLIP byte-level BPE, as
  ``clip.tokenize``: the SD conditioning text encoder and the ViT-B/32
  scorer both read its ids.  Needs the standard
  ``bpe_simple_vocab_16e6.txt.gz`` merges file.
* :class:`BertWordPieceTokenizer` — bert-base-uncased's WordPiece, as the
  LDM text2img-large conditioning reads it.  Needs the ``vocab.txt`` file.
* :class:`HashTokenizer` — a hashed vocabulary for runs without vocab
  assets: stable ids across processes, no linguistic meaning.

All give the same ids as the JAX package's classes of the same names.
"""

from __future__ import annotations

import functools
import gzip
import os
import re
import zlib
from typing import Dict, List, Sequence

import numpy as np


def _basic_clean(text: str) -> str:
    text = re.sub(r"\s+", " ", text)
    return text.strip().lower()


@functools.cache
def _bytes_to_unicode() -> Dict[int, str]:
    """CLIP's reversible byte -> printable unicode character table."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word) -> set:
    return set(zip(word, word[1:]))


_CLIP_PAT = re.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+""",
    re.IGNORECASE)


class CLIPBPETokenizer:
    """Byte-level BPE with the CLIP merges table: ``<|startoftext|>`` /
    ``<|endoftext|>`` wrapping, zero padding to ``context_length``, and
    truncation that keeps the end token."""

    def __init__(self, bpe_path: str, context_length: int = 77):
        if not os.path.exists(bpe_path):
            raise FileNotFoundError(
                f"CLIP BPE merges file not found: {bpe_path}. Provide the standard "
                "bpe_simple_vocab_16e6.txt.gz asset.")
        self.context_length = context_length
        self.byte_encoder = _bytes_to_unicode()
        opener = gzip.open if bpe_path.endswith(".gz") else open
        with opener(bpe_path, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        # clip/simple_tokenizer.py's slice; the pair filter drops the blank
        # tail lines of short synthetic files
        merges = [tuple(m.split()) for m in lines[1:49152 - 256 - 2 + 1]]
        merges = [m for m in merges if len(m) == 2]
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab += ["".join(m) for m in merges] + ["<|startoftext|>", "<|endoftext|>"]
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache = {"<|startoftext|>": "<|startoftext|>",
                      "<|endoftext|>": "<|endoftext|>"}
        self.sot = self.encoder["<|startoftext|>"]
        self.eot = self.encoder["<|endoftext|>"]
        self.vocab_size = len(self.encoder)

    def _bpe(self, token: str) -> str:
        """Merge the lowest-ranked adjacent pair until none is in the table."""
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            merged: List[str] = []
            i = 0
            while i < len(word):
                if first not in word[i:]:
                    merged.extend(word[i:])
                    break
                j = word.index(first, i)
                merged.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i + 1] == second:
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode_text(self, text: str) -> List[int]:
        ids: List[int] = []
        for token in re.findall(_CLIP_PAT, _basic_clean(text)):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(token).split(" "))
        return ids

    def __call__(self, texts: Sequence[str] | str) -> np.ndarray:
        """``(len(texts), context_length)`` int32 token ids."""
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), self.context_length), dtype=np.int32)
        for i, text in enumerate(texts):
            toks = [self.sot] + self.encode_text(text) + [self.eot]
            if len(toks) > self.context_length:
                toks = toks[:self.context_length]
                toks[-1] = self.eot
            out[i, :len(toks)] = toks
        return out


class BertWordPieceTokenizer:
    """Lowercasing basic tokenizer + WordPiece (``##`` continuation pieces,
    a word with an unmatched piece is ``[UNK]``), ``[CLS] ... [SEP]``,
    truncated to ``max_length`` and padded with ``[PAD]``: HF's
    ``BertTokenizerFast`` with ``padding="max_length"``, as the reference's
    ``BERTTokenizer`` calls it."""

    def __init__(self, vocab_path: str, max_length: int = 77):
        if not os.path.exists(vocab_path):
            raise FileNotFoundError(
                f"BERT vocab.txt not found: {vocab_path}. Provide the "
                "bert-base-uncased vocab asset (see README).")
        self.max_length = max_length
        with open(vocab_path, encoding="utf-8") as f:
            tokens = [line.rstrip("\n") for line in f]
        self.vocab = {t: i for i, t in enumerate(tokens)}
        self.cls = self.vocab["[CLS]"]
        self.sep = self.vocab["[SEP]"]
        self.pad = self.vocab["[PAD]"]
        self.unk = self.vocab["[UNK]"]
        self.vocab_size = len(self.vocab)

    @staticmethod
    def _basic(text: str) -> List[str]:
        """Lowercased words, each punctuation character a word of its own."""
        text = text.lower().strip()
        text = re.sub(r"([^\w\s])", r" \1 ", text)
        return text.split()

    def _wordpiece(self, word: str) -> List[int]:
        if word in self.vocab:
            return [self.vocab[word]]
        ids: List[int] = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = self.vocab[sub]
                    break
                end -= 1
            if cur is None:
                return [self.unk]
            ids.append(cur)
            start = end
        return ids

    def __call__(self, texts: Sequence[str] | str) -> np.ndarray:
        """``(len(texts), max_length)`` int32 token ids."""
        if isinstance(texts, str):
            texts = [texts]
        out = np.full((len(texts), self.max_length), self.pad, dtype=np.int32)
        for i, text in enumerate(texts):
            ids: List[int] = []
            for w in self._basic(text):
                ids.extend(self._wordpiece(w))
            ids = [self.cls] + ids[:self.max_length - 2] + [self.sep]
            out[i, :len(ids)] = ids
        return out


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
