"""Word-level tokenizer over the HowTo100M word2vec vocabulary (the
port's own copy of ``milnce_tpu/data/tokenizer.py``).

Behavioral parity with the reference tokenizer (s3dg.py:164-194,
video_loader.py:97-117):

- vocabulary: an array of words; word -> index+1 (0 is the pad id);
- split: regex ``[\\w']+`` over the stringified sentence;
- unknown words are dropped (not mapped to UNK);
- pad/truncate to ``max_words`` with 0;
- a sentence with no in-vocab words tokenizes to all-pad.

Host-side, numpy-only.  A :class:`Tokenizer` is safe for concurrent
``encode`` calls: nothing is written after ``__init__``.
"""

from __future__ import annotations

import re
from typing import Iterable, Sequence

import numpy as np

_WORD_RE = re.compile(r"[\w']+")

PAD_ID = 0


class Tokenizer:
    """Maps sentences to fixed-length int32 id arrays."""

    def __init__(self, vocab: Sequence[str], max_words: int = 20):
        self.word_to_id = {w: i + 1 for i, w in enumerate(vocab)}
        self.max_words = int(max_words)
        self.vocab_size = len(vocab) + 1  # + pad row 0

    @classmethod
    def from_npy(cls, path: str, max_words: int = 20) -> "Tokenizer":
        """Load the reference's ``dict.npy`` vocabulary (s3dg.py:166)."""
        vocab = np.load(path, allow_pickle=True)
        return cls([str(w) for w in vocab], max_words=max_words)

    @staticmethod
    def split(sentence: str) -> list[str]:
        return _WORD_RE.findall(str(sentence))

    def encode(self, sentence: str, max_words: int | None = None) -> np.ndarray:
        """One sentence -> (max_words,) int32, zero-padded."""
        size = self.max_words if max_words is None else int(max_words)
        ids = [self.word_to_id[w] for w in self.split(sentence) if w in self.word_to_id]
        out = np.zeros((size,), dtype=np.int32)
        if ids:
            ids = ids[:size]
            out[: len(ids)] = ids
        return out

    def encode_batch(self, sentences: Iterable[str], max_words: int | None = None) -> np.ndarray:
        """Batch of sentences -> (B, max_words) int32 (s3dg.py:192-194)."""
        rows = [self.encode(s, max_words) for s in sentences]
        if not rows:
            size = self.max_words if max_words is None else int(max_words)
            return np.zeros((0, size), dtype=np.int32)
        return np.stack(rows, axis=0)


def synthetic_vocab(size: int = 128) -> list[str]:
    """Deterministic toy vocabulary for hermetic tests."""
    return [f"word{i}" for i in range(size)]
