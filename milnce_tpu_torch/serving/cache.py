"""LRU text-embedding cache keyed by the exact token-id tuple (port of
``milnce_tpu/serving/cache.py``, line for line).

Production query streams are heavy-tailed — the same captions and
search phrases recur constantly — and a text-tower forward costs a
device dispatch per miss.  Caching at the *token-id* level (not the raw
string) means the key is exactly what determines the embedding: two
strings that tokenize identically share an entry, and tokenizer config
changes can never serve a stale vector for a new id sequence.

numpy-only on purpose: the cache sits on the request path *in front of*
the batcher, so a hit never touches torch or the card at all — no
dispatch, no transfer, no bucket slot consumed.

Thread safety: every public method takes the internal lock; stored
arrays are marked read-only so a caller mutating a returned row cannot
poison later hits.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np

from milnce_tpu_torch.analysis.lockrt import make_lock


def token_key(row: np.ndarray) -> tuple:
    """(W,) int row -> hashable cache key.  The FULL padded row is the
    key (pad ids included): the text tower consumes the padded row, so
    the row is the complete input signature."""
    return tuple(int(t) for t in row)


class EmbeddingLRUCache:
    """Bounded LRU map: token-id tuple -> (D,) embedding row.

    ``capacity <= 0`` disables the cache (get always misses, put is a
    no-op) — one code path for cache-on and cache-off deployments.
    """

    def __init__(self, capacity: int = 4096):
        self.capacity = int(capacity)
        self._data: OrderedDict[tuple, np.ndarray] = OrderedDict()
        self._lock = make_lock("serving.cache")
        self._hits = 0
        self._misses = 0

    def get(self, key: tuple) -> np.ndarray | None:
        with self._lock:
            row = self._data.get(key)
            if row is None:
                self._misses += 1
                return None
            self._data.move_to_end(key)
            self._hits += 1
            return row

    def put(self, key: tuple, value: np.ndarray) -> None:
        if self.capacity <= 0:
            return
        value = np.array(value, copy=True)
        value.setflags(write=False)
        with self._lock:
            self._data[key] = value
            self._data.move_to_end(key)
            while len(self._data) > self.capacity:
                self._data.popitem(last=False)

    def clear(self) -> None:
        with self._lock:
            self._data.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def stats(self) -> dict:
        with self._lock:
            hits, misses, size = self._hits, self._misses, len(self._data)
        total = hits + misses
        return {
            "hits": hits,
            "misses": misses,
            "size": size,
            "capacity": self.capacity,
            "hit_rate": (hits / total) if total else 0.0,
        }
