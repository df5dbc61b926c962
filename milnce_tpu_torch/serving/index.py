"""Device-resident retrieval index: corpus embeddings on the card (row
shards over the cards of a device group, or over a process group's
ranks), dot-product + exact top-k retrieval (port of
``milnce_tpu/serving/index.py``).

Offline eval materializes the full T x V similarity matrix on host
(``eval/retrieval.py``) — fine for a 1k-video benchmark, hopeless for a
served corpus: at production scale the corpus embedding table is the
largest tensor in the system and must live ON the device, with only
(Q, k) winners ever crossing back to host.

The retrieval program (the JAX ``shard_map`` body, step for step):

1. each shard scores the query block against its local corpus rows
   (one (Q, R_local) matmul);
2. pad rows are masked to -inf and each shard takes a LOCAL top-k,
   shifted to global row indices by the shard's rank — per shard only
   (Q, k) survives, not (Q, R_local);
3. the per-shard candidate lists meet on one device and a final top-k
   over the ``n * k`` candidates is exact — every true global winner is
   necessarily some shard's local winner.  Over a device group (the
   JAX mesh's data axis, in one process: :func:`group_topk`) each card's
   (Q, k) lists are copied to the group's first card and concatenated in
   shard order; over a process group they ride ONE all-gather each for
   scores and indices (``parallel/dist.py::all_gather_tiled``).  One
   device and no process group is one shard.

Ties break by the lower row index, as ``lax.top_k`` breaks them:
``torch.topk`` promises no order among equal values, so the selection
ranks a composite int64 key, the score's order-preserving integer image
in the high 32 bits and ``2**32 - 1 - row`` in the low 32.  The keys are
distinct, so the top-k is exact, a tie across the k-th place included.

Query batches are padded to a fixed bucket ladder exactly like the
embed entries (pad queries produce garbage rows that are dropped on
unpad; they never affect real rows).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from milnce_tpu_torch.analysis.lockrt import make_lock
from milnce_tpu_torch.parallel.dist import all_gather_tiled
from milnce_tpu_torch.serving.batcher import pad_rows
from milnce_tpu_torch.serving.engine import (DEVICE_DISPATCH_LOCK,
                                             refuse_two_groups, serving_group)


def _order_key(scores: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """int64 keys whose order is (score descending, row ascending): the
    f32 score's bits made monotone as a signed int32 (negative floats'
    magnitude bits flipped; -0.0 folded onto +0.0 first), shifted up 32,
    plus ``2**32 - 1 - row``."""
    bits = (scores + 0.0).view(torch.int32)
    bits = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    return (bits.to(torch.int64) << 32) + (0xFFFFFFFF - rows.to(torch.int64))


def exact_topk(scores: torch.Tensor, rows: torch.Tensor, k: int):
    """(Q, C) scores of the rows ``rows`` (broadcast to (Q, C)) -> the k
    best of each query as ((Q, k) scores, (Q, k) rows), best first, ties
    by the lower row."""
    _, j = torch.topk(_order_key(scores, rows), k, dim=1)
    return scores.gather(1, j), rows.expand_as(scores).gather(1, j)


def make_topk_fn(k: int, group=None):
    """The retrieval program: ``fn(corpus_l (R, D), valid (1,), start (1,),
    queries (Q, D)) -> ((Q, k) scores, (Q, k) global rows)`` for one
    shard whose first global row is ``start``; with ``group`` the
    shards' candidates are gathered and the exact global top-k taken."""

    @torch.no_grad()
    def local_topk(corpus_l, valid_l, start, queries):
        scores = queries @ corpus_l.T                    # (Q, R_local)
        col = torch.arange(corpus_l.shape[0], device=corpus_l.device)
        scores = scores.masked_fill(col[None, :] >= valid_l, -torch.inf)
        s, i = exact_topk(scores, col[None, :] + start, k)  # local winners
        if group is None:
            return s, i
        world = dist.get_world_size(group)
        hop = (s.device if dist.get_backend(group) == "nccl"
               else torch.device("cpu"))
        s_all = all_gather_tiled(s.to(hop), group).to(s.device)
        i_all = all_gather_tiled(i.to(hop), group).to(i.device)
        q = s.shape[0]                     # (W*Q, k) -> (Q, W*k), rank order
        s_all = s_all.view(world, q, k).permute(1, 0, 2).reshape(q, -1)
        i_all = i_all.view(world, q, k).permute(1, 0, 2).reshape(q, -1)
        return exact_topk(s_all, i_all, k)               # exact global

    return local_topk


def group_topk(fn, shards, queries: np.ndarray, k: int
               ) -> tuple[np.ndarray, np.ndarray]:
    """The JAX ``shard_map`` body over a device group, in one process:
    ``fn`` (one shard's program, :func:`make_topk_fn`) on every shard
    ``(corpus, valid, start)`` on its card, all launched before anything
    is read back; with more than one shard, each one's (Q, k) candidates
    are copied to the first shard's card, concatenated in shard order and
    one exact top-k taken over the ``n * k`` (ties by the lower row,
    across shard boundaries too).  Returns host ((Q, k) float32 scores,
    (Q, k) int32 rows); the read back is the call's one sync."""
    on = {c.device: torch.from_numpy(queries).to(c.device)
          for c, _, _ in shards}
    parts = [fn(c, v, s, on[c.device]) for c, v, s in shards]
    if len(parts) > 1:
        first = shards[0][0].device
        parts = [exact_topk(torch.cat([s.to(first) for s, _ in parts], 1),
                            torch.cat([i.to(first) for _, i in parts], 1),
                            k)]
    scores, idx = parts[0]
    return scores.to("cpu").numpy(), idx.to("cpu").numpy().astype(np.int32)


def shard_tensors(emb: np.ndarray, shard: int, rows: int, device) -> tuple:
    """Shard ``shard`` of ``emb`` at ``rows`` rows a shard on ``device``:
    (``(rows, D)`` corpus padded with zero rows, ``(1,)`` int32 valid
    rows, ``(1,)`` int64 first global row)."""
    lo = shard * rows
    corpus, valid = shard_corpus(emb[lo:lo + rows], 1, rows)
    return (torch.from_numpy(corpus).to(device),
            torch.from_numpy(valid).to(device),
            torch.tensor([lo], device=device))


def shard_corpus(emb: np.ndarray, n_data: int, rows: int
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Pad ``(size, D)`` embeddings to ``rows`` rows per data shard ->
    (``(rows * n_data, D)`` padded corpus, ``(n_data,)`` int32 per-shard
    valid-row counts).  Pad rows are zeros and masked to -inf inside the
    top-k program, so they can never be retrieved."""
    size, dim = emb.shape
    corpus = np.zeros((rows * n_data, dim), np.float32)
    corpus[:size] = emb
    valid = np.asarray(
        [max(0, min(size, (s + 1) * rows) - s * rows)
         for s in range(n_data)], np.int32)
    return corpus, valid


class DeviceRetrievalIndex:
    """Immutable corpus on the card + fixed-k exact top-k retrieval.

    - ``embeddings``: (N, D) float32 video-corpus embeddings (built from
      ``InferenceEngine.embed_video`` or an offline extraction); with a
      ``group`` every rank passes the same full corpus and keeps its row
      shard on its device;
    - ``k``: retrieval depth;
    - ``query_buckets``: the query-batch ladder to warm (share the
      engine's so batcher output feeds straight through);
    - ``device``: ``cuda`` unless the caller passes ``cpu``; a list of
      devices is a device group, and shard r of ``max(ceil(N / n), k)``
      rows lives on its r-th device, the JAX mesh's geometry.  A device
      group together with ``group=`` is refused.
    """

    def __init__(self, embeddings: np.ndarray, *, k: int = 10,
                 query_buckets: Sequence[int] = (8,), device="cuda",
                 group=None, precompile: bool = True):
        self.devices = serving_group(device)
        refuse_two_groups(self.devices, group)
        self.device = self.devices[0]
        emb = np.ascontiguousarray(embeddings, dtype=np.float32)
        if emb.ndim != 2:
            raise ValueError(f"expected (N, D) embeddings, got {emb.shape}")
        self.size, self.dim = emb.shape
        self.k = int(k)
        if not 1 <= self.k <= self.size:
            raise ValueError(f"k={k} outside [1, corpus size {self.size}]")
        self.query_buckets = tuple(sorted(int(b) for b in query_buckets))
        if group is None:
            n_data, mine = len(self.devices), range(len(self.devices))
        else:
            n_data, mine = dist.get_world_size(group), [dist.get_rank(group)]
        # Pad the corpus so rows split evenly AND every shard holds at
        # least k rows (the local top-k needs k <= local extent).
        rows = max(-(-self.size // n_data), self.k)
        self._shards = [shard_tensors(emb, r, rows, dev)   # resident
                        for r, dev in zip(mine, self.devices)]
        self._fn = make_topk_fn(self.k, group)
        # call accounting is hit straight off concurrent request threads
        # — its own lock, never the dispatch lock
        self._stats_lock = make_lock("serving.index.stats")
        self._calls = 0
        self._shapes: set = set()
        self._baseline = None
        if precompile:
            self.warmup()

    # ---- query path ------------------------------------------------------

    def bucket_for(self, n: int) -> int:
        for b in self.query_buckets:
            if n <= b:
                return b
        raise ValueError(f"{n} queries exceeds the top query bucket "
                         f"{self.query_buckets[-1]}")

    def topk(self, queries: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(n, D) query embeddings -> ((n, k) float32 scores, (n, k) int32
        corpus row indices), ranked best-first, ties by lower index."""
        q = np.ascontiguousarray(queries, dtype=np.float32)
        if q.ndim != 2 or q.shape[1] != self.dim:
            raise ValueError(f"expected (n, {self.dim}) queries, got "
                             f"{q.shape}")
        n = q.shape[0]
        q = pad_rows(q, self.bucket_for(n))
        # serialized dispatch: see DEVICE_DISPATCH_LOCK in engine.py —
        # index queries come straight off request threads
        with DEVICE_DISPATCH_LOCK:
            scores, idx = group_topk(self._fn, self._shards, q, self.k)
        with self._stats_lock:
            self._calls += 1
            self._shapes.add(q.shape)
        return scores[:n], idx[:n]

    # ---- warmup + observability -----------------------------------------

    def warmup(self) -> None:
        for b in self.query_buckets:
            self.topk(np.zeros((b, self.dim), np.float32))
        with self._stats_lock:
            self._baseline = frozenset(self._shapes)

    def recompiles(self) -> int:
        """Query shapes dispatched since the warmup that it did not run;
        -1 before the warmup.  0 by construction in the port, as
        :meth:`InferenceEngine.recompiles` is: every query batch is
        padded to a bucket the warmup ran."""
        with self._stats_lock:
            if self._baseline is None:
                return -1
            return len(self._shapes - self._baseline)

    def stats(self) -> dict:
        with self._stats_lock:
            calls = self._calls
        return {"size": self.size, "dim": self.dim, "k": self.k,
                "query_buckets": list(self.query_buckets),
                "calls": calls, "recompiles": self.recompiles()}
