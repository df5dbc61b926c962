"""Device-resident retrieval index: corpus embeddings on the card (row
shards over a grid: the cards of a device group on every rank of a
process group), dot-product + exact top-k retrieval (port of
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
3. the per-shard candidate lists meet and a final top-k over the
   ``n * k`` candidates is exact — every true global winner is
   necessarily some shard's local winner.  On a grid of W ranks of G
   devices (``parallel/devices.py::Grid``, the JAX mesh's data axis of
   W x G: :func:`group_topk`) each card's (Q, k) lists are copied to the
   rank's first card and concatenated in shard order, then ride ONE
   all-gather each for scores and rows over the ranks
   (``parallel/dist.py::all_gather_rows``: from the card over NCCL,
   through the host over gloo) -- JAX's two collectives a query batch,
   after the in-process hop.  One device and no process group is one
   shard.

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
from milnce_tpu_torch.parallel.devices import serving_grid
from milnce_tpu_torch.parallel.dist import all_gather_rows
from milnce_tpu_torch.serving.batcher import pad_rows
from milnce_tpu_torch.serving.engine import DEVICE_DISPATCH_LOCK


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


def make_topk_fn(k: int):
    """One shard's retrieval program: ``fn(corpus_l (R, D), valid (1,),
    start (1,), queries (Q, D)) -> ((Q, k) scores, (Q, k) global rows)``
    for a shard whose first global row is ``start``."""

    @torch.no_grad()
    def local_topk(corpus_l, valid_l, start, queries):
        scores = queries @ corpus_l.T                    # (Q, R_local)
        col = torch.arange(corpus_l.shape[0], device=corpus_l.device)
        scores = scores.masked_fill(col[None, :] >= valid_l, -torch.inf)
        return exact_topk(scores, col[None, :] + start, k)  # local winners

    return local_topk


def group_topk(fn, shards, queries, k: int, group=None
               ) -> tuple[np.ndarray, np.ndarray]:
    """The JAX ``shard_map`` body over this rank's part of a grid:
    ``fn`` (one shard's program, :func:`make_topk_fn`) on every shard
    ``(corpus, valid, start)`` on its card, all launched before anything
    is read back; each one's (Q, k) candidates copied to the first
    shard's card and concatenated in shard order; with a process
    ``group``, those (Q, G * k) gathered over the ranks in rank order (one
    all-gather for scores, one for rows); then one exact top-k over the
    ``n * k`` (ties by the lower row, across shard and rank boundaries
    too).  ``queries`` is a host array or a tensor.  Returns host ((Q, k)
    float32 scores, (Q, k) int32 rows); the read back is the call's one
    sync."""
    q = (torch.from_numpy(queries) if isinstance(queries, np.ndarray)
         else queries)
    on = {c.device: q.to(c.device) for c, _, _ in shards}
    parts = [fn(c, v, s, on[c.device]) for c, v, s in shards]
    scores, idx = parts[0]
    if len(parts) > 1:
        first = scores.device
        scores = torch.cat([s.to(first) for s, _ in parts], 1)
        idx = torch.cat([i.to(first) for _, i in parts], 1)
    if group is not None:
        world, n = dist.get_world_size(group), scores.shape[0]
        # (W * Q, G * k) -> (Q, W * G * k): rank-major, then shard order
        scores, idx = (all_gather_rows(x, group).view(world, n, -1)
                       .permute(1, 0, 2).reshape(n, -1)
                       for x in (scores, idx))
    if len(parts) > 1 or group is not None:
        scores, idx = exact_topk(scores, idx, k)
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
      shards on its devices;
    - ``k``: retrieval depth;
    - ``query_buckets``: the query-batch ladder to warm (share the
      engine's so batcher output feeds straight through);
    - ``device``: ``cuda`` unless the caller passes ``cpu``; a list of
      devices is a device group;
    - ``group``: a process group whose every rank holds a device group
      of the same size G (a grid of W x G shards; every rank calls each
      query with the same rows, see ``serving/lockstep.py``).  Shard
      ``rank * G + d`` of ``max(ceil(N / (W * G)), k)`` rows lives on
      the rank's d-th device, the JAX mesh's geometry.

    ``announce``, None unless ``serving/lockstep.py`` sets it, is called
    under the dispatch lock with each query batch before it runs.
    """

    def __init__(self, embeddings: np.ndarray, *, k: int = 10,
                 query_buckets: Sequence[int] = (8,), device="cuda",
                 group=None, precompile: bool = True):
        self.grid = serving_grid(device, group)
        self.devices = list(self.grid.devices)
        self.device = self.devices[0]
        self.announce = None
        emb = np.ascontiguousarray(embeddings, dtype=np.float32)
        if emb.ndim != 2:
            raise ValueError(f"expected (N, D) embeddings, got {emb.shape}")
        self.size, self.dim = emb.shape
        self.k = int(k)
        if not 1 <= self.k <= self.size:
            raise ValueError(f"k={k} outside [1, corpus size {self.size}]")
        self.query_buckets = tuple(sorted(int(b) for b in query_buckets))
        # Pad the corpus so rows split evenly AND every shard holds at
        # least k rows (the local top-k needs k <= local extent).
        rows = max(-(-self.size // self.grid.extent), self.k)
        self._shards = [shard_tensors(emb, r, rows, dev)   # resident
                        for r, dev in zip(self.grid.shards, self.devices)]
        self._fn = make_topk_fn(self.k)
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
            if self.announce is not None:
                q = self.announce("query", q)
            scores, idx = self._launch(q)
        with self._stats_lock:
            self._calls += 1
            self._shapes.add(tuple(q.shape))
        return scores[:n], idx[:n]

    def _launch(self, q):
        return group_topk(self._fn, self._shards, q, self.k,
                          self.grid.group)

    def replay_query(self, q) -> None:
        """Run a query batch another rank announced (padded, a host array
        or a tensor), its result dropped."""
        with DEVICE_DISPATCH_LOCK:
            self._launch(q)

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
