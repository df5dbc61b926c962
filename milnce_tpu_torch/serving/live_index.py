"""Live retrieval index: online ingest with generation-swapped corpus
shards (port of ``milnce_tpu/serving/live_index.py``).

``DeviceRetrievalIndex`` (serving/index.py) freezes its corpus at boot.
This module is its double-buffered twin:

- **ingest** (:meth:`LiveRetrievalIndex.add`) appends embedding rows to
  a host-side pending buffer and returns at once — no device work, no
  lock shared with the query path beyond a pointer read;
- a **background builder thread** drains the buffer, concatenates the
  grown corpus on the host, copies its shard to the device and performs
  an **atomic generation swap** — one reference assignment under
  ``serving.live_index.state``.  Queries capture the generation
  reference once per call, so every query is answered by exactly ONE
  generation, and the old generation's tensors are freed once the last
  in-flight query drops them;
- **publication after the copy**: the builder copies a generation on a
  side stream of its own (on ``cuda``), outside the dispatch lock and
  through two pinned staging slots, so the copy is an asynchronous DMA
  and queries keep running meanwhile; it then waits for the copy's event
  and marks the tensors as used on the query stream (``record_stream``)
  before it publishes.  A query on another thread can never read a
  half-copied corpus, and the allocator does not hand a freed
  generation's blocks back to the side stream while a query stream
  could still read them;
- **the rung rule**: per-shard row capacity rides the same power-of-two
  rung rule as the engine's bucket ladder (:func:`shard_rung`), so a
  swap within a rung re-uses the same shapes.  Crossing a rung is a
  builder event: the new shape is warmed on the builder thread before
  the swap publishes (``builder_compiles`` counts those warms).
  :meth:`recompiles` is 0 by construction in eager PyTorch, as the
  frozen index's is: there is no jit cache, and every query is padded to
  a warmed bucket.  What a rung crossing does move is the device memory:
  two generations are resident until the last query drops the old one.

Failure discipline: a build/swap failure (the ``index.swap_raise`` fault
site fires just before publication) leaves the OLD generation serving,
re-queues the drained rows at the front of the pending buffer, and the
builder thread survives to retry — first on the next ingest/flush
signal, else on a bounded idle backoff.  ``index.ingest_hang`` wedges an
``add`` caller without touching the query path.

Snapshot/restore ties into the ``milnce-export`` artifact family
(serving/export.py): :meth:`snapshot` writes the live generation's
corpus as ``corpus.npz`` + ``index_meta.json`` — the JAX package's
files, so a snapshot opens in either package; :meth:`restore` boots a
new index from one, generation counter preserved, bit-exact.

With ``group=`` the corpus rows shard over the group's ranks as in
``DeviceRetrievalIndex``: every rank ingests the same rows, and a query
is a collective, so the ranks must query the same generation (flush on
every rank before querying).
"""

from __future__ import annotations

import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from milnce_tpu_torch.analysis.lockrt import make_lock
from milnce_tpu_torch.obs import metrics as obs_metrics
from milnce_tpu_torch.obs import spans as obs_spans
from milnce_tpu_torch.resilience import faults
from milnce_tpu_torch.serving.batcher import pad_rows
from milnce_tpu_torch.serving.engine import DEVICE_DISPATCH_LOCK, serving_device
from milnce_tpu_torch.serving.export import (export_corpus_snapshot,
                                             load_corpus_snapshot)
from milnce_tpu_torch.serving.index import make_topk_fn, shard_corpus

# Builder idle poll (bounds close() latency) and the backoff before a
# FAILED build is retried without a fresh ingest/flush signal.
_IDLE_POLL_S = 0.05
_RETRY_BACKOFF_S = 0.25
# Bytes of one of the builder's two pinned staging slots (cuda).
_STAGE_BYTES = 64 << 20


def shard_rung(size: int, n_data: int, k: int, floor: int = 0) -> int:
    """Per-shard row capacity for a ``size``-row corpus: the smallest
    power of two >= max(ceil(size / n_data), k, floor, 1).

    The serving twin of ``engine.bucket_ladder``'s rung rule: corpus
    growth within a rung swaps generations at IDENTICAL padded shapes;
    only crossing a rung — a doubling, so O(log corpus) times ever —
    builds a new shape."""
    need = max(-(-size // n_data) if size else 1, k, int(floor), 1)
    rung = 1
    while rung < need:
        rung *= 2
    return rung


def recommended_min_shard_rows(corpus_rows: int, n_data: int,
                               headroom: int = 2) -> int:
    """``--serve.index_min_shard_rows`` sizing rule for a corpus that is
    expected to GROW to ~``corpus_rows``: the rung that fits
    ``headroom`` x the per-shard share, so ingest reaches the target size
    without ever crossing a rung."""
    if corpus_rows <= 0:
        raise ValueError("corpus_rows must be positive")
    if n_data <= 0:
        raise ValueError("n_data must be positive")
    if headroom < 1:
        raise ValueError("headroom must be >= 1")
    return shard_rung(int(corpus_rows) * int(headroom), n_data, 1)


class _Generation:
    """One immutable published corpus generation.  Everything here is
    written once by the builder (or ``__init__``) before publication and
    only ever read afterwards — the atomic-swap contract."""

    __slots__ = ("gen", "host", "size", "rows", "corpus", "valid", "start",
                 "built_mono")

    def __init__(self, gen: int, host: np.ndarray, rows: int,
                 corpus, valid, start):
        self.gen = int(gen)
        self.host = host                 # (size, D) f32 — snapshot/rebuild
        self.size = int(host.shape[0])
        self.rows = int(rows)            # per-shard capacity (the rung)
        self.corpus = corpus             # device, (rows, D): this shard
        self.valid = valid               # device, (1,) int32
        self.start = start               # device, (1,): first global row
        self.built_mono = time.monotonic()


class LiveRetrievalIndex:
    """Generation-swapped corpus on the card + fixed-k exact top-k.

    Query surface is a superset of :class:`DeviceRetrievalIndex`
    (``topk`` / ``bucket_for`` / ``stats`` / ``recompiles``), plus the
    live surface: ``add`` / ``flush`` / ``topk_with_gen`` / ``snapshot``
    / ``restore``.  ``embeddings=None`` boots an EMPTY index (``dim``
    required); queries refuse until the corpus holds at least ``k`` rows,
    but ingest works from the first second.  ``device`` is ``cuda``
    unless the caller passes ``cpu``.
    """

    def __init__(self, embeddings: Optional[np.ndarray] = None, *,
                 k: int = 10, query_buckets: Sequence[int] = (8,),
                 device="cuda", dim: Optional[int] = None,
                 min_shard_rows: int = 0, generation: int = 0,
                 precompile: bool = True, group=None,
                 registry: Optional[obs_metrics.MetricsRegistry] = None,
                 recorder: Optional[obs_spans.SpanRecorder] = None):
        self.device = serving_device(device)
        if embeddings is None:
            if dim is None:
                raise ValueError("an empty live index needs dim= (the "
                                 "embedding width ingest rows will have)")
            emb = np.zeros((0, int(dim)), np.float32)
        else:
            emb = np.ascontiguousarray(embeddings, dtype=np.float32)
            if emb.ndim != 2:
                raise ValueError(f"expected (N, D) embeddings, "
                                 f"got {emb.shape}")
        self.dim = int(emb.shape[1])
        self.k = int(k)
        if self.k < 1:
            raise ValueError(f"k={k} < 1")
        self.query_buckets = tuple(sorted(int(b) for b in query_buckets))
        if group is None:
            self._n_data, self._rank = 1, 0
        else:
            self._n_data = dist.get_world_size(group)
            self._rank = dist.get_rank(group)
        self._min_shard_rows = int(min_shard_rows)
        self._fn = make_topk_fn(self.k, group)
        # the builder's copies run on a stream of their own (cuda)
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)
        self._stage = None        # the builder's pinned slots (cuda)
        self._recorder = recorder
        reg = registry if registry is not None \
            else obs_metrics.MetricsRegistry()
        self._m_ingested = reg.counter(
            "milnce_serve_index_ingested_rows_total",
            "embedding rows accepted into the live-index pending buffer")
        self._m_swaps = reg.counter(
            "milnce_serve_index_swaps_total",
            "generation swaps published (the corpus grew atomically)")
        self._m_swap_failures = reg.counter(
            "milnce_serve_index_swap_failures_total",
            "builds/swaps that failed (old generation kept serving, "
            "rows re-queued)")
        self._m_builder_compiles = reg.counter(
            "milnce_serve_index_builder_compiles_total",
            "rung-crossing warms performed on the builder thread "
            "(boot-equivalent; the query path never warms)")
        reg.gauge("milnce_serve_index_generation",
                  "live-index generation counter",
                  fn=lambda: float(self.stats()["generation"]))
        reg.gauge("milnce_serve_index_pending_rows",
                  "ingested rows not yet swapped live",
                  fn=lambda: float(self.stats()["pending_rows"]))
        reg.gauge("milnce_serve_index_last_swap_age_seconds",
                  "seconds since the last generation swap",
                  fn=lambda: float(self.stats()["last_swap_age_s"]))
        # One lock for all mutable host state: generation pointer,
        # pending buffer, call/warm accounting.  NEVER held across device
        # work, sleeps, or metric calls.
        self._state_lock = make_lock("serving.live_index.state")
        self._pending: list[np.ndarray] = []   # guarded-by: _state_lock
        self._pending_rows = 0                 # guarded-by: _state_lock
        self._ingested_total = 0               # guarded-by: _state_lock
        self._calls = 0                        # guarded-by: _state_lock
        self._shapes: set = set()              # guarded-by: _state_lock
        self._baseline = None                  # guarded-by: _state_lock
        self._swaps = 0                        # guarded-by: _state_lock
        self._swap_failures = 0                # guarded-by: _state_lock
        self._last_attempt = 0.0               # guarded-by: _state_lock
        self._warmed_rungs: set = set()        # guarded-by: _state_lock
        # the published generation: written only under _state_lock (one
        # reference assignment — the atomic swap); readers take the lock
        # for the pointer read and hold the REFERENCE through device work
        self._gen = self._make_generation(     # guarded-by: _state_lock
            int(generation), emb)
        self._boot_size = self._gen.size
        self._work = threading.Event()
        self._closed = threading.Event()
        self._builder = threading.Thread(target=self._builder_loop,
                                         daemon=True,
                                         name="live-index-builder")
        if precompile:
            self.warmup()
        self._builder.start()

    # ---- geometry / device copies ----------------------------------------

    def _make_generation(self, gen: int, host: np.ndarray) -> _Generation:
        """Pad this rank's shard of ``host`` to its rung and copy it to
        the device; returns only once the copy has finished there."""
        rows = shard_rung(host.shape[0], self._n_data, self.k,
                          self._min_shard_rows)
        lo = self._rank * rows
        mine = host[lo:lo + rows]
        start = np.asarray([lo], np.int64)
        if self._copy_stream is None:
            corpus, valid = shard_corpus(mine, 1, rows)
            tensors = [torch.from_numpy(a).to(self.device)
                       for a in (corpus, valid, start)]
        else:
            tensors = self._upload(mine, rows, start)
        return _Generation(gen, host, rows, *tensors)

    def _upload(self, mine: np.ndarray, rows: int, start: np.ndarray
                ) -> list:
        """Copy this rank's rows up on the builder's own stream through
        two pinned staging slots, zeroing the pad rows on the card.  A
        copy from pinned memory is a true asynchronous DMA, so the queries
        go on beside it; a pageable source would be staged through the
        driver's buffers, which the queries' own copies share.  Returns
        (corpus, valid, start) once the copy is whole on the device, each
        marked as used by the query stream from then on."""
        if self._stage is None:
            chunk = max(1, _STAGE_BYTES // (4 * self.dim))
            self._stage = [(torch.empty((chunk, self.dim),
                                        dtype=torch.float32,
                                        pin_memory=True),
                            torch.cuda.Event()) for _ in range(2)]
        chunk = self._stage[0][0].shape[0]
        n = mine.shape[0]
        query_stream = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self._copy_stream):
            corpus = torch.empty((rows, self.dim), dtype=torch.float32,
                                 device=self.device)
            corpus[n:].zero_()
            for j, a in enumerate(range(0, n, chunk)):
                buf, free = self._stage[j % 2]
                free.synchronize()       # the slot's last copy has left it
                b = min(n, a + chunk)
                buf.numpy()[:b - a] = mine[a:b]
                corpus[a:b].copy_(buf[:b - a], non_blocking=True)
                free.record(self._copy_stream)
            tensors = [corpus] + [torch.from_numpy(x).to(self.device)
                                  for x in (np.asarray([n], np.int32),
                                            start)]
            done = torch.cuda.Event()
            done.record(self._copy_stream)
        done.synchronize()               # the copy is whole on the device
        for t in tensors:                # used by queries from now on
            t.record_stream(query_stream)
        return tensors

    def _dispatch(self, g: _Generation, q_padded: np.ndarray):
        with DEVICE_DISPATCH_LOCK:
            qd = torch.from_numpy(q_padded).to(self.device)
            scores, idx = self._fn(g.corpus, g.valid, g.start, qd)
            scores = scores.to("cpu").numpy()
            idx = idx.to("cpu").numpy().astype(np.int32)
        with self._state_lock:
            self._shapes.add((g.rows, q_padded.shape))
        return scores, idx

    def _warm_rung(self, g: _Generation) -> None:
        """Run the top-k for every query bucket at ``g``'s shape before
        it serves, then re-snapshot the shape baseline: rung warms are
        boot-equivalent builder work, never a query-path event."""
        with self._state_lock:
            if g.rows in self._warmed_rungs:
                return
        for b in self.query_buckets:
            self._dispatch(g, np.zeros((b, self.dim), np.float32))
        self._m_builder_compiles.inc()
        with self._state_lock:
            self._warmed_rungs.add(g.rows)
            self._baseline = frozenset(self._shapes)

    # ---- query path ------------------------------------------------------

    def bucket_for(self, n: int) -> int:
        for b in self.query_buckets:
            if n <= b:
                return b
        raise ValueError(f"{n} queries exceeds the top query bucket "
                         f"{self.query_buckets[-1]}")

    def topk_with_gen(self, queries: np.ndarray
                      ) -> tuple[np.ndarray, np.ndarray, int]:
        """(n, D) query embeddings -> ((n, k) scores, (n, k) corpus row
        indices, generation), ties by the lower row.  The generation
        reference is captured ONCE — a swap completing mid-query cannot
        tear the answer."""
        q = np.ascontiguousarray(queries, dtype=np.float32)
        if q.ndim != 2 or q.shape[1] != self.dim:
            raise ValueError(f"expected (n, {self.dim}) queries, "
                             f"got {q.shape}")
        with self._state_lock:
            g = self._gen
        if g.size < self.k:
            raise ValueError(f"corpus holds {g.size} rows < k={self.k} — "
                             "ingest more before querying")
        n = q.shape[0]
        scores, idx = self._dispatch(g, pad_rows(q, self.bucket_for(n)))
        with self._state_lock:
            self._calls += 1
        return scores[:n], idx[:n], g.gen

    def topk(self, queries: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """DeviceRetrievalIndex-compatible surface (no generation)."""
        scores, idx, _ = self.topk_with_gen(queries)
        return scores, idx

    @property
    def size(self) -> int:
        """LIVE corpus rows (pending ingest not yet included)."""
        with self._state_lock:
            return self._gen.size

    @property
    def generation(self) -> int:
        with self._state_lock:
            return self._gen.gen

    # ---- ingest path -----------------------------------------------------

    def add(self, embeddings: np.ndarray) -> dict:
        """Queue (n, D) embedding rows for the next generation; returns
        ``{"pending_rows", "generation", "target_rows"}``.  Host-only —
        the builder does the device work."""
        rows = np.ascontiguousarray(embeddings, dtype=np.float32)
        if rows.ndim != 2 or rows.shape[1] != self.dim:
            raise ValueError(f"expected (n, {self.dim}) embeddings, "
                             f"got {rows.shape}")
        if rows.shape[0] < 1:
            raise ValueError("empty ingest batch")
        if self._closed.is_set():
            raise RuntimeError("live index is closed")
        # fault site: a wedged ingest caller — must never touch the
        # query path's locks
        faults.maybe_hang("index.ingest_hang")
        n = rows.shape[0]
        with self._state_lock:
            self._pending.append(rows)
            self._pending_rows += n
            self._ingested_total += n
            out = {"pending_rows": self._pending_rows,
                   "generation": self._gen.gen,
                   "target_rows": self._boot_size + self._ingested_total}
        self._m_ingested.inc(n)
        self._work.set()
        return out

    def flush(self, timeout: float = 10.0) -> bool:
        """Block until every row ingested BEFORE this call is live, or
        ``timeout`` expires — False means rows are still pending, never an
        exception."""
        with self._state_lock:
            target = self._boot_size + self._ingested_total
        self._work.set()
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._state_lock:
                live = self._gen.size
            if live >= target:
                return True
            if self._closed.is_set():
                return False
            time.sleep(0.005)
        return False

    # ---- builder thread --------------------------------------------------

    def _builder_loop(self) -> None:
        while not self._closed.is_set():
            signaled = self._work.wait(timeout=_IDLE_POLL_S)
            if self._closed.is_set():
                return
            if signaled:
                self._work.clear()
            else:
                # idle tick: retry a previously-failed build, backed off
                with self._state_lock:
                    retry = (self._pending_rows > 0 and
                             time.monotonic() - self._last_attempt
                             > _RETRY_BACKOFF_S)
                if not retry:
                    continue
            self._build_once()

    def _build_once(self) -> None:
        with self._state_lock:
            if not self._pending:
                return
            pending, self._pending = self._pending, []
            moved = self._pending_rows
            self._pending_rows = 0
            base = self._gen
            self._last_attempt = time.monotonic()
        rec = self._recorder if self._recorder is not None \
            else obs_spans.get_recorder()
        try:
            with rec.span("index.build", rows=moved,
                          base_gen=base.gen) as span:
                t0 = time.perf_counter()
                host = np.concatenate([base.host] + pending) \
                    if base.size else np.concatenate(pending)
                t1 = time.perf_counter()
                g = self._make_generation(base.gen + 1, host)
                span["host_ms"] = round((t1 - t0) * 1e3, 4)
                span["upload_ms"] = round((time.perf_counter() - t1) * 1e3,
                                          4)
                self._warm_rung(g)
                # fault site: the publication step itself fails — must
                # leave the old generation serving and the builder alive
                faults.maybe_raise("index.swap_raise")
                with self._state_lock:
                    self._gen = g                 # THE atomic swap
                    self._swaps += 1
            self._m_swaps.inc()
            rec.event("index.swap", generation=g.gen, size=g.size,
                      shard_rows=g.rows)
        except Exception as exc:
            # failed build/swap: re-queue the drained rows at the FRONT;
            # the old generation keeps serving and this thread runs on
            with self._state_lock:
                self._pending = pending + self._pending
                self._pending_rows += moved
                self._swap_failures += 1
            self._m_swap_failures.inc()
            rec.event("index.swap_fail", base_gen=base.gen, rows=moved,
                      error=type(exc).__name__)

    # ---- warmup + recompile accounting -----------------------------------

    def warmup(self) -> None:
        with self._state_lock:
            g = self._gen
        self._warm_rung(g)

    def recompiles(self) -> int:
        """(rung, query shape) pairs dispatched since the last warm that
        it did not run; -1 before the first warm.  0 by construction in
        eager PyTorch (every query is padded to a bucket the builder
        warmed at the published rung): it keeps the JAX index's key so
        the two ``stats()`` agree."""
        with self._state_lock:
            if self._baseline is None:
                return -1
            return len(self._shapes - self._baseline)

    # ---- snapshot / restore ----------------------------------------------

    def snapshot(self, out_dir: str) -> str:
        """Write the LIVE generation's corpus as a ``milnce-export``
        family artifact (corpus.npz + index_meta.json).  Pending ingest
        rows are not included — :meth:`flush` first to capture them."""
        with self._state_lock:
            g = self._gen
        return export_corpus_snapshot(out_dir, g.host, generation=g.gen,
                                      k=self.k, source="live_index")

    @classmethod
    def restore(cls, snap_dir: str, **kwargs) -> "LiveRetrievalIndex":
        """Boot a live index from a :meth:`snapshot` directory (either
        package's) — generation counter preserved, corpus bit-exact."""
        meta, emb = load_corpus_snapshot(snap_dir)
        kwargs.setdefault("k", meta["k"])
        kwargs.setdefault("generation", meta["generation"])
        return cls(emb, **kwargs)

    # ---- lifecycle / observability ---------------------------------------

    def close(self, timeout: float = 5.0) -> None:
        self._closed.set()
        self._work.set()
        self._builder.join(timeout)

    def stats(self) -> dict:
        """Superset of ``DeviceRetrievalIndex.stats()`` — the JAX live
        index's keys (the ``/healthz`` ``index`` section contract)."""
        now = time.monotonic()
        with self._state_lock:
            g = self._gen
            out = {
                "size": g.size, "dim": self.dim, "k": self.k,
                "query_buckets": list(self.query_buckets),
                "calls": self._calls,
                "generation": g.gen,
                "pending_rows": self._pending_rows,
                "ingested_rows": self._ingested_total,
                "swaps": self._swaps,
                "swap_failures": self._swap_failures,
                "shard_rows": g.rows,
                "capacity": g.rows * self._n_data,
                "last_swap_age_s": round(now - g.built_mono, 3),
            }
        out["recompiles"] = self.recompiles()
        out["builder_alive"] = self._builder.is_alive()
        return out
