"""Live retrieval index: online ingest with generation-swapped corpus
shards (port of ``milnce_tpu/serving/live_index.py``).

``DeviceRetrievalIndex`` (serving/index.py) freezes its corpus at boot.
This module is its double-buffered twin:

- **ingest** (:meth:`LiveRetrievalIndex.add`) appends embedding rows to
  a host-side pending buffer and returns at once — no device work, no
  lock shared with the query path beyond a pointer read;
- a **background builder thread** drains the buffer, concatenates the
  grown corpus on the host, copies each shard to its device and performs
  an **atomic generation swap** — one reference assignment under
  ``serving.live_index.state``, made once every shard's copy has
  finished.  A generation holds every shard's tensors, and queries
  capture the generation reference once per call, so every query is
  answered by exactly ONE generation on every card, and the old
  generation's tensors are freed once the last in-flight query drops
  them;
- **publication after the copy**: the builder copies a generation on a
  side stream of each card's own (on ``cuda``), outside the dispatch
  lock and through two pinned staging slots, so the copy is an
  asynchronous DMA and queries keep running meanwhile; it then waits for
  each card's copy and marks the tensors as used on that card's query
  stream (``record_stream``) before it publishes.  A query on another
  thread can never read a half-copied corpus, and the allocator does not
  hand a freed generation's blocks back to the side stream while a query
  stream could still read them;
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

``device`` may be a device group, and ``group=`` a process group of
ranks that each hold one of the same size: the corpus rows shard over
the grid's W x G shards as in ``DeviceRetrievalIndex``
(``shard_rung(size, W * G, k, floor)`` rows a shard, the JAX mesh's
geometry).  A query over a process group is a collective, so every rank
must query the same generation.  A caller that drives every rank itself
ingests the same rows on each and flushes on each before querying.
Under ``serving/lockstep.py`` rank 0 alone ingests: its builder
announces each generation's new rows (``ingest``) before it copies them
up and the swap (``swap``) when they are whole, both under the dispatch
lock, and every other rank builds the same generation from the announced
rows on its own builder thread and publishes it at the swap, so the swap
happens at the same point of the call order on every rank and no query
mixes generations across ranks.
"""

from __future__ import annotations

import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from milnce_tpu_torch.analysis.lockrt import make_lock
from milnce_tpu_torch.obs import metrics as obs_metrics
from milnce_tpu_torch.obs import spans as obs_spans
from milnce_tpu_torch.parallel.devices import serving_grid
from milnce_tpu_torch.resilience import faults
from milnce_tpu_torch.serving.batcher import pad_rows
from milnce_tpu_torch.serving.engine import DEVICE_DISPATCH_LOCK
from milnce_tpu_torch.serving.export import (export_corpus_snapshot,
                                             load_corpus_snapshot)
from milnce_tpu_torch.serving.index import (group_topk, make_topk_fn,
                                            shard_tensors)

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

    __slots__ = ("gen", "host", "size", "rows", "shards", "built_mono")

    def __init__(self, gen: int, host: np.ndarray, rows: int, shards: list):
        self.gen = int(gen)
        self.host = host                 # (size, D) f32 — snapshot/rebuild
        self.size = int(host.shape[0])
        self.rows = int(rows)            # per-shard capacity (the rung)
        # every shard this process holds, each on its device: (corpus
        # (rows, D), valid (1,) int32, start (1,) first global row)
        self.shards = shards
        self.built_mono = time.monotonic()


class LiveRetrievalIndex:
    """Generation-swapped corpus on the card + fixed-k exact top-k.

    Query surface is a superset of :class:`DeviceRetrievalIndex`
    (``topk`` / ``bucket_for`` / ``stats`` / ``recompiles``), plus the
    live surface: ``add`` / ``flush`` / ``topk_with_gen`` / ``snapshot``
    / ``restore``.  ``embeddings=None`` boots an EMPTY index (``dim``
    required); queries refuse until the corpus holds at least ``k`` rows,
    but ingest works from the first second.  ``device`` is ``cuda``
    unless the caller passes ``cpu``, or a device group; ``group`` a
    process group (the module docstring).  ``announce``, None unless
    ``serving/lockstep.py`` sets it, is called under the dispatch lock
    with each query batch, each generation's new rows and each swap.
    """

    def __init__(self, embeddings: Optional[np.ndarray] = None, *,
                 k: int = 10, query_buckets: Sequence[int] = (8,),
                 device="cuda", dim: Optional[int] = None,
                 min_shard_rows: int = 0, generation: int = 0,
                 precompile: bool = True, group=None,
                 registry: Optional[obs_metrics.MetricsRegistry] = None,
                 recorder: Optional[obs_spans.SpanRecorder] = None):
        self.grid = serving_grid(device, group)
        self.devices = list(self.grid.devices)
        self.device = self.devices[0]
        self.announce = None
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
        self._n_data = self.grid.extent
        self._mine = self.grid.shards
        self._min_shard_rows = int(min_shard_rows)
        self._fn = make_topk_fn(self.k)
        # each card's generation copies run on a stream of its own (cuda)
        self._copy_streams = {dev: torch.cuda.Stream(dev)
                              for dev in dict.fromkeys(self.devices)
                              if dev.type == "cuda"}
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
        # a replaying rank: the count of generations announced to it
        # (0: none, the builder publishes what it builds) and what its
        # builder made of the latest (the generation, or the exception
        # its build raised), ``_staged_ready`` set once that is known
        self._announced = 0                    # guarded-by: _state_lock
        self._staged = None                    # guarded-by: _state_lock
        self._staged_ready = threading.Event()
        # the published generation: written only under _state_lock (one
        # reference assignment); readers take the lock for the pointer
        # read.  ``_serving`` is the generation queries run on, written
        # just before ``_gen`` under the dispatch lock (THE atomic swap):
        # a query takes it under the lock it dispatches under and holds
        # the REFERENCE through its device work, so no serving lock is
        # ever taken inside another
        self._gen = self._make_generation(     # guarded-by: _state_lock
            int(generation), emb)
        self._serving = self._gen      # guarded-by: DEVICE_DISPATCH_LOCK
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
        """Pad each of this process's shards of ``host`` to its rung and
        copy it to its device; returns only once every copy has finished
        there, so the generation it builds is whole on every card."""
        rows = shard_rung(host.shape[0], self._n_data, self.k,
                          self._min_shard_rows)
        return _Generation(gen, host, rows, [
            self._copy_shard(host, r, rows, dev)
            for r, dev in zip(self._mine, self.devices)])

    def _copy_shard(self, host: np.ndarray, shard: int, rows: int,
                    device) -> tuple:
        """Shard ``shard`` of ``host`` on ``device``, the copy finished."""
        if device.type != "cuda":
            return shard_tensors(host, shard, rows, device)
        lo = shard * rows
        return self._upload(host[lo:lo + rows], rows,
                            np.asarray([lo], np.int64), device)

    def _upload(self, mine: np.ndarray, rows: int, start: np.ndarray,
                device) -> tuple:
        """Copy one shard's rows up on its card's copy stream through the
        two pinned staging slots, zeroing the pad rows on the card.  A
        copy from pinned memory is a true asynchronous DMA, so the queries
        go on beside it; a pageable source would be staged through the
        driver's buffers, which the queries' own copies share.  Returns
        (corpus, valid, start) once the copy is whole on the device, each
        marked as used by the card's query stream from then on."""
        if self._stage is None:
            chunk = max(1, _STAGE_BYTES // (4 * self.dim))
            self._stage = [[torch.empty((chunk, self.dim),
                                        dtype=torch.float32,
                                        pin_memory=True), None]
                           for _ in range(2)]
        chunk = self._stage[0][0].shape[0]
        n = mine.shape[0]
        stream = self._copy_streams[device]
        query_stream = torch.cuda.current_stream(device)
        with torch.cuda.stream(stream):
            corpus = torch.empty((rows, self.dim), dtype=torch.float32,
                                 device=device)
            corpus[n:].zero_()
            for j, a in enumerate(range(0, n, chunk)):
                slot = self._stage[j % 2]
                if slot[1] is not None:
                    slot[1].synchronize()  # the slot's last copy has left
                b = min(n, a + chunk)
                slot[0].numpy()[:b - a] = mine[a:b]
                corpus[a:b].copy_(slot[0][:b - a], non_blocking=True)
                # an event of this card's: the slots serve every card
                slot[1] = torch.cuda.Event()
                slot[1].record(stream)
            tensors = (corpus,) + tuple(
                torch.from_numpy(x).to(device)
                for x in (np.asarray([n], np.int32), start))
            done = torch.cuda.Event()
            done.record(stream)
        done.synchronize()               # the copy is whole on the device
        for t in tensors:                # used by queries from now on
            t.record_stream(query_stream)
        return tensors

    def _launch(self, g: _Generation, q_padded):
        """The top-k of ``g`` (the dispatch lock held)."""
        return group_topk(self._fn, g.shards, q_padded, self.k,
                          self.grid.group)

    def _warm_queries(self, g: _Generation) -> list:
        """One zero batch a query bucket if ``g``'s rung was never
        warmed, else none (the same on every rank of a lockstep)."""
        with self._state_lock:
            if g.rows in self._warmed_rungs:
                return []
        return [np.zeros((b, self.dim), np.float32)
                for b in self.query_buckets]

    def _warmed(self, g: _Generation, queries: list) -> None:
        """Record a warm of ``g``'s rung (no dispatch lock held) and
        re-snapshot the shape baseline: rung warms are boot-equivalent
        builder work, never a query-path event."""
        if not queries:
            return
        self._m_builder_compiles.inc()
        with self._state_lock:
            self._shapes.update((g.rows, q.shape) for q in queries)
            self._warmed_rungs.add(g.rows)
            self._baseline = frozenset(self._shapes)

    def _warm_rung(self, g: _Generation) -> None:
        """Run the top-k for every query bucket at ``g``'s shape before
        it serves, a dispatch each."""
        queries = self._warm_queries(g)
        for q in queries:
            with DEVICE_DISPATCH_LOCK:
                self._launch(g, q)
        self._warmed(g, queries)

    def _swap_in(self, g: _Generation, announce=None) -> None:
        """Publish ``g`` at one point of the call order: under the
        dispatch lock, announced to the other ranks first (``announce``),
        its rung warmed there if it is new, then ``_serving``; ``_gen``
        follows under the state lock."""
        queries = self._warm_queries(g)
        with DEVICE_DISPATCH_LOCK:
            if announce is not None:
                announce("swap", None, g.gen)
            for q in queries:
                self._launch(g, q)
            self._serving = g             # THE atomic swap
        self._warmed(g, queries)
        with self._state_lock:
            self._gen = g
            self._swaps += 1

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
            size = self._gen.size        # only grows
        if size < self.k:
            raise ValueError(f"corpus holds {size} rows < k={self.k} — "
                             "ingest more before querying")
        n = q.shape[0]
        q = pad_rows(q, self.bucket_for(n))
        with DEVICE_DISPATCH_LOCK:
            if self.announce is not None:
                q = self.announce("query", q)
            g = self._serving
            scores, idx = self._launch(g, q)
        with self._state_lock:
            self._calls += 1
            self._shapes.add((g.rows, tuple(q.shape)))
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
            seq = self._announced
            self._last_attempt = time.monotonic()
        rec = self._rec()
        try:
            with rec.span("index.build", rows=moved,
                          base_gen=base.gen) as span:
                t0 = time.perf_counter()
                if self.announce is not None:
                    with DEVICE_DISPATCH_LOCK:
                        self.announce("ingest", np.concatenate(pending),
                                      base.gen + 1)
                host = np.concatenate([base.host] + pending) \
                    if base.size else np.concatenate(pending)
                t1 = time.perf_counter()
                g = self._make_generation(base.gen + 1, host)
                span["host_ms"] = round((t1 - t0) * 1e3, 4)
                span["upload_ms"] = round((time.perf_counter() - t1) * 1e3,
                                          4)
                if self.announce is None and not seq:
                    self._warm_rung(g)
                # fault site: the publication step itself fails — must
                # leave the old generation serving and the builder alive
                faults.maybe_raise("index.swap_raise")
                if seq:
                    # a replaying rank: rank 0's announced swap publishes
                    # it (replay_swap), at that point of the call order
                    self._stage_built(seq, g)
                    return
                # with an announce the other ranks warm the rung and swap
                # at this point of the call order too
                self._swap_in(g, self.announce)
            self._swapped(g, rec)
        except Exception as exc:
            # failed build/swap: re-queue the drained rows at the FRONT;
            # the old generation keeps serving and this thread runs on.
            # A replaying rank re-queues nothing (rank 0 announces the
            # rows again) and fails the swap that awaits this build.
            with self._state_lock:
                if not seq:
                    self._pending = pending + self._pending
                    self._pending_rows += moved
                self._swap_failures += 1
            if seq:
                self._stage_built(seq, exc)
            self._m_swap_failures.inc()
            rec.event("index.swap_fail", base_gen=base.gen, rows=moved,
                      error=type(exc).__name__)

    def _rec(self) -> obs_spans.SpanRecorder:
        return self._recorder if self._recorder is not None \
            else obs_spans.get_recorder()

    def _swapped(self, g: _Generation, rec) -> None:
        self._m_swaps.inc()
        rec.event("index.swap", generation=g.gen, size=g.size,
                  shard_rows=g.rows)

    # ---- replaying rank 0's calls (serving/lockstep.py) -----------------

    def replay_query(self, q) -> None:
        """Run a query batch rank 0 announced, its result dropped."""
        with DEVICE_DISPATCH_LOCK:
            self._launch(self._serving, q)

    def replay_ingest(self, gen: int, rows) -> None:
        """Rank 0 announced generation ``gen``: the live one plus
        ``rows``.  They become the builder's whole input (a later
        announcement of the same generation, after a failed swap there,
        replaces it), and the builder stages what it builds for
        :meth:`replay_swap`."""
        rows = np.ascontiguousarray(torch.as_tensor(rows).cpu().numpy(),
                                    dtype=np.float32)
        with self._state_lock:
            if gen != self._gen.gen + 1:
                raise RuntimeError(
                    f"generation {gen} announced over this rank's "
                    f"generation {self._gen.gen}: the grid is out of step")
            self._announced += 1
            self._pending, self._pending_rows = [rows], rows.shape[0]
            self._staged = None
            self._staged_ready.clear()
        self._work.set()

    def _stage_built(self, seq: int, g) -> None:
        """The builder made ``g`` (a generation or an exception) of
        announcement ``seq``; a later announcement supersedes it."""
        with self._state_lock:
            if seq == self._announced:
                self._staged = g
                self._staged_ready.set()

    def replay_swap(self, gen: int, timeout: float) -> None:
        """Publish the generation rank 0 swapped in, once this rank's
        builder has made it (within ``timeout`` seconds), at the same
        point of the call order, the new rung warmed first as rank 0
        warms it."""
        ready = self._staged_ready.wait(timeout)
        with self._state_lock:
            g = self._staged if ready else None
        if isinstance(g, Exception):
            raise RuntimeError(f"generation {gen} announced for a swap "
                               "failed to build on this rank") from g
        if g is None or g.gen != gen:
            raise RuntimeError(f"generation {gen} announced for a swap was "
                               "not built on this rank")
        self._swap_in(g)
        self._swapped(g, self._rec())

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
