"""Engine replica pool: health-gated routing, hedged dispatch, bounded
per-replica queues — the serving path's failure-isolation substrate
(port of ``milnce_tpu/serving/pool.py``: host-side stdlib over engines,
the same states, routing, counters and events).

Without a pool every request funnels through ONE
:class:`~milnce_tpu_torch.serving.engine.InferenceEngine` behind ONE
dispatch lock: a single wedged dispatch or slow replica stalls the
entire service.  The pool owns N engines — a replica is ONE device in
the port (the port's engine serves on one device; on the CPU every
replica is ``cpu``, as every JAX CPU replica is one virtual device) —
each with its OWN model copy, its OWN dispatch lock
(``serving.replica<i>.dispatch``), its own bounded work queue and
worker thread, and a per-replica health state machine:

::

                 consecutive latency-SLO breaches
        SERVING ─────────────────────────────────> DEGRADED
           ^  ^                                      │   │
           │  │   SLO-ok streak                      │   │
           │  └──────────────────────────────────────┘   │
           │                 consecutive dispatch errors │
           │                 (from EITHER state), or     │
           │                 ReplicaDead instantly       v
           └──────────────────────────────────── QUARANTINED
             background synthetic probe succeeds
             (smallest bucket rung, every probe_interval_s)

- **SERVING**: routable, preferred.
- **DEGRADED**: routable only when no SERVING replica exists; entered
  after ``slo_breaches`` consecutive dispatches slower than ``slo_ms``;
  leaves back to SERVING after the same streak of in-SLO dispatches.
- **QUARANTINED**: never routed.  Entered after ``error_threshold``
  consecutive dispatch errors (immediately on
  :class:`~milnce_tpu_torch.serving.engine.ReplicaDead`).  A background probe
  thread re-runs a synthetic embed at the smallest bucket rung every
  ``probe_interval_s``; one success returns the replica to SERVING
  (a force-killed replica's probes keep failing — it stays quarantined
  for the life of the process).

Request flow (``submit_text``/``submit_video`` → Future):

1. **route**: least-outstanding SERVING replica (DEGRADED only as
   fallback); every routable replica's queue full →
   :class:`PoolSaturated` (the admission controller's 429).  No
   routable replica at all → :class:`PoolUnavailable` (the degradation
   ladder's 503 — service.py answers cache hits and sheds misses).
2. **execute**: the replica worker pops the dispatch and runs it on its
   own engine (own dispatch lock — a sibling's hang is not our hang).
3. **requeue**: a dispatch that ERRORS on a replica is re-submitted to
   a different healthy replica up to ``max_requeues`` times before the
   caller sees the error — one flaky replica does not fail requests
   while healthy capacity remains.
4. **hedge**: a dispatch still unresolved past a configurable latency
   quantile (``hedge_quantile`` over the pool's recent dispatch
   latencies, floored at ``hedge_min_ms``) is re-submitted to a second
   healthy replica; the FIRST result wins and the loser's queue slot is
   reclaimed unexecuted (a queued hedge loser is skipped the moment its
   worker sees the future already resolved).

Everything observable lands on the obs metrics registry (per-replica
state/outstanding/probe-age gauges, quarantine/recovery/requeue/hedge
counters — OBSERVABILITY.md) and the span recorder (``pool.quarantine``
/ ``pool.recover`` / ``pool.hedge`` events); ``pool_stats()`` feeds the
``/healthz`` ``pool`` section.

Thread mesh (SERVING.md "Threading model"): N replica workers, one
probe thread, one hedge monitor, plus every submitting thread (batcher
worker, warmup callers).  All mutable pool/replica health state is
guarded by ``_state_lock``; engine dispatch happens under NO pool lock
(each engine takes its own dispatch lock); metric/recorder calls happen
outside ``_state_lock`` (lock-order hygiene, GL011/GL012).
"""

from __future__ import annotations

import copy
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError
from typing import Callable, Optional, Sequence

import numpy as np

from milnce_tpu_torch.analysis.lockrt import make_lock
from milnce_tpu_torch.obs import metrics as obs_metrics
from milnce_tpu_torch.obs import spans as obs_spans
from milnce_tpu_torch.serving.engine import InferenceEngine, ReplicaDead

SERVING = "SERVING"
DEGRADED = "DEGRADED"
QUARANTINED = "QUARANTINED"
STATE_NUM = {SERVING: 0, DEGRADED: 1, QUARANTINED: 2}

# Replica classes (heterogeneous pools, ROADMAP item 5): the default
# full-precision tier and the edge tier (int8-quantized or distilled-
# student engines built from a quantized/student export).  Class names
# are plain strings — these two are the conventions the service and
# serve_bench speak.
F32_CLASS = "f32"
EDGE_CLASS = "edge"

# Worker idle poll (bounds close() latency) and the hedge monitor's
# minimum resolution; latency samples kept for the hedge quantile.
_IDLE_POLL_S = 0.05
_LATENCY_WINDOW = 256
_MIN_HEDGE_SAMPLES = 16


class PoolUnavailable(RuntimeError):
    """No replica can take traffic (all quarantined/dead).  The
    degradation ladder's trigger: the service answers cache hits and
    turns misses into structured 503s (SERVING.md "HTTP error
    contract")."""

    def __init__(self, msg: str, reason: str = "no_healthy_replicas"):
        super().__init__(msg)
        self.reason = reason


class PoolSaturated(RuntimeError):
    """Every routable replica's bounded work queue is full — overload,
    not failure.  Surfaced as HTTP 429 with ``retry_after_ms``."""

    def __init__(self, msg: str, retry_after_ms: float = 0.0):
        super().__init__(msg)
        self.retry_after_ms = float(retry_after_ms)


class _Dispatch:
    """One logical batch dispatch: routed to a replica, possibly
    requeued after an error or hedged onto a second replica.  The future
    resolves exactly once (first result wins).  ``attempts``/``hedged``
    are guarded by the pool's ``_state_lock``."""

    __slots__ = ("entry", "rows", "future", "t0", "attempts", "hedged",
                 "primary_rid", "cls")

    def __init__(self, entry: str, rows: np.ndarray,
                 cls: Optional[str] = None):
        self.entry = entry
        self.rows = rows
        self.cls = cls              # replica-class pin (None = any)
        self.future: Future = Future()
        self.t0 = time.monotonic()
        # attempts/hedged/primary_rid are only touched under the owning
        # pool's _state_lock (the pool, not this record, is the
        # thread-shared object)
        self.attempts = 0
        self.hedged = False
        self.primary_rid = -1


class Replica:
    """One engine + bounded queue + health bookkeeping.  Every mutable
    field is guarded by the OWNING pool's ``_state_lock`` (the replica
    itself holds no lock — state transitions and routing must see one
    consistent snapshot across all replicas)."""

    def __init__(self, rid: int, engine, queue_depth: int,
                 cls: str = F32_CLASS):
        self.rid = rid
        self.engine = engine
        self.cls = cls              # replica class, immutable after build
        self.queue: queue.Queue[_Dispatch] = queue.Queue(maxsize=queue_depth)
        # ---- everything below: guarded-by the pool's _state_lock ----
        self.state = SERVING
        self.consecutive_errors = 0
        self.slo_breach_streak = 0
        self.slo_ok_streak = 0
        self.outstanding = 0        # queued + executing dispatches
        self.dispatches = 0
        self.errors = 0
        self.last_probe: Optional[float] = None   # monotonic


class ReplicaPool:
    """N engine replicas behind health-gated, load-aware routing.

    Duck-types the single-engine surface the service/batcher consume
    (``embed_text`` / ``embed_video`` / ``bucket_for`` / ``buckets`` /
    ``max_batch`` / ``text_words`` / ``embed_dim`` / ``recompiles`` /
    ``stats``), plus the Future-returning ``submit_text`` /
    ``submit_video`` the batcher's pipelined mode uses.

    ``engines`` may be real :class:`InferenceEngine` replicas
    (:meth:`build` / :meth:`from_export` construct them, one device
    each) or engine-shaped test doubles — the pool only needs the
    embed/bucket surface.
    """

    def __init__(self, engines: Sequence, *, queue_depth: int = 16,
                 error_threshold: int = 3, slo_ms: float = 0.0,
                 slo_breaches: int = 5, probe_interval_s: float = 1.0,
                 hedge_quantile: float = 0.0, hedge_min_ms: float = 20.0,
                 max_requeues: int = 1, classes: Optional[Sequence] = None,
                 registry: Optional[obs_metrics.MetricsRegistry] = None,
                 recorder: Optional[obs_spans.SpanRecorder] = None,
                 on_latency: Optional[Callable[[float, int], None]] = None):
        engines = list(engines)
        if not engines:
            raise ValueError("a replica pool needs at least one engine")
        # Heterogeneous pools: ``classes`` labels each engine with its
        # replica class ('f32' full-precision, 'edge' int8/student, or
        # any caller-defined string).  Routing, requeue and hedging all
        # stay WITHIN a dispatch's requested class; the ladder must
        # still be uniform across classes — a class switch must never
        # change which bucket a batch pads to.
        classes = ([F32_CLASS] * len(engines) if classes is None
                   else [str(c) for c in classes])
        if len(classes) != len(engines):
            raise ValueError(f"{len(classes)} classes for "
                             f"{len(engines)} engines")
        ladders = {tuple(e.buckets) for e in engines}
        if len(ladders) != 1:
            raise ValueError(f"replica bucket ladders diverge: {ladders} — "
                             "every replica must serve the same ladder")
        self.buckets = engines[0].buckets
        self.max_batch = engines[0].max_batch
        self.text_words = engines[0].text_words
        self.error_threshold = int(error_threshold)
        self.slo_ms = float(slo_ms)
        self.slo_breaches = int(slo_breaches)
        self.probe_interval_s = float(probe_interval_s)
        self.hedge_quantile = float(hedge_quantile)
        self.hedge_min_ms = float(hedge_min_ms)
        self.max_requeues = int(max_requeues)
        self.replicas = [Replica(i, e, queue_depth, cls=c)
                         for i, (e, c) in enumerate(zip(engines, classes))]
        self.classes = tuple(classes)
        self._state_lock = make_lock("serving.pool.state")
        self._latencies: deque = deque(maxlen=_LATENCY_WINDOW)  # guarded-by: _state_lock
        self._inflight: set = set()                             # guarded-by: _state_lock
        self._rr = 0                                            # guarded-by: _state_lock
        self._on_latency = on_latency                           # guarded-by: _state_lock
        self._closed = threading.Event()
        self._recorder = recorder
        reg = registry if registry is not None \
            else obs_metrics.MetricsRegistry()
        self.registry = reg
        self._f_state = reg.gauge(
            "milnce_serve_replica_state",
            "per-replica health state (0=SERVING 1=DEGRADED 2=QUARANTINED)",
            ("replica",))
        self._f_outstanding = reg.gauge(
            "milnce_serve_replica_outstanding",
            "dispatches queued or executing per replica", ("replica",))
        self._f_probe_age = reg.gauge(
            "milnce_serve_replica_last_probe_age_seconds",
            "seconds since the replica's last synthetic probe "
            "(-1 = never probed)", ("replica",))
        self._f_quarantined = reg.counter(
            "milnce_serve_pool_quarantined_total",
            "replica transitions into QUARANTINED", ("replica",))
        self._f_recovered = reg.counter(
            "milnce_serve_pool_recovered_total",
            "replica recoveries (probe success -> SERVING)", ("replica",))
        self._f_probes = reg.counter(
            "milnce_serve_pool_probes_total",
            "synthetic probes against quarantined replicas", ("result",))
        self._m_requeued = reg.counter(
            "milnce_serve_pool_requeued_total",
            "dispatches re-submitted to another replica after an error")
        self._m_hedged = reg.counter(
            "milnce_serve_pool_hedged_total",
            "dispatches re-submitted to a second replica past the "
            "hedge latency quantile")
        self._f_hedge_wins = reg.counter(
            "milnce_serve_pool_hedge_wins_total",
            "hedged dispatches by which copy resolved first", ("winner",))
        self._m_saturated = reg.counter(
            "milnce_serve_pool_saturated_total",
            "submissions refused because every routable replica's "
            "queue was full")
        self._m_reclaimed = reg.counter(
            "milnce_serve_pool_reclaimed_total",
            "queue slots reclaimed unexecuted (hedge/requeue loser "
            "already resolved)")
        for r in self.replicas:
            self._f_state.labels(replica=str(r.rid)).bind(
                lambda r=r: float(STATE_NUM[self._replica_state(r)]))
            self._f_outstanding.labels(replica=str(r.rid)).bind(
                lambda r=r: float(self._replica_outstanding(r)))
            self._f_probe_age.labels(replica=str(r.rid)).bind(
                lambda r=r: self._probe_age(r))
        self._workers = [
            threading.Thread(target=self._worker, args=(r,), daemon=True,
                             name=f"pool-replica{r.rid}")
            for r in self.replicas]
        for t in self._workers:
            t.start()
        self._prober = threading.Thread(target=self._probe_loop, daemon=True,
                                        name="pool-prober")
        self._prober.start()
        self._hedger = None
        if self.hedge_quantile > 0.0:
            self._hedger = threading.Thread(target=self._hedge_loop,
                                            daemon=True, name="pool-hedger")
            self._hedger.start()

    # ---- engine-compatible surface ---------------------------------------

    @property
    def embed_dim(self) -> Optional[int]:
        for r in self.replicas:
            if r.engine.embed_dim is not None:
                return r.engine.embed_dim
        return None

    def bucket_for(self, n: int) -> int:
        return self.replicas[0].engine.bucket_for(n)

    def embed_text(self, token_ids: np.ndarray,
                   cls: Optional[str] = None) -> np.ndarray:
        return self.submit_text(token_ids, cls=cls).result()

    def embed_video(self, video_u8: np.ndarray,
                    cls: Optional[str] = None) -> np.ndarray:
        return self.submit_video(video_u8, cls=cls).result()

    def submit_text(self, token_ids: np.ndarray,
                    cls: Optional[str] = None) -> Future:
        return self._submit("text", token_ids, cls=cls)

    def submit_video(self, video_u8: np.ndarray,
                     cls: Optional[str] = None) -> Future:
        return self._submit("video", video_u8, cls=cls)

    def recompiles(self) -> int:
        """Recompiles since warmup summed over SURVIVING (non-dead)
        replicas (0 by construction for the port's engines); -1 when no
        surviving replica reports one."""
        counts = [r.engine.recompiles() for r in self.replicas
                  if not getattr(r.engine, "dead", False)]
        known = [c for c in counts if c >= 0]
        return sum(known) if known else -1

    def stats(self) -> dict:
        """Engine-shaped aggregate (the ``/healthz`` ``engine`` section
        keeps its keys when a pool replaces the single engine): calls
        merged across replicas, recompiles summed over survivors."""
        calls: dict[str, int] = {}
        for r in self.replicas:
            for key, n in r.engine.stats().get("calls", {}).items():
                calls[key] = calls.get(key, 0) + n
        counts: dict[str, int] = {}
        for c in self.classes:
            counts[c] = counts.get(c, 0) + 1
        return {
            "buckets": list(self.buckets),
            "max_batch": self.max_batch,
            "recompiles": self.recompiles(),
            "replicas": len(self.replicas),
            "classes": dict(sorted(counts.items())),
            "calls": dict(sorted(calls.items())),
        }

    # ---- submission / routing --------------------------------------------

    def _submit(self, entry: str, rows: np.ndarray,
                cls: Optional[str] = None) -> Future:
        if self._closed.is_set():
            raise RuntimeError("replica pool is closed")
        if cls is not None and cls not in self.classes:
            raise ValueError(f"no {cls!r} replica class in this pool "
                             f"(classes: {sorted(set(self.classes))})")
        d = _Dispatch(entry, np.asarray(rows), cls=cls)
        targets = self._route(cls=cls)
        rid = self._enqueue(d, targets, primary=True)
        if rid < 0:
            self._m_saturated.inc()
            raise PoolSaturated(
                f"every routable replica's work queue is full "
                f"({len(targets)} routable of {len(self.replicas)})",
                retry_after_ms=self._mean_latency_ms())
        if self._closed.is_set():
            # close() raced the enqueue above: the workers may already
            # have drained and exited, so this dispatch would hang
            # forever — sweep every queue from here (idempotent: the
            # resolve path tolerates double resolution), same defense
            # as DynamicBatcher.submit
            for r in self.replicas:
                self._drain_closed(r)
        return d.future

    def _route(self, exclude: tuple = (),
               cls: Optional[str] = None) -> list:
        """Routable replicas, best-first: SERVING by least outstanding,
        then DEGRADED by least outstanding.  ``cls`` restricts routing
        to one replica class — STRICT: a class-pinned dispatch with no
        routable replica of that class fails PoolUnavailable even if
        another class has capacity (a caller asking for the edge tier
        asked for its precision/latency contract, not any answer).
        Raises PoolUnavailable when nothing is routable."""
        with self._state_lock:
            pool = [r for r in self.replicas
                    if cls is None or r.cls == cls]
            serving = [r for r in pool
                       if r.state == SERVING and r.rid not in exclude]
            degraded = [r for r in pool
                        if r.state == DEGRADED and r.rid not in exclude]
            # least-outstanding first; equal depths rotate round-robin
            # (a fixed tie-break would starve every replica but one at
            # low load, making hedges and probes the only traffic they
            # ever see)
            self._rr += 1
            rr, n = self._rr, len(self.replicas)
            key = lambda r: (r.outstanding, (r.rid - rr) % n)  # noqa: E731
            serving.sort(key=key)
            degraded.sort(key=key)
        if not serving and not degraded:
            scope = (f"class {cls!r} ({len(pool)} replicas)"
                     if cls is not None else f"pool of {len(self.replicas)}")
            raise PoolUnavailable(
                "no SERVING or DEGRADED replica left "
                f"({scope}, exclude={list(exclude)})")
        return serving + degraded

    def _enqueue(self, d: _Dispatch, targets: list,
                 primary: bool = False) -> int:
        """Queue ``d`` on the first target with a free slot; returns the
        replica id, or -1 when every target's bounded queue is full.

        Bookkeeping is registered BEFORE the put (and rolled back on a
        full queue): the instant the worker can see the dispatch, its
        outstanding count, primary marker and in-flight registration
        already exist — registering after the put raced a fast worker
        into resolving (and discarding from ``_inflight``) a dispatch
        the submitter then added back, leaking it there forever."""
        for r in targets:
            with self._state_lock:
                r.outstanding += 1
                if primary:
                    d.primary_rid = r.rid
                    self._inflight.add(d)
            try:
                r.queue.put_nowait(d)
            except queue.Full:
                with self._state_lock:
                    r.outstanding -= 1
                    if primary:
                        self._inflight.discard(d)
                        d.primary_rid = -1
                continue
            return r.rid
        return -1

    # ---- replica workers --------------------------------------------------

    def _worker(self, replica: Replica) -> None:
        while not self._closed.is_set():
            try:
                d = replica.queue.get(timeout=_IDLE_POLL_S)
            except queue.Empty:
                continue
            try:
                self._execute(replica, d)
            except Exception as exc:
                # _execute guards the dispatch itself; this barrier is
                # for the BOOKKEEPING around it (metrics, recorder, the
                # injected on_latency callback).  A raising callback
                # must never kill the lane — a dead worker would strand
                # every queued dispatch while the replica still reads
                # SERVING (the exact failure DynamicBatcher._flush
                # defends against).  Resolve the caller (no-op if the
                # dispatch already resolved) and keep draining.
                self._resolve(d, exc=exc)
        self._drain_closed(replica)

    def _execute(self, replica: Replica, d: _Dispatch) -> None:
        if d.future.done():
            # hedge/requeue loser still queued: reclaim the slot without
            # touching the device
            with self._state_lock:
                replica.outstanding -= 1
            self._m_reclaimed.inc()
            return
        # the dispatch is host-blocking (engine._run copies the result
        # back before returning), so this delta is the replica's latency
        t0 = time.monotonic()
        try:
            fn = (replica.engine.embed_text if d.entry == "text"
                  else replica.engine.embed_video)
            out = fn(d.rows)
        except Exception as exc:
            with self._state_lock:
                replica.outstanding -= 1
            self._record_error(replica, exc)
            self._handle_failure(d, replica, exc)
            return
        dur_s = time.monotonic() - t0
        with self._state_lock:
            replica.outstanding -= 1
            on_latency = self._on_latency
        self._record_success(replica, dur_s)
        won = self._resolve(d, result=out)
        if won and d.hedged:
            winner = "primary" if replica.rid == d.primary_rid else "hedge"
            self._f_hedge_wins.labels(winner=winner).inc()
        if on_latency is not None:
            on_latency(dur_s * 1e3, int(d.rows.shape[0]))

    def _resolve(self, d: _Dispatch, *, result=None, exc=None) -> bool:
        try:
            if exc is not None:
                d.future.set_exception(exc)
            else:
                d.future.set_result(result)
            won = True
        except InvalidStateError:
            won = False                 # the other copy got there first
        with self._state_lock:
            self._inflight.discard(d)
        return won

    def _handle_failure(self, d: _Dispatch, replica: Replica,
                        exc: Exception) -> None:
        """Requeue the dispatch on another healthy replica (bounded),
        else fail the caller with the LAST error — bounded, structured,
        never a hang."""
        with self._state_lock:
            d.attempts += 1
            attempts = d.attempts
        if attempts <= self.max_requeues:
            try:
                targets = self._route(exclude=(replica.rid,), cls=d.cls)
            except PoolUnavailable as unavailable:
                # nobody left to retry on: the caller-facing error is
                # the DEGRADATION signal (the service's cache-only /
                # full-503 ladder keys on it), with the dispatch error
                # chained as the cause
                unavailable.__cause__ = exc
                self._resolve(d, exc=unavailable)
                return
            rid = self._enqueue(d, targets)
            if rid >= 0:
                with self._state_lock:
                    # the requeued copy is a FRESH attempt: restart the
                    # hedge clock and move the primary marker, else the
                    # hedge monitor sees a stale t0 and can immediately
                    # "hedge" onto the very replica now executing it
                    d.t0 = time.monotonic()
                    d.primary_rid = rid
                self._m_requeued.inc()
                self._recorder_event("pool.requeue", replica=replica.rid,
                                     attempts=attempts,
                                     error=type(exc).__name__)
                return
        self._resolve(d, exc=exc)

    def _drain_closed(self, replica: Replica) -> None:
        while True:
            try:
                d = replica.queue.get_nowait()
            except queue.Empty:
                return
            self._resolve(d, exc=RuntimeError("replica pool closed"))

    # ---- health state machine --------------------------------------------

    def _record_success(self, replica: Replica, dur_s: float) -> None:
        transition = None
        with self._state_lock:
            replica.dispatches += 1
            replica.consecutive_errors = 0
            self._latencies.append(dur_s)
            if self.slo_ms > 0:
                if dur_s * 1e3 > self.slo_ms:
                    replica.slo_breach_streak += 1
                    replica.slo_ok_streak = 0
                    if (replica.state == SERVING and
                            replica.slo_breach_streak >= self.slo_breaches):
                        replica.state = DEGRADED
                        replica.slo_breach_streak = 0
                        transition = DEGRADED
                else:
                    replica.slo_ok_streak += 1
                    replica.slo_breach_streak = 0
                    if (replica.state == DEGRADED and
                            replica.slo_ok_streak >= self.slo_breaches):
                        replica.state = SERVING
                        replica.slo_ok_streak = 0
                        transition = SERVING
        if transition == DEGRADED:
            self._recorder_event("pool.degrade", replica=replica.rid,
                                 slo_ms=self.slo_ms)
        elif transition == SERVING:
            self._recorder_event("pool.undegrade", replica=replica.rid)

    def _record_error(self, replica: Replica, exc: Exception) -> None:
        quarantined = False
        with self._state_lock:
            replica.dispatches += 1
            replica.errors += 1
            replica.consecutive_errors += 1
            if replica.state != QUARANTINED and (
                    isinstance(exc, ReplicaDead) or
                    replica.consecutive_errors >= self.error_threshold):
                replica.state = QUARANTINED
                quarantined = True
        if quarantined:
            self._f_quarantined.labels(replica=str(replica.rid)).inc()
            self._recorder_event("pool.quarantine", replica=replica.rid,
                                 error=type(exc).__name__)

    # ---- background probe (quarantine recovery) ---------------------------

    def _probe_loop(self) -> None:
        while not self._closed.wait(self.probe_interval_s):
            for r in self.replicas:
                if self._replica_state(r) == QUARANTINED:
                    self._probe(r)

    def _probe(self, replica: Replica) -> None:
        """Synthetic embed at the smallest bucket rung, through the
        replica's own engine (and its fault sites — an armed
        ``serve.dispatch_raise`` can fail a probe, which just means the
        replica stays quarantined until a clean probe)."""
        try:
            replica.engine.embed_text(
                np.zeros((self.buckets[0], self.text_words), np.int32))
            ok, err = True, ""
        except Exception as exc:
            ok, err = False, type(exc).__name__
        recovered = False
        with self._state_lock:
            replica.last_probe = time.monotonic()
            if ok and replica.state == QUARANTINED:
                replica.state = SERVING
                replica.consecutive_errors = 0
                replica.slo_breach_streak = 0
                replica.slo_ok_streak = 0
                recovered = True
        self._f_probes.labels(result="ok" if ok else "fail").inc()
        if recovered:
            self._f_recovered.labels(replica=str(replica.rid)).inc()
            self._recorder_event("pool.recover", replica=replica.rid)
        elif not ok:
            self._recorder_event("pool.probe_fail", replica=replica.rid,
                                 error=err)

    # ---- hedged dispatch --------------------------------------------------

    def _hedge_threshold_s(self) -> Optional[float]:
        with self._state_lock:
            if len(self._latencies) < _MIN_HEDGE_SAMPLES:
                return None
            lats = sorted(self._latencies)
        q = lats[min(len(lats) - 1,
                     int(self.hedge_quantile * len(lats)))]
        return max(q, self.hedge_min_ms / 1e3)

    def _hedge_loop(self) -> None:
        poll = max(self.hedge_min_ms / 4e3, 0.002)
        while not self._closed.wait(poll):
            thr = self._hedge_threshold_s()
            if thr is None:
                continue
            now = time.monotonic()
            with self._state_lock:
                stale = [d for d in self._inflight
                         if not d.hedged and now - d.t0 > thr
                         and not d.future.done()]
                for d in stale:
                    d.hedged = True    # one hedge attempt per dispatch
            for d in stale:
                self._hedge(d)

    def _hedge(self, d: _Dispatch) -> None:
        try:
            targets = self._route(exclude=(d.primary_rid,), cls=d.cls)
        except PoolUnavailable:
            return                      # nobody to hedge onto
        if self._enqueue(d, targets) >= 0:
            self._m_hedged.inc()
            self._recorder_event("pool.hedge", replica=d.primary_rid,
                                 age_ms=round((time.monotonic() - d.t0) * 1e3,
                                              2))

    # ---- observability / lifecycle ---------------------------------------

    def _replica_state(self, r: Replica) -> str:
        with self._state_lock:
            return r.state

    def _replica_outstanding(self, r: Replica) -> int:
        with self._state_lock:
            return r.outstanding

    def _probe_age(self, r: Replica) -> float:
        with self._state_lock:
            last = r.last_probe
        return -1.0 if last is None else round(time.monotonic() - last, 3)

    def _mean_latency_ms(self) -> float:
        with self._state_lock:
            lats = list(self._latencies)
        return round(sum(lats) / len(lats) * 1e3, 2) if lats else 50.0

    def _recorder_event(self, name: str, **attrs) -> None:
        rec = self._recorder if self._recorder is not None \
            else obs_spans.get_recorder()
        rec.event(name, **attrs)

    def set_on_latency(self, cb: Optional[Callable[[float, int], None]]
                       ) -> None:
        """Per-dispatch latency observer ``(dur_ms, rows)`` — the service
        wires its EWMA flush-latency spike detector here so pool
        dispatches feed the anomaly→capture path like batcher flushes."""
        with self._state_lock:
            self._on_latency = cb

    def counts(self) -> dict:
        """The pool's resilience counters as plain ints (single source:
        the registry metrics) — serve_bench's chaos record reads these."""
        def _fam_total(fam) -> int:
            return int(sum(child.value for _, child in fam.items()))

        return {
            "requeued": int(self._m_requeued.value),
            "hedged": int(self._m_hedged.value),
            "hedge_wins": _fam_total(self._f_hedge_wins),
            "saturated": int(self._m_saturated.value),
            "reclaimed": int(self._m_reclaimed.value),
            "quarantines": _fam_total(self._f_quarantined),
            "recoveries": _fam_total(self._f_recovered),
            "probes": _fam_total(self._f_probes),
        }

    def pool_stats(self) -> dict:
        """The ``/healthz`` ``pool`` section: per-replica state,
        outstanding depth, probe age, error/dispatch counts, plus the
        pool-level resilience counters."""
        now = time.monotonic()
        with self._state_lock:
            reps = [{
                "id": r.rid,
                "class": r.cls,
                "state": r.state,
                "outstanding": r.outstanding,
                "consecutive_errors": r.consecutive_errors,
                "dispatches": r.dispatches,
                "errors": r.errors,
                "last_probe_age_s": (round(now - r.last_probe, 3)
                                     if r.last_probe is not None else None),
            } for r in self.replicas]
        for rep, r in zip(reps, self.replicas):
            rep["dead"] = bool(getattr(r.engine, "dead", False))
            rep["recompiles"] = r.engine.recompiles()
        out = {"replicas": reps}
        out.update(self.counts())
        return out

    def close(self, timeout: float = 5.0) -> None:
        self._closed.set()
        for t in self._workers:
            t.join(timeout)
        self._prober.join(timeout)
        if self._hedger is not None:
            self._hedger.join(timeout)
        for r in self.replicas:
            self._drain_closed(r)

    # ---- construction over devices ---------------------------------------

    @staticmethod
    def partition_devices(devices: Sequence, n_replicas: int) -> list:
        """The device of each of ``n_replicas`` engines: the port's engine
        serves on one device, so a replica is one device.

        ``devices`` is an explicit list, which may name one device more
        than once (several replicas on one card, each with its own model
        copy and dispatch lock), or None for every visible CUDA card.  On
        the CPU (every device ``cpu``) the first ``n_replicas`` are taken,
        as JAX does there.  On cards JAX splits the devices into
        ``n_replicas`` even groups, each one engine over a mesh: a split
        that is uneven is refused as in JAX, and one whose groups would
        hold more than one card is refused because a multi-card engine is
        not ported.  Fewer devices than replicas are refused ("a replica
        needs at least one card")."""
        import torch

        if n_replicas < 1:
            raise ValueError(f"n_replicas={n_replicas} < 1")
        if devices is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "replica pool on 'cuda' but no CUDA device is visible "
                    "(pass devices=['cpu'] * n)")
            devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        devices = list(devices)
        if n_replicas > len(devices):
            raise ValueError(f"{n_replicas} replicas > {len(devices)} "
                             "devices — a replica needs at least one card")
        if all(torch.device(d).type == "cpu" for d in devices):
            return devices[:n_replicas]
        if len(devices) % n_replicas:
            raise ValueError(
                f"{len(devices)} devices do not split evenly into "
                f"{n_replicas} replica groups")
        if len(devices) > n_replicas:
            raise ValueError(
                f"{len(devices)} cards over {n_replicas} replicas would make "
                f"groups of {len(devices) // n_replicas} cards: the torch "
                "port's engine serves on one card, so a replica is one card "
                "(a multi-card engine is not ported); serve as many replicas "
                "as cards, or name one card a replica in devices=")
        return devices

    @classmethod
    def _over_devices(cls, specs: Sequence, devices, *, text_words: int,
                      video_shape: Sequence[int], max_batch: int,
                      min_bucket: int, precompile: bool,
                      **pool_kwargs) -> "ReplicaPool":
        """One engine per ``(model, variables, class)`` spec, each on its
        device from :meth:`partition_devices`, over its own copy of the
        model and with its OWN dispatch lock (named ``serving.replica<i>.
        dispatch`` — distinct order classes for the runtime sanitizer)."""
        devs = cls.partition_devices(devices, len(specs))
        engines = [InferenceEngine(
            copy.deepcopy(m), v, device=dev, text_words=text_words,
            video_shape=video_shape, max_batch=max_batch,
            min_bucket=min_bucket, precompile=precompile,
            dispatch_lock=make_lock(f"serving.replica{i}.dispatch"))
            for i, (dev, (m, v, _)) in enumerate(zip(devs, specs))]
        return cls(engines, classes=[c for _, _, c in specs], **pool_kwargs)

    @classmethod
    def build(cls, model, variables, n_replicas: int, *, text_words: int,
              video_shape: Sequence[int], max_batch: int = 64,
              min_bucket: int = 0, devices=None,
              precompile: bool = True, **pool_kwargs) -> "ReplicaPool":
        """``n_replicas`` engines over ``model``, one device each."""
        return cls._over_devices(
            [(model, variables, F32_CLASS)] * n_replicas, devices,
            text_words=text_words, video_shape=video_shape,
            max_batch=max_batch, min_bucket=min_bucket,
            precompile=precompile, **pool_kwargs)

    @classmethod
    def from_export(cls, export_dir: str, n_replicas: int, *,
                    dtype: str = "", max_batch: int = 64,
                    min_bucket: int = 0, devices=None,
                    precompile: bool = True,
                    edge_export_dir: str = "", edge_replicas: int = 0,
                    edge_class: str = EDGE_CLASS,
                    **pool_kwargs) -> "ReplicaPool":
        """Pooled twin of ``InferenceEngine.from_export``: one frozen
        export served by ``n_replicas`` engines, one device each
        (:meth:`partition_devices` over ``devices``, default every CUDA
        card; ``devices=["cpu"] * n`` on the CPU).

        ``edge_export_dir``/``edge_replicas`` add a heterogeneous edge
        tier: that many extra replicas built from a SECOND artifact
        (int8-quantized or distilled-student export — any format the
        engine's loader detects), registered under ``edge_class``.  Both
        artifacts must agree on the serving contract (tokenizer
        max_words, video shape); every replica serves the same ladder."""
        from milnce_tpu_torch.serving.engine import load_serving_model

        model, variables, meta = load_serving_model(export_dir, dtype)
        specs = [(model, variables, F32_CLASS)] * n_replicas
        if edge_export_dir and edge_replicas:
            emodel, evars, emeta = load_serving_model(edge_export_dir)
            if (emeta["tokenizer"]["max_words"]
                    != meta["tokenizer"]["max_words"]
                    or list(emeta["video_shape"])
                    != list(meta["video_shape"])):
                raise ValueError(
                    "edge export disagrees with the f32 export on the "
                    "serving contract: max_words "
                    f"{emeta['tokenizer']['max_words']} vs "
                    f"{meta['tokenizer']['max_words']}, video_shape "
                    f"{emeta['video_shape']} vs {meta['video_shape']}")
            specs += [(emodel, evars, edge_class)] * edge_replicas
        return cls._over_devices(
            specs, devices, text_words=meta["tokenizer"]["max_words"],
            video_shape=meta["video_shape"], max_batch=max_batch,
            min_bucket=min_bucket, precompile=precompile, **pool_kwargs)
