"""Serving front: programmatic retrieval API + stdlib threaded HTTP/JSON
(port of ``milnce_tpu/serving/service.py``: the same endpoints, error
contract, admission controller, tiers and metric names).

Request flow for a text query (the full tentpole path)::

    sentence --tokenizer--> token row --cache?--> hit: cached embedding
                                      \\--miss--> DynamicBatcher (pad to
                                      bucket) --> InferenceEngine.embed_text
    embedding --> DeviceRetrievalIndex.topk --> (scores, corpus indices)

Everything device-side goes through the engine and the index, each
with one explicit copy each way under its dispatch lock (engine.py /
index.py); everything host-side is stdlib + numpy.  The HTTP front is
``http.server.ThreadingHTTPServer`` on purpose: zero new dependencies,
one thread per connection, and the real concurrency story lives in the
batcher anyway — handler threads just block on futures.

Endpoints (JSON in/out):

- ``POST /v1/query``       {"token_ids": [[...]] | "sentences": [...],
                            "k": int?, "timeout_ms": float?, "tier": str?,
                            "replica_class": str?}  ("f32"/"edge" pins the
                           request to one pool replica class — SERVING.md
                           "Edge tier"; omitted = any class)
                           -> {"results": [{"indices": [...],
                                            "scores": [...]}, ...],
                               "index_generation": int?}  (live index
                           only — the freshness stamp)
- ``POST /v1/embed_text``  same inputs -> {"embeddings": [[...], ...]}
- ``POST /v1/index/add``   {"embeddings": [[...]] | "clips": [[...]],
                            "wait": bool?} — live-index ingest: raw
                           clips route through the video embed tower,
                           precomputed embeddings go straight to the
                           pending buffer; ``wait`` blocks until the
                           generation swap publishes the rows
                           (serving/live_index.py; 400 on a frozen
                           index).
- ``GET  /healthz``        resilience-style counters: uptime, request /
                           error / deadline-expired totals, engine
                           recompile count, batch-occupancy histogram,
                           cache hit rate, index size.
- ``GET  /metrics``        Prometheus text exposition of the service's
                           obs registry (request counters, batcher
                           occupancy histogram, cache hit rate,
                           recompile gauge — OBSERVABILITY.md).
- ``GET  /obs/events``     the span recorder's in-memory ring as JSON
                           (``?n=`` limits to the most recent N;
                           ``?since=<mono>`` returns only records
                           appended after that cursor, so pollers stop
                           re-downloading the whole ring).
- ``POST /obs/capture``    arm the bounded one-shot profiler capture
                           (obs/capture.py; 404 without
                           ``--serve.capture_dir``, refusal reasons as
                           JSON — the capture enforces its own
                           one-in-flight/cooldown/budget discipline).

Deadline semantics: ``timeout_ms`` bounds a request's QUEUE wait in the
batcher (ROBUSTNESS.md "Serving request path").  An expired request
fails with HTTP 504 / :class:`~milnce_tpu_torch.serving.batcher.DeadlineExpired`
— never a silent drop.

HTTP error contract (SERVING.md "HTTP error contract"): every refusal
is a STRUCTURED JSON body — ``{"error", "kind", "reason"?,
"retry_after_ms"?}`` — and 429/503/504 responses carry a real
``Retry-After`` header.  504 = this request aged out (DeadlineExpired);
429 = shed at admission (bounded global queue full, deadline provably
infeasible, or every replica queue full — try again later); 503 =
degraded service (no healthy replica; cache hits still answered, misses
refused).  ``/healthz`` and ``/metrics`` NEVER shed — an overloaded
service must stay observable.
"""

from __future__ import annotations

import contextlib
import json
import logging
import math
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from milnce_tpu_torch.analysis.lockrt import make_lock
from milnce_tpu_torch.obs import export as obs_export
from milnce_tpu_torch.obs import metrics as obs_metrics
from milnce_tpu_torch.obs import spans as obs_spans
from milnce_tpu_torch.obs.anomaly import EwmaSpikeDetector
from milnce_tpu_torch.serving.batcher import DeadlineExpired, DynamicBatcher
from milnce_tpu_torch.serving.cache import EmbeddingLRUCache, token_key
from milnce_tpu_torch.serving.pool import PoolSaturated, PoolUnavailable

log = logging.getLogger(__name__)

# Safety margin on future waits past the request deadline: covers device
# execution of an already-submitted batch (a deadline bounds queue wait,
# not in-flight compute), so a wedged device surfaces as an error instead
# of a hung handler thread.
_RESULT_WAIT_SLACK_S = 30.0


class ShedError(RuntimeError):
    """Request refused at ADMISSION (HTTP 429): the bounded global
    queue is full or the deadline is provably infeasible.  Nothing was
    queued — retrying after ``retry_after_ms`` is safe and cheap."""

    def __init__(self, msg: str, reason: str, retry_after_ms: float):
        super().__init__(msg)
        self.reason = reason
        self.retry_after_ms = float(retry_after_ms)


class DegradedError(RuntimeError):
    """Request refused because the service is DEGRADED (HTTP 503): no
    healthy replica can embed.  ``reason`` is machine-readable —
    ``cache_only`` (hits still answered, this request missed) or
    ``no_healthy_replicas`` (cache disabled/cold: full 503)."""

    def __init__(self, msg: str, reason: str, retry_after_ms: float = 1000.0):
        super().__init__(msg)
        self.reason = reason
        self.retry_after_ms = float(retry_after_ms)


def parse_tier_spec(spec: str) -> dict:
    """``serve.tiers`` grammar: ``name:share[,name:share...]`` ->
    ordered ``{name: share}`` — PRIORITY order (first = highest; a
    request naming no tier gets the first one).  ``share`` in (0, 1] is
    the fraction of ``max_inflight`` that tier may occupy: the
    per-tenant SLO-class mechanism — a ``batch:0.5`` backfill tier can
    never hold more than half the admission budget, so the
    ``interactive:1.0`` tier always has headroom (it can't be starved).
    Malformed items and out-of-range shares raise ValueError at config
    time, not as a silently-ignored tier."""
    out: dict[str, float] = {}
    for item in filter(None, (c.strip() for c in spec.split(","))):
        if ":" not in item:
            raise ValueError(f"tier item {item!r} missing ':share' "
                             "(grammar: name:share[,name:share...])")
        name, _, share = item.partition(":")
        name = name.strip()
        if not name or name in out:
            raise ValueError(f"bad/duplicate tier name in {item!r}")
        share_f = float(share)
        if not 0.0 < share_f <= 1.0:
            raise ValueError(f"tier {name!r} share {share_f} outside "
                             "(0, 1]")
        out[name] = share_f
    return out


class AdmissionController:
    """Bounded global queue + deadline-feasibility load shedding.

    Sits in FRONT of the batcher (`embed_text_ids` / `query_ids` admit
    through here; `/healthz` and `/metrics` never do).  Two refusal
    conditions, both HTTP 429 with ``Retry-After``:

    - **overload**: admitted-but-unresolved rows would exceed
      ``max_inflight`` (the bounded global queue; 0 disables);
    - **deadline infeasibility**: the request carries a deadline, and a
      PROVABLE lower bound on its queue wait already exceeds it.  The
      bound is conservative: (batches provably ahead in the queue,
      spread across the pool's dispatch lanes) x the FASTEST dispatch
      ever observed — when it sheds, the request could not have met its
      deadline even on the service's best day, so failing it now (with
      nothing queued) beats failing it later with a 504 after it
      consumed queue space.

    Both refusals require the controller to be ARMED
    (``max_inflight`` > 0 — the config.py contract), and feasibility
    additionally needs latency samples; until the first dispatch
    completes it never sheds on deadline (the bound is unknown, so the
    controller stays conservative in the other direction).  The floor
    must be fed PURE dispatch time: the single-engine service feeds
    batcher flush durations (flush == dispatch there), the pooled
    service feeds the pool's per-dispatch latencies — an async flush's
    submit-to-resolution time includes replica queue wait and would
    inflate the "provable" floor into false 429s.

    **Per-tenant SLO classes** (``tiers`` — :func:`parse_tier_spec`):
    each tier may occupy at most ``share x max_inflight`` admitted rows;
    past it, THAT tier sheds (``tier_overload``, HTTP 429) while
    higher-priority tiers keep admitting into their own headroom — a
    batch backfill job cannot starve interactive traffic.  A request
    naming no tier rides the FIRST (highest-priority) tier; an unknown
    tier is a loud ValueError (HTTP 400), never a silent default."""

    def __init__(self, max_inflight: int, *, max_batch: int, lanes: int = 1,
                 depth_fn=None,
                 registry: Optional[obs_metrics.MetricsRegistry] = None,
                 tiers=None):
        self.max_inflight = int(max_inflight)
        self.max_batch = max(1, int(max_batch))
        self.lanes = max(1, int(lanes))
        self._depth_fn = depth_fn           # batcher queue depth (rows)
        self.tiers = (parse_tier_spec(tiers) if isinstance(tiers, str)
                      else dict(tiers or {}))
        self.default_tier = next(iter(self.tiers), None)
        self._lock = make_lock("serving.admission")
        self._inflight = 0                  # guarded-by: _lock
        self._tier_inflight = {t: 0 for t in self.tiers}  # guarded-by: _lock
        self._flush_floor_ms: Optional[float] = None  # guarded-by: _lock
        self._flush_mean_ms: Optional[float] = None   # guarded-by: _lock
        reg = registry if registry is not None \
            else obs_metrics.MetricsRegistry()
        self._f_shed = reg.counter(
            "milnce_serve_shed_total",
            "requests refused at admission (HTTP 429)", ("reason",))
        reg.gauge("milnce_serve_admission_inflight",
                  "rows admitted and not yet resolved",
                  fn=lambda: float(self.inflight))
        self._f_tier_shed = None
        if self.tiers:
            self._f_tier_shed = reg.counter(
                "milnce_serve_tier_shed_total",
                "admission refusals per SLO tier (HTTP 429)",
                ("tier", "reason"))
            g = reg.gauge("milnce_serve_tier_inflight",
                          "rows admitted and unresolved per SLO tier",
                          ("tier",))
            for name in self.tiers:
                g.labels(tier=name).bind(
                    lambda n=name: float(self.tier_inflight(n)))

    @property
    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    def tier_inflight(self, tier: str) -> int:
        with self._lock:
            return self._tier_inflight.get(tier, 0)

    def tier_cap(self, tier: str) -> int:
        """Rows tier ``tier`` may hold: ``ceil(share * max_inflight)``
        (unbounded while the controller is unarmed)."""
        if self.max_inflight <= 0:
            return 0
        return max(1, math.ceil(self.tiers[tier] * self.max_inflight))

    def observe_flush(self, dur_ms: float, rows: int) -> None:
        """Fed from the batcher's ``on_flush`` hook: tracks the fastest
        flush (the provable floor) and an EWMA (the Retry-After hint)."""
        with self._lock:
            self._flush_floor_ms = dur_ms if self._flush_floor_ms is None \
                else min(self._flush_floor_ms, dur_ms)
            self._flush_mean_ms = dur_ms if self._flush_mean_ms is None \
                else 0.8 * self._flush_mean_ms + 0.2 * dur_ms

    def _shed(self, reason: str, msg: str, retry_after_ms: float,
              tier: Optional[str] = None):
        self._f_shed.labels(reason=reason).inc()
        if tier is not None and self._f_tier_shed is not None:
            self._f_tier_shed.labels(tier=tier, reason=reason).inc()
        raise ShedError(msg, reason, retry_after_ms)

    def resolve_tier(self, tier: Optional[str]) -> Optional[str]:
        """None -> the highest-priority tier; unknown names are a loud
        error (HTTP 400), never a silent default tier."""
        if not self.tiers:
            return None
        if tier is None:
            return self.default_tier
        if tier not in self.tiers:
            raise ValueError(f"unknown SLO tier {tier!r} "
                             f"(tiers: {', '.join(self.tiers)})")
        return tier

    @contextlib.contextmanager
    def admit(self, rows: int, timeout_ms: Optional[float],
              tier: Optional[str] = None):
        """Reserve ``rows`` slots for the duration of the request, or
        refuse with :class:`ShedError` — the refusal happens BEFORE
        anything is queued, so a shed request costs nothing downstream
        and can never hang."""
        rows = int(rows)
        tier = self.resolve_tier(tier)
        shed = None
        with self._lock:
            if (self.max_inflight > 0
                    and self._inflight + rows > self.max_inflight):
                hint = self._flush_mean_ms or 100.0
                shed = ("overload",
                        f"{self._inflight} rows in flight + {rows} would "
                        f"exceed max_inflight={self.max_inflight}", hint)
            elif (tier is not None and self.max_inflight > 0
                    and self._tier_inflight[tier] + rows
                    > self.tier_cap(tier)):
                hint = self._flush_mean_ms or 100.0
                shed = ("tier_overload",
                        f"tier {tier!r} holds "
                        f"{self._tier_inflight[tier]} rows + {rows} would "
                        f"exceed its share cap {self.tier_cap(tier)} "
                        f"(share {self.tiers[tier]:g} of "
                        f"max_inflight={self.max_inflight})", hint)
            elif self.max_inflight > 0 and timeout_ms and timeout_ms > 0 \
                    and self._flush_floor_ms is not None \
                    and self._depth_fn is not None:
                batches_ahead = math.ceil(self._depth_fn() / self.max_batch)
                floor_ms = (batches_ahead / self.lanes) \
                    * self._flush_floor_ms
                if floor_ms > float(timeout_ms):
                    shed = ("deadline_infeasible",
                            f"deadline {timeout_ms:.0f} ms < provable "
                            f"queue-wait floor {floor_ms:.0f} ms "
                            f"({batches_ahead} batches ahead)", floor_ms)
            if shed is None:
                self._inflight += rows
                if tier is not None:
                    self._tier_inflight[tier] += rows
        if shed is not None:
            self._shed(*shed, tier=tier)
        try:
            yield
        finally:
            with self._lock:
                self._inflight -= rows
                if tier is not None:
                    self._tier_inflight[tier] -= rows

    def stats(self) -> dict:
        with self._lock:
            inflight = self._inflight
            tier_inflight = dict(self._tier_inflight)
            floor = self._flush_floor_ms
        out = {
            "max_inflight": self.max_inflight,
            "inflight": inflight,
            "flush_floor_ms": floor,
            "shed": {str(labels[0]): int(child.value)
                     for labels, child in self._f_shed.items()},
        }
        if self.tiers:
            tier_shed: dict[str, dict] = {t: {} for t in self.tiers}
            for labels, child in self._f_tier_shed.items():
                tier_shed.setdefault(str(labels[0]), {})[
                    str(labels[1])] = int(child.value)
            out["tiers"] = {
                t: {"share": share,
                    "cap": self.tier_cap(t) if self.max_inflight > 0
                    else None,
                    "inflight": tier_inflight[t],
                    "shed": tier_shed.get(t, {})}
                for t, share in self.tiers.items()}
        return out


class RetrievalService:
    """Programmatic API over engine + batcher + cache + index."""

    def __init__(self, engine, index=None, *, tokenizer=None,
                 cache: Optional[EmbeddingLRUCache] = None,
                 max_delay_ms: float = 5.0, default_timeout_ms: float = 0.0,
                 registry: Optional[obs_metrics.MetricsRegistry] = None,
                 recorder: Optional[obs_spans.SpanRecorder] = None,
                 capture=None, anomaly_ratio: float = 3.0,
                 max_inflight: int = 0, tiers="", continuous: bool = False):
        self.engine = engine
        self.index = index
        self.tokenizer = tokenizer
        self.cache = cache if cache is not None else EmbeddingLRUCache(0)
        # engine may be a single InferenceEngine or a ReplicaPool —
        # the pool adds the Future-returning submit surface (pipelined
        # batcher flushes) and per-replica health (serving/pool.py)
        self._pool = engine if hasattr(engine, "pool_stats") else None
        # Anomaly-triggered profiler capture (obs/anomaly.py + obs/
        # capture.py): an EWMA detector watches per-flush latency (fed
        # by the batcher worker) and — when a capture is injected — arms
        # ONE bounded capture on a spike; POST /obs/capture arms it
        # manually.  None = events only / 404.  An OwnedCapture (what
        # main() builds: torch.profiler stops only on its starting
        # thread) is armed without blocking the batcher's flush.
        self.capture = capture
        self._flush_detector = EwmaSpikeDetector(
            "serve.flush_ms", ratio=anomaly_ratio, recorder=recorder,
            on_anomaly=((lambda v, e: getattr(capture, "arm_async",
                                              capture.arm)(
                reason="flush_spike"))
                        if capture is not None else None))
        # Every counter on the request path lives on ONE obs registry
        # (the old per-component dicts raced request threads against the
        # batcher worker; registry metrics are lock-guarded).  None = a
        # private registry, so multiple services in one process stay
        # isolated; the milnce-serve CLI passes the process-wide
        # ``obs.metrics.registry()``.
        self.registry = registry if registry is not None \
            else obs_metrics.MetricsRegistry()
        # None = the process-default recorder, resolved PER USE (not
        # captured here): a later ``spans.install()`` — e.g. a train run
        # in the same process — must divert this service's spans and the
        # ``/obs/events`` ring together, never split them
        self._recorder = recorder
        # admission controller (the bounded global queue + feasibility
        # shed): max_inflight=0 keeps the overload bound off but the
        # controller still meters in-flight rows for /healthz
        self._admission = AdmissionController(
            max_inflight, max_batch=engine.max_batch,
            lanes=(len(self._pool.replicas) if self._pool is not None else 1),
            depth_fn=lambda: self._batcher.depth(),
            registry=self.registry, tiers=tiers)

        def _on_flush(dur_ms: float, rows: int) -> None:
            # one hook, two consumers: the EWMA spike detector (anomaly
            # -> profiler capture) and — single-engine mode only — the
            # admission feasibility floor (a sync flush IS the dispatch;
            # a pooled async flush spans replica queue wait too, so the
            # pooled floor feeds from the pool's dispatch latencies
            # below instead)
            self._flush_detector.observe(dur_ms, rows=rows)
            if self._pool is None:
                self._admission.observe_flush(dur_ms, rows)

        self._batcher = DynamicBatcher(
            engine.embed_text, engine.bucket_for, max_batch=engine.max_batch,
            max_delay_ms=max_delay_ms, default_timeout_ms=default_timeout_ms,
            name="text", registry=self.registry, buckets=engine.buckets,
            recorder=recorder, on_flush=_on_flush,
            # pooled: submit-and-move-on so batches pipeline across
            # replicas and one wedged replica never blocks the flush loop
            run_batch_async=(self._pool.submit_text
                             if self._pool is not None else None),
            # continuous batching (SERVING.md): one dispatch lane per
            # pool replica; the single-engine path has exactly one
            continuous=continuous,
            lanes=(len(self._pool.replicas)
                   if self._pool is not None else 1))
        if self._pool is not None:
            # the pool's per-dispatch latencies feed the same spike
            # detector (the anomaly->capture path sees replica-level
            # slowness even when batcher queueing hides it) AND the
            # admission feasibility floor (pure execution time — the
            # honest "fastest the service has ever dispatched")
            def _on_dispatch(dur_ms: float, rows: int) -> None:
                self._flush_detector.observe(dur_ms, rows=rows)
                self._admission.observe_flush(dur_ms, rows)

            self._pool.set_on_latency(_on_dispatch)
        self._default_timeout_ms = float(default_timeout_ms)
        self._m_degraded = self.registry.counter(
            "milnce_serve_degraded_total",
            "requests refused in degraded mode (HTTP 503)", ("reason",))
        self._started = time.time()     # wall-clock uptime for /healthz
        reg = self.registry
        self._m_queries = reg.counter(
            "milnce_serve_queries_total", "retrieval queries received")
        self._m_errors = reg.counter(
            "milnce_serve_query_errors_total", "retrieval queries failed")
        # collect-time gauges: values owned by other components, read at
        # scrape/snapshot — never cached stale, never double-counted
        reg.gauge("milnce_serve_uptime_seconds", "seconds since boot",
                  fn=lambda: time.time() - self._started)
        reg.gauge("milnce_serve_engine_recompiles",
                  "(entry, shape) pairs dispatched since the warmup "
                  "sweep that it did not run (0 by construction in the "
                  "torch port; -1 before the warmup)",
                  fn=engine.recompiles)
        reg.gauge("milnce_serve_cache_hits",
                  "text-embedding cache hits",
                  fn=lambda: self.cache.stats()["hits"])
        reg.gauge("milnce_serve_cache_misses",
                  "text-embedding cache misses",
                  fn=lambda: self.cache.stats()["misses"])
        reg.gauge("milnce_serve_cache_hit_rate",
                  "hits / (hits + misses), 0 before traffic",
                  fn=lambda: self.cache.stats()["hit_rate"])
        if index is not None:
            reg.gauge("milnce_serve_index_size", "corpus rows indexed",
                      fn=lambda: self.index.stats()["size"])

    # ---- embedding path --------------------------------------------------

    def embed_text_ids(self, token_ids: np.ndarray,
                       timeout_ms: Optional[float] = None,
                       tier: Optional[str] = None,
                       replica_class: Optional[str] = None) -> np.ndarray:
        """(n, W) int32 -> (n, D): cache hits answered on host, misses
        batched through the engine; results land back in the cache.

        Admission runs FIRST (a shed request touches neither cache nor
        queue); a miss that fails because no replica is healthy becomes
        :class:`DegradedError` — the degradation ladder's cache-only
        tier (an all-hit request still succeeds because it never reaches
        the batcher).  ``tier`` names the request's SLO class when the
        controller has tiers configured (None = highest priority).

        ``replica_class`` pins the request to one pool replica class
        ('f32' / 'edge' — SERVING.md "Edge tier").  Class-pinned
        requests bypass the batcher AND the embedding cache: the
        batcher's queue is class-blind, and cached rows carry no class
        stamp — an edge-tier int8 embedding silently answering a later
        full-precision request would mix tiers.  None (the default)
        batches across every class as usual."""
        rows = np.ascontiguousarray(token_ids, dtype=np.int32)
        if rows.ndim != 2:
            raise ValueError(f"expected (n, W) token ids, got {rows.shape}")
        if replica_class is not None and self._pool is None:
            raise ValueError("replica_class requires a pooled service "
                             "(--serve.replicas > 1 or an edge tier)")
        # admission judges the EFFECTIVE deadline (the batcher applies
        # default_timeout_ms to a None request deadline, so feasibility
        # must see the same number — a raw None would silently disable
        # the check for every default-deadline client)
        eff_timeout_ms = (self._default_timeout_ms if timeout_ms is None
                          else float(timeout_ms))
        with self._admission.admit(rows.shape[0], eff_timeout_ms, tier):
            if replica_class is not None:
                return self._embed_class_pinned(rows, replica_class)
            keys = [token_key(r) for r in rows]
            out: list[Optional[np.ndarray]] = [self.cache.get(k)
                                               for k in keys]
            misses = [i for i, hit in enumerate(out) if hit is None]
            pending = list(zip(misses, self._batcher.submit_many(
                [rows[i] for i in misses], timeout_ms)))
            wait = self._result_wait_s(timeout_ms)
            for i, fut in pending:
                try:
                    row = fut.result(timeout=wait)
                except PoolUnavailable as exc:
                    reason = ("cache_only" if self.cache.capacity > 0
                              else exc.reason)
                    self._m_degraded.labels(reason=reason).inc()
                    raise DegradedError(
                        f"no healthy replica to embed this request "
                        f"({exc}); cache hits are still served",
                        reason) from exc
                self.cache.put(keys[i], row)
                out[i] = row
            return np.stack(out) if out else np.zeros(
                (0, self.engine.embed_dim or 0), np.float32)

    def _embed_class_pinned(self, rows: np.ndarray,
                            replica_class: str) -> np.ndarray:
        """Direct class-pinned dispatch (no batcher, no cache): the pool
        pads each chunk to its bucket; chunks stay within max_batch."""
        top = self.engine.max_batch
        if rows.shape[0] == 0:
            return np.zeros((0, self.engine.embed_dim or 0), np.float32)
        try:
            return np.concatenate(
                [self._pool.embed_text(rows[lo:lo + top],
                                       cls=replica_class)
                 for lo in range(0, rows.shape[0], top)])
        except PoolUnavailable as exc:
            self._m_degraded.labels(reason=exc.reason).inc()
            raise DegradedError(
                f"no healthy {replica_class!r} replica to embed this "
                f"request ({exc})", exc.reason) from exc

    def _result_wait_s(self, timeout_ms: Optional[float]) -> Optional[float]:
        t_ms = (self._default_timeout_ms if timeout_ms is None
                else float(timeout_ms))
        return (t_ms / 1000.0 + _RESULT_WAIT_SLACK_S) if t_ms > 0 else None

    def _encode(self, sentences) -> np.ndarray:
        if self.tokenizer is None:
            raise ValueError("service built without a tokenizer — send "
                             "token_ids instead of sentences")
        return self.tokenizer.encode_batch(sentences,
                                           self.engine.text_words)

    # ---- query path ------------------------------------------------------

    def query_ids_with_gen(self, token_ids: np.ndarray,
                           k: Optional[int] = None,
                           timeout_ms: Optional[float] = None,
                           tier: Optional[str] = None,
                           replica_class: Optional[str] = None
                           ) -> tuple[np.ndarray, np.ndarray,
                                      Optional[int]]:
        """(n, W) token ids -> ((n, k) scores, (n, k) corpus indices,
        index generation).  The generation is the freshness stamp a
        live index answers with (``/v1/query`` surfaces it as
        ``index_generation`` so clients can detect a stale read); a
        frozen index answers None."""
        if self.index is None:
            raise ValueError("service built without a retrieval index")
        k = self.index.k if k is None else int(k)
        if not 1 <= k <= self.index.k:
            raise ValueError(f"k={k} outside [1, index k={self.index.k}]")
        self._m_queries.inc(len(token_ids))
        try:
            emb = self.embed_text_ids(token_ids, timeout_ms, tier,
                                      replica_class)
            if hasattr(self.index, "topk_with_gen"):
                scores, idx, gen = self.index.topk_with_gen(emb)
            else:
                scores, idx = self.index.topk(emb)
                gen = None
        except (ShedError, DegradedError, PoolSaturated, PoolUnavailable):
            raise        # refusals, not failures: counted on their own
        except Exception:
            self._m_errors.inc(len(token_ids))
            raise
        return scores[:, :k], idx[:, :k], gen

    def query_ids(self, token_ids: np.ndarray, k: Optional[int] = None,
                  timeout_ms: Optional[float] = None,
                  tier: Optional[str] = None,
                  replica_class: Optional[str] = None
                  ) -> tuple[np.ndarray, np.ndarray]:
        """(n, W) token ids -> ((n, k) scores, (n, k) corpus indices)."""
        scores, idx, _ = self.query_ids_with_gen(token_ids, k, timeout_ms,
                                                 tier, replica_class)
        return scores, idx

    def query_sentences_with_gen(self, sentences, k: Optional[int] = None,
                                 timeout_ms: Optional[float] = None,
                                 tier: Optional[str] = None,
                                 replica_class: Optional[str] = None):
        return self.query_ids_with_gen(self._encode(sentences), k,
                                       timeout_ms, tier, replica_class)

    def query_sentences(self, sentences, k: Optional[int] = None,
                        timeout_ms: Optional[float] = None,
                        tier: Optional[str] = None,
                        replica_class: Optional[str] = None
                        ) -> tuple[np.ndarray, np.ndarray]:
        return self.query_ids(self._encode(sentences), k, timeout_ms, tier,
                              replica_class)

    # ---- write path (live index ingest) ----------------------------------

    def index_add(self, embeddings=None, clips=None, *, wait: bool = False,
                  timeout_s: float = 30.0) -> dict:
        """Ingest corpus rows into a LIVE index: either precomputed
        ``(n, D)`` embeddings, or raw ``(n, T, H, W, 3)`` uint8 clips
        routed through the SAME video embed tower serving uses (pooled
        when the service is pooled) — served numbers stay eval numbers
        for ingested rows too.  ``wait=True`` blocks until the rows are
        swapped live and reports the published generation."""
        if self.index is None or not hasattr(self.index, "add"):
            raise ValueError("service index is not a live index — boot "
                             "with serving/live_index.py (or "
                             "--serve.live_index) to ingest online")
        if (embeddings is None) == (clips is None):
            raise ValueError("exactly one of 'embeddings' (n, D floats) "
                             "or 'clips' (n, T, H, W, 3 uint8) required")
        if clips is not None:
            rows = np.ascontiguousarray(clips, dtype=np.uint8)
            top = self.engine.max_batch
            emb = np.concatenate(
                [self.engine.embed_video(rows[lo:lo + top])
                 for lo in range(0, rows.shape[0], top)])
        else:
            emb = np.ascontiguousarray(embeddings, dtype=np.float32)
        out = self.index.add(emb)
        out["rows"] = int(emb.shape[0])
        if wait:
            out["live"] = self.index.flush(timeout_s)
            out["generation"] = self.index.generation
            out["size"] = self.index.size
        return out

    # ---- lifecycle / observability --------------------------------------

    def health(self) -> dict:
        """The pre-registry ``/healthz`` contract, keys unchanged —
        every value now reads the obs registry (or a component stats()
        that itself reads the registry)."""
        out = {
            "status": "ok",
            "uptime_s": time.time() - self._started,
            "queries": int(self._m_queries.value),
            "query_errors": int(self._m_errors.value),
            "engine": self.engine.stats(),
            "batcher": self._batcher.stats(),
            "cache": self.cache.stats(),
            "index": self.index.stats() if self.index is not None else None,
            "admission": self._admission.stats(),
        }
        if self._pool is not None:
            # per-replica state / outstanding / last-probe age + the
            # pool resilience counters (additive key — every
            # pre-existing /healthz key above is byte-compatible)
            out["pool"] = self._pool.pool_stats()
        return out

    def metrics_text(self) -> str:
        """Prometheus text exposition of the service registry."""
        return obs_export.to_prometheus(self.registry)

    @property
    def recorder(self) -> obs_spans.SpanRecorder:
        """The recorder ``/obs/events`` serves: the injected one, else
        whatever is CURRENTLY installed as the process default."""
        return self._recorder if self._recorder is not None \
            else obs_spans.get_recorder()

    def close(self) -> None:
        self._batcher.close()


# ---------------------------------------------------------------------------
# HTTP front
# ---------------------------------------------------------------------------

class _Handler(BaseHTTPRequestHandler):
    # set per-server in serve_http
    service: RetrievalService = None        # type: ignore[assignment]

    def log_message(self, fmt, *args):       # route access logs to logging
        log.debug("%s " + fmt, self.address_string(), *args)

    def _reply(self, code: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        self._reply_raw(code, body, "application/json")

    def _reply_raw(self, code: int, body: bytes, content_type: str,
                   retry_after_ms: Optional[float] = None) -> None:
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        if retry_after_ms is not None:
            # Retry-After is whole seconds (RFC 9110); round UP so the
            # client never retries before the hinted wait
            self.send_header("Retry-After",
                             str(max(1, math.ceil(retry_after_ms / 1000.0))))
        self.end_headers()
        self.wfile.write(body)

    def _refuse(self, code: int, kind: str, exc: Exception,
                reason: Optional[str] = None) -> None:
        """The structured refusal contract (SERVING.md): JSON body with
        ``error``/``kind``/``reason``/``retry_after_ms`` + a real
        ``Retry-After`` header — machine-actionable, never a bare
        string or a socket hang."""
        retry_ms = float(getattr(exc, "retry_after_ms", 1000.0)) or 1000.0
        payload = {"error": str(exc), "kind": kind,
                   "retry_after_ms": round(retry_ms, 1)}
        if reason is not None:
            payload["reason"] = reason
        body = json.dumps(payload).encode()
        self._reply_raw(code, body, "application/json",
                        retry_after_ms=retry_ms)

    def do_GET(self) -> None:
        from urllib.parse import parse_qs, urlparse

        url = urlparse(self.path)
        route = url.path.rstrip("/")
        if route in ("/healthz", "/health"):
            self._reply(200, self.service.health())
        elif route == "/metrics":
            self._reply_raw(200, self.service.metrics_text().encode(),
                            obs_export.PROMETHEUS_CONTENT_TYPE)
        elif route == "/obs/events":
            qs = parse_qs(url.query)
            n = qs.get("n", [None])[0]
            try:
                n = int(n) if n else None
            except ValueError:
                self._reply(400, {"error": f"n must be an integer, "
                                           f"got {n!r}"})
                return
            # ?since=<mono>: only records appended after that cursor
            # (the `mono` stamp each record carries) — pollers pass
            # their last-seen value back instead of re-downloading the
            # whole ring
            since = qs.get("since", [None])[0]
            try:
                since = float(since) if since else None
            except ValueError:
                self._reply(400, {"error": f"since must be a number "
                                           f"(a record's mono stamp), "
                                           f"got {since!r}"})
                return
            self._reply(200, {"events":
                              self.service.recorder.tail(n, since=since)})
        else:
            self._reply(404, {"error": f"no route {self.path!r}"})

    def do_POST(self) -> None:
        try:
            length = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(length) or b"{}")
            if self.path == "/v1/query":
                scores, idx, gen = self._dispatch(
                    self.service.query_ids_with_gen,
                    self.service.query_sentences_with_gen, req)
                payload = {"results": [
                    {"indices": row_i.tolist(), "scores": row_s.tolist()}
                    for row_s, row_i in zip(scores, idx)]}
                if gen is not None:
                    # freshness stamp: the live-index generation this
                    # ranking was answered from (SERVING.md "Live index")
                    payload["index_generation"] = int(gen)
                self._reply(200, payload)
            elif self.path == "/v1/embed_text":
                rows = self._token_rows(req)
                emb = self.service.embed_text_ids(
                    rows, req.get("timeout_ms"), req.get("tier"),
                    req.get("replica_class"))
                self._reply(200, {"embeddings": emb.tolist()})
            elif self.path == "/v1/index/add":
                out = self.service.index_add(
                    embeddings=req.get("embeddings"),
                    clips=req.get("clips"),
                    wait=bool(req.get("wait", False)))
                self._reply(200, out)
            elif self.path == "/obs/capture":
                # manual profiler-capture arm; the capture object
                # enforces the one-shot/cooldown budget and reports a
                # refusal reason instead of silently double-capturing
                if self.service.capture is None:
                    self._reply(404, {"error": "no profiler capture "
                                               "configured "
                                               "(--serve.capture_dir)"})
                else:
                    self._reply(200, self.service.capture.arm(
                        reason=str(req.get("reason", "http"))))
            else:
                self._reply(404, {"error": f"no route {self.path!r}"})
        except DeadlineExpired as exc:
            self._refuse(504, "deadline_expired", exc)
        except ShedError as exc:
            self._refuse(429, "shed", exc, reason=exc.reason)
        except PoolSaturated as exc:
            self._refuse(429, "shed", exc, reason="replica_queues_full")
        except DegradedError as exc:
            self._refuse(503, "degraded", exc, reason=exc.reason)
        except PoolUnavailable as exc:
            self._refuse(503, "degraded", exc, reason=exc.reason)
        except (ValueError, KeyError, json.JSONDecodeError) as exc:
            self._reply(400, {"error": str(exc)})
        except Exception as exc:
            log.exception("serving request failed")
            self._reply(500, {"error": f"{type(exc).__name__}: {exc}"})

    def _token_rows(self, req: dict) -> np.ndarray:
        if "token_ids" in req:
            return np.asarray(req["token_ids"], np.int32)
        return self.service._encode(req["sentences"])

    def _dispatch(self, by_ids, by_sentences, req: dict):
        k, t, tier = req.get("k"), req.get("timeout_ms"), req.get("tier")
        cls = req.get("replica_class")
        if "token_ids" in req:
            return by_ids(np.asarray(req["token_ids"], np.int32), k, t,
                          tier, cls)
        if "sentences" in req:
            return by_sentences(req["sentences"], k, t, tier, cls)
        raise ValueError("request needs 'token_ids' or 'sentences'")


def serve_http(service: RetrievalService, host: str = "127.0.0.1",
               port: int = 0) -> ThreadingHTTPServer:
    """Bind a threaded HTTP server (port 0 = ephemeral, for tests); the
    caller owns ``serve_forever`` / ``shutdown``."""
    handler = type("BoundHandler", (_Handler,), {"service": service})
    server = ThreadingHTTPServer((host, port), handler)
    server.daemon_threads = True
    return server


def _device_memory_gauges(reg, cards) -> None:
    """Each card's memory as the caching allocator sees it (a live
    index's rung crossing holds two generations until the old one's last
    query ends), one child a card labelled by it — read at scrape
    time."""
    import torch

    for name, fn, help_ in (
            ("allocated", torch.cuda.memory_allocated,
             "bytes of device memory held by tensors"),
            ("reserved", torch.cuda.memory_reserved,
             "bytes of device memory the caching allocator holds"),
            ("max_reserved", torch.cuda.max_memory_reserved,
             "peak bytes the caching allocator has held")):
        fam = reg.gauge(f"milnce_serve_device_memory_{name}_bytes", help_,
                        labels=("card",))
        for card in dict.fromkeys(cards):
            fam.labels(card=card).bind(
                lambda fn=fn, card=card: float(fn(card)))


def main(argv=None) -> None:
    """``milnce-serve-torch``: HTTP retrieval service over a frozen export
    (either package's), the JAX ``milnce-serve``'s flags.

    Same CLI grammar as the trainer (``--preset`` + ``--serve.*`` /
    ``--parallel.*`` overrides — config.py).  It serves on every visible
    CUDA card, as ``milnce-serve``'s mesh spans every device, unless
    ``--parallel.platform cpu`` (one CPU device), and refuses to start
    without a card otherwise.  With one replica the engine spans every
    card as one group.  Pooled (``--serve.replicas`` > 1 or an edge
    tier): the cards split into one even contiguous group a replica
    (``ReplicaPool.partition_devices``: an uneven split and more
    replicas than cards are refused), every replica one ``cpu`` device on
    the CPU.  The index, frozen or live, shards its rows over every card
    in both modes.  The corpus comes from
    ``--serve.corpus_npz`` (a (N, D) float32 embedding matrix); without
    it the service starts embed-only (query requests 400 until an index
    exists).  SIGTERM/SIGINT shut down gracefully: the live index is
    flushed, then snapshotted to ``--serve.index_snapshot_dir``.

    Over ranks (``torchrun --nproc-per-node W`` or the coordinator knobs,
    as the JAX ``milnce-serve`` joins its processes' mesh): every rank
    joins the group (``parallel/dist.py::initialize_serving``: a CUDA
    rank holds its host's visible cards split evenly by
    ``LOCAL_WORLD_SIZE``, part ``LOCAL_RANK``), and the engine and the
    index, frozen or live, span the grid of W ranks x G devices; every
    rank boots the index from rank 0's snapshot or corpus, sent to it
    (``lockstep.share_boot``), not from its own host's files.  Rank 0
    alone runs the HTTP front, the batchers, the cache and admission;
    every other rank replays rank 0's device calls in order
    (``serving/lockstep.py``) and ignores SIGTERM/SIGINT.  SIGTERM on
    rank 0 flushes the live index, writes the snapshot once, from rank
    0, and ends every rank with exit 0.  A replica pool over a grid is
    refused."""
    import os

    import torch

    from milnce_tpu_torch.config import parse_cli
    from milnce_tpu_torch.data.tokenizer import Tokenizer
    from milnce_tpu_torch.obs import runctx as obs_runctx
    from milnce_tpu_torch.obs.capture import OwnedCapture, ProfilerCapture
    from milnce_tpu_torch.parallel.dist import (broadcast_str,
                                                initialize_serving,
                                                names_a_group)
    from milnce_tpu_torch.serving import lockstep
    from milnce_tpu_torch.serving.engine import InferenceEngine
    from milnce_tpu_torch.serving.export import METADATA_FILE
    from milnce_tpu_torch.serving.index import DeviceRetrievalIndex
    from milnce_tpu_torch.train.loop import resolve_device

    cfg = parse_cli(argv, description="milnce-tpu-torch serving front")
    s = cfg.serve
    if not s.export_dir:
        raise SystemExit("--serve.export_dir is required (a milnce-export "
                         "artifact directory)")
    # the port's device choice: every visible card (the JAX service's
    # mesh over jax.devices()) unless --parallel.platform cpu; 'cuda'
    # without a card raises here, before anything loads
    device = resolve_device(cfg.parallel.platform)
    edge = bool(s.edge_export_dir) and s.edge_replicas > 0
    if s.edge_replicas > 0 and not s.edge_export_dir:
        raise SystemExit("--serve.edge_replicas needs "
                         "--serve.edge_export_dir (the quantized/student "
                         "artifact the edge class serves)")
    if names_a_group(cfg.parallel) and (s.replicas > 1 or edge):
        raise SystemExit("a replica pool over a serving grid (--serve."
                         "replicas > 1 or an edge tier under a process "
                         "group) is not ported: ROADMAP.md Queue A, 'The "
                         "replica pool over a grid'")
    # over ranks, as JAX's main joins its processes before its mesh
    ranks, rank_devices = initialize_serving(cfg.parallel)
    pg = ranks.group
    if pg is not None:
        group = rank_devices
    elif device.type == "cpu":
        group = [device]
    else:
        group = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    if s.replicas > 1 or edge:
        from milnce_tpu_torch.serving.pool import ReplicaPool

        n = s.replicas + (s.edge_replicas if edge else 0)
        engine = ReplicaPool.from_export(
            s.export_dir, s.replicas, dtype=s.dtype,
            max_batch=s.max_batch, min_bucket=s.min_bucket,
            devices=(["cpu"] * n if device.type == "cpu" else None),
            queue_depth=s.replica_queue_depth,
            error_threshold=s.error_threshold, slo_ms=s.slo_ms,
            slo_breaches=s.slo_breaches,
            probe_interval_s=s.probe_interval_s,
            hedge_quantile=s.hedge_quantile, hedge_min_ms=s.hedge_min_ms,
            max_requeues=s.max_requeues,
            edge_export_dir=s.edge_export_dir,
            edge_replicas=s.edge_replicas,
            registry=obs_metrics.registry())
    else:
        engine = InferenceEngine.from_export(
            s.export_dir, device=group, dtype=s.dtype,
            max_batch=s.max_batch, min_bucket=s.min_bucket,
            process_group=pg)
    # sentence requests need a vocab: --serve.token_dict_path wins, else
    # the path the export recorded; with neither, token_ids-only
    with open(os.path.join(s.export_dir, METADATA_FILE)) as fh:
        meta = json.load(fh)
    tok_meta = meta.get("tokenizer", {})
    tokenizer = None
    if s.token_dict_path:
        if not os.path.exists(s.token_dict_path):
            raise SystemExit(f"--serve.token_dict_path "
                             f"{s.token_dict_path!r} does not exist")
        tokenizer = Tokenizer.from_npy(s.token_dict_path,
                                       max_words=engine.text_words)
    else:
        recorded = tok_meta.get("token_dict_path", "")
        if recorded and os.path.exists(recorded):
            tokenizer = Tokenizer.from_npy(recorded,
                                           max_words=engine.text_words)
    snap = s.index_snapshot_dir if s.live_index else ""

    def boot_corpus():
        """(generation, corpus or None) the index boots from: a live
        index's snapshot resumes the ingesting service where it left off
        (generation counter included; --serve.corpus_npz is ignored then
        — the snapshot IS the corpus), else the corpus at generation 0."""
        from milnce_tpu_torch.serving.export import (INDEX_METADATA_FILE,
                                                     load_corpus_snapshot)

        if snap and os.path.exists(os.path.join(snap, INDEX_METADATA_FILE)):
            snap_meta, emb = load_corpus_snapshot(snap)
            return snap_meta["generation"], emb
        if not s.corpus_npz:
            return 0, None
        with np.load(s.corpus_npz) as z:
            if "emb" in z.files:            # the documented contract
                return 0, z["emb"]
            if len(z.files) == 1:
                return 0, z[z.files[0]]
            raise SystemExit(
                f"--serve.corpus_npz {s.corpus_npz!r} holds "
                f"{z.files} — store the corpus under the 'emb' key "
                "(np.savez(..., emb=embeddings)) so the index can't "
                "silently build over the wrong array")

    # over ranks, rank 0 alone decides the boot corpus and every rank
    # boots from its rows and generation: the grid's ranks number their
    # global rows from one geometry, whatever their hosts' files hold
    # (rank 0 alone writes the snapshot)
    generation, corpus = (boot_corpus() if pg is None else
                          lockstep.share_boot(pg, boot_corpus))
    index = None
    if s.live_index:
        from milnce_tpu_torch.serving.live_index import LiveRetrievalIndex

        index = LiveRetrievalIndex(corpus, k=s.topk, dim=engine.embed_dim,
                                   generation=generation,
                                   query_buckets=engine.buckets,
                                   device=group, group=pg,
                                   min_shard_rows=s.index_min_shard_rows,
                                   registry=obs_metrics.registry())
    elif corpus is not None:
        index = DeviceRetrievalIndex(corpus, k=s.topk,
                                     query_buckets=engine.buckets,
                                     device=group, group=pg)
    # run identity for every snapshot/event this process emits: rank 0's
    # run id on every rank, and the group's rank, as JAX passes
    # jax.process_index()
    obs_runctx.set_run_context(
        broadcast_str(obs_runctx.auto_run_id("serve-"), pg), ranks.rank)
    import signal
    import threading

    if ranks.rank:
        # a follower: rank 0's SIGTERM ends it, through close
        signal.signal(signal.SIGTERM, signal.SIG_IGN)
        signal.signal(signal.SIGINT, signal.SIG_IGN)
        print(f"milnce-serve-torch: rank {ranks.rank} of {ranks.world} "
              f"replaying rank 0's calls (devices {group})", flush=True)
        try:
            calls = lockstep.follow(pg, cfg.parallel.group_timeout_s,
                                    engine, index)
        finally:
            if index is not None and hasattr(index, "close"):
                index.close()
        # the group is destroyed after a clean close only: a lost peer
        # may leave it unable to tear down, and the exit frees it anyway
        ranks.close()
        print(f"milnce-serve-torch: rank {ranks.rank} closed after "
              f"{calls} calls", flush=True)
        _exit_grid_rank()
    leader = None
    if pg is not None:
        leader = lockstep.Leader(pg, cfg.parallel.group_timeout_s)
        engine.announce = leader.announce
        if index is not None:
            index.announce = leader.announce
    if device.type == "cuda":
        _device_memory_gauges(obs_metrics.registry(), group)
    capture = None
    if s.capture_dir:
        capture = OwnedCapture(ProfilerCapture(
            s.capture_dir, duration_s=s.capture_ms / 1e3,
            max_captures=s.capture_max))
    service = RetrievalService(
        engine, index, tokenizer=tokenizer,
        cache=EmbeddingLRUCache(s.cache_capacity),
        max_delay_ms=s.max_delay_ms, default_timeout_ms=s.default_timeout_ms,
        registry=obs_metrics.registry(),
        capture=capture, anomaly_ratio=s.anomaly_ratio,
        max_inflight=s.max_inflight, tiers=s.tiers,
        continuous=s.continuous_batching)
    server = serve_http(service, s.host, s.port)

    # graceful shutdown: SIGTERM/SIGINT unwind through the finally below
    # (live-index flush and snapshot, batcher/pool close) instead of
    # killing the process mid-write; shutdown() blocks until
    # serve_forever returns, so it runs OFF the main thread
    def _graceful(signum, frame):
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _graceful)
    signal.signal(signal.SIGINT, _graceful)
    print(f"milnce-serve-torch: listening on http://{s.host}:"
          f"{server.server_address[1]} (devices {group}"
          + (f" on rank 0 of {ranks.world}" if pg is not None else "")
          + ", buckets "
          f"{engine.buckets}, replicas={s.replicas}"
          + (f"+{s.edge_replicas} edge" if edge else "") + ", "
          f"index={'none' if index is None else index.size}, "
          f"tokenizer={'yes' if tokenizer else 'token_ids-only'}; "
          f"Prometheus scrape: /metrics)",
          flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()
        service.close()
        if capture is not None:
            capture.close()
        if s.live_index and index is not None:
            if s.index_snapshot_dir:
                # checkpoint the grown corpus so the next boot resumes
                # the generation instead of re-ingesting from scratch
                if not index.flush(timeout=30.0):
                    st = index.stats()
                    print(f"milnce-serve-torch: WARNING — shutdown flush "
                          f"timed out with {st['pending_rows']} ingested "
                          f"rows unpublished ({st['swap_failures']} swap "
                          f"failures); snapshot covers generation "
                          f"{st['generation']} only", flush=True)
                index.snapshot(s.index_snapshot_dir)
            index.close()
        if hasattr(engine, "pool_stats"):
            engine.close()
        if leader is not None and leader.close():
            ranks.close()
    if pg is not None:
        _exit_grid_rank()


def _exit_grid_rank() -> None:
    """End a grid rank's process after its clean shutdown, skipping the
    interpreter's teardown.  The engine, the index and the metrics
    registry hold the process group past ``destroy_process_group``, and
    gloo's group can abort in its destructor when the interpreter frees
    it at exit ("terminate called without an active exception", a few
    exits in a hundred on the CPU), which would turn a clean SIGTERM into
    a crash.  The output is flushed first; the port registers no atexit
    work."""
    import os
    import sys

    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


if __name__ == "__main__":
    main()
