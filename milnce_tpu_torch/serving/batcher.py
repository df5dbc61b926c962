"""Dynamic micro-batcher: request queue -> padded bucket -> per-request
results (port of ``milnce_tpu/serving/batcher.py``, line for line, on the
port's ``obs`` registry and span recorder).

The serving engine (engine.py) only executes fixed, pre-traced batch
shapes (the bucket ladder); individual requests arrive one row at a
time.  This module is the shim between the two worlds: a worker thread
drains a queue, groups rows into a batch, pads the batch to the
smallest bucket that fits, runs it, and scatters per-row results back
to the callers' futures.

Flush policy (both bounds are SLO knobs, SERVING.md):

- **size**: a batch flushes as soon as ``max_batch`` rows are waiting —
  never pads past the top bucket;
- **delay**: a batch flushes at most ``max_delay_ms`` after its FIRST
  row arrived — a lone request never waits longer than the delay bound
  for company.

**Continuous batching** (``continuous=True`` — the vLLM slot-reuse idea
adapted to the fixed bucket ladder, SERVING.md "Continuous batching"):
instead of flush-and-wait, the worker flushes the moment a dispatch
LANE is free — a lone request never pays ``max_delay_ms`` for company
that isn't coming — and while every lane is busy, arrivals accumulate
into the forming batch, filling bucket slots for free (occupancy rises
exactly when the device is the bottleneck).  ``lanes`` is the number of
concurrently-dispatchable batches (1 for a single engine; the replica
count for a pool in pipelined mode); a semaphore bounds in-flight
batches to it.  Deadlines stay prompt: the lane-wait loop expires aged
requests at the same ~2 ms resolution the deadline wake gives the
flush-and-wait path.

Deadline semantics (the request-path analogue of the training side's
decode watchdog, ROBUSTNESS.md): a request may carry a deadline that
bounds its QUEUE WAIT.  A request whose deadline passes before its
batch runs completes with :class:`DeadlineExpired` — an error the
caller sees, never a silent drop — and the worker wakes early at the
nearest pending deadline so expiry is prompt, not discovered at the
next size/delay flush.  A deadline does NOT abort device work already
in flight: once a batch is submitted its rows get their results.

numpy-only on purpose: payloads and results are host arrays; every
device interaction lives behind the injected ``run_batch`` callable.
Thread safety: ``submit`` may be called from any number of threads;
one worker thread owns the flush path; every counter lives on the obs
metrics registry (lock-guarded there), so request threads and the
worker never race an unlocked dict.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from milnce_tpu_torch.analysis.lockrt import make_lock
from milnce_tpu_torch.obs import metrics as obs_metrics
from milnce_tpu_torch.obs import spans as obs_spans

# The worker wakes this soon after the nearest deadline so an expired
# request fails promptly (bounded staleness of the expiry verdict).
_DEADLINE_SLACK_S = 0.002
# Idle poll period: how often the worker re-checks the closed flag when
# the queue is empty (bounds close() latency, costs nothing hot).
_IDLE_POLL_S = 0.05
# Continuous mode's lane-wait tick: bounds both deadline-expiry
# staleness and close() latency while every dispatch lane is busy.
_LANE_POLL_S = 0.002


class DeadlineExpired(RuntimeError):
    """The request's deadline passed while it was still queued.

    ``retry_after_ms`` is the server's retry hint (a fresh, lone request's
    expected queue wait) — the HTTP front surfaces it as a real
    ``Retry-After`` header plus a ``retry_after_ms`` JSON body field
    (SERVING.md "HTTP error contract")."""

    def __init__(self, msg: str, retry_after_ms: float = 0.0):
        super().__init__(msg)
        self.retry_after_ms = float(retry_after_ms)


def pad_rows(rows: np.ndarray, bucket: int) -> np.ndarray:
    """Zero-pad ``(n, ...)`` rows up to ``(bucket, ...)`` on axis 0
    (no-op when already at the bucket).  THE pad rule of the serve path
    — batcher, engine and index all share it so it cannot diverge."""
    n = rows.shape[0]
    if bucket <= n:
        return rows
    pad = np.zeros((bucket - n,) + rows.shape[1:], dtype=rows.dtype)
    return np.concatenate([rows, pad], axis=0)


@dataclass
class _Request:
    payload: np.ndarray
    future: Future
    deadline: Optional[float]        # absolute time.monotonic() seconds


class DynamicBatcher:
    """Queue + worker thread turning single-row submits into bucket-padded
    batch executions.

    - ``run_batch(padded (bucket, ...)) -> (bucket, D)``: the batch
      executor (e.g. ``InferenceEngine.embed_text``).  Row ``i`` of the
      output must correspond to row ``i`` of the input — the pad/unpad
      identity the batcher relies on (pinned by tests).
    - ``bucket_for(n) -> bucket >= n``: the engine's ladder lookup.
    - ``max_batch``: size-flush threshold (== the top bucket).
    - ``max_delay_ms``: delay-flush bound.
    - ``default_timeout_ms``: deadline applied to submits that don't pass
      their own; 0 disables.
    - ``registry``: obs metrics registry the counters/occupancy histogram
      land on (None = a private one, so standalone batchers stay
      isolated; the service passes its registry down so ``GET /metrics``
      sees the request path).
    - ``buckets``: the engine's ladder, used as the occupancy histogram's
      fixed edges (None = powers of two up to ``max_batch``).
    - ``run_batch_async``: optional Future-returning batch executor (e.g.
      ``ReplicaPool.submit_text``).  When set, the worker SUBMITS each
      padded batch and moves on — results scatter to the callers' futures
      from a completion callback — so several batches can be in flight
      across pool replicas at once and one wedged replica never blocks
      the flush loop.  ``run_batch`` is ignored when this is set.
    - ``continuous``: continuous batching (module docstring) — flush the
      instant a lane is free, accumulate while lanes are busy;
      ``max_delay_ms`` is ignored (a lone request never waits for
      company that isn't coming).
    - ``lanes``: concurrently-in-flight batch bound in continuous mode
      (the pool's replica count in pipelined mode, else 1).
    """

    def __init__(self, run_batch: Callable[[np.ndarray], np.ndarray],
                 bucket_for: Callable[[int], int], *, max_batch: int,
                 max_delay_ms: float = 5.0, default_timeout_ms: float = 0.0,
                 name: str = "batcher",
                 registry: Optional[obs_metrics.MetricsRegistry] = None,
                 buckets: Optional[tuple] = None,
                 recorder: Optional[obs_spans.SpanRecorder] = None,
                 on_flush: Optional[Callable[[float, int], None]] = None,
                 run_batch_async: Optional[Callable[[np.ndarray],
                                                    Future]] = None,
                 continuous: bool = False, lanes: int = 1):
        assert max_batch >= 1
        self._run_batch = run_batch
        self._run_batch_async = run_batch_async
        self.continuous = bool(continuous)
        # in-flight batch bound for continuous mode: acquired by the
        # worker before each flush, released when the flush resolves
        # (sync: after run_batch; async: in the completion callback)
        self._lane_sem = (threading.Semaphore(max(1, int(lanes)))
                          if continuous else None)
        # flush-latency observer ``(dur_ms, live_rows) -> None``: the
        # service feeds its EWMA spike detector here (anomaly-triggered
        # profiler capture).  Invoked on the worker thread AFTER the
        # flush resolves, outside every batcher lock (GL012 discipline:
        # the callee takes its own locks)
        self._on_flush = on_flush
        # flush spans go to the injected recorder when the owner (the
        # service) isolates one; None = the process default, resolved at
        # flush time so a later spans.install() is honored
        self._recorder = recorder
        self._bucket_for = bucket_for
        self.max_batch = int(max_batch)
        self.max_delay_s = float(max_delay_ms) / 1000.0
        self.default_timeout_ms = float(default_timeout_ms)
        self.name = name
        self._q: queue.Queue[_Request] = queue.Queue()
        self._closed = threading.Event()
        self.registry = registry if registry is not None \
            else obs_metrics.MetricsRegistry()
        if buckets is None:
            buckets, b = [], 1
            while b < self.max_batch:
                buckets.append(b)
                b *= 2
            buckets.append(self.max_batch)
        lbl = {"batcher": name}
        reg = self.registry
        self._m_requests = reg.counter(
            "milnce_serve_requests_total",
            "rows submitted to the batcher", ("batcher",)).labels(**lbl)
        self._m_flushes = reg.counter(
            "milnce_serve_flushes_total",
            "batches executed", ("batcher",)).labels(**lbl)
        self._m_expired = reg.counter(
            "milnce_serve_deadline_expired_total",
            "requests failed with DeadlineExpired while queued",
            ("batcher",)).labels(**lbl)
        self._m_batch_errors = reg.counter(
            "milnce_serve_batch_errors_total",
            "batch executions that failed (propagated to every caller)",
            ("batcher",)).labels(**lbl)
        self._m_occupancy = reg.histogram(
            "milnce_serve_batch_occupancy",
            "live rows per executed batch (bucket edges = the ladder)",
            buckets=tuple(buckets), labels=("batcher",)).labels(**lbl)
        self._f_bucket_flushes = reg.counter(
            "milnce_serve_bucket_flushes_total",
            "batches executed per padded bucket size",
            ("batcher", "bucket"))
        self._f_bucket_rows = reg.counter(
            "milnce_serve_bucket_rows_total",
            "live rows executed per padded bucket size",
            ("batcher", "bucket"))
        # cached per-bucket child handles (resolved once per bucket on
        # the worker thread).  Children are keyed by label values, so
        # two batchers sharing a registry AND a name read combined
        # totals — isolation is a private registry (the default) or a
        # distinct name, not this cache.  Lock-guarded: the worker
        # inserts on a bucket's first flush while request threads
        # iterate it in stats() (/healthz) — EVERY access, including the
        # worker's own lookup (graftlint GL010: single-writer does not
        # make a lock-free read of a guarded dict safe)
        self._bucket_children: dict[int, tuple] = {}
        self._children_lock = make_lock("serving.batcher.children")
        # rows the continuous worker has dequeued into its FORMING batch
        # (left _q, not yet flushed): depth() must count them or the
        # admission feasibility floor undercounts by up to max_batch
        # while the worker parks on busy lanes
        self._forming = 0                     # guarded-by: _forming_lock
        self._forming_lock = make_lock("serving.batcher.forming")
        # held while one request's rows are queued (submit_many) and while
        # the continuous worker drains the queue, so a drain takes all of
        # a request's rows or none of them
        self._submit_lock = make_lock("serving.batcher.submit")
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name=f"{name}-worker")
        self._worker.start()

    # ---- client side ----------------------------------------------------

    def submit(self, payload: np.ndarray,
               timeout_ms: Optional[float] = None) -> Future:
        """Enqueue one row; returns a Future resolving to its result row.

        ``timeout_ms``: deadline for THIS request (None = the batcher
        default; <= 0 = no deadline)."""
        if self._closed.is_set():
            raise RuntimeError("batcher is closed")
        t_ms = self.default_timeout_ms if timeout_ms is None else timeout_ms
        deadline = (time.monotonic() + t_ms / 1000.0) if t_ms > 0 else None
        fut: Future = Future()
        self._m_requests.inc()
        self._q.put(_Request(np.asarray(payload), fut, deadline))
        if self._closed.is_set():
            # close() raced the put above: the worker may already have
            # drained and exited, so this request would hang forever —
            # sweep the queue from here (idempotent, InvalidStateError-
            # safe) so the future resolves either way
            self._drain_closed()
        return fut

    def submit_many(self, payloads, timeout_ms: Optional[float] = None
                    ) -> list:
        """Enqueue one request's rows together -> a Future each.  The
        continuous worker drains them in one go (up to the top bucket),
        so the timing of the puts never splits a request over two
        flushes: a request's answer does not depend in its last bits on
        when the worker woke."""
        with self._submit_lock:
            return [self.submit(p, timeout_ms) for p in payloads]

    # ---- worker side ----------------------------------------------------

    def _run(self) -> None:
        if self.continuous:
            self._run_continuous()
            return
        while not self._closed.is_set():
            try:
                first = self._q.get(timeout=_IDLE_POLL_S)
            except queue.Empty:
                continue
            batch = [first]
            flush_at = time.monotonic() + self.max_delay_s
            while len(batch) < self.max_batch:
                wake = flush_at
                for r in batch:
                    if r.deadline is not None:
                        wake = min(wake, r.deadline + _DEADLINE_SLACK_S)
                remaining = wake - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    batch.append(self._q.get(timeout=remaining))
                except queue.Empty:
                    break        # woke at flush_at or a pending deadline
            self._flush(batch)
        self._drain_closed()

    def _run_continuous(self) -> None:
        """Continuous batching: flush as soon as a lane is free, fill
        bucket slots from new arrivals while every lane is busy."""
        while not self._closed.is_set():
            try:
                first = self._q.get(timeout=_IDLE_POLL_S)
            except queue.Empty:
                continue
            batch = [first]
            self._drain_into(batch)
            self._set_forming(len(batch))
            got_lane = self._lane_sem.acquire(timeout=_LANE_POLL_S)
            while not got_lane and not self._closed.is_set():
                # parked on busy lanes: expire aged requests promptly
                # and keep topping the forming batch up to the bucket
                batch = self._expire(batch)
                self._drain_into(batch)
                self._set_forming(len(batch))
                got_lane = self._lane_sem.acquire(timeout=_LANE_POLL_S)
            self._set_forming(0)
            if not got_lane:        # closing: fail the collected batch
                for r in batch:
                    self._fail_closed(r)
                break
            self._flush(batch)      # the flush resolution frees the lane
        self._drain_closed()

    def _set_forming(self, n: int) -> None:
        with self._forming_lock:
            self._forming = n

    def _drain_into(self, batch: list) -> None:
        """Move whatever is queued RIGHT NOW into ``batch`` (up to the
        top bucket) without waiting — the continuous-mode accumulator."""
        with self._submit_lock:
            while len(batch) < self.max_batch:
                try:
                    batch.append(self._q.get_nowait())
                except queue.Empty:
                    return

    def _release_lane(self) -> None:
        if self._lane_sem is not None:
            self._lane_sem.release()

    def _expire(self, batch: list) -> list:
        """Fail (promptly) every request in ``batch`` whose deadline has
        passed; returns the survivors."""
        now = time.monotonic()
        live, expired = [], 0
        for r in batch:
            if r.deadline is not None and r.deadline < now:
                r.future.set_exception(DeadlineExpired(
                    f"deadline exceeded by {self._past_ms(r, now):.1f} ms "
                    "while queued (request was never batched)",
                    retry_after_ms=self.max_delay_s * 1e3))
                expired += 1
            else:
                live.append(r)
        if expired:
            self._m_expired.inc(expired)
        return live

    def _flush(self, batch: list[_Request]) -> None:
        live = self._expire(batch)
        if not live:
            self._release_lane()
            return
        n = len(live)
        try:
            # the whole batch computation is inside the try: a bad
            # payload (mixed row shapes -> np.stack raises) must fail
            # THIS batch's futures, never kill the worker thread — a
            # dead worker would strand every later submit forever
            bucket = self._bucket_for(n)
            rows = pad_rows(np.stack([r.payload for r in live]), bucket)
            if self._run_batch_async is not None:
                # pipelined mode: submit and move on — the pool resolves
                # the batch on its own worker and the completion callback
                # scatters results, so the NEXT batch can flush (to
                # another replica) while this one is still in flight
                t0 = time.monotonic()
                fut = self._run_batch_async(rows)
                fut.add_done_callback(
                    lambda f: self._complete(f, live, bucket, n, t0))
                return
            rec = self._recorder if self._recorder is not None \
                else obs_spans.get_recorder()
            with rec.span("batcher.flush", batcher=self.name,
                          bucket=bucket, rows=n) as flush_span:
                out = np.asarray(self._run_batch(rows))
        except Exception as exc:
            # batch failure -> every caller sees the error (never a hang)
            self._release_lane()
            for r in live:
                r.future.set_exception(exc)
            self._m_batch_errors.inc()
            return
        self._release_lane()
        for i, r in enumerate(live):
            r.future.set_result(out[i])
        self._account_flush(bucket, n, flush_span["dur_ms"])

    def _complete(self, f: Future, live: list[_Request], bucket: int,
                  n: int, t0: float) -> None:
        """Async-flush completion (runs on the pool's worker thread):
        scatter per-row results / the batch error, then the same
        accounting as a synchronous flush.  The timed record is an
        ``event`` with ``dur_ms`` (a span cannot straddle threads)."""
        self._release_lane()            # frees the lane for the NEXT
        try:                            # batch before scattering results
            out = np.asarray(f.result())
        except Exception as exc:
            for r in live:
                r.future.set_exception(exc)
            self._m_batch_errors.inc()
            return
        for i, r in enumerate(live):
            r.future.set_result(out[i])
        dur_ms = round((time.monotonic() - t0) * 1e3, 4)
        rec = self._recorder if self._recorder is not None \
            else obs_spans.get_recorder()
        rec.event("batcher.flush", batcher=self.name, bucket=bucket,
                  rows=n, dur_ms=dur_ms)
        self._account_flush(bucket, n, dur_ms)

    def _account_flush(self, bucket: int, n: int, dur_ms: float) -> None:
        self._m_flushes.inc()
        self._m_occupancy.observe(n)
        with self._children_lock:
            children = self._bucket_children.get(bucket)
        if children is None:
            # insert: flush path only (worker thread, or the pool worker
            # resolving an async flush).  The label resolution happens
            # OUTSIDE the children lock so it never nests over the
            # registry family lock (lock-order hygiene, GL011); a racing
            # double-insert writes the same label children twice, which
            # is idempotent.
            children = (
                self._f_bucket_flushes.labels(batcher=self.name,
                                              bucket=bucket),
                self._f_bucket_rows.labels(batcher=self.name, bucket=bucket))
            with self._children_lock:
                self._bucket_children[bucket] = children
        children[0].inc()
        children[1].inc(n)
        if self._on_flush is not None:
            self._on_flush(dur_ms, n)

    @staticmethod
    def _past_ms(r: _Request, now: float) -> float:
        return max(0.0, (now - r.deadline) * 1000.0) if r.deadline else 0.0

    @staticmethod
    def _fail_closed(r: _Request) -> None:
        from concurrent.futures import InvalidStateError

        try:
            r.future.set_exception(RuntimeError("batcher closed"))
        except InvalidStateError:
            pass                        # the other drainer got it first

    def _drain_closed(self) -> None:
        """Fail (never drop) anything still queued when the batcher
        closes.  Callable from both the exiting worker and a racing
        ``submit`` thread — double-resolution is tolerated."""
        while True:
            try:
                r = self._q.get_nowait()
            except queue.Empty:
                return
            self._fail_closed(r)

    # ---- lifecycle / observability --------------------------------------

    def close(self, timeout: float = 5.0) -> None:
        self._closed.set()
        self._worker.join(timeout)

    def depth(self) -> int:
        """Requests currently queued (approximate — stdlib qsize) plus
        any rows the continuous worker holds in its forming batch.  The
        admission controller's feasibility input (service.py)."""
        with self._forming_lock:
            forming = self._forming
        return self._q.qsize() + forming

    def stats(self) -> dict:
        """Counters + the batch-occupancy histogram (bucket -> how full
        batches ran) — the number that tells you whether max_delay_ms is
        tuned right for the offered load.  Keys are the pre-registry
        ``/healthz`` contract; the values now READ the registry metrics
        (one source of truth — SERVING.md observability section)."""
        occupancy = {}
        with self._children_lock:
            children = sorted(self._bucket_children.items())
        for b, (fc, rc) in children:
            f, rows = int(fc.value), int(rc.value)
            occupancy[str(b)] = {
                "flushes": f, "rows": rows,
                "mean_fill": (rows / (f * b)) if f else 0.0}
        # flushes read BEFORE requests: each read is atomic but the PAIR
        # is only monotonically consistent in this order (a reader
        # preempted between the two reads then sees requests >= the
        # causal floor of the flush count, never flushes > requests)
        flushes = int(self._m_flushes.value)
        return {
            "requests": int(self._m_requests.value),
            "flushes": flushes,
            "deadline_expired": int(self._m_expired.value),
            "batch_errors": int(self._m_batch_errors.value),
            "occupancy": occupancy,
        }
