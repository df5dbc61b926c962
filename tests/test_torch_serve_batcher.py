"""Port parity, the dynamic micro-batcher (``milnce_tpu_torch/serving/
batcher.py``): every case of ``tests/test_serve_batcher.py`` on the
port's batcher — flush on size and on delay, pad/unpad identity, bucket
selection at boundaries, deadline-expired -> error (never a silent
drop), batch-failure propagation, exact occupancy under racing readers,
continuous batching's lanes and deadlines, the injected span recorder
and the flush observer — and its pad rule against JAX's.  The batcher is
numpy-only host code: a fake ``run_batch`` stands in for the engine.
"""

import threading
import time

import numpy as np
import pytest
import torch

from milnce_tpu_torch.serving.batcher import DeadlineExpired, DynamicBatcher

torch.set_num_threads(1)         # six test workers share the cores

_BUCKETS = (4, 8)


def _bucket_for(n: int) -> int:
    for b in _BUCKETS:
        if n <= b:
            return b
    raise ValueError(n)


class _FakeEngine:
    """Records every padded batch; result row = payload * 2 (so per-row
    identity is checkable through pad/unpad)."""

    def __init__(self, fail=False, delay_s=0.0):
        self.batches: list[np.ndarray] = []
        self.fail = fail
        self.delay_s = delay_s
        self._lock = threading.Lock()

    def __call__(self, rows: np.ndarray) -> np.ndarray:
        if self.delay_s:
            time.sleep(self.delay_s)
        if self.fail:
            raise ValueError("injected batch failure")
        with self._lock:
            self.batches.append(np.array(rows, copy=True))
        return rows * 2.0


def _mk(engine, **kw):
    kw.setdefault("max_batch", _BUCKETS[-1])
    return DynamicBatcher(engine, _bucket_for, **kw)


def _rows(n, w=3):
    return [np.full((w,), float(i), np.float32) for i in range(n)]


def test_flush_on_max_batch_does_not_wait_for_delay():
    eng = _FakeEngine()
    b = _mk(eng, max_batch=4, max_delay_ms=10_000)   # delay flush never fires
    t0 = time.monotonic()
    futs = [b.submit(r) for r in _rows(4)]
    out = [f.result(timeout=5) for f in futs]
    assert time.monotonic() - t0 < 5.0               # well under the 10s delay
    assert len(eng.batches) == 1 and eng.batches[0].shape == (4, 3)
    for i, row in enumerate(out):
        assert np.array_equal(row, np.full((3,), 2.0 * i))
    occ = b.stats()["occupancy"]["4"]
    assert occ == {"flushes": 1, "rows": 4, "mean_fill": 1.0}
    b.close()


def test_flush_on_delay_serves_a_lone_request():
    eng = _FakeEngine()
    b = _mk(eng, max_delay_ms=40)
    t0 = time.monotonic()
    row = b.submit(np.ones((3,), np.float32)).result(timeout=5)
    waited = time.monotonic() - t0
    assert np.array_equal(row, np.full((3,), 2.0))
    assert waited >= 0.03                 # did wait for company...
    assert eng.batches[0].shape == (4, 3)  # ...then padded to the floor bucket
    b.close()


def test_pad_unpad_identity_matches_per_sample_results():
    eng = _FakeEngine()
    b = _mk(eng, max_delay_ms=30)
    futs = [b.submit(r) for r in _rows(3)]
    batched = np.stack([f.result(timeout=5) for f in futs])
    assert np.array_equal(batched, np.stack(_rows(3)) * 2.0)
    # the engine really saw ONE padded bucket, zeros in the pad slots
    (batch,) = eng.batches
    assert batch.shape == (4, 3)
    assert np.array_equal(batch[3], np.zeros((3,)))
    b.close()


@pytest.mark.parametrize("n,bucket", [(1, 4), (4, 4), (5, 8), (8, 8)])
def test_bucket_selection_at_boundaries(n, bucket):
    eng = _FakeEngine()
    b = _mk(eng, max_delay_ms=150)        # plenty to collect all n submits
    futs = [b.submit(r) for r in _rows(n)]
    for f in futs:
        f.result(timeout=5)
    assert len(eng.batches) == 1, "expected one flush for the burst"
    assert eng.batches[0].shape == (bucket, 3)
    b.close()


def test_expired_deadline_is_an_error_not_a_silent_drop():
    eng = _FakeEngine()
    b = _mk(eng, max_delay_ms=10_000)     # only the deadline can end the wait
    fut = b.submit(np.ones((3,), np.float32), timeout_ms=40)
    with pytest.raises(DeadlineExpired):
        fut.result(timeout=5)             # resolves promptly, NOT after 10s
    assert b.stats()["deadline_expired"] == 1
    assert eng.batches == []              # never reached the engine
    b.close()


def test_live_requests_survive_a_neighbors_expiry():
    eng = _FakeEngine()
    b = _mk(eng, max_delay_ms=10_000)
    doomed = b.submit(np.zeros((3,), np.float32), timeout_ms=40)
    alive = b.submit(np.ones((3,), np.float32))     # no deadline
    with pytest.raises(DeadlineExpired):
        doomed.result(timeout=5)
    assert np.array_equal(alive.result(timeout=5), np.full((3,), 2.0))
    b.close()


def test_mixed_shape_batch_fails_the_batch_not_the_worker():
    """A malformed payload mix (np.stack of unequal row shapes raises
    BEFORE run_batch) must fail that batch's futures and leave the
    worker alive — a dead worker would strand every later request."""
    eng = _FakeEngine()
    b = _mk(eng, max_delay_ms=60)
    f1 = b.submit(np.ones((3,), np.float32))
    f2 = b.submit(np.ones((4,), np.float32))      # width mismatch
    for f in (f1, f2):
        with pytest.raises(ValueError):
            f.result(timeout=5)
    assert b.stats()["batch_errors"] == 1
    # the worker survived: a well-formed request still gets served
    ok = b.submit(np.ones((3,), np.float32)).result(timeout=5)
    assert np.array_equal(ok, np.full((3,), 2.0))
    b.close()


def test_batch_failure_propagates_to_every_caller():
    b = _mk(_FakeEngine(fail=True), max_delay_ms=20)
    futs = [b.submit(r) for r in _rows(2)]
    for f in futs:
        with pytest.raises(ValueError, match="injected batch failure"):
            f.result(timeout=5)
    assert b.stats()["batch_errors"] == 1
    b.close()


def test_default_timeout_applies_when_submit_passes_none():
    b = _mk(_FakeEngine(), max_delay_ms=10_000, default_timeout_ms=40)
    with pytest.raises(DeadlineExpired):
        b.submit(np.ones((3,), np.float32)).result(timeout=5)
    b.close()


def test_explicit_zero_timeout_disables_the_default_deadline():
    # default deadline (20ms) < delay flush (60ms): a request that kept
    # the default would expire; timeout_ms=0 opts out and gets served
    b = _mk(_FakeEngine(), max_delay_ms=60, default_timeout_ms=20)
    fut = b.submit(np.ones((3,), np.float32), timeout_ms=0)
    assert np.array_equal(fut.result(timeout=5), np.full((3,), 2.0))
    b.close()


def test_submit_after_close_raises():
    b = _mk(_FakeEngine())
    b.close()
    with pytest.raises(RuntimeError, match="closed"):
        b.submit(np.ones((3,), np.float32))


def test_stats_shape():
    eng = _FakeEngine()
    b = _mk(eng, max_delay_ms=20)
    b.submit(np.ones((3,), np.float32)).result(timeout=5)
    s = b.stats()
    assert s["requests"] == 1 and s["flushes"] == 1
    assert s["deadline_expired"] == 0 and s["batch_errors"] == 0
    assert s["occupancy"]["4"]["mean_fill"] == pytest.approx(0.25)
    b.close()

def test_stats_readers_race_flushes_with_exact_final_occupancy():
    """Regression: the worker's per-bucket children lookup once ran
    OUTSIDE the children lock while stats() iterated under it
    (graftlint GL010) — hammer stats() from readers during a stream of
    flushes; final occupancy totals must be exact."""
    eng = _FakeEngine()
    b = _mk(eng, max_delay_ms=1)
    stop = threading.Event()
    errors = []

    def reader():
        try:
            while not stop.is_set():
                s = b.stats()
                # mid-race sanity only: counters are monotonic and the
                # occupancy dict never tears (exactness is pinned on
                # the quiesced state below; the flushes/rows PAIR is
                # deliberately not atomic across two counters)
                assert s["requests"] >= s["flushes"] >= 0
                for occ in s["occupancy"].values():
                    assert occ["rows"] >= 0 and occ["flushes"] >= 0
        except Exception as exc:  # pragma: no cover - surfaced below
            errors.append(exc)

    readers = [threading.Thread(target=reader) for _ in range(3)]
    for t in readers:
        t.start()
    n = 40
    futs = [b.submit(np.full((3,), float(i), np.float32)) for i in range(n)]
    for f in futs:
        f.result(timeout=10)
    stop.set()
    for t in readers:
        t.join(timeout=10)
    b.close()
    assert not errors, errors
    s = b.stats()
    assert s["requests"] == n
    assert sum(occ["rows"] for occ in s["occupancy"].values()) == n
    assert sum(occ["flushes"]
               for occ in s["occupancy"].values()) == s["flushes"]


def test_continuous_lone_request_skips_the_delay_wait():
    """Continuous batching: a lone request flushes the
    moment the lane is free — it never pays max_delay_ms waiting for
    company that isn't coming (the flush-and-wait path's cost)."""
    eng = _FakeEngine()
    b = _mk(eng, max_delay_ms=10_000, continuous=True)
    t0 = time.monotonic()
    row = b.submit(np.ones((3,), np.float32)).result(timeout=5)
    waited = time.monotonic() - t0
    assert np.array_equal(row, np.full((3,), 2.0))
    assert waited < 2.0, f"continuous mode waited {waited:.3f}s"
    b.close()


def test_continuous_accumulates_into_bucket_slots_while_lane_busy():
    """While the single lane executes, arrivals accumulate into the
    forming batch — occupancy rises exactly when the device is the
    bottleneck (the slot-reuse win over flush-and-wait)."""
    eng = _FakeEngine(delay_s=0.15)
    b = _mk(eng, continuous=True)                    # max_batch 8
    futs = [b.submit(np.full((3,), 0.0, np.float32))]
    time.sleep(0.03)                 # first flush (1 row) is in flight
    futs += [b.submit(np.full((3,), float(i), np.float32))
             for i in range(1, 7)]
    for f in futs:
        f.result(timeout=5)
    b.close()
    sizes = [batch.shape[0] for batch in eng.batches]
    assert sizes == [4, 8], (
        f"expected the 6 lane-busy arrivals to coalesce: {sizes}")


def test_continuous_keeps_one_requests_rows_in_one_flush():
    """``submit_many`` queues a request's rows together: the continuous
    worker, its lane free throughout, flushes all 8 rows as one batch
    even when each row's put is slow (without it the worker takes the
    first row and flushes it alone)."""
    eng = _FakeEngine()
    b = _mk(eng, continuous=True)                    # max_batch 8
    put = b._q.put

    def slow_put(item, *args, **kwargs):
        put(item, *args, **kwargs)
        time.sleep(0.01)

    b._q.put = slow_put
    rows = [f.result(timeout=5) for f in b.submit_many(_rows(8))]
    b.close()
    assert [batch.shape[0] for batch in eng.batches] == [8]
    assert np.array_equal(np.stack(rows), np.stack(_rows(8)) * 2.0)


def test_continuous_deadline_expires_promptly_while_lane_busy():
    """Pipelined continuous mode: a request aging out while the worker
    is PARKED on a busy lane fails with DeadlineExpired at the
    lane-wait tick — it never waits for the lane to free first."""
    from concurrent.futures import Future

    slow: list[Future] = []

    def run_async(rows):
        fut: Future = Future()
        slow.append(fut)
        return fut                        # resolved manually, late

    b = _mk(_FakeEngine(), continuous=True, lanes=1,
            run_batch_async=run_async)
    blocker = b.submit(np.ones((3,), np.float32))     # occupies the lane
    deadline = time.monotonic() + 5.0
    while not slow and time.monotonic() < deadline:
        time.sleep(0.005)
    assert slow, "the blocker batch never dispatched"
    doomed = b.submit(np.zeros((3,), np.float32), timeout_ms=60)
    t0 = time.monotonic()
    with pytest.raises(DeadlineExpired):
        doomed.result(timeout=5)
    waited = time.monotonic() - t0
    assert waited < 0.4, (f"expiry took {waited:.3f}s — waited for the "
                          "lane instead of the deadline")
    slow[0].set_result(np.ones((4, 3), np.float32) * 2.0)
    assert np.array_equal(blocker.result(timeout=5), np.full((3,), 2.0))
    assert b.stats()["deadline_expired"] == 1
    b.close()


def test_continuous_async_lanes_bound_inflight_batches():
    """Pipelined continuous mode: at most ``lanes`` batches are ever in
    flight at once (the semaphore), and every batch still resolves."""
    from concurrent.futures import Future

    inflight = {"now": 0, "max": 0}
    lock = threading.Lock()
    pending: list[tuple] = []

    def run_async(rows):
        fut: Future = Future()
        with lock:
            inflight["now"] += 1
            inflight["max"] = max(inflight["max"], inflight["now"])
            pending.append((fut, np.array(rows, copy=True)))
        return fut

    def resolver():
        while not stop.is_set():
            with lock:
                item = pending.pop(0) if pending else None
            if item is None:
                time.sleep(0.005)
                continue
            time.sleep(0.05)                  # the "dispatch"
            fut, rows = item
            with lock:
                inflight["now"] -= 1
            fut.set_result(rows * 2.0)

    stop = threading.Event()
    t = threading.Thread(target=resolver, daemon=True)
    t.start()
    b = _mk(_FakeEngine(), continuous=True, lanes=2,
            run_batch_async=run_async)
    try:
        futs = []
        for burst in range(6):                # 6 bursts of 2 rows
            futs += [b.submit(np.full((3,), float(burst), np.float32))
                     for _ in range(2)]
            time.sleep(0.02)
        out = [f.result(timeout=10) for f in futs]
        assert all(o.shape == (3,) for o in out)
        assert inflight["max"] <= 2, (
            f"{inflight['max']} batches in flight > 2 lanes")
        assert inflight["max"] >= 2, "lanes never actually pipelined"
    finally:
        stop.set()
        b.close()
        t.join(timeout=5)


def test_injected_recorder_receives_flush_spans():
    # an owner that isolates its span stream (recorder=...) must get the
    # flush spans there — not on the process-default recorder, which a
    # co-resident train run can swap out via spans.install()
    from milnce_tpu_torch.obs.spans import SpanRecorder

    rec = SpanRecorder()
    b = _mk(_FakeEngine(), max_delay_ms=20, recorder=rec)
    b.submit(np.ones((3,), np.float32)).result(timeout=5)
    b.close()
    spans = [r for r in rec.tail() if r.get("name") == "batcher.flush"]
    assert len(spans) == 1 and spans[0]["rows"] == 1


def test_on_flush_observer_sees_duration_and_rows():
    """The flush-latency observer (the service's EWMA spike
    detector feed) fires once per successful flush with (dur_ms, rows)
    — and never for a failed batch."""
    seen = []
    eng = _FakeEngine(delay_s=0.02)
    b = _mk(eng, max_delay_ms=10,
            on_flush=lambda dur_ms, rows: seen.append((dur_ms, rows)))
    futs = [b.submit(r) for r in _rows(3)]
    for f in futs:
        f.result(timeout=5)
    b.close()
    assert len(seen) == 1
    dur_ms, rows = seen[0]
    assert rows == 3 and dur_ms >= 20.0 - 1.0   # the engine's delay

    seen.clear()
    bad = _mk(_FakeEngine(fail=True), max_delay_ms=10,
              on_flush=lambda dur_ms, rows: seen.append((dur_ms, rows)))
    fut = bad.submit(np.ones((3,), np.float32))
    with pytest.raises(ValueError, match="injected"):
        fut.result(timeout=5)
    bad.close()
    assert seen == []


@pytest.mark.parametrize("n,bucket", [(3, 3), (3, 4), (1, 8), (5, 4)])
def test_pad_rows_equals_jax(n, bucket):
    from milnce_tpu.serving.batcher import pad_rows as jax_pad_rows
    from milnce_tpu_torch.serving.batcher import pad_rows

    rows = np.arange(n * 6, dtype=np.int32).reshape(n, 2, 3) + 1
    got, want = pad_rows(rows, bucket), jax_pad_rows(rows, bucket)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert got.shape == (max(n, bucket), 2, 3)
