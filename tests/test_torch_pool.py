"""Port parity, replica pool: ``milnce_tpu_torch/serving/pool.py`` (with
the service's admission controller and HTTP error contract) on every
scenario of ``tests/test_serve_chaos.py``, and the replica-class cases
of ``tests/test_quant.py``, on the CPU.

- Unit chaos over engine-shaped fakes (the JAX file's, verbatim on the
  port's pool): requeue, quarantine and probe recovery, ReplicaDead,
  hedging (first result wins, loser slots reclaimed), saturation, the
  in-flight registry, a raising latency observer, ``pool_stats``.
- Admission and the HTTP error contract (429 / 503 / 504 with
  ``Retry-After``; ``/healthz`` and ``/metrics`` never shed; the degraded
  ladder).
- Real-engine chaos on two port engines (one ``cpu`` device each, own
  dispatch locks): each serving fault site through
  ``InferenceEngine._run``, with identical embeddings before and after;
  and the closed-loop acceptance (``serve.dispatch_raise@%5`` plus a
  replica killed mid-run) driven in process, as ``scripts/serve_bench.py``
  is not ported.
- Replica classes: an f32 and an int8 edge replica from exports; class
  pins strict; the serving contract checked.
- ``partition_devices``: JAX's grouping (one device a replica on the
  CPU, even contiguous groups of cards); more replicas than devices, an
  uneven split, a card that is not there and ``cuda`` without a card are
  refused; a pool of two group engines survives ``serve.replica_dead``.
"""

import copy
import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from milnce_tpu_torch.obs import metrics as obs_metrics
from milnce_tpu_torch.resilience import faults
from milnce_tpu_torch.serving.engine import ReplicaDead
from milnce_tpu_torch.serving.pool import (DEGRADED, QUARANTINED, SERVING,
                                           PoolSaturated, PoolUnavailable,
                                           ReplicaPool)
from milnce_tpu_torch.serving.service import (AdmissionController,
                                              DegradedError,
                                              RetrievalService, ShedError,
                                              serve_http)

torch.set_num_threads(1)         # six test workers share the cores

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_FRAMES, _SIZE, _WORDS = 4, 32, 6


# ---------------------------------------------------------------------------
# engine-shaped fakes (jax-free: the pool only needs the embed surface)
# ---------------------------------------------------------------------------

class FakeEngine:
    """Deterministic engine stand-in: ``embed_*`` is a pure function of
    the rows (so first-result-wins hedging is CHECKABLE for value
    determinism), with injectable delay / scripted failures / death."""

    buckets = (4, 8)
    max_batch = 8
    text_words = 4
    embed_dim = 8

    def __init__(self, delay_s: float = 0.0):
        self.delay_s = delay_s
        self.calls = 0
        self.fail_next = 0           # raise on the next N calls
        self._dead = False
        self._lock = threading.Lock()

    @property
    def dead(self) -> bool:
        return self._dead

    def kill(self) -> None:
        self._dead = True

    def bucket_for(self, n):
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(n)

    def embed_text(self, rows):
        if self._dead:
            raise ReplicaDead("fake replica is dead")
        with self._lock:
            self.calls += 1
            if self.fail_next > 0:
                self.fail_next -= 1
                raise RuntimeError("scripted dispatch failure")
            delay = self.delay_s
        if delay:
            time.sleep(delay)
        rows = np.asarray(rows)
        return np.tile(rows[:, :1].astype(np.float32), (1, self.embed_dim))

    embed_video = embed_text

    def recompiles(self):
        return 0

    def stats(self):
        return {"buckets": list(self.buckets), "max_batch": self.max_batch,
                "recompiles": 0, "dead": self._dead, "calls": {}}


def _fake_pool(n=2, **kwargs):
    engines = [FakeEngine() for _ in range(n)]
    kwargs.setdefault("probe_interval_s", 0.05)
    kwargs.setdefault("registry", obs_metrics.MetricsRegistry())
    return engines, ReplicaPool(engines, **kwargs)


def _rows(n=2, fill=3):
    return np.full((n, 4), fill, np.int32)


def _expected(rows, dim=8):
    return np.tile(np.asarray(rows)[:, :1].astype(np.float32), (1, dim))


# ---------------------------------------------------------------------------
# unit chaos: routing, requeue, quarantine/recovery, hedge, saturation
# ---------------------------------------------------------------------------

class TestPoolUnit:
    def test_requeue_masks_one_flaky_replica(self):
        engines, pool = _fake_pool(2)
        try:
            engines[0].fail_next = engines[1].fail_next = 0
            # whichever replica routes first fails once; the requeue to
            # the sibling must answer the caller
            engines[0].fail_next = 1
            engines[1].fail_next = 0
            out = pool.embed_text(_rows())
            np.testing.assert_array_equal(out, _expected(_rows()))
            # either the flaky replica was routed (requeue fired) or the
            # healthy one was — in both cases the request succeeded; force
            # the flaky path deterministically for the counter:
            engines[0].fail_next = engines[1].fail_next = 1
            with pytest.raises(RuntimeError, match="scripted"):
                # both replicas fail -> requeue exhausts -> caller sees it
                pool.embed_text(_rows())
            assert pool.counts()["requeued"] >= 1
        finally:
            pool.close()

    def test_consecutive_errors_quarantine_then_probe_recovers(self):
        engines, pool = _fake_pool(2, error_threshold=2, max_requeues=0)
        try:
            for e in engines:
                e.fail_next = 10**6
            for _ in range(4):          # 2 consecutive errors per replica
                with pytest.raises(RuntimeError):
                    pool.embed_text(_rows())
            states = {pool._replica_state(r) for r in pool.replicas}
            assert states == {QUARANTINED}
            with pytest.raises(PoolUnavailable):
                pool.embed_text(_rows())
            assert pool.counts()["quarantines"] == 2
            # heal the fakes; the background probe must recover both
            for e in engines:
                with e._lock:
                    e.fail_next = 0
            deadline = time.monotonic() + 5.0
            while time.monotonic() < deadline:
                if all(pool._replica_state(r) == SERVING
                       for r in pool.replicas):
                    break
                time.sleep(0.02)
            assert all(pool._replica_state(r) == SERVING
                       for r in pool.replicas), "probe recovery timed out"
            assert pool.counts()["recoveries"] == 2
            assert pool.counts()["probes"] >= 2
            np.testing.assert_array_equal(pool.embed_text(_rows()),
                                          _expected(_rows()))
        finally:
            pool.close()

    def test_replica_dead_quarantines_immediately_and_probes_keep_failing(
            self):
        engines, pool = _fake_pool(2, error_threshold=5)
        try:
            engines[0].kill()
            engines[1].kill()
            with pytest.raises((ReplicaDead, PoolUnavailable)):
                pool.embed_text(_rows())
            # one dispatch error quarantines a DEAD replica (no
            # threshold wait), and probes never revive it
            time.sleep(0.3)
            dead_states = [pool._replica_state(r) for r in pool.replicas
                           if r.engine.dead]
            assert QUARANTINED in dead_states
            assert pool.counts()["probes"] >= 1
            assert pool.counts()["recoveries"] == 0
        finally:
            pool.close()

    def test_hedge_first_result_wins_is_value_deterministic(self):
        engines, pool = _fake_pool(2, hedge_quantile=0.1, hedge_min_ms=4.0,
                                   probe_interval_s=60.0)
        try:
            rows = _rows()
            for _ in range(20):          # prime the latency window
                pool.embed_text(rows)
            engines[0].delay_s = 0.4     # primary goes slow
            with pool._state_lock:       # force routing onto replica 0
                pool.replicas[1].state = DEGRADED
            t0 = time.monotonic()
            out = pool.embed_text(rows)
            dt = time.monotonic() - t0
            # the hedge (replica 1) answered long before the wedged
            # primary could have, and the value is EXACTLY the function
            # of the rows — whichever copy wins, the answer is the same
            np.testing.assert_array_equal(out, _expected(rows))
            assert dt < 0.3, f"hedge did not win ({dt:.3f}s)"
            counts = pool.counts()
            assert counts["hedged"] == 1
            assert counts["hedge_wins"] == 1
        finally:
            pool.close()

    def test_hedged_loser_queue_slot_is_reclaimed_unexecuted(self):
        engines, pool = _fake_pool(2, hedge_quantile=0.1, hedge_min_ms=4.0,
                                   probe_interval_s=60.0, queue_depth=8)
        try:
            rows = _rows()
            for _ in range(20):
                pool.embed_text(rows)
            calls_before = engines[0].calls + engines[1].calls
            engines[0].delay_s = 0.25
            with pool._state_lock:
                pool.replicas[1].state = DEGRADED
            # A executes on replica 0 (slow); B queues BEHIND it, gets
            # hedged to replica 1, and its stale copy on replica 0 must
            # be skipped when the worker finally reaches it
            fut_a = pool.submit_text(rows)
            fut_b = pool.submit_text(rows)
            np.testing.assert_array_equal(fut_b.result(timeout=5),
                                          _expected(rows))
            np.testing.assert_array_equal(fut_a.result(timeout=5),
                                          _expected(rows))
            deadline = time.monotonic() + 5.0
            while (time.monotonic() < deadline
                   and pool.counts()["reclaimed"] < 1):
                time.sleep(0.02)
            assert pool.counts()["reclaimed"] >= 1
            # the reclaimed copy never executed: 2 logical dispatches,
            # at most 3 executions (A on r0, B's hedge on r1, NOT B on r0)
            assert engines[0].calls + engines[1].calls <= calls_before + 3
        finally:
            pool.close()

    def test_all_queues_full_is_saturated_not_a_hang(self):
        engines, pool = _fake_pool(2, queue_depth=1, probe_interval_s=60.0)
        try:
            for e in engines:
                e.delay_s = 0.5
            futs = []
            t0 = time.monotonic()
            with pytest.raises(PoolSaturated) as exc_info:
                for _ in range(16):      # 2 executing + 2 queued, then boom
                    futs.append(pool.submit_text(_rows()))
            assert time.monotonic() - t0 < 2.0, "saturation must be instant"
            assert exc_info.value.retry_after_ms > 0
            assert pool.counts()["saturated"] >= 1
            for f in futs:               # everything admitted still resolves
                f.result(timeout=10)
        finally:
            pool.close()

    def test_inflight_registry_drains_to_empty(self):
        """Every resolved dispatch must leave the hedge monitor's
        in-flight registry — a submit-vs-worker race that re-added a
        resolved dispatch after its discard leaked it (and its padded
        rows) there forever."""
        _engines, pool = _fake_pool(2)
        try:
            for i in range(20):
                pool.embed_text(_rows(fill=i + 1))
            deadline = time.monotonic() + 2.0
            while time.monotonic() < deadline:
                with pool._state_lock:
                    if not pool._inflight:
                        break
                time.sleep(0.01)
            with pool._state_lock:
                assert not pool._inflight, (
                    f"{len(pool._inflight)} resolved dispatches leaked "
                    "in the in-flight registry")
        finally:
            pool.close()

    def test_raising_latency_observer_does_not_kill_the_worker_lane(self):
        """The service-injected on_latency callback runs on the worker
        thread AFTER the dispatch resolves; if it raises, the lane must
        survive (a dead worker would strand every queued dispatch while
        the replica still reads SERVING)."""
        _engines, pool = _fake_pool(1)
        try:
            def bad_observer(dur_ms, rows):
                raise RuntimeError("observer bug")

            pool.set_on_latency(bad_observer)
            np.testing.assert_array_equal(pool.embed_text(_rows()),
                                          _expected(_rows()))
            # the worker survived the observer's exception: still serving
            np.testing.assert_array_equal(
                pool.embed_text(_rows(fill=5)), _expected(_rows(fill=5)))
            assert pool._replica_state(pool.replicas[0]) == SERVING
        finally:
            pool.close()

    def test_pool_stats_shape(self):
        _engines, pool = _fake_pool(2)
        try:
            pool.embed_text(_rows())
            ps = pool.pool_stats()
            assert len(ps["replicas"]) == 2
            for rep in ps["replicas"]:
                for key in ("id", "state", "outstanding",
                            "consecutive_errors", "dispatches", "errors",
                            "last_probe_age_s", "dead", "recompiles"):
                    assert key in rep, f"pool replica stats missing {key}"
            for key in ("requeued", "hedged", "hedge_wins", "saturated",
                        "quarantines", "recoveries", "probes"):
                assert key in ps
        finally:
            pool.close()


# ---------------------------------------------------------------------------
# admission controller: bounded global queue + deadline feasibility
# ---------------------------------------------------------------------------

class TestAdmission:
    def test_overload_sheds_with_retry_hint(self):
        ac = AdmissionController(4, max_batch=4,
                                 registry=obs_metrics.MetricsRegistry())
        with ac.admit(3, None):
            with pytest.raises(ShedError) as exc_info:
                with ac.admit(2, None):
                    pass
            assert exc_info.value.reason == "overload"
            assert exc_info.value.retry_after_ms > 0
        # slots released on exit: admissible again
        with ac.admit(4, None):
            pass
        assert ac.stats()["shed"] == {"overload": 1}

    def test_deadline_infeasibility_needs_samples_and_is_provable(self):
        depth = [0]
        ac = AdmissionController(1000, max_batch=4, lanes=1,
                                 depth_fn=lambda: depth[0],
                                 registry=obs_metrics.MetricsRegistry())
        depth[0] = 40
        with ac.admit(1, 1.0):       # no flush samples yet: never sheds
            pass
        ac.observe_flush(50.0, 4)    # fastest dispatch ever seen: 50 ms
        with pytest.raises(ShedError) as exc_info:
            with ac.admit(1, 100.0):  # 10 batches ahead -> floor 500 ms
                pass
        assert exc_info.value.reason == "deadline_infeasible"
        assert exc_info.value.retry_after_ms >= 100.0
        with ac.admit(1, 1000.0):    # a feasible deadline passes
            pass
        with ac.admit(1, None):      # no deadline: feasibility can't shed
            pass

    def test_unarmed_controller_never_sheds(self):
        """max_inflight=0 disarms BOTH refusal conditions (the config.py
        contract: max_inflight 'arms the admission controller') — an
        unarmed service must not 429 on feasibility either."""
        depth = [40]
        ac = AdmissionController(0, max_batch=4, lanes=1,
                                 depth_fn=lambda: depth[0],
                                 registry=obs_metrics.MetricsRegistry())
        ac.observe_flush(50.0, 4)
        with ac.admit(1, 100.0):     # would shed if armed
            pass

    def test_admission_judges_the_effective_default_deadline(self):
        """Feasibility must see the deadline the batcher will actually
        apply: a client omitting timeout_ms still gets the service's
        default_timeout_ms judged at admission (a raw None would
        silently disable the check for every default-deadline client)."""
        service = RetrievalService(FakeEngine(), None, max_delay_ms=1.0,
                                   default_timeout_ms=123.0,
                                   registry=obs_metrics.MetricsRegistry())
        try:
            seen = []
            real_admit = service._admission.admit

            def spying_admit(rows, timeout_ms, tier=None):
                seen.append(timeout_ms)
                return real_admit(rows, timeout_ms, tier)

            service._admission.admit = spying_admit
            service.embed_text_ids(_rows(1))
            service.embed_text_ids(_rows(1, fill=4), timeout_ms=77.0)
            assert seen == [123.0, 77.0]
        finally:
            service.close()

    def test_pool_saturated_is_a_refusal_not_a_query_error(self):
        """PoolSaturated reaching the query path is a structured 429
        refusal — it must not inflate the unstructured query_errors
        counter (the error-rate gate's input)."""
        class _SaturatingEngine(FakeEngine):
            def embed_text(self, rows):
                raise PoolSaturated("full", retry_after_ms=5.0)

        class _FakeIndex:
            k = 5

            def topk(self, emb):
                n = emb.shape[0]
                return (np.zeros((n, 5), np.float32),
                        np.zeros((n, 5), np.int64))

            def stats(self):
                return {"size": 1}

        service = RetrievalService(_SaturatingEngine(), _FakeIndex(),
                                   max_delay_ms=1.0,
                                   registry=obs_metrics.MetricsRegistry())
        try:
            with pytest.raises(PoolSaturated):
                service.query_ids(_rows(1))
            assert service.health()["query_errors"] == 0
        finally:
            service.close()

    def test_shed_never_hangs_through_the_service(self):
        slow = FakeEngine(delay_s=1.0)
        service = RetrievalService(slow, None, max_delay_ms=1.0,
                                   registry=obs_metrics.MetricsRegistry(),
                                   max_inflight=1)
        try:
            started = threading.Event()

            def occupy():
                started.set()
                service.embed_text_ids(_rows(1))

            t = threading.Thread(target=occupy, daemon=True)
            t.start()
            started.wait()
            time.sleep(0.1)          # the occupant is admitted + in flight
            t0 = time.monotonic()
            with pytest.raises(ShedError):
                service.embed_text_ids(_rows(1, fill=9))
            assert time.monotonic() - t0 < 0.5, "shed must be instant"
            t.join(timeout=10)
        finally:
            service.close()


# ---------------------------------------------------------------------------
# HTTP error contract: structured bodies + Retry-After on 429/503/504
# ---------------------------------------------------------------------------

def _post(base, route, payload):
    req = urllib.request.Request(
        base + route, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=30)


class TestHTTPErrorContract:
    def test_shed_is_429_with_structured_body_and_header_healthz_never_sheds(
            self):
        slow = FakeEngine(delay_s=1.0)
        service = RetrievalService(slow, None, max_delay_ms=1.0,
                                   registry=obs_metrics.MetricsRegistry(),
                                   max_inflight=1)
        server = serve_http(service, port=0)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        base = f"http://127.0.0.1:{server.server_address[1]}"
        try:
            started = threading.Event()

            def occupy():
                started.set()
                try:
                    _post(base, "/v1/embed_text",
                          {"token_ids": [[1, 1, 1, 1]]})
                except Exception:
                    pass
            t = threading.Thread(target=occupy, daemon=True)
            t.start()
            started.wait()
            time.sleep(0.15)
            with pytest.raises(urllib.error.HTTPError) as exc_info:
                _post(base, "/v1/embed_text", {"token_ids": [[2, 2, 2, 2]]})
            err = exc_info.value
            assert err.code == 429
            body = json.loads(err.read())
            assert body["kind"] == "shed"
            assert body["reason"] == "overload"
            assert body["retry_after_ms"] > 0
            assert int(err.headers["Retry-After"]) >= 1
            # the observability plane NEVER sheds, even right now
            for route in ("/healthz", "/metrics"):
                with urllib.request.urlopen(base + route, timeout=30) as r:
                    assert r.status == 200
            t.join(timeout=10)
        finally:
            server.shutdown()
            server.server_close()
            service.close()

    def test_deadline_expiry_is_504_with_retry_hint(self):
        service = RetrievalService(FakeEngine(), None, max_delay_ms=40.0,
                                   registry=obs_metrics.MetricsRegistry())
        server = serve_http(service, port=0)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        base = f"http://127.0.0.1:{server.server_address[1]}"
        try:
            with pytest.raises(urllib.error.HTTPError) as exc_info:
                _post(base, "/v1/embed_text",
                      {"token_ids": [[3, 3, 3, 3]], "timeout_ms": 1})
            err = exc_info.value
            assert err.code == 504
            body = json.loads(err.read())
            assert body["kind"] == "deadline_expired"
            assert body["retry_after_ms"] > 0
            assert int(err.headers["Retry-After"]) >= 1
        finally:
            server.shutdown()
            server.server_close()
            service.close()

    def test_degraded_ladder_cache_hits_answered_misses_503_then_full_503(
            self):
        engines, pool = _fake_pool(2, probe_interval_s=60.0)
        from milnce_tpu_torch.serving.cache import EmbeddingLRUCache

        service = RetrievalService(pool, None,
                                   cache=EmbeddingLRUCache(64),
                                   max_delay_ms=1.0,
                                   registry=obs_metrics.MetricsRegistry())
        server = serve_http(service, port=0)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        base = f"http://127.0.0.1:{server.server_address[1]}"
        try:
            hot = [[5, 5, 5, 5]]
            with _post(base, "/v1/embed_text", {"token_ids": hot}) as r:
                cached = json.loads(r.read())["embeddings"]
            for e in engines:            # kill the whole pool
                e.kill()
            # drive a dispatch error so both replicas quarantine
            with pytest.raises(urllib.error.HTTPError):
                _post(base, "/v1/embed_text", {"token_ids": [[6, 6, 6, 6]]})
            # cache-only tier: the hot row still answers...
            with _post(base, "/v1/embed_text", {"token_ids": hot}) as r:
                assert json.loads(r.read())["embeddings"] == cached
            # ...a miss is a STRUCTURED 503
            with pytest.raises(urllib.error.HTTPError) as exc_info:
                _post(base, "/v1/embed_text", {"token_ids": [[7, 7, 7, 7]]})
            err = exc_info.value
            assert err.code == 503
            body = json.loads(err.read())
            assert body["kind"] == "degraded"
            assert body["reason"] in ("cache_only", "no_healthy_replicas")
            assert int(err.headers["Retry-After"]) >= 1
            # /healthz stays up and surfaces the pool section
            with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
                h = json.loads(r.read())
            assert "pool" in h and len(h["pool"]["replicas"]) == 2
            assert {rep["state"] for rep in h["pool"]["replicas"]} \
                == {QUARANTINED}
            assert h["admission"]["max_inflight"] == 0
        finally:
            server.shutdown()
            server.server_close()
            service.close()
            pool.close()


# ---------------------------------------------------------------------------
# fault-site grammar
# ---------------------------------------------------------------------------

def test_serving_fault_sites_parse_and_unknown_still_rejected():
    spec = faults.parse_spec(
        "serve.dispatch_raise@%5;serve.dispatch_hang@1:x=0.5;"
        "serve.replica_dead@3")
    assert set(spec) == {"serve.dispatch_raise", "serve.dispatch_hang",
                         "serve.replica_dead"}
    assert spec["serve.dispatch_hang"].x == 0.5
    with pytest.raises(ValueError, match="unknown fault site"):
        faults.parse_spec("serve.typo@*")




# ---------------------------------------------------------------------------
# real-engine chaos: the fault sites through the port's InferenceEngine._run
# on a 2-replica pool (one cpu device each, own dispatch locks)
# ---------------------------------------------------------------------------

_MODEL = dict(embedding_dim=16, vocab_size=64, word_embedding_dim=8,
              text_hidden_dim=16, inception_blocks=1)
_VIDEO = (_FRAMES, _SIZE, _SIZE, 3)


def _model():
    from milnce_tpu_torch.config import ModelConfig
    from milnce_tpu_torch.models.build import build_model

    return build_model(ModelConfig(**_MODEL), seed=0)


@pytest.fixture(scope="module")
def real_stack():
    model = _model()
    pool = ReplicaPool.build(
        model, None, 2, text_words=_WORDS, video_shape=_VIDEO, max_batch=8,
        min_bucket=4, devices=["cpu"] * 2, probe_interval_s=0.2,
        error_threshold=2, registry=obs_metrics.MetricsRegistry())
    yield dict(model=model, pool=pool)
    pool.close()


class TestRealEngineChaos:
    def _ids(self, n=4, seed=0):
        return np.random.default_rng(seed).integers(
            1, 64, (n, _WORDS)).astype(np.int32)

    def test_replicas_are_separate_copies_with_own_locks(self, real_stack):
        pool = real_stack["pool"]
        a, b = (r.engine for r in pool.replicas)
        assert a.model is not b.model
        assert a._dispatch_lock is not b._dispatch_lock
        assert {e.device.type for e in (a, b)} == {"cpu"}

    def test_dispatch_raise_survives_via_requeue(self, real_stack):
        pool = real_stack["pool"]
        clean = pool.embed_text(self._ids())
        before = pool.counts()["requeued"]
        with faults.armed("serve.dispatch_raise@1"):
            out = pool.embed_text(self._ids())
        np.testing.assert_array_equal(out, clean)
        assert pool.counts()["requeued"] == before + 1
        assert all(pool._replica_state(r) != QUARANTINED
                   for r in pool.replicas)

    def test_dispatch_hang_slows_but_survives(self, real_stack):
        pool = real_stack["pool"]
        clean = pool.embed_text(self._ids(seed=1))
        with faults.armed("serve.dispatch_hang@1:x=0.4"):
            t0 = time.monotonic()
            out = pool.embed_text(self._ids(seed=1))
            dt = time.monotonic() - t0
        np.testing.assert_array_equal(out, clean)
        assert dt >= 0.4, "the hang site did not fire"
        assert pool.recompiles() == 0

    def test_quarantine_then_recovery_round_trip(self, real_stack):
        pool = real_stack["pool"]
        rec_before = pool.counts()["recoveries"]
        with faults.armed("serve.dispatch_raise@*"):
            outcomes = []
            for _ in range(6):
                try:
                    pool.embed_text(self._ids(1))
                    outcomes.append("ok")
                except Exception as exc:
                    outcomes.append(type(exc).__name__)
                if "PoolUnavailable" in outcomes:
                    break
            assert "PoolUnavailable" in outcomes, outcomes
            assert all(pool._replica_state(r) == QUARANTINED
                       for r in pool.replicas)
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            if all(pool._replica_state(r) == SERVING
                   for r in pool.replicas):
                break
            time.sleep(0.05)
        assert all(pool._replica_state(r) == SERVING
                   for r in pool.replicas), "probe recovery timed out"
        assert pool.counts()["recoveries"] >= rec_before + 2
        assert pool.embed_text(self._ids()).shape[0] == 4
        assert pool.recompiles() == 0

    def test_replica_dead_reroutes_within_a_probe_interval(self,
                                                          real_stack):
        pool = ReplicaPool.build(
            real_stack["model"], None, 2, text_words=_WORDS,
            video_shape=_VIDEO, max_batch=8, min_bucket=4,
            devices=["cpu"] * 2, probe_interval_s=0.2,
            registry=obs_metrics.MetricsRegistry())
        try:
            clean = pool.embed_text(self._ids(seed=2))
            with faults.armed("serve.replica_dead@1"):
                out = pool.embed_text(self._ids(seed=2))
            np.testing.assert_array_equal(out, clean)
            dead = [r for r in pool.replicas if r.engine.dead]
            alive = [r for r in pool.replicas if not r.engine.dead]
            assert len(dead) == 1 and len(alive) == 1
            assert pool._replica_state(dead[0]) == QUARANTINED
            for _ in range(3):
                np.testing.assert_array_equal(
                    pool.embed_text(self._ids(seed=2)), clean)
            time.sleep(0.5)
            assert pool._replica_state(dead[0]) == QUARANTINED
            assert pool.counts()["recoveries"] == 0
            assert pool.recompiles() == 0
        finally:
            pool.close()


def test_chaos_closed_loop_acceptance(real_stack):
    """The JAX suite's closed-loop bench acceptance, in process:
    ``serve.dispatch_raise@%5`` armed and one replica killed
    (``serve.replica_dead@25``) mid-run on a 2-replica pool behind the
    service, 4 closed-loop clients for 2 s: no request hangs (every
    client joins), the dead replica quarantined with traffic rerouted,
    at most 2 unstructured errors (structured 503s allowed), requeues
    fired, recompiles 0 on the survivor."""
    from milnce_tpu_torch.serving.cache import EmbeddingLRUCache
    from milnce_tpu_torch.serving.index import DeviceRetrievalIndex

    pool = ReplicaPool.build(
        real_stack["model"], None, 2, text_words=_WORDS,
        video_shape=_VIDEO, max_batch=8, min_bucket=8,
        devices=["cpu"] * 2, probe_interval_s=0.2, max_requeues=2,
        registry=obs_metrics.MetricsRegistry())
    corpus = np.random.default_rng(1).standard_normal(
        (16, 16)).astype(np.float32)
    index = DeviceRetrievalIndex(corpus, k=5, query_buckets=pool.buckets,
                                 device="cpu")
    service = RetrievalService(pool, index, cache=EmbeddingLRUCache(0),
                               max_delay_ms=2.0)
    counts = {"requests": 0, "errors": 0, "structured": 0}
    lock = threading.Lock()
    stop = time.monotonic() + 2.0

    def client(seed):
        rng = np.random.default_rng(seed)
        while time.monotonic() < stop:
            ids = rng.integers(1, 64, (1, _WORDS)).astype(np.int32)
            try:
                service.query_ids(ids)
                kind = None
            except (DegradedError, ShedError, PoolSaturated,
                    PoolUnavailable):
                kind = "structured"
            except Exception:
                kind = "errors"
            with lock:
                counts["requests"] += 1
                if kind:
                    counts[kind] += 1

    try:
        with faults.armed("serve.dispatch_raise@%5;serve.replica_dead@25"):
            threads = [threading.Thread(target=client, args=(s,))
                       for s in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads), "a request hung"
        res = pool.counts()
        stats = pool.pool_stats()
    finally:
        service.close()
        pool.close()
    assert counts["requests"] > 20, counts
    assert counts["errors"] <= 2, counts
    assert res["requeued"] >= 1 and res["quarantines"] >= 1, res
    dead = [r for r in stats["replicas"] if r["dead"]]
    alive = [r for r in stats["replicas"] if not r["dead"]]
    assert len(dead) == 1 and dead[0]["state"] == QUARANTINED
    assert len(alive) == 1 and alive[0]["dispatches"] > dead[0]["dispatches"]
    assert alive[0]["recompiles"] == 0


# ---------------------------------------------------------------------------
# replica classes (tests/test_quant.py's cases)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mixed_stack(tmp_path_factory):
    """One f32 + one int8 edge replica (from exports) behind one service."""
    from milnce_tpu_torch.config import ModelConfig
    from milnce_tpu_torch.quant.quantize import quantize_variables
    from milnce_tpu_torch.serving import export
    from milnce_tpu_torch.serving.index import DeviceRetrievalIndex
    from milnce_tpu_torch.utils.torch_convert import torch_state_dict_to_flax

    root = tmp_path_factory.mktemp("classes")
    model = _model()
    v = torch_state_dict_to_flax({k: t.numpy()
                                  for k, t in model.state_dict().items()})
    kw = dict(max_words=_WORDS, video_shape=_VIDEO)
    f32_dir, q_dir = str(root / "f32"), str(root / "int8")
    export.export_inference_checkpoint(f32_dir, v["params"],
                                       v["batch_stats"],
                                       ModelConfig(**_MODEL), **kw)
    qvars = quantize_variables(v)
    export.export_quantized_checkpoint(q_dir, qvars, ModelConfig(**_MODEL),
                                       **kw)
    pool = ReplicaPool.from_export(f32_dir, 1, max_batch=8,
                                   devices=["cpu"] * 2,
                                   edge_export_dir=q_dir, edge_replicas=1)
    rng = np.random.default_rng(5)
    clips = rng.integers(0, 255, (8,) + _VIDEO, dtype=np.uint8)
    index = DeviceRetrievalIndex(pool.embed_video(clips), k=5,
                                 query_buckets=pool.buckets, device="cpu")
    service = RetrievalService(pool, index, max_delay_ms=2.0)
    yield dict(pool=pool, service=service, f32_dir=f32_dir, q_dir=q_dir,
               qvars=qvars, root=root)
    service.close()
    pool.close()


class TestReplicaClasses:
    def test_pool_reports_both_classes(self, mixed_stack):
        stats = mixed_stack["pool"].stats()
        assert stats["classes"] == {"edge": 1, "f32": 1}
        edge = [r for r in mixed_stack["pool"].replicas if r.cls == "edge"]
        assert any(b.dtype == torch.int8
                   for b in edge[0].engine.model.buffers())

    @pytest.mark.parametrize("cls", ["f32", "edge"])
    def test_class_pinned_embed_serves(self, mixed_stack, cls):
        tokens = np.ones((2, _WORDS), np.int32)
        out = mixed_stack["pool"].embed_text(tokens, cls=cls)
        assert out.shape == (2, 16) and np.isfinite(out).all()

    def test_pins_land_only_on_their_class(self, mixed_stack):
        pool = mixed_stack["pool"]
        before = {r.rid: r.engine.stats()["calls"] for r in pool.replicas}
        for _ in range(4):
            pool.embed_text(np.full((1, _WORDS), 3, np.int32), cls="edge")
        for r in pool.replicas:
            moved = r.engine.stats()["calls"] != before[r.rid]
            assert moved == (r.cls == "edge"), r.cls

    def test_unknown_class_is_a_loud_error(self, mixed_stack):
        with pytest.raises(ValueError, match="replica class"):
            mixed_stack["pool"].embed_text(np.ones((1, _WORDS), np.int32),
                                           cls="gpu")

    def test_class_routing_is_strict(self, mixed_stack):
        pool = mixed_stack["pool"]
        (edge_rid,) = [r.rid for r in pool.replicas if r.cls == "edge"]
        with pytest.raises(PoolUnavailable, match="edge"):
            pool._route(cls="edge", exclude=(edge_rid,))

    @pytest.mark.parametrize("cls", ["f32", "edge"])
    def test_service_request_pins_a_class(self, mixed_stack, cls):
        tokens = np.ones((1, _WORDS), np.int32)
        scores, ids = mixed_stack["service"].query_ids(
            tokens, replica_class=cls)
        assert scores.shape == (1, 5) and ids.shape == (1, 5)

    def test_service_unknown_class_is_a_loud_error(self, mixed_stack):
        with pytest.raises(ValueError, match="replica class"):
            mixed_stack["service"].query_ids(
                np.ones((1, _WORDS), np.int32), replica_class="gpu")

    def test_unpooled_service_refuses_class_pins(self):
        from milnce_tpu_torch.serving.engine import InferenceEngine
        from milnce_tpu_torch.serving.index import DeviceRetrievalIndex

        engine = InferenceEngine(_model(), device="cpu", text_words=_WORDS,
                                 video_shape=_VIDEO, max_batch=8)
        rng = np.random.default_rng(6)
        corpus = engine.embed_video(rng.integers(
            0, 255, (8,) + _VIDEO, dtype=np.uint8))
        index = DeviceRetrievalIndex(corpus, k=3,
                                     query_buckets=engine.buckets,
                                     device="cpu")
        service = RetrievalService(engine, index)
        try:
            with pytest.raises(ValueError, match="pooled"):
                service.query_ids(np.ones((1, _WORDS), np.int32),
                                  replica_class="f32")
        finally:
            service.close()

    def test_contract_mismatch_refused(self, mixed_stack):
        from milnce_tpu_torch.config import ModelConfig
        from milnce_tpu_torch.serving import export

        bad = str(mixed_stack["root"] / "bad_edge")
        export.export_quantized_checkpoint(
            bad, mixed_stack["qvars"], ModelConfig(**_MODEL),
            max_words=_WORDS + 1, video_shape=_VIDEO)
        with pytest.raises(ValueError, match="serving contract"):
            ReplicaPool.from_export(mixed_stack["f32_dir"], 1, max_batch=8,
                                    devices=["cpu"] * 2,
                                    edge_export_dir=bad, edge_replicas=1)


# ---------------------------------------------------------------------------
# partition_devices
# ---------------------------------------------------------------------------

def test_partition_devices_one_device_a_replica():
    """JAX's grouping: on the CPU one device a replica; on cards even
    contiguous groups, one card named more than once included."""
    assert ReplicaPool.partition_devices(["cpu"] * 3, 2) == [["cpu"],
                                                            ["cpu"]]
    assert ReplicaPool.partition_devices(["cuda:0"] * 3, 3) == [
        ["cuda:0"]] * 3
    assert ReplicaPool.partition_devices(["cuda:0", "cuda:1"], 2) == [
        ["cuda:0"], ["cuda:1"]]
    cards = [f"cuda:{i}" for i in range(4)]
    assert ReplicaPool.partition_devices(cards, 2) == [
        ["cuda:0", "cuda:1"], ["cuda:2", "cuda:3"]]
    assert ReplicaPool.partition_devices(cards, 1) == [cards]
    assert ReplicaPool.partition_devices(["cuda:0"] * 4, 2) == [
        ["cuda:0", "cuda:0"]] * 2


@pytest.mark.parametrize("devices,n,match", [
    (["cpu"], 2, "a replica needs at least one card"),
    (["cuda:0", "cuda:1"], 3, "a replica needs at least one card"),
    (["cpu"], 0, "n_replicas=0"),
    (["cuda:0", "cuda:1", "cuda:2"], 2, "do not split evenly"),
])
def test_partition_devices_refusals(devices, n, match):
    with pytest.raises(ValueError, match=match):
        ReplicaPool.partition_devices(devices, n)


def test_multi_card_groups_and_missing_cards_are_refused(tmp_path):
    # groups of cards split evenly or not at all; a card that is not
    # there is refused before anything loads (the export does not exist),
    # and nothing narrows the group or falls back to the CPU
    for devices, n in ((["cuda:0", "cuda:1", "cuda:2"], 2),
                       ([f"cuda:{i}" for i in range(6)], 4)):
        with pytest.raises(ValueError, match="do not split evenly"):
            ReplicaPool.partition_devices(devices, n)
    missing = f"cuda:{torch.cuda.device_count()}"
    with pytest.raises(RuntimeError,
                       match="no CUDA device|CUDA devices are visible"):
        ReplicaPool.from_export(str(tmp_path / "absent"), 2,
                                devices=["cpu", "cpu", missing, missing])
    with pytest.raises(RuntimeError,
                       match="no CUDA device|CUDA devices are visible"):
        ReplicaPool.build(_model(), None, 1, text_words=_WORDS,
                          video_shape=_VIDEO, devices=[missing])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ReplicaPool.partition_devices(None, 1)


def test_pool_of_group_engines_survives_replica_dead():
    """Two replicas, each an engine over a group of two ``cpu`` devices:
    ``serve.replica_dead`` mid-traffic kills one whole group, which
    quarantines and stays so; its request is requeued and every ranking
    stays the same."""
    from milnce_tpu_torch.analysis.lockrt import make_lock
    from milnce_tpu_torch.serving.engine import InferenceEngine
    from milnce_tpu_torch.serving.index import DeviceRetrievalIndex

    model = _model()
    engines = [InferenceEngine(
        copy.deepcopy(model), device=["cpu"] * 2, text_words=_WORDS,
        video_shape=_VIDEO, max_batch=8, min_bucket=2,
        dispatch_lock=make_lock(f"serving.replica{i}.dispatch"))
        for i in range(2)]
    assert all(len(e.models) == 2 and e.buckets == (2, 4, 8)
               for e in engines)
    pool = ReplicaPool(engines, probe_interval_s=0.1, max_requeues=2,
                       registry=obs_metrics.MetricsRegistry())
    rng = np.random.default_rng(3)
    clips = rng.integers(0, 256, (13,) + _VIDEO, dtype=np.uint8)
    corpus = np.concatenate([engines[0].embed_video(clips[:8]),
                             engines[1].embed_video(clips[8:])])
    index = DeviceRetrievalIndex(corpus, k=3, query_buckets=pool.buckets,
                                 device=["cpu"] * 2)
    tokens = rng.integers(1, 64, (3, _WORDS)).astype(np.int32)
    try:
        before = index.topk(pool.embed_text(tokens))[1]
        errors, lock = [], threading.Lock()

        def client(n):
            for _ in range(n):
                try:
                    same = np.array_equal(
                        index.topk(pool.embed_text(tokens))[1], before)
                except Exception as exc:    # noqa: BLE001 - counted
                    same = f"{type(exc).__name__}: {exc}"
                with lock:
                    if same is not True:
                        errors.append(same)

        with faults.armed("serve.replica_dead@5"):
            threads = [threading.Thread(target=client, args=(6,))
                       for _ in range(3)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(60)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors[:3]
        dead = [r for r in pool.replicas if r.engine.dead]
        assert len(dead) == 1
        assert pool.counts()["requeued"] >= 1
        time.sleep(0.3)                  # a few probe intervals
        assert pool._replica_state(dead[0]) == QUARANTINED
        assert pool.counts()["recoveries"] == 0
        for _ in range(3):
            assert np.array_equal(index.topk(pool.embed_text(tokens))[1],
                                  before)
    finally:
        pool.close()


def test_pool_serves_bfloat16_and_keeps_the_edge_at_its_precision(
        mixed_stack):
    """``serve.dtype`` reaches every f32-class replica, as the JAX pool's
    ``from_export(dtype=...)``: bf16 parameters and BatchNorm statistics,
    embeddings equal to one bf16 engine's on the same export; the int8
    edge replica keeps its own precision."""
    from milnce_tpu_torch.serving.engine import InferenceEngine

    pool = ReplicaPool.from_export(
        mixed_stack["f32_dir"], 2, dtype="bfloat16", max_batch=8,
        devices=["cpu"] * 3, edge_export_dir=mixed_stack["q_dir"],
        edge_replicas=1)
    try:
        for r in pool.replicas:
            model = r.engine.model
            floats = {t.dtype for t in [*model.parameters(),
                                        *model.buffers()]
                      if t.is_floating_point()}
            assert floats == ({torch.bfloat16} if r.cls == "f32"
                              else {torch.float32}), r.cls
        one = InferenceEngine.from_export(mixed_stack["f32_dir"],
                                          device="cpu", dtype="bfloat16",
                                          max_batch=8, precompile=False)
        tokens = np.random.default_rng(9).integers(
            1, 64, (3, _WORDS)).astype(np.int32)
        np.testing.assert_array_equal(pool.embed_text(tokens, cls="f32"),
                                      one.embed_text(tokens))
    finally:
        pool.close()
