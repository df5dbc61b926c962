"""Port parity, serving core: ``milnce_tpu_torch/serving/engine.py``,
``index.py`` and ``cache.py`` against ``milnce_tpu/serving/`` (the cases
of ``tests/test_serving.py`` that these modules carry), on the CPU.

- Engine: the ladder and ``bucket_for`` equal JAX's at the boundaries;
  oversized and wrongly shaped inputs are rejected; padding never
  changes a real row; a ladder sweep makes 0 recompiles; concurrent
  call accounting is exact; each fault site fires; ``stats()`` has the
  JAX keys.
- Index: the top-k equals the numpy ranking and JAX's
  ``DeviceRetrievalIndex`` on the same embeddings, planted duplicate rows
  with a tie across the k-th place included (ties by the lower row, as
  ``lax.top_k``); pad rows are never retrieved; the k and bucket bounds;
  the sharded index at W = 2 and 4 over gloo equals one shard and JAX's
  index on a 2- and 4-device mesh.
- The served path (token rows -> cache -> dynamic batcher -> engine ->
  index) ranks as the port's offline eval (``eval/retrieval.py``).
- Cache: LRU order, the disabled cache, read-only rows, and a hit leaves
  the engine's call counts unchanged.
- The serving locks come from ``analysis/lockrt.py::make_lock`` under
  the JAX names, and the port's sanitizer catches what JAX's does.

One module-scoped stack (a tiny random model, one Inception block,
4 x 32^2 frames, 6 words) keeps the warm-up to one sweep.
"""

import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh

import torch_dist_worker as worker
from milnce_tpu.serving.engine import InferenceEngine as JaxEngine
from milnce_tpu.serving.engine import bucket_ladder as jax_bucket_ladder
from milnce_tpu.serving.index import DeviceRetrievalIndex as JaxIndex
from milnce_tpu.serving.index import shard_corpus as jax_shard_corpus
from milnce_tpu_torch.config import ModelConfig
from milnce_tpu_torch.models.build import build_model
from milnce_tpu_torch.resilience import faults
from milnce_tpu_torch.serving.batcher import DynamicBatcher
from milnce_tpu_torch.serving.cache import EmbeddingLRUCache, token_key
from milnce_tpu_torch.serving.engine import (InferenceEngine, ReplicaDead,
                                             bucket_ladder)
from milnce_tpu_torch.serving.index import DeviceRetrievalIndex, shard_corpus

torch.set_num_threads(1)         # six test workers share the cores

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_FRAMES, _SIZE, _WORDS, _VOCAB = 4, 32, 6, 64
_VIDEO = (_FRAMES, _SIZE, _SIZE, 3)
_CORPUS, _K = 21, 5
_MODEL = dict(embedding_dim=16, vocab_size=_VOCAB, word_embedding_dim=8,
              text_hidden_dim=16, inception_blocks=1)


@pytest.fixture(scope="module")
def stack():
    model = build_model(ModelConfig(**_MODEL), seed=0)
    engine = InferenceEngine(model, device="cpu", text_words=_WORDS,
                             video_shape=_VIDEO, max_batch=16)
    rng = np.random.default_rng(0)
    clips = rng.integers(0, 255, (_CORPUS,) + _VIDEO, dtype=np.uint8)
    corpus_emb = np.concatenate(
        [engine.embed_video(clips[:16]), engine.embed_video(clips[16:])])
    index = DeviceRetrievalIndex(corpus_emb, k=_K,
                                 query_buckets=engine.buckets, device="cpu")
    return dict(model=model, engine=engine, clips=clips,
                corpus_emb=corpus_emb, index=index)


def _jax_ranking(emb, queries, k, n_dev):
    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("data",))
    index = JaxIndex(mesh, emb, k=k, query_buckets=(len(queries),))
    scores, idx = index.topk(queries)
    return np.asarray(scores), np.asarray(idx)


def _numpy_ranking(emb, queries, k):
    """Exhaustive ranking on the host, ties by the lower row."""
    sim = queries.astype(np.float64) @ emb.astype(np.float64).T
    return np.argsort(-sim, axis=1, kind="stable")[:, :k]


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_dev", [1, 2, 8])
@pytest.mark.parametrize("min_bucket", [0, 1, 3, 8, 16])
@pytest.mark.parametrize("max_batch", [1, 8, 16, 24])
def test_bucket_ladder_equals_jax(n_dev, min_bucket, max_batch):
    try:
        want = jax_bucket_ladder(n_dev, min_bucket, max_batch)
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            bucket_ladder(n_dev, min_bucket, max_batch)
        assert str(got.value) == str(exc)
        return
    assert bucket_ladder(n_dev, min_bucket, max_batch) == want


def test_engine_ladder_and_bucket_for_equal_a_one_device_jax_engine(stack):
    """The port's engine runs on one device: its ladder is a 1-device
    data axis's, and ``bucket_for`` agrees with JAX's at every n."""
    import jax.numpy as jnp

    from milnce_tpu.models import S3D as JaxS3D

    model = JaxS3D(num_classes=16, vocab_size=_VOCAB, word_embedding_dim=8,
                   text_hidden_dim=16, inception_blocks=1)
    variables = model.init(jax.random.PRNGKey(0),
                           jnp.zeros((1,) + _VIDEO),
                           jnp.zeros((1, _WORDS), jnp.int32))
    jx = JaxEngine(model, dict(variables),
                   Mesh(np.array(jax.devices()[:1]), ("data",)),
                   text_words=_WORDS, video_shape=_VIDEO, max_batch=16,
                   precompile=False)
    eng = stack["engine"]
    assert eng.buckets == jx.buckets == (1, 2, 4, 8, 16)
    for n in range(1, 17):
        assert eng.bucket_for(n) == jx.bucket_for(n), n
    for n in (0, 17):
        with pytest.raises(ValueError):
            jx.bucket_for(n)
        with pytest.raises(ValueError):
            eng.bucket_for(n)


def test_oversize_batch_rejected(stack):
    with pytest.raises(ValueError, match="max_batch"):
        stack["engine"].bucket_for(17)
    with pytest.raises(ValueError, match="max_batch"):
        stack["engine"].embed_text(np.zeros((17, _WORDS), np.int32))


def test_wrong_trailing_shape_rejected(stack):
    eng = stack["engine"]
    with pytest.raises(ValueError, match="token ids"):
        eng.embed_text(np.zeros((2, _WORDS + 1), np.int32))
    with pytest.raises(ValueError, match="token ids"):
        eng.embed_text(np.zeros((_WORDS,), np.int32))
    with pytest.raises(ValueError, match="uint8 video"):
        eng.embed_video(np.zeros((2, _FRAMES, _SIZE, 16, 3), np.uint8))


def test_pad_unpad_identity(stack):
    """Rows of a padded partial batch == the same rows embedded alone:
    padding slots never leak into real rows."""
    eng = stack["engine"]
    rng = np.random.default_rng(1)
    ids = rng.integers(1, _VOCAB, (5, _WORDS)).astype(np.int32)
    five = eng.embed_text(ids)                     # pads 5 -> 8
    singles = np.stack([eng.embed_text(ids[i:i + 1])[0] for i in range(5)])
    np.testing.assert_allclose(five, singles, rtol=1e-5, atol=1e-6)
    clips = stack["clips"][:3]
    three = eng.embed_video(clips)                 # pads 3 -> 4
    alone = np.stack([eng.embed_video(clips[i:i + 1])[0] for i in range(3)])
    np.testing.assert_allclose(three, alone, rtol=1e-5, atol=1e-6)


def test_ladder_sweep_causes_zero_recompiles(stack):
    eng = stack["engine"]
    rng = np.random.default_rng(2)
    for n in (1, 3, 8, 11, 16):
        eng.embed_text(rng.integers(1, _VOCAB, (n, _WORDS)).astype(np.int32))
        eng.embed_video(rng.integers(0, 255, (n,) + _VIDEO, dtype=np.uint8))
    assert eng.recompiles() == 0
    # a shape the sweep never ran counts: a rung added after the warm-up
    fresh = InferenceEngine(stack["model"], device="cpu", text_words=_WORDS,
                            video_shape=_VIDEO, max_batch=2)
    assert fresh.recompiles() == 0
    fresh.buckets += (4,)
    fresh.embed_text(np.zeros((3, _WORDS), np.int32))
    assert fresh.recompiles() == 1


def test_cast_floats_equals_jax():
    from milnce_tpu.serving.engine import cast_floats as jax_cast_floats
    from milnce_tpu_torch.serving.engine import cast_floats

    tree = {"a": {"w": np.ones((2, 3), np.float32)},
            "n": np.arange(3, dtype=np.int32),
            "t": torch.ones(2, dtype=torch.float32)}
    got = cast_floats(tree, "float16")
    want = jax_cast_floats({k: v for k, v in tree.items() if k != "t"},
                           "float16")
    assert got["a"]["w"].dtype == np.float16 == want["a"]["w"].dtype
    assert got["n"].dtype == np.int32 == want["n"].dtype
    assert got["t"].dtype == torch.float16
    assert np.array_equal(got["a"]["w"], np.asarray(want["a"]["w"]))


def test_stats_keys_equal_jax(stack):
    s = stack["engine"].stats()
    assert sorted(s) == ["buckets", "calls", "dead", "max_batch",
                         "recompiles"]
    assert s["buckets"] == [1, 2, 4, 8, 16] and s["max_batch"] == 16
    assert s["dead"] is False and s["recompiles"] == 0
    assert s["calls"]["video@16"] >= 2 and "text@1" in s["calls"]
    assert stack["engine"].embed_dim == 16


def test_concurrent_call_accounting_is_exact(stack):
    """N threads x K embeds land EXACTLY N*K counts, with stats()
    readers racing the whole time."""
    eng = stack["engine"]
    key = "text@1"
    before = eng.stats()["calls"].get(key, 0)
    n_threads, k = 6, 4
    ids = np.ones((1, _WORDS), np.int32)
    stop = threading.Event()
    errors = []

    def embedder():
        try:
            for _ in range(k):
                eng.embed_text(ids)
        except Exception as exc:  # pragma: no cover - the assert below
            errors.append(exc)

    def reader():
        while not stop.is_set():
            assert eng.stats()["calls"].get(key, 0) >= before

    threads = [threading.Thread(target=embedder) for _ in range(n_threads)]
    readers = [threading.Thread(target=reader) for _ in range(2)]
    for t in readers + threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    stop.set()
    for t in readers:
        t.join(timeout=30)
    assert not errors, errors
    assert eng.stats()["calls"][key] == before + n_threads * k


def test_fault_sites_fire(stack):
    """``serve.dispatch_raise`` raises, ``serve.dispatch_hang`` sleeps
    ``x`` and then serves, ``serve.replica_dead`` kills the engine for
    good; the counts of calls move only for served dispatches."""
    eng = stack["engine"]
    ids = np.ones((1, _WORDS), np.int32)
    calls = eng.stats()["calls"]["text@1"]
    with faults.armed("serve.dispatch_raise@1"):
        with pytest.raises(faults.InjectedFault, match="dispatch_raise"):
            eng.embed_text(ids)
        eng.embed_text(ids)                       # occurrence 2 serves
    with faults.armed("serve.dispatch_hang@1:x=0.3"):
        t0 = time.monotonic()
        out = eng.embed_text(ids)
        assert time.monotonic() - t0 >= 0.3 and out.shape == (1, 16)
    assert eng.stats()["calls"]["text@1"] == calls + 2
    victim = InferenceEngine(stack["model"], device="cpu",
                             text_words=_WORDS, video_shape=_VIDEO,
                             max_batch=2, precompile=False)
    with faults.armed("serve.replica_dead@2"):
        victim.embed_text(ids)
        with pytest.raises(ReplicaDead, match="replica_dead"):
            victim.embed_text(ids)
    assert victim.dead and victim.stats()["dead"]
    with pytest.raises(ReplicaDead, match="dead"):
        victim.embed_video(np.zeros((1,) + _VIDEO, np.uint8))
    assert not eng.dead


def test_cuda_without_a_card_raises(stack):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(stack["model"], text_words=_WORDS,
                        video_shape=_VIDEO, precompile=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceRetrievalIndex(stack["corpus_emb"], k=_K)


# ---------------------------------------------------------------------------
# index
# ---------------------------------------------------------------------------

def _planted(emb, queries, k):
    """``emb`` with rows copied so that, for the first query, the row at
    place k is tied with a copy of itself at a lower row (the copy must
    win the k-th place) and, for the second, with a copy at a higher row
    (the original must keep it); for the third, a tie inside the top-k.
    Each copy is placed where it leaves the earlier plants standing."""
    emb = emb.copy()
    plants = []                   # (query, place, (lower row, higher row))

    def holds(e, plant):
        q, place, pair = plant
        order = _numpy_ranking(e, queries[q:q + 1], place + 2)[0]
        return tuple(order[place:place + 2].tolist()) == pair

    for q, (place, lower) in enumerate(((k - 1, True), (k - 1, False),
                                        (1, False))):
        r = int(_numpy_ranking(emb, queries[q:q + 1], place + 1)[0][place])
        rows = range(r) if lower else range(len(emb) - 1, r, -1)
        for p in rows:
            trial = emb.copy()
            trial[p] = emb[r]
            plant = (q, place, (min(p, r), max(p, r)))
            if all(holds(trial, x) for x in plants + [plant]):
                emb, plants = trial, plants + [plant]
                break
        else:
            raise AssertionError(f"no row to plant query {q}'s tie")
    return emb


def test_topk_equals_numpy_and_jax_with_ties_at_the_kth_place(stack):
    rng = np.random.default_rng(3)
    base = rng.standard_normal((64, 16)).astype(np.float32)
    queries = rng.standard_normal((5, 16)).astype(np.float32)
    emb = _planted(base, queries, _K)
    ref = _numpy_ranking(emb, queries, _K)
    sim = queries.astype(np.float64) @ emb.astype(np.float64).T
    # the plants hold: place k tied with place k + 1 for queries 0 and 1
    for q in (0, 1):
        order = np.argsort(-sim[q], kind="stable")
        assert sim[q, order[_K - 1]] == sim[q, order[_K]]
    index = DeviceRetrievalIndex(emb, k=_K, query_buckets=(8,),
                                 device="cpu")
    scores, idx = index.topk(queries)
    jax_scores, jax_idx = _jax_ranking(emb, queries, _K, 8)
    assert idx.dtype == np.int32 and scores.dtype == np.float32
    assert np.array_equal(idx, ref)
    assert np.array_equal(idx, jax_idx)
    np.testing.assert_allclose(scores, np.take_along_axis(sim, ref, axis=1),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(scores, jax_scores, rtol=1e-5, atol=1e-5)


def test_topk_matches_numpy_ranking_on_engine_embeddings(stack):
    index, corpus_emb = stack["index"], stack["corpus_emb"]
    rng = np.random.default_rng(4)
    q = rng.standard_normal((5, corpus_emb.shape[1])).astype(np.float32)
    _, idx = index.topk(q)
    assert np.array_equal(idx, _numpy_ranking(corpus_emb, q, _K))
    assert np.array_equal(idx, _jax_ranking(corpus_emb, q, _K, 8)[1])


def test_exact_topk_orders_every_tie_by_the_lower_row():
    from milnce_tpu_torch.serving.index import exact_topk

    scores = torch.tensor([[1.0, 3.0, 3.0, -0.0, 0.0, -2.0, 3.0, -torch.inf,
                            -1.0, -1.0]])
    s, i = exact_topk(scores, torch.arange(10)[None], 10)
    assert i.tolist() == [[1, 2, 6, 0, 3, 4, 8, 9, 5, 7]]
    assert s.tolist()[0][:3] == [3.0, 3.0, 3.0]


def test_shard_corpus_equals_jax():
    emb = np.random.default_rng(5).standard_normal((21, 4)).astype(
        np.float32)
    for n_data, rows in ((1, 21), (2, 11), (4, 6), (8, 5)):
        got, want = shard_corpus(emb, n_data, rows), jax_shard_corpus(
            emb, n_data, rows)
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1]) and got[1].dtype == np.int32


def test_pad_rows_never_retrieved(stack):
    emb = stack["corpus_emb"][:7]               # k = 5 of 7 real rows
    index = DeviceRetrievalIndex(-np.abs(emb), k=7, query_buckets=(4,),
                                 device="cpu")
    # all-negative scores: the zero pad rows would win if not masked
    _, idx = index.topk(np.abs(stack["corpus_emb"][:3]))
    assert idx.max() < index.size and sorted(idx[0]) == list(range(7))


def test_query_bucket_overflow_rejected(stack):
    index = stack["index"]
    with pytest.raises(ValueError, match="query bucket"):
        index.topk(np.zeros((17, index.dim), np.float32))
    with pytest.raises(ValueError, match="queries"):
        index.topk(np.zeros((2, index.dim + 1), np.float32))


@pytest.mark.parametrize("k", [0, _CORPUS + 1])
def test_k_bounds_validated(stack, k):
    with pytest.raises(ValueError, match="outside"):
        DeviceRetrievalIndex(stack["corpus_emb"], k=k, device="cpu",
                             precompile=False)


def test_concurrent_topk_call_accounting_is_exact(stack):
    index = stack["index"]
    before = index.stats()["calls"]
    n_threads, k = 6, 4
    q = np.zeros((1, index.dim), np.float32)
    threads = [threading.Thread(
        target=lambda: [index.topk(q) for _ in range(k)])
        for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    s = index.stats()
    assert s["calls"] == before + n_threads * k and s["recompiles"] == 0
    assert sorted(s) == ["calls", "dim", "k", "query_buckets", "recompiles",
                         "size"]


@pytest.fixture(scope="module")
def sharded(stack, tmp_path_factory):
    rng = np.random.default_rng(8)
    queries = rng.standard_normal((6, 16)).astype(np.float32)
    emb = _planted(np.concatenate([stack["corpus_emb"],
                                   rng.standard_normal((43, 16)).astype(
                                       np.float32)]), queries, _K)
    return emb, queries, {w: worker.spawn(
        worker.index_topk_cases, w, tmp_path_factory.mktemp(f"index-{w}"),
        emb, queries, _K, (8,)) for w in (2, 4)}


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_index_equals_one_shard_and_jax(sharded, world):
    emb, queries, runs = sharded
    one = DeviceRetrievalIndex(emb, k=_K, query_buckets=(8,), device="cpu")
    s1, i1 = one.topk(queries)
    jax_scores, jax_idx = _jax_ranking(emb, queries, _K, world)
    rows = max(-(-len(emb) // world), _K)
    for rank, got in enumerate(runs[world]):
        assert got["rows"] == rows and got["recompiles"] == 0
        assert got["valid"] == max(0, min(len(emb), (rank + 1) * rows)
                                   - rank * rows)
        assert np.array_equal(got["idx"], i1), rank
        assert np.array_equal(got["idx"], jax_idx), rank
        assert np.array_equal(got["scores"], s1), rank
        np.testing.assert_allclose(got["scores"], jax_scores, rtol=1e-5,
                                   atol=1e-5)
    assert np.array_equal(i1, _numpy_ranking(emb, queries, _K))


# ---------------------------------------------------------------------------
# the served path and the cache
# ---------------------------------------------------------------------------

def _serve_text(cache, batcher, ids):
    """A query's text embeddings as the JAX service gets them: the cache,
    then the batcher for the misses."""
    out = []
    for row in ids:
        key = token_key(row)
        hit = cache.get(key)
        if hit is None:
            hit = batcher.submit(row).result(timeout=60)
            cache.put(key, hit)
        out.append(hit)
    return np.stack(out)


def test_served_topk_equals_offline_eval_ranking(stack):
    """Token rows through cache -> dynamic batcher -> bucketed engine ->
    index, from many threads, rank exactly as the port's offline
    ``eval/retrieval.py`` extraction + argsort."""
    from milnce_tpu_torch.eval.retrieval import extract_retrieval_embeddings

    clips, engine, index = stack["clips"], stack["engine"], stack["index"]
    rng = np.random.default_rng(5)
    texts = rng.integers(1, _VOCAB, (_CORPUS, _WORDS)).astype(np.int32)

    class _Source:
        def __len__(self):
            return _CORPUS

        def sample(self, i, rng=None):
            return {"video": clips[i:i + 1], "text": texts[i:i + 1]}

    t_emb, v_emb = extract_retrieval_embeddings(stack["model"], _Source(),
                                                torch.device("cpu"),
                                                batch_size=8)
    offline = np.argsort(-(t_emb @ v_emb.T), axis=1)[:, :_K]
    cache = EmbeddingLRUCache(128)
    batcher = DynamicBatcher(engine.embed_text, engine.bucket_for,
                             max_batch=engine.max_batch, max_delay_ms=3.0)
    results = [None] * _CORPUS

    def one(i):
        results[i] = index.topk(_serve_text(cache, batcher,
                                            texts[i:i + 1]))[1][0]

    try:
        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(_CORPUS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        served = np.stack(results)
        assert np.array_equal(served, offline), (
            "served top-k diverged from the offline eval ranking")
        assert batcher.stats()["flushes"] < _CORPUS      # it batched
        assert engine.recompiles() == 0 and index.recompiles() == 0
    finally:
        batcher.close()


def test_cache_hits_skip_the_device(stack):
    engine = stack["engine"]
    cache = EmbeddingLRUCache(8)
    batcher = DynamicBatcher(engine.embed_text, engine.bucket_for,
                             max_batch=engine.max_batch, max_delay_ms=1.0)
    try:
        ids = np.full((1, _WORDS), 7, np.int32)
        first = _serve_text(cache, batcher, ids)
        calls_before = dict(engine.stats()["calls"])
        before_hits = cache.stats()["hits"]
        out = _serve_text(cache, batcher, ids)
        assert cache.stats()["hits"] == before_hits + 1
        assert engine.stats()["calls"] == calls_before   # no dispatch
        assert np.array_equal(out, first) and out.shape == (1, 16)
    finally:
        batcher.close()


class TestCache:
    def test_lru_eviction_order(self):
        c = EmbeddingLRUCache(capacity=2)
        c.put((1,), np.array([1.0]))
        c.put((2,), np.array([2.0]))
        assert c.get((1,)) is not None      # refresh 1 -> 2 is now LRU
        c.put((3,), np.array([3.0]))
        assert c.get((2,)) is None
        assert c.get((1,)) is not None and c.get((3,)) is not None

    def test_disabled_cache_never_stores(self):
        c = EmbeddingLRUCache(capacity=0)
        c.put((1,), np.array([1.0]))
        assert c.get((1,)) is None and len(c) == 0

    def test_stored_rows_are_immutable(self):
        c = EmbeddingLRUCache(capacity=4)
        c.put((1,), np.array([1.0, 2.0]))
        row = c.get((1,))
        with pytest.raises(ValueError):
            row[0] = 99.0

    def test_stats_and_key_equal_jax(self):
        from milnce_tpu.serving.cache import EmbeddingLRUCache as JaxCache
        from milnce_tpu.serving.cache import token_key as jax_token_key

        row = np.array([3, 1, 0, 0], np.int32)
        assert token_key(row) == jax_token_key(row) == (3, 1, 0, 0)
        caches = [EmbeddingLRUCache(2), JaxCache(2)]
        for c in caches:
            c.put((1,), np.ones(2))
            c.get((1,))
            c.get((9,))
        assert caches[0].stats() == caches[1].stats()


# ---------------------------------------------------------------------------
# locks
# ---------------------------------------------------------------------------

def test_serving_locks_carry_the_jax_names(stack, monkeypatch):
    from milnce_tpu_torch.analysis.lockrt import SanitizedLock

    monkeypatch.setenv("MILNCE_LOCK_SANITIZE", "1")
    engine = InferenceEngine(stack["model"], device="cpu",
                             text_words=_WORDS, video_shape=_VIDEO,
                             max_batch=1, precompile=False)
    index = DeviceRetrievalIndex(stack["corpus_emb"], k=_K, device="cpu",
                                 precompile=False)
    cache = EmbeddingLRUCache(2)
    batcher = DynamicBatcher(engine.embed_text, engine.bucket_for,
                             max_batch=1)
    try:
        names = {engine._stats_lock.name, index._stats_lock.name,
                 cache._lock.name, batcher._children_lock.name,
                 batcher._forming_lock.name}
        assert all(isinstance(lock, SanitizedLock) for lock in (
            engine._stats_lock, index._stats_lock, cache._lock))
    finally:
        batcher.close()
    assert names == {"serving.engine.stats", "serving.index.stats",
                     "serving.cache", "serving.batcher.children",
                     "serving.batcher.forming"}
    # the module-level dispatch lock is made at import time
    code = ("from milnce_tpu_torch.serving import engine; "
            "print(type(engine.DEVICE_DISPATCH_LOCK).__name__, "
            "engine.DEVICE_DISPATCH_LOCK.name)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env={**os.environ, "MILNCE_LOCK_SANITIZE": "1"},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["SanitizedLock", "serving.device_dispatch"]


@pytest.mark.parametrize("package", ["port", "jax"])
def test_sanitizer_catches_abba_and_self_deadlock(package):
    if package == "port":
        from milnce_tpu_torch.analysis import lockrt
    else:
        from milnce_tpu.analysis import lockrt

    graph = lockrt.LockOrderGraph()
    a = lockrt.SanitizedLock("a", graph=graph)
    b = lockrt.SanitizedLock("b", graph=graph)
    with a, b:
        pass
    with pytest.raises(lockrt.LockOrderError, match="cycle"):
        with b, a:
            pass
    with pytest.raises(lockrt.LockOrderError, match="self-deadlock"):
        with a, a:
            pass
    assert graph.snapshot()["edges"][0][:2] == ["a", "b"]
    slow = lockrt.SanitizedLock("slow", hold_budget_s=0.001, graph=graph)
    with pytest.raises(lockrt.LockHoldBudgetExceeded):
        with slow:
            time.sleep(0.01)
