"""Port parity, live index: ``milnce_tpu_torch/serving/live_index.py``
against ``milnce_tpu/serving/live_index.py`` on the CPU.

- ``shard_rung`` and ``recommended_min_shard_rows`` equal JAX's over a
  grid, refusals included.
- The same ingest sequence gives the JAX ``LiveRetrievalIndex``'s
  rankings (and a float64 numpy ranking, ties by the lower row) at every
  generation, within a rung and across rungs, with duplicate rows
  planted so that ties cross the k-th place; ``stats()`` has the JAX
  keys.
- Swap chaos: under ``index.swap_raise`` the old generation keeps
  serving bit for bit, the rows are re-queued and the builder retries; a
  hung ingest does not block queries.
- Snapshots open in both directions, bit-exact, generation kept.
- Row shards over a gloo pair (``group=``) rank as one shard at every
  generation.
- A 16-thread ingest-while-query hammer under ``MILNCE_LOCK_SANITIZE=1``
  (``tests/torch_dist_worker.py live_index_hammer``): no torn
  generation, exact row accounting, >= 3 swaps, and no lock taken while
  another serving lock is held.

Rankings compare exactly (they are indices); scores against JAX's within
rtol 1e-6, atol 1e-6 (the same f32 dot products, summed in another
order), and against the port's own earlier answers bit for bit.
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
from milnce_tpu.serving import live_index as jax_live
from milnce_tpu.serving.export import export_corpus_snapshot as jax_snapshot
from milnce_tpu_torch.resilience import faults
from milnce_tpu_torch.serving import live_index

torch.set_num_threads(1)         # six test workers share the cores

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_DIM, _K = 16, 5


def _mesh():
    return Mesh(np.array(jax.devices()[:1]), ("data",))


def _index(corpus, **kw):
    kw.setdefault("k", _K)
    kw.setdefault("query_buckets", (8,))
    return live_index.LiveRetrievalIndex(corpus, device="cpu", **kw)


def _numpy_ranking(emb, queries, k):
    sim = queries.astype(np.float64) @ emb.astype(np.float64).T
    return np.argsort(-sim, axis=1, kind="stable")[:, :k]


def _tied_corpus(rng, n):
    """``n`` rows drawn from n // 3 distinct ones: every score is tied
    with a few others, so ties cross the k-th place."""
    distinct = rng.standard_normal((max(1, n // 3), _DIM)).astype(np.float32)
    return distinct[rng.integers(0, len(distinct), n)]


# ---------------------------------------------------------------------------
# the rung rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_data", [1, 2, 8])
@pytest.mark.parametrize("k", [1, 5, 10])
@pytest.mark.parametrize("floor", [0, 32])
def test_shard_rung_equals_jax(n_data, k, floor):
    for size in range(0, 140):
        assert live_index.shard_rung(size, n_data, k, floor) == \
            jax_live.shard_rung(size, n_data, k, floor), size


@pytest.mark.parametrize("n_data", [0, 1, 8])
@pytest.mark.parametrize("headroom", [0, 1, 2, 3])
def test_recommended_min_shard_rows_equals_jax(n_data, headroom):
    for rows in (-1, 0, 1, 100, 1_200_000):
        try:
            want = jax_live.recommended_min_shard_rows(rows, n_data,
                                                       headroom)
        except ValueError as exc:
            with pytest.raises(ValueError) as got:
                live_index.recommended_min_shard_rows(rows, n_data,
                                                      headroom)
            assert str(got.value) == str(exc)
            continue
        assert live_index.recommended_min_shard_rows(
            rows, n_data, headroom) == want


# ---------------------------------------------------------------------------
# rankings at every generation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("min_shard_rows", [0, 128])
def test_ingest_sequence_ranks_as_jax_at_every_generation(min_shard_rows):
    """Boot 12 rows, ingest 9, 10, 20 and 40 more (rung 16 -> 32 -> 64 ->
    128 without a floor; all in one rung with 128): each generation's
    top-k equals the JAX live index's and a float64 numpy ranking."""
    rng = np.random.default_rng(5)
    chunks = [12, 9, 10, 20, 40]
    full = _tied_corpus(rng, sum(chunks))
    queries = rng.standard_normal((6, _DIM)).astype(np.float32)
    kw = dict(k=_K, query_buckets=(8,), min_shard_rows=min_shard_rows)
    port = _index(full[:chunks[0]], **kw)
    jx = jax_live.LiveRetrievalIndex(_mesh(), full[:chunks[0]], **kw)
    crossed, rungs = 0, set()
    try:
        size = chunks[0]
        for gen, n in enumerate([0] + chunks[1:]):
            if n:
                for idx in (port, jx):
                    idx.add(full[size:size + n])
                    assert idx.flush(10.0)
                size += n
            s, i, g = port.topk_with_gen(queries)
            js, ji, jg = jx.topk_with_gen(queries)
            assert g == jg == gen
            assert np.array_equal(i, np.asarray(ji)), gen
            np.testing.assert_allclose(s, np.asarray(js), rtol=1e-6,
                                       atol=1e-6)
            assert np.array_equal(i, _numpy_ranking(full[:size], queries,
                                                    _K)), gen
            sim = queries.astype(np.float64) @ full[:size].T.astype(
                np.float64)
            ordered = -np.sort(-sim, axis=1)
            crossed += int((ordered[:, _K - 1] == ordered[:, _K]).sum())
            rungs.add(port.stats()["shard_rows"])
            assert port.stats()["shard_rows"] == jx.stats()["shard_rows"]
        st, jst = port.stats(), jx.stats()
        assert sorted(st) == sorted(jst)
        for key in ("size", "generation", "swaps", "swap_failures",
                    "pending_rows", "ingested_rows", "capacity",
                    "shard_rows", "calls"):
            assert st[key] == jst[key], key
        assert st["recompiles"] == 0 and st["builder_alive"]
        assert crossed >= 2, "no tie crossed the k-th place"
        assert len(rungs) == (1 if min_shard_rows else 4)
    finally:
        port.close()
        jx.close()


def test_empty_boot_ingest_then_query_and_cuda_refusal():
    rng = np.random.default_rng(32)
    li = _index(None, dim=_DIM)
    try:
        with pytest.raises(ValueError, match="ingest more"):
            li.topk(np.zeros((1, _DIM), np.float32))
        with pytest.raises(ValueError, match="expected"):
            li.add(np.zeros((2, _DIM + 1), np.float32))
        li.add(rng.standard_normal((8, _DIM)).astype(np.float32))
        assert li.flush(10.0)
        _, idx, gen = li.topk_with_gen(
            rng.standard_normal((2, _DIM)).astype(np.float32))
        assert gen == 1 and idx.max() < 8
    finally:
        li.close()
    with pytest.raises(ValueError, match="dim="):
        _index(None)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            live_index.LiveRetrievalIndex(None, dim=_DIM)


# ---------------------------------------------------------------------------
# swap chaos
# ---------------------------------------------------------------------------

def test_failed_swap_keeps_old_generation_and_builder_retries():
    rng = np.random.default_rng(11)
    li = _index(rng.standard_normal((12, _DIM)).astype(np.float32))
    try:
        q = rng.standard_normal((3, _DIM)).astype(np.float32)
        s0, i0, g0 = li.topk_with_gen(q)
        with faults.armed("index.swap_raise@*"):
            li.add(rng.standard_normal((3, _DIM)).astype(np.float32))
            assert not li.flush(0.8), "swap 'succeeded' under @*"
            st = li.stats()
            assert st["swap_failures"] >= 1
            assert st["pending_rows"] == 3, "failed swap lost rows"
            assert st["builder_alive"], "builder thread wedged"
            s1, i1, g1 = li.topk_with_gen(q)
            assert g1 == g0 and np.array_equal(i1, i0) \
                and np.array_equal(s1, s0), "old generation torn"
        assert li.flush(10.0), li.stats()
        st = li.stats()
        assert st["generation"] == g0 + 1 and st["size"] == 15
        assert st["pending_rows"] == 0 and st["builder_alive"]
        assert li.recompiles() == 0
    finally:
        li.close()


def test_transient_swap_failure_self_heals_without_flush():
    rng = np.random.default_rng(12)
    li = _index(rng.standard_normal((12, _DIM)).astype(np.float32))
    try:
        with faults.armed("index.swap_raise@1"):
            li.add(rng.standard_normal((2, _DIM)).astype(np.float32))
            deadline = time.monotonic() + 10.0
            while time.monotonic() < deadline:
                if li.stats()["generation"] == 1:
                    break
                time.sleep(0.02)
        st = li.stats()
        assert st["generation"] == 1 and st["size"] == 14, st
        assert st["swap_failures"] == 1
    finally:
        li.close()


def test_ingest_hang_does_not_block_queries():
    rng = np.random.default_rng(13)
    li = _index(rng.standard_normal((12, _DIM)).astype(np.float32))
    try:
        q = rng.standard_normal((2, _DIM)).astype(np.float32)
        li.topk_with_gen(q)
        done = threading.Event()

        def slow_add():
            li.add(rng.standard_normal((2, _DIM)).astype(np.float32))
            done.set()

        faults.arm("index.ingest_hang@1:x=0.8")
        try:
            t = threading.Thread(target=slow_add, daemon=True)
            t.start()
            time.sleep(0.05)
            t0 = time.monotonic()
            li.topk_with_gen(q)
            dt = time.monotonic() - t0
            t.join(timeout=10)
        finally:
            faults.disarm()
        assert done.is_set()
        assert dt < 0.5, f"query took {dt:.3f}s while an ingest hung"
    finally:
        li.close()


# ---------------------------------------------------------------------------
# snapshots across the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["port", "jax"])
def test_snapshot_restores_bit_exact_in_both_packages(writer, tmp_path):
    rng = np.random.default_rng(21)
    boot = rng.standard_normal((12, _DIM)).astype(np.float32)
    grow = rng.standard_normal((5, _DIM)).astype(np.float32)
    q = rng.standard_normal((4, _DIM)).astype(np.float32)
    snap = str(tmp_path / "snap")
    if writer == "port":
        src = _index(boot)
    else:
        src = jax_live.LiveRetrievalIndex(_mesh(), boot, k=_K,
                                          query_buckets=(8,))
    try:
        src.add(grow)
        assert src.flush(10.0)
        s0, i0, g0 = src.topk_with_gen(q)
        src.snapshot(snap)
    finally:
        src.close()
    dst = (jax_live.LiveRetrievalIndex.restore(snap, _mesh(),
                                               query_buckets=(8,))
           if writer == "port"
           else live_index.LiveRetrievalIndex.restore(
               snap, query_buckets=(8,), device="cpu"))
    try:
        s1, i1, g1 = dst.topk_with_gen(q)
        np.testing.assert_allclose(np.asarray(s1), np.asarray(s0),
                                   rtol=1e-6, atol=1e-6)
        assert np.array_equal(np.asarray(i1), np.asarray(i0))
        assert g1 == g0 == 1 and dst.size == 17 and dst.k == _K
        out = str(tmp_path / "again")
        dst.snapshot(out)
    finally:
        dst.close()
    with np.load(os.path.join(out, "corpus.npz")) as z:
        assert z["emb"].tobytes() == np.concatenate([boot, grow]).tobytes()
    jax_snapshot(str(tmp_path / "direct"), np.concatenate([boot, grow]),
                 generation=1, k=_K, source="live_index")
    for name in ("corpus.npz",):
        with np.load(os.path.join(out, name)) as a, \
                np.load(str(tmp_path / "direct" / name)) as b:
            assert a["emb"].tobytes() == b["emb"].tobytes()


# ---------------------------------------------------------------------------
# row shards over a group
# ---------------------------------------------------------------------------

def test_row_shards_over_a_gloo_pair_rank_as_one_shard(tmp_path):
    rng = np.random.default_rng(41)
    chunks = [12, 9, 30]
    full = _tied_corpus(rng, sum(chunks))
    queries = rng.standard_normal((6, _DIM)).astype(np.float32)
    runs = worker.spawn(worker.live_index_group_cases, 2, tmp_path, full,
                        chunks, queries, _K)
    size = 0
    for gen, n in enumerate(chunks):
        size += n
        want = _numpy_ranking(full[:size], queries, _K)
        for rank, got in enumerate(runs):
            idx, g, shard_rows = got[gen]
            assert g == gen, (rank, gen)
            assert np.array_equal(idx, want), (rank, gen)
            assert shard_rows == live_index.shard_rung(size, 2, _K)


# ---------------------------------------------------------------------------
# the hammer, under the lock sanitizer
# ---------------------------------------------------------------------------

def test_live_index_hammer_subprocess_under_sanitizer():
    env = dict(os.environ, MILNCE_LOCK_SANITIZE="1",
               PYTHONPATH=os.pathsep.join(
                   [ROOT] + os.environ.get("PYTHONPATH", "").split(
                       os.pathsep)))
    env.pop("MILNCE_FAULTS", None)
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tests", "torch_dist_worker.py"),
         "live_index_hammer"], capture_output=True, text=True, timeout=300,
        env=env)
    assert proc.returncode == 0, (
        f"live-index hammer failed\nstdout:\n{proc.stdout}\n"
        f"stderr:\n{proc.stderr}")
    assert "HAMMER_OK" in proc.stdout
