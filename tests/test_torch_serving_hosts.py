"""Port parity, serving over a process group of device groups (a grid):
``InferenceEngine``, ``DeviceRetrievalIndex`` and ``LiveRetrievalIndex``
of ``milnce_tpu_torch/serving/`` on two gloo ranks of ``["cpu", "cpu"]``
each, against the JAX package serving on a mesh of four of conftest's
virtual CPU devices (the mesh a two-process, two-device JAX run would
span), and ``milnce-serve-torch`` over two ranks against one process.

- The grid engine's ladder equals a JAX engine's over a 4-device mesh;
  both entries at every bucket equal the JAX engine's and the port's
  one-device engine's at rtol 1e-5, atol 1e-6 (the tolerances of
  ``tests/test_torch_serving_group.py``).
- ``DeviceRetrievalIndex`` over the grid returns the JAX index's rows
  and a float64 ranking's exactly, where a rank's last shards hold only
  pad rows and with ties planted across the k-th place across a device
  boundary and across a rank boundary; scores within 1e-5.
- ``LiveRetrievalIndex`` over the grid crosses rungs; every rank reports
  the generation and rows of the JAX live index, driven by every rank,
  and under ``serving/lockstep.py`` with rank 0 ingesting alone.
- A grid of unequal device groups is refused; ``rank_cards`` splits a
  host's cards evenly and refuses what does not split.
- ``milnce-serve-torch`` on two ranks (the coordinator knobs): rank 0's
  front answers as a one-process service on the same export and corpus,
  a live index crossing a rung included; every rank boots from rank 0's
  snapshot when only rank 0's host holds one; SIGTERM on rank 0 ends both
  ranks with 0 after one snapshot; a killed follower makes rank 0's
  call fail within ``parallel.group_timeout_s``; a replica pool over
  ranks is refused.

The ranks import torch and the port only (``tests/torch_dist_worker.py``,
one torch thread a rank).
"""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh

import torch_dist_worker as worker
from milnce_tpu.config import ModelConfig as JaxModelConfig
from milnce_tpu.models.build import build_model as jax_build_model
from milnce_tpu.serving import live_index as jax_live
from milnce_tpu.serving.engine import InferenceEngine as JaxEngine
from milnce_tpu.serving.index import DeviceRetrievalIndex as JaxIndex
from milnce_tpu_torch.config import ModelConfig
from milnce_tpu_torch.models.build import build_model
from milnce_tpu_torch.parallel import devices as port_devices
from milnce_tpu_torch.serving.engine import InferenceEngine
from milnce_tpu_torch.serving.export import (export_corpus_snapshot,
                                             export_inference_checkpoint)
from milnce_tpu_torch.serving.live_index import LiveRetrievalIndex, shard_rung
from milnce_tpu_torch.utils.torch_convert import torch_state_dict_to_flax
from test_torch_serving_group import _seeded_state

torch.set_num_threads(1)         # six test workers share the cores

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-5, 1e-6
WORLD, G = 2, 2                  # two ranks of ["cpu", "cpu"]
_FRAMES, _SIZE, _WORDS, _VOCAB = 4, 32, 6, 64
_VIDEO = (_FRAMES, _SIZE, _SIZE, 3)
_MODEL = dict(embedding_dim=16, vocab_size=_VOCAB, word_embedding_dim=8,
              text_hidden_dim=16, inception_blocks=1)
_DIM = 16
_ENGINE = dict(text_words=_WORDS, video_shape=_VIDEO, max_batch=16)
_LADDERS = [(0, 16), (3, 16), (8, 32), (1, 4)]
_ROWS = [1, 3, 4, 6, 8, 13, 16]
# (size, k, plants): a rank's last shards only pad rows at (5, 3) (both
# of rank 1's) and (9, 4) (its last); ties planted across the k-th place
# across a device boundary and across a rank boundary at (22, 5), (40, 3)
_INDEX = [(5, 3, ()), (9, 4, ()), (22, 5, ("device", "rank")),
          (40, 3, ("rank", "device", "rank"))]


def _mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("data",))


def _numpy_ranking(emb, queries, k):
    sim = queries.astype(np.float64) @ emb.astype(np.float64).T
    return np.argsort(-sim, axis=1, kind="stable")[:, :k]


def _place(row, rows):
    """(rank, device) of a corpus row at ``rows`` rows a shard."""
    return divmod(row // rows, G)


def _plant(emb, queries, k, plants):
    """For query j and ``plants[j]`` ('device' or 'rank'): copy the
    query's k-th row onto another row one device (same rank) or one rank
    away, outside the planted queries' top k + 1 and the earlier plants,
    so that the two tie across the k-th place there.  Returns the
    planted corpus."""
    emb = emb.copy()
    rows = max(-(-len(emb) // (WORLD * G)), k)
    planted = set()
    for j, where in enumerate(plants):
        order = _numpy_ranking(emb, queries[:len(plants)], k + 1)
        taken = set(order.ravel()) | planted
        r = int(order[j, k - 1])
        rank, dev = _place(r, rows)
        for p in range(len(emb)):
            pr, pd = _place(p, rows)
            other = (pr == rank and pd != dev) if where == "device" \
                else pr != rank
            if other and p not in taken:
                emb[p] = emb[r]
                planted |= {p, r}
                break
        else:
            raise AssertionError(f"no row to plant {where} for query {j}")
    return emb


def _ties_at_k(emb, queries, k):
    """{'device', 'rank'}: the boundaries some tie across the k-th place
    crosses in the float64 ranking."""
    rows = max(-(-len(emb) // (WORLD * G)), k)
    sim = queries.astype(np.float64) @ emb.astype(np.float64).T
    order = np.argsort(-sim, axis=1, kind="stable")
    seen = set()
    for q, o in enumerate(order):
        for a in range(k):
            if sim[q, o[a]] == sim[q, o[k]]:
                (ra, da), (rb, db) = _place(o[a], rows), _place(o[k], rows)
                if ra != rb:
                    seen.add("rank")
                elif da != db:
                    seen.add("device")
    return seen


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    model = build_model(ModelConfig(**_MODEL), seed=0)
    variables = torch_state_dict_to_flax(_seeded_state(model, 7))
    rng = np.random.default_rng(26)
    engine_rows = {n: (rng.integers(1, _VOCAB, (n, _WORDS)).astype(np.int32),
                       rng.integers(0, 256, (n,) + _VIDEO, dtype=np.uint8))
                   for n in _ROWS}
    index_cases = []
    for size, k, plants in _INDEX:
        emb = rng.standard_normal((size, _DIM)).astype(np.float32)
        queries = rng.standard_normal((8, _DIM)).astype(np.float32)
        index_cases.append((_plant(emb, queries, k, plants), queries, k))
    # each chunk's rows score above every earlier one's, so a query that
    # read one rank's shards at another generation would show
    chunks = [6, 5, 9, 20, 30]
    q = rng.standard_normal((6, _DIM)).astype(np.float32)
    full = np.concatenate([
        rng.standard_normal((n, _DIM)).astype(np.float32) + 2.0 * g * q[0]
        for g, n in enumerate(chunks)])
    live = (full, chunks, q, 5)
    runs = worker.spawn(worker.serving_grid_cases, WORLD,
                        tmp_path_factory.mktemp("grid"), _MODEL, variables,
                        _ENGINE, _LADDERS, engine_rows, index_cases, live,
                        live + (60.0,))
    return dict(runs=runs, variables=variables, engine_rows=engine_rows,
                index_cases=index_cases, live=live)


# ---------------------------------------------------------------------------
# the engine over the grid
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", range(len(_LADDERS)))
def test_grid_ladder_equals_a_jax_engine_over_the_mesh(grid, case):
    min_bucket, max_batch = _LADDERS[case]
    jx = JaxEngine(jax_build_model(JaxModelConfig(**_MODEL)),
                   grid["variables"], _mesh(WORLD * G), precompile=False,
                   **dict(_ENGINE, min_bucket=min_bucket,
                          max_batch=max_batch))
    for run in grid["runs"]:
        assert run["ladders"][case] == jx.buckets


@pytest.fixture(scope="module")
def references(grid):
    variables = grid["variables"]
    jx = JaxEngine(jax_build_model(JaxModelConfig(**_MODEL)), variables,
                   _mesh(WORLD * G), precompile=False, **_ENGINE)
    one = InferenceEngine(build_model(ModelConfig(**_MODEL), seed=1),
                          variables, device="cpu", **_ENGINE)
    return jx, one


@pytest.mark.parametrize("n", _ROWS)
def test_grid_embeddings_equal_jax_and_one_device(grid, references, n):
    """Both entries at every bucket of the (4, 8, 16) ladder, 1 row padded
    to 4 included: every rank returns the whole bucket, equal to the JAX
    engine's over a 4-device mesh and the port's one-device engine's."""
    jx, one = references
    ids, clips = grid["engine_rows"][n]
    for run in grid["runs"]:
        for entry, rows, got in zip(("embed_text", "embed_video"),
                                    (ids, clips), run["engine"][n]):
            assert got.shape == (n, _DIM) and got.dtype == np.float32
            np.testing.assert_allclose(
                got, np.asarray(getattr(jx, entry)(rows)), rtol=RTOL,
                atol=ATOL, err_msg=entry)
            np.testing.assert_allclose(got, getattr(one, entry)(rows),
                                       rtol=RTOL, atol=ATOL, err_msg=entry)
    assert np.array_equal(grid["runs"][0]["engine"][n][0],
                          grid["runs"][1]["engine"][n][0])


# ---------------------------------------------------------------------------
# the indexes over the grid
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", range(len(_INDEX)))
def test_grid_index_equals_jax_and_numpy(grid, case):
    emb, queries, k = grid["index_cases"][case]
    size, _, plants = _INDEX[case]
    assert _ties_at_k(emb, queries, k) >= set(plants)
    rows = max(-(-size // (WORLD * G)), k)
    js, ji = JaxIndex(_mesh(WORLD * G), emb, k=k,
                      query_buckets=(8,)).topk(queries)
    for rank, run in enumerate(grid["runs"]):
        got = run["index"][case]
        shards = [rank * G + d for d in range(G)]
        assert got["shards"] == shards and got["rows"] == [rows] * G
        assert got["valid"] == [max(0, min(size, (s + 1) * rows) - s * rows)
                                for s in shards]
        assert np.array_equal(got["idx"], np.asarray(ji)), rank
        assert np.array_equal(got["idx"], _numpy_ranking(emb, queries, k))
        np.testing.assert_allclose(got["scores"], np.asarray(js),
                                   rtol=1e-5, atol=1e-5)
        assert got["recompiles"] == 0
    if size < 3 * rows:                          # rank 1 holds pad rows only
        assert grid["runs"][1]["index"][case]["valid"][-1] == 0


def _jax_live_answers(live):
    full, chunks, queries, k = live
    jx = jax_live.LiveRetrievalIndex(_mesh(WORLD * G), full[:chunks[0]], k=k,
                                     query_buckets=(8,))
    out, size = [], chunks[0]
    try:
        for n in [0] + list(chunks[1:]):
            if n:
                jx.add(full[size:size + n])
                assert jx.flush(10.0)
                size += n
            _, idx, gen = jx.topk_with_gen(queries)
            out.append((np.asarray(idx), gen, jx.stats()["shard_rows"],
                        size))
    finally:
        jx.close()
    return out


@pytest.mark.parametrize("mode", ["every rank ingests", "lockstep"])
def test_grid_live_index_ranks_as_jax_across_rungs(grid, mode):
    """Boot 6 rows, ingest 5, 9, 20 and 30 (rungs 8, 8, 8, 16 and 32 rows
    a shard on 4 shards at k = 5): at every generation each rank's top-k
    is the JAX live index's on a 4-device mesh and the float64 ranking's,
    and each rank is at the JAX generation and rung; under the lockstep
    rank 0 ingests alone and the other rank replays its calls."""
    want = _jax_live_answers(grid["live"])
    full, _, queries, k = grid["live"]
    assert {w[2] for w in want} == {8, 16, 32}
    for rank, run in enumerate(grid["runs"]):
        if mode == "lockstep":
            st = run["lockstep"]
            assert (st["generation"], st["shard_rows"]) == want[-1][1:3]
            if rank:
                # per chunk: a query; past the boot: an ingest and a swap
                assert st["replayed"] == 3 * len(want) - 2
                continue
            assert st["closed"] and len(st["answers"]) == len(want)
            got = [(idx, gen, None) for idx, gen in st["answers"]]
        else:
            got = run["live"]
        for (idx, gen, rung), (j_idx, j_gen, j_rung, size) in zip(got, want):
            assert gen == j_gen, (rank, gen)
            assert np.array_equal(idx, j_idx), (rank, gen)
            assert np.array_equal(idx, _numpy_ranking(full[:size], queries,
                                                      k)), (rank, gen)
            assert rung in (None, j_rung, shard_rung(size, WORLD * G, k))


# ---------------------------------------------------------------------------
# the grid's refusals
# ---------------------------------------------------------------------------

def test_a_grid_of_unequal_device_groups_is_refused(grid):
    for run in grid["runs"]:
        assert "differ in size [2, 1]" in run["unequal"]


@pytest.mark.parametrize("visible,local_world,want", [
    (4, 2, [["cuda:0", "cuda:1"], ["cuda:2", "cuda:3"]]),
    (4, 1, [["cuda:0", "cuda:1", "cuda:2", "cuda:3"]]),
    (2, 2, [["cuda:0"], ["cuda:1"]]),
    (3, 2, None), (0, 1, None)])
def test_rank_cards_split_the_visible_cards_evenly(monkeypatch, visible,
                                                    local_world, want):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: visible > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: visible)
    for r in range(local_world):
        if want is None:
            with pytest.raises((ValueError, RuntimeError)):
                port_devices.rank_cards(r, local_world)
        else:
            assert port_devices.rank_cards(r, local_world) == want[r]
    with pytest.raises(ValueError, match="outside"):
        port_devices.rank_cards(local_world, local_world)


@pytest.mark.parametrize("num_devices", [None, 0, 1, 2])
def test_initialize_serving_joins_a_cpu_rank_and_checks_the_grid(
        tmp_path, monkeypatch, num_devices):
    """No group named: no group.  Named (the coordinator knobs, one
    process): a gloo rank of one CPU device; ``num_devices`` other than
    W x G refused before the group forms."""
    import torch.distributed as dist

    from milnce_tpu_torch.config import ParallelConfig
    from milnce_tpu_torch.parallel import dist as port_dist

    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    if num_devices is None:
        cfg = ParallelConfig(platform="cpu")
        assert not port_dist.names_a_group(cfg)
        ranks, devices = port_dist.initialize_serving(cfg)
        assert ranks.group is None and devices is None
        return
    cfg = ParallelConfig(coordinator_address=f"file://{tmp_path}/store",
                         num_processes=1, process_id=0, platform="cpu",
                         num_devices=num_devices, group_timeout_s=30)
    assert port_dist.names_a_group(cfg)
    if num_devices > 1:
        with pytest.raises(ValueError, match="1 ranks x 1 devices"):
            port_dist.initialize_serving(cfg)
        assert not dist.is_initialized()
        return
    ranks, devices = port_dist.initialize_serving(cfg)
    try:
        assert devices == ["cpu"] and (ranks.rank, ranks.world) == (0, 1)
        assert dist.get_backend(ranks.group) == "gloo"
    finally:
        ranks.close()


# ---------------------------------------------------------------------------
# milnce-serve-torch over two ranks
# ---------------------------------------------------------------------------

_CORPUS, _K, _MAX_BATCH = 50, 3, 8


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve")
    cfg = ModelConfig(**_MODEL)
    tree = torch_state_dict_to_flax(_seeded_state(build_model(cfg, seed=0),
                                                  11))
    export = export_inference_checkpoint(
        str(root / "export"), tree["params"], tree["batch_stats"], cfg,
        max_words=_WORDS, video_shape=_VIDEO)
    rng = np.random.default_rng(3)
    corpus = rng.standard_normal((_CORPUS, _DIM)).astype(np.float32)
    np.savez(root / "corpus.npz", emb=corpus)
    # 20 rows carry the live index from 32 to 64 rows a shard (2 shards)
    grow = rng.standard_normal((20, _DIM)).astype(np.float32)
    # a restart where only rank 0's host holds the snapshot (rank 0 alone
    # writes it): generation 1, the corpus and the grown rows
    export_corpus_snapshot(str(root / "snap-restart-rank0"),
                           np.concatenate([corpus, grow]), generation=1,
                           k=_K)
    return dict(root=root, export=export, corpus=corpus, grow=grow)


def _env():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + os.environ.get("PYTHONPATH", "").split(os.pathsep)),
        OMP_NUM_THREADS="1")
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                 "MILNCE_FAULTS"):
        env.pop(name, None)
    return env


def _launch(artifacts, tag, *extra, world=WORLD, snaps=None):
    """``milnce-serve-torch`` on ``world`` rank processes (the coordinator
    knobs over a FileStore), live index, port 0 -> (procs, logs); rank
    r's snapshot directory is ``snaps[r]`` (default one for the tag)."""
    root = artifacts["root"]
    store = root / f"store-{tag}"
    procs, logs = [], []
    for rank in range(world):
        log = root / f"{tag}-rank{rank}.log"
        snap = snaps[rank] if snaps else f"snap-{tag}"
        args = ["--preset", "tiny", "--parallel.platform", "cpu",
                "--serve.export_dir", artifacts["export"],
                "--serve.corpus_npz", str(root / "corpus.npz"),
                "--serve.port", "0", "--serve.max_batch", str(_MAX_BATCH),
                "--serve.topk", str(_K), "--serve.live_index", "true",
                "--serve.index_snapshot_dir", str(root / snap),
                "--parallel.coordinator_address", f"file://{store}",
                "--parallel.num_processes", str(world),
                "--parallel.process_id", str(rank)] + list(extra)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "milnce_tpu_torch.serving.service"]
            + args, stdout=open(log, "w"), stderr=subprocess.STDOUT,
            env=_env(), cwd=str(root)))
        logs.append(log)
    return procs, logs


def _base_url(procs, logs, timeout=120.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        text = logs[0].read_text()
        if "listening on" in text:
            return text.split("listening on ")[1].split()[0]
        if any(p.poll() is not None for p in procs):
            break
        time.sleep(0.1)
    for p in procs:
        p.kill()
    raise AssertionError("\n".join(log.read_text()[-3000:] for log in logs))


def _call(base, route, payload=None, timeout=60):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(base + route, data=data, headers={
        "Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture(scope="module")
def pairs(artifacts):
    """Three pairs booted side by side: ``healthy`` (the default
    timeout), ``fragile`` (``parallel.group_timeout_s`` 4) and
    ``restart`` (a snapshot in rank 0's directory only)."""
    booted = {"healthy": _launch(artifacts, "healthy"),
              "fragile": _launch(artifacts, "fragile",
                                 "--parallel.group_timeout_s", "4"),
              "restart": _launch(artifacts, "restart", snaps=[
                  "snap-restart-rank0", "snap-restart-rank1"])}
    try:
        yield {tag: (procs, logs, _base_url(procs, logs))
               for tag, (procs, logs) in booted.items()}
    finally:
        for procs, _ in booted.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait(10)


@pytest.fixture(scope="module")
def one_process(artifacts):
    """The one-process service on the same export and corpus, in this
    process: (RetrievalService, live index)."""
    from milnce_tpu_torch.obs import metrics as obs_metrics
    from milnce_tpu_torch.serving.service import RetrievalService

    engine = InferenceEngine.from_export(artifacts["export"], device="cpu",
                                         max_batch=_MAX_BATCH)
    index = LiveRetrievalIndex(artifacts["corpus"], k=_K,
                               query_buckets=engine.buckets, device="cpu")
    svc = RetrievalService(engine, index,
                           registry=obs_metrics.MetricsRegistry())
    yield svc, index
    svc.close()
    index.close()


def _ids(seed, n):
    return np.random.default_rng(seed).integers(
        1, _VOCAB, (n, _WORDS)).astype(np.int32)


def test_rank_0_front_answers_as_one_process(pairs, one_process,
                                             artifacts):
    """Queries of 1, 3, 5 and 8 rows (every bucket), an embed request,
    then an ingest that crosses a rung, then the queries again: rankings
    equal, scores and embeddings within rtol 1e-5, the same generation."""
    _, _, base = pairs["healthy"]
    svc, index = one_process
    for phase in range(2):
        if phase:
            code, body = _call(base, "/v1/index/add", {
                "embeddings": artifacts["grow"].tolist(), "wait": True})
            assert code == 200 and body["live"], body
            index.add(artifacts["grow"])
            assert index.flush(30.0)
            assert (body["generation"], body["size"]) == (
                index.generation, index.size) == (1, _CORPUS + 20)
        for n in (1, 3, 5, 8):
            ids = _ids(100 * phase + n, n)
            code, body = _call(base, "/v1/query", {"token_ids": ids.tolist()})
            assert code == 200, body
            scores, idx, gen = svc.query_ids_with_gen(ids)
            assert body["index_generation"] == gen == phase
            assert np.array_equal([r["indices"] for r in body["results"]],
                                  idx)
            np.testing.assert_allclose([r["scores"] for r in body["results"]],
                                       scores, rtol=1e-5, atol=1e-6)
    ids = _ids(7, 3)
    code, body = _call(base, "/v1/embed_text", {"token_ids": ids.tolist()})
    assert code == 200
    np.testing.assert_allclose(body["embeddings"], svc.embed_text_ids(ids),
                               rtol=RTOL, atol=ATOL)
    code, body = _call(base, "/healthz")
    assert code == 200 and body["engine"]["recompiles"] == 0
    assert body["index"]["shard_rows"] == 64
    assert body["index"]["capacity"] == 64 * WORLD


def test_every_rank_boots_from_rank_0s_snapshot(pairs, one_process,
                                                artifacts):
    """Rank 0's snapshot directory holds generation 1 (70 rows, 64 a
    shard); rank 1's holds none, so its own files alone would boot the
    50-row corpus at generation 0 and 32 rows a shard.  Both ranks boot
    rank 0's: the front ranks as a float64 ranking over the snapshot."""
    procs, logs, base = pairs["restart"]
    svc, _ = one_process
    grown = np.concatenate([artifacts["corpus"], artifacts["grow"]])
    for n in (1, 5, 8):
        ids = _ids(300 + n, n)
        code, body = _call(base, "/v1/query", {"token_ids": ids.tolist()})
        assert code == 200, body
        assert body["index_generation"] == 1
        assert np.array_equal(
            [r["indices"] for r in body["results"]],
            _numpy_ranking(grown, svc.embed_text_ids(ids), _K))
    code, body = _call(base, "/healthz")
    assert code == 200
    assert (body["index"]["generation"], body["index"]["size"],
            body["index"]["shard_rows"]) == (1, _CORPUS + 20, 64)
    procs[0].send_signal(signal.SIGTERM)
    assert [p.wait(60) for p in procs] == [0, 0], [
        log.read_text()[-2000:] for log in logs]


def test_sigterm_on_rank_0_ends_both_ranks_after_one_snapshot(
        pairs, artifacts):
    procs, logs, base = pairs["healthy"]
    assert _call(base, "/healthz")[0] == 200
    procs[0].send_signal(signal.SIGTERM)
    codes = [p.wait(60) for p in procs]
    assert codes == [0, 0], [log.read_text()[-2000:] for log in logs]
    with open(artifacts["root"] / "snap-healthy" / "index_meta.json") as fh:
        meta = json.load(fh)
    assert meta["generation"] == 1
    assert "closed after" in logs[1].read_text()


def test_a_killed_follower_fails_rank_0s_call_within_the_timeout(pairs):
    procs, logs, base = pairs["fragile"]
    assert _call(base, "/v1/query", {"token_ids": _ids(1, 2).tolist()}
                 )[0] == 200
    procs[1].kill()
    procs[1].wait(10)
    for seed in (2, 3):                       # cache misses: device calls
        t0 = time.monotonic()
        code, body = _call(base, "/v1/query",
                           {"token_ids": _ids(seed, 2).tolist()})
        assert code == 500 and "FollowerLost" in body["error"], body
        assert time.monotonic() - t0 < 4 + 2
    assert _call(base, "/healthz")[0] == 200   # the front stays up
    procs[0].send_signal(signal.SIGTERM)
    assert procs[0].wait(60) == 0


def test_a_replica_pool_over_ranks_is_refused(artifacts):
    procs, logs = _launch(artifacts, "pool", "--serve.replicas", "2",
                          world=1)
    assert procs[0].wait(120) != 0
    text = logs[0].read_text()
    assert "replica pool over a serving grid" in text
    assert "Queue A" in text
