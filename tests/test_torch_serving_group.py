"""Port parity, serving over a device group: ``InferenceEngine``,
``DeviceRetrievalIndex``, ``LiveRetrievalIndex`` and
``ReplicaPool.partition_devices`` of ``milnce_tpu_torch/serving/`` over
a group of devices in one process, against the JAX package serving over
a mesh of conftest's virtual CPU devices.

- The group engine's ladder and ``bucket_for`` equal a JAX engine's over
  a mesh of the same size; ``partition_devices`` groups as JAX's does.
- ``embed_text`` / ``embed_video`` over ``["cpu"] * 4`` at every bucket,
  1 row padded to 4 included, equal the JAX engine's over a 4-device
  mesh and the port's one-device engine's at rtol 1e-5, atol 1e-6.
- ``DeviceRetrievalIndex`` over the group returns JAX's ids on the same
  mesh and a float64 ranking exactly, ties across the k-th place and
  across a shard boundary included; scores within 1e-5.
- ``LiveRetrievalIndex`` over the group ingests across rungs and ranks
  as JAX's live index on the mesh and the port's one-shard index at
  every generation; a query thread asking while each swap is staged
  (every card's copy slowed) gets answers of one generation only.
- The fault sites fire once a group call; ``kill()`` kills the group; a
  card that is not there is refused before anything loads, and a device
  group with a process group of one rank serves as the device group
  alone.

Weights: the tiny model's state drawn from a numpy seed, carried to the
JAX package through ``utils/torch_convert.py``.
"""

import threading
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
from jax.sharding import Mesh

from milnce_tpu.config import ModelConfig as JaxModelConfig
from milnce_tpu.models.build import build_model as jax_build_model
from milnce_tpu.serving import live_index as jax_live
from milnce_tpu.serving.engine import InferenceEngine as JaxEngine
from milnce_tpu.serving.index import DeviceRetrievalIndex as JaxIndex
from milnce_tpu.serving.pool import ReplicaPool as JaxPool
from milnce_tpu_torch.config import ModelConfig
from milnce_tpu_torch.models.build import build_model
from milnce_tpu_torch.resilience import faults
from milnce_tpu_torch.serving.engine import InferenceEngine, ReplicaDead
from milnce_tpu_torch.serving.index import DeviceRetrievalIndex
from milnce_tpu_torch.serving.live_index import LiveRetrievalIndex, shard_rung
from milnce_tpu_torch.serving.pool import ReplicaPool
from milnce_tpu_torch.utils.torch_convert import torch_state_dict_to_flax

torch.set_num_threads(1)         # six test workers share the cores

RTOL, ATOL = 1e-5, 1e-6
GROUP = ["cpu"] * 4
_FRAMES, _SIZE, _WORDS, _VOCAB = 4, 32, 6, 64
_VIDEO = (_FRAMES, _SIZE, _SIZE, 3)
_MODEL = dict(embedding_dim=16, vocab_size=_VOCAB, word_embedding_dim=8,
              text_hidden_dim=16, inception_blocks=1)
_DIM, _K = 16, 5


def _mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("data",))


def _seeded_state(model, seed):
    """Every float leaf of ``model``'s state drawn from a numpy seed:
    weights at 1/sqrt(fan-in), BatchNorm scales near 1, statistics near
    (0, 1)."""
    rng = np.random.default_rng(seed)
    state = {}
    for key, ref in model.state_dict().items():
        shape = tuple(ref.shape)
        if not ref.is_floating_point():
            state[key] = ref.numpy()
        elif key.endswith("running_var"):
            state[key] = rng.random(shape) + 0.5
        elif key.endswith("running_mean") or len(shape) < 2:
            state[key] = 0.1 * rng.standard_normal(shape)
            if key.endswith(".weight"):
                state[key] += 1.0
        else:
            fan_in = int(np.prod(shape[1:]))
            state[key] = rng.standard_normal(shape) / np.sqrt(fan_in)
        state[key] = np.asarray(state[key], ref.numpy().dtype)
    return state


@pytest.fixture(scope="module")
def stack():
    model = build_model(ModelConfig(**_MODEL), seed=0)
    variables = torch_state_dict_to_flax(_seeded_state(model, 7))
    kw = dict(text_words=_WORDS, video_shape=_VIDEO, max_batch=16)
    group = InferenceEngine(model, variables, device=GROUP, **kw)
    one = InferenceEngine(build_model(ModelConfig(**_MODEL), seed=1),
                          variables, device="cpu", **kw)
    jx = JaxEngine(jax_build_model(JaxModelConfig(**_MODEL)), variables,
                   _mesh(len(GROUP)), precompile=False, **kw)
    return dict(group=group, one=one, jax=jx, variables=variables)


def _numpy_ranking(emb, queries, k):
    sim = queries.astype(np.float64) @ emb.astype(np.float64).T
    return np.argsort(-sim, axis=1, kind="stable")[:, :k]


def _tied_corpus(rng, n):
    """``n`` rows drawn from n // 3 distinct ones: every score ties with a
    few others, in other shards too."""
    distinct = rng.standard_normal((max(1, n // 3), _DIM)).astype(np.float32)
    return distinct[rng.integers(0, len(distinct), n)]


def _ties_at_k(emb, queries, k, rows):
    """(ties across the k-th place, of them across a shard boundary of
    ``rows`` rows a shard) in the float64 ranking."""
    sim = queries.astype(np.float64) @ emb.astype(np.float64).T
    order = np.argsort(-sim, axis=1, kind="stable")
    across = boundary = 0
    for q, o in enumerate(order):
        if sim[q, o[k - 1]] == sim[q, o[k]]:
            across += 1
            boundary += o[k - 1] // rows != o[k] // rows
    return across, boundary


# ---------------------------------------------------------------------------
# the engine over a group
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
@pytest.mark.parametrize("min_bucket,max_batch", [(0, 16), (3, 16), (8, 32)])
def test_group_ladder_and_bucket_for_equal_a_jax_engine(stack, n_dev,
                                                        min_bucket,
                                                        max_batch):
    kw = dict(text_words=_WORDS, video_shape=_VIDEO, max_batch=max_batch,
              min_bucket=min_bucket, precompile=False)
    port = InferenceEngine(build_model(ModelConfig(**_MODEL), seed=0),
                           device=["cpu"] * n_dev, **kw)
    jx = JaxEngine(jax_build_model(JaxModelConfig(**_MODEL)),
                   stack["variables"], _mesh(n_dev), **kw)
    assert port.buckets == jx.buckets
    assert len(port.models) == n_dev
    assert len({id(m) for m in port.models}) == n_dev
    for n in range(1, max_batch + 2):
        try:
            want = jx.bucket_for(n)
        except ValueError:
            with pytest.raises(ValueError):
                port.bucket_for(n)
            continue
        assert port.bucket_for(n) == want, n


@pytest.mark.parametrize("n", [1, 3, 4, 6, 8, 13, 16])
def test_group_embeddings_equal_jax_and_one_device(stack, n):
    """Both entries at every bucket of the (4, 8, 16) ladder, 1 row padded
    to 4 included: the group engine equals the JAX engine over a 4-device
    mesh and the port's one-device engine."""
    rng = np.random.default_rng(100 + n)
    ids = rng.integers(1, _VOCAB, (n, _WORDS)).astype(np.int32)
    clips = rng.integers(0, 256, (n,) + _VIDEO, dtype=np.uint8)
    group, one, jx = stack["group"], stack["one"], stack["jax"]
    assert group.buckets == (4, 8, 16)
    for entry, rows in (("embed_text", ids), ("embed_video", clips)):
        got = getattr(group, entry)(rows)
        assert got.shape == (n, _DIM) and got.dtype == np.float32
        want = np.asarray(getattr(jx, entry)(rows))
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                   err_msg=entry)
        np.testing.assert_allclose(got, getattr(one, entry)(rows),
                                   rtol=RTOL, atol=ATOL, err_msg=entry)
    assert group.recompiles() == 0


def test_fault_sites_fire_once_a_group_call_and_kill_kills_the_group():
    model = build_model(ModelConfig(**_MODEL), seed=0)
    eng = InferenceEngine(model, device=GROUP, text_words=_WORDS,
                          video_shape=_VIDEO, max_batch=8)
    ids = np.ones((5, _WORDS), np.int32)
    clean = eng.embed_text(ids)
    # a site checked a shard at a time would fire inside the first call
    with faults.armed("serve.dispatch_raise@2"):
        np.testing.assert_array_equal(eng.embed_text(ids), clean)
        with pytest.raises(faults.InjectedFault):
            eng.embed_text(ids)
        np.testing.assert_array_equal(eng.embed_text(ids), clean)
    calls = eng.stats()["calls"]
    with faults.armed("serve.replica_dead@2"):
        eng.embed_text(ids)
        with pytest.raises(ReplicaDead, match="injected"):
            eng.embed_text(ids)
    assert eng.dead and eng.stats()["dead"]
    for entry, rows in (("embed_text", ids),
                        ("embed_video", np.zeros((1,) + _VIDEO, np.uint8))):
        with pytest.raises(ReplicaDead, match="restart"):
            getattr(eng, entry)(rows)
    assert eng.stats()["calls"]["text@8"] == calls["text@8"] + 1


def test_missing_cards_and_two_groups_are_refused(tmp_path):
    missing = f"cuda:{torch.cuda.device_count()}"
    card_error = "no CUDA device is visible|CUDA devices are visible"
    # before anything loads: the export directory does not exist
    with pytest.raises(RuntimeError, match=card_error):
        InferenceEngine.from_export(str(tmp_path / "absent"),
                                    device=["cpu", missing])
    with pytest.raises(RuntimeError, match=card_error):
        ReplicaPool.from_export(str(tmp_path / "absent"), 1,
                                devices=[missing, missing])
    for cls in (DeviceRetrievalIndex, LiveRetrievalIndex):
        with pytest.raises(RuntimeError, match=card_error):
            cls(np.ones((8, _DIM), np.float32), k=2, device=[missing])
    with pytest.raises(ValueError, match="empty device group"):
        DeviceRetrievalIndex(np.ones((8, _DIM), np.float32), k=2, device=[])
    with pytest.raises(ValueError, match="mixes device types"):
        DeviceRetrievalIndex(np.ones((8, _DIM), np.float32), k=2,
                             device=["cpu", "meta"])
    # a device group together with a process group is a grid, and serves
    # (tests/test_torch_serving_hosts.py holds it over two ranks)
    emb = np.random.default_rng(0).standard_normal((8, _DIM)).astype(
        np.float32)
    want = DeviceRetrievalIndex(emb, k=2, device="cpu").topk(emb[:3])[1]
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        for cls in (DeviceRetrievalIndex, LiveRetrievalIndex):
            idx = cls(emb, k=2, device=["cpu"] * 2, group=dist.group.WORLD)
            try:
                assert idx.grid.extent == 2 and idx.grid.shards == [0, 1]
                assert np.array_equal(idx.topk(emb[:3])[1], want)
            finally:
                getattr(idx, "close", lambda: None)()
        one = DeviceRetrievalIndex(emb, k=2, device="cpu",
                                   group=dist.group.WORLD)
        assert np.array_equal(one.topk(emb[:3])[1], want)
        eng = InferenceEngine(build_model(ModelConfig(**_MODEL), seed=0),
                              device=["cpu"] * 2, text_words=_WORDS,
                              video_shape=_VIDEO, max_batch=4,
                              process_group=dist.group.WORLD)
        alone = InferenceEngine(build_model(ModelConfig(**_MODEL), seed=0),
                                device=["cpu"] * 2, text_words=_WORDS,
                                video_shape=_VIDEO, max_batch=4)
        ids = np.arange(3 * _WORDS, dtype=np.int32).reshape(3, _WORDS) % 60
        assert eng.buckets == alone.buckets == (2, 4)
        np.testing.assert_allclose(eng.embed_text(ids),
                                   alone.embed_text(ids), rtol=0, atol=0)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("n_devices", [1, 2, 3, 4, 6, 8])
def test_partition_devices_groups_as_jax(monkeypatch, n_devices):
    """On cards (JAX on an accelerator backend): even contiguous groups,
    an uneven split and more replicas than devices refused; on the CPU
    one device a replica, as the JAX CPU backend."""
    cards = [f"cuda:{i}" for i in range(n_devices)]
    cpus = ["cpu"] * n_devices
    for n in range(1, n_devices + 2):
        with monkeypatch.context() as m:
            m.setattr(jax, "default_backend", lambda: "gpu")
            try:
                want = JaxPool.partition_devices(cards, n)
            except ValueError:
                with pytest.raises(ValueError):
                    ReplicaPool.partition_devices(cards, n)
            else:
                assert ReplicaPool.partition_devices(cards, n) == want
        try:
            want = JaxPool.partition_devices(cpus, n)
        except ValueError:
            with pytest.raises(ValueError):
                ReplicaPool.partition_devices(cpus, n)
        else:
            assert ReplicaPool.partition_devices(cpus, n) == want


# ---------------------------------------------------------------------------
# the indexes over a group
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size,k", [(22, _K), (40, 3), (9, 4)])
def test_group_index_equals_jax_and_numpy(size, k):
    rng = np.random.default_rng(size)
    emb = _tied_corpus(rng, size)
    queries = rng.standard_normal((8, _DIM)).astype(np.float32)
    rows = max(-(-size // len(GROUP)), k)
    across, boundary = _ties_at_k(emb, queries, k, rows)
    assert across >= 2 and boundary >= 1, (across, boundary)
    port = DeviceRetrievalIndex(emb, k=k, query_buckets=(8,), device=GROUP)
    assert [c.shape[0] for c, _, _ in port._shards] == [rows] * len(GROUP)
    s, i = port.topk(queries)
    js, ji = JaxIndex(_mesh(len(GROUP)), emb, k=k,
                      query_buckets=(8,)).topk(queries)
    assert np.array_equal(i, np.asarray(ji))
    assert np.array_equal(i, _numpy_ranking(emb, queries, k))
    np.testing.assert_allclose(s, np.asarray(js), rtol=1e-5, atol=1e-5)
    one = DeviceRetrievalIndex(emb, k=k, query_buckets=(8,), device="cpu")
    assert np.array_equal(i, one.topk(queries)[1])
    assert port.recompiles() == 0


def test_group_live_index_ranks_as_jax_and_one_shard_across_rungs():
    """Boot 6 rows, ingest 5, 8, 20 and 30 (8, 8, 8, 16 and 32 rows a
    card on 4 cards at k = 5: two rung crossings): at every generation
    the group's top-k is JAX's live index's on a 4-device mesh, the
    port's one-shard index's and a float64 ranking's."""
    rng = np.random.default_rng(5)
    chunks = [6, 5, 8, 20, 30]
    full = _tied_corpus(rng, sum(chunks))
    queries = rng.standard_normal((6, _DIM)).astype(np.float32)
    kw = dict(k=_K, query_buckets=(8,))
    group = LiveRetrievalIndex(full[:chunks[0]], device=GROUP, **kw)
    one = LiveRetrievalIndex(full[:chunks[0]], device="cpu", **kw)
    jx = jax_live.LiveRetrievalIndex(_mesh(len(GROUP)), full[:chunks[0]],
                                     **kw)
    rungs, crossed = set(), 0
    try:
        size = chunks[0]
        for gen, n in enumerate([0] + chunks[1:]):
            if n:
                for idx in (group, one, jx):
                    idx.add(full[size:size + n])
                    assert idx.flush(10.0)
                size += n
            s, i, g = group.topk_with_gen(queries)
            js, ji, jg = jx.topk_with_gen(queries)
            assert g == jg == gen
            assert np.array_equal(i, np.asarray(ji)), gen
            np.testing.assert_allclose(s, np.asarray(js), rtol=1e-5,
                                       atol=1e-5)
            assert np.array_equal(i, one.topk(queries)[1]), gen
            assert np.array_equal(i, _numpy_ranking(full[:size], queries,
                                                    _K)), gen
            st = group.stats()
            assert st["shard_rows"] == jx.stats()["shard_rows"] == \
                shard_rung(size, len(GROUP), _K)
            assert st["capacity"] == jx.stats()["capacity"]
            rungs.add(st["shard_rows"])
            crossed += _ties_at_k(full[:size], queries, _K,
                                  st["shard_rows"])[0]
        assert rungs == {8, 16, 32}
        assert crossed >= 2, "no tie crossed the k-th place"
        assert group.recompiles() == 0
    finally:
        for idx in (group, one, jx):
            idx.close()


def test_no_query_mixes_generations_while_a_swap_is_staged():
    """Every card's copy of a generation is slowed, and a query thread
    asks all the while: each answer equals the float64 ranking of the
    generation it reports, so no answer read one card's shard at one
    generation and another card's at another."""
    rng = np.random.default_rng(9)
    chunks = [8, 4, 9, 15, 20]
    q = rng.standard_normal((3, _DIM)).astype(np.float32)
    # each chunk's rows score above every earlier one's, so each
    # generation's top-k is new and a torn generation would show
    full = np.concatenate([
        rng.standard_normal((n, _DIM)).astype(np.float32) + 3.0 * g * q[0]
        for g, n in enumerate(chunks)])
    sizes = np.cumsum(chunks)
    want = {g: _numpy_ranking(full[:sizes[g]], q, 3)
            for g in range(len(chunks))}
    idx = LiveRetrievalIndex(full[:chunks[0]], k=3, query_buckets=(4,),
                             device=GROUP)
    copying = threading.Event()
    copy_shard = idx._copy_shard

    def slow_copy(*args):
        copying.set()
        try:
            time.sleep(0.01)
            return copy_shard(*args)
        finally:
            copying.clear()

    idx._copy_shard = slow_copy
    answers, stop = [], threading.Event()

    def ask():
        while not stop.is_set():
            staged = copying.is_set()
            _, rows, gen = idx.topk_with_gen(q)
            answers.append((gen, rows, staged))

    asker = threading.Thread(target=ask, daemon=True)
    asker.start()
    try:
        for g in range(1, len(chunks)):
            idx.add(full[sizes[g - 1]:sizes[g]])
            assert idx.flush(10.0)
            time.sleep(0.01)
    finally:
        stop.set()
        asker.join(10.0)
        idx.close()
    assert not asker.is_alive()
    assert {gen for gen, _, _ in answers} == set(want)
    assert sum(staged for *_, staged in answers) >= len(chunks) - 1
    for gen, rows, _ in answers:
        assert np.array_equal(rows, want[gen]), gen
