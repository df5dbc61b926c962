"""Port parity, data parallelism over ``torch.distributed`` (gloo, CPU).

Each multi-rank case spawns its ranks from ``tests/torch_dist_worker.py``
(torch and the port only; a ``FileStore`` under the test's directory, a
60 s collective timeout and a join deadline, so a hung rank fails its
test); this process holds JAX and compares.  Inputs are numpy, seeded.

- The gather: value = ``torch.cat``, backward = the sum over the ranks
  of the cotangents' slices (W = 2, 4).
- Dense and chunked (plain stream) MIL-NCE at W = 2, 4, 8 against JAX
  ``milnce_loss(axis_name="data")`` under ``shard_map`` on a W-device
  mesh, with ``tests/test_milnce.py``'s tolerances (value rtol 1e-5,
  gradients atol 1e-6), and against the port's one-process dense loss
  on the concatenated batch; K = 2 and an uneven last chunk (chunk 5).
- The four DTW losses at W = 2 on the gathered batch against the
  one-process loss on the concatenated batch.
- Two steps at W = 2 with ``tests/test_torch_train.py``'s tolerances
  (float64, rtol 2e-4, atol 2e-5): local BatchNorm, and sync BatchNorm
  for MIL-NCE and for cdtw, against the JAX ``make_train_step`` on a
  2-device mesh; sync BatchNorm also against the port's one-process
  step on the concatenated batch (reduced gradients included); a rank
  with NaN gradients makes both ranks skip.
- ``run_training`` at W = 2: resume, checkpoint keys, a W = 2 checkpoint
  booting one process, rank 0 alone logging and evaluating; each rank's
  span stream and goodput ledger under one ``run_id`` (rank 0's,
  broadcast), merged alike by both packages' ``merge_event_streams``.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import torch_dist_worker as worker
from milnce_tpu.config import LossConfig as JaxLossConfig
from milnce_tpu.config import OptimConfig as JaxOptimConfig
from milnce_tpu.losses.milnce import milnce_loss as jax_milnce_loss
from milnce_tpu.models import S3D as JaxS3D
from milnce_tpu.parallel.compat import set_mesh, shard_map
from milnce_tpu.train.schedule import build_schedule as jax_build_schedule
from milnce_tpu.train.state import build_optimizer as jax_build_optimizer
from milnce_tpu.train.state import create_train_state
from milnce_tpu.train.step import make_train_step as jax_make_train_step
from milnce_tpu_torch.config import LossConfig, tiny_preset
from milnce_tpu_torch.data.pipeline import ShardedLoader
from milnce_tpu_torch.data.synthetic import SyntheticVideoTextSource
from milnce_tpu_torch.losses.milnce import milnce_loss
from milnce_tpu_torch.train import loop
from milnce_tpu_torch.train.checkpoint import CheckpointManager
from milnce_tpu_torch.train.step import _sequence_loss
from milnce_tpu_torch.utils.torch_convert import flax_to_torch_state_dict

torch.set_num_threads(1)         # six test workers share the cores

VALUE_RTOL, GRAD_ATOL = 1e-5, 1e-6           # tests/test_milnce.py
STEP_RTOL, STEP_ATOL = 2e-4, 2e-5            # tests/test_torch_train.py
B_LOCAL, D = 3, 16
MILNCE_CASES = {"k2": (2, 4), "uneven-chunk5": (5, 5)}   # name: (K, chunk)
DTW_LOSSES = ("cdtw", "sdtw_cidm", "sdtw_negative", "sdtw_3")


# ------------------------------------------------------------ loss cases
def _loss_inputs(world):
    rng = np.random.RandomState(100 + world)
    bg = B_LOCAL * world
    gather = (rng.randn(bg, D).astype(np.float32),
              rng.randn(world, bg, D).astype(np.float32))
    milnce = {name: (rng.randn(bg, D).astype(np.float32),
                     rng.randn(bg * k, D).astype(np.float32), chunk)
              for name, (k, chunk) in MILNCE_CASES.items()}
    dtw = {}
    if world == 2:
        for name in DTW_LOSSES:
            dtw[name] = (rng.randn(bg, 4, 8).astype(np.float32),
                         rng.randn(bg, 3, 8).astype(np.float32),
                         (rng.rand(bg) * 30).astype(np.float32))
    return gather, milnce, dtw


@pytest.fixture(scope="module")
def loss_runs(tmp_path_factory):
    """world -> (inputs, per-rank results); one spawn per world size."""
    cache = {}

    def get(world):
        if world not in cache:
            inputs = _loss_inputs(world)
            cache[world] = inputs, worker.spawn(
                worker.loss_cases, world,
                tmp_path_factory.mktemp(f"losses-w{world}"), *inputs)
        return cache[world]

    return get


def _jax_sharded(v, t, world):
    """JAX ``milnce_loss(axis_name='data')`` on a ``world``-device mesh:
    the value and each shard's gradients, concatenated."""
    mesh = Mesh(np.array(jax.devices()[:world]), ("data",))

    def local(vv, tt):
        value, grads = jax.value_and_grad(
            lambda a, b: jax_milnce_loss(a, b, axis_name="data"),
            argnums=(0, 1))(vv, tt)
        return (value,) + grads

    fn = jax.jit(shard_map(local, mesh=mesh, in_specs=(P("data"), P("data")),
                           out_specs=(P(), P("data"), P("data"))))
    with set_mesh(mesh):
        value, gv, gt = fn(jax.device_put(v, NamedSharding(mesh, P("data"))),
                           jax.device_put(t, NamedSharding(mesh, P("data"))))
    return float(value), np.asarray(gv), np.asarray(gt)


def _one_process(fn, *arrays):
    leaves = [torch.tensor(a, requires_grad=True) for a in arrays]
    loss = fn(*leaves)
    loss.backward()
    return (float(loss.detach()),) + tuple(x.grad.numpy() for x in leaves)


def _ranks_joined(results, key):
    """Every rank's (value, local grads...) -> the value (the same on
    every rank) and the gradients concatenated in rank order."""
    values = [r[key][0] for r in results]
    assert len(set(values)) == 1, values
    grads = zip(*(r[key][1:] for r in results))
    return (values[0],) + tuple(np.concatenate(g) for g in grads)


def _assert_loss(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=VALUE_RTOL)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, atol=GRAD_ATOL)


@pytest.mark.parametrize("world", [2, 4])
def test_gather_is_cat_and_its_backward_sums_the_ranks(world, loss_runs):
    (x, cots), _, _ = loss_runs(world)[0]
    results = loss_runs(world)[1]
    for rank, res in enumerate(results):
        gathered, grad = res["gather"]
        np.testing.assert_array_equal(gathered, x)
        rows = slice(rank * B_LOCAL, (rank + 1) * B_LOCAL)
        np.testing.assert_allclose(grad, cots[:, rows].sum(0), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("case", sorted(MILNCE_CASES))
@pytest.mark.parametrize("impl", ["dense", "chunked"])
@pytest.mark.parametrize("world", [2, 4, 8])
def test_milnce_over_ranks_matches_jax_sharded(world, impl, case, loss_runs):
    (_, milnce, _), results = loss_runs(world)
    v, t, _ = milnce[case]
    got = _ranks_joined(results, (impl, case))
    _assert_loss(got, _jax_sharded(v, t, world))
    # and the port's one-process dense loss on the concatenated batch
    _assert_loss(got, _one_process(milnce_loss, v, t))


@pytest.mark.parametrize("name", DTW_LOSSES)
def test_dtw_loss_over_ranks_matches_the_concatenated_batch(name, loss_runs):
    """The gathered batch is scored whole on every rank: the value is the
    one-process loss's.  That replicated loss's gradient reaches each
    rank once from every rank's copy, W times the one-process gradient;
    the step's MEAN reduction divides it out."""
    (_, _, dtw), results = loss_runs(2)
    v, t, start = dtw[name]
    want = _one_process(
        lambda a, b: _sequence_loss(LossConfig(name=name), a, b,
                                    torch.from_numpy(start)), v, t)
    got = _ranks_joined(results, ("dtw", name))
    _assert_loss((got[0],) + tuple(g / 2 for g in got[1:]), want)


# ------------------------------------------------------------ step parity
_DIMS = dict(num_classes=16, vocab_size=32, word_embedding_dim=8,
             text_hidden_dim=16, inception_blocks=1)
_BG, _K, _FRAMES, _SIZE, _WORDS = 4, 2, 4, 32, 5
_STEPS = 2


def _batches():
    out = []
    for i in range(_STEPS):
        rng = np.random.default_rng(50 + i)
        out.append((rng.integers(0, 255, (_BG, _FRAMES, _SIZE, _SIZE, 3),
                                 dtype=np.uint8),
                    rng.integers(0, 32, (_BG * _K, _WORDS)).astype(np.int32)))
    return out


def _variables():
    variables = JaxS3D(**_DIMS).init(
        jax.random.PRNGKey(0),
        jnp.zeros((2, _FRAMES, _SIZE, _SIZE, 3), jnp.float32),
        jnp.zeros((2 * _K, _WORDS), jnp.int32))
    return jax.tree_util.tree_map(np.asarray, variables)


def _jax_mesh_run(variables, batches, world, sync_bn=False, loss="milnce"):
    """The JAX step on a ``world``-device mesh in float64, with the loss
    named; BatchNorm local, or synced over the data axis (the JAX
    ``model.sync_batchnorm``, ``bn_axis_name='data'``)."""
    with jax.enable_x64(True):
        model = JaxS3D(dtype=jnp.float64,
                       bn_axis_name="data" if sync_bn else None, **_DIMS)
        opt_cfg = JaxOptimConfig(warmup_steps=2)
        opt = jax_build_optimizer(opt_cfg, jax_build_schedule(opt_cfg, 10))
        state = create_train_state(jax.tree_util.tree_map(
            lambda a: a.astype(np.float64), variables), opt)
        mesh = Mesh(np.array(jax.devices()[:world]), ("data",))
        step = jax_make_train_step(
            model, opt, mesh, donate=False,
            loss_cfg=JaxLossConfig(name=loss, milnce_impl="dense",
                                   sdtw_backend="scan"),
            finite_guard=True)
        losses = []
        for video, text in batches:
            state, loss, skipped = step(state, video, text,
                                        np.zeros((len(video),), np.float32))
            assert int(skipped) == 0
            losses.append(float(loss))
        sd = flax_to_torch_state_dict({
            "params": jax.tree_util.tree_map(np.asarray, state.params),
            "batch_stats": jax.tree_util.tree_map(np.asarray,
                                                  state.batch_stats)})
    return losses, sd


def _assert_state(got, want):
    keys = [k for k in want if not k.endswith("num_batches_tracked")]
    assert set(keys) == {k for k in got if not k.endswith(
        "num_batches_tracked")}
    for key in keys:
        np.testing.assert_allclose(got[key], want[key], STEP_RTOL, STEP_ATOL,
                                   err_msg=key)


def _same_on_every_rank(results):
    """The ranks hold one model: the reduced gradients, the same update
    and the merged statistics leave every tensor equal."""
    (l0, s0, st0, _), *rest = results
    for losses, skips, states, _ in rest:
        assert losses == l0 and skips == s0
        for key, val in st0[-1].items():
            np.testing.assert_array_equal(states[-1][key], val, err_msg=key)
    return results[0]


@pytest.fixture(scope="module")
def step_runs(tmp_path_factory):
    variables, batches = _variables(), _batches()
    work = tmp_path_factory.mktemp("steps")
    run = {name: worker.spawn(worker.step_run, 2, work, _DIMS, variables,
                              batches, sync_bn)
           for name, sync_bn in (("local", False), ("sync", True))}
    run["poisoned"] = worker.spawn(worker.step_run, 2, work, _DIMS, variables,
                                   batches, False, (1, 1))
    run["one"] = worker.spawn(worker.step_run, 1, work, _DIMS, variables,
                              batches, join_group=False)
    run["cdtw"] = worker.spawn(worker.step_run, 2, work, _DIMS, variables,
                               batches, True, None, "cdtw")
    run["cdtw-one"] = worker.spawn(worker.step_run, 1, work, _DIMS,
                                   variables, batches, False, None, "cdtw",
                                   join_group=False)
    return variables, batches, run


def test_step_with_local_batchnorm_matches_the_jax_mesh_step(step_runs):
    variables, batches, run = step_runs
    losses, skips, states, _ = _same_on_every_rank(run["local"])
    jl, jsd = _jax_mesh_run(variables, batches, 2)
    assert skips == [0] * _STEPS
    np.testing.assert_allclose(losses, jl, STEP_RTOL, STEP_ATOL)
    _assert_state(states[-1], jsd)


@pytest.mark.parametrize("run_name,loss", [("sync", "milnce"),
                                           ("cdtw", "cdtw")])
def test_step_with_sync_batchnorm_matches_the_jax_mesh_step(step_runs,
                                                            run_name, loss):
    """Sync BN and the DTW family across ranks against JAX itself: the
    JAX step on a 2-device mesh with ``bn_axis_name='data'``, MIL-NCE
    (psum of the gradients) and cdtw (the gathered batch, pmean)."""
    variables, batches, run = step_runs
    losses, skips, states, _ = _same_on_every_rank(run[run_name])
    jl, jsd = _jax_mesh_run(variables, batches, 2, sync_bn=True, loss=loss)
    assert skips == [0] * _STEPS
    np.testing.assert_allclose(losses, jl, STEP_RTOL, STEP_ATOL)
    _assert_state(states[-1], jsd)


def test_step_with_sync_batchnorm_matches_the_concatenated_batch(step_runs):
    """Sync BN makes the W = 2 step the one-process step on the rank-order
    concatenation of the shards, reduced gradients included (Adam's
    update hardly sees their scale, so a MEAN where MIL-NCE needs the
    SUM shows only there); local BN is another model."""
    _, _, run = step_runs
    losses, skips, states, grads = _same_on_every_rank(run["sync"])
    ol, osk, ost, ograds = run["one"][0]
    assert skips == osk == [0] * _STEPS
    np.testing.assert_allclose(losses, ol, STEP_RTOL, STEP_ATOL)
    _assert_state(states[-1], ost[-1])
    assert set(grads) == set(ograds)
    for name, want in ograds.items():
        np.testing.assert_allclose(grads[name], want, STEP_RTOL, STEP_ATOL,
                                   err_msg=name)
    local_losses = run["local"][0][0]
    assert not np.allclose(local_losses, ol, rtol=1e-3, atol=0)


def test_dtw_step_with_sync_batchnorm_matches_the_concatenated_batch(
        step_runs):
    """cdtw scores the gathered batch on every rank; the MEAN over the
    ranks makes its reduced gradients the one-process step's."""
    _, _, run = step_runs
    losses, skips, states, grads = _same_on_every_rank(run["cdtw"])
    ol, osk, ost, ograds = run["cdtw-one"][0]
    assert skips == osk == [0] * _STEPS
    np.testing.assert_allclose(losses, ol, STEP_RTOL, STEP_ATOL)
    _assert_state(states[-1], ost[-1])
    assert set(grads) == set(ograds)
    for name, want in ograds.items():
        np.testing.assert_allclose(grads[name], want, STEP_RTOL, STEP_ATOL,
                                   err_msg=name)


def test_one_rank_with_nan_gradients_makes_every_rank_skip(step_runs):
    _, _, run = step_runs
    losses, skips, states, _ = _same_on_every_rank(run["poisoned"])
    assert skips == [0, 1]
    for key, val in states[0].items():     # step 2 kept step 1's state
        np.testing.assert_array_equal(states[1][key], val, err_msg=key)


# ------------------------------------------------------------ run_training
def _run_cfg(root, label, steps, world, resume=False):
    cfg = tiny_preset()
    cfg.parallel.platform = "cpu"
    cfg.model.inception_blocks = 2
    cfg.data.synthetic_num_samples = 16      # 4 global batches an epoch
    cfg.optim.epochs = 2
    cfg.train.max_steps, cfg.train.resume = steps, resume
    cfg.train.checkpoint_root = str(root / label)
    cfg.train.log_root = str(root / f"log-{label}")
    cfg.parallel.coordinator_address = f"file://{root / ('store-' + label)}"
    cfg.parallel.num_processes = world
    return cfg


@pytest.fixture(scope="module")
def trainer_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("trainer")
    runs = [("whole", _run_cfg(root, "whole", 4, 2)),
            ("stopped", _run_cfg(root, "split", 2, 2)),
            ("resumed", _run_cfg(root, "split", 2, 2, resume=True)),
            ("eval", _run_cfg(root, "eval", 1, 2))]
    runs[2][1].parallel.coordinator_address += "-2"
    csv = root / "eval.csv"            # in-training retrieval, fake decoder
    csv.write_text("key,vid_key,video_id,sentence\n" + "".join(
        f"r{i},m{i},video{i},word{i} word{i + 1}\n" for i in range(3)))
    cfg = runs[3][1]
    cfg.train.evaluate, cfg.train.eval_task = True, "msrvtt"
    cfg.data.eval_csv, cfg.data.eval_video_root = str(csv), str(root)
    return root, worker.spawn(worker.train_runs, 2, root, runs,
                              join_group=False)


def test_run_training_at_two_ranks_resumes_as_the_whole_run(trainer_runs):
    _, (r0, r1) = trainer_runs
    for res in (r0, r1):
        assert sorted(res["whole"]["losses"]) == [1, 2, 3, 4]
        assert sorted(res["resumed"]["losses"]) == [3, 4]
        for s in (3, 4):
            np.testing.assert_allclose(res["resumed"]["losses"][s],
                                       res["whole"]["losses"][s], rtol=1e-6)
    assert r0["whole"]["losses"] == r1["whole"]["losses"]   # global loss
    assert "resumed from epoch 1 at batch 0" not in r0["resumed"]["lines"]
    assert "resumed from epoch 0 at batch 2" in r0["resumed"]["lines"]
    for key, val in r0["whole"]["state"].items():
        np.testing.assert_array_equal(r1["whole"]["state"][key], val)


def test_run_training_at_two_ranks_saves_plain_keys_and_boots_one_process(
        trainer_runs):
    """Rank 0's checkpoint holds the model's own ``state_dict`` keys (no
    wrapper prefix), and a one-process run resumes from it."""
    root, (r0, _) = trainer_runs
    ckpt = CheckpointManager(str(root / "whole" / "run"), create=False)
    assert ckpt.all_epochs() == [1]
    state = ckpt.restore(1)
    assert state["step"] == 4
    cfg = _run_cfg(root, "whole", 1, 1, resume=True)
    assert set(state["model"]) == set(loop.build_model(cfg.model).state_dict())
    assert not any(k.startswith("module.") for k in state["model"])
    for key, val in r0["whole"]["state"].items():
        np.testing.assert_array_equal(state["model"][key].numpy(), val)
    cfg.train.log_root = str(root / "log-boot")
    cfg.parallel.coordinator_address = None
    cfg.parallel.num_processes = None
    lines = []
    res = loop.run_training(cfg, log=lines.append)
    assert "resumed from epoch 1 at batch 0" in lines and res.steps == 1
    assert np.isfinite(res.last_loss)


def test_run_training_at_two_ranks_logs_on_rank_zero_only(trainer_runs):
    root, (r0, r1) = trainer_runs
    assert r1["whole"]["lines"] == [] and r1["whole"]["rank"] == 1
    lines = r0["whole"]["lines"]
    assert "process group: 2 ranks on gloo" in lines
    assert "MIL-NCE: dense cubes (B_local 2, Bg 4, K 1, D 512)" in lines
    # the run log is rank 0's; the span streams and ledgers every rank's
    assert sorted(os.listdir(root / "log-whole")) == [
        "GOODPUT.json", "GOODPUT.p1.json", "RUN_EVENTS.jsonl",
        "RUN_EVENTS.p1.jsonl", "run.jsonl", "run.log"]
    text = (root / "log-whole" / "run.log").read_text()
    assert text.count("Training loss:") == 4
    events = [json.loads(x) for x in
              (root / "log-whole" / "run.jsonl").read_text().splitlines()]
    assert [e["step"] for e in events] == [1, 2, 3, 4]
    np.testing.assert_allclose([e["loss"] for e in events],
                               [r0["whole"]["losses"][s] for s in range(1, 5)],
                               rtol=1e-6)


def test_run_training_at_two_ranks_streams_merge_under_one_run_id(
        trainer_runs):
    """Each rank writes its stream and ledger under rank 0's run_id (the
    broadcast), stamped with its rank; the port's and the JAX package's
    ``merge_event_streams`` merge the two streams alike (exact), and a
    stream of another run is refused."""
    from milnce_tpu.obs.aggregate import merge_event_streams as jax_merge
    from milnce_tpu_torch.obs.aggregate import merge_event_streams

    root, _ = trainer_runs
    streams = []
    for rank, name in enumerate(("RUN_EVENTS.jsonl", "RUN_EVENTS.p1.jsonl")):
        recs = [json.loads(x) for x in
                (root / "log-whole" / name).read_text().splitlines()]
        assert {r["process_index"] for r in recs} == {rank}
        assert [r["step"] for r in recs if r["name"] == "step"] == [1, 2, 3, 4]
        streams.append(recs)
    run_ids = {r["run_id"] for recs in streams for r in recs}
    assert len(run_ids) == 1
    merged = merge_event_streams(streams)
    assert merged == jax_merge(streams)
    assert merged["run_id"] in run_ids and merged["process_indices"] == [0, 1]
    for rank, name in enumerate(("GOODPUT.json", "GOODPUT.p1.json")):
        doc = json.loads((root / "log-whole" / name).read_text())
        assert doc["run_id"] in run_ids and doc["process_index"] == rank
        assert doc["steps"] == 4
    other = [dict(r, run_id="other") for r in streams[1]]
    with pytest.raises(ValueError, match="mixed-run merge refused"):
        merge_event_streams([streams[0], other])


def test_run_training_at_two_ranks_evaluates_on_rank_zero(trainer_runs):
    """``train.evaluate``: at epoch 0 each rank scores its share of the
    task and rank 0 alone logs the metrics; both then train the step."""
    _, (r0, r1) = trainer_runs
    shown = [m for m in r0["eval"]["lines"]
             if m.startswith("msrvtt retrieval: R@1: ")]
    assert len(shown) == 1 and r1["eval"]["lines"] == []
    assert r0["eval"]["steps"] == r1["eval"]["steps"] == 1
    assert r0["eval"]["losses"] == r1["eval"]["losses"]


# ------------------------------------------------------------ the loader
@pytest.mark.parametrize("world", [2, 4])
def test_sharded_loader_shards_reassemble_the_global_batch(world):
    cfg = tiny_preset()
    cfg.data.synthetic_num_samples = 24
    source = SyntheticVideoTextSource(cfg.data, vocab_size=cfg.model.vocab_size)
    whole = ShardedLoader(source, 8, seed=3, num_threads=2)
    shards = [ShardedLoader(source, 8, seed=3, num_threads=2,
                            process_index=p, process_count=world)
              for p in range(world)]
    got = [list(s.epoch(1)) for s in shards]
    want = list(whole.epoch(1))
    assert len(want) == 3 and all(len(g) == 3 for g in got)
    for i, batch in enumerate(want):
        for j, sample in enumerate(batch):       # rows p, p+W, ... of rank p
            mine = got[j % world][i][j // world]
            for key in sample:
                np.testing.assert_array_equal(mine[key], sample[key])
