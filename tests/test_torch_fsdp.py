"""Port parity, the 2-D ``(data, model)`` layout (``parallel/mesh.py``,
``parallel/sharding_map.py``, the 2-D steps of ``train/step.py``) over
``torch.distributed`` (gloo, CPU), mirroring ``tests/test_train_2d.py``.

The ranks come from ``tests/torch_dist_worker.py`` (torch and the port
only); this process holds JAX.  The model, weights and batches are
``tests/test_train_2d.py``'s (16 clips, sync BatchNorm over every rank,
FSDP threshold 256 so that several kernels shard), the port in float64:

- two steps on the (2 x 2) and (4 x 2) grids equal the 4-way and 8-way
  1-D layouts, one process, and JAX's ``_train("2d")`` (its 4 x 2 mesh)
  on the same weights, for MIL-NCE and sdtw_3 (losses rtol 2e-4, atol
  2e-5, the JAX test's own tolerance); the 2-D parameters and Adam's
  moments equal the 1-D layout's, and a rank holds half the bytes of
  the sharded parameters and their moments;
- the grad-cache step at M = 2 on the 4 x 2 grid equals the 8-way 1-D
  layout's;
- a NaN in one model column's slice makes every rank skip, under both
  settings of ``parallel.overlap_grad_reduce``;
- a model axis without a size (and the other 2-D refusals) is refused
  before the model is built;
- ``run_training`` on a (1 x 2) grid for 2 steps holds real slices, and
  a 1-D checkpoint resumes on the grid and back on 1-D in one process,
  the step counter carried and the losses on the uninterrupted run's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import test_train_2d as jax2d
import torch_dist_worker as worker
from milnce_tpu.config import LossConfig as JaxLossConfig
from milnce_tpu_torch.config import tiny_preset
from milnce_tpu_torch.train import loop

torch.set_num_threads(1)         # six test workers share the cores

RTOL, ATOL = 2e-4, 2e-5          # tests/test_train_2d.py
DIMS = dict(num_classes=16, vocab_size=jax2d._VOCAB, word_embedding_dim=8,
            text_hidden_dim=16, inception_blocks=1)
LOSSES = {"milnce": None,
          "sdtw_3": JaxLossConfig(name="sdtw_3", sdtw_backend="scan")}


def _variables():
    variables = jax2d._model(None).init(
        jax.random.PRNGKey(0),
        jnp.zeros((2, jax2d._FRAMES, jax2d._SIZE, jax2d._SIZE, 3),
                  jnp.float32),
        jnp.zeros((2, jax2d._WORDS), jnp.int32))
    return jax.tree_util.tree_map(np.asarray, variables)


def _batches(n=2):
    return [jax2d._batch(i) for i in range(n)]


def _cases(model_size, grad_cache):
    cases = {}
    for loss in LOSSES:
        cases[f"1d-{loss}"] = dict(loss=loss, model_size=0)
        cases[f"2d-{loss}"] = dict(loss=loss, model_size=model_size)
    if grad_cache:
        cases["gc-1d"] = dict(loss="milnce", model_size=0, micro_batches=2)
        cases["gc-2d"] = dict(loss="milnce", model_size=model_size,
                              micro_batches=2)
        for overlap in (True, False):
            cases[f"nan-2d-{overlap}"] = dict(
                loss="milnce", model_size=model_size, nan_at=1,
                overlap=overlap)
    return cases


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    """world -> per-rank ``{label: result}``: one spawn of 4 ranks (the
    2 x 2 grid) and one of 8 (the 4 x 2 grid, grad-cache, NaN); and the
    one-process runs."""
    variables, batches = _variables(), _batches()
    out = {w: worker.spawn(worker.layout_runs, w,
                           tmp_path_factory.mktemp(f"layouts-w{w}"), DIMS,
                           variables, batches, _cases(2, w == 8))
           for w in (4, 8)}
    out[1] = {loss: worker.layout_run(0, 1, None, DIMS, variables, batches,
                                      loss, 0) for loss in LOSSES}
    return out


@pytest.fixture(scope="module")
def jax_2d():
    """JAX's ``_train("2d")`` (4 x 2 mesh, f32) for each loss."""
    return {loss: jax2d._train("2d", cfg)[0] for loss, cfg in LOSSES.items()}


def _close(got, want, what):
    np.testing.assert_allclose(got, want, RTOL, ATOL, err_msg=what)


def _same_state(got, want, what):
    for key, val in want.items():
        if not key.endswith("num_batches_tracked"):
            _close(got[key], val, f"{what}: {key}")


@pytest.mark.parametrize("world", [4, 8], ids=["2x2", "4x2"])
@pytest.mark.parametrize("loss", list(LOSSES))
def test_2d_layout_matches_1d_one_process_and_jax(layouts, jax_2d, world,
                                                  loss):
    ranks = layouts[world]
    two, one_d = ranks[0][f"2d-{loss}"], ranks[0][f"1d-{loss}"]
    for r in ranks:
        assert r[f"2d-{loss}"]["losses"] == two["losses"]
        assert r[f"2d-{loss}"]["skips"] == [0, 0]
        assert r[f"2d-{loss}"]["state_digest"] == two["state_digest"]
    _close(two["losses"], one_d["losses"], "2-D vs 1-D losses")
    _close(two["losses"], layouts[1][loss]["losses"], "2-D vs one process")
    _close(two["losses"], jax_2d[loss], "2-D vs JAX 2-D")
    _same_state(two["state"], one_d["state"], "2-D vs 1-D state")
    for name, (m, v) in one_d["moments"].items():
        _close(two["moments"][name][0], m, f"exp_avg {name}")
        _close(two["moments"][name][1], v, f"exp_avg_sq {name}")
    # the sharded parameters and their moments: half of the 1-D bytes
    assert two["sharded_bytes"] * 2 == one_d["sharded_bytes"] > 0


def test_grad_cache_2d_matches_1d(layouts):
    ranks = layouts[8]
    two, one_d = ranks[0]["gc-2d"], ranks[0]["gc-1d"]
    assert two["skips"] == one_d["skips"] == [0, 0]
    _close(two["losses"], one_d["losses"], "grad-cache 2-D vs 1-D losses")
    _same_state(two["state"], one_d["state"], "grad-cache 2-D vs 1-D")
    for name, (m, v) in one_d["moments"].items():
        _close(two["moments"][name][0], m, f"exp_avg {name}")
        _close(two["moments"][name][1], v, f"exp_avg_sq {name}")


@pytest.mark.parametrize("overlap", [True, False],
                         ids=["overlap", "fused"])
def test_nan_in_one_model_column_makes_every_rank_skip(layouts, overlap):
    """Rank 0's NaN lands in the last model column's slice alone; the
    verdict agreed over the model axis skips step 2 on all 8 ranks, which
    keep one model (step 1 ran at lr 0, so the initial weights), whether
    the gradients are reduced a leaf at a time during the backward
    (``parallel.overlap_grad_reduce``) or fused after it."""
    ranks = layouts[8]
    init = ranks[0]["2d-milnce"]
    label = f"nan-2d-{overlap}"
    for r in ranks:
        got = r[label]
        assert got["skips"] == [0, 1]
        assert got["losses"][0] == init["losses"][0]
        assert got["state_digest"] == ranks[0][label]["state_digest"]
    variables = worker.load_jax_variables(
        worker.S3D(**DIMS).to(torch.float64), _variables())
    for name, p in variables.named_parameters():
        np.testing.assert_array_equal(ranks[0][label]["state"][name],
                                      p.detach().numpy(), err_msg=name)


def test_layout_hash_is_one_map_on_every_rank(layouts):
    for world in (4, 8):
        hashes = {r["2d-milnce"]["hash"] for r in layouts[world]}
        assert len(hashes) == 1
    assert layouts[4][0]["2d-milnce"]["summary"] == \
        layouts[8][0]["2d-milnce"]["summary"]


def _no_model(*_args, **_kwargs):
    raise AssertionError("the model was built before the refusal")


@pytest.mark.parametrize("axis,size,match", [
    ("model", 1, "model_parallel_size > 1"),
    (None, 2, "needs parallel.model_axis"),
    ("model", 2, "does not divide the run's 1 ranks")],
    ids=["axis-without-size", "size-without-axis", "world-indivisible"])
def test_2d_request_is_refused_before_the_model_is_built(axis, size, match,
                                                         monkeypatch,
                                                         tmp_path):
    cfg = tiny_preset()
    cfg.parallel.platform = "cpu"
    cfg.train.checkpoint_root = str(tmp_path)
    cfg.parallel.model_axis, cfg.parallel.model_parallel_size = axis, size
    monkeypatch.setattr(loop, "build_model", _no_model)
    with pytest.raises(ValueError, match=match):
        loop.run_training(cfg, log=lambda _m: None)


def _run_cfg(root, label, steps, two_d=False, resume=False, epochs=1):
    """``tests/test_train_2d.py::_run_cfg`` on the port: the tiny preset at
    one inception block, a global batch of 8 over 32 synthetic samples,
    sync BatchNorm and a long warmup (so that each layout's step is the
    one-process step), its own group from a ``file://`` store."""
    cfg = tiny_preset()
    cfg.parallel.platform = "cpu"
    cfg.model.inception_blocks = 1
    cfg.model.sync_batchnorm = True
    cfg.optim.warmup_steps = 1000
    cfg.optim.epochs = epochs
    cfg.train.batch_size = 8
    cfg.train.max_steps = steps
    cfg.train.resume = resume
    cfg.data.synthetic_num_samples = 32
    cfg.data.num_reader_threads = 2
    cfg.train.checkpoint_root = str(root / "ckpt" / label.split(":")[0])
    cfg.train.log_root = str(root / f"log-{label}")
    cfg.parallel.coordinator_address = f"file://{root}/store-{label}"
    cfg.parallel.num_processes = 2
    if two_d:
        cfg.parallel.model_axis = "model"
        cfg.parallel.model_parallel_size = 2
        cfg.parallel.fsdp_min_size = jax2d._MIN_SIZE
    return cfg


@pytest.fixture(scope="module")
def trainer_runs(tmp_path_factory):
    """One spawn of 2 ranks: the uninterrupted 1-D run (4 steps), a 1-D
    run of 2 steps resumed for 1 on the (1 x 2) grid, and a fresh 2-D
    run of 2 steps; then, in this process, the grid's checkpoint resumed
    for 1 step."""
    root = tmp_path_factory.mktemp("trainer")
    runs = [("whole", _run_cfg(root, "whole", 4)),
            ("chain:1d", _run_cfg(root, "chain:1d", 2)),
            ("chain:2d", _run_cfg(root, "chain:2d", 1, two_d=True,
                                  resume=True)),
            ("fresh2d", _run_cfg(root, "fresh2d", 2, two_d=True))]
    ranks = worker.spawn(worker.train_runs_2d, 2, root, runs,
                         join_group=False)
    cfg = _run_cfg(root, "chain:one", 1, resume=True)
    cfg.parallel.coordinator_address = None
    cfg.parallel.num_processes = None
    losses, lines = {}, []
    res = loop.run_training(cfg, log=lines.append,
                            on_step=lambda s, _t, loss, _w:
                            losses.__setitem__(s, loss))
    return ranks, dict(losses=losses, lines=lines, steps=res.steps)


def test_run_training_2d_holds_real_shards(trainer_runs):
    ranks, _ = trainer_runs
    one = {}
    for r in ranks:
        fresh = r["fresh2d"]
        assert sorted(fresh["losses"]) == [1, 2]
        assert all(np.isfinite(v) for v in fresh["losses"].values())
        one[r["fresh2d"]["hash"]] = fresh
    assert len(one) == 1                      # one map on both ranks
    cfg = tiny_preset()
    cfg.model.inception_blocks = 1
    model = loop.build_model(cfg.model)
    full = {n: tuple(p.shape) for n, p in model.named_parameters()}
    got = ranks[0]["fresh2d"]["shapes"]
    halved = [n for n in full if got[n] != full[n]]
    assert halved
    for n in halved:
        assert [a // b for a, b in zip(full[n], got[n]) if a != b] == [2]
    line = next(m for m in ranks[0]["fresh2d"]["lines"]
                if m.startswith("sharding map:"))
    assert line.startswith(f"sharding map: {len(halved)}/{len(full)} params "
                           "sharded on 'model' (threshold 256 elements")


def test_resume_1d_to_2d_to_1d(trainer_runs):
    ranks, back = trainer_runs
    whole = ranks[0]["whole"]["losses"]
    chain = {**ranks[0]["chain:1d"]["losses"], **ranks[0]["chain:2d"]["losses"],
             **back["losses"]}
    assert sorted(chain) == sorted(whole) == [1, 2, 3, 4]
    assert ranks[0]["chain:2d"]["steps"] == back["steps"] == 1
    assert "resumed from epoch 0 at batch 2" in ranks[0]["chain:2d"]["lines"]
    assert "resumed from epoch 0 at batch 3" in back["lines"]
    assert any(m.startswith("elastic resume: topology change {'data': 2} -> "
                            "{'data': 1, 'model': 2}")
               for m in ranks[0]["chain:2d"]["lines"])
    assert any(m.startswith("elastic resume: topology change {'data': 1, "
                            "'model': 2} -> {'data': 1}")
               for m in back["lines"])
    for s in whole:
        np.testing.assert_allclose(chain[s], whole[s], rtol=RTOL,
                                   err_msg=f"step {s}")
