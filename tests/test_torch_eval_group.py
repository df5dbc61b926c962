"""Port parity, eval over a device group and over ranks
(``eval/shards.py``, ``eval/retrieval.py``, ``eval/linear_probe.py``,
``eval/cli.py``, the trainer's in-training eval), against the JAX evals
over a 2-device CPU mesh (``tests/conftest.py`` gives 8 host devices).

The JAX tiny model's weights go to the port by ``load_jax_variables``;
the source is ``torch_dist_worker.SeededEvalSource`` (its samples made
from their index, so the ranks' processes decode what this one does): 7
samples at retrieval batch 4 and probe batch 8, so the last batch is
padded as JAX pads it.

- retrieval embeddings and probe features over ``["cpu", "cpu"]`` and
  over two gloo ranks equal the one-device eval's within
  ``1e-5 + 1e-4·max|e|``; their metrics equal JAX's ``evaluate_retrieval``
  / ``evaluate_linear_probe`` on the 2-device mesh; every rank gets every
  sample, and decodes only its own slices' samples;
- the batch is rounded as JAX rounds it;
- ``run_training`` with ``train.evaluate`` over two gloo ranks: every rank
  ends with the metrics one process gets, rank 0 logs them once, and no
  rank meets a barrier while it evaluates;
- ``cuda`` without a card, or a group naming a missing card, is refused;
  the eval CLI's group is every visible card under ``--platform cuda``.
"""

import csv
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import torch_dist_worker as worker
from milnce_tpu.eval.linear_probe import (
    evaluate_linear_probe as jax_evaluate_linear_probe)
from milnce_tpu.eval.metrics import (
    compute_retrieval_metrics as jax_compute_retrieval_metrics)
from milnce_tpu.eval.retrieval import (
    extract_retrieval_embeddings as jax_extract_retrieval_embeddings)
from milnce_tpu.models import S3D as JaxS3D
from milnce_tpu_torch.config import tiny_preset
from milnce_tpu_torch.eval import cli
from milnce_tpu_torch.eval.linear_probe import (evaluate_linear_probe,
                                                extract_probe_features)
from milnce_tpu_torch.eval.metrics import compute_retrieval_metrics
from milnce_tpu_torch.eval.retrieval import extract_retrieval_embeddings
from milnce_tpu_torch.eval.shards import EvalShards
from milnce_tpu_torch.models.s3dg import S3D
from milnce_tpu_torch.utils.torch_convert import load_jax_variables

torch.set_num_threads(1)         # six test workers share the cores

ROOT = pathlib.Path(__file__).resolve().parents[1]
DIMS = dict(num_classes=16, vocab_size=64, word_embedding_dim=8,
            text_hidden_dim=16, inception_blocks=1)
N, BATCH = 7, 4
RTOL, ATOL = 1e-4, 1e-5          # the model tests' (port against JAX)


def _limit(want):
    return 1e-5 + 1e-4 * float(np.abs(want).max())


@pytest.fixture(scope="module")
def pair():
    """The JAX tiny model's weights in both packages; the JAX mesh of 2
    devices."""
    jm = JaxS3D(**DIMS)
    variables = jm.init(jax.random.PRNGKey(0),
                        jnp.zeros((2, 4, 32, 32, 3), jnp.float32),
                        jnp.zeros((2, 5), jnp.int32))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    return jm, variables, mesh, load_jax_variables(S3D(**DIMS), variables)


@pytest.fixture(scope="module")
def one_device(pair):
    """The one-device eval: embeddings, features, probe accuracies."""
    tm = pair[3]
    src = worker.SeededEvalSource(N, vocab=DIMS["vocab_size"])
    t, v = extract_retrieval_embeddings(tm, src, "cpu", BATCH)
    feats, labels, splits = extract_probe_features(tm, src, "cpu")
    return dict(t=t, v=v, feats=feats, labels=list(labels), splits=splits)


@pytest.fixture(scope="module")
def jax_mesh(pair):
    """JAX's embeddings, metrics and probe accuracies on its 2-device
    mesh."""
    jm, variables, mesh, _ = pair
    src = worker.SeededEvalSource(N, vocab=DIMS["vocab_size"])
    t, v = jax_extract_retrieval_embeddings(jm, variables, src, mesh,
                                            batch_size=BATCH)
    np.random.seed(0)
    accs = jax_evaluate_linear_probe(jm, variables, src, mesh)
    return dict(t=t, v=v, metrics=jax_compute_retrieval_metrics(t @ v.T),
                accs=accs)


@pytest.fixture(scope="module")
def two_ranks(pair, tmp_path_factory):
    """Two gloo ranks, each on its one CPU device."""
    return worker.spawn(worker.eval_group_runs, 2,
                        tmp_path_factory.mktemp("eval-ranks"), DIMS,
                        pair[1], N, BATCH, "cpu")


def _check(got, one_device, jax_mesh):
    for key in ("t", "v", "feats"):
        assert got[key].shape == one_device[key].shape, key
        assert np.abs(got[key] - one_device[key]).max() <= _limit(
            one_device[key]), key
    np.testing.assert_allclose(got["t"], jax_mesh["t"], RTOL, ATOL)
    np.testing.assert_allclose(got["v"], jax_mesh["v"], RTOL, ATOL)
    assert got["labels"] == one_device["labels"]
    np.testing.assert_array_equal(got["splits"], one_device["splits"])
    assert compute_retrieval_metrics(got["t"] @ got["v"].T) \
        == jax_mesh["metrics"]


def test_device_group_matches_one_device_and_the_jax_mesh(pair, one_device,
                                                          jax_mesh):
    tm = pair[3]
    src = worker.SeededEvalSource(N, vocab=DIMS["vocab_size"])
    t, v = extract_retrieval_embeddings(tm, src, ["cpu", "cpu"], BATCH)
    feats, labels, splits = extract_probe_features(tm, src, ["cpu", "cpu"])
    _check(dict(t=t, v=v, feats=feats, labels=list(labels), splits=splits),
           one_device, jax_mesh)
    np.random.seed(0)
    assert evaluate_linear_probe(tm, src, ["cpu", "cpu"]) == jax_mesh["accs"]


def test_two_ranks_match_one_device_and_the_jax_mesh(two_ranks, one_device,
                                                     jax_mesh):
    for got in two_ranks:
        _check(got, one_device, jax_mesh)
        assert got["metrics"] == jax_mesh["metrics"]
        assert got["accs"] == jax_mesh["accs"]
    a, b = two_ranks
    for key in ("t", "v", "feats"):
        np.testing.assert_array_equal(a[key], b[key])


def test_each_rank_decodes_its_own_slices(two_ranks):
    """Batch 4 over 2 shards: rank 0 takes samples 0, 1 and 4, 5; rank 1
    takes 2, 3 and 6 (and 6 again as the pad).  The probe's batch of 8
    is padded to 8: rank 0 takes 0-3, rank 1 4-6."""
    assert [r["decoded_retrieval"] for r in two_ranks] == [[0, 1, 4, 5],
                                                           [2, 3, 6]]
    assert [r["decoded_probe"] for r in two_ranks] == [[0, 1, 2, 3],
                                                       [4, 5, 6]]


@pytest.mark.parametrize("shards,batch", [(1, 16), (2, 4), (4, 4), (3, 16),
                                          (8, 4), (3, 2)])
def test_the_batch_rounds_as_jax(shards, batch):
    fake = EvalShards.__new__(EvalShards)
    fake.n = shards
    assert fake.round(batch) == max(shards, (batch // shards) * shards)


def _eval_cfg(root, world):
    """The tiny preset (one inception block) trained one step on
    synthetic clips, evaluating msrvtt on the first 7 rows of
    ``csv/msrvtt_test.csv`` (the fake decoder) at batch 4, two windows,
    before step 1; ``world`` ranks over a ``file://`` store."""
    with open(ROOT / "csv" / "msrvtt_test.csv", newline="") as f:
        rows = list(csv.reader(f))[:N + 1]
    path = root / "msrvtt.csv"
    with open(path, "w", newline="") as f:
        csv.writer(f).writerows(rows)
    cfg = tiny_preset()
    cfg.parallel.platform = "cpu"
    cfg.model.inception_blocks = 1
    cfg.train.batch_size = 4
    cfg.train.max_steps = 1
    cfg.train.evaluate = True
    cfg.train.eval_task = "msrvtt"
    cfg.train.batch_size_val = BATCH
    cfg.train.num_windows_test = 2
    cfg.data.eval_csv = str(path)
    cfg.data.eval_video_root = "videos"
    cfg.data.synthetic_num_samples = 16
    cfg.data.num_reader_threads = 2
    cfg.train.checkpoint_root = str(root / "ckpt")
    cfg.train.log_root = str(root / "log")
    cfg.parallel.coordinator_address = f"file://{root}/store"
    cfg.parallel.num_processes = world
    return cfg


def test_run_training_evaluates_on_every_rank(tmp_path, monkeypatch):
    # the fake decoder seeds by a path's hash: one seed for both ranks
    monkeypatch.setenv("PYTHONHASHSEED", "0")
    ranks = worker.spawn(worker.eval_train_runs, 2, tmp_path,
                         _eval_cfg(tmp_path, 2), join_group=False)
    for r in ranks:
        assert r["metrics"] == r["alone"] == ranks[0]["alone"]
        assert set(r["metrics"]) == {"R1", "R5", "R10", "MR"}
        assert not any(r["barriers"]), "a barrier inside the eval"
    shown = [[m for m in r["lines"] if m.startswith("msrvtt retrieval:")]
             for r in ranks]
    assert [len(s) for s in shown] == [1, 0]
    assert [r["decoded"] for r in ranks] == [[0, 1, 4, 5], [2, 3, 6]]


def test_missing_cards_are_refused(pair, monkeypatch):
    tm = pair[3]
    src = worker.SeededEvalSource(N, vocab=DIMS["vocab_size"])
    missing = f"cuda:{torch.cuda.device_count()}"
    with pytest.raises(RuntimeError,
                       match="no CUDA device is visible|devices are visible"):
        extract_retrieval_embeddings(tm, src, ["cpu", missing], BATCH)
    with pytest.raises(RuntimeError,
                       match="no CUDA device is visible|devices are visible"):
        extract_probe_features(tm, src, [missing])
    assert src.decoded == []        # refused before any sample is decoded
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.eval_devices("cuda")


def test_eval_cli_takes_every_visible_card(monkeypatch):
    assert cli.eval_devices("cpu") == [torch.device("cpu")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert cli.eval_devices("cuda") == [torch.device("cuda", i)
                                        for i in range(3)]
