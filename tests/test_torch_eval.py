"""Port parity, eval: retrieval metrics, retrieval embeddings and the
HMDB linear probe of ``milnce_tpu_torch/eval/`` against the JAX
package's, with the JAX tiny model's weights carried across by
``load_jax_variables``, on the first rows of the committed ``csv/``
manifests decoded by ``FakeDecoder`` (the same frames on both sides
within one process).  Embeddings agree within the model tests'
``rtol=1e-4, atol=1e-5``; metrics and probe accuracies are equal.  Also:
the eval CLI on a port checkpoint directory and on a reference ``.pth``.
"""

import csv
import pathlib
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from milnce_tpu.config import DataConfig as JaxDataConfig
from milnce_tpu.data import datasets as jax_datasets
from milnce_tpu.data.tokenizer import Tokenizer as JaxTokenizer
from milnce_tpu.data.video import FakeDecoder as JaxFakeDecoder
from milnce_tpu.eval.linear_probe import (
    evaluate_linear_probe as jax_evaluate_linear_probe)
from milnce_tpu.eval.linear_probe import (
    extract_probe_features as jax_extract_probe_features)
from milnce_tpu.eval.metrics import (
    compute_retrieval_metrics as jax_compute_retrieval_metrics)
from milnce_tpu.eval.retrieval import (
    extract_retrieval_embeddings as jax_extract_retrieval_embeddings)
from milnce_tpu.models import S3D as JaxS3D
from milnce_tpu_torch.config import DataConfig, ModelConfig, OptimConfig
from milnce_tpu_torch.data import datasets
from milnce_tpu_torch.data.tokenizer import Tokenizer
from milnce_tpu_torch.data.video import FakeDecoder
from milnce_tpu_torch.eval import cli
from milnce_tpu_torch.eval.linear_probe import (evaluate_linear_probe,
                                                extract_probe_features)
from milnce_tpu_torch.eval.metrics import compute_retrieval_metrics
from milnce_tpu_torch.eval.retrieval import extract_retrieval_embeddings
from milnce_tpu_torch.eval.runner import evaluate_task
from milnce_tpu_torch.models.build import build_model
from milnce_tpu_torch.models.s3dg import S3D
from milnce_tpu_torch.train.checkpoint import CheckpointManager, train_state
from milnce_tpu_torch.train.schedule import build_schedule
from milnce_tpu_torch.train.state import build_optimizer
from milnce_tpu_torch.utils.torch_convert import load_jax_variables

torch.set_num_threads(1)         # six test workers share the cores

ROOT = pathlib.Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-4, 1e-5
_DIMS = dict(num_classes=16, vocab_size=256, word_embedding_dim=8,
             text_hidden_dim=16, inception_blocks=2)
_FRAMES, _SIZE, _WINDOWS, _ROWS, _WORDS = 4, 32, 3, 8, 30


def _cut_csv(name, out, rows):
    """``csv/<name>`` cut to the rows whose positions are in ``rows``."""
    with open(ROOT / "csv" / name, newline="") as f:
        reader = csv.DictReader(f)
        kept = [r for i, r in enumerate(reader) if i in rows]
        fields = reader.fieldnames
    with open(out, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=fields)
        writer.writeheader()
        writer.writerows(kept)
    return str(out), kept


@pytest.fixture(scope="module")
def pair():
    """The JAX tiny model's weights, in both packages."""
    jm = JaxS3D(**_DIMS)
    variables = jm.init(jax.random.PRNGKey(0),
                        jnp.zeros((2, _FRAMES, _SIZE, _SIZE, 3), jnp.float32),
                        jnp.zeros((2, 5), jnp.int32))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    tm = load_jax_variables(S3D(**_DIMS), variables)
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    return jm, variables, mesh, tm


# --------------------------------------------------------------- metrics
@pytest.mark.parametrize("n,levels", [(1, 0), (7, 3), (40, 5), (40, 0),
                                      (257, 1000)],
                         ids=["one", "ties", "ties-40", "all-tied",
                              "distinct"])
def test_retrieval_metrics_match_jax(n, levels):
    """Random similarities, on a few integer levels so that rows tie."""
    rng = np.random.RandomState(n + levels)
    sim = (rng.randint(0, levels, (n, n)).astype(np.float32) if levels
           else np.zeros((n, n), np.float32))
    assert compute_retrieval_metrics(sim) == jax_compute_retrieval_metrics(sim)


# --------------------------------------------------- retrieval embeddings
def _vocab(rows, field):
    words = sorted({w for r in rows for w in Tokenizer.split(r[field])})
    assert len(words) < _DIMS["vocab_size"]
    return words


@pytest.mark.parametrize("task,name,field", [
    ("youcook", "validation_youcook.csv", "text"),
    ("msrvtt", "msrvtt_test.csv", "sentence")])
def test_retrieval_matches_jax(pair, tmp_path, task, name, field):
    jm, variables, mesh, tm = pair
    path, rows = _cut_csv(name, tmp_path / name, range(_ROWS))
    words = _vocab(rows, field)
    kw = dict(num_clip=_WINDOWS, max_words=_WORDS)
    cls = {"youcook": "YouCookSource", "msrvtt": "MSRVTTSource"}[task]
    src = getattr(datasets, cls)(
        path, "videos", DataConfig(num_frames=_FRAMES, video_size=_SIZE),
        Tokenizer(words), decoder=FakeDecoder(), **kw)
    jsrc = getattr(jax_datasets, cls)(
        path, "videos", JaxDataConfig(num_frames=_FRAMES, video_size=_SIZE),
        JaxTokenizer(words), decoder=JaxFakeDecoder(), **kw)
    t, v = extract_retrieval_embeddings(tm, src, "cpu", batch_size=_ROWS)
    jt, jv = jax_extract_retrieval_embeddings(jm, variables, jsrc, mesh,
                                              batch_size=_ROWS)
    assert t.shape == v.shape == (_ROWS, 16)
    np.testing.assert_allclose(t, jt, RTOL, ATOL)
    np.testing.assert_allclose(v, jv, RTOL, ATOL)
    got = compute_retrieval_metrics(t @ v.T)
    assert got == jax_compute_retrieval_metrics(jt @ jv.T)
    # the runner's dispatch gives the same numbers
    assert evaluate_task(task, tm, "cpu", data_cfg=src.cfg, csv_path=path,
                         video_root="videos", tokenizer=Tokenizer(words),
                         batch_size=_ROWS, decoder=FakeDecoder(),
                         **kw) == got


# ------------------------------------------------------------ linear probe
def _hmdb_rows():
    """The first rows of three classes: each official split then has
    training and test videos of several classes."""
    with open(ROOT / "csv" / "hmdb51.csv", newline="") as f:
        labels = [r["label"] for r in csv.DictReader(f)]
    firsts = [labels.index(lab) for lab in dict.fromkeys(labels)][:3]
    return {i for f, n in zip(firsts, (12, 12, 8)) for i in range(f, f + n)}


def test_linear_probe_matches_jax(pair, tmp_path):
    jm, variables, mesh, tm = pair
    path, _ = _cut_csv("hmdb51.csv", tmp_path / "hmdb.csv", _hmdb_rows())
    src = datasets.HMDBSource(path, "videos", DataConfig(
        num_frames=_FRAMES, video_size=_SIZE), num_clip=2,
        decoder=FakeDecoder())
    jsrc = jax_datasets.HMDBSource(path, "videos", JaxDataConfig(
        num_frames=_FRAMES, video_size=_SIZE), num_clip=2,
        decoder=JaxFakeDecoder())
    feats, labels, splits = extract_probe_features(tm, src, "cpu")
    jfeats, jlabels, jsplits = jax_extract_probe_features(jm, variables,
                                                          jsrc, mesh)
    assert feats.shape[:2] == (32, 2)
    np.testing.assert_allclose(feats, jfeats, RTOL, ATOL)
    np.testing.assert_array_equal(labels, jlabels)
    np.testing.assert_array_equal(splits, jsplits)
    # LinearSVC's solver shuffles with the global numpy stream: the same
    # seed for both fits
    np.random.seed(0)
    got = evaluate_linear_probe(tm, src, "cpu")
    np.random.seed(0)
    assert got == jax_evaluate_linear_probe(jm, variables, jsrc, mesh)
    assert set(got) == {"split1", "split2", "split3", "mean"}


# ------------------------------------------------------------------ the CLI
_CLI_DIMS = ["--embedding_dim", "16", "--inception_blocks", "2",
             "--word_embedding_dim", "8", "--text_hidden_dim", "16",
             "--vocab_size", "64"]


def test_eval_cli_reads_checkpoints_and_reference_files(tmp_path, capsys,
                                                        monkeypatch):
    """The same weights, saved by the trainer's checkpoint manager and as
    a reference DDP ``.pth``, score the same; ``--platform cuda`` without
    a card refuses."""
    mcfg = ModelConfig(embedding_dim=16, inception_blocks=2,
                       word_embedding_dim=8, text_hidden_dim=16,
                       vocab_size=64)
    model = build_model(mcfg, seed=4)
    optimizer, sched = build_optimizer(model, OptimConfig(),
                                       build_schedule(OptimConfig(), 10))
    CheckpointManager(str(tmp_path / "run")).save(
        2, train_state(model, optimizer, sched, step=7, epoch=2))
    pth = tmp_path / "ref.pth"
    torch.save({"state_dict": {"module." + k: v
                               for k, v in model.state_dict().items()}}, pth)
    path, _ = _cut_csv("msrvtt_test.csv", tmp_path / "m.csv", range(6))
    common = ["msrvtt", "--csv", path, "--video_root", "videos",
              "--num_frames", "4", "--video_size", "32", "--num_windows",
              "2", "--batch_size", "4", "--fake_decoder"] + _CLI_DIMS
    with pytest.raises(RuntimeError, match="no CUDA device"):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        cli.main(common + ["--ckpt", str(pth)])       # cuda by default
    common += ["--platform", "cpu"]
    from_dir = cli.main(common + ["--ckpt", str(tmp_path / "run")])
    out = capsys.readouterr().out
    assert "loaded checkpoint (epoch 2)" in out
    assert re.search(r"R@1: \S+ - R@5: \S+ - R@10: \S+ - Median R: \S+", out)
    from_pth = cli.main(common + ["--ckpt", str(pth)])
    assert "loaded reference checkpoint" in capsys.readouterr().out
    assert from_dir == from_pth
    with pytest.raises(FileNotFoundError):
        cli.main(common + ["--ckpt", str(tmp_path / "typo")])
    assert not (tmp_path / "typo").exists()
