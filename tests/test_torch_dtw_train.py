"""Port parity, DTW-loss training: the sequence mode of the torch S3D-G
and three optimizer steps of the torch trainer for each DTW loss, against
``milnce_tpu``'s model and ``make_train_step`` on a one-device ``Mesh``.

The tiny model has 1 Inception block and takes 8 frames at 32^2, so the
video sequence has T' = 4 steps; K = 3 candidate captions make the text
sequence; the clip start times are ``arange(B) * 7``, so the CIDM
interval terms are live.  Losses and every parameter and BatchNorm
statistic are compared leaf by leaf in float64 on both sides, with
``rtol=2e-4, atol=2e-5`` (``tests/test_torch_train.py`` says why float64:
the JAX f32 BatchNorm's one-pass variance, and Adam's amplification of
last-bit noise).  The JAX side runs the scan backend; the port's
``auto`` backend takes the plain recurrence for CPU tensors.  The
sequence mode is compared in f32 eval mode with the model file's
``rtol=1e-4, atol=1e-5``.

Also pinned: the DTW repairs of this slice (the loader carries the clip
start times, ``loss.sdtw_backend`` takes CUDA choices only, the step
builds for every DTW loss and refuses an unknown one at build time) and
the ``milnce-train-torch --loss.name sdtw_3`` entry point on the CPU.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from milnce_tpu.config import LossConfig as JaxLossConfig
from milnce_tpu.config import OptimConfig as JaxOptimConfig
from milnce_tpu.models import S3D as JaxS3D
from milnce_tpu.train.schedule import build_schedule as jax_build_schedule
from milnce_tpu.train.state import build_optimizer as jax_build_optimizer
from milnce_tpu.train.state import create_train_state
from milnce_tpu.train.step import _check_loss_name as jax_check_loss_name
from milnce_tpu.train.step import make_train_step as jax_make_train_step
from milnce_tpu_torch.config import (DataConfig, LossConfig, OptimConfig,
                                     parse_cli, tiny_preset)
from milnce_tpu_torch.data.pipeline import (ShardedLoader, device_prefetch,
                                            flatten_text)
from milnce_tpu_torch.data.synthetic import SyntheticVideoTextSource
from milnce_tpu_torch.models.s3dg import S3D
from milnce_tpu_torch.train.loop import run_training
from milnce_tpu_torch.train.schedule import build_schedule
from milnce_tpu_torch.train.state import build_optimizer
from milnce_tpu_torch.train.step import make_train_step
from milnce_tpu_torch.utils.torch_convert import (flax_to_torch_state_dict,
                                                  load_jax_variables)

torch.set_num_threads(1)         # six test workers share the cores

ROOT = pathlib.Path(__file__).resolve().parents[1]
RTOL, ATOL = 2e-4, 2e-5
_B, _K, _FRAMES, _SIZE, _WORDS, _VOCAB = 4, 3, 8, 32, 5, 32
_DIMS = dict(num_classes=16, vocab_size=_VOCAB, word_embedding_dim=8,
             text_hidden_dim=16, inception_blocks=1)
_STEPS = 3
_START = np.arange(_B, dtype=np.float32) * 7
DTW_LOSSES = ("cdtw", "sdtw_cidm", "sdtw_negative", "sdtw_3")


def _batch(i):
    rng = np.random.default_rng(100 + i)
    video = rng.integers(0, 255, (_B, _FRAMES, _SIZE, _SIZE, 3),
                         dtype=np.uint8)
    text = rng.integers(0, _VOCAB, (_B * _K, _WORDS)).astype(np.int32)
    return video, text


@pytest.fixture(scope="module")
def variables():
    variables = JaxS3D(**_DIMS).init(
        jax.random.PRNGKey(0),
        jnp.zeros((2, _FRAMES, _SIZE, _SIZE, 3), jnp.float32),
        jnp.zeros((2 * _K, _WORDS), jnp.int32))
    return jax.tree_util.tree_map(np.asarray, variables)


def test_sequence_mode_matches_jax(variables):
    """mode="sequence" gives (video (B, T', D), text (B*K, D)) as the JAX
    model does.  It adds no parameter: the JAX variables load into the
    port model with ``strict=True`` and the same keys as the pooled mode
    uses, so the weight bridge carries them across unchanged."""
    model = load_jax_variables(S3D(**_DIMS), variables).eval()
    assert set(model.state_dict()) == set(flax_to_torch_state_dict(variables))
    video, text = _batch(0)
    video = video.astype(np.float32) / 255.0
    want_v, want_t = JaxS3D(**_DIMS).apply(variables, jnp.asarray(video),
                                           jnp.asarray(text), mode="sequence")
    with torch.no_grad():
        got_v, got_t = model(torch.tensor(video), torch.tensor(text),
                             mode="sequence")
    assert tuple(got_v.shape) == (_B, 4, 16) == want_v.shape
    assert tuple(got_t.shape) == (_B * _K, 16) == want_t.shape
    np.testing.assert_allclose(got_v.numpy(), want_v, 1e-4, 1e-5)
    np.testing.assert_allclose(got_t.numpy(), want_t, 1e-4, 1e-5)
    # the sequence mean-pooled over time is the pooled embedding's input
    with torch.no_grad():
        pooled = model(torch.tensor(video), None, mode="video")
    np.testing.assert_allclose(
        got_v.mean(dim=1).numpy(), pooled.numpy(), 1e-5, 1e-6)


def _jax_run(name, variables):
    with jax.enable_x64(True):
        model = JaxS3D(dtype=jnp.float64, **_DIMS)
        state_vars = jax.tree_util.tree_map(
            lambda a: a.astype(np.float64), variables)
        opt_cfg = JaxOptimConfig(warmup_steps=2)
        opt = jax_build_optimizer(opt_cfg, jax_build_schedule(opt_cfg, 10))
        state = create_train_state(state_vars, opt)
        mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
        step = jax_make_train_step(
            model, opt, mesh, donate=False, finite_guard=True,
            loss_cfg=JaxLossConfig(name=name, sdtw_backend="scan"))
        losses = []
        for i in range(_STEPS):
            state, loss, skipped = step(state, *_batch(i), _START)
            assert int(skipped) == 0
            losses.append(float(loss))
        sd = flax_to_torch_state_dict({
            "params": jax.tree_util.tree_map(np.asarray, state.params),
            "batch_stats": jax.tree_util.tree_map(np.asarray,
                                                  state.batch_stats)})
    return losses, sd


def _torch_run(name, variables):
    model = load_jax_variables(S3D(**_DIMS).double(), variables)
    opt_cfg = OptimConfig(warmup_steps=2)
    optimizer, sched = build_optimizer(model, opt_cfg,
                                       build_schedule(opt_cfg, 10))
    step = make_train_step(model, optimizer, LossConfig(name=name),
                           finite_guard=True, lr_scheduler=sched)
    losses = []
    for i in range(_STEPS):
        video, text = _batch(i)
        loss, skipped = step(torch.from_numpy(video), torch.from_numpy(text),
                             torch.from_numpy(_START))
        assert skipped == 0
        losses.append(float(loss))
    return losses, model


@pytest.mark.parametrize("name", DTW_LOSSES)
def test_three_steps_match_jax(name, variables):
    want_losses, want_sd = _jax_run(name, variables)
    losses, model = _torch_run(name, variables)
    np.testing.assert_allclose(losses, want_losses, RTOL, ATOL)
    got = model.state_dict()
    keys = [k for k in want_sd if not k.endswith("num_batches_tracked")]
    for key in keys:
        np.testing.assert_allclose(got[key].numpy(), want_sd[key], RTOL,
                                   ATOL, err_msg=key)


def test_unknown_loss_is_refused_when_the_step_is_built():
    model = S3D(**_DIMS)
    optimizer, _ = build_optimizer(model, OptimConfig(),
                                   build_schedule(OptimConfig(), 10))
    with pytest.raises(ValueError) as got:
        make_train_step(model, optimizer, LossConfig(name="sdtw_4"))
    with pytest.raises(ValueError) as want:
        jax_check_loss_name(JaxLossConfig(name="sdtw_4"))
    assert str(got.value) == str(want.value)
    for name in DTW_LOSSES:                  # every DTW loss builds
        make_train_step(model, optimizer, LossConfig(name=name))


def test_loader_yields_start_times():
    cfg = DataConfig(num_frames=2, video_size=8, max_words=4,
                     num_candidates=2, synthetic_num_samples=6)
    source = SyntheticVideoTextSource(cfg, vocab_size=16)
    loader = ShardedLoader(source, 3, seed=1, num_threads=2)
    order = np.arange(6)
    np.random.RandomState(1).shuffle(order)
    batches = list(device_prefetch(loader.epoch(0), "cpu"))
    assert len(batches) == 2
    for k, batch in enumerate(batches):
        (video, text), start = flatten_text(batch), batch["start"]
        assert video.shape == (3, 2, 8, 8, 3) and text.shape == (6, 4)
        assert start.dtype == torch.float32
        np.testing.assert_array_equal(
            start.numpy(), [source.sample(int(i), None)["start"]
                            for i in order[3 * k:3 * k + 3]])


def test_sdtw_backend_knob_takes_cuda_choices():
    for choice in ("auto", "scan", "cuda"):
        assert parse_cli(["--loss.sdtw_backend", choice]).loss.sdtw_backend \
            == choice
    with pytest.raises(SystemExit):
        parse_cli(["--loss.sdtw_backend", "pallas"])


def test_cli_trains_sdtw3_on_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT),
               OMP_NUM_THREADS="1")     # six test workers share the cores
    proc = subprocess.run(
        [sys.executable, "-m", "milnce_tpu_torch.train.cli", "--preset",
         "tiny", "--parallel.platform", "cpu", "--loss.name", "sdtw_3",
         "--train.max_steps", "2", "--train.checkpoint_root",
         str(tmp_path), "--train.log_root", str(tmp_path / "log")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.count("Training loss:") == 2
    assert "done: 2 steps" in proc.stdout


def test_trainer_runs_on_the_card_by_default(monkeypatch, tmp_path):
    """Without a card, a run that did not ask for the CPU refuses to
    start instead of falling back to it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tiny_preset()
    cfg.loss.name = "sdtw_3"
    cfg.train.log_root = str(tmp_path / "log")
    assert cfg.parallel.platform == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_training(cfg, log=lambda _m: None)
