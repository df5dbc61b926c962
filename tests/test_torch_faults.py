"""Port parity, fault injection: ``milnce_tpu_torch/resilience/faults.py``
against ``milnce_tpu/resilience/faults.py``, and the training sites the
port fires where the JAX package fires them.

- The spec grammar: the same parse of every good spec and the same
  refusal of every bad one; arming, disarming, the ``armed`` block, the
  ``MILNCE_FAULTS`` variable and the caller's exception class.
- ``decode.raise`` / ``decode.hang`` in ``data/synthetic.py`` and
  ``data/video.py::sample_clip``: the HowTo100M source resamples the
  same draws as the JAX source under the same schedule (its failures
  counted alike), and the loader's watchdog times a hung decode out and
  retries it, giving the JAX loader's batch; the cases of the JAX
  package's ``tests/test_resilience.py``.
- ``ckpt.save_ioerror`` inside the checkpoint save's retry: a single
  failure is retried and committed, a failure on every attempt raises.
- ``grad.nonfinite@N`` skips the same optimizer step as the JAX step,
  plain and grad-cache (float64, ``tests/test_torch_train.py``'s
  tolerances), and its count goes on across a resume.
- ``run_training`` with ``train.faults``: the host sites together, the
  guard's skip, the breaker's rollback, the registry disarmed at the
  end, a malformed spec refused before the model is built.
"""

import contextlib
import json
import os
import re
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from milnce_tpu.config import DataConfig as JaxDataConfig
from milnce_tpu.config import LossConfig as JaxLossConfig
from milnce_tpu.config import ModelConfig as JaxModelConfig
from milnce_tpu.config import OptimConfig as JaxOptimConfig
from milnce_tpu.data import video as jax_video
from milnce_tpu.data.datasets import HowTo100MSource as JaxHowTo100MSource
from milnce_tpu.data.pipeline import ShardedLoader as JaxShardedLoader
from milnce_tpu.data.synthetic import (
    SyntheticVideoTextSource as JaxSyntheticSource)
from milnce_tpu.data.tokenizer import Tokenizer as JaxTokenizer
from milnce_tpu.models import S3D as JaxS3D
from milnce_tpu.resilience import faults as jax_faults
from milnce_tpu.train.schedule import build_schedule as jax_build_schedule
from milnce_tpu.train.state import build_optimizer as jax_build_optimizer
from milnce_tpu.train.state import create_train_state
from milnce_tpu.train.step import \
    make_grad_cache_step as jax_make_grad_cache_step
from milnce_tpu.train.step import make_train_step as jax_make_train_step
from milnce_tpu_torch.config import (DataConfig, LossConfig, ModelConfig,
                                     OptimConfig, tiny_preset)
from milnce_tpu_torch.data import video
from milnce_tpu_torch.data.datasets import HowTo100MSource
from milnce_tpu_torch.data.pipeline import ShardedLoader, stack_batch
from milnce_tpu_torch.data.synthetic import SyntheticVideoTextSource
from milnce_tpu_torch.data.tokenizer import Tokenizer
from milnce_tpu_torch.models.s3dg import S3D
from milnce_tpu_torch.obs import metrics as obs_metrics
from milnce_tpu_torch.resilience import faults
from milnce_tpu_torch.train import loop
from milnce_tpu_torch.train.checkpoint import CheckpointManager
from milnce_tpu_torch.train.schedule import build_schedule
from milnce_tpu_torch.train.state import build_optimizer
from milnce_tpu_torch.train.step import make_grad_cache_step, make_train_step
from milnce_tpu_torch.utils.torch_convert import (flax_to_torch_state_dict,
                                                  load_jax_variables)

torch.set_num_threads(1)         # six test workers share the cores

RTOL, ATOL = 2e-4, 2e-5                      # tests/test_torch_train.py
_VOCAB = [f"word{i}" for i in range(1, 8)] + ["it's", "a"]


@pytest.fixture(autouse=True)
def _disarmed():
    """Every test starts and ends with both registries disarmed."""
    faults.disarm()
    jax_faults.disarm()
    yield
    faults.disarm()
    jax_faults.disarm()


# ------------------------------------------------------------------ grammar
_GOOD = ["decode.raise@1", "decode.raise@1,3,7", "decode.hang@*:x=0.5",
         "ckpt.save_ioerror@%3", "grad.nonfinite@2;decode.raise@%2",
         " decode.hang@2 ; ;grad.nonfinite@* ", "serve.replica_dead@60",
         "host.slow@%1:x=0.05;host.preempt@9;index.swap_raise@%3"]
_BAD = ["decode.raise", "nope@1", "decode.raise@0", "decode.raise@%0",
        "decode.hang@1:y=2", "decode.raise@a", "decode.raise@"]


@pytest.mark.parametrize("spec", _GOOD)
def test_spec_parses_as_jax(spec):
    got, want = faults.parse_spec(spec), jax_faults.parse_spec(spec)
    assert set(got) == set(want)
    for site, s in want.items():
        g = got[site]
        assert (g.site, g.mode, g.at, g.every, g.x) == (s.site, s.mode, s.at,
                                                        s.every, s.x)
        assert [g.scheduled(n) for n in range(1, 13)] == \
            [s.scheduled(n) for n in range(1, 13)]
    assert faults.KNOWN_SITES == jax_faults.KNOWN_SITES


@pytest.mark.parametrize("spec", _BAD)
def test_bad_spec_is_refused_as_jax(spec):
    with pytest.raises(ValueError) as want:
        jax_faults.parse_spec(spec)
    with pytest.raises(ValueError) as got:
        faults.parse_spec(spec)
    assert type(got.value) is type(want.value)


def test_arming_disarming_and_the_environment(monkeypatch):
    faults.maybe_raise("decode.raise")           # disarmed: a no-op
    faults.maybe_hang("decode.hang")
    assert faults.device_schedule("grad.nonfinite") is None
    assert faults.fire_site("serve.replica_dead") is False
    with faults.armed("decode.raise@1;ckpt.save_ioerror@2"):
        with pytest.raises(faults.InjectedFault, match="occurrence 1"):
            faults.maybe_raise("decode.raise")
        faults.maybe_raise("decode.raise")       # occurrence 2: clean
        faults.maybe_raise("ckpt.save_ioerror", OSError)
        with pytest.raises(OSError):             # the caller's class
            faults.maybe_raise("ckpt.save_ioerror", OSError)
    faults.maybe_raise("decode.raise")           # disarmed again
    monkeypatch.setattr(faults, "_registry", None)
    monkeypatch.setattr(faults, "_env_checked", False)
    monkeypatch.setenv(faults.ENV_VAR, "decode.raise@1")
    with pytest.raises(faults.InjectedFault):
        faults.maybe_raise("decode.raise")
    faults.disarm()
    faults.maybe_raise("decode.raise")           # a disarm stays disarmed
    injected = obs_metrics.registry().counter(
        "milnce_faults_injected_total", labels=("site",))
    assert injected.labels(site="decode.raise").value >= 2


def test_hang_sleeps_its_parameter():
    with faults.armed("decode.hang@1:x=0.3"):
        t0 = time.perf_counter()
        faults.maybe_hang("decode.hang")
        assert time.perf_counter() - t0 >= 0.3
        t0 = time.perf_counter()
        faults.maybe_hang("decode.hang")         # occurrence 2: no sleep
        assert time.perf_counter() - t0 < 0.1


# ------------------------------------------------------------ decode sites
@pytest.fixture
def howto_dir(tmp_path):
    (tmp_path / "videos").mkdir()
    (tmp_path / "captions").mkdir()
    rows = ["video_path"]
    for i in range(4):
        rows.append(f"vid{i}.mp4")
        (tmp_path / "captions" / f"vid{i}.json").write_text(json.dumps(
            {"start": [0, 6, 12], "end": [6, 12, 18],
             "text": [f"word{i} word2", "word3 word4", "word5"]}))
    (tmp_path / "train.csv").write_text("\n".join(rows))
    return tmp_path


def _sources(root):
    def cfg(cls):
        return cls(train_csv=str(root / "train.csv"),
                   video_root=str(root / "videos"),
                   caption_root=str(root / "captions"), num_frames=4,
                   video_size=16, max_words=6, num_candidates=3,
                   max_failure_rate=1.0)

    src = HowTo100MSource(cfg(DataConfig), ModelConfig(),
                          decoder=video.FakeDecoder(),
                          tokenizer=Tokenizer(_VOCAB, 6),
                          log_fn=lambda _m: None)
    jsrc = JaxHowTo100MSource(cfg(JaxDataConfig), JaxModelConfig(),
                              decoder=jax_video.FakeDecoder(),
                              tokenizer=JaxTokenizer(_VOCAB, 6),
                              log_fn=lambda _m: None)
    return src, jsrc


def _same(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      err_msg=k)


@pytest.mark.parametrize("spec", ["decode.raise@1,2", "decode.raise@%2",
                                  "decode.raise@*"],
                         ids=["first-two", "every-other", "every"])
def test_decode_raise_resamples_as_jax(spec, howto_dir):
    """The same schedule in both registries: each source resamples the
    same draws (``sample_clip`` raises), counts the same failures, and
    falls back to black frames when every retry fails."""
    src, jsrc = _sources(howto_dir)
    got, want = [], []
    for source, registry, out in ((src, faults, got),
                                  (jsrc, jax_faults, want)):
        with registry.armed(spec):
            for idx in range(4):
                out.append(source.sample(idx, np.random.RandomState(idx)))
    for g, w in zip(got, want):
        _same(g, w)
    assert src.decode_failures == jsrc.decode_failures > 0
    if spec == "decode.raise@*":
        assert not any(s["video"].any() for s in got)


def test_decode_raise_in_the_synthetic_source_as_jax():
    cfg = dict(num_frames=2, video_size=8, max_words=4, num_candidates=2)
    src = SyntheticVideoTextSource(DataConfig(**cfg), vocab_size=16)
    jsrc = JaxSyntheticSource(JaxDataConfig(**cfg), vocab_size=16)
    for source, registry, exc in ((src, faults, faults.InjectedFault),
                                  (jsrc, jax_faults,
                                   jax_faults.InjectedFault)):
        with registry.armed("decode.raise@2"):
            source.sample(0, None)
            with pytest.raises(exc, match="decode.raise"):
                source.sample(1, None)
            source.sample(2, None)


def test_decode_hang_is_timed_out_and_retried_as_jax():
    """A hung decode (occurrence 1 sleeps past the watchdog) is timed out
    and decoded again: the batch is the JAX loader's under the same
    schedule, nothing fell back to black frames."""
    cfg = dict(num_frames=2, video_size=8, max_words=4, num_candidates=2,
               synthetic_num_samples=8)
    kw = dict(seed=0, num_threads=2, sample_timeout=0.2, timeout_retries=2)
    got = want = None
    for registry, make in (
            (faults, lambda: ShardedLoader(
                SyntheticVideoTextSource(DataConfig(**cfg), vocab_size=16), 4,
                log_fn=lambda _m: None, **kw)),
            (jax_faults, lambda: JaxShardedLoader(
                JaxSyntheticSource(JaxDataConfig(**cfg), vocab_size=16), 4,
                **kw))):
        with registry.armed("decode.hang@1:x=1.0"):
            loader = make()
            gen = loader.epoch(0)
            batch = next(gen)
            gen.close()
        assert loader.decode_timeouts >= 1
        if registry is faults:
            got = stack_batch(batch)
        else:
            want = batch
    _same(got, want)
    assert all(got["video"][i].any() for i in range(4))


# --------------------------------------------------------------- save site
def test_save_ioerror_is_retried_then_reraised(tmp_path):
    state = {"w": torch.ones(4)}
    retries = obs_metrics.registry().counter(
        "milnce_ckpt_save_retries_total")
    before = retries.value
    mgr = CheckpointManager(str(tmp_path / "run"), keep=2, save_retries=1,
                            retry_backoff=0.01)
    with faults.armed("ckpt.save_ioerror@*"):
        with pytest.raises(OSError, match="ckpt.save_ioerror"):
            mgr.save(1, state)
    assert mgr.latest_epoch() is None
    with faults.armed("ckpt.save_ioerror@1"):       # transient: retried
        assert mgr.save(1, state)
    assert mgr.latest_epoch() == 1
    assert torch.equal(mgr.restore(1)["w"], state["w"])
    assert retries.value - before == 2


# ------------------------------------------------------------- step site
_DIMS = dict(num_classes=16, vocab_size=32, word_embedding_dim=8,
             text_hidden_dim=16, inception_blocks=1)
_B, _K, _FRAMES, _SIZE, _WORDS, _STEPS = 4, 2, 4, 32, 5, 3


def _batches():
    out = []
    for i in range(_STEPS):
        rng = np.random.default_rng(90 + i)
        out.append((rng.integers(0, 255, (_B, _FRAMES, _SIZE, _SIZE, 3),
                                 dtype=np.uint8),
                    rng.integers(0, 32, (_B * _K, _WORDS)).astype(np.int64),
                    np.zeros(_B, np.float32)))
    return out


@pytest.fixture(scope="module")
def variables():
    v = JaxS3D(**_DIMS).init(
        jax.random.PRNGKey(0),
        jnp.zeros((2, _FRAMES, _SIZE, _SIZE, 3), jnp.float32),
        jnp.zeros((2 * _K, _WORDS), jnp.int32))
    return jax.tree_util.tree_map(np.asarray, v)


def _jax_run(variables, micro_batches, spec):
    with jax.enable_x64(True), jax_faults.armed(spec):
        model = JaxS3D(dtype=jnp.float64, **_DIMS)
        opt_cfg = JaxOptimConfig(warmup_steps=2)
        opt = jax_build_optimizer(opt_cfg, jax_build_schedule(opt_cfg, 10))
        state = create_train_state(jax.tree_util.tree_map(
            lambda a: a.astype(np.float64), variables), opt)
        mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
        cfg = JaxLossConfig(milnce_impl="dense")
        step = (jax_make_grad_cache_step(model, opt, mesh, micro_batches,
                                         donate=False, loss_cfg=cfg,
                                         finite_guard=True)
                if micro_batches > 1 else
                jax_make_train_step(model, opt, mesh, donate=False,
                                    loss_cfg=cfg, finite_guard=True))
        losses, skips = [], []
        for video_, text, start in _batches():
            state, value, skipped = step(state, video_, text.astype(np.int32),
                                         start)
            losses.append(float(value))
            skips.append(int(skipped))
        sd = flax_to_torch_state_dict({
            "params": jax.tree_util.tree_map(np.asarray, state.params),
            "batch_stats": jax.tree_util.tree_map(np.asarray,
                                                  state.batch_stats)})
    return losses, skips, sd


def _port_run(variables, micro_batches, spec, first_step=0, batches=None):
    model = load_jax_variables(S3D(**_DIMS).to(torch.float64), variables)
    opt_cfg = OptimConfig(warmup_steps=2)
    optimizer, sched = build_optimizer(model, opt_cfg,
                                       build_schedule(opt_cfg, 10))
    cfg = LossConfig(milnce_impl="dense")
    kw = dict(finite_guard=True, lr_scheduler=sched, first_step=first_step)
    with faults.armed(spec) if spec else contextlib.nullcontext():
        step = (make_grad_cache_step(model, optimizer, micro_batches, cfg,
                                     **kw)
                if micro_batches > 1 else
                make_train_step(model, optimizer, cfg, **kw))
    losses, skips, states = [], [], []
    for video_, text, start in batches or _batches():
        loss, skipped = step(torch.from_numpy(video_), torch.from_numpy(text),
                             torch.from_numpy(start))
        losses.append(float(loss))
        skips.append(skipped)
        states.append({k: v.clone() for k, v in model.state_dict().items()})
    return losses, skips, states, optimizer, sched


@pytest.mark.parametrize("micro_batches", [1, 2], ids=["plain", "grad-cache"])
def test_grad_nonfinite_skips_the_same_step_as_jax(micro_batches, variables):
    """Armed when the step is built, ``grad.nonfinite@2`` poisons the
    reduced gradients of optimizer step 2 in both packages: both skip it,
    keep parameters, moments and BatchNorm statistics (and, in the port,
    ``num_batches_tracked``), and train on identically."""
    jl, js, jsd = _jax_run(variables, micro_batches, "grad.nonfinite@2")
    tl, ts, states, optimizer, sched = _port_run(variables, micro_batches,
                                                 "grad.nonfinite@2")
    assert js == ts == [0, 1, 0]
    np.testing.assert_allclose(tl, jl, RTOL, ATOL)
    keys = [k for k in jsd if not k.endswith("num_batches_tracked")]
    for key in keys:
        np.testing.assert_allclose(states[-1][key].numpy(), jsd[key], RTOL,
                                   ATOL, err_msg=key)
    for key, val in states[0].items():       # the skip kept step 1's state
        assert torch.equal(states[1][key], val), key
    assert sched.last_epoch == 2
    assert all(int(s["step"]) == 2 for s in optimizer.state.values())
    # the schedule is read once, when the step is built
    _, ts_after, *_ = _port_run(variables, micro_batches, "")
    assert ts_after == [0, 0, 0]


def test_grad_nonfinite_counts_from_the_restored_step(variables):
    """A step resumed after optimizer step 1 counts on from 2: the
    fault's occurrence is the optimizer step number, as the JAX
    ``state.step + 1``."""
    _, skips, *_ = _port_run(variables, 2, "grad.nonfinite@2", first_step=1,
                             batches=_batches()[:2])
    assert skips == [1, 0]


# ------------------------------------------------------------ run_training
def _run_cfg(root, name):
    cfg = tiny_preset()
    cfg.parallel.platform = "cpu"
    cfg.model.inception_blocks = 1
    cfg.train.batch_size = 8
    cfg.data.synthetic_num_samples = 32
    cfg.data.num_reader_threads = 2
    cfg.train.checkpoint_root = str(root / f"ckpt_{name}")
    cfg.train.log_root = str(root / f"log_{name}")
    return cfg


def test_host_sites_together_through_run_training(tmp_path):
    """decode.raise + decode.hang + ckpt.save_ioerror armed together over
    the HowTo100M source (fake decoder): the source resamples the corrupt
    decodes, the watchdog times the hung one out, the exit save survives
    its first IOError, the run reaches max_steps, and the registry is
    disarmed after (the JAX ``test_chaos_host_sites_combined_run_survives``)."""
    cfg = _run_cfg(tmp_path, "hostsites")
    rows = ["video_path"] + [f"vid{i}.mp4" for i in range(16)]
    (tmp_path / "train.csv").write_text("\n".join(rows) + "\n")
    (tmp_path / "captions").mkdir()
    for i in range(16):
        (tmp_path / "captions" / f"vid{i}.json").write_text(json.dumps(
            {"start": [0.0, 6.0], "end": [5.0, 12.0],
             "text": ["pour the batter", "flip the pancake"]}))
    cfg.data.train_csv = str(tmp_path / "train.csv")
    cfg.data.video_root = str(tmp_path)
    cfg.data.caption_root = str(tmp_path / "captions")
    cfg.data.synthetic = False
    cfg.data.decoder_backend = "fake"
    cfg.data.sample_timeout = 0.3
    cfg.data.sample_timeout_retries = 2
    cfg.train.max_steps = 2
    cfg.train.faults = ("decode.raise@1,2;decode.hang@3:x=3.0;"
                        "ckpt.save_ioerror@1")
    lines = []
    res = loop.run_training(cfg, log=lines.append)
    assert res.steps == 2 and np.isfinite(res.last_loss)
    out = "\n".join(lines)
    assert "Decode failures: 2" in out, out
    assert "Decode timeouts:" in out, out
    assert faults._active() is None
    mgr = CheckpointManager(os.path.join(cfg.train.checkpoint_root, "run"),
                            create=False)
    assert mgr.latest_epoch() is not None


def test_host_preempt_drains_the_run_at_its_step(tmp_path):
    """``host.preempt@2`` through run_training: the drain controller's
    once-a-step poll fires at step 2 (the JAX loop's site), the run saves
    under ``elastic.drain`` and returns drained, and the registry counted
    the fire."""
    cfg = _run_cfg(tmp_path, "preempt")
    cfg.train.faults = "host.preempt@2"
    lines = []
    res = loop.run_training(cfg, log=lines.append)
    assert res.drained and res.steps == 2
    assert "drain (host.preempt) — checkpointing and exiting" in lines
    names = [json.loads(line)["name"] for line in open(
        os.path.join(cfg.train.log_root, "RUN_EVENTS.jsonl"))]
    assert names.count("preempt.signal") == names.count("elastic.drain") == 1
    assert "ckpt.save" not in names
    assert faults._active() is None


def test_host_slow_sleeps_inside_the_step_span(tmp_path):
    """``host.slow@2:x=1`` through run_training: step 2's ``step`` span
    (and the step time ``on_step`` reports) holds the 1 s sleep, step 3's
    does not."""
    cfg = _run_cfg(tmp_path, "slow")
    cfg.train.max_steps = 3
    cfg.train.faults = "host.slow@2:x=1.0"
    secs = {}
    loop.run_training(cfg, log=lambda _m: None,
                      on_step=lambda s, t, _l, _w: secs.__setitem__(s, t))
    spans = {r["step"]: r["dur_ms"] for r in map(json.loads, open(
        os.path.join(cfg.train.log_root, "RUN_EVENTS.jsonl")))
        if r["name"] == "step"}
    assert spans[2] >= 1000 and secs[2] >= 1.0
    assert spans[3] < 1000 and secs[3] < 1.0


def test_guard_skips_the_faulted_step_and_counts_across_a_resume(tmp_path):
    """``grad.nonfinite@2`` through run_training skips step 2 (the display
    says so; the JAX ``test_chaos_grad_nonfinite_guard_skips_and_run_
    survives``); stopped after step 1 and resumed, the same spec skips the
    resumed run's first step: the count goes on from the checkpoint."""
    cfg = _run_cfg(tmp_path, "gnan")
    cfg.train.faults = "grad.nonfinite@2"
    cfg.train.max_steps, cfg.train.n_display = 3, 1
    lines = []
    res = loop.run_training(cfg, log=lines.append)
    assert res.steps == 3 and res.skipped_steps == 1 and res.rollbacks == 0
    assert np.isfinite(res.last_loss)
    assert re.findall(r"Skipped steps: (\d+)", "\n".join(lines)) == \
        ["0", "1", "1"]
    cfg = _run_cfg(tmp_path, "gnan-resumed")
    cfg.train.max_steps, cfg.train.n_display = 1, 1
    loop.run_training(cfg, log=lambda _m: None)
    cfg.train.resume, cfg.train.faults = True, "grad.nonfinite@2"
    lines, steps = [], []
    res = loop.run_training(cfg, log=lines.append,
                            on_step=lambda s, *_: steps.append(s))
    assert steps == [2] and res.skipped_steps == 1
    assert "Skipped steps: 1" in "\n".join(lines)


def test_breaker_rolls_back_on_faulted_steps(tmp_path):
    """Every step non-finite: after two consecutive skips the breaker
    restores the rotation checkpoint and goes on past the window (the JAX
    ``test_chaos_circuit_breaker_rolls_back_and_resumes``)."""
    cfg = _run_cfg(tmp_path, "breaker")
    cfg.optim.epochs = 2
    cfg.train.max_steps = 2
    assert loop.run_training(cfg, log=lambda _m: None).rollbacks == 0
    cfg.train.resume = True
    cfg.train.faults = "grad.nonfinite@*"
    cfg.train.skip_rollback_after = 2
    cfg.train.n_display = 2
    cfg.train.max_steps = 3
    lines = []
    res = loop.run_training(cfg, log=lines.append)
    assert res.steps == 3 and res.skipped_steps == 3 and res.rollbacks >= 1
    assert any("circuit breaker" in m for m in lines)


def test_malformed_spec_is_refused_before_the_model_is_built(tmp_path,
                                                             monkeypatch):
    cfg = _run_cfg(tmp_path, "bad")
    cfg.train.faults = "decode.raise@0"
    monkeypatch.setattr(loop, "build_model", lambda *a, **k: 1 / 0)
    with pytest.raises(ValueError, match="1-based"):
        loop.run_training(cfg, log=lambda _m: None)
    assert faults._active() is None
