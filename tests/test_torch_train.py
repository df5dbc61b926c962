"""Port parity, training: three optimizer steps of the torch trainer
against the JAX ``make_train_step`` on a one-device ``Mesh``, from the
same weights and the same batches, for the dense and the chunked loss.

Losses and every parameter and BatchNorm statistic are compared leaf by
leaf with ``rtol=2e-4, atol=2e-5`` (the JAX chunked-loss file's train
tolerance: three Adam steps amplify f32 summation-order differences).
Also pinned: the schedule's pre-increment count (the first warmup step
runs at lr 0 in both), the frozen word table, the finite-guard skip, the
finite guard's display window against the JAX loop's helpers, the
refusal of knobs the port does not honour, every embedding width passing
the config check (the stream kernels' deep mode past 768), and the
``milnce-train-torch`` entry point on the CPU.
"""

import contextlib
import dataclasses
import datetime
import importlib.util
import json
import math
import os
import pathlib
import re
import subprocess
import sys
import typing

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from milnce_tpu.config import LossConfig as JaxLossConfig
from milnce_tpu.config import OptimConfig as JaxOptimConfig
from milnce_tpu.models import S3D as JaxS3D
from milnce_tpu.resilience import faults
from milnce_tpu.train.schedule import build_schedule as jax_build_schedule
from milnce_tpu.train.state import build_optimizer as jax_build_optimizer
from milnce_tpu.train.state import create_train_state
from milnce_tpu.train.loop import (_fetch_guard_window, _guard_acc,
                                   _guard_restart)
from milnce_tpu.train.step import make_train_step as jax_make_train_step
from milnce_tpu_torch.config import (PRESETS, Config, LossConfig, OptimConfig,
                                     full_preset, tiny_preset)
from milnce_tpu_torch.models.s3dg import S3D, BatchNorm3d
from milnce_tpu_torch.ops.milnce_stream import STREAM_DMAX
from milnce_tpu_torch.train import loop
from milnce_tpu_torch.train.schedule import build_schedule, cosine_with_warmup
from milnce_tpu_torch.train.state import build_optimizer
from milnce_tpu_torch.train.step import make_train_step
from milnce_tpu_torch.utils.torch_convert import (flax_to_torch_state_dict,
                                                  load_jax_variables)

torch.set_num_threads(1)         # six test workers share the cores

ROOT = pathlib.Path(__file__).resolve().parents[1]
RTOL, ATOL = 2e-4, 2e-5
_B, _K, _FRAMES, _SIZE, _WORDS, _VOCAB = 4, 2, 4, 32, 5, 32
_DIMS = dict(num_classes=16, vocab_size=_VOCAB, word_embedding_dim=8,
             text_hidden_dim=16, inception_blocks=1)
_STEPS = 3


def _batch(i):
    rng = np.random.default_rng(i)
    video = rng.integers(0, 255, (_B, _FRAMES, _SIZE, _SIZE, 3),
                         dtype=np.uint8)
    text = rng.integers(0, _VOCAB, (_B * _K, _WORDS)).astype(np.int32)
    return video, text


def _variables():
    variables = JaxS3D(**_DIMS).init(
        jax.random.PRNGKey(0),
        jnp.zeros((2, _FRAMES, _SIZE, _SIZE, 3), jnp.float32),
        jnp.zeros((2 * _K, _WORDS), jnp.int32))
    return jax.tree_util.tree_map(np.asarray, variables)


def _jax_run(loss_cfg, poison=""):
    """The JAX step from the f32 init, computed in float64.

    Both sides compare leaf by leaf in float64 (the MIL-NCE stream still
    runs in f32 on both, as the JAX scan upcasts/downcasts to f32).  In
    f32 two things break a leaf-by-leaf comparison at this tiny size:
    the JAX BatchNorm's one-pass variance (E[x^2] - E[x]^2) loses ~1e-2
    of some gradients, where the port's two-pass f32 BatchNorm stays
    within ~4e-6 of float64 (ROADMAP.md Queue C); and Adam scales a
    near-zero gradient up to a full lr-sized step, so its last-bit noise
    moves that parameter by a visible fraction of lr."""
    variables = _variables()
    with jax.enable_x64(True), (faults.armed(poison) if poison
                                else contextlib.nullcontext()):
        model = JaxS3D(dtype=jnp.float64, **_DIMS)
        state_vars = jax.tree_util.tree_map(
            lambda a: a.astype(np.float64), variables)
        opt_cfg = JaxOptimConfig(warmup_steps=2)
        opt = jax_build_optimizer(opt_cfg, jax_build_schedule(opt_cfg, 10))
        state = create_train_state(state_vars, opt)
        mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
        step = jax_make_train_step(model, opt, mesh, donate=False,
                                   loss_cfg=loss_cfg, finite_guard=True)
        losses, skips = [], []
        for i in range(_STEPS):
            video, text = _batch(i)
            state, loss, skipped = step(state, video, text,
                                        np.zeros((_B,), np.float32))
            losses.append(float(loss))
            skips.append(int(skipped))
        sd = flax_to_torch_state_dict({
            "params": jax.tree_util.tree_map(np.asarray, state.params),
            "batch_stats": jax.tree_util.tree_map(np.asarray,
                                                  state.batch_stats)})
    return losses, skips, sd, variables


def _torch_run(loss_cfg, variables, poison_step=None,
               dtype=torch.float64):
    model = load_jax_variables(S3D(**_DIMS).to(dtype), variables)
    opt_cfg = OptimConfig(warmup_steps=2)
    optimizer, sched = build_optimizer(model, opt_cfg,
                                       build_schedule(opt_cfg, 10))
    step = make_train_step(model, optimizer, loss_cfg, finite_guard=True,
                           lr_scheduler=sched)
    losses, skips = [], []
    for i in range(_STEPS):
        hooks = []
        if i == poison_step:
            hooks = [p.register_hook(lambda g: g * float("nan"))
                     for p in model.parameters() if p.requires_grad]
        video, text = _batch(i)
        loss, skipped = step(torch.from_numpy(video),
                             torch.from_numpy(text), torch.zeros(_B))
        for h in hooks:
            h.remove()
        losses.append(float(loss))
        skips.append(skipped)
    return losses, skips, model, optimizer, sched


def _assert_same_state(model, want_sd):
    got = model.state_dict()
    keys = [k for k in want_sd if not k.endswith("num_batches_tracked")]
    assert set(keys) == {k for k in got if not k.endswith(
        "num_batches_tracked")}
    for key in keys:
        np.testing.assert_allclose(got[key].numpy(), want_sd[key], RTOL,
                                   ATOL, err_msg=key)


@pytest.mark.parametrize("impl", ["dense", "chunked"])
def test_three_steps_match_jax(impl):
    jax_cfg = JaxLossConfig(milnce_impl=impl, milnce_chunk=3,
                            milnce_backend="scan")
    cfg = LossConfig(milnce_impl=impl, milnce_chunk=3, milnce_backend="scan")
    jl, js, jsd, variables = _jax_run(jax_cfg)
    tl, ts, model, _, _ = _torch_run(cfg, variables)
    assert js == ts == [0] * _STEPS
    np.testing.assert_allclose(tl, jl, RTOL, ATOL)
    _assert_same_state(model, jsd)
    # the float32 trainer, as it runs on the card, lands on the same losses
    tl32, _, _, _, _ = _torch_run(cfg, variables, dtype=torch.float32)
    np.testing.assert_allclose(tl32, jl, RTOL, ATOL)
    # the frozen table never moves
    np.testing.assert_array_equal(
        model.text_module.word_embd.weight.numpy(),
        variables["params"]["text_module"]["word_embd"]["embedding"])


def test_finite_guard_skip_matches_jax():
    """Step 2's gradients are poisoned (the JAX fault site on one side, a
    NaN gradient hook on the other): both skip it, keep parameters,
    moments and BatchNorm statistics, and train on from there."""
    cfg = LossConfig(milnce_impl="dense")
    jl, js, jsd, variables = _jax_run(JaxLossConfig(milnce_impl="dense"),
                                      poison="grad.nonfinite@2")
    tl, ts, model, optimizer, sched = _torch_run(cfg, variables,
                                                 poison_step=1)
    assert js == ts == [0, 1, 0]
    np.testing.assert_allclose(tl, jl, RTOL, ATOL)
    _assert_same_state(model, jsd)
    # two applied updates: the schedule and Adam's count advanced twice
    assert sched.last_epoch == 2
    assert all(int(s["step"]) == 2 for s in optimizer.state.values())


def test_first_warmup_step_uses_lr_zero():
    sched = cosine_with_warmup(1e-3, 2, 10)
    assert sched(0) == 0.0 and sched(1) == pytest.approx(5e-4)
    model = S3D(**_DIMS)
    before = {k: v.clone() for k, v in model.state_dict().items()
              if "running" not in k and "num_batches" not in k}
    opt_cfg = OptimConfig(warmup_steps=2)
    optimizer, lr = build_optimizer(model, opt_cfg,
                                    build_schedule(opt_cfg, 10))
    step = make_train_step(model, optimizer, lr_scheduler=lr)
    step(*(torch.from_numpy(x) for x in _batch(0)), torch.zeros(_B))
    after = model.state_dict()
    for key, val in before.items():
        assert torch.equal(after[key], val), key
    assert optimizer.param_groups[0]["lr"] == pytest.approx(5e-4)


def test_cli_trains_two_steps_on_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT),
               OMP_NUM_THREADS="1")     # six test workers share the cores
    proc = subprocess.run(
        [sys.executable, "-m", "milnce_tpu_torch.train.cli", "--preset",
         "tiny", "--parallel.platform", "cpu", "--train.max_steps", "2",
         "--train.checkpoint_root", str(tmp_path),
         "--train.log_root", str(tmp_path / "log")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.count("Training loss:") == 2
    assert "done: 2 steps" in proc.stdout


# ------------------------------------------- the finite guard's display window
def _tiny_run_cfg(steps, n_display, root):
    """The tiny preset on the CPU, checkpointing under ``root`` and
    logging beside it."""
    cfg = tiny_preset()
    cfg.parallel.platform = "cpu"
    cfg.train.checkpoint_root = str(root)
    cfg.train.log_root = f"{root}-log"
    cfg.train.max_steps, cfg.train.n_display = steps, n_display
    return cfg


def _poison_steps(monkeypatch, poisoned, record):
    """Make ``loop.run_training``'s step NaN in its loss and gradients on
    the calls numbered in ``poisoned`` (from 1), by a forward hook on the
    model; ``record`` gets each call's (loss, skipped), skipped 0 when
    the guard is off."""
    real = loop.make_train_step

    def factory(model, optimizer, loss_cfg, **kwargs):
        step = real(model, optimizer, loss_cfg, **kwargs)

        def run(video, text, start):
            hook = None
            if len(record) + 1 in poisoned:
                hook = model.register_forward_hook(
                    lambda _m, _i, out: tuple(x * float("nan") for x in out))
            try:
                out = step(video, text, start)
            finally:
                if hook is not None:
                    hook.remove()
            loss, skipped = out if kwargs["finite_guard"] else (out, 0)
            record.append((float(loss), skipped))
            return out

        return run

    monkeypatch.setattr(loop, "make_train_step", factory)


def _jax_windows(record, n_display):
    """The JAX loop's display fetches, (mean, consecutive skips), for the
    same (loss, skipped) steps."""
    windows, acc = [], None
    for i, (loss, skipped) in enumerate(record):
        args = (jnp.float32(loss), jnp.int32(skipped))
        if i % n_display == 0:
            consec = acc[2] if acc is not None else jnp.int32(0)
            total = acc[3] if acc is not None else jnp.int32(0)
            acc = _guard_restart(*args, consec, total)
        else:
            acc = _guard_acc(*acc, *args)
        if (i + 1) % n_display == 0 or i + 1 == len(record):
            windows.append(_fetch_guard_window(*acc)[:2])
    return windows


def _shown_means(lines):
    return [float(m) for m in re.findall(r"Training loss: (\S+),",
                                         "\n".join(lines))]


def _same_means(shown, want):
    return [f"{m:.4f}" for m in shown] == [f"{m:.4f}" for m in want]


def test_skipped_step_stays_out_of_the_display_window(monkeypatch, tmp_path):
    """One non-finite step: the guard skips it, the run goes on to
    max_steps, and each displayed window mean is the JAX loop's, over the
    window's valid steps only."""
    record, lines = [], []
    _poison_steps(monkeypatch, {2}, record)
    res = loop.run_training(_tiny_run_cfg(4, 2, tmp_path), log=lines.append)
    assert res.steps == 4 and res.skipped_steps == 1
    assert [s for _, s in record] == [0, 1, 0, 0]
    assert not np.isfinite(record[1][0])     # the skipped step's loss is NaN
    shown = _shown_means(lines)
    want = [m for m, _ in _jax_windows(record, 2)]
    assert len(shown) == len(want) == 2
    assert all(np.isfinite(shown))
    assert _same_means(shown, want)


def test_all_skipped_window_runs_on_below_the_breaker(monkeypatch, tmp_path):
    """A window with no applied update shows a NaN mean, as the JAX loop's
    does, and the run goes on: that window is the breaker's case, and one
    skipped step is below its count."""
    record, lines = [], []
    _poison_steps(monkeypatch, {2}, record)
    res = loop.run_training(_tiny_run_cfg(4, 1, tmp_path), log=lines.append)
    assert res.steps == 4 and res.skipped_steps == 1
    assert [s for _, s in record] == [0, 1, 0, 0]
    shown = _shown_means(lines)
    want = [m for m, _ in _jax_windows(record, 1)]
    assert np.isnan(shown[1]) and np.isnan(want[1])
    assert _same_means(shown, want)


@pytest.mark.parametrize("after,poisoned,halts_at", [
    (2, {2, 3}, 3),        # two consecutive skips trip a breaker of 2
    (3, {2, 3}, None),     # ... but not one of 3
    (2, {2, 4}, None),     # an applied step in between resets the count
    (0, {2, 3}, None),     # 0 turns the breaker off
])
def test_consecutive_skips_trip_the_breaker(monkeypatch, after, poisoned,
                                            halts_at, tmp_path):
    """``train.skip_rollback_after`` consecutive skips halt the run, as the
    JAX loop's breaker does when it has no checkpoint to roll back to (the
    checkpoint root is empty and no epoch ends before step 5); the count
    is the JAX loop's own at every display."""
    record = []
    _poison_steps(monkeypatch, poisoned, record)
    cfg = _tiny_run_cfg(5, 1, tmp_path)
    cfg.train.skip_rollback_after = after
    if halts_at is None:
        res = loop.run_training(cfg, log=lambda _m: None)
        assert res.steps == 5 and res.skipped_steps == len(poisoned)
    else:
        with pytest.raises(FloatingPointError,
                           match=f"{after} consecutive .* at step "
                                 f"{halts_at} "):
            loop.run_training(cfg, log=lambda _m: None)
        assert len(record) == halts_at
    consec = [c for _, c in _jax_windows(record, 1)]
    tripped = [after and c >= after for c in consec]
    assert any(tripped) == (halts_at is not None)
    if halts_at is not None:
        assert tripped.index(True) + 1 == halts_at


def test_unguarded_non_finite_window_halts(monkeypatch, tmp_path):
    """With the guard off a non-finite window mean halts the run, naming
    the step, as the JAX loop's divergence check does."""
    record = []
    _poison_steps(monkeypatch, {2}, record)
    cfg = _tiny_run_cfg(4, 1, tmp_path)
    cfg.train.finite_guard = False
    with pytest.raises(FloatingPointError, match="non-finite .* at step 2"):
        loop.run_training(cfg, log=lambda _m: None)
    assert len(record) == 2


# ---------------------------------------------- knobs the port does not honour
def _other_value(cfg, knob):
    section, field = knob.split(".")
    obj = getattr(cfg, section)
    default = getattr(obj, field)
    typ = typing.get_type_hints(type(obj))[field]
    if typing.get_origin(typ) is typing.Union:
        typ = next(a for a in typing.get_args(typ) if a is not type(None))
    value = {bool: lambda: not default, int: lambda: (default or 0) + 1,
             str: lambda: "set"}[typ]()
    return obj, field, value


def _no_model(*_args, **_kwargs):
    raise AssertionError("the model was built before the refusal")


def test_unported_knob_is_refused_before_the_model_is_built(monkeypatch,
                                                            tmp_path):
    """Every knob is ported (``UNPORTED_KNOBS`` is empty); the refusal
    stays for the next knob the JAX package grows, shown here on one put
    into the table for the test."""
    assert loop.UNPORTED_KNOBS == ()
    knob = "train.n_display"
    monkeypatch.setattr(loop, "UNPORTED_KNOBS", (knob,))
    cfg = _tiny_run_cfg(1, 1, tmp_path)
    obj, field, value = _other_value(cfg, knob)
    setattr(obj, field, value)
    monkeypatch.setattr(loop, "build_model", _no_model)
    with pytest.raises(ValueError, match=re.escape(knob)):
        loop.run_training(cfg, log=lambda _m: None)


def _resume_is_honoured(cfg, root):
    loop.run_training(cfg, log=lambda _m: None)
    cfg.train.resume = True
    lines = []
    res = loop.run_training(cfg, log=lines.append)
    assert "resumed from epoch 0 at batch 1" in lines and res.steps == 1
    assert "Epoch status: 0.5000" in "\n".join(lines)    # step 2 of 4


def _checkpoint_dir_is_honoured(cfg, root):
    cfg.train.checkpoint_dir = "mine"
    loop.run_training(cfg, log=lambda _m: None)
    assert sorted(os.listdir(root)) == ["mine"]
    assert sorted(os.listdir(root / "mine")) == [
        "0", "CURRICULUM_STAMP.json", "ELASTIC_STAMP.json"]


def _pretrain_ckpt_is_honoured(cfg, root):
    """A reference-layout .pth (the DDP wrapper) seeds the weights: the
    first warmup step runs at lr 0, so the trained parameters are the
    file's."""
    ref = loop.build_model(cfg.model, seed=cfg.train.seed + 5)
    path = root / "ref.pth.tar"
    torch.save({"state_dict": {"module." + k: v
                               for k, v in ref.state_dict().items()}}, path)
    cfg.train.pretrain_ckpt = str(path)
    lines = []
    res = loop.run_training(cfg, log=lines.append)
    assert f"loaded pretrained weights from {path}" in lines
    for name, param in res.model.named_parameters():
        assert torch.equal(param, ref.get_parameter(name)), name


def _evaluate_is_honoured(cfg, root):
    """In-training retrieval eval on synthetic clips at epoch 0."""
    csv = root / "eval.csv"
    csv.write_text("key,vid_key,video_id,sentence\n" + "".join(
        f"r{i},m{i},video{i},word{i} word{i + 1}\n" for i in range(3)))
    cfg.train.evaluate, cfg.train.eval_task = True, "msrvtt"
    cfg.data.eval_csv, cfg.data.eval_video_root = str(csv), str(root)
    lines = []
    loop.run_training(cfg, log=lines.append)
    shown = [m for m in lines if m.startswith("msrvtt retrieval: R@1: ")]
    assert len(shown) == 1
    cfg.train.eval_task = "kinetics"
    with pytest.raises(ValueError, match="unknown train.eval_task"):
        loop.run_training(cfg, log=lambda _m: None)


def _coordinator_address_is_honoured(cfg, root):
    """A one-rank gloo group from a ``file://`` rendezvous: the run trains
    through the group's path and leaves the group when it returns (the
    multi-rank runs: tests/test_torch_dist.py)."""
    cfg.parallel.coordinator_address = f"file://{root}/store"
    cfg.parallel.num_processes, cfg.parallel.process_id = 1, 0
    lines = []
    res = loop.run_training(cfg, log=lines.append)
    assert "process group: 1 ranks on gloo" in lines and res.steps == 1
    assert not torch.distributed.is_initialized()
    cfg.parallel.process_id = 1
    with pytest.raises(ValueError, match="process_id=1 outside"):
        loop.run_training(cfg, log=lambda _m: None)


def _num_devices_is_honoured(cfg, root):
    """One rank on the CPU: 1 is the run's world size; 2 passes the
    devices there are and is refused, as the JAX loop refuses it."""
    cfg.parallel.num_devices = 1
    assert loop.run_training(cfg, log=lambda _m: None).steps == 1
    cfg.parallel.num_devices = 2
    with pytest.raises(ValueError, match="num_devices=2 exceeds the 1 "
                                         "visible devices"):
        loop.run_training(cfg, log=lambda _m: None)


def _log_root_is_honoured(cfg, root):
    """The JAX loop's ``<log_root>/<checkpoint_dir>.log`` and ``.jsonl``:
    every message, time-stamped, and one record a display window; and,
    with no ``train.obs_dir``, the span stream and the goodput ledger."""
    cfg.train.log_root, cfg.train.checkpoint_dir = str(root / "logs"), "mine"
    lines = []
    loop.run_training(cfg, log=lines.append)
    assert sorted(os.listdir(root / "logs")) == [
        "GOODPUT.json", "RUN_EVENTS.jsonl", "mine.jsonl", "mine.log"]
    logged = (root / "logs" / "mine.log").read_text().splitlines()
    assert [re.sub(r"^\[\d\d:\d\d:\d\d\] ", "", m) for m in logged] == lines
    events = (root / "logs" / "mine.jsonl").read_text().splitlines()
    assert len(events) == 1 and '"step": 1' in events[0]


def _verbose_is_honoured(cfg, root):
    """``train.verbose false`` writes no log file; the messages still
    reach the caller's ``log``."""
    cfg.train.log_root, cfg.train.verbose = str(root / "logs"), False
    lines = []
    loop.run_training(cfg, log=lines.append)
    assert not (root / "logs").exists() and lines


def _obs_dir_is_honoured(cfg, root):
    """The span stream and the ledger go to ``train.obs_dir``, the run
    log stays in ``log_root``."""
    cfg.train.log_root, cfg.train.obs_dir = str(root / "logs"), str(root / "obs")
    loop.run_training(cfg, log=lambda _m: None)
    assert sorted(os.listdir(root / "obs")) == ["GOODPUT.json",
                                                "RUN_EVENTS.jsonl"]
    assert sorted(os.listdir(root / "logs")) == ["run.jsonl", "run.log"]


def _trace_dir_is_honoured(cfg, root):
    """The run under ``torch.profiler``: a Chrome trace in the directory,
    holding the step's convolutions."""
    cfg.train.trace_dir = str(root / "trace")
    loop.run_training(cfg, log=lambda _m: None)
    trace = (root / "trace" / "trace.json").read_text()
    assert "aten::convolution" in trace


def _capture_dir_is_honoured(cfg, root):
    """SIGUSR1 arms one bounded capture, at the next display, into a
    numbered directory of ``train.capture_dir``, stopped on the loop's
    thread when the run ends within its duration."""
    import signal

    cfg.train.capture_dir = str(root / "captures")
    cfg.train.max_steps = 2
    cfg.train.log_root = str(root / "logs")
    sent = []

    def on_step(step, *_):
        if step == 1:
            os.kill(os.getpid(), signal.SIGUSR1)
            sent.append(step)

    lines = []
    loop.run_training(cfg, log=lines.append, on_step=on_step)
    assert sent == [1]
    assert any(m.startswith("SIGUSR1 profiler capture: {'armed': True")
               for m in lines)
    (trace,) = (root / "captures").glob("capture_001-sigusr1/trace.json")
    assert "aten::convolution" in trace.read_text()
    names = [json.loads(line)["name"] for line in
             (root / "logs" / "RUN_EVENTS.jsonl").read_text().splitlines()]
    assert names.count("capture.start") == names.count("capture.stop") == 1


def _grad_accum_is_honoured(cfg, root):
    """The loop builds the grad-cache step with M = 2 over the rank's
    batch of 4 (two microbatches of 2 clips); its loss is the one shown,
    and it differs from the one-pass step's, whose BatchNorm sees all 4
    clips at once."""
    built, losses = [], {}
    real = loop.make_grad_cache_step

    def spy(model, optimizer, micro_batches, loss_cfg, **kwargs):
        built.append((micro_batches, kwargs["first_step"]))
        return real(model, optimizer, micro_batches, loss_cfg, **kwargs)

    for accum in (1, 2):
        cfg.train.grad_accum = accum
        cfg.train.checkpoint_root = str(root / f"accum{accum}")
        lines = []
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(loop, "make_grad_cache_step", spy)
            loop.run_training(cfg, log=lines.append,
                              on_step=lambda _s, _t, loss, _w:
                              losses.__setitem__(accum, loss))
    assert built == [(2, 0)]
    shown = "\n".join(lines)
    assert "microbatches: 2" in shown
    assert f"Training loss: {losses[2]:.4f}" in shown
    assert not math.isclose(losses[1], losses[2], rel_tol=1e-6)


def _faults_is_honoured(cfg, root):
    """``train.faults`` arms the registry for the run: the step built in
    it poisons step 1's gradients, the guard skips it, and the registry
    is disarmed when the run returns."""
    from milnce_tpu_torch.resilience import faults as port_faults

    cfg.train.faults = "grad.nonfinite@1"
    lines = []
    res = loop.run_training(cfg, log=lines.append)
    assert res.steps == 1 and res.skipped_steps == 1
    assert "Skipped steps: 1" in "\n".join(lines)
    assert port_faults._active() is None


def _curriculum_is_honoured(cfg, root):
    """A two-stage schedule, one step at 2 frames of 16 px and batch 8,
    then the preset's clip at batch 4 (re-skipping the 8 samples
    consumed: 2 steps left of the 4-sample batches): each step runs its
    stage's clip, and the run ends in stage 1."""
    cfg.train.max_steps = 2
    cfg.train.curriculum = ("num_frames=2,resolution=16,batch_size=8,"
                            "until_step=1;num_frames=4,resolution=32")
    shapes, lines = [], []
    real = loop.make_train_step

    def spy(*args, **kwargs):
        step = real(*args, **kwargs)
        return lambda v, t, s: shapes.append(tuple(v.shape)) or step(v, t, s)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(loop, "make_train_step", spy)
        res = loop.run_training(cfg, log=lines.append)
    assert shapes == [(8, 2, 16, 16, 3), (4, 4, 32, 32, 3)]
    assert res.stage == 1 and res.steps == 2
    assert "curriculum: 2f@16 batch 8 -> 4f@32 batch 4 (3 steps planned)" \
        in lines


def _drain_signal_file_is_honoured(cfg, root):
    """The file appearing after step 1 drains the run at step 1: a forced
    save and a drained result."""
    flag = root / "drain.now"
    cfg.train.max_steps = 3
    cfg.train.drain_signal_file = str(flag)
    lines = []
    res = loop.run_training(cfg, log=lines.append,
                            on_step=lambda *_: flag.write_text(""))
    assert res.drained and res.steps == 1
    assert "drain (signal_file) — checkpointing and exiting" in lines
    assert sorted(os.listdir(root / "run")) == [
        "0", "CURRICULUM_STAMP.json", "ELASTIC_STAMP.json"]


def _use_native_reader_is_honoured(cfg, root):
    """The HowTo source decodes through the C++ pipe pump (a stub ffmpeg
    on PATH), and the run trains on the frames of the subprocess path:
    the same loss with the flag off."""
    from milnce_tpu_torch.data import video
    from milnce_tpu_torch.native.build import native_available

    if not native_available():
        pytest.skip("no C++ compiler to build the native library")
    (root / "captions").mkdir()
    (root / "bin").mkdir()
    rows = ["video_path"]
    for i in range(4):
        (root / "captions" / f"vid{i}.json").write_text(json.dumps(
            {"start": [0, 3], "end": [3, 6], "text": ["hello world", "a b"]}))
        rows.append(f"vid{i}.mp4")
    (root / "train.csv").write_text("\n".join(rows) + "\n")
    d = cfg.data
    frames = np.random.RandomState(0).randint(
        0, 256, (d.num_frames + 2, d.video_size, d.video_size, 3))
    (root / "frames.bin").write_bytes(frames.astype(np.uint8).tobytes())
    stub = root / "bin" / "ffmpeg"
    stub.write_text(f"#!/bin/sh\ncat {root / 'frames.bin'}\n")
    stub.chmod(0o755)
    d.synthetic = False
    d.train_csv, d.video_root = str(root / "train.csv"), str(root)
    d.caption_root = str(root / "captions")
    cfg.train.batch_size = 2
    decoded, losses = [], {}
    real = video.NativeFFmpegDecoder.decode

    def spy(self, *args, **kwargs):
        decoded.append(args[0])
        return real(self, *args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PATH", f"{root / 'bin'}:{os.environ['PATH']}")
        mp.setattr(video.NativeFFmpegDecoder, "decode", spy)
        for flag in (False, True):
            d.use_native_reader = flag
            cfg.train.checkpoint_root = str(root / f"native{flag}")
            res = loop.run_training(cfg, log=lambda _m: None,
                                    on_step=lambda _s, _t, loss, _w:
                                    losses.__setitem__(flag, loss))
            assert res.steps == 1
    assert len(decoded) >= 2 and math.isfinite(losses[True])
    assert losses[True] == losses[False]


def _two_ranks(cfg, root, runs):
    """``run_training`` on two gloo ranks for each (label, edit) of
    ``runs``: ``edit(cfg)`` sets the run's knobs on a copy of ``cfg``."""
    import copy

    import torch_dist_worker as worker

    todo = []
    for label, edit in runs:
        c = copy.deepcopy(cfg)
        c.parallel.coordinator_address = f"file://{root}/store-{label}"
        c.parallel.num_processes = 2
        c.train.checkpoint_root = str(root / label)
        c.train.log_root = str(root / f"log-{label}")
        edit(c)
        todo.append((label, c))
    return worker.spawn(worker.train_runs_2d, 2, root, todo,
                        join_group=False)


def _model_axis(size, min_size=256, spec=""):
    def edit(c):
        c.parallel.model_axis, c.parallel.model_parallel_size = "model", size
        c.parallel.fsdp_min_size, c.parallel.sharding_map = min_size, spec
    return edit


def _model_axis_is_honoured(cfg, root):
    """``parallel.model_axis`` with ``model_parallel_size`` 2 trains two
    ranks on the (1 x 2) grid: the map is logged, each rank holds half of
    every sharded parameter, and the losses are the 1-D layout's (the
    batch shards over both axes, local BatchNorm alike)."""
    ranks = _two_ranks(cfg, root, [("one_d", lambda c: None),
                                   ("two_d", _model_axis(2))])
    full = {n: tuple(p.shape) for n, p in
            loop.build_model(cfg.model).named_parameters()}
    assert any(m.startswith("sharding map: ") and m.endswith(
        "| mesh {'data': 1, 'model': 2}") for m in ranks[0]["two_d"]["lines"])
    for r in ranks:
        got = r["two_d"]
        halved = [n for n in full if got["shapes"][n] != full[n]]
        assert halved and all(
            sorted(a // b for a, b in zip(full[n], got["shapes"][n])) ==
            [1] * (len(full[n]) - 1) + [2] for n in halved)
        assert got["losses"][1] == pytest.approx(r["one_d"]["losses"][1],
                                                 rel=2e-4)


def _sharding_map_is_honoured(cfg, root):
    """An override moves the layout as in the JAX map: ``conv1``'s kernel
    forced to replicate stays whole on each rank, one parameter fewer is
    sharded, and the map's hash changes; ``parallel.fsdp_min_size`` at
    its default shards fewer parameters than at 256."""
    ranks = _two_ranks(cfg, root, [
        ("auto", _model_axis(2)),
        ("override", _model_axis(2, spec="conv1/conv/kernel=-")),
        ("default_size", _model_axis(2, min_size=65536))])
    count = {label: int(re.search(r"sharding map: (\d+)/", next(
        m for m in ranks[0][label]["lines"]
        if m.startswith("sharding map: "))).group(1))
        for label in ("auto", "override", "default_size")}
    assert count["override"] == count["auto"] - 1
    assert 0 < count["default_size"] < count["auto"]
    full = loop.build_model(cfg.model).conv1.conv1.weight.shape
    assert ranks[0]["override"]["shapes"]["conv1.conv1.weight"] == tuple(full)
    assert ranks[0]["auto"]["shapes"]["conv1.conv1.weight"] != tuple(full)
    assert ranks[0]["override"]["hash"] != ranks[0]["auto"]["hash"]


_PORTED_KNOBS = {"train.resume": _resume_is_honoured,
                 "train.checkpoint_dir": _checkpoint_dir_is_honoured,
                 "train.pretrain_ckpt": _pretrain_ckpt_is_honoured,
                 "train.evaluate": _evaluate_is_honoured,
                 "parallel.coordinator_address":
                     _coordinator_address_is_honoured,
                 "parallel.num_devices": _num_devices_is_honoured,
                 "train.log_root": _log_root_is_honoured,
                 "train.verbose": _verbose_is_honoured,
                 "train.obs_dir": _obs_dir_is_honoured,
                 "train.trace_dir": _trace_dir_is_honoured,
                 "train.capture_dir": _capture_dir_is_honoured,
                 "train.grad_accum": _grad_accum_is_honoured,
                 "train.faults": _faults_is_honoured,
                 "train.curriculum": _curriculum_is_honoured,
                 "train.drain_signal_file": _drain_signal_file_is_honoured,
                 "data.use_native_reader": _use_native_reader_is_honoured,
                 "parallel.model_axis": _model_axis_is_honoured,
                 "parallel.sharding_map": _sharding_map_is_honoured}


@pytest.mark.parametrize("knob", list(_PORTED_KNOBS))
def test_ported_knob_is_honoured(knob, tmp_path):
    """Each knob that left ``UNPORTED_KNOBS`` does what the JAX loop does
    with it (one step of a 4-step epoch, at a cut depth)."""
    assert knob not in loop.UNPORTED_KNOBS
    cfg = _tiny_run_cfg(1, 1, tmp_path)
    cfg.model.inception_blocks = 2
    cfg.data.synthetic_num_samples = 16
    _PORTED_KNOBS[knob](cfg, tmp_path)


def test_remat_model_builds_and_trains(tmp_path):
    """``model.remat`` builds the checkpointed model with the plain one's
    ``state_dict`` keys and trains: two steps of ``run_training`` land on
    the plain run's losses and weights (the recomputation folds nothing;
    step by step: tests/test_torch_grad_cache.py)."""
    runs = {}
    for remat in (False, True):
        cfg = _tiny_run_cfg(2, 1, tmp_path / f"remat{remat}")
        cfg.model.inception_blocks = 2
        cfg.model.remat = remat
        losses = []
        res = loop.run_training(cfg, log=lambda _m: None,
                                on_step=lambda _s, _t, loss, _w:
                                losses.append(loss))
        assert res.model.remat is remat
        runs[remat] = losses, res.model.state_dict()
    assert runs[True][0] == pytest.approx(runs[False][0], rel=1e-6)
    assert list(runs[True][1]) == list(runs[False][1])
    for key, val in runs[False][1].items():
        torch.testing.assert_close(runs[True][1][key], val, rtol=1e-5,
                                   atol=1e-6, msg=key)


@pytest.mark.parametrize("platform", ["cpu", "cuda"])
def test_num_devices_past_the_devices_is_refused_before_the_model_is_built(
        platform, monkeypatch, tmp_path):
    cfg = _tiny_run_cfg(1, 1, tmp_path)
    cfg.parallel.platform = platform
    visible = torch.cuda.device_count() if platform == "cuda" else 1
    cfg.parallel.num_devices = visible + 1
    monkeypatch.setattr(loop, "build_model", _no_model)
    with pytest.raises(ValueError, match=f"exceeds the {visible} visible"):
        loop.run_training(cfg, log=lambda _m: None)


def test_group_timeout_reaches_the_process_group(monkeypatch, tmp_path):
    """``parallel.group_timeout_s`` is the group's collective timeout, the
    time rank 0's in-training eval has while the other ranks wait."""
    import torch.distributed as dist

    seen = []
    real = dist.init_process_group

    def spy(*args, **kwargs):
        seen.append(kwargs.get("timeout"))
        return real(*args, **kwargs)

    monkeypatch.setattr(dist, "init_process_group", spy)
    cfg = _tiny_run_cfg(1, 1, tmp_path)
    cfg.model.inception_blocks = 2
    cfg.parallel.coordinator_address = f"file://{tmp_path}-store"
    cfg.parallel.num_processes, cfg.parallel.process_id = 1, 0
    cfg.parallel.group_timeout_s = 1234.5
    assert loop.run_training(cfg, log=lambda _m: None).steps == 1
    assert seen == [datetime.timedelta(seconds=1234.5)]
    assert Config().parallel.group_timeout_s == 7200.0


@pytest.mark.parametrize("sync", [False, True])
def test_sync_batchnorm_knob_reaches_every_batchnorm(sync):
    """``model.sync_batchnorm`` hands the run's group to every BatchNorm
    (what that does across ranks: tests/test_torch_dist.py); off, or with
    no group, each normalizes its own batch."""
    cfg = tiny_preset().model
    cfg.inception_blocks, cfg.sync_batchnorm = 1, sync
    group = object()
    model = loop.build_model(cfg, group=group)
    bns = [m for m in model.modules() if isinstance(m, BatchNorm3d)]
    assert bns and all(m.group is (group if sync else None) for m in bns)
    assert all(m.group is None for m in loop.build_model(cfg).modules()
               if isinstance(m, BatchNorm3d))


def test_unported_knobs_are_config_fields():
    cfg = Config()
    for knob in loop.UNPORTED_KNOBS:
        section, field = knob.split(".")
        assert field in {f.name for f in
                         dataclasses.fields(getattr(cfg, section))}, knob


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("preset", sorted(PRESETS))
@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_presets_pass_the_config_check(preset, device):
    loop.check_config(PRESETS[preset](), device)


def test_chip_smoke_configurations_pass_the_config_check():
    smoke = _chip_smoke()
    cfgs = [smoke._small_cfg("chunked", "cuda"),
            smoke._small_cfg("dense", "auto"),
            smoke._full_cfg("milnce", smoke._stream_loss),
            smoke._full_cfg("milnce", smoke._stream_loss, smoke.GC_BATCH,
                            smoke.GC_ACCUM),
            smoke._full_cfg("sdtw_3", smoke._sdtw_loss)]
    for name in smoke.DTW_LOSSES:
        cfgs.append(smoke._small_cfg("dense", "auto"))
        cfgs[-1].loss.name = name
    cfgs.append(smoke._curriculum_cfg())
    for cfg in cfgs:
        loop.check_config(cfg, "cuda")
    loop.check_config(smoke._elastic_cfg("root"), "cuda", smoke.DDP2_WORLD)
    for two_d in (False, True):
        loop.check_config(smoke._resume2d_cfg("root", 1, two_d=two_d),
                          "cuda", smoke.DDP2_WORLD)
    for loss in ("milnce", "sdtw_3"):
        loop.check_config(smoke._fsdp_cfg(loss), "cuda", smoke.FSDP_WORLD)
    plan = loop.curriculum.plan_curriculum(
        loop.curriculum.parse_curriculum(smoke.CURRICULUM),
        smoke.CURRICULUM_SAMPLES, 1)
    assert plan.total_steps == smoke.TRAIN_STEPS


# ------------------------- every depth passes: the kernels' deep mode past 768
@pytest.mark.parametrize("impl,backend,device,batch,on_kernels", [
    ("chunked", "cuda", "cpu", 16, True),
    ("chunked", "cuda", "cuda", 16, True),
    ("chunked", "auto", "cuda", 16, True),    # auto streams on the kernels
    ("chunked", "auto", "cpu", 16, False),
    ("chunked", "scan", "cuda", 16, False),
    ("dense", "cuda", "cuda", 16, False),
    ("auto", "auto", "cuda", 1024, True),     # past the dense budget
    ("auto", "auto", "cuda", 16, False),      # dense
    ("auto", "cuda", "cpu", 1024, True),
])
def test_stream_depth_is_checked_at_build_time(impl, backend, device, batch,
                                               on_kernels):
    """Each configuration that was refused past the kernels' held depth
    (MIL-NCE streaming on them: backend ``cuda``, or ``auto`` on a CUDA
    device) now passes the check at D = 769, 1024 and 2048: the kernels
    take it in their deep mode.  The route is unchanged: the card still
    never falls back to the plain stream."""
    cfg = full_preset()
    cfg.loss.milnce_impl, cfg.loss.milnce_backend = impl, backend
    cfg.train.batch_size = batch
    route = loop.milnce_route(cfg.loss, batch, batch,
                              cfg.data.num_candidates, device)
    assert (route == "cuda") == on_kernels
    for d in (STREAM_DMAX, STREAM_DMAX + 1, 1024, 2048):
        cfg.model.embedding_dim = d
        loop.check_config(cfg, device)
    cfg.loss.name = "sdtw_3"                   # no MIL-NCE stream at all
    loop.check_config(cfg, device)


@pytest.mark.parametrize("device,route", [("cuda", "cuda"), ("cpu", "scan")])
def test_milnce_route_follows_the_device_and_the_global_batch(device, route):
    """``auto`` streams on the kernels on a CUDA device and on the plain
    twin on the CPU; the global batch decides ``auto``'s impl (B_local
    128 against Bg 8192 streams, B 128 alone stays dense)."""
    cfg = full_preset()
    cfg.loss.milnce_impl = "auto"
    assert loop.milnce_route(cfg.loss, 128, 8192, 5, device) == route
    assert loop.milnce_route(cfg.loss, 128, 128, 5, device) == "dense"
    cfg.train.batch_size = 8192
    loop.check_config(cfg, device, world=64)
    cfg.model.embedding_dim = 1024         # the deep mode on the card
    loop.check_config(cfg, device, world=64)


def test_run_training_refuses_the_depth_before_anything_runs(monkeypatch,
                                                              tmp_path):
    """D = 1024 is no longer refused: on a host without a card the only
    refusal of a ``cuda`` run is the missing card, before the model is
    built; on the CPU the same configuration trains a step on the plain
    stream at D = 1024."""
    cfg = _tiny_run_cfg(1, 1, tmp_path)
    cfg.model.inception_blocks = 1
    cfg.parallel.platform = "cuda"
    cfg.loss.milnce_impl, cfg.loss.milnce_backend = "chunked", "auto"
    cfg.model.embedding_dim = 1024
    if not torch.cuda.is_available():
        with monkeypatch.context() as m:
            m.setattr(loop, "build_model", _no_model)
            with pytest.raises(RuntimeError, match="no CUDA device"):
                loop.run_training(cfg, log=lambda _m: None)
    cfg.parallel.platform = "cpu"
    lines = []
    res = loop.run_training(cfg, log=lines.append)
    assert res.steps == 1 and math.isfinite(res.last_loss)
    assert any(m.startswith("MIL-NCE: streamed on the plain PyTorch stream")
               and m.endswith("D 1024)") for m in lines)
