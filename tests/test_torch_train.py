"""Port parity, training: three optimizer steps of the torch trainer
against the JAX ``make_train_step`` on a one-device ``Mesh``, from the
same weights and the same batches, for the dense and the chunked loss.

Losses and every parameter and BatchNorm statistic are compared leaf by
leaf with ``rtol=2e-4, atol=2e-5`` (the JAX chunked-loss file's train
tolerance: three Adam steps amplify f32 summation-order differences).
Also pinned: the schedule's pre-increment count (the first warmup step
runs at lr 0 in both), the frozen word table, the finite-guard skip, the
finite guard's display window against the JAX loop's helpers, the
refusal of knobs and depths the port does not honour, and the
``milnce-train-torch`` entry point on the CPU.
"""

import contextlib
import dataclasses
import importlib.util
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
from milnce_tpu_torch.models.s3dg import S3D
from milnce_tpu_torch.ops.milnce_stream import STREAM_DMAX
from milnce_tpu_torch.train import loop
from milnce_tpu_torch.train.schedule import build_schedule, cosine_with_warmup
from milnce_tpu_torch.train.state import build_optimizer
from milnce_tpu_torch.train.step import make_train_step
from milnce_tpu_torch.utils.torch_convert import (flax_to_torch_state_dict,
                                                  load_jax_variables)

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


def test_cli_trains_two_steps_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-m", "milnce_tpu_torch.train.cli", "--preset",
         "tiny", "--parallel.platform", "cpu", "--train.max_steps", "2"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.count("Training loss:") == 2
    assert "done: 2 steps" in proc.stdout


# ------------------------------------------- the finite guard's display window
def _tiny_run_cfg(steps, n_display):
    cfg = tiny_preset()
    cfg.parallel.platform = "cpu"
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


def test_skipped_step_stays_out_of_the_display_window(monkeypatch):
    """One non-finite step: the guard skips it, the run goes on to
    max_steps, and each displayed window mean is the JAX loop's, over the
    window's valid steps only."""
    record, lines = [], []
    _poison_steps(monkeypatch, {2}, record)
    res = loop.run_training(_tiny_run_cfg(4, 2), log=lines.append)
    assert res.steps == 4 and res.skipped_steps == 1
    assert [s for _, s in record] == [0, 1, 0, 0]
    assert not np.isfinite(record[1][0])     # the skipped step's loss is NaN
    shown = _shown_means(lines)
    want = [m for m, _ in _jax_windows(record, 2)]
    assert len(shown) == len(want) == 2
    assert all(np.isfinite(shown))
    assert _same_means(shown, want)


def test_all_skipped_window_runs_on_below_the_breaker(monkeypatch):
    """A window with no applied update shows a NaN mean, as the JAX loop's
    does, and the run goes on: that window is the breaker's case, and one
    skipped step is below its count."""
    record, lines = [], []
    _poison_steps(monkeypatch, {2}, record)
    res = loop.run_training(_tiny_run_cfg(4, 1), log=lines.append)
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
                                            halts_at):
    """``train.skip_rollback_after`` consecutive skips halt the run, as the
    JAX loop's breaker does when it has no checkpoint to roll back to; the
    count is the JAX loop's own at every display."""
    record = []
    _poison_steps(monkeypatch, poisoned, record)
    cfg = _tiny_run_cfg(5, 1)
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


def test_unguarded_non_finite_window_halts(monkeypatch):
    """With the guard off a non-finite window mean halts the run, naming
    the step, as the JAX loop's divergence check does."""
    record = []
    _poison_steps(monkeypatch, {2}, record)
    cfg = _tiny_run_cfg(4, 1)
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


@pytest.mark.parametrize("knob", loop.UNPORTED_KNOBS)
def test_unported_knob_is_refused_before_the_model_is_built(knob,
                                                            monkeypatch):
    cfg = _tiny_run_cfg(1, 1)
    obj, field, value = _other_value(cfg, knob)
    setattr(obj, field, value)
    monkeypatch.setattr(loop, "build_model", _no_model)
    with pytest.raises(ValueError, match=re.escape(knob)):
        loop.run_training(cfg, log=lambda _m: None)


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
            smoke._full_cfg("sdtw_3", smoke._sdtw_loss)]
    for name in smoke.DTW_LOSSES:
        cfgs.append(smoke._small_cfg("dense", "auto"))
        cfgs[-1].loss.name = name
    for cfg in cfgs:
        loop.check_config(cfg, "cuda")


# ------------------------------------------- depths the stream kernels refuse
@pytest.mark.parametrize("impl,backend,device,batch,refused", [
    ("chunked", "cuda", "cpu", 16, True),
    ("chunked", "cuda", "cuda", 16, True),
    ("chunked", "auto", "cuda", 16, True),
    ("chunked", "auto", "cpu", 16, False),
    ("chunked", "scan", "cuda", 16, False),
    ("dense", "cuda", "cuda", 16, False),
    ("auto", "auto", "cuda", 1024, True),     # past the dense budget
    ("auto", "auto", "cuda", 16, False),      # dense
    ("auto", "cuda", "cpu", 1024, True),
])
def test_stream_depth_is_checked_at_build_time(impl, backend, device, batch,
                                               refused):
    cfg = full_preset()
    cfg.loss.milnce_impl, cfg.loss.milnce_backend = impl, backend
    cfg.train.batch_size = batch
    cfg.model.embedding_dim = STREAM_DMAX
    loop.check_config(cfg, device)
    cfg.model.embedding_dim = STREAM_DMAX + 1
    if refused:
        with pytest.raises(ValueError, match=r"model\.embedding_dim=769.*"
                                             r"loss\.milnce_impl dense"):
            loop.check_config(cfg, device)
    else:
        loop.check_config(cfg, device)
    cfg.loss.name = "sdtw_3"                   # no MIL-NCE stream at all
    loop.check_config(cfg, device)


def test_run_training_refuses_the_depth_before_anything_runs(monkeypatch):
    """On a host without a card: the refusal comes before the device is
    resolved and before the model is built."""
    cfg = _tiny_run_cfg(1, 1)
    cfg.parallel.platform = "cuda"
    cfg.loss.milnce_impl, cfg.loss.milnce_backend = "chunked", "auto"
    cfg.model.embedding_dim = 1024
    monkeypatch.setattr(loop, "build_model", _no_model)
    with pytest.raises(ValueError, match="embedding_dim=1024"):
        loop.run_training(cfg, log=lambda _m: None)
