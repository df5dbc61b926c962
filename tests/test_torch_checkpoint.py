"""Port parity, checkpointing: ``train/checkpoint.py``'s manager, the
resume arithmetic of ``train/loop.py`` against the JAX loop's, a stopped
and resumed CPU run against the uninterrupted one, the circuit breaker's
rollback and halts, the divergence halt's post-mortem save, and the
reference ``.pth`` loader against the JAX package's converter.

A resumed run restores every tensor and reads the same batches, so its
losses equal the uninterrupted run's to rel 1e-6 (float32 on the CPU is
deterministic; the bound only absorbs printing through ``float``).
"""

import copy
import os

import numpy as np
import pytest
import torch

from milnce_tpu.config import DataConfig as JaxDataConfig
from milnce_tpu.data.pipeline import ShardedLoader as JaxShardedLoader
from milnce_tpu.data.synthetic import (
    SyntheticVideoTextSource as JaxSyntheticSource)
from milnce_tpu.train.loop import resume_batch_offset as jax_resume_offset
from milnce_tpu.train.loop import stop_save_label as jax_stop_save_label
from milnce_tpu.utils.torch_convert import (
    load_torch_checkpoint_as_flax as jax_load_pth)
from milnce_tpu_torch.config import tiny_preset
from milnce_tpu_torch.data.pipeline import ShardedLoader, stack_batch
from milnce_tpu_torch.models.s3dg import S3D
from milnce_tpu_torch.train import checkpoint as ckpt
from milnce_tpu_torch.train import loop
from milnce_tpu_torch.train.checkpoint import CheckpointManager
from milnce_tpu_torch.utils.torch_convert import (load_jax_variables,
                                                  load_reference_checkpoint)

torch.set_num_threads(1)         # six test workers share the cores


# ------------------------------------------------------ the resume arithmetic
@pytest.mark.parametrize("steps_per_epoch", [1, 3, 4, 7])
def test_resume_arithmetic_matches_jax(steps_per_epoch):
    for step in range(0, 40):
        assert (loop.resume_batch_offset(step, steps_per_epoch)
                == jax_resume_offset(step, steps_per_epoch))
        for epoch in range(4):
            assert (loop.stop_save_label(epoch, step, steps_per_epoch)
                    == jax_stop_save_label(epoch, step, steps_per_epoch))


# ------------------------------------------------------------ the manager
def _state(value):
    return {"model": {"w": torch.full((3,), float(value))},
            "step": int(value), "epoch": int(value)}


def _value(manager, epoch):
    return float(manager.restore(epoch)["model"]["w"][0])


def test_round_trip_and_rotation(tmp_path):
    m = CheckpointManager(str(tmp_path / "run"), keep=2)
    assert m.latest_epoch() is None
    assert m.restore_latest() == (0, None)
    for label in (1, 2, 3, 4):
        assert m.save(label, _state(label * 10))
    assert m.all_epochs() == [3, 4]           # the two newest are kept
    label, state = m.restore_latest()
    assert label == 4 and state["step"] == 40
    torch.testing.assert_close(state["model"]["w"], torch.full((3,), 40.0))
    label, weights = m.restore_raw(3)
    assert label == 3 and list(weights) == ["w"]
    torch.testing.assert_close(weights["w"], torch.full((3,), 30.0))
    # not forced, a label no newer than the latest is skipped (Orbax rule)
    assert not m.save(4, _state(99)) and not m.save(2, _state(99))
    assert _value(m, 4) == 40.0 and m.all_epochs() == [3, 4]


def test_forced_save_replaces_the_label(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=10)
    m.save(1, _state(1))
    assert m.save(1, _state(2), force=True)
    assert _value(m, 1) == 2.0
    assert sorted(os.listdir(tmp_path)) == ["1"]


@pytest.mark.parametrize("killed_at", ["rename", "rmtree"],
                         ids=["moved-aside", "renamed-in"])
def test_interrupted_replacement_is_recovered(tmp_path, monkeypatch,
                                              killed_at):
    """A kill after the stale copy was moved aside (at the rename of the
    new copy into place) keeps the old state; a kill after the new copy
    was renamed in (at the removal of the stale copy) keeps the new one.
    Either way the next open leaves one whole label and no debris."""
    m = CheckpointManager(str(tmp_path), keep=10)
    m.save(1, _state(1))
    module = ckpt.os if killed_at == "rename" else ckpt.shutil
    real = getattr(module, killed_at)

    def killed(src, *args, **kwargs):
        name = os.path.basename(str(src))
        if name.startswith(".tmp-" if killed_at == "rename" else "stale-"):
            raise KeyboardInterrupt
        return real(src, *args, **kwargs)

    monkeypatch.setattr(module, killed_at, killed)
    with pytest.raises(KeyboardInterrupt):
        m.save(1, _state(2), force=True)
    monkeypatch.setattr(module, killed_at, real)
    assert "stale-epoch-1" in os.listdir(tmp_path)
    reopened = CheckpointManager(str(tmp_path), keep=10)
    assert sorted(os.listdir(tmp_path)) == ["1"]
    assert _value(reopened, 1) == {"rename": 1.0, "rmtree": 2.0}[killed_at]


def test_read_only_open_of_a_missing_directory_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "typo"), create=False)
    assert not (tmp_path / "typo").exists()
    CheckpointManager(str(tmp_path)).save(1, _state(1))
    ro = CheckpointManager(str(tmp_path), create=False)
    assert ro.latest_epoch() == 1
    with pytest.raises(PermissionError):
        ro.save(2, _state(2))


@pytest.mark.parametrize("retries,fails", [(2, 2), (1, 2)])
def test_save_retries_a_planted_oserror(tmp_path, monkeypatch, retries,
                                        fails):
    real_save, calls = torch.save, []

    def flaky(obj, path):
        calls.append(path)
        if len(calls) <= fails:
            raise OSError("disk hiccup")
        real_save(obj, path)

    monkeypatch.setattr(torch, "save", flaky)
    m = CheckpointManager(str(tmp_path), save_retries=retries,
                          retry_backoff=0.0)
    if retries >= fails:
        assert m.save(1, _state(1)) and _value(m, 1) == 1.0
    else:
        with pytest.raises(OSError, match="disk hiccup"):
            m.save(1, _state(1))
        assert m.latest_epoch() is None
    assert len(calls) == min(fails, retries) + 1


# --------------------------------------------- runs: resume, breaker, halt
def _cfg(root, steps, samples=16, epochs=2):
    """Tiny CPU run: ``samples // 4`` steps an epoch."""
    cfg = tiny_preset()
    cfg.parallel.platform = "cpu"
    cfg.model.inception_blocks = 2
    cfg.data.synthetic_num_samples = samples
    cfg.optim.epochs = epochs
    cfg.train.max_steps = steps
    cfg.train.checkpoint_root = str(root)
    cfg.train.log_root = f"{root}-log"
    return cfg


_MAKE_TRAIN_STEP = loop.make_train_step


def _spy_steps(monkeypatch, poisoned=()):
    """Wrap ``loop.make_train_step``: each call records its video batch,
    the model's state before the step, its loss and whether it skipped;
    the calls numbered in ``poisoned`` (from 1) get a NaN forward."""
    calls, handles = [], {}
    real = _MAKE_TRAIN_STEP

    def factory(model, optimizer, loss_cfg, **kwargs):
        step = real(model, optimizer, loss_cfg, **kwargs)
        handles.update(model=model, scheduler=kwargs["lr_scheduler"])

        def run(video, text, start):
            before = {k: v.clone() for k, v in model.state_dict().items()}
            hook = None
            if len(calls) + 1 in poisoned:
                hook = model.register_forward_hook(
                    lambda _m, _i, out: tuple(x * float("nan") for x in out))
            try:
                out = step(video, text, start)
            finally:
                if hook is not None:
                    hook.remove()
            loss, skipped = out if kwargs["finite_guard"] else (out, 0)
            calls.append(dict(video=video.clone(), before=before,
                              loss=float(loss), skipped=skipped))
            return out

        return run

    monkeypatch.setattr(loop, "make_train_step", factory)
    return calls, handles


def test_stopped_and_resumed_run_equals_the_uninterrupted_one(tmp_path,
                                                              monkeypatch):
    whole, _ = _spy_steps(monkeypatch)
    loop.run_training(_cfg(tmp_path / "a", 6), log=lambda _m: None)
    first, _ = _spy_steps(monkeypatch)
    loop.run_training(_cfg(tmp_path / "b", 3), log=lambda _m: None)
    # the stop at step 3 of 4 is mid-epoch: label 0, forced
    assert CheckpointManager(str(tmp_path / "b" / "run")).all_epochs() == [0]
    second, _ = _spy_steps(monkeypatch)
    lines = []
    cfg = _cfg(tmp_path / "b", 3)
    cfg.train.resume = True
    res = loop.run_training(cfg, log=lines.append)
    assert res.steps == 3
    offset = jax_resume_offset(3, 4)
    assert f"resumed from epoch 0 at batch {offset}" in lines
    np.testing.assert_allclose([c["loss"] for c in first + second],
                               [c["loss"] for c in whole], rtol=1e-6)
    # the cursor: the resumed run's first batch is the JAX loader's batch
    # at the JAX offset
    jsrc = JaxSyntheticSource(JaxDataConfig(**{
        f: getattr(cfg.data, f) for f in ("num_frames", "video_size",
                                          "max_words", "num_candidates",
                                          "synthetic_num_samples")}),
        vocab_size=cfg.model.vocab_size)
    jbatch = next(JaxShardedLoader(jsrc, 4, seed=cfg.train.seed,
                                   process_index=0, process_count=1)
                  .epoch(0, skip_batches=offset))
    np.testing.assert_array_equal(second[0]["video"].numpy(),
                                  jbatch["video"])
    # epoch 0's boundary save (label 1), then the stop at step 6 (label 1,
    # forced) in the resumed run
    state = CheckpointManager(str(tmp_path / "b" / "run")).restore(1)
    assert state["step"] == 6 and state["epoch"] == 1


def test_fresh_run_over_older_checkpoints_behaves_as_orbax(tmp_path):
    """A run without ``train.resume`` in a directory that holds an older
    run's checkpoints does not crash and does not read them; as with the
    JAX manager, its boundary save of a label no newer than the latest is
    skipped, and a forced stop save writes its own label."""
    loop.run_training(_cfg(tmp_path, 4), log=lambda _m: None)
    m = CheckpointManager(str(tmp_path / "run"))
    old = m.restore(1)["model"]
    cfg = _cfg(tmp_path, 6)
    cfg.train.seed = 2
    res = loop.run_training(cfg, log=lambda _m: None)
    assert res.steps == 6
    # the boundary save of label 1 (step 4) was skipped; the forced stop
    # save at step 6, labeled 1 too, replaced the older run's
    assert m.all_epochs() == [1]
    state = m.restore(1)
    assert state["step"] == 6
    assert any(not torch.equal(state["model"][k], v) for k, v in old.items())
    cfg.train.max_steps = 2
    loop.run_training(cfg, log=lambda _m: None)
    assert m.all_epochs() == [0, 1] and m.restore(0)["step"] == 2


def _breaker(tmp_path, monkeypatch, poisoned, steps):
    cfg = _cfg(tmp_path, steps)
    cfg.train.n_display = 1
    cfg.train.skip_rollback_after = 2
    calls, handles = _spy_steps(monkeypatch, poisoned)
    lines = []
    return cfg, calls, handles, lines


def test_breaker_restores_the_newest_checkpoint_and_trains_on(tmp_path,
                                                              monkeypatch):
    """Label 1 is saved after step 4 (the epoch's end); step 5 applies;
    steps 6-7 skip and trip a breaker of 2 at step 7, which restores label
    1 (dropping step 5's update) and keeps the step counter and the data
    cursor: step 8 starts from label 1's weights on epoch 1's last batch."""
    cfg, calls, handles, lines = _breaker(tmp_path, monkeypatch, {6, 7}, 8)
    res = loop.run_training(cfg, log=lines.append)
    assert res.steps == 8 and res.skipped_steps == 2 and res.rollbacks == 1
    assert [c["skipped"] for c in calls] == [0] * 5 + [1, 1, 0]
    assert ("circuit breaker: 2 consecutive non-finite updates — restored "
            "rotation checkpoint 1, resuming at step 7 past the poisoned "
            "data window") in lines
    saved = CheckpointManager(str(tmp_path / "run")).restore(1)
    assert saved["step"] == 4
    for key, val in saved["model"].items():
        torch.testing.assert_close(calls[7]["before"][key], val, rtol=0,
                                   atol=0)
    assert any(not torch.equal(calls[5]["before"][k], v)
               for k, v in saved["model"].items())
    # the data cursor went on: call 8 got epoch 1's last batch
    loader = ShardedLoader(loop.build_source(cfg), 4, seed=cfg.train.seed)
    want = stack_batch(list(loader.epoch(1))[3])["video"]
    np.testing.assert_array_equal(calls[7]["video"].numpy(), want)
    # restored schedule: 4 updates at label 1, then step 8's
    assert handles["scheduler"].last_epoch == 5
    assert np.isfinite(calls[7]["loss"])


def test_breaker_halts_without_a_checkpoint(tmp_path, monkeypatch):
    cfg, calls, _, _ = _breaker(tmp_path, monkeypatch, {2, 3}, 8)
    with pytest.raises(FloatingPointError,
                       match="2 consecutive non-finite updates at step 3 and "
                             "no rotation checkpoint to roll back to"):
        loop.run_training(cfg, log=lambda _m: None)
    assert len(calls) == 3


def test_breaker_halts_when_no_update_applied_since_the_last_rollback(
        tmp_path, monkeypatch):
    """Steps 5-6 trip the breaker (rollback to label 1); steps 7-8 trip it
    again with no applied update in between: the failure is persistent."""
    cfg, calls, _, lines = _breaker(tmp_path, monkeypatch, {5, 6, 7, 8}, 8)
    with pytest.raises(FloatingPointError,
                       match="ZERO applied updates since the previous "
                             "rollback"):
        loop.run_training(cfg, log=lines.append)
    assert len(calls) == 8
    assert sum("restored rotation checkpoint 1, resuming at step 6" in m
               for m in lines) == 1


def test_divergence_halt_saves_a_post_mortem(tmp_path, monkeypatch):
    cfg = _cfg(tmp_path, 4)
    cfg.train.n_display = 1
    cfg.train.finite_guard = False
    calls, _ = _spy_steps(monkeypatch, {2})
    lines = []
    with pytest.raises(FloatingPointError, match="non-finite .* at step 2"):
        loop.run_training(cfg, log=lines.append)
    pm = CheckpointManager(str(tmp_path / "run" / "nan_postmortem"),
                           create=False)
    assert pm.all_epochs() == [2]
    assert pm.restore(2)["step"] == 2
    assert any("post-mortem state saved under nan_postmortem/2" in m
               for m in lines)
    # the rotation holds nothing: a resume does not pick the NaN state up
    assert CheckpointManager(str(tmp_path / "run")).latest_epoch() is None


# --------------------------------------------------- reference .pth files
_DIMS = dict(num_classes=16, vocab_size=32, word_embedding_dim=8,
             text_hidden_dim=16, inception_blocks=1)


@pytest.mark.parametrize("flavor", ["ddp", "flat"])
def test_reference_pth_loads_as_the_jax_converter_reads_it(tmp_path, flavor):
    src = S3D(**_DIMS)
    torch.manual_seed(7)
    for p in src.parameters():
        p.data.normal_()
    sd = src.state_dict()
    if flavor == "ddp":
        blob = {"epoch": 3, "state_dict": {"module." + k: v
                                           for k, v in sd.items()}}
    else:                               # upstream: no update counters
        blob = {k: v for k, v in sd.items()
                if not k.endswith("num_batches_tracked")}
    path = tmp_path / "ref.pth.tar"
    torch.save(blob, path)
    got = load_reference_checkpoint(S3D(**_DIMS), str(path)).state_dict()
    want = load_jax_variables(S3D(**_DIMS), jax_load_pth(str(path)))
    for key, val in want.state_dict().items():
        torch.testing.assert_close(got[key], val, rtol=0, atol=0)
    for key, val in sd.items():
        if not key.endswith("num_batches_tracked"):
            torch.testing.assert_close(got[key], val, rtol=0, atol=0)


# ------------------------------------- an unfused optimizer's checkpoint
def _unfused_checkpoint(name):
    """A checkpoint as an unfused optimizer writes it (its groups save
    ``fused`` None), after one update of a tiny model."""
    from milnce_tpu_torch.config import LossConfig
    from milnce_tpu_torch.train.state import trainable_parameters
    from milnce_tpu_torch.train.step import make_train_step

    torch.manual_seed(3)
    model = S3D(**_DIMS)
    params = trainable_parameters(model)
    opt = (torch.optim.Adam(params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
           if name == "adam" else
           torch.optim.SGD(params, lr=1e-3, momentum=0.9))
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda _n: 1.0)
    make_train_step(model, opt, LossConfig(milnce_impl="dense"))(*_inputs(0))
    sched.step()
    assert all(g["fused"] is None for g in opt.state_dict()["param_groups"])
    return {"model": model.state_dict(), "optimizer": opt.state_dict(),
            "scheduler": sched.state_dict(), "step": 1, "epoch": 0}


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.integers(0, 255, (4, 4, 32, 32, 3),
                                          dtype=np.uint8)),
            torch.from_numpy(rng.integers(0, 32, (8, 5))),
            torch.zeros(4))


@pytest.mark.parametrize("name", ["adam", "sgd"])
def test_guarded_step_resumes_an_unfused_optimizer_checkpoint(name):
    """``load_train_state`` keeps ``build_optimizer``'s fused form over a
    checkpoint that an unfused optimizer wrote, so the finite guard's
    ``found_inf`` is taken: the resumed guarded step applies its update,
    equal to that of the same checkpoint saved with fused groups, and a
    poisoned step after it moves nothing."""
    from milnce_tpu_torch.config import LossConfig, OptimConfig
    from milnce_tpu_torch.train.schedule import build_schedule
    from milnce_tpu_torch.train.state import build_optimizer
    from milnce_tpu_torch.train.step import make_train_step

    state = _unfused_checkpoint(name)
    fused_sd = {**state["optimizer"], "param_groups": [
        {**g, "fused": True, "foreach": None}
        for g in state["optimizer"]["param_groups"]]}
    runs = []
    for opt_sd in (state["optimizer"], fused_sd):
        model = S3D(**_DIMS)
        cfg = OptimConfig(name=name, warmup_steps=1)
        optimizer, sched = build_optimizer(model, cfg,
                                           build_schedule(cfg, 10))
        # a copy each: the load keeps the saved moments' storage, and
        # the step updates them in place
        assert ckpt.load_train_state(copy.deepcopy(
            {**state, "optimizer": opt_sd}), model, optimizer, sched) == 1
        assert all(g["fused"] and g["foreach"] is None
                   for g in optimizer.param_groups)
        assert sched.last_epoch == 1
        step = make_train_step(model, optimizer,
                               LossConfig(milnce_impl="dense"),
                               finite_guard=True, lr_scheduler=sched,
                               first_step=1)
        before = {k: v.clone() for k, v in model.state_dict().items()}
        loss, skipped = step(*_inputs(1))
        assert int(skipped) == 0 and torch.isfinite(loss)
        assert sched.last_epoch == 2
        after = {k: v.clone() for k, v in model.state_dict().items()}
        assert not torch.equal(after["text_module.fc1.weight"],
                               before["text_module.fc1.weight"])
        hook = model.register_forward_hook(
            lambda _m, _i, out: tuple(x * float("nan") for x in out))
        _, skipped = step(*_inputs(2))
        hook.remove()
        assert int(skipped) == 1 and sched.last_epoch == 2
        for key, val in after.items():
            assert torch.equal(model.state_dict()[key], val), key
        runs.append(after)
    for key, val in runs[1].items():
        assert torch.equal(runs[0][key], val), key
