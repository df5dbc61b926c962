"""Port parity, curriculum training: ``train/curriculum.py`` against the
JAX package's ``milnce_tpu/train/curriculum.py``, and the port's loop
walking the plan.

- ``parse_curriculum``: every case of ``tests/test_curriculum.py``'s
  grammar table gives the same stages, or a ``ValueError`` with the same
  message.
- ``plan_curriculum``: over a sweep of specs x ``num_samples`` x
  ``epochs``, the segments, ``locate``, ``stage_at``, the epoch
  start/end/steps and ``total_steps`` equal JAX's (or both refuse with
  the same message); a flat plan agrees with ``resume_batch_offset`` and
  ``stop_save_label``.
- ``trial_step`` (the pre-flight's trial) changes nothing in the model;
  on the CPU the pre-flight is disarmed and the run log says so.
- The loop at the tiny preset (one inception block, 16 and 32 pixel
  clips): a two-stage run trains each step on the batch shape, sample
  ids and captions of JAX's plan and loader; resumes in the middle of a
  stage and at a stage boundary land at JAX's offsets and log JAX's
  line; a resume with the schedule removed is refused before any
  restore; a check refuses a stage batch that does not split over the
  ranks or into microbatches.

The JAX loop's own curriculum run is not the oracle (it fails on this
jax version); its pure-host functions are.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from milnce_tpu.config import DataConfig as JaxDataConfig
from milnce_tpu.data.pipeline import ShardedLoader as JaxShardedLoader
from milnce_tpu.data.synthetic import (
    SyntheticVideoTextSource as JaxSyntheticSource)
from milnce_tpu.train import curriculum as jcurr
from milnce_tpu.train.loop import stop_save_label_planned as jax_stop_planned
from milnce_tpu_torch.config import tiny_preset
from milnce_tpu_torch.models.build import build_model
from milnce_tpu_torch.train import curriculum as curr
from milnce_tpu_torch.train import loop
from milnce_tpu_torch.train.schedule import build_schedule
from milnce_tpu_torch.train.state import build_optimizer
from milnce_tpu_torch.train.step import make_grad_cache_step, make_train_step

torch.set_num_threads(1)         # six test workers share the cores

TWO_STAGE = ("num_frames=4,resolution=32,until_step=3;"
             "num_frames=8,resolution=32")


# --------------------------------------------------------------- the grammar
def _stages(fn, spec, default):
    try:
        return [dataclasses.astuple(s)
                for s in fn(spec, default_batch_size=default)]
    except ValueError as exc:
        return ("ValueError", str(exc))


_GRAMMAR = [
    ("", 8),
    (TWO_STAGE, 8),
    ("num_frames=4,fps=2;num_frames=8,resolution=32", 8),
    ("num_frames=x,resolution=32", 8),
    ("num_frames=0,resolution=32", 8),
    ("num_frames=4,resolution=32,until_step=2,until_epoch=1;"
     "num_frames=8,resolution=32", 8),
    ("num_frames=4,resolution=32,until_step=2", 8),
    ("num_frames=4,resolution=32;num_frames=8,resolution=32", 8),
    ("num_frames=4", 8),
    ("/no/such/artifact.json", 8),
    ("num_frames=4,resolution=32", None),
    ("num_frames=4,resolution=32,until_epoch=1,batch_size=16;"
     "num_frames=8,resolution=112", None),
    ("num_frames=4,resolution=32,until_step=2;;num_frames=8,resolution=32,", 8),
    ("num_frames=4,resolution=32,oops;num_frames=8,resolution=32", 8),
]


@pytest.mark.parametrize("spec,default", _GRAMMAR)
def test_parse_curriculum_matches_jax(spec, default):
    assert _stages(curr.parse_curriculum, spec, default) == \
        _stages(jcurr.parse_curriculum, spec, default)


@pytest.mark.parametrize("payload", [
    {"curriculum": [{"num_frames": 4, "resolution": 64, "batch_size": 16,
                     "until_epoch": 1},
                    {"num_frames": 8, "resolution": 112, "batch_size": 8}]},
    [{"num_frames": 4, "resolution": 64, "until_step": 5},
     {"num_frames": 8, "resolution": 112}],
    {"curriculum": "not a list"},
    [3, {"num_frames": 8, "resolution": 112}],
])
def test_json_artifact_matches_jax(payload, tmp_path):
    art = tmp_path / "sched.json"
    art.write_text(json.dumps(payload))
    assert _stages(curr.parse_curriculum, str(art), 8) == \
        _stages(jcurr.parse_curriculum, str(art), 8)


# ------------------------------------------------------------------ the plan
def _plan_view(mod, spec, num_samples, epochs):
    """Everything a plan answers, as plain values (or the refusal)."""
    try:
        stages = mod.parse_curriculum(spec, default_batch_size=8)
        plan = mod.plan_curriculum(stages, num_samples, epochs)
    except ValueError as exc:
        return ("ValueError", str(exc))
    view = {"total": plan.total_steps,
            "segments": [dataclasses.astuple(s) for s in plan.segments]}
    for step in range(plan.total_steps + 2):
        seg, off = plan.locate(step)
        view[("locate", step)] = (dataclasses.astuple(seg), off,
                                  plan.stage_at(step))
    for epoch in range(epochs + 1):
        view[("epoch", epoch)] = (plan.epoch_start_step(epoch),
                                  plan.epoch_end_step(epoch),
                                  plan.epoch_steps(epoch),
                                  len(plan.segments_for_epoch(epoch)))
        for step in range(plan.total_steps + 1):
            view[("stop", epoch, step)] = (
                loop.stop_save_label_planned(epoch, step, plan)
                if mod is curr else jax_stop_planned(epoch, step, plan))
    return view


_SPECS = [
    "num_frames=4,resolution=32,batch_size=8",
    TWO_STAGE,
    "num_frames=4,resolution=32,batch_size=8,until_step=3;"
    "num_frames=8,resolution=32,batch_size=4",
    "num_frames=4,resolution=32,batch_size=4,until_step=5;"
    "num_frames=8,resolution=32,batch_size=8,until_epoch=2;"
    "num_frames=8,resolution=64,batch_size=6",
    "num_frames=2,resolution=16,batch_size=16,until_epoch=1;"
    "num_frames=4,resolution=32,batch_size=8",
    "num_frames=4,resolution=32,until_step=40;num_frames=8,resolution=32",
    "num_frames=4,resolution=32,batch_size=64;",
]


@pytest.mark.parametrize("spec", _SPECS)
@pytest.mark.parametrize("num_samples,epochs", [(48, 1), (48, 3), (50, 2),
                                                (17, 2)])
def test_plan_matches_jax(spec, num_samples, epochs):
    assert _plan_view(curr, spec, num_samples, epochs) == \
        _plan_view(jcurr, spec, num_samples, epochs)


@pytest.mark.parametrize("num_samples,batch,epochs", [(48, 8, 2), (50, 7, 3),
                                                      (8, 8, 1)])
def test_flat_plan_matches_the_modulo_helpers(num_samples, batch, epochs):
    cfg = tiny_preset()
    plan = curr.plan_curriculum(curr.flat_stages(cfg.data, batch),
                                num_samples, epochs)
    spe = num_samples // batch
    assert plan.total_steps == spe * epochs
    for step in range(plan.total_steps):
        seg, off = plan.locate(step)
        assert seg.skip_batches + off == loop.resume_batch_offset(step, spe)
    for epoch in range(epochs):
        for step in range(epoch * spe + 1, (epoch + 1) * spe + 1):
            assert (loop.stop_save_label_planned(epoch, step, plan)
                    == loop.stop_save_label(epoch, step, spe))


def test_stage_configs_swap_only_the_shapes():
    cfg = tiny_preset()
    st = curr.CurriculumStage(num_frames=8, resolution=112, batch_size=4)
    out = curr.stage_config(cfg, st)
    assert (out.data.num_frames, out.data.video_size) == (8, 112)
    assert dataclasses.replace(out.data, num_frames=cfg.data.num_frames,
                               video_size=cfg.data.video_size) == cfg.data
    assert out.train == cfg.train and out.model == cfg.model


# ------------------------------------------------------------- the pre-flight
def _tiny_model():
    cfg = tiny_preset()
    cfg.model.inception_blocks = 1
    return cfg, build_model(cfg.model, seed=3)


@pytest.mark.parametrize("micro_batches", [1, 2])
def test_trial_step_leaves_the_model_as_it_was(micro_batches):
    """The pre-flight's trial runs a forward and a backward (BatchNorm in
    train mode) and puts back every parameter, gradient and buffer,
    ``num_batches_tracked`` included."""
    cfg, model = _tiny_model()
    optimizer, sched = build_optimizer(model, cfg.optim,
                                       build_schedule(cfg.optim, 10))
    step = (make_train_step(model, optimizer, cfg.loss, finite_guard=True,
                            lr_scheduler=sched) if micro_batches == 1 else
            make_grad_cache_step(model, optimizer, micro_batches, cfg.loss,
                                 finite_guard=True, lr_scheduler=sched))
    rng = np.random.RandomState(0)
    video = torch.from_numpy(rng.randint(0, 256, (4, 4, 32, 32, 3),
                                         dtype=np.uint8))
    text = torch.from_numpy(rng.randint(1, 64, (4, 8)).astype(np.int64))
    step(video, text, torch.zeros(4))          # grads and Adam state exist
    before = {k: v.clone() for k, v in model.state_dict().items()}
    grads = {n: p.grad.clone() for n, p in model.named_parameters()
             if p.grad is not None}
    curr.trial_step(step, model, video[:2], text[:2], torch.zeros(2))
    for key, val in model.state_dict().items():
        assert torch.equal(val, before[key]), key
    for name, p in model.named_parameters():
        assert (p.grad is None) == (name not in grads), name
        if p.grad is not None:
            assert torch.equal(p.grad, grads[name]), name


def test_budget_is_disarmed_on_the_cpu(monkeypatch):
    monkeypatch.setenv("MILNCE_HBM_GIB", "1.5")
    assert curr.hbm_budget_bytes(torch.device("cpu")) is None


# ------------------------------------------------------------- the loop
def _cfg(tmp_path, spec=TWO_STAGE, samples=24, batch=4, epochs=1):
    cfg = tiny_preset()
    cfg.parallel.platform = "cpu"
    cfg.model.inception_blocks = 1
    cfg.data.synthetic_num_samples = samples
    cfg.data.num_frames, cfg.data.video_size = 8, 32
    cfg.data.num_reader_threads = 2
    cfg.train.batch_size = batch
    cfg.train.curriculum = spec
    cfg.optim.epochs = epochs
    cfg.train.checkpoint_root = str(tmp_path / "ckpt")
    cfg.train.log_root = str(tmp_path / "log")
    return cfg


def _recording(monkeypatch):
    """Each step's (video shape, sample ids, captions) as the port's
    step receives them."""
    seen = []
    real = loop.make_train_step

    def spy(*args, **kwargs):
        step = real(*args, **kwargs)

        def recorded(video, text, start):
            seen.append((tuple(video.shape),
                         start.to(torch.int64).tolist(), text.numpy().copy()))
            return step(video, text, start)

        recorded.fwd_bwd = step.fwd_bwd
        return recorded

    monkeypatch.setattr(loop, "make_train_step", spy)
    return seen


def _jax_batches(cfg, from_step=0):
    """The (video shape, sample ids, captions) JAX's plan and loader give
    each step from ``from_step`` on."""
    stages = jcurr.parse_curriculum(cfg.train.curriculum,
                                    default_batch_size=cfg.train.batch_size)
    data = JaxDataConfig(synthetic_num_samples=cfg.data.synthetic_num_samples,
                         num_candidates=cfg.data.num_candidates,
                         max_words=cfg.data.max_words)
    plan = jcurr.plan_curriculum(stages, data.synthetic_num_samples,
                                 cfg.optim.epochs)
    out = []
    for seg in plan.segments:
        if seg.end_step <= from_step:
            continue
        done = max(0, from_step - seg.start_step)
        st = plan.stages[seg.stage]
        src = JaxSyntheticSource(jcurr.stage_data_config(data, st),
                                 vocab_size=cfg.model.vocab_size)
        ldr = JaxShardedLoader(src, st.batch_size, seed=cfg.train.seed,
                               num_threads=1)
        it = ldr.epoch(seg.epoch, skip_batches=seg.skip_batches + done)
        for _ in range(seg.n_steps - done):
            b = next(it)
            out.append((tuple(b["video"].shape),
                        b["start"].astype(np.int64).tolist(),
                        b["text"].reshape(-1, b["text"].shape[-1])))
        it.close()
    return plan, out


def _assert_batches(got, want):
    assert len(got) == len(want)
    for i, ((gs, gi, gt), (ws, wi, wt)) in enumerate(zip(got, want)):
        assert (gs, gi) == (ws, wi), i
        np.testing.assert_array_equal(gt, wt, err_msg=str(i))


_SWITCH = ("num_frames=4,resolution=16,until_step=3;"
           "num_frames=8,resolution=32,batch_size=8")


def test_two_stage_run_trains_the_jax_plans_batches(tmp_path, monkeypatch):
    """Stage 0 at 4 frames of 16 px and batch 4 for 3 steps, stage 1 at 8
    frames of 32 px and batch 8 (re-skipping the 12 samples consumed):
    every step gets JAX's batch, and the run logs the plan, the switch
    and the disarmed pre-flight."""
    cfg = _cfg(tmp_path, _SWITCH)
    seen = _recording(monkeypatch)
    lines = []
    res = loop.run_training(cfg, log=lines.append)
    plan, want = _jax_batches(cfg)
    _assert_batches(seen, want)
    assert res.steps == plan.total_steps == 4 and res.stage == 1
    assert not res.drained
    assert ("curriculum: 4f@16 batch 4 -> 8f@32 batch 8 (4 steps planned)"
            in lines)
    assert "curriculum: entering stage 1 (8f@32 batch 8) at step 3" in lines
    assert any(m.startswith("curriculum pre-flight skipped") for m in lines)
    stamp = curr.read_stage_stamp(str(tmp_path / "ckpt" / "run"))
    assert stamp == jcurr.read_stage_stamp(str(tmp_path / "ckpt" / "run"))
    assert (stamp["stage"], stamp["step"], stamp["batch_size"]) == (1, 4, 8)
    events = [json.loads(line) for line in
              (tmp_path / "log" / "RUN_EVENTS.jsonl").read_text().splitlines()]
    switch = [e for e in events if e["name"] == "stage.switch"]
    assert len(switch) == 1 and switch[0]["stage"] == 1
    assert {e["stage"] for e in events if e["name"] == "display"} == {0, 1}


@pytest.mark.parametrize("stop", [2, 3])
def test_resume_lands_at_the_jax_offset(stop, tmp_path, monkeypatch):
    """Stopped at step 2 (inside stage 0) or 3 (the boundary), the resumed
    run trains JAX's remaining batches and logs JAX's line."""
    cfg = _cfg(tmp_path, _SWITCH)
    cfg.train.max_steps = stop
    loop.run_training(cfg, log=lambda _m: None)
    seen = _recording(monkeypatch)
    cfg.train.max_steps, cfg.train.resume = None, True
    lines = []
    res = loop.run_training(cfg, log=lines.append)
    plan, want = _jax_batches(cfg, from_step=stop)
    _assert_batches(seen, want)
    seg, off = plan.locate(stop)
    assert (f"resumed from epoch 0 at batch {seg.skip_batches + off} "
            f"(curriculum stage {seg.stage}, "
            f"{plan.stages[seg.stage].label()})") in lines
    assert res.steps == 4 - stop


def test_resume_with_the_schedule_removed_is_refused_before_the_restore(
        tmp_path, monkeypatch):
    cfg = _cfg(tmp_path, _SWITCH)
    cfg.train.max_steps = 2
    loop.run_training(cfg, log=lambda _m: None)
    cfg.train.curriculum, cfg.train.resume = "", True

    def no_restore(*_a, **_k):
        raise AssertionError("a checkpoint was read before the refusal")

    monkeypatch.setattr(loop.CheckpointManager, "restore_latest", no_restore)
    with pytest.raises(ValueError, match="train.curriculum is unset"):
        loop.run_training(cfg, log=lambda _m: None)


@pytest.mark.parametrize("spec,world,accum,match", [
    ("num_frames=4,resolution=16,batch_size=6,until_step=2;"
     "num_frames=8,resolution=32,batch_size=8", 4, 1,
     "curriculum stage 0 batch_size=6 does not split over 4 ranks"),
    ("num_frames=4,resolution=16,batch_size=8,until_step=2;"
     "num_frames=8,resolution=32,batch_size=12", 2, 4,
     r"train.grad_accum=4 does not split a rank's batch of 6 \(curriculum "
     "stage 1\\)"),
    ("num_frames=4,resolution=16,oops", 1, 1, "not key=value"),
])
def test_check_config_refuses_what_a_stage_cannot_run(spec, world, accum,
                                                      match):
    cfg = tiny_preset()
    cfg.train.batch_size = 8
    cfg.train.curriculum, cfg.train.grad_accum = spec, accum
    with pytest.raises(ValueError, match=match):
        loop.check_config(cfg, "cpu", world)
