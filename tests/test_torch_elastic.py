"""Port parity, elastic training: ``elastic/`` (stamp, drain, straggler)
against the JAX package's ``milnce_tpu/elastic/``, and the port's loop
draining and resuming.

- Stamps cross-read both ways: the two packages write the same bytes
  for the same arguments (both sidecars), and each reads the other's.
  On a table of world sizes, indivisible batches, stale pairs and
  removed schedules, ``check_topology_resume`` and
  ``check_resume_compatible`` give the same verdict: the same refusal
  or the same note.
- ``StragglerPolicy``: the same observations give JAX's events,
  demotions, skew and ``ledger_extra``.  ``DrainController``: SIGTERM,
  the signal file and ``host.preempt@N`` trip at the same poll as
  JAX's, with the same ``preempt.signal`` event.
- The loop at W = 1 (tiny preset, one inception block): a run drained
  at step 2 by each of the three sources returns ``drained``, writes
  both stamps at step 2 and puts its forced save in the ledger's drain
  bucket; resumed to the end it equals the uninterrupted run bit for bit
  (float32 on the CPU is deterministic).  The CLI exits 75 on a drain.
- At W = 2 over gloo (``tests/torch_dist_worker.py``, one spawn for all
  runs): ``host.preempt`` on rank 1 alone stops both ranks at the synced
  step 2 with one stamp ``{"data": 2}``; resumed at W = 1 with the same
  global batch (sync BatchNorm, so the two world sizes normalize alike)
  it trains steps 3-4 on the uninterrupted W = 1 run's samples, and its
  losses equal the uninterrupted W = 2 run's within
  ``tests/test_torch_dist.py``'s step tolerance (rtol 2e-4), the
  uninterrupted W = 1 run's through step 3, and at step 4 lie no further
  from W = 1's than the uninterrupted W = 2 run does (Adam's first
  updates are sign-like, so the world size's float32 reduction order
  alone moves step 4 by ~7e-4 relative at the tiny preset's warmup); a
  world size that does not split the batch is refused; ``host.slow`` on
  rank 1 makes rank 0's straggler policy name rank 1.

The JAX loop's own elastic runs are not the oracle (they fail on this
jax version); its pure-host functions, and the port's own uninterrupted
run, are.
"""

import json
import os
import signal

import numpy as np
import pytest
import torch

import torch_dist_worker as worker
from milnce_tpu.elastic import drain as jax_drain
from milnce_tpu.elastic import stamp as jax_stamp
from milnce_tpu.elastic import straggler as jax_straggler
from milnce_tpu.resilience import faults as jax_faults
from milnce_tpu.train import curriculum as jcurr
from milnce_tpu_torch import elastic
from milnce_tpu_torch.config import tiny_preset
from milnce_tpu_torch.elastic import drain, stamp, straggler
from milnce_tpu_torch.resilience import faults
from milnce_tpu_torch.train import cli, loop
from milnce_tpu_torch.train import curriculum as curr

torch.set_num_threads(1)         # six test workers share the cores

STEP_RTOL = 2e-4                 # tests/test_torch_dist.py


def _outcome(fn, *args, **kwargs):
    try:
        return fn(*args, **kwargs)
    except ValueError as exc:
        return ("ValueError", str(exc))


# ------------------------------------------------------------------ stamps
_ESTAMP_ARGS = [
    dict(mesh_shape={"data": 2}, sharding_hash="", step=2, stage_index=0,
         batch_offset=2, drained=True),
    dict(mesh_shape={"data": 4, "model": 2}, sharding_hash="abc", step=7,
         stage_index=1, batch_offset=3, drained=False),
]
_SSTAMP_ARGS = [
    dict(spec="", stage_index=0, stage=jcurr.CurriculumStage(32, 224, 16),
         step=4),
    dict(spec="num_frames=8,resolution=112,batch_size=32,until_step=2;"
         "num_frames=32,resolution=224,batch_size=16", stage_index=1,
         stage=jcurr.CurriculumStage(32, 224, 16), step=3),
]


@pytest.mark.parametrize("args", _ESTAMP_ARGS)
def test_elastic_stamp_is_the_jax_file(args, tmp_path):
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    stamp.write_elastic_stamp(str(tmp_path / "port"), **args)
    jax_stamp.write_elastic_stamp(str(tmp_path / "jax"), **args)
    name = elastic.ELASTIC_STAMP_NAME
    assert name == jax_stamp.ELASTIC_STAMP_NAME and stamp.SCHEMA == \
        jax_stamp.SCHEMA
    assert ((tmp_path / "port" / name).read_bytes()
            == (tmp_path / "jax" / name).read_bytes())
    assert (jax_stamp.read_elastic_stamp(str(tmp_path / "port"))
            == stamp.read_elastic_stamp(str(tmp_path / "jax")))
    assert not (tmp_path / "port" / (name + ".tmp")).exists()


@pytest.mark.parametrize("args", _SSTAMP_ARGS)
def test_stage_stamp_is_the_jax_file(args, tmp_path):
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    port_args = dict(args, stage=curr.CurriculumStage(
        *[getattr(args["stage"], f) for f in ("num_frames", "resolution",
                                               "batch_size")]))
    curr.write_stage_stamp(str(tmp_path / "port"), **port_args)
    jcurr.write_stage_stamp(str(tmp_path / "jax"), **args)
    name = curr.STAMP_NAME
    assert name == jcurr.STAMP_NAME
    assert ((tmp_path / "port" / name).read_bytes()
            == (tmp_path / "jax" / name).read_bytes())
    assert (jcurr.read_stage_stamp(str(tmp_path / "port"))
            == curr.read_stage_stamp(str(tmp_path / "jax")))


_SPEC = ("num_frames=8,resolution=112,batch_size=32,until_step=2;"
         "num_frames=32,resolution=224,batch_size=16")
_TOPOLOGY = [   # (stamp, mesh, batch sizes, curriculum stamp)
    (None, {"data": 1}, [8], None),
    (None, {"data": 3}, [8, 6], None),
    ({"mesh": {"data": 2}, "step": 2, "sharding_hash": ""}, {"data": 2},
     [4], {"step": 2}),
    ({"mesh": {"data": 2}, "step": 2, "sharding_hash": ""}, {"data": 1},
     [4], {"step": 2}),
    ({"mesh": {"data": 1}, "step": 6, "sharding_hash": ""}, {"data": 4},
     [32, 16], {"step": 6}),
    ({"mesh": {"data": 2}, "step": 2, "sharding_hash": ""}, {"data": 3},
     [4], {"step": 2}),
    ({"mesh": {"data": 4}, "step": 2}, {"data": 4}, [32, 16], {"step": 5}),
    ({"mesh": {"data": 8}, "step": 4, "sharding_hash": "h"},
     {"data": 4, "model": 2}, [8], None),
    ({"step": 4}, {"data": 2}, [8], None),
]


@pytest.mark.parametrize("case", range(len(_TOPOLOGY)))
def test_topology_verdict_matches_jax(case):
    est, mesh, batches, cst = _TOPOLOGY[case]
    kwargs = dict(mesh_shape=mesh, batch_sizes=batches, curriculum_stamp=cst)
    assert (_outcome(stamp.check_topology_resume, est, **kwargs)
            == _outcome(jax_stamp.check_topology_resume, est, **kwargs))


_COMPAT = [     # (stage stamp, spec now)
    (None, ""),
    ({"curriculum": "", "step": 4}, ""),
    ({"curriculum": _SPEC, "stage": 1, "num_frames": 32, "resolution": 224,
      "batch_size": 16, "step": 3}, ""),
    ({"curriculum": _SPEC, "stage": 0, "num_frames": 8, "resolution": 112,
      "batch_size": 32, "step": 1}, _SPEC),
    ({"curriculum": _SPEC, "stage": 0, "step": 1}, "num_frames=4,"
     "resolution=32"),
]


@pytest.mark.parametrize("case", range(len(_COMPAT)))
def test_resume_compatibility_matches_jax(case):
    st, spec = _COMPAT[case]
    kwargs = dict(curriculum_spec=spec, flat_frames=32, flat_resolution=224,
                  flat_batch=16)
    assert (_outcome(curr.check_resume_compatible, st, **kwargs)
            == _outcome(jcurr.check_resume_compatible, st, **kwargs))


# ------------------------------------------------------------- straggler
class _Rec:
    def __init__(self):
        self.events = []

    def event(self, name, **attrs):
        self.events.append((name, attrs))


def _policy_run(mod, knobs, feeds):
    rec = _Rec()
    try:
        p = mod.StragglerPolicy(recorder=rec, **knobs)
    except ValueError as exc:
        return ("ValueError", str(exc))
    for kind, step, payload in feeds:
        if kind == "observe":
            p.observe(*payload, step=step)
        else:
            p.feed_merged(payload, step=step)
    return rec.events, p.demoted, p.last_skew, p.ledger_extra()


def _feeds(seed, ranks, slow, merged):
    rng = np.random.RandomState(seed)
    feeds = []
    for step in range(1, 13):
        times = {r: 10.0 + rng.rand() for r in range(ranks)}
        if slow is not None and step > 3 and step % 5:
            times[slow] *= 1.6
        if merged:
            feeds.append(("merged", step, {"per_process": {
                r: {"steps": 1 + (step % 3 != 0 or r != 0),
                    "step_ms_p50": t} for r, t in times.items()}}))
        else:
            feeds.extend(("observe", step, (r, t)) for r, t in times.items())
    return feeds


@pytest.mark.parametrize("knobs", [
    dict(), dict(ratio=1.25, window=2, recommend_resize=True),
    dict(ratio=1.5, window=1, history=4), dict(ratio=1.0), dict(window=0)])
@pytest.mark.parametrize("ranks,slow,merged", [(1, None, False),
                                               (2, 1, False), (3, 2, False),
                                               (4, 0, True), (2, 1, True)])
def test_straggler_policy_matches_jax(knobs, ranks, slow, merged):
    feeds = _feeds(ranks + 7 * bool(merged), ranks, slow, merged)
    assert (_policy_run(straggler, knobs, feeds)
            == _policy_run(jax_straggler, knobs, feeds))


# ------------------------------------------------------------------ drain
def _drain_run(mod, fault_mod, source, tmp_path):
    """Six polls of a controller, the drain signal delivered at poll 3 by
    ``source``; returns the verdicts, the source and the events."""
    rec = _Rec()
    flag = str(tmp_path / f"drain-{mod.__name__}")
    ctl = mod.DrainController(signal_file=flag if source == "file" else "",
                              recorder=rec)
    prev = signal.getsignal(signal.SIGTERM)
    ctl.install()
    verdicts = []
    try:
        if source == "host.preempt":
            fault_mod.arm("host.preempt@3")
        for step in range(1, 7):
            if step == 3 and source == "file":
                open(flag, "w").close()
            if step == 3 and source == "sigterm":
                signal.raise_signal(signal.SIGTERM)
            verdicts.append(ctl.poll(step))
    finally:
        fault_mod.disarm()
        ctl.uninstall()
    assert signal.getsignal(signal.SIGTERM) is prev
    return verdicts, ctl.source, ctl.draining, rec.events


@pytest.mark.parametrize("source", ["host.preempt", "file", "sigterm"])
def test_drain_controller_trips_at_the_jax_poll(source, tmp_path):
    got = _drain_run(drain, faults, source, tmp_path)
    assert got == _drain_run(jax_drain, jax_faults, source, tmp_path)
    assert got[0] == [False, False, True, True, True, True]
    assert elastic.DRAINED_EXIT_CODE == jax_drain.DRAINED_EXIT_CODE == 75


# ------------------------------------------------------------- the loop, W=1
def _cfg(root, label, world=None):
    cfg = tiny_preset()
    cfg.parallel.platform = "cpu"
    cfg.model.inception_blocks = 1
    cfg.data.synthetic_num_samples = 16      # 4 global batches of 4
    cfg.data.num_reader_threads = 2
    cfg.train.batch_size = 4
    cfg.optim.epochs = 1
    cfg.train.checkpoint_root = str(root / label)
    cfg.train.log_root = str(root / f"log-{label}")
    if world:
        cfg.model.sync_batchnorm = True
        cfg.parallel.coordinator_address = f"file://{root / ('store-' + label)}"
        cfg.parallel.num_processes = world
    return cfg


def _losses(cfg, on_step=None, ids=None):
    """Run; returns the result, {step: loss}, the log lines.  ``ids``:
    a list that gets each step's sample ids (from the clips' start
    times, the synthetic source's ``idx % 100``)."""
    losses, lines = {}, []

    def record(step, secs, loss, wait):
        losses[step] = loss
        if on_step is not None:
            on_step(step)

    with pytest.MonkeyPatch.context() as mp:
        if ids is not None:
            real = loop.make_train_step

            def spy(*args, **kwargs):
                step = real(*args, **kwargs)

                def recorded(video, text, start):
                    ids.append(sorted(start.to(torch.int64).tolist()))
                    return step(video, text, start)

                return recorded

            mp.setattr(loop, "make_train_step", spy)
        res = loop.run_training(cfg, log=lines.append, on_step=record)
    return res, losses, lines


@pytest.fixture(scope="module")
def whole(tmp_path_factory):
    """The uninterrupted W = 1 run: 4 steps, one epoch."""
    res, losses, _ = _losses(_cfg(tmp_path_factory.mktemp("whole"), "whole"))
    assert res.steps == 4 and not res.drained
    return losses


def _ledger(cfg) -> dict:
    with open(os.path.join(cfg.train.log_root, "GOODPUT.json")) as fh:
        return json.load(fh)


@pytest.mark.parametrize("source", ["signal_file", "host.preempt", "sigterm"])
def test_drained_run_resumes_as_the_uninterrupted_one(source, whole,
                                                      tmp_path):
    cfg = _cfg(tmp_path, "split")
    flag = tmp_path / "drain.now"
    on_step = None
    if source == "signal_file":
        cfg.train.drain_signal_file = str(flag)
        on_step = (lambda step: flag.write_text("") if step == 2 else None)
    elif source == "host.preempt":
        cfg.train.faults = "host.preempt@2"
    else:
        on_step = (lambda step: signal.raise_signal(signal.SIGTERM)
                   if step == 2 else None)
    prev = signal.getsignal(signal.SIGTERM)
    res, losses, lines = _losses(cfg, on_step)
    assert signal.getsignal(signal.SIGTERM) is prev
    assert res.drained and res.steps == 2 and sorted(losses) == [1, 2]
    want = {"signal_file": "signal_file"}.get(source, source)
    assert f"drain ({want}) — checkpointing and exiting" in lines
    run_dir = str(tmp_path / "split" / "run")
    est = jax_stamp.read_elastic_stamp(run_dir)
    assert (est["mesh"], est["step"], est["drained"]) == ({"data": 1}, 2,
                                                          True)
    assert (est["sharding_hash"], est["batch_offset"]) == ("", 2)
    assert jcurr.read_stage_stamp(run_dir)["step"] == 2
    assert _ledger(cfg)["categories_s"].get("drain", 0) > 0
    cfg.train.faults = cfg.train.drain_signal_file = ""
    cfg.train.resume = True
    cfg.train.log_root = str(tmp_path / "log-resumed")
    res, resumed, lines = _losses(cfg)
    assert not res.drained and sorted(resumed) == [3, 4]
    assert "resumed from epoch 0 at batch 2" in lines
    assert {s: whole[s] for s in (1, 2)} == losses
    assert {s: whole[s] for s in (3, 4)} == resumed
    est = stamp.read_elastic_stamp(run_dir)
    assert (est["step"], est["drained"]) == (4, False)


def test_cli_exits_75_on_a_drain(tmp_path, capsys):
    argv = ["--preset", "tiny", "--parallel.platform", "cpu",
            "--model.inception_blocks", "1",
            "--data.synthetic_num_samples", "8", "--train.batch_size", "4",
            "--train.faults", "host.preempt@1",
            "--train.checkpoint_root", str(tmp_path / "ckpt"),
            "--train.log_root", str(tmp_path / "log")]
    with pytest.raises(SystemExit) as exit_:
        cli.main(argv)
    assert exit_.value.code == elastic.DRAINED_EXIT_CODE == 75
    assert ("drained: 1 steps" in capsys.readouterr().out)
    assert stamp.read_elastic_stamp(str(tmp_path / "ckpt" / "run"))["drained"]


# ------------------------------------------------------------- W = 2, gloo
@pytest.fixture(scope="module")
def rank_runs(tmp_path_factory):
    """One spawn of two gloo ranks for the three runs: ``preempt``
    (rank 1 drains at step 1, the flag agreed every 2 steps), ``whole``
    (uninterrupted) and ``slow`` (rank 1 sleeps 1 s in every step: a
    skew of (C + 1) / C over a step of C s, clear of the 1.25 rule on a
    loaded host)."""
    root = tmp_path_factory.mktemp("ranks")
    preempt = _cfg(root, "preempt", world=2)
    preempt.train.preempt_sync_steps = 2
    slow = _cfg(root, "slow", world=2)
    slow.train.n_display = 1
    slow.train.straggler_window = 2
    runs = [("preempt", preempt, {1: "host.preempt@1"}),
            ("whole", _cfg(root, "whole2", world=2), {}),
            ("slow", slow, {1: "host.slow@*:x=1.0"})]
    return root, worker.spawn(worker.rank_fault_runs, 2, root, runs,
                              join_group=False)


def test_preempt_on_one_rank_stops_both_at_the_synced_step(rank_runs):
    root, (r0, r1) = rank_runs
    for res in (r0, r1):
        assert res["preempt"]["drained"] and res["preempt"]["steps"] == 2
        assert sorted(res["preempt"]["losses"]) == [1, 2]
    assert ("drain (cluster peer) — checkpointing and exiting "
            "(cluster-coordinated)") in r0["preempt"]["lines"]
    est = stamp.read_elastic_stamp(str(root / "preempt" / "run"))
    assert (est["mesh"], est["n_devices"], est["step"], est["drained"]) == (
        {"data": 2}, 2, 2, True)


def test_two_ranks_drained_resume_at_one_as_the_uninterrupted_run(
        rank_runs, tmp_path):
    root, (r0, _) = rank_runs
    cfg = _cfg(root, "preempt")
    cfg.model.sync_batchnorm = True
    cfg.train.resume = True
    cfg.train.log_root = str(tmp_path / "log-resumed")
    ids, ids1 = [], []
    res, resumed, lines = _losses(cfg, ids=ids)
    assert sorted(resumed) == [3, 4] and not res.drained
    run_dir = str(root / "preempt" / "run")
    note = jax_stamp.check_topology_resume(
        {"mesh": {"data": 2}, "step": 2, "sharding_hash": ""},
        mesh_shape={"data": 1}, batch_sizes=[4], curriculum_stamp=None)
    assert note in lines
    assert stamp.read_elastic_stamp(run_dir)["mesh"] == {"data": 1}
    one = _cfg(tmp_path, "one")
    one.model.sync_batchnorm = True
    _, whole1, _ = _losses(one, ids=ids1)
    assert ids == ids1[2:]                  # the cursor: the same samples
    got = np.array([r0["preempt"]["losses"][1], r0["preempt"]["losses"][2],
                    resumed[3], resumed[4]])
    w1 = np.array([whole1[s] for s in (1, 2, 3, 4)])
    w2 = np.array([r0["whole"]["losses"][s] for s in (1, 2, 3, 4)])
    np.testing.assert_allclose(got, w2, rtol=STEP_RTOL)
    np.testing.assert_allclose(got[:3], w1[:3], rtol=STEP_RTOL)
    assert abs(got[3] - w1[3]) <= abs(w2[3] - w1[3]) + STEP_RTOL * abs(w1[3])


def test_a_world_size_that_does_not_split_the_batch_is_refused(rank_runs):
    """Resuming the W = 2 drain at W = 3 (batch 4): the port's check and
    both packages' topology guard refuse it, the guard with JAX's
    message."""
    root, _ = rank_runs
    cfg = _cfg(root, "preempt")
    with pytest.raises(ValueError, match="batch_size=4 does not split over "
                                         "3 ranks"):
        loop.check_config(cfg, "cpu", 3)
    est = stamp.read_elastic_stamp(str(root / "preempt" / "run"))
    kwargs = dict(mesh_shape={"data": 3}, batch_sizes=[4],
                  curriculum_stamp=None)
    refusal = _outcome(stamp.check_topology_resume, est, **kwargs)
    assert refusal == _outcome(jax_stamp.check_topology_resume, est, **kwargs)
    assert refusal[0] == "ValueError" and "does not divide" in refusal[1]


def test_slow_rank_is_named_by_the_straggler_policy(rank_runs):
    root, (r0, r1) = rank_runs
    assert r0["slow"]["steps"] == r1["slow"]["steps"] == 4
    log = root / "log-slow"
    events = [json.loads(line) for line in
              (log / "RUN_EVENTS.jsonl").read_text().splitlines()]
    flagged = [e for e in events if e["name"] == "straggler"]
    assert flagged and {e["process"] for e in flagged} == {1}
    assert [e["process"] for e in events
            if e["name"] == "straggler.demote"] == [1]
    with open(log / "GOODPUT.json") as fh:
        assert json.load(fh)["demoted_hosts"] == [1]
    other = [json.loads(line)["name"] for line in
             (log / "RUN_EVENTS.p1.jsonl").read_text().splitlines()]
    assert "straggler" not in other
