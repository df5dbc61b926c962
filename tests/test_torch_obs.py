"""Port parity, observability: each module of ``milnce_tpu_torch/obs/`` and
``utils/roofline.py`` against its JAX twin (jax-free, so both import
cheaply), and the port's trainer writing JAX-schema artifacts that the
JAX package's readers and ``scripts/obs_report.py`` accept.

Inputs are seeded (numpy).  Tolerances: exact (``==``) for the Prometheus
text, snapshots, ledgers, merges, detector firings, event sequences and
FLOP counts, which are the same stdlib arithmetic on both sides; the
ledger's categories against an externally measured wall time within
rel 5 % (``tests/test_goodput.py``'s bound); the live MFU gauge against
the formula within rel 1e-12 (one float expression, evaluated twice).
The two-rank streams are in ``tests/test_torch_dist.py``.
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from milnce_tpu.obs import aggregate as j_aggregate
from milnce_tpu.obs import anomaly as j_anomaly
from milnce_tpu.obs import capture as j_capture
from milnce_tpu.obs import export as j_export
from milnce_tpu.obs import goodput as j_goodput
from milnce_tpu.obs import metrics as j_metrics
from milnce_tpu.obs import runctx as j_runctx
from milnce_tpu.obs import spans as j_spans
from milnce_tpu.utils import roofline as j_roofline
from milnce_tpu_torch.config import (PRESETS, full_preset, small_preset,
                                     tiny_preset)
from milnce_tpu_torch.obs import aggregate as t_aggregate
from milnce_tpu_torch.obs import anomaly as t_anomaly
from milnce_tpu_torch.obs import capture as t_capture
from milnce_tpu_torch.obs import export as t_export
from milnce_tpu_torch.obs import goodput as t_goodput
from milnce_tpu_torch.obs import metrics as t_metrics
from milnce_tpu_torch.obs import runctx as t_runctx
from milnce_tpu_torch.obs import spans as t_spans
from milnce_tpu_torch.utils import roofline as t_roofline

torch.set_num_threads(1)         # six test workers share the cores

ROOT = pathlib.Path(__file__).resolve().parents[1]
_OBS_REPORT = str(ROOT / "scripts" / "obs_report.py")


# ------------------------------------------------ each module against JAX's
def _drive_registry(mod, seed):
    """One seeded sequence of counter, gauge and histogram operations on
    a fresh registry of ``mod``."""
    rng = np.random.default_rng(seed)
    reg = mod.MetricsRegistry()
    c = reg.counter("milnce_x_total", "a counter")
    fam = reg.counter("milnce_y_total", "labeled", labels=("kind",))
    g = reg.gauge("milnce_g", "a gauge")
    cb = reg.gauge("milnce_cb", "a callback gauge", fn=lambda: 2.5)
    h = reg.histogram("milnce_h", "a histogram",
                      buckets=(0.1, 1.0, 10.0))
    for _ in range(50):
        op = int(rng.integers(5))
        x = float(rng.exponential(2.0))
        if op == 0:
            c.inc(x)
        elif op == 1:
            fam.labels(kind=["a", "b\"q", "c\nd"][int(rng.integers(3))]).inc()
        elif op == 2:
            g.set(x if rng.random() > 0.1 else float("nan"))
        elif op == 3:
            g.inc(x)
        else:
            h.observe(x)
    assert cb.value == 2.5
    return reg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_exposition_and_snapshot_match_jax(seed):
    j_reg, t_reg = _drive_registry(j_metrics, seed), _drive_registry(
        t_metrics, seed)
    assert t_export.to_prometheus(t_reg) == j_export.to_prometheus(j_reg)
    want = j_export.snapshot(j_reg, kind="k", extra={"q": 1},
                             run_id="r", process_index=3)
    got = t_export.snapshot(t_reg, kind="k", extra={"q": 1}, run_id="r",
                            process_index=3)
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)
    assert t_export.SNAPSHOT_SCHEMA == j_export.SNAPSHOT_SCHEMA


def test_registry_refuses_a_device_tensor():
    class FakeCuda:
        is_cuda = True

    reg = t_metrics.MetricsRegistry()
    with pytest.raises(TypeError, match="host-side only"):
        reg.gauge("milnce_g").set(FakeCuda())


def _records(seed, run_id="r1", process_index=0, steps=12, skip_at=(),
             rollback=False):
    """A seeded span/event stream in the train loop's vocabulary."""
    rng = np.random.default_rng(seed)
    t = 100.0
    recs = []

    def add(kind, name, dur_ms=None, **attrs):
        nonlocal t
        rec = {"kind": kind, "name": name, "ts": t, "mono": t,
               "run_id": run_id, "process_index": process_index, **attrs}
        if dur_ms is not None:
            rec["dur_ms"] = dur_ms
            t += dur_ms / 1e3
        t += 0.001
        recs.append(rec)

    add("event", "run.start", seed=1, batch_size=8, processes=1)
    skipped = 0
    for s in range(1, steps + 1):
        add("span", "data.wait", float(rng.uniform(1, 20)), batch=s - 1)
        add("span", "step", float(rng.uniform(100, 400)), step=s)
        skipped += s in skip_at
        if s % 3 == 0:
            add("span", "sync", float(rng.uniform(0, 2)), cause="display",
                step=s)
            add("event", "display", step=s, epoch=1, loss=1.0, lr=1e-3,
                clips_per_sec=10.0, goodput_fraction=0.9, stage=0,
                skipped_total=skipped)
    if rollback:
        add("span", "ckpt.restore", 30.0, label=0)
        add("event", "rollback", step=steps, restored_epoch=0,
            consecutive_skips=1, lost_updates=2)
    add("event", "anomaly", detector="train.step_ms", value=9.0, ewma=1.0)
    add("event", "capture.start", reason="x", capture=1)
    add("event", "capture.stop", cause="duration")
    add("span", "ckpt.save", 50.0, label=1, forced=True, stage=0)
    add("event", "run.end", steps=steps)
    return recs


@pytest.mark.parametrize("seed,skip_at,rollback", [
    (0, (), False), (1, (4,), False), (2, (5, 6), True)],
    ids=["clean", "skipped", "rollback"])
def test_ledger_and_merges_match_jax(seed, skip_at, rollback):
    recs = _records(seed, skip_at=skip_at, rollback=rollback)
    want = j_goodput.compute_ledger(recs, run_id="r1")
    got = t_goodput.compute_ledger(recs, run_id="r1")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.to_extra() == want.to_extra()
    assert got.summary_line() == want.summary_line()
    assert (t_goodput.select_run(recs + _records(9, run_id="r2"), "r1")
            == j_goodput.select_run(recs + _records(9, run_id="r2"), "r1"))
    j_reg, t_reg = j_metrics.MetricsRegistry(), t_metrics.MetricsRegistry()
    j_goodput.ledger_to_registry(want, j_reg)
    t_goodput.ledger_to_registry(got, t_reg)
    assert t_export.to_prometheus(t_reg) == j_export.to_prometheus(j_reg)
    streams = [recs, _records(seed + 10, process_index=1, skip_at=skip_at)]
    assert (t_aggregate.merge_event_streams(streams)
            == j_aggregate.merge_event_streams(streams))
    docs = [j_export.snapshot(j_reg, kind="goodput", run_id="r1",
                              process_index=i, extra=want.to_extra())
            for i in range(2)]
    assert t_aggregate.merge_snapshots(docs) == j_aggregate.merge_snapshots(
        docs)
    with pytest.raises(ValueError, match="mixed-run merge refused"):
        t_aggregate.merge_event_streams(
            [recs, _records(3, run_id="r2", process_index=1)])


def test_span_recorder_writes_the_jax_records(tmp_path, monkeypatch):
    """The same spans and events, on the same clocks, give the same
    lines on both sides (run context stamped at record time)."""
    lines = {}
    for name, spans, runctx in (("jax", j_spans, j_runctx),
                                ("torch", t_spans, t_runctx)):
        clock = iter(np.arange(1000.0, 2000.0, 0.25))
        monkeypatch.setattr(spans, "_now", lambda: float(next(clock)))
        monkeypatch.setattr(spans, "_wall", lambda: 5.0)
        prev = runctx.set_run_context("rid", 2)
        try:
            rec = spans.SpanRecorder(path=str(tmp_path / f"{name}.jsonl"))
            rec.event("run.start", seed=1)
            with rec.span("step", step=1):
                pass
            with pytest.raises(KeyError):
                with rec.span("ckpt.save", label=3):
                    raise KeyError("x")
            rec.event("run.end", steps=1)
            assert len(rec.tail(2)) == 2 and rec.tail(0) == []
            rec.close()
        finally:
            runctx.set_run_context(*prev)
        lines[name] = (tmp_path / f"{name}.jsonl").read_text()
    assert lines["torch"] == lines["jax"]
    assert '"error": "KeyError"' in lines["torch"]


@pytest.mark.parametrize("seed", [0, 1])
def test_spike_detector_fires_where_jax_does(seed):
    rng = np.random.default_rng(seed)
    values = rng.normal(100.0, 3.0, 60)
    values[[10, 11, 30, 45]] *= [3.0, 3.5, 2.5, 4.0]
    fired = {}
    for name, mod, spans in (("jax", j_anomaly, j_spans),
                             ("torch", t_anomaly, t_spans)):
        clock = iter(np.arange(0.0, 600.0, 10.0))
        rec = spans.SpanRecorder()
        det = mod.EwmaSpikeDetector("train.step_ms", ratio=2.0, warmup=3,
                                    cooldown_s=50.0, recorder=rec,
                                    time_fn=lambda: float(next(clock)))
        fired[name] = ([i for i, v in enumerate(values)
                        if det.observe(float(v), step=i)],
                       [(r["name"], r["value"], r["ewma"], r["step"])
                        for r in rec.tail()], det.stats())
    assert fired["torch"] == fired["jax"]
    assert len(fired["torch"][0]) >= 2


def test_profiler_capture_emits_the_jax_event_sequence(tmp_path):
    """Injected start/stop: arm, refusals (active, budget, cooldown), the
    duration timer's stop and a manual stop give the same events."""
    seqs = {}
    for name, mod, spans in (("jax", j_capture, j_spans),
                             ("torch", t_capture, t_spans)):
        now = [0.0]
        calls = []
        rec = spans.SpanRecorder()
        cap = mod.ProfilerCapture(
            str(tmp_path / "cap"), duration_s=1.0, cooldown_s=10.0,
            max_captures=2, recorder=rec,
            start_fn=lambda d: calls.append(("start", os.path.basename(d))),
            stop_fn=lambda: calls.append(("stop",)),
            time_fn=lambda: now[0])
        verdicts = [cap.arm("spike/..", step=1), cap.arm("again")]
        # the duration timer's stop has finished when its event is in the
        # stream (its thread sets the state idle just before recording it)
        deadline = time.monotonic() + 60
        while (not any(r["name"] == "capture.stop" for r in rec.tail())
               and time.monotonic() < deadline):
            time.sleep(0.01)
        verdicts.append(cap.arm("cool"))        # within the cooldown
        now[0] = 100.0
        # both captures read the duration when armed: the second one's
        # timer can never beat the manual stop, however loaded the host
        cap.duration_s = 3600.0
        verdicts.append(cap.arm("second"))
        verdicts.append(cap.stop(cause="manual"))
        verdicts.append(cap.arm("third"))       # budget exhausted
        cap.close()
        seqs[name] = (
            [{k: v for k, v in r.items() if k not in ("ts", "mono")}
             for r in rec.tail()],
            verdicts, calls, cap.stats()["captures"])
    assert seqs["torch"] == seqs["jax"]
    names = [r["name"] for r in seqs["torch"][0]]
    assert names == ["capture.start", "capture.stop", "capture.start",
                     "capture.stop"]


@pytest.mark.parametrize("preset", ["tiny", "small", "full"])
def test_roofline_counts_match_jax(preset):
    cfg = PRESETS[preset]()
    m, d = cfg.model, cfg.data
    kw = dict(space_to_depth=m.space_to_depth,
              inception_blocks=m.inception_blocks,
              embedding_dim=m.embedding_dim)
    for b in (1, cfg.train.batch_size):
        assert (t_roofline.train_step_flops(
            b, d.num_frames, d.video_size, d.num_candidates, d.max_words,
            word_dim=m.word_embedding_dim, hidden=m.text_hidden_dim, **kw)
            == j_roofline.train_step_flops(
                b, d.num_frames, d.video_size, d.num_candidates,
                d.max_words, word_dim=m.word_embedding_dim,
                hidden=m.text_hidden_dim, **kw))
        assert (t_roofline.video_fwd_flops(b, d.num_frames, d.video_size,
                                           **kw)
                == j_roofline.video_fwd_flops(b, d.num_frames, d.video_size,
                                              **kw))
    # the same table at the same rates; the port names the compute side
    # by the H100's FMA units where the JAX table names the MXU
    args = (cfg.train.batch_size, d.num_frames, d.video_size)
    rates = dict(peak_flops=67e12, hbm_bw=3.35e12, dtype_bytes=4)
    assert (t_roofline.roofline_table(*args, **rates).replace("FMA", "MXU")
            == j_roofline.roofline_table(*args, **rates))
    assert t_roofline.mfu(3e12, 2.0, 67e12, 1) == j_roofline.mfu(
        3e12, 2.0, 67e12, 1)


def test_device_peak_knows_only_the_h100(monkeypatch):
    monkeypatch.delenv("MILNCE_PEAK_FLOPS", raising=False)
    assert t_roofline.device_peak_flops("NVIDIA H100 80GB HBM3") == 67e12
    assert t_roofline.device_peak_flops("NVIDIA H100 PCIe") == 51e12
    for other in ("cpu", "NVIDIA A100-SXM4-80GB", "TPU v5e"):
        assert t_roofline.device_peak_flops(other) is None
    assert not hasattr(t_roofline, "PEAK_FLOPS_BY_KIND")
    monkeypatch.setenv("MILNCE_PEAK_FLOPS", "2.5e12")
    assert t_roofline.device_peak_flops("cpu") == 2.5e12


# ------------------------------------------ the slice: the port's trainer
def _tiny_cfg(root, samples=16):
    cfg = tiny_preset()
    cfg.parallel.platform = "cpu"
    cfg.model.inception_blocks = 1
    cfg.train.batch_size = 8
    cfg.train.n_display = 1
    cfg.data.synthetic_num_samples = samples
    cfg.data.num_reader_threads = 2
    cfg.train.checkpoint_root = str(root / "ckpt")
    cfg.train.log_root = str(root / "log")
    return cfg


def _read_events(cfg, name="RUN_EVENTS.jsonl"):
    path = os.path.join(cfg.train.log_root, name)
    assert os.path.exists(path)
    with open(path) as fh:
        return path, [json.loads(line) for line in fh]


def _run_report(*args):
    proc = subprocess.run([sys.executable, _OBS_REPORT, *args],
                          capture_output=True, text=True, timeout=120)
    return proc.returncode, proc.stdout + proc.stderr


@pytest.fixture(scope="module")
def two_step_run(tmp_path_factory):
    """One 2-step CPU run of the port under ``MILNCE_PEAK_FLOPS``, read by
    the tests below, with the registry's MFU and throughput gauges as
    the run left them."""
    from milnce_tpu_torch.train.loop import run_training

    cfg = _tiny_cfg(tmp_path_factory.mktemp("torch_obs_two_step"))
    cfg.train.run_id = "torch-2step"
    old = os.environ.get("MILNCE_PEAK_FLOPS")
    os.environ["MILNCE_PEAK_FLOPS"] = "1e12"
    try:
        t0 = time.monotonic()
        res = run_training(cfg, log=lambda _m: None)
        wall = time.monotonic() - t0
    finally:
        if old is None:
            del os.environ["MILNCE_PEAK_FLOPS"]
        else:
            os.environ["MILNCE_PEAK_FLOPS"] = old
    reg = t_metrics.registry()
    gauges = {name: reg.gauge(name).value for name in
              ("milnce_train_mfu", "milnce_train_clips_per_sec")}
    return dict(cfg=cfg, res=res, wall=wall, gauges=gauges)


def test_two_step_run_writes_run_events(two_step_run):
    """``tests/test_obs.py``'s end-to-end assertions on the port's run."""
    cfg, res = two_step_run["cfg"], two_step_run["res"]
    assert res.steps == 2 and np.isfinite(res.last_loss)
    path, records = _read_events(cfg)
    steps = [r for r in records if r["kind"] == "span" and r["name"] == "step"]
    saves = [r for r in records
             if r["kind"] == "span" and r["name"] == "ckpt.save"]
    assert [r["step"] for r in steps] == [1, 2]
    assert all(r["dur_ms"] >= 0 for r in steps)
    assert saves
    # the run's stream detached: later events go to the previous recorder
    assert t_spans.get_recorder().path != path
    code, out = _run_report(path)
    assert code == 0 and "ckpt.save" in out


def test_two_step_run_ledger_sums_to_measured_wall(two_step_run):
    """``tests/test_goodput.py``'s ledger acceptance on the port's run:
    every line and the snapshot carry the run identity, the categories
    sum to the measured wall within 5 %, and the JAX package's
    ``compute_ledger`` reads the port's stream into the ledger the port
    wrote."""
    cfg = two_step_run["cfg"]
    path, records = _read_events(cfg)
    for r in records:
        assert r["run_id"] == "torch-2step" and r["process_index"] == 0
        assert "mono" in r
    names = [r["name"] for r in records]
    assert names.count("data.wait") >= 2 and names.count("display") == 2
    assert names[0] == "run.start" and names[-1] == "run.end"
    gp_path = os.path.join(cfg.train.log_root, "GOODPUT.json")
    with open(gp_path) as fh:
        doc = json.load(fh)
    assert doc["schema"] == j_export.SNAPSHOT_SCHEMA
    assert doc["kind"] == "goodput" and doc["run_id"] == "torch-2step"
    assert doc["process_index"] == 0 and doc["steps"] == 2
    total = sum(doc["categories_s"].values())
    assert total == pytest.approx(two_step_run["wall"], rel=0.05), (
        doc["categories_s"], two_step_run["wall"])
    assert 0.0 <= doc["goodput_fraction"] <= 1.0
    jax_ledger = j_goodput.compute_ledger(records, run_id="torch-2step")
    assert {k: v for k, v in jax_ledger.to_extra().items()} == {
        k: doc[k] for k in jax_ledger.to_extra()}
    code, out = _run_report(gp_path)
    assert code == 0 and "wall-time attribution" in out


def test_live_mfu_gauge_agrees_with_the_formula(two_step_run):
    """After ``tests/test_goodput.py``'s MFU acceptance: the live gauge is
    the roofline step FLOPs times the displayed steps/s over the peak."""
    cfg = two_step_run["cfg"]
    live = two_step_run["gauges"]["milnce_train_mfu"]
    clips = two_step_run["gauges"]["milnce_train_clips_per_sec"]
    assert live > 0 and clips > 0
    flops = j_roofline.train_step_flops(
        cfg.train.batch_size, cfg.data.num_frames, cfg.data.video_size,
        cfg.data.num_candidates, cfg.data.max_words,
        inception_blocks=cfg.model.inception_blocks,
        embedding_dim=cfg.model.embedding_dim,
        word_dim=cfg.model.word_embedding_dim,
        hidden=cfg.model.text_hidden_dim)
    expected = j_roofline.mfu(flops, clips / cfg.train.batch_size, 1e12, 1)
    assert live == pytest.approx(expected, rel=1e-12)
    _, records = _read_events(cfg)
    displays = [r for r in records if r["name"] == "display"]
    assert displays and all("mfu" in r for r in displays)
    with open(os.path.join(cfg.train.log_root, "GOODPUT.json")) as fh:
        doc = json.load(fh)
    assert doc["mfu"] == round(live, 5)
    assert "anomaly" not in [r["name"] for r in records]


def test_planted_spike_fires_one_anomaly_and_one_capture(tmp_path,
                                                          monkeypatch):
    """After ``tests/test_goodput.py``'s spike acceptance: step 8's display
    window reads 30 s more than it took, planted in the step timer whose
    window time the detector reads (so the spike does not depend on the
    host's load), and that fires one anomaly and one bounded
    torch.profiler capture with a trace file."""
    from milnce_tpu_torch.train import loop
    from milnce_tpu_torch.train.loop import run_training

    cfg = _tiny_cfg(tmp_path, samples=64)
    cfg.train.run_id = "torch-spike"
    cfg.train.max_steps = 8
    cfg.train.capture_dir = str(tmp_path / "captures")
    cfg.train.capture_ms = 100.0
    cfg.train.anomaly_warmup, cfg.train.anomaly_ratio = 3, 2.0
    planted, step_secs = [0.0], []

    class PlantedTimer(loop.StepTimer):
        @property
        def elapsed_s(self):
            return super().elapsed_s + planted[0]

    def on_step(step, secs, _loss, wait):
        step_secs.append(secs + wait)
        planted[0] = 30.0 if step == 8 else 0.0

    monkeypatch.setattr(loop, "StepTimer", PlantedTimer)
    res = run_training(cfg, log=lambda _m: None, on_step=on_step)
    assert res.steps == 8
    _, records = _read_events(cfg)
    names = [r["name"] for r in records]
    anomalies = [r for r in records if r["name"] == "anomaly"]
    assert len(anomalies) == 1 and anomalies[0]["step"] == 8, (
        step_secs, [r.get("clips_per_sec") for r in records
                    if r["name"] == "display"])
    assert anomalies[0]["detector"] == "train.step_ms"
    assert names.count("capture.start") == names.count("capture.stop") == 1
    start = next(r for r in records if r["name"] == "capture.start")
    assert start["reason"] == "step_time_spike"
    assert os.path.getsize(os.path.join(start["trace_dir"],
                                        "trace.json")) > 0
    with open(os.path.join(cfg.train.log_root, "GOODPUT.json")) as fh:
        doc = json.load(fh)
    assert doc["anomalies"] == 1 and doc["captures"] == 1


def test_presets_are_the_port_configs():
    """The presets the roofline parity runs are the port's own."""
    assert {"tiny", "small", "full"} <= set(PRESETS)
    assert PRESETS["full"] is full_preset and PRESETS["small"] is small_preset
