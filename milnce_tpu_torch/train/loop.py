"""Training loop (a slim port of ``milnce_tpu/train/loop.py``).

Joins the run's process group (``parallel.coordinator_address`` or the
``torchrun`` environment; none for a single process), builds the model
from the seed (or loads ``train.pretrain_ckpt``), resumes from the
newest checkpoint of ``checkpoint_root/checkpoint_dir`` with
``train.resume``, draws this rank's shard of every global batch through
``ShardedLoader`` and ``device_prefetch``, runs ``train.max_steps``
optimizer steps (or all epochs) and prints the JAX loop's display line
every ``n_display`` steps.  It saves a checkpoint at each epoch boundary
(label ``epoch + 1``) and at ``max_steps``, and keeps the JAX loop's
finite-guard window, circuit breaker (roll back to the newest
checkpoint) and divergence halt (with a post-mortem save).  With
``train.evaluate`` it scores ``train.eval_task`` every ``max(1,
batch_size // 512)`` epochs.  With ``train.verbose`` the messages also
go to ``<log_root>/<checkpoint_dir>.log``, the display windows to its
``.jsonl`` twin.

Observability, as the JAX loop has it (``obs/``): a ``run_id`` from rank
0 on every record; the span stream ``RUN_EVENTS.jsonl`` (rank r:
``RUN_EVENTS.p{r}.jsonl``) in ``train.obs_dir or train.log_root`` when
``train.verbose`` is set, with the ``run.start``, ``step``, ``data.wait``,
``sync``, ``display``, ``ckpt.save``, ``ckpt.restore``, ``rollback``,
``anomaly``, ``capture.*`` and ``run.end`` records; the display gauges
(loss, lr, clips/s, skipped steps, rollbacks, live MFU, goodput, stage)
on the process-wide registry; the EWMA step-time spike detector
(``train.anomaly_*``) arming a bounded ``torch.profiler`` capture
(``train.capture_*``, also armed by SIGUSR1); ``train.trace_dir``; and
at the end the goodput ledger, ``GOODPUT.json`` (rank r:
``GOODPUT.p{r}.json``) beside the stream.  The ``step`` span holds the
step's device work; the finite guard keeps its window on the device and
the loop reads it at the display cadence, in the ``sync`` span.

Across ranks, rank 0 logs and saves the checkpoints while the others
wait at a barrier; every rank evaluates its share of the eval source on
its card and gets the same metrics, as the JAX loop evaluates over its
mesh (rank 0 logs them); every rank restores on resume and on a
rollback.  Losses, skips and the displayed clips/s are global.

``train.grad_accum`` M > 1 runs the grad-cache step
(``train/step.py::make_grad_cache_step``): ``train.batch_size`` stays the
global batch, the loader yields each rank's share and the step splits it
into M microbatches; the display, the span stream, the ledger and the
schedule count optimizer steps, and the live MFU is not computed (as in
the JAX loop).  ``train.faults`` arms the fault registry
(``resilience/faults.py``) for the run and disarms it at the end.

The 2-D ``(data, model)`` layout, as the JAX loop has it:
``parallel.model_axis`` with ``parallel.model_parallel_size`` mp > 1
lays the ranks out as a (W / mp, mp) DeviceMesh (``parallel/mesh.py``),
places the model on the sharding map (``parallel/sharding_map.py``:
``parallel.fsdp_min_size``, ``parallel.sharding_map``; a map that shards
nothing is refused) and runs the 2-D step.  The map's hash rides the
run log and ``ELASTIC_STAMP.json``; every save gathers the full state
on every rank (rank 0 writes it), and a resume, the breaker's rollback
and the in-training eval place full tensors on whichever layout the run
has.  ``data.use_native_reader`` decodes HowTo100M through the C++
pipe pump (``data/video.py::NativeFFmpegDecoder``).

Curriculum and elastic training, as the JAX loop has them: every run
goes through a plan (``train/curriculum.py``; a flat run is one
open-ended stage), whose segments the epoch loop walks.  At a stage
boundary the loader is rebuilt at the stage's shapes under a
``stage.switch`` span and the display window starts afresh; a resume
lands where ``plan.locate`` puts the restored step.  On the card a
curriculum run pre-flights every stage's memory before step 1.  Rank 0
writes ``CURRICULUM_STAMP.json`` and ``ELASTIC_STAMP.json`` beside every
save, and a resume checks both before any checkpoint is read.  SIGTERM,
``train.drain_signal_file`` and the ``host.preempt`` fault site drain
the run (``elastic/drain.py``): polled once a step, agreed over the
group every ``train.preempt_sync_steps`` steps, then a forced save under
an ``elastic.drain`` span and ``TrainResult.drained``.  The ``host.slow``
fault site sleeps inside the ``step`` span, and the straggler policy
(``elastic/straggler.py``) reads each rank's step time at the display
cadence.

Precision: the JAX towers run in f32, so TF32 is switched off for both
cuDNN convolutions and CUDA matmuls before anything runs.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import signal
import time
from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.distributed as dist

from milnce_tpu_torch.config import Config
from milnce_tpu_torch.data.datasets import HowTo100MSource, build_tokenizer
from milnce_tpu_torch.data.pipeline import (ShardedLoader, device_prefetch,
                                            flatten_text)
from milnce_tpu_torch.data.synthetic import SyntheticVideoTextSource
from milnce_tpu_torch.data.video import FakeDecoder
from milnce_tpu_torch.elastic import (DrainController, StragglerPolicy,
                                      check_topology_resume,
                                      read_elastic_stamp, write_elastic_stamp)
from milnce_tpu_torch.eval.metrics import format_metrics
from milnce_tpu_torch.eval.runner import EVAL_TASKS, evaluate_task
from milnce_tpu_torch.losses.milnce_chunked import milnce_route
from milnce_tpu_torch.models.build import build_model
from milnce_tpu_torch.obs import export as obs_export
from milnce_tpu_torch.obs import goodput as obs_goodput
from milnce_tpu_torch.obs import metrics as obs_metrics
from milnce_tpu_torch.obs import runctx as obs_runctx
from milnce_tpu_torch.obs import spans as obs_spans
from milnce_tpu_torch.obs.anomaly import EwmaSpikeDetector
from milnce_tpu_torch.obs.capture import ProfilerCapture
from milnce_tpu_torch.parallel.dist import (Ranks, broadcast_str,
                                            gather_floats,
                                            initialize_distributed,
                                            reduce_flag)
from milnce_tpu_torch.parallel.mesh import build_mesh, check_model_axis
from milnce_tpu_torch.parallel.sharding_map import (ShardedPlacement,
                                                    parse_sharding_spec)
from milnce_tpu_torch.resilience import faults
from milnce_tpu_torch.train import curriculum
from milnce_tpu_torch.train.checkpoint import (CheckpointManager,
                                               load_train_state, train_state)
from milnce_tpu_torch.train.schedule import build_schedule_total
from milnce_tpu_torch.train.state import build_optimizer, local_state_bytes
from milnce_tpu_torch.train.step import make_grad_cache_step, make_train_step
from milnce_tpu_torch.utils.logging import RunLogger
from milnce_tpu_torch.utils.profiling import StepTimer, maybe_trace
from milnce_tpu_torch.utils.roofline import (device_peak_flops, mfu,
                                             train_step_flops)
from milnce_tpu_torch.utils.torch_convert import load_reference_checkpoint

# Knobs of the reference loop that this loop does not read yet, as dotted
# names; a run that sets one away from its dataclass default is refused.
# A name leaves the table in the change that ports it: none is left.
UNPORTED_KNOBS: tuple = ()


def check_config(cfg: Config, device_type: str, world: int = 1) -> None:
    """Refuse, before anything is built, what a run of ``world`` ranks on
    ``device_type`` would not honour: every knob of
    :data:`UNPORTED_KNOBS` set away from its default, a malformed
    ``train.curriculum``, a global batch (each stage's, under a
    curriculum) that does not split over the ranks, a rank's batch that
    does not split into ``train.grad_accum`` microbatches, a malformed
    ``train.faults`` spec, straggler knobs the policy refuses, a 2-D
    request the ranks cannot carry (``parallel/mesh.py::check_model_axis``)
    or a malformed ``parallel.sharding_map``, and an unknown
    ``train.eval_task`` when evaluating.  The MIL-NCE stream
    kernels take any embedding width (past ``STREAM_DMAX`` in their deep
    mode)."""
    default = Config()
    unported = [name for name in UNPORTED_KNOBS
                if _knob(cfg, name) != _knob(default, name)]
    if unported:
        raise ValueError(f"not ported yet: {', '.join(unported)} (leave "
                         "them at their defaults)")
    stages = curriculum.parse_curriculum(
        cfg.train.curriculum, default_batch_size=cfg.train.batch_size)
    accum = cfg.train.grad_accum
    for i, b_global in enumerate(st.batch_size for st in stages or
                                 curriculum.flat_stages(cfg.data,
                                                        cfg.train.batch_size)):
        name = (f"curriculum stage {i} batch_size" if stages
                else "train.batch_size")
        if b_global % world:
            raise ValueError(f"{name}={b_global} does not split over "
                             f"{world} ranks")
        if accum < 1 or (b_global // world) % accum:
            raise ValueError(f"train.grad_accum={accum} does not split a "
                             f"rank's batch of {b_global // world}"
                             + (f" (curriculum stage {i})" if stages else ""))
    if cfg.train.faults:
        faults.parse_spec(cfg.train.faults)
    check_model_axis(cfg.parallel, world)
    parse_sharding_spec(cfg.parallel.sharding_map)
    StragglerPolicy(ratio=cfg.train.straggler_ratio,
                    window=cfg.train.straggler_window)
    if cfg.train.evaluate and cfg.train.eval_task not in EVAL_TASKS:
        raise ValueError(f"unknown train.eval_task {cfg.train.eval_task!r}; "
                         f"expected one of {'|'.join(EVAL_TASKS)}")


_ROUTES = {"dense": "dense cubes", "cuda": "streamed on the CUDA kernels",
           "scan": "streamed on the plain PyTorch stream"}


def _knob(cfg: Config, name: str):
    section, field = name.split(".")
    return getattr(getattr(cfg, section), field)


@dataclass
class TrainResult:
    steps: int
    last_loss: float
    skipped_steps: int = 0      # finite-guard: updates dropped on
                                # non-finite gradients
    rollbacks: int = 0          # circuit-breaker checkpoint restores
    model: Optional[torch.nn.Module] = None
    rank: int = 0               # this process's rank in the run
    stage: int = 0              # curriculum stage at exit (flat runs: 0)
    drained: bool = False       # exited on a drain (SIGTERM, signal file,
                                # host.preempt) with a forced checkpoint
                                # and ELASTIC_STAMP; the CLI exits 75
    placement: Optional[ShardedPlacement] = None    # the 2-D layout: the
                                # model's sharded parameters hold this
                                # rank's slices
    eval_metrics: Optional[dict] = None     # the last in-training eval's
                                # metrics (every rank has them)


def disable_tf32() -> str:
    """Turn TF32 off for convolutions and matmuls; returns both flags as
    a printable line."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return (f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
            f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")


def resolve_device(platform: str, ranks: Ranks = Ranks()) -> torch.device:
    """``parallel.platform`` -> torch device; 'cuda' refuses to run
    without a card instead of falling back to the CPU.  A rank of a
    group runs on ``cuda:<local rank>``."""
    if platform == "cpu":
        return torch.device("cpu")
    if platform == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("parallel.platform=cuda but no CUDA device is "
                               "visible (use --parallel.platform cpu)")
        if ranks.group is not None:
            return torch.device("cuda", ranks.local_rank)
        return torch.device("cuda", torch.cuda.current_device())
    raise ValueError(f"unknown parallel.platform {platform!r} "
                     "(expected cuda | cpu)")


def build_source(cfg: Config, log_fn=None):
    if cfg.data.synthetic:
        return SyntheticVideoTextSource(cfg.data,
                                        vocab_size=cfg.model.vocab_size)
    return HowTo100MSource(cfg.data, cfg.model, log_fn=log_fn)


def resume_batch_offset(restored_step: int, steps_per_epoch: int) -> int:
    """Mid-epoch resume position of a flat run: how many global batches of
    the current epoch the restored step counter has already consumed (an
    end-of-epoch save lands on the boundary -> 0).  The loop reads it from
    ``plan.locate``, whose flat plan agrees; kept, as the JAX loop keeps
    it, for scripts that know only the epoch length."""
    return int(restored_step) % steps_per_epoch


def stop_save_label(epoch: int, opt_step: int,
                    steps_per_epoch: int) -> tuple:
    """(checkpoint label, force) for a stop at ``opt_step``.  A stop ON
    the epoch's last batch labels epoch+1; any other labels the CURRENT
    epoch and must FORCE the save, since the previous epoch's boundary
    save holds the same label."""
    done = opt_step % steps_per_epoch == 0
    return (epoch + 1 if done else epoch), (not done)


def stop_save_label_planned(epoch: int, opt_step: int, plan) -> tuple:
    """Plan-aware twin of :func:`stop_save_label`: per-stage batch sizes
    make the epoch boundary a plan lookup, not a modulo.  Identical to
    the flat helper for single-stage plans."""
    done = opt_step == plan.epoch_end_step(epoch)
    return (epoch + 1 if done else epoch), (not done)


def _in_training_eval(cfg: Config, model, device, log,
                      group=None) -> dict:
    """Periodic downstream eval during training, dispatched through the
    eval CLI's runner; hermetic (synthetic) runs decode with the fake
    decoder.  Every rank of ``group`` evaluates its share of the source
    on its device and gets the metrics (returned); ``log`` is rank 0's
    alone."""
    decoder = FakeDecoder() if cfg.data.synthetic else None
    task = cfg.train.eval_task
    tokenizer = (None if task == "hmdb" else
                 build_tokenizer(cfg.model, cfg.data.eval_max_words))
    metrics = evaluate_task(
        task, model, device, data_cfg=cfg.data, csv_path=cfg.data.eval_csv,
        video_root=cfg.data.eval_video_root, tokenizer=tokenizer,
        num_clip=cfg.train.num_windows_test,
        batch_size=cfg.train.batch_size_val, decoder=decoder,
        max_words=cfg.data.eval_max_words, process_group=group)
    if task == "hmdb":
        log(f"HMDB linear probe: {metrics}")
    else:
        log(f"{task} retrieval: {format_metrics(metrics)}")
    return metrics


def run_training(cfg: Config, log: Callable[[str], None] = print,
                 on_step: Optional[Callable[[int, float, float, float],
                                            None]] = None) -> TrainResult:
    """Train for ``cfg.train.max_steps`` steps of this run (None = to the
    last epoch).  ``on_step(step, seconds, loss, data_wait)`` is called
    after each step with its global step number, the host time the step
    took, synchronized with the device, its (global) loss, and the host
    time the loop was blocked waiting for the step's batch.  ``log`` gets
    rank 0's messages.  A group this call joins is left before it
    returns."""
    ranks = initialize_distributed(cfg.parallel)
    try:
        check_config(cfg, cfg.parallel.platform, ranks.world)
        if cfg.train.faults:
            # armed before any decode or step is built, so every site
            # sees it; a config-armed registry dies with the run
            faults.arm(cfg.train.faults)
        runlog = RunLogger(cfg.train.log_root, cfg.train.checkpoint_dir,
                           enabled=ranks.is_main and cfg.train.verbose,
                           echo=log)
        try:
            say = (runlog.log if runlog.enabled
                   else log if ranks.is_main else _quiet)
            return _train(cfg, ranks, say, runlog, on_step)
        finally:
            runlog.close()
            if cfg.train.faults:
                faults.disarm()
    finally:
        ranks.close()


def _quiet(_message: str) -> None:
    """The log of a rank other than 0."""


def _open_checkpoints(ckpt_dir: str, cfg: Config,
                      ranks: Ranks) -> CheckpointManager:
    """Rank 0 opens (and makes) the directory it alone writes; the other
    ranks open it read-only once it exists, to restore from it."""
    manager = (CheckpointManager(ckpt_dir, keep=cfg.train.checkpoint_keep,
                                 save_retries=cfg.train.checkpoint_save_retries)
               if ranks.is_main else None)
    ranks.barrier()
    return manager or CheckpointManager(ckpt_dir, create=False)


class _RunObs:
    """The run's observability (after ``milnce_tpu/train/loop.py:264-375``
    and ``:1111-1127``): the run identity, the span stream, the display
    gauges, the spike detector and the capture it arms, and at the end
    the goodput ledger.  It reads only values the loop already holds on
    the host, so it adds no device sync."""

    def __init__(self, cfg: Config, ranks: Ranks, device, log):
        t = cfg.train
        self.log = log
        self.guard_on = t.finite_guard
        # one run_id for every rank: rank 0's, broadcast over the group
        self.run_id = t.run_id or broadcast_str(obs_runctx.auto_run_id(),
                                                ranks.group)
        self.prev_runctx = obs_runctx.set_run_context(self.run_id,
                                                      ranks.rank)
        self.obs_dir = t.obs_dir or t.log_root
        self.path = None
        if t.verbose and self.obs_dir:
            os.makedirs(self.obs_dir, exist_ok=True)
            name = ("RUN_EVENTS.jsonl" if ranks.rank == 0
                    else f"RUN_EVENTS.p{ranks.rank}.jsonl")
            self.path = os.path.join(self.obs_dir, name)
        self.rec = obs_spans.SpanRecorder(
            path=self.path, profiler_bridge=t.obs_profiler_bridge)
        self.rec.event("run.start", seed=t.seed, batch_size=t.batch_size,
                       processes=ranks.world)
        # the pipeline's data.wait spans and watchdog events land here
        self.prev_rec = obs_spans.install(self.rec)
        reg = self.reg = obs_metrics.registry()
        self.m_steps = reg.counter(
            "milnce_train_steps_total",
            "optimizer steps dispatched (display-cadence fed)")
        self.g_loss = reg.gauge(
            "milnce_train_loss",
            "windowed mean training loss at the last display")
        self.g_lr = reg.gauge("milnce_train_learning_rate",
                              "current LR (numpy host-schedule twin)")
        self.g_tput = reg.gauge("milnce_train_clips_per_sec",
                                "windowed throughput at the last display")
        self.g_skipped = reg.gauge("milnce_train_skipped_steps",
                                   "finite-guard skipped updates (run total)")
        self.m_rollbacks = reg.counter("milnce_train_rollbacks_total",
                                       "circuit-breaker checkpoint restores")
        self.g_mfu = reg.gauge(
            "milnce_train_mfu",
            "live MFU at the last display (roofline step FLOPs over device "
            "peak; only set when both are known)")
        self.g_goodput = reg.gauge(
            "milnce_train_goodput_fraction",
            "windowed goodput at the last display: elapsed minus data-wait, "
            "times the applied-update fraction, over elapsed")
        self.g_stage = reg.gauge(
            "milnce_train_stage",
            "live curriculum stage index (0-based; flat runs stay 0)")
        self.m_data_wait = reg.counter(
            "milnce_data_wait_seconds_total",
            "host seconds the training loop blocked waiting for batch data")
        # live MFU: the roofline step FLOPs (MIL-NCE without grad-cache
        # only, as in the JAX loop) over the card's peak for the model's
        # dtype
        self.peak = device_peak_flops(
            torch.cuda.get_device_name(device) if device.type == "cuda"
            else device.type, cfg.model.dtype)
        self.n_cards = ranks.world
        self.cfg = cfg
        self.step_flops = None
        self.stage = 0
        self.last_mfu = None
        self.steps = 0                  # the loop's steps, for run.end
        self.wait0 = self.m_data_wait.value
        self.prev_skipped = 0
        self.capture = None
        if t.capture_dir:
            self.capture = ProfilerCapture(
                t.capture_dir, duration_s=t.capture_ms / 1e3,
                cooldown_s=t.anomaly_cooldown_s, max_captures=t.capture_max,
                recorder=self.rec)
        self.detector = None
        if t.anomaly_detect:
            self.detector = EwmaSpikeDetector(
                "train.step_ms", ratio=t.anomaly_ratio,
                warmup=t.anomaly_warmup, cooldown_s=t.anomaly_cooldown_s,
                recorder=self.rec,
                on_anomaly=((lambda v, e: self.capture.arm(
                    reason="step_time_spike"))
                    if self.capture is not None else None))
        self.capture_requested = False      # SIGUSR1, acted on at display
        self.prev_usr1 = None
        if self.capture is not None:
            try:
                self.prev_usr1 = signal.signal(signal.SIGUSR1,
                                               self._on_sigusr1)
            except ValueError:                  # not the main thread
                self.prev_usr1 = None

    def _on_sigusr1(self, signum, frame) -> None:
        self.capture_requested = True

    def set_stage(self, index: int, stage) -> None:
        """The curriculum stage the next steps run: the stage gauge, and
        the roofline step FLOPs at its batch and shapes (MIL-NCE without
        grad-cache only, as in the JAX loop)."""
        self.stage = index
        self.g_stage.set(index)
        cfg = self.cfg
        if (self.peak and cfg.loss.name == "milnce"
                and cfg.train.grad_accum == 1):
            m, d = cfg.model, cfg.data
            self.step_flops = train_step_flops(
                stage.batch_size, stage.num_frames, stage.resolution,
                d.num_candidates, d.max_words,
                space_to_depth=m.space_to_depth,
                inception_blocks=m.inception_blocks,
                embedding_dim=m.embedding_dim,
                word_dim=m.word_embedding_dim, hidden=m.text_hidden_dim)

    def after_step(self) -> None:
        """A step boundary: a capture whose duration has passed stops on
        this (the loop's) thread."""
        if self.capture is not None:
            self.capture.poll()

    def display(self, *, step: int, epoch: int, window: int,
                elapsed: float, mean_loss: float, lr: float,
                clips_per_sec: float, skipped: int,
                first_window: bool) -> str:
        """Feed one display window to the gauges, the ``display`` event,
        the spike detector and a requested capture; returns the display
        line's MFU text ('' when the MFU is unknown)."""
        extra = ""
        sps = window / elapsed if elapsed > 0 else 0.0
        if self.step_flops is not None and sps > 0:
            self.last_mfu = mfu(self.step_flops, sps, self.peak,
                                self.n_cards)
            self.g_mfu.set(self.last_mfu)
            extra = f", MFU: {self.last_mfu:.3f}"
        # windowed goodput: elapsed minus host data-wait, scaled by the
        # applied-update fraction (a skipped step burnt time for nothing)
        wait_now = self.m_data_wait.value
        wait_delta = max(0.0, wait_now - self.wait0)
        self.wait0 = wait_now
        applied = 1.0
        if self.guard_on and window > 0:
            applied = max(0.0, 1.0 - max(0, skipped - self.prev_skipped)
                          / window)
            self.prev_skipped = skipped
        goodput = (max(0.0, elapsed - wait_delta) / elapsed * applied
                   if elapsed > 0 else 0.0)
        self.g_goodput.set(goodput)
        self.m_steps.inc(window)
        self.g_loss.set(mean_loss)
        self.g_lr.set(lr)
        self.g_tput.set(clips_per_sec)
        if self.guard_on:
            self.g_skipped.set(skipped)
        self.rec.event("display", step=step, epoch=epoch,
                       loss=float(mean_loss), lr=float(lr),
                       clips_per_sec=clips_per_sec,
                       goodput_fraction=round(goodput, 5), stage=self.stage,
                       skipped_total=skipped,
                       **({"mfu": round(self.last_mfu, 5)}
                          if self.last_mfu is not None else {}))
        # the window holding the run's first step is left out: its
        # start-up time would set the baseline too high
        if self.detector is not None and window > 0 and not first_window:
            self.detector.observe(elapsed * 1e3 / window, step=step)
        if self.capture is not None and self.capture_requested:
            self.capture_requested = False
            verdict = self.capture.arm(reason="sigusr1")
            self.log(f"SIGUSR1 profiler capture: {verdict}")
        return extra

    def rollback(self, *, step: int, restored_epoch: int, consec: int,
                 lost: int) -> None:
        self.m_rollbacks.inc()
        self.rec.event("rollback", step=step, restored_epoch=restored_epoch,
                       consecutive_skips=consec, lost_updates=lost)

    def close(self, steps: int, extra: Optional[dict] = None) -> None:
        """``run.end``, then the goodput ledger over the whole run (with
        ``extra``, the straggler policy's keys, in its snapshot); the
        previous recorder, run context and SIGUSR1 handler come back."""
        if self.prev_usr1 is not None:
            signal.signal(signal.SIGUSR1, self.prev_usr1)
        if self.capture is not None:
            self.capture.close()        # flush a mid-capture trace
        self.rec.event("run.end", steps=steps)
        extra = dict(extra or {})
        if self.last_mfu is not None:
            extra["mfu"] = round(self.last_mfu, 5)
        _finalize_goodput_ledger(self.rec, self.path, self.run_id,
                                 obs_runctx.get_run_context()[1], self.reg,
                                 self.obs_dir, self.log, extra or None)
        obs_spans.install(self.prev_rec)
        self.rec.close()
        obs_runctx.set_run_context(*self.prev_runctx)


def _finalize_goodput_ledger(rec, rec_path, run_id, process_index,
                             registry, obs_dir, log_fn,
                             extra: Optional[dict] = None) -> None:
    """End-of-run goodput ledger (``obs/goodput.py``): read back this run's
    stream (the file when there is one, the ring otherwise), export it as
    gauges and write ``GOODPUT.json`` (rank r: ``GOODPUT.p{r}.json``)
    beside the stream.  Best-effort: the ledger never turns a finished
    (or failing) run into an error."""
    try:
        if rec_path and os.path.exists(rec_path):
            with open(rec_path) as fh:
                records = [json.loads(line) for line in fh if line.strip()]
        else:
            records = rec.tail()
        ledger = obs_goodput.compute_ledger(records, run_id=run_id)
        obs_goodput.ledger_to_registry(ledger, registry)
        if rec_path:
            name = ("GOODPUT.json" if not process_index
                    else f"GOODPUT.p{process_index}.json")
            payload = ledger.to_extra()
            payload.update(extra or {})
            obs_export.write_snapshot(os.path.join(obs_dir, name), registry,
                                      kind="goodput", extra=payload)
        log_fn(ledger.summary_line())
    except Exception as exc:
        log_fn(f"goodput ledger failed ({type(exc).__name__}: {exc}) — "
               "telemetry only, run result unaffected")


def _train(cfg: Config, ranks: Ranks, log, runlog: RunLogger,
           on_step) -> TrainResult:
    log(disable_tf32())
    device = resolve_device(cfg.parallel.platform, ranks)
    if ranks.group is not None:
        log(f"process group: {ranks.world} ranks on "
            f"{dist.get_backend(ranks.group)}")
    obs = _RunObs(cfg, ranks, device, log)
    # the straggler policy (elastic/straggler.py): rank 0 feeds every
    # rank's step time at the display cadence; its verdict rides the
    # goodput snapshot
    policy = StragglerPolicy(ratio=cfg.train.straggler_ratio,
                             window=cfg.train.straggler_window,
                             recommend_resize=cfg.train.straggler_resize,
                             recorder=obs.rec)
    # SIGTERM, the signal file and host.preempt latch one drain verdict
    drain = DrainController(signal_file=cfg.train.drain_signal_file,
                            recorder=obs.rec)
    drain.install()
    try:
        with maybe_trace(cfg.train.trace_dir or None):
            return _train_run(cfg, ranks, log, runlog, on_step, device, obs,
                              drain, policy)
    finally:
        drain.uninstall()
        obs.close(obs.steps, policy.ledger_extra())


def _train_run(cfg: Config, ranks: Ranks, log, runlog: RunLogger, on_step,
               device, obs: _RunObs, drain: DrainController,
               policy: StragglerPolicy) -> TrainResult:
    rec = obs.rec
    # The plan (train/curriculum.py): a flat run is one open-ended stage
    # through the same machinery, so resume offsets, epoch progress and
    # the schedule's total have one derivation.
    stages = curriculum.parse_curriculum(
        cfg.train.curriculum, default_batch_size=cfg.train.batch_size)
    curriculum_on = bool(stages)
    if not curriculum_on:
        stages = curriculum.flat_stages(cfg.data, cfg.train.batch_size)
    stage_cfgs = [curriculum.stage_config(cfg, st) for st in stages]
    source0 = build_source(stage_cfgs[0], log_fn=log)
    plan = curriculum.plan_curriculum(stages, len(source0), cfg.optim.epochs)
    if curriculum_on:
        rec.event("curriculum.plan", total_steps=plan.total_steps,
                  stages=[{"num_frames": s.num_frames,
                           "resolution": s.resolution,
                           "batch_size": s.batch_size}
                          for s in plan.stages])
        log("curriculum: " + " -> ".join(s.label() for s in plan.stages)
            + f" ({plan.total_steps} steps planned)")

    def stage_pipeline(idx: int):
        """(source, loader) of one stage, rebuilt at every boundary: the
        decode shapes and the batch are the stage's; the model and the
        optimizer are not."""
        st = plan.stages[idx]
        src = source0 if idx == 0 else build_source(stage_cfgs[idx],
                                                    log_fn=log)
        ldr = ShardedLoader(src, st.batch_size, seed=cfg.train.seed,
                            num_threads=cfg.data.num_reader_threads,
                            process_index=ranks.rank,
                            process_count=ranks.world,
                            lookahead_batches=cfg.data.decode_lookahead,
                            sample_timeout=cfg.data.sample_timeout,
                            timeout_retries=cfg.data.sample_timeout_retries,
                            log_fn=log)
        if cfg.loss.name == "milnce":
            b_local = st.batch_size // ranks.world
            k, d = cfg.data.num_candidates, cfg.model.embedding_dim
            route = milnce_route(cfg.loss, b_local, st.batch_size, k,
                                 device.type)
            log(f"MIL-NCE: {_ROUTES[route]} (B_local {b_local}, Bg "
                f"{st.batch_size}, K {k}, D {d})")
        return src, ldr

    model = build_model(cfg.model, seed=cfg.train.seed, group=ranks.group)
    if cfg.train.pretrain_ckpt:
        # reference weights (main_distributed.py:81-83)
        load_reference_checkpoint(model, cfg.train.pretrain_ckpt)
        log(f"loaded pretrained weights from {cfg.train.pretrain_ckpt}")
    model.to(device)
    grid = build_mesh(cfg.parallel, ranks.group)
    placement = None
    if grid is not None:
        placement = ShardedPlacement(
            model, grid, ranks.group, min_size=cfg.parallel.fsdp_min_size,
            spec=cfg.parallel.sharding_map,
            overlap=cfg.parallel.overlap_grad_reduce)
        log(f"sharding map: {placement.n_sharded}/{len(placement.summary)} "
            f"params sharded on '{grid.model_axis}' (threshold "
            f"{cfg.parallel.fsdp_min_size} elements, hash {placement.hash})"
            " | gradients reduced "
            + ("a leaf at a time during the backward"
               if placement.overlap else "after the backward, fused")
            + f" | mesh {grid.shape}")
        if placement.n_sharded == 0:
            raise ValueError(
                "sharding map shards no parameter: the 2-D layout would pay "
                "the model axis's collectives for pure replication (lower "
                "parallel.fsdp_min_size or fix parallel.sharding_map)")
    # the schedule runs over the PLAN's total: per-stage batch sizes make
    # steps_per_epoch * epochs wrong for a curriculum
    schedule = build_schedule_total(cfg.optim, plan.total_steps)
    optimizer, lr_scheduler = build_optimizer(model, cfg.optim, schedule)

    ckpt_dir = os.path.join(cfg.train.checkpoint_root,
                            cfg.train.checkpoint_dir or "run")
    manager = _open_checkpoints(ckpt_dir, cfg, ranks)
    mesh = grid.shape if grid is not None else {"data": ranks.world}
    start_epoch = resume_step = 0
    if cfg.train.resume:
        # both guards BEFORE any checkpoint is read: a curriculum
        # checkpoint resumed with the schedule removed, a stage batch that
        # does not split over the new world size and a stale sidecar pair
        # refuse; a change of world size is logged
        stage_stamp = curriculum.read_stage_stamp(ckpt_dir)
        curriculum.check_resume_compatible(
            stage_stamp, curriculum_spec=cfg.train.curriculum,
            flat_frames=cfg.data.num_frames,
            flat_resolution=cfg.data.video_size,
            flat_batch=cfg.train.batch_size)
        estamp = read_elastic_stamp(ckpt_dir)
        note = check_topology_resume(
            estamp, mesh_shape=mesh,
            batch_sizes=[st.batch_size for st in plan.stages],
            curriculum_stamp=stage_stamp)
        if note:
            log(note)
        span = (rec.span("elastic.resume", label="latest",
                         from_mesh=str(dict(estamp.get("mesh") or {})),
                         to_mesh=str(mesh))
                if estamp is not None else
                rec.span("ckpt.restore", label="latest"))
        with span:
            start_epoch, state = manager.restore_latest(map_location=device)
            if state is not None:
                resume_step = load_train_state(state, model, optimizer,
                                               lr_scheduler, placement)
        if state is not None:
            seg, off = plan.locate(resume_step)
            log(f"resumed from epoch {start_epoch} at batch "
                f"{seg.skip_batches + off}"
                + (f" (curriculum stage {seg.stage}, "
                   f"{plan.stages[seg.stage].label()})"
                   if curriculum_on else ""))
    # built after the restore: the grad.nonfinite fault counts optimizer
    # steps from the restored one
    step_kwargs = dict(finite_guard=cfg.train.finite_guard,
                       lr_scheduler=lr_scheduler, group=ranks.group,
                       first_step=resume_step, placement=placement)
    if cfg.train.grad_accum > 1:
        step_fn = make_grad_cache_step(model, optimizer,
                                       cfg.train.grad_accum, cfg.loss,
                                       **step_kwargs)
    else:
        step_fn = make_train_step(model, optimizer, cfg.loss, **step_kwargs)
    max_steps = cfg.train.max_steps
    log(f"device: {device} | global batch: {cfg.train.batch_size} | "
        f"steps: {max_steps or plan.total_steps}"
        + (f" | microbatches: {cfg.train.grad_accum}"
           if cfg.train.grad_accum > 1 else "")
        + (f" | state bytes a rank: {local_state_bytes(model, optimizer)}"
           if placement is not None else ""))
    if curriculum_on:
        # every stage's trial step against the card's memory, before
        # step 1: an over-budget stage is refused now, not at its boundary
        budget = curriculum.hbm_budget_bytes(device)
        if budget:
            from milnce_tpu_torch.analysis.memplan import what_if_step
            for note in curriculum.preflight_stages(
                    step_fn, model, optimizer, plan.stages,
                    world=ranks.world,
                    num_candidates=cfg.data.num_candidates,
                    max_words=cfg.data.max_words,
                    vocab_size=cfg.model.vocab_size, budget_bytes=budget,
                    device=device, static_plan=lambda b, st: what_if_step(
                        b, st.num_frames, st.resolution, cfg,
                        entry=f"stage {st.label()}")):
                log(f"curriculum pre-flight: {note}")
        else:
            log("curriculum pre-flight skipped: no allocator peak to read "
                f"on {device.type} (it runs on a CUDA device)")

    def snapshot(epoch_label: int) -> Optional[dict]:
        """The checkpoint's state on rank 0 (None elsewhere); on the 2-D
        layout every rank takes part in gathering it."""
        if placement is None and not ranks.is_main:
            return None
        state = train_state(model, optimizer, lr_scheduler, opt_step,
                            epoch_label, placement)
        return state if ranks.is_main else None

    def save(label: int, force: bool = False, drained: bool = False) -> None:
        """A rotation save and, beside it, both stamps (rank 0); a
        drain's forced save runs under ``elastic.drain`` instead of
        ``ckpt.save``, so the ledger puts it in the drain bucket."""
        span = ("elastic.drain" if drained else "ckpt.save")
        with rec.span(span, label=label, forced=force, stage=stage_idx,
                      **({"source": drain.source or "peer"} if drained
                         else {})):
            state = snapshot(label)
            if ranks.is_main:
                manager.save(label, state, force=force)
                curriculum.write_stage_stamp(
                    ckpt_dir, spec=cfg.train.curriculum,
                    stage_index=stage_idx, stage=plan.stages[stage_idx],
                    step=opt_step)
                seg_c, off_c = plan.locate(opt_step)
                write_elastic_stamp(
                    ckpt_dir, mesh_shape=mesh,
                    sharding_hash=placement.hash if placement else "",
                    step=opt_step, stage_index=stage_idx,
                    batch_offset=seg_c.skip_batches + off_c,
                    drained=drained)
            ranks.barrier()

    # The finite guard's display window, as the JAX loop keeps it: a
    # skipped step's loss stays out of the sum and the count, a window
    # with no applied update has a NaN mean, and ``consec`` counts the
    # skipped steps since the last applied one, across windows.  With the
    # guard on, the step's verdict stays on the device: the window's
    # valid count, ``consec`` and the run's skipped total accumulate there
    # (``guard``: valid, consec, skipped) and are read at display cadence,
    # in the ``sync`` span, as the JAX loop's ``_fetch_guard_window``.
    guard_on = cfg.train.finite_guard
    steps = skipped = window = valid = consec = rollbacks = 0
    opt_step = resume_step          # batches consumed, restored ones too
    last_rollback = None            # (steps, skipped) at the last rollback
    running = torch.zeros((), device=device)
    guard = torch.zeros(3, dtype=torch.int32, device=device)
    last = torch.zeros((), device=device)
    fn_s = 0.0                      # the window's time in the step function
    eval_every = max(1, cfg.train.batch_size // 512)
    sync_every = max(1, cfg.train.preempt_sync_steps)
    cursor = resume_step            # the plan step the run resumes at
    stage_idx = plan.stage_at(resume_step)
    source, loader = stage_pipeline(stage_idx)
    obs.set_stage(stage_idx, plan.stages[stage_idx])
    tick = time.time()
    timer = StepTimer(clips_per_step=plan.stages[stage_idx].batch_size)
    eval_metrics = None

    def result(drained: bool = False) -> TrainResult:
        total = int(guard[2]) if guard_on else 0  # graftlint: disable=GL001(run end: read once, when the run returns)
        return TrainResult(steps, float(last), total, rollbacks, model,  # graftlint: disable=GL001(run end, as the line above)
                           ranks.rank, stage_idx, drained, placement,
                           eval_metrics)

    for epoch in range(start_epoch, cfg.optim.epochs):
        if (cfg.train.evaluate and cfg.data.eval_video_root
                and epoch % eval_every == 0):
            # every rank its share, on its card: none waits for another
            with (placement.full_params() if placement is not None
                  else contextlib.nullcontext()):
                eval_metrics = _in_training_eval(cfg, model, device, log,
                                                 ranks.group)
        for seg in plan.segments_for_epoch(epoch):
            # a resume skips the segments its restored step consumed and
            # starts the one holding it at its offset
            seg_done = 0
            if cursor:
                if cursor >= seg.end_step:
                    continue
                seg_done = max(0, cursor - seg.start_step)
                cursor = 0
            if seg.stage != stage_idx:
                # a curriculum boundary: the loader at the new shapes, and
                # a fresh display window (its loss and throughput must not
                # mix shapes)
                st = plan.stages[seg.stage]
                with rec.span("stage.switch", stage=seg.stage,
                              prev_stage=stage_idx, step=opt_step,
                              num_frames=st.num_frames,
                              resolution=st.resolution,
                              batch_size=st.batch_size):
                    source, loader = stage_pipeline(seg.stage)
                stage_idx = seg.stage
                obs.set_stage(stage_idx, st)
                log(f"curriculum: entering stage {stage_idx} "
                    f"({st.label()}) at step {opt_step}")
                running.zero_()
                window = valid = 0
                fn_s = 0.0
                timer = StepTimer(clips_per_step=st.batch_size)
                tick = time.time()
            b_stage = plan.stages[stage_idx].batch_size
            prefetch = device_prefetch(
                loader.epoch(epoch, skip_batches=seg.skip_batches + seg_done),
                device, depth=cfg.data.prefetch_depth)
            while seg_done < seg.n_steps:
                t_wait = time.perf_counter()
                batch = next(prefetch, None)
                t0 = time.perf_counter()
                if batch is None:
                    break
                video, text = flatten_text(batch)
                with rec.span("step", step=steps + 1):
                    # host.slow: this rank's step runs slow (the straggler
                    # policy's case), inside the span as in the JAX loop
                    faults.maybe_hang("host.slow", default_sleep=0.05)
                    t_fn = time.perf_counter()
                    out = step_fn(video, text, batch["start"])
                    fn_s += time.perf_counter() - t_fn
                if guard_on:
                    last, skip = out
                    _guard_acc(running, guard, last, skip)
                else:
                    last = out
                    running += last
                    valid += 1
                steps += 1
                seg_done += 1
                obs.steps = steps
                opt_step += 1
                window += 1
                obs.after_step()
                if on_step is not None:
                    if device.type == "cuda":
                        torch.cuda.synchronize(device)
                    on_step(opt_step, time.perf_counter() - t0, float(last),  # graftlint: disable=GL001(only with a caller's on_step, which asks for each step's time and loss)
                            t0 - t_wait)
                if window == cfg.train.n_display or steps == max_steps:
                    with rec.span("sync", cause="display", step=opt_step):
                        if guard_on:
                            valid, consec, skipped = guard.tolist()  # graftlint: disable=GL001(display cadence, in the sync span: the guard's window)
                        mean_loss = (float(running) / valid if valid  # graftlint: disable=GL001(display cadence, in the sync span: the window's loss)
                                     else math.nan)
                    elapsed = timer.elapsed_s
                    ep_start = plan.epoch_start_step(epoch)
                    ep_len = max(1, plan.epoch_steps(epoch))
                    progress = ((opt_step - ep_start - 1) % ep_len + 1) / ep_len
                    clips_per_s = window * b_stage / elapsed
                    lr = schedule(opt_step)
                    first_window = opt_step - window == resume_step
                    extra = obs.display(
                        step=opt_step, epoch=epoch + 1, window=window,
                        elapsed=elapsed, mean_loss=mean_loss, lr=lr,
                        clips_per_sec=clips_per_s, skipped=skipped,
                        first_window=first_window)
                    # the straggler feed, the first window left out as the
                    # spike detector leaves it (start-up is not skew)
                    if not first_window:
                        _feed_straggler(policy, ranks, elapsed / window,
                                        fn_s / window, opt_step)
                    log(f"Epoch {epoch + 1}, Elapsed Time: "
                        f"{time.time() - tick:.3f}, Epoch status: "
                        f"{progress:.4f}, Training loss: {mean_loss:.4f}, "
                        f"Learning rate: {lr:.6f}, Throughput: "
                        f"{clips_per_s:.1f} clips/s"
                        + (f", Stage: {stage_idx}" if curriculum_on else "")
                        + f"{_health(guard_on, skipped, source, loader)}{extra}")
                    runlog.log_event({"event": "display", "epoch": epoch + 1,
                                      "step": opt_step, "loss": mean_loss,
                                      "lr": lr, "clips_per_s": clips_per_s,
                                      "skipped": skipped})
                    # A guarded window with no applied update is NaN by
                    # construction: that is the breaker's case, not the
                    # divergence halt's.  The halt saves the state apart
                    # from the rotation (``nan_postmortem/``), which a
                    # resume would otherwise hand the poisoned weights
                    # back from.
                    if (cfg.train.halt_on_nan and not math.isfinite(mean_loss)
                            and not (guard_on and math.isnan(mean_loss))):
                        state = snapshot(epoch)
                        if ranks.is_main:
                            CheckpointManager(
                                os.path.join(ckpt_dir, "nan_postmortem"),
                                keep=1).save(opt_step, state)
                        log(f"non-finite training loss ({mean_loss}) — "
                            "post-mortem state saved under "
                            f"nan_postmortem/{opt_step}; halting")
                        raise FloatingPointError(
                            f"training loss became non-finite ({mean_loss}) "
                            f"at step {opt_step}")
                    if (guard_on and cfg.train.skip_rollback_after
                            and consec >= cfg.train.skip_rollback_after):
                        latest = _roll_back(manager, consec, opt_step, steps,
                                            skipped, last_rollback, model,
                                            optimizer, lr_scheduler, device,
                                            rec, placement)
                        last_rollback = (steps, skipped)
                        rollbacks += 1
                        # updates applied since the restored boundary save
                        # are discarded; the skipped streak is already
                        # badput
                        obs.rollback(step=opt_step, restored_epoch=latest,
                                     consec=consec,
                                     lost=max(0, opt_step
                                              - plan.epoch_start_step(latest)
                                              - consec))
                        log(f"circuit breaker: {consec} consecutive "
                            f"non-finite updates — restored rotation "
                            f"checkpoint {latest}, resuming at step "
                            f"{opt_step} past the poisoned data window")
                        consec = 0
                        guard[1] = 0
                    running.zero_()
                    guard[0] = 0
                    window = valid = 0
                    fn_s = 0.0
                    timer.reset()
                # one drain poll a step (the host.preempt occurrence is the
                # step number); over a group every rank takes the group's
                # verdict at the same steps, so all stop together
                local = drain.poll(steps)
                if ranks.group is None:
                    stopping = local
                else:
                    stopping = (steps % sync_every == 0
                                and reduce_flag(local, ranks.group))
                if stopping or steps == max_steps:
                    prefetch.close()
                    if stopping:
                        log(f"drain ({drain.source or 'cluster peer'}) — "
                            "checkpointing and exiting"
                            + (" (cluster-coordinated)"
                               if ranks.group is not None else ""))
                    label, force = stop_save_label_planned(epoch, opt_step,
                                                           plan)
                    save(label, force=force, drained=stopping)
                    return result(drained=stopping)
            # the segment's end (a stage boundary or the epoch's tail):
            # its readers retire now, before the next stage's start
            prefetch.close()
        save(epoch + 1)
    return result()


def _guard_acc(running: torch.Tensor, guard: torch.Tensor,
               loss: torch.Tensor, skip: torch.Tensor) -> None:
    """One guarded step into the display window, on the device (the JAX
    loop's ``_guard_acc``): an applied step's loss into ``running`` and
    its count into ``guard[0]``; ``guard[1]`` the skipped steps since the
    last applied one; ``guard[2]`` the run's skipped total."""
    keep = skip == 0
    running += torch.where(keep, loss, torch.zeros_like(loss))
    consec = guard[1]
    guard += torch.stack([keep.to(guard.dtype), (consec + 1) * skip - consec,
                          skip])


def _feed_straggler(policy: StragglerPolicy, ranks: Ranks, step_s: float,
                    fn_s: float, step: int) -> None:
    """Each rank's step time for the straggler policy, fed on rank 0.
    Ranks step in lockstep, so their window wall times are alike; what
    differs is where each spends it.  A rank that is late to the step's
    collectives makes the others wait inside the step function, so each
    rank's own time is its wall time less its step function's, plus the
    least step-function time over the ranks (the step without waiting).
    One process is its own wall time (it never flags: skew needs two)."""
    fns = gather_floats(fn_s, ranks.group)
    if not ranks.is_main:
        return
    if ranks.group is None:
        policy.observe(0, step_s * 1e3, step=step)
        return
    least = min(fns)
    policy.feed_merged({"per_process": {
        rank: {"steps": 1, "step_ms_p50": (step_s - fn + least) * 1e3}
        for rank, fn in enumerate(fns)}}, step=step)


def _health(guard_on: bool, skipped: int, source, loader) -> str:
    """The display line's health counts, as the JAX loop prints them:
    the finite guard's skipped steps (guard on), the source's decode
    failures, and the loader's decode timeouts when there were any."""
    extra = f", Skipped steps: {skipped}" if guard_on else ""
    extra += f", Decode failures: {getattr(source, 'decode_failures', 0)}"
    if loader.decode_timeouts:
        extra += f", Decode timeouts: {loader.decode_timeouts}"
    return extra


def _roll_back(manager, consec, opt_step, steps, skipped, last_rollback,
               model, optimizer, lr_scheduler, device, rec,
               placement=None) -> int:
    """The circuit breaker: K consecutive non-finite updates restore the
    newest rotation checkpoint's weights, optimizer and schedule; the
    caller keeps its step counter and data cursor, so the run goes on
    PAST the poisoned window.  Halts when there is no checkpoint, or when
    no update applied since the previous rollback (a persistent failure
    would otherwise loop rollback-skip-rollback).  Returns the restored
    label."""
    latest = manager.latest_epoch()
    if latest is None:
        raise FloatingPointError(
            f"{consec} consecutive non-finite updates at step {opt_step} "
            "and no rotation checkpoint to roll back to — halting")
    if last_rollback is not None:
        applied = (steps - last_rollback[0]) - (skipped - last_rollback[1])
        if applied <= 0:
            raise FloatingPointError(
                f"circuit breaker: {consec} consecutive non-finite updates "
                "with ZERO applied updates since the previous rollback — "
                "the failure is persistent, halting instead of rolling back "
                "in a loop")
    # graftlint: disable=GL001(a checkpoint label on the host, at the breaker's display cadence)
    with rec.span("ckpt.restore", label=int(latest)):
        load_train_state(manager.restore(latest, map_location=device), model,
                         optimizer, lr_scheduler, placement)
    return int(latest)  # graftlint: disable=GL001(a checkpoint label on the host)
