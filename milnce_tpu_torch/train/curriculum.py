"""Curriculum schedule: staged (frames, resolution, batch) training (port
of ``milnce_tpu/train/curriculum.py``).

A curriculum runs early training at few frames and a low resolution and
only graduates to the full operating point late.  This module parses
``train.curriculum``, turns it into an exact step-level plan, and
pre-flights every stage's memory on the card before step 1; train/loop.py
consumes the plan.

Grammar (``train.curriculum``): stages separated by ``;``, each a comma
list of ``key=value`` with keys ``num_frames``, ``resolution``,
``batch_size`` (optional — defaults to ``train.batch_size``, the global
batch), and exactly one of ``until_step`` / ``until_epoch`` on every
stage but the last (the final stage is open-ended and runs to the end of
training)::

    num_frames=8,resolution=112,batch_size=32,until_step=2000;\
    num_frames=32,resolution=224,batch_size=16

A spec containing no ``=`` is read as a JSON artifact path holding the
stage list (optionally under a ``"curriculum"`` key).  Unknown keys,
non-positive values, a bounded final stage, an unbounded middle stage,
or boundaries that leave a stage unreachable all raise ``ValueError``
naming the stage — never a silent fallback.

Plan semantics (:func:`plan_curriculum`): the plan simulates the epoch
loop exactly — ``until_epoch=E`` ends a stage when the epoch counter
reaches E; ``until_step=S`` ends it when the global optimizer step
reaches S (mid-epoch allowed).  A mid-epoch switch re-arms the loader
with ``skip_batches = ceil(samples_consumed / new_batch)`` so no sample
is trained twice in an epoch.  The flat (no-curriculum) run is the SAME
machinery with a single open-ended stage built from the run config, so
the loop has one code path.  The plan, the grammar and the stage stamp
are the JAX module's, copied (tests/test_torch_curriculum.py holds them
equal); the pre-flight is the card's own: the JAX one walks a jaxpr,
this one runs a trial forward and backward at each stage's shape and
reads the allocator's peak.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass
from typing import Optional

import torch

_STAGE_KEYS = ("num_frames", "resolution", "batch_size",
               "until_step", "until_epoch")

#: checkpoint sidecar (train/loop.py writes it next to the checkpoint
#: rotation at every save): the resume guard needs the writing run's
#: stage shape to refuse a curriculum checkpoint resumed with the
#: schedule silently removed.  The same file, key for key, as the JAX
#: package's, so either package reads the other's.
STAMP_NAME = "CURRICULUM_STAMP.json"


@dataclass(frozen=True)
class CurriculumStage:
    num_frames: int
    resolution: int
    batch_size: int
    until_step: Optional[int] = None    # stage ends when the global
    #                                     optimizer step reaches this
    until_epoch: Optional[int] = None   # stage ends entering this epoch

    def label(self) -> str:
        return (f"{self.num_frames}f@{self.resolution} "
                f"batch {self.batch_size}")


@dataclass(frozen=True)
class StageSegment:
    """One contiguous run of steps of one stage inside one epoch."""
    stage: int          # index into the plan's stages
    epoch: int
    skip_batches: int   # loader.epoch(epoch, skip_batches=...) offset
    start_step: int     # global optimizer step of the segment's first step
    n_steps: int

    @property
    def end_step(self) -> int:
        return self.start_step + self.n_steps


def parse_curriculum(spec: str, *,
                     default_batch_size: Optional[int] = None) -> list:
    """``train.curriculum`` -> ordered ``CurriculumStage`` list ('' ->
    []).  Inline grammar or a JSON artifact path — see module docstring.
    Every malformed input names its stage and raises; nothing falls back
    silently."""
    if not spec:
        return []
    if "=" in spec:
        raw = []
        for part in spec.split(";"):
            if not part.strip():
                continue
            d: dict = {}
            for item in part.split(","):
                if not item.strip():
                    continue
                if "=" not in item:
                    raise ValueError(
                        f"curriculum stage {len(raw)}: item {item!r} is "
                        "not key=value (keys: "
                        f"{', '.join(_STAGE_KEYS)})")
                k, v = item.split("=", 1)
                d[k.strip()] = v.strip()
            raw.append(d)
    else:
        if not os.path.exists(spec):
            raise ValueError(
                f"train.curriculum={spec!r}: no '=' so it must be a JSON "
                "artifact path, but no such file exists")
        with open(spec) as fh:
            payload = json.load(fh)
        raw = (payload.get("curriculum", payload)
               if isinstance(payload, dict) else payload)
        if not isinstance(raw, list):
            raise ValueError(
                f"curriculum artifact {spec}: expected a JSON list of "
                "stage objects (or {'curriculum': [...]}), got "
                f"{type(raw).__name__}")
    if not raw:
        return []
    stages = []
    for i, d in enumerate(raw):
        if not isinstance(d, dict):
            raise ValueError(f"curriculum stage {i}: expected an object "
                             f"of stage keys, got {type(d).__name__}")
        unknown = sorted(set(d) - set(_STAGE_KEYS))
        if unknown:
            raise ValueError(
                f"curriculum stage {i}: unknown key(s) "
                f"{', '.join(unknown)} (valid: {', '.join(_STAGE_KEYS)})")
        vals = {}
        for k, v in d.items():
            try:
                vals[k] = int(v)
            except (TypeError, ValueError):
                raise ValueError(
                    f"curriculum stage {i}: {k}={v!r} is not an integer")
            if vals[k] <= 0:
                raise ValueError(
                    f"curriculum stage {i}: {k}={vals[k]} must be > 0")
        for req in ("num_frames", "resolution"):
            if req not in vals:
                raise ValueError(
                    f"curriculum stage {i}: missing required key {req!r}")
        if "batch_size" not in vals:
            if default_batch_size is None:
                raise ValueError(
                    f"curriculum stage {i}: no batch_size and no default "
                    "to inherit")
            vals["batch_size"] = int(default_batch_size)
        has_s = "until_step" in vals
        has_e = "until_epoch" in vals
        last = i == len(raw) - 1
        if has_s and has_e:
            raise ValueError(
                f"curriculum stage {i}: sets BOTH until_step and "
                "until_epoch — exactly one bounds a non-final stage")
        if last and (has_s or has_e):
            raise ValueError(
                f"curriculum stage {i}: the final stage must be "
                "open-ended (it runs to the end of training) but sets "
                f"until_{'step' if has_s else 'epoch'}")
        if not last and not (has_s or has_e):
            raise ValueError(
                f"curriculum stage {i}: needs until_step or until_epoch "
                "(only the final stage is open-ended)")
        stages.append(CurriculumStage(**vals))
    return stages


def flat_stages(data_cfg, batch_size: int) -> list:
    """The no-curriculum run as a single open-ended stage — the loop's
    one code path covers both."""
    return [CurriculumStage(num_frames=data_cfg.num_frames,
                            resolution=data_cfg.video_size,
                            batch_size=int(batch_size))]


def stage_data_config(data_cfg, stage: CurriculumStage):
    """Per-stage DataConfig: only the decode shapes change; everything
    else (candidates, words, decode policy) rides the run config."""
    return dataclasses.replace(data_cfg, num_frames=stage.num_frames,
                               video_size=stage.resolution)


def stage_config(cfg, stage: CurriculumStage):
    """Full Config with the data shapes swapped to ``stage``'s — what
    build_source consumes when the loop re-arms the pipeline at a
    boundary."""
    return dataclasses.replace(cfg, data=stage_data_config(cfg.data, stage))


@dataclass
class CurriculumPlan:
    stages: tuple
    segments: tuple     # StageSegment, ordered by start_step
    num_samples: int
    epochs: int
    total_steps: int

    def segments_for_epoch(self, epoch: int) -> list:
        return [s for s in self.segments if s.epoch == epoch]

    def locate(self, step: int):
        """(segment, offset) containing global step ``step`` — the NEXT
        step to run, so a resume from a restored counter lands exactly
        where the saving run stopped.  ``step >= total_steps`` pins to
        the end of the final segment (a finished run resumes to no-op)."""
        for seg in self.segments:
            if seg.start_step <= step < seg.end_step:
                return seg, step - seg.start_step
        if step >= self.total_steps and self.segments:
            last = self.segments[-1]
            return last, last.n_steps
        raise ValueError(f"step {step} outside the plan "
                         f"(total_steps={self.total_steps})")

    def stage_at(self, step: int) -> int:
        return self.locate(step)[0].stage

    def epoch_start_step(self, epoch: int) -> int:
        segs = self.segments_for_epoch(epoch)
        return segs[0].start_step if segs else self.total_steps

    def epoch_end_step(self, epoch: int) -> int:
        segs = self.segments_for_epoch(epoch)
        return segs[-1].end_step if segs else self.total_steps

    def epoch_steps(self, epoch: int) -> int:
        return self.epoch_end_step(epoch) - self.epoch_start_step(epoch)


def plan_curriculum(stages, num_samples: int, epochs: int) -> CurriculumPlan:
    """Simulate the epoch loop over ``stages`` into an exact step-level
    plan.  Raises when a stage can never run (its predecessor's boundary
    lies past the end of training, or boundaries are non-monotone) —
    a schedule that silently never reaches full resolution is the worst
    possible failure mode of a curriculum."""
    stages = tuple(stages)
    if not stages:
        raise ValueError("plan_curriculum needs at least one stage")
    segments = []
    step = 0
    si = 0
    n = len(stages)
    for epoch in range(epochs):
        consumed = 0            # samples this epoch has trained on
        while True:
            # epoch-counter boundaries resolve at epoch entry
            while (si + 1 < n and stages[si].until_epoch is not None
                   and epoch >= stages[si].until_epoch):
                si += 1
            st = stages[si]
            spe = num_samples // st.batch_size
            if spe <= 0:
                raise ValueError(
                    f"curriculum stage {si} ({st.label()}): batch_size "
                    f"exceeds the dataset ({num_samples} samples)")
            bounded = si + 1 < n and st.until_step is not None
            if bounded and st.until_step <= step:
                si += 1         # boundary already passed (non-monotone
                continue        # specs drain here into "unreachable")
            skip = -(-consumed // st.batch_size)    # ceil div
            avail = spe - skip
            if bounded:
                avail = min(avail, st.until_step - step)
            if avail > 0:
                segments.append(StageSegment(si, epoch, skip, step, avail))
                step += avail
                consumed += avail * st.batch_size
            if bounded and step >= st.until_step:
                si += 1         # mid-epoch switch: stay in this epoch
                continue
            break               # epoch exhausted at the current stage
    reached = {seg.stage for seg in segments}
    for i, st in enumerate(stages):
        if i not in reached:
            raise ValueError(
                f"curriculum stage {i} ({st.label()}) is unreachable — "
                f"earlier boundaries consume the whole run ({step} steps "
                f"over {epochs} epoch(s)); lower until_step/until_epoch "
                "or raise optim.epochs")
    return CurriculumPlan(stages=stages, segments=tuple(segments),
                          num_samples=num_samples, epochs=epochs,
                          total_steps=step)


# ---------------------------------------------------------------------
# pre-flight: refuse a stage that does not fit BEFORE step 1
# ---------------------------------------------------------------------

def hbm_budget_bytes(device) -> Optional[int]:
    """Per-card memory budget the stage pre-flight gates against:
    ``MILNCE_HBM_GIB`` (explicit, wins) else the card's total memory;
    ``None`` on the CPU, which has no peak to read (the pre-flight is
    disarmed there)."""
    if device.type != "cuda":
        return None
    env = os.environ.get("MILNCE_HBM_GIB")
    if env:
        return int(float(env) * 2 ** 30)
    return int(torch.cuda.get_device_properties(device).total_memory)


def trial_step(step_fn, model, video, text, start) -> None:
    """One forward and backward of ``step_fn`` (its ``fwd_bwd``) that
    leaves the model as it found it: the parameters are not updated (no
    optimizer step), the BatchNorm statistics do not fold
    (``frozen_running_stats``) and every buffer and gradient is put back,
    ``num_batches_tracked`` included (the grad-cache step's first pass
    writes the running statistics itself)."""
    from milnce_tpu_torch.models.s3dg import frozen_running_stats

    params = list(model.parameters())
    grads = [None if p.grad is None else p.grad.clone() for p in params]
    buffers = [b.clone() for b in model.buffers()]
    try:
        with frozen_running_stats(model):
            for p in params:
                p.grad = None
            step_fn.fwd_bwd(video, text, start)
    finally:
        with torch.no_grad():
            for b, old in zip(model.buffers(), buffers):
                b.copy_(old)
        for p, g in zip(params, grads):
            p.grad = g


def preflight_stages(step_fn, model, optimizer, stages, *, world: int,
                     num_candidates: int, max_words: int, vocab_size: int,
                     budget_bytes: int, device, static_plan=None) -> list:
    """Run one trial forward and backward (:func:`trial_step`) per stage
    at its ``(batch / world, frames, res, res, 3)`` uint8 input, read the
    card's peak allocation (``reset_peak_memory_stats`` before,
    ``max_memory_allocated`` after; plus Adam's two moments when the
    optimizer has not allocated them yet) and REFUSE the run when a
    stage's peak passes ``budget_bytes`` — at startup, with the stage
    named, never an OOM at a mid-run boundary.  An out-of-memory error
    inside the trial is that same refusal.  Every rank of a group runs
    it (the forward's collectives need all of them).  ``static_plan(b,
    stage)``, when given, plans the stage's step at local batch ``b``
    (``analysis/memplan.py::what_if_step`` on meta) and its verdict is
    printed beside the trial's, as the JAX pre-flight prints its plan; the
    trial stays the decision, and a planner failure is a note.  Returns
    the per-stage verdict strings for the run log."""
    gen = torch.Generator().manual_seed(0)
    moments = 0
    if not optimizer.state:
        moments = 2 * sum(p.numel() * p.element_size()
                          for p in model.parameters() if p.requires_grad)
    notes = []
    for i, st in enumerate(stages):
        b = st.batch_size // world
        entry = f"curriculum stage {i} ({st.label()})"
        video = torch.randint(0, 256, (b, st.num_frames, st.resolution,
                                       st.resolution, 3), generator=gen,
                              dtype=torch.uint8).to(device)
        text = torch.randint(1, vocab_size, (b * num_candidates, max_words),
                             generator=gen).to(device)
        start = torch.zeros(b, device=device)
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        try:
            trial_step(step_fn, model, video, text, start)
            torch.cuda.synchronize(device)
            peak = torch.cuda.max_memory_allocated(device) + moments
            oom = ""
        except torch.cuda.OutOfMemoryError as exc:
            peak, oom = None, f"out of memory in the trial ({exc})"
        budget_gib = budget_bytes / 2 ** 30
        msg = (f"{entry}: {oom}" if oom else
               f"{entry}: peak {peak / 2 ** 30:.3f} GiB of "
               f"{budget_gib:.3f} GiB budget")
        if static_plan is not None:
            msg += f"; {_static_verdict(static_plan, b, st, budget_gib)}"
        notes.append(msg)
        if oom or peak > budget_bytes:
            raise ValueError(
                f"curriculum pre-flight refused {msg} — shrink the stage's "
                "batch/resolution, enable remat/grad_accum, or raise the "
                "budget (MILNCE_HBM_GIB)")
    return notes


def _static_verdict(static_plan, b: int, stage, budget_gib: float) -> str:
    """The static plan's verdict on one stage, or why there is none."""
    from milnce_tpu_torch.analysis.memplan import budget_verdict

    try:
        plan = static_plan(b, stage)
    except Exception as exc:            # a planner limit, not a verdict
        return (f"static plan failed ({type(exc).__name__}: {exc}), "
                "advisory only")
    return budget_verdict(plan, budget_gib)[1]


# ---------------------------------------------------------------------
# checkpoint stage stamp: the resume-compatibility guard's source of
# truth (a curriculum checkpoint resumed with the schedule removed must
# fail LOUDLY, naming shapes, not silently train at full res)
# ---------------------------------------------------------------------

def write_stage_stamp(ckpt_dir: str, *, spec: str, stage_index: int,
                      stage: CurriculumStage, step: int) -> None:
    """Atomic sidecar write next to the checkpoint rotation (rank 0 only —
    the caller gates).  Overwritten at every save: the stamp describes
    the LATEST saved state, which is exactly what restore_latest hands
    back."""
    payload = {
        "schema": "milnce.curriculum/v1",
        "curriculum": spec,
        "stage": int(stage_index),
        "num_frames": int(stage.num_frames),
        "resolution": int(stage.resolution),
        "batch_size": int(stage.batch_size),
        "step": int(step),
    }
    path = os.path.join(ckpt_dir, STAMP_NAME)
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(payload, fh, indent=1)
    os.replace(tmp, path)


def read_stage_stamp(ckpt_dir: str) -> Optional[dict]:
    path = os.path.join(ckpt_dir, STAMP_NAME)
    if not os.path.exists(path):
        return None         # pre-curriculum checkpoint: no guard to run
    with open(path) as fh:
        return json.load(fh)


def check_resume_compatible(stamp: Optional[dict], *, curriculum_spec: str,
                            flat_frames: int, flat_resolution: int,
                            flat_batch: int) -> None:
    """Refuse resuming a curriculum checkpoint with ``train.curriculum``
    removed.  The TrainState is shape-invariant across stages, so
    NOTHING else would fail — the run would silently continue at the
    flat config's full shape with the schedule's intent discarded."""
    if not stamp or not stamp.get("curriculum"):
        return      # flat checkpoint (or pre-curriculum): any config ok
    if curriculum_spec:
        return      # schedule present; the plan's locate() places us
    saved = (f"{stamp.get('num_frames')}f@{stamp.get('resolution')} "
             f"batch {stamp.get('batch_size')}")
    flat = f"{flat_frames}f@{flat_resolution} batch {flat_batch}"
    raise ValueError(
        "checkpoint was written by a curriculum run (stage "
        f"{stamp.get('stage')}: {saved}, schedule "
        f"{stamp.get('curriculum')!r}, step {stamp.get('step')}) but "
        "train.curriculum is unset — resuming would silently train at "
        f"the flat shape {flat} instead of the schedule's; restore with "
        "the original train.curriculum (or a deliberate replacement)")
