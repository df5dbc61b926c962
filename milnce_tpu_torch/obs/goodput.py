"""Goodput ledger: partition a run's wall time into attribution buckets
(port of ``milnce_tpu/obs/goodput.py``; the same ledger from the same
stream).

The obs layer so far records *what* happened (counters, spans); this
module answers *where the time went*.  It consumes the span/event
stream a run already emits (RUN_EVENTS.jsonl lines or the recorder
ring — train/loop.py + data/pipeline.py instrumentation) and produces
a ledger that partitions the run's wall clock into:

| category       | fed by                                             |
|----------------|----------------------------------------------------|
| ``compute``    | ``step`` span dispatch + ``sync`` spans (the        |
|                | display-cadence ``device_get`` where the async     |
|                | pipeline's device work surfaces on the host),      |
|                | minus the skipped / rollback-lost reattributions   |
| ``compile``    | the FIRST ``step`` span per process — dispatch     |
|                | blocks on trace+compile there, and calling that    |
|                | compute would flatter every short run's goodput    |
| ``stage_switch`` | curriculum boundaries: each ``stage.switch``     |
|                | span (prefetcher drain + pipeline rebuild) plus    |
|                | the first ``step`` span after it — that dispatch   |
|                | blocks on the new stage's trace+compile, so the    |
|                | curriculum's overhead is measured, not guessed     |
| ``data_wait``  | ``data.wait`` spans (device_prefetch pulls: host   |
|                | blocked assembling/decoding the next batch)        |
| ``checkpoint`` | ``ckpt.save`` + ``ckpt.restore`` spans             |
| ``drain``      | ``elastic.drain`` spans: the forced stop-save of a |
|                | preemption drain (used INSTEAD of ``ckpt.save``    |
|                | there — the save is badput the preemption caused,  |
|                | not routine checkpoint overhead)                   |
| ``reshard``    | ``elastic.resume`` spans: restoring a rotation     |
|                | onto a (possibly different) mesh layout — used     |
|                | INSTEAD of ``ckpt.restore`` when a topology stamp  |
|                | is present, so resize cost is attributable         |
| ``skipped``    | step time of finite-guard-skipped updates (badput: |
|                | the chip ran, the update was discarded), prorated  |
|                | from the display events' ``skipped_total`` deltas  |
| ``rollback_lost`` | step time of updates a circuit-breaker rollback |
|                | discarded (``rollback`` events' ``lost_updates``)  |
| ``unattributed`` | the remainder: loop overhead, display logging,   |
|                | eval, init between the run markers                 |

``goodput_fraction`` = compute / wall: the fraction of the run's wall
clock that produced *kept* training progress.  All categories sum to
``wall_s`` by construction **unless spans double-count** (overlapping
attribution would push the attributed total past wall and the
``unattributed`` floor at zero makes the sum exceed wall) — the chaos
acceptance test pins the sum against an externally measured wall time
within 5%, so a future instrumentation change that overlaps spans
fails loudly instead of quietly inventing time.

Wall time comes from the ``run.start`` / ``run.end`` markers the train
loop emits (falling back to first/last record timestamps for foreign
streams).  All inputs are host-side wall/monotonic stamps that already
exist in the stream: building a ledger costs zero device syncs.

In the PyTorch port the ``step`` span holds the step's device work too
(the finite guard reads the gradients' verdict on the host each step),
so ``compute`` is mostly step spans and the ``sync`` spans are short;
the categories still partition the same wall.

Stdlib-only, like the rest of ``obs/``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

CATEGORIES = ("compute", "compile", "stage_switch", "data_wait",
              "checkpoint", "drain", "reshard", "skipped",
              "rollback_lost", "unattributed")

# span name -> raw bucket (before the skipped/rollback reattribution)
_SPAN_BUCKETS = {
    "step": "compute",
    "sync": "compute",
    "data.wait": "data_wait",
    "ckpt.save": "checkpoint",
    "ckpt.restore": "checkpoint",
    "stage.switch": "stage_switch",
    "elastic.drain": "drain",
    "elastic.resume": "reshard",
}


@dataclass
class GoodputLedger:
    run_id: str | None
    process_index: int | None
    wall_s: float
    categories: dict = field(default_factory=dict)  # name -> seconds
    steps: int = 0
    skipped_steps: int = 0
    rollbacks: int = 0
    lost_updates: int = 0
    decode_timeouts: int = 0
    anomalies: int = 0
    captures: int = 0
    stage_switches: int = 0     # curriculum boundaries crossed

    @property
    def goodput_fraction(self) -> float:
        return (self.categories.get("compute", 0.0) / self.wall_s
                if self.wall_s > 0 else 0.0)

    def to_extra(self) -> dict:
        """Top-level keys for the ``milnce.obs/v1`` ledger snapshot
        (kind=``goodput``) — ``goodput_fraction`` rides at top level so
        ``obs_report --check`` gates it like clips/s."""
        return {
            "wall_s": round(self.wall_s, 4),
            "categories_s": {k: round(v, 4)
                             for k, v in self.categories.items()},
            "goodput_fraction": round(self.goodput_fraction, 5),
            "steps": self.steps,
            "skipped_steps": self.skipped_steps,
            "rollbacks": self.rollbacks,
            "lost_updates": self.lost_updates,
            "decode_timeouts": self.decode_timeouts,
            "anomalies": self.anomalies,
            "captures": self.captures,
            "stage_switches": self.stage_switches,
        }

    def summary_line(self) -> str:
        frac = {k: (v / self.wall_s if self.wall_s > 0 else 0.0)
                for k, v in self.categories.items()}
        parts = ", ".join(f"{k} {frac[k]:.1%}" for k in CATEGORIES
                          if self.categories.get(k))
        return (f"goodput ledger: wall {self.wall_s:.1f}s, goodput "
                f"{self.goodput_fraction:.1%} ({parts}; steps "
                f"{self.steps}, skipped {self.skipped_steps}, "
                f"rollbacks {self.rollbacks})")


def split_runs(records: list) -> dict:
    """Group a (possibly shared, append-only) stream by ``run_id``.
    Untagged records (pre-tagging streams) group under ``None``."""
    runs: dict = {}
    for rec in records:
        runs.setdefault(rec.get("run_id"), []).append(rec)
    return runs


def select_run(records: list, run_id: str | None = None) -> list:
    """One run's records out of a stream.  ``run_id=None`` requires the
    stream to hold EXACTLY one run — a mixed stream is the documented
    cross-run append ambiguity and raises loudly instead of silently
    diluting percentiles across runs."""
    runs = split_runs(records)
    if run_id is not None:
        if run_id not in runs:
            raise ValueError(
                f"run_id {run_id!r} not in stream (present: "
                f"{sorted(str(k) for k in runs)})")
        return runs[run_id]
    if len(runs) > 1:
        raise ValueError(
            f"mixed-run stream: {len(runs)} run_ids present "
            f"({sorted(str(k) for k in runs)}) — pass run_id= (CLI: "
            "--run-id) or point at a fresh obs_dir per run "
            "(OBSERVABILITY.md 'Run identity')")
    return next(iter(runs.values())) if runs else []


def _span_window(records: list) -> tuple[float, float]:
    """(start, end) wall seconds covered by the stream.  Prefers the
    explicit ``run.start`` / ``run.end`` markers — FIRST start, LAST
    end: a crashed run re-launched under the same explicit run_id
    appends a second marker pair, and the window must cover every
    session whose spans the categories sum over (keeping only the last
    pair made attributed time exceed wall and pushed the gated
    goodput_fraction past 1.0).  Falls back to the first/last record
    stamps (spans end at ``ts + dur_ms``) for marker-less streams."""
    start = end = None
    lo, hi = float("inf"), float("-inf")
    for rec in records:
        ts = float(rec.get("ts", 0.0))
        if rec.get("name") == "run.start":
            start = ts if start is None else min(start, ts)
        elif rec.get("name") == "run.end":
            end = ts if end is None else max(end, ts)
        lo = min(lo, ts)
        hi = max(hi, ts + float(rec.get("dur_ms", 0.0)) / 1e3)
    if not records:
        return 0.0, 0.0
    return (start if start is not None else lo,
            end if end is not None else hi)


def compute_ledger(records: list, run_id: str | None = None,
                   process_index: int | None = None) -> GoodputLedger:
    """Build the ledger for one run (and optionally one process) out of
    a record stream."""
    records = select_run(records, run_id)
    if process_index is not None:
        records = [r for r in records
                   if r.get("process_index", process_index)
                   == process_index]
    if not records:
        raise ValueError("empty record stream — nothing to attribute")
    t0, t1 = _span_window(records)
    wall = max(0.0, t1 - t0)

    cats = {k: 0.0 for k in CATEGORIES}
    steps = 0
    step_durs: list[float] = []
    skipped = 0
    rollbacks = 0
    lost_updates = 0
    anomalies = 0
    captures = 0
    timeouts = 0
    stage_switches = 0
    seen_first_step = False
    pending_switch = False
    for rec in records:
        name = rec.get("name", "")
        if rec.get("kind") == "span":
            dur = float(rec.get("dur_ms", 0.0)) / 1e3
            if name == "step":
                steps += 1
                if not seen_first_step:
                    # first dispatch blocks on trace+compile — its own
                    # category, or a 2-step CPU run reads as 95% compute
                    seen_first_step = True
                    cats["compile"] += dur
                elif pending_switch:
                    # first step of a NEW curriculum stage: dispatch
                    # blocks on that stage's trace+compile — boundary
                    # cost, not steady-state compute (and excluded from
                    # the mean-step-time pool like the compile step)
                    pending_switch = False
                    cats["stage_switch"] += dur
                else:
                    step_durs.append(dur)
                    cats["compute"] += dur
            else:
                bucket = _SPAN_BUCKETS.get(name)
                if bucket is not None:
                    cats[bucket] += dur
                if name == "stage.switch":
                    stage_switches += 1
                    pending_switch = True
        elif rec.get("kind") == "event":
            if name == "display":
                skipped = max(skipped,
                              int(rec.get("skipped_total", 0) or 0))
            elif name == "rollback":
                rollbacks += 1
                lost_updates += int(rec.get("lost_updates", 0) or 0)
            elif name == "anomaly":
                anomalies += 1
            elif name == "capture.start":
                captures += 1
            elif name == "decode.timeout":
                timeouts += 1

    # Reattribute badput OUT of compute: the chip ran these steps but
    # the updates were discarded.  Prorated by the run-level skip
    # fraction / mean post-compile step time — the stream doesn't say
    # WHICH steps skipped (that would cost a per-step host sync), and a
    # ledger needs totals, not per-step labels.
    # compute-pool step count: total minus the compile step and the
    # per-switch compile steps already attributed to stage_switch
    post_compile = max(1, steps - 1 - stage_switches)
    if skipped and cats["compute"] > 0:
        frac = min(1.0, skipped / post_compile)
        moved = cats["compute"] * frac
        cats["skipped"] = moved
        cats["compute"] -= moved
    if lost_updates and step_durs:
        mean_step = sum(step_durs) / len(step_durs)
        moved = min(cats["compute"], mean_step * lost_updates)
        cats["rollback_lost"] = moved
        cats["compute"] -= moved

    attributed = sum(v for k, v in cats.items() if k != "unattributed")
    cats["unattributed"] = max(0.0, wall - attributed)

    rid = records[0].get("run_id") if run_id is None else run_id
    pi = process_index
    if pi is None:
        pis = {r.get("process_index") for r in records} - {None}
        pi = pis.pop() if len(pis) == 1 else None
    return GoodputLedger(run_id=rid, process_index=pi, wall_s=wall,
                         categories=cats, steps=steps,
                         skipped_steps=skipped, rollbacks=rollbacks,
                         lost_updates=lost_updates,
                         decode_timeouts=timeouts, anomalies=anomalies,
                         captures=captures, stage_switches=stage_switches)


def ledger_to_registry(ledger: GoodputLedger, registry) -> None:
    """Export the ledger as ``milnce.obs/v1`` gauges on ``registry`` —
    the per-run summary a scrape (or the final snapshot) carries."""
    fam = registry.gauge("milnce_goodput_seconds",
                         "per-run wall-time attribution (goodput ledger)",
                         labels=("category",))
    for cat in CATEGORIES:
        fam.labels(category=cat).set(ledger.categories.get(cat, 0.0))
    registry.gauge("milnce_goodput_wall_seconds",
                   "total wall time the ledger attributes over"
                   ).set(ledger.wall_s)
    registry.gauge("milnce_goodput_fraction",
                   "kept-compute fraction of run wall time"
                   ).set(ledger.goodput_fraction)
