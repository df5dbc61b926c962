"""Straggler-adaptive scheduling: the skew metric, made a live policy
(port of ``milnce_tpu/elastic/straggler.py``; a rank stands where the
JAX package has a process, since the port runs one process a card).

``obs_report --merge`` already computes cross-rank step-time skew after
the fact (obs/aggregate.py: per-process step-span p50s, max/min skew,
slow hosts named).  This module feeds the SAME math into a live policy
object: per-rank window step times stream in (rank 0 gathers every
rank's at the display cadence; merged event streams feed every rank's
at once),
and a host whose p50 stays above ``ratio`` x the fastest host's for
``window`` consecutive evaluations is **demoted** — a ``straggler``
event per flagged evaluation, a ``straggler.demote`` event at the
threshold, and the demoted set lands in the goodput ledger snapshot so
the badput is attributable to a named host.  Behind
``train.straggler_resize``, a demotion also emits a
``straggler.resize_recommended`` event: drain (elastic/drain.py) and
resume at a capacity that excludes the slow host — the serving twin is
the replica pool's DEGRADED state, but training can't route around a
host mid-collective, so the recommendation is drain-and-resize, never
a live eviction.

One straggler chip sets the pace of every collective; the policy names
the host to act on before anyone stares at a profile.  Host-side only
and stdlib+repo-pure: evaluating costs zero device syncs.
"""

from __future__ import annotations

from milnce_tpu_torch.obs.aggregate import STRAGGLER_RATIO, _percentile


class StragglerPolicy:
    """Live straggler detection over per-process step-time observations.

    ``observe(process_index, step_ms, step=)`` records one window's
    mean step wall time for one host; ``evaluate(step=)`` compares the
    per-host p50s over the observation history (the aggregate module's
    percentile, the aggregate module's ratio rule) and advances the
    per-host flag streaks.  With fewer than two hosts reporting there
    is nothing to compare and evaluation is a no-op — skew is a
    cross-host property."""

    def __init__(self, ratio: float = STRAGGLER_RATIO, window: int = 3,
                 recommend_resize: bool = False, recorder=None,
                 history: int = 32):
        if ratio <= 1.0:
            raise ValueError(f"straggler ratio must be > 1.0, got {ratio}")
        if window < 1:
            raise ValueError(f"straggler window must be >= 1, got {window}")
        self.ratio = float(ratio)
        self.window = int(window)
        self.recommend_resize = bool(recommend_resize)
        self._rec = recorder
        self._history = int(history)
        self._obs: dict = {}        # process_index -> [step_ms, ...]
        self._streaks: dict = {}    # process_index -> consecutive flags
        self.demoted: list = []     # process indices, demotion order
        self.last_skew: float = 1.0

    # -- feeds ----------------------------------------------------------
    def observe(self, process_index: int, step_ms: float,
                step: int = 0) -> None:
        """One window observation for one host, then evaluate."""
        buf = self._obs.setdefault(int(process_index), [])
        buf.append(float(step_ms))
        del buf[:-self._history]
        self.evaluate(step=step)

    def feed_merged(self, merged: dict, step: int = 0) -> None:
        """Feed a pod view from ``obs_report --merge`` /
        ``aggregate.merge_event_streams``: every host's step p50 in one
        call — the post-hoc twin of per-display ``observe`` feeds."""
        for pi, stats in (merged.get("per_process") or {}).items():
            if stats.get("steps"):
                buf = self._obs.setdefault(int(pi), [])
                buf.append(float(stats["step_ms_p50"]))
                del buf[:-self._history]
        self.evaluate(step=step)

    # -- the verdict ----------------------------------------------------
    def _p50s(self) -> dict:
        return {pi: _percentile(sorted(buf), 50)
                for pi, buf in self._obs.items() if buf}

    def evaluate(self, step: int = 0) -> list:
        """Advance streaks; returns the processes flagged THIS round."""
        p50s = self._p50s()
        if len(p50s) < 2:
            return []
        fastest = min(p50s.values())
        if fastest <= 0:
            return []
        self.last_skew = max(p50s.values()) / fastest
        flagged = sorted(pi for pi, p in p50s.items()
                         if p > self.ratio * fastest)
        for pi in list(self._streaks):
            if pi not in flagged:
                self._streaks[pi] = 0
        for pi in flagged:
            self._streaks[pi] = self._streaks.get(pi, 0) + 1
            if self._rec is not None:
                self._rec.event("straggler", process=pi, step=int(step),
                                p50_ms=round(p50s[pi], 4),
                                skew=round(p50s[pi] / fastest, 4),
                                streak=self._streaks[pi])
            if (self._streaks[pi] >= self.window
                    and pi not in self.demoted):
                self.demoted.append(pi)
                if self._rec is not None:
                    self._rec.event("straggler.demote", process=pi,
                                    step=int(step),
                                    skew=round(p50s[pi] / fastest, 4))
                if self.recommend_resize and self._rec is not None:
                    self._rec.event("straggler.resize_recommended",
                                    process=pi, step=int(step),
                                    reason=(f"host {pi} p50 > "
                                            f"{self.ratio}x fastest for "
                                            f"{self.window} windows — "
                                            "drain and resume without it"))
        return flagged

    def ledger_extra(self) -> dict:
        """Keys for the GOODPUT snapshot: the demotion verdict rides the
        ledger so pod badput is attributable to named hosts."""
        if not self._obs:
            return {}
        return {"straggler_skew": round(self.last_skew, 4),
                "demoted_hosts": list(self.demoted)}
