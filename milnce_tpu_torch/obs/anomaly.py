"""EWMA spike detector: step-time / latency anomalies, host-side only
(port of ``milnce_tpu/obs/anomaly.py``).

A step-time regression on real hardware is invisible until someone
re-runs under a manually armed profiler.  This detector watches a
stream of host-side measurements (window step time at display cadence,
batcher flush latency on the serving side), keeps an exponentially
weighted mean + deviation, and on a spike emits an ``anomaly`` event
and fires a callback — obs/capture.py's bounded one-shot
``torch.profiler`` capture, so the trace of the *anomalous* period exists
without anyone watching.

Spike criterion (both must hold, after ``warmup`` samples):

- ``value > ewma * ratio`` — a relative floor, so the near-zero
  variance of a healthy steady state (step times flat to the ms) does
  not turn scheduler jitter into pages;
- ``value > ewma + sigma * std`` — a deviation gate, so a noisy
  baseline (shared CPU containers) widens its own threshold.

Anomalous samples do NOT update the EWMA: a genuine regression keeps
firing against the healthy baseline instead of teaching the detector
that slow is normal.  A ``cooldown_s`` window suppresses repeat events
so a bad run pages once per episode, not per display.

Recording is host-side (the registry/recorder invariant); the
callback runs OUTSIDE the detector lock — callbacks take their own
locks (ProfilerCapture) and calling through while holding ours would
stack this lock above theirs in the lock order.  ``observe`` may be called from any thread (the train
loop, the batcher worker).
"""

from __future__ import annotations

import threading
import math
import time
from typing import Callable, Optional

from milnce_tpu_torch.obs import spans as obs_spans


class EwmaSpikeDetector:
    """Feed host-side samples; get at most one anomaly per episode.

    - ``name``: what the samples measure (``train.step_ms``,
      ``serve.flush_ms``) — lands in the event and the metric label;
    - ``ratio``: relative spike floor (value vs EWMA);
    - ``sigma``: deviation gate width;
    - ``alpha``: EWMA weight of the newest sample;
    - ``warmup``: samples before the detector may fire (the first
      windows include compile and cache-cold effects);
    - ``cooldown_s``: suppression window after a firing;
    - ``on_anomaly``: callback ``(value, ewma) -> None`` invoked outside
      the lock (arm a capture, log, page);
    - ``recorder``: span recorder for the ``anomaly`` event (None = the
      process default, resolved per firing);
    - ``time_fn`` / injectable clock: tests drive the cooldown without
      sleeping.
    """

    def __init__(self, name: str, *, ratio: float = 2.0,
                 sigma: float = 4.0, alpha: float = 0.2, warmup: int = 3,
                 cooldown_s: float = 300.0,
                 on_anomaly: Optional[Callable[[float, float], None]] = None,
                 recorder: Optional[obs_spans.SpanRecorder] = None,
                 time_fn: Callable[[], float] = time.monotonic):
        if ratio <= 1.0:
            raise ValueError(f"ratio must be > 1 (got {ratio}): a spike "
                             "threshold at or below the mean fires forever")
        self.name = name
        self.ratio = float(ratio)
        self.sigma = float(sigma)
        self.alpha = float(alpha)
        self.warmup = max(1, int(warmup))
        self.cooldown_s = float(cooldown_s)
        self._on_anomaly = on_anomaly
        self._recorder = recorder
        self._time = time_fn
        self._lock = threading.Lock()
        self._n = 0                     # guarded-by: _lock
        self._ewma = 0.0                # guarded-by: _lock
        self._var = 0.0                 # guarded-by: _lock
        self._last_fire = -math.inf     # guarded-by: _lock
        self._fired = 0                 # guarded-by: _lock

    def observe(self, value: float, **attrs) -> bool:
        """Record one sample; returns True when this sample fired an
        anomaly (event emitted + callback invoked)."""
        value = float(value)
        now = self._time()
        fire = False
        with self._lock:
            if self._n >= self.warmup:
                std = math.sqrt(max(0.0, self._var))
                spike = (value > self._ewma * self.ratio
                         and value > self._ewma + self.sigma * std)
                if spike:
                    if now - self._last_fire >= self.cooldown_s:
                        fire = True
                        self._last_fire = now
                        self._fired += 1
                    # anomalous samples never update the baseline —
                    # suppressed or not, slow must not become normal
                    ewma = self._ewma
                else:
                    ewma = self._update(value)
            else:
                ewma = self._update(value)
        if fire:
            rec = (self._recorder if self._recorder is not None
                   else obs_spans.get_recorder())
            rec.event("anomaly", detector=self.name, value=round(value, 4),
                      ewma=round(ewma, 4), **attrs)
            cb = self._on_anomaly
            if cb is not None:
                cb(value, ewma)
        return fire

    # guarded-by: _lock
    def _update(self, value: float) -> float:
        # helper-relies-on-caller's-lock: observe() holds _lock across
        # every call
        if self._n == 0:
            self._ewma = value
        else:
            delta = value - self._ewma
            self._ewma += self.alpha * delta
            self._var = (1 - self.alpha) * (self._var
                                            + self.alpha * delta * delta)
        self._n += 1
        return self._ewma

    def stats(self) -> dict:
        with self._lock:
            return {"name": self.name, "samples": self._n,
                    "ewma": self._ewma,
                    "std": math.sqrt(max(0.0, self._var)),
                    "anomalies": self._fired}
