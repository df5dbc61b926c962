"""Bounded one-shot ``torch.profiler`` capture, armed by anomalies (port
of ``milnce_tpu/obs/capture.py``: the same state machine, budget,
cooldown and events).

The missing diagnostic loop: a step-time spike on real hardware is
only explainable from a profiler trace of the *spiking* period, but
traces are expensive (hundreds of MB, host overhead) so nobody runs
them always-on.  :class:`ProfilerCapture` holds a disarmed profiler
that anything host-side may arm — the EWMA detector (obs/anomaly.py),
``SIGUSR1`` on the train loop, ``POST /obs/capture`` on the serving
front — and that then stops ITSELF after a bounded duration.

Discipline (why a bad run captures once, not forever):

- at most one capture in flight (arming while active is refused);
- ``cooldown_s`` between captures;
- ``max_captures`` per process lifetime (default 1: the first anomaly
  of a run is the interesting one; operators re-arm by restarting or
  raising the budget).

Every transition emits ``capture.start`` / ``capture.stop`` events so
the run's event stream says exactly which wall-clock window the trace
covers.  State transitions happen under the lock; the profiler
start/stop callables run OUTSIDE it (they do real I/O — blocking under
a lock is the GL012 class of bug), with the ``starting``/``stopping``
states keeping concurrent armers out meanwhile.  ``start_fn`` /
``stop_fn`` are injectable for tests; by default each capture drives a
``torch.profiler.profile`` of its own (CPU activity, and CUDA activity
when a card is visible) and writes a Chrome trace, ``trace.json``, into
the capture directory when it stops.  torch is imported only when a
capture starts.

torch.profiler stops only on the thread that started it (another
thread's stop finds no session), so with the default profiler the
duration timer does not stop the capture itself: it marks it due, and
the owner's next :meth:`ProfilerCapture.poll` (the train loop calls it
at every step boundary) stops it there, with the same ``capture.stop``
event.  With injected ``start_fn`` / ``stop_fn`` the timer stops it, as
in the JAX package.
"""

from __future__ import annotations

import os
import re
import threading
import time
from typing import Callable, Optional

from milnce_tpu_torch.obs import spans as obs_spans

_REASON_SLUG = re.compile(r"[^A-Za-z0-9_-]+")


def _slug(reason: str) -> str:
    """Filesystem-safe capture-directory label.  ``reason`` reaches
    here from the NETWORK (``POST /obs/capture``): anything outside
    [A-Za-z0-9_-] — path separators, ``..``, whitespace — is squashed
    so a request body can never direct the trace write outside
    ``out_dir``."""
    return _REASON_SLUG.sub("_", str(reason)).strip("_")[:48] or "manual"


class _TorchProfile:
    """The default profiler backend: one ``torch.profiler.profile`` a
    capture, its Chrome trace written into the capture directory."""

    def __init__(self):
        self._prof = None
        self._trace_dir = None

    def start(self, trace_dir: str) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)
        self._prof.start()
        self._trace_dir = trace_dir

    def stop(self) -> None:
        import torch

        prof, self._prof = self._prof, None
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(self._trace_dir, "trace.json"))


class ProfilerCapture:
    """Armable, self-stopping, budgeted profiler capture.

    - ``out_dir``: capture root; each capture lands in a numbered
      ``capture_NNN-<reason>/`` subdirectory;
    - ``duration_s``: the capture stops itself this long after arming
      (a daemon timer thread calls the stop path);
    - ``cooldown_s`` / ``max_captures``: the re-arm budget;
    - ``recorder``: event destination (None = process default, resolved
      per event);
    - ``start_fn(trace_dir)`` / ``stop_fn()``: the profiler backend
      (default, both None: a ``torch.profiler.profile`` and a Chrome
      trace, ``trace.json``, in the capture directory, stopped by
      :meth:`poll` on the owner's thread once its duration has passed);
    - ``time_fn``: injectable clock for cooldown tests.
    """

    def __init__(self, out_dir: str, *, duration_s: float = 2.0,
                 cooldown_s: float = 600.0, max_captures: int = 1,
                 recorder: Optional[obs_spans.SpanRecorder] = None,
                 start_fn: Optional[Callable[[str], None]] = None,
                 stop_fn: Optional[Callable[[], None]] = None,
                 time_fn: Callable[[], float] = time.monotonic):
        self.out_dir = out_dir
        self.duration_s = float(duration_s)
        self.cooldown_s = float(cooldown_s)
        self.max_captures = int(max_captures)
        self._recorder = recorder
        if (start_fn is None) != (stop_fn is None):
            raise ValueError("give both start_fn and stop_fn, or neither")
        # the default torch profiler stops only on its starting thread
        self.stop_at_poll = start_fn is None
        if self.stop_at_poll:
            prof = _TorchProfile()
            start_fn, stop_fn = prof.start, prof.stop
        self._start_fn = start_fn
        self._stop_fn = stop_fn
        self._time = time_fn
        self._lock = threading.Lock()
        self._state = "idle"        # guarded-by: _lock  (idle | starting
        #                             | active | stopping)
        self._captures = 0          # guarded-by: _lock
        self._last_done = None      # guarded-by: _lock  (monotonic s)
        self._timer = None          # guarded-by: _lock
        self._stop_requested = False  # guarded-by: _lock  (stop() raced
        #                               an arm still in 'starting')
        self._due = False           # guarded-by: _lock  (duration passed,
        #                             stop_at_poll)

    # ---- arming ----------------------------------------------------------

    def arm(self, reason: str = "manual", **attrs) -> dict:
        """Try to start a capture.  Returns ``{"armed": bool, ...}``
        with the refusal reason when not armed — callers surface it
        (the serving endpoint returns it as JSON) instead of guessing."""
        now = self._time()
        with self._lock:
            if self._state != "idle":
                return {"armed": False, "reason": f"capture {self._state}"}
            if self._captures >= self.max_captures:
                return {"armed": False,
                        "reason": f"budget exhausted "
                                  f"({self._captures}/{self.max_captures} "
                                  "captures this process)"}
            if (self._last_done is not None
                    and now - self._last_done < self.cooldown_s):
                remaining = self.cooldown_s - (now - self._last_done)
                return {"armed": False,
                        "reason": f"cooldown ({remaining:.0f}s remaining)"}
            self._state = "starting"
            n = self._captures + 1
        trace_dir = os.path.join(self.out_dir,
                                 f"capture_{n:03d}-{_slug(reason)}")
        try:
            os.makedirs(trace_dir, exist_ok=True)
            self._start_fn(trace_dir)
        except Exception as exc:
            with self._lock:
                self._state = "idle"
                self._stop_requested = False
            self._event("capture.error", reason=reason,
                        error=f"{type(exc).__name__}: {exc}")
            return {"armed": False,
                    "reason": f"profiler start failed: "
                              f"{type(exc).__name__}: {exc}"}
        with self._lock:
            self._captures = n
            if self._stop_requested:
                # a stop()/close() landed while _start_fn ran: honor it
                # NOW — leaving the trace running with only a daemon
                # timer to stop it would lose the capture on exit
                self._stop_requested = False
                self._state = "stopping"
                timer = None
            else:
                self._state = "active"
                timer = threading.Timer(self.duration_s, self._auto_stop)
                timer.daemon = True
                self._timer = timer
        if timer is None:
            try:
                self._stop_fn()
            finally:
                with self._lock:
                    self._state = "idle"
                    self._last_done = self._time()
            self._event("capture.stop", cause="stopped-during-start")
            return {"armed": False,
                    "reason": "stop requested while the capture was "
                              "starting (trace flushed)"}
        timer.start()
        self._event("capture.start", reason=reason, trace_dir=trace_dir,
                    duration_s=self.duration_s, capture=n, **attrs)
        return {"armed": True, "trace_dir": trace_dir, "capture": n}

    # ---- stopping --------------------------------------------------------

    def _auto_stop(self) -> None:
        if self.stop_at_poll:
            with self._lock:
                self._due = self._state == "active"
            return
        self.stop(cause="duration")

    def poll(self) -> bool:
        """Stop a capture whose duration has passed (the default profiler),
        on the calling thread; returns whether it stopped one.  Cheap when
        nothing is due: one lock."""
        with self._lock:
            due, self._due = self._due, False
        return self.stop(cause="duration") if due else False

    def stop(self, cause: str = "manual") -> bool:
        """Stop an active capture (idempotent; the duration timer and a
        manual/final stop may race — exactly one wins)."""
        with self._lock:
            if self._state == "starting":
                # arm() is inside _start_fn on another thread: flag it —
                # the armer stops the trace itself the moment the start
                # completes (the 'stopped-during-start' path)
                self._stop_requested = True
                return False
            if self._state != "active":
                return False
            self._state = "stopping"
            self._due = False
            timer, self._timer = self._timer, None
        if timer is not None:
            timer.cancel()
        try:
            self._stop_fn()
        finally:
            with self._lock:
                self._state = "idle"
                self._last_done = self._time()
        self._event("capture.stop", cause=cause)
        return True

    def close(self) -> None:
        """Owner teardown: stop a still-active capture so a run that
        ends mid-capture flushes its trace instead of corrupting it."""
        self.stop(cause="close")

    # ---- reading ---------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            return {"state": self._state, "captures": self._captures,
                    "max_captures": self.max_captures,
                    "out_dir": self.out_dir}

    def _event(self, name: str, **attrs) -> None:
        rec = (self._recorder if self._recorder is not None
               else obs_spans.get_recorder())
        rec.event(name, **attrs)


class OwnedCapture:
    """A :class:`ProfilerCapture` driven from ONE owner thread — the
    serving process's capture.

    ``torch.profiler`` stops only on the thread that started it, and a
    server arms its capture from wherever the trigger lands (an HTTP
    handler thread for ``POST /obs/capture``, the batcher's flush thread
    for the anomaly detector), none of which waits for the duration.  So
    the owner thread starts the capture (``capture.arm`` on the owner),
    waits its ``duration_s``, and stops it there.  The profiler traces
    the whole process while it runs: kernels the engine launches from the
    batcher's thread land in its trace.

    :meth:`arm` returns the capture's own answer (``{"armed": ...}``) once
    the owner has started it or refused; while a capture is held, it
    refuses at once (``capture active``), as the JAX capture does.
    :meth:`arm_async` queues the request without waiting (the anomaly
    path must not stall a flush)."""

    def __init__(self, capture: ProfilerCapture):
        import queue

        self.capture = capture
        # the owner stops it: the capture's own duration timer only marks
        # it due, whatever its profiler backend
        capture.stop_at_poll = True
        self.duration_s = capture.duration_s
        self._requests: "queue.Queue" = queue.Queue()
        self._lock = threading.Lock()
        self._busy = False              # guarded-by: _lock
        self._closed = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="serve-capture-owner")
        self._thread.start()

    def _submit(self, reason: str, attrs: dict):
        from concurrent.futures import Future

        with self._lock:
            if self._busy:
                return None
            self._busy = True
        fut: Future = Future()
        self._requests.put((reason, attrs, fut))
        return fut

    def arm(self, reason: str = "manual", **attrs) -> dict:
        fut = self._submit(reason, attrs)
        if fut is None:
            return {"armed": False, "reason": "capture active"}
        return fut.result(timeout=120)

    def arm_async(self, reason: str = "manual", **attrs) -> None:
        self._submit(reason, attrs)

    def _loop(self) -> None:
        import queue

        while not self._closed.is_set():
            try:
                reason, attrs, fut = self._requests.get(timeout=0.05)
            except queue.Empty:
                continue
            try:
                out = self.capture.arm(reason=reason, **attrs)
                fut.set_result(out)
                if out.get("armed"):
                    self._closed.wait(self.duration_s)
                    self.capture.stop(cause="duration")
            except Exception as exc:        # the owner must outlive one
                if not fut.done():          # failed capture
                    fut.set_exception(exc)
            finally:
                with self._lock:
                    self._busy = False

    def close(self) -> None:
        """Stop a held capture (on the owner thread) and end the owner."""
        self._closed.set()
        self._thread.join(30)
