"""Monotonic-clock span/event recorder: RUN_EVENTS.jsonl + in-memory ring
(port of ``milnce_tpu/obs/spans.py``, same records).

The span taxonomy covers the moments that explain a
run after the fact: ``step`` (hot-loop dispatch), ``decode.timeout`` /
``decode.retry`` (watchdog escalations), ``batcher.flush`` (serving
micro-batches), ``ladder.warmup`` (engine pre-trace sweep),
``ckpt.save`` / ``ckpt.restore`` / ``rollback`` (checkpoint lifecycle),
``display`` (the train loop's cadenced fetch).

Durability has two tiers:

- the **ring** (``tail()``) always records — bounded memory, surfaced
  over HTTP by the serving front (``GET /obs/events``);
- the **JSONL file** records when a path is configured (the train loop
  writes ``<log_root>/RUN_EVENTS.jsonl``): append-only, one JSON object
  per line, line-buffered so a crash loses at most the current line.

Durations come from ``time.monotonic`` (wall-clock ``ts`` is attached
for human correlation only).  The recorder itself never blocks on the
device (the same host-side-only invariant as the metrics registry): a
span measures what its body waits for on the host.  For device truth,
the opt-in ``profiler_bridge=True`` wraps each span in
``torch.profiler.record_function(name)``, so spans show in a
torch.profiler trace (torch is imported only when the bridge is on).

Thread-safe: ring appends and file writes are lock-guarded (spans fire
from reader threads, the batcher worker and request threads).
"""

from __future__ import annotations

import threading
import contextlib
import json
import time
from collections import deque
from typing import Optional

from milnce_tpu_torch.obs import runctx


def _now() -> float:
    """Monotonic seconds (single helper so span timing has one clock —
    and so tests can monkeypatch it)."""
    return time.monotonic()


def _wall() -> float:
    return time.time()


class SpanRecorder:
    def __init__(self, path: Optional[str] = None, ring: int = 2048,
                 profiler_bridge: bool = False):
        self.path = path or None
        self.profiler_bridge = bool(profiler_bridge)
        self._ring: deque = deque(maxlen=max(1, int(ring)))
        self._lock = threading.Lock()
        self._mono_last = 0.0
        self._fh = None
        if self.path:
            # line-buffered append handle, opened ONCE (the RunLogger
            # reopen-per-line pathology is the anti-pattern)
            self._fh = open(self.path, "a", buffering=1)

    # ---- recording -------------------------------------------------------

    def _record(self, rec: dict) -> None:
        # run identity stamped at RECORD time (not construction): the
        # owning entry point installs the context once, and every line —
        # including library events from reader/worker threads — carries
        # it, so obs_report can split a shared append-only stream by run
        # and aggregate.py can merge a pod's streams by process
        run_id, pi = runctx.get_run_context()
        if run_id is not None and "run_id" not in rec:
            rec["run_id"] = run_id
        if pi is not None and "process_index" not in rec:
            rec["process_index"] = pi
        with self._lock:
            # append-order monotonic cursor (``GET /obs/events?since=``):
            # stamped under the lock, and forced STRICTLY increasing —
            # two back-to-back records rounding to the same microsecond
            # would otherwise let a poller whose cursor lands between
            # them miss the second one forever (tail()'s filter is a
            # strict '>')
            mono = round(_now(), 6)
            if mono <= self._mono_last:
                mono = round(self._mono_last + 1e-6, 6)
            self._mono_last = mono
            rec["mono"] = mono
            self._ring.append(rec)
            if self._fh is not None:
                self._fh.write(json.dumps(rec) + "\n")

    def event(self, name: str, **attrs) -> None:
        """Point-in-time occurrence (a retry, a rollback, a display)."""
        rec = {"kind": "event", "name": name, "ts": _wall()}
        rec.update(attrs)
        self._record(rec)

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        """Timed region; records on exit with ``dur_ms`` (host-side
        elapsed).  Exceptions propagate — the span still records, with
        ``error`` naming the exception type."""
        if self.profiler_bridge:
            import torch

            bridge = torch.profiler.record_function(name)
        else:
            bridge = contextlib.nullcontext()
        t0 = _now()
        rec = {"kind": "span", "name": name, "ts": _wall()}
        rec.update(attrs)
        try:
            with bridge:
                yield rec
        except BaseException as exc:
            rec["error"] = type(exc).__name__
            raise
        finally:
            rec["dur_ms"] = round((_now() - t0) * 1e3, 4)
            self._record(rec)

    # ---- reading / lifecycle --------------------------------------------

    def tail(self, n: Optional[int] = None,
             since: Optional[float] = None) -> list[dict]:
        """Most recent ``n`` records, oldest first (the whole ring by
        default); ``n <= 0`` is an empty list, not the whole ring (a
        bare ``out[-0:]`` would invert the limit's meaning).

        ``since`` keeps only records appended strictly after that
        ``mono`` cursor (the append-order monotonic stamp every record
        carries) — pollers pass their last-seen ``mono`` back instead of
        re-downloading the whole ring (``GET /obs/events?since=``)."""
        with self._lock:
            out = list(self._ring)
        if since is not None:
            cut = float(since)
            out = [r for r in out if r.get("mono", 0.0) > cut]
        if n is None:
            return out
        n = int(n)
        return out[-n:] if n > 0 else []

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # graftlint: disable=GL007(interpreter-teardown finalizer: close is best-effort, raising only makes unraisable-exception noise)
            pass


# ---------------------------------------------------------------------------
# the process-default recorder
# ---------------------------------------------------------------------------

_default = SpanRecorder()           # ring-only until a run installs a file
_install_lock = threading.Lock()


def get_recorder() -> SpanRecorder:
    """The process-default recorder.  Library call sites (data pipeline
    watchdog, serving batcher/engine) record here; the train loop
    installs a file-backed recorder for the run's lifetime."""
    return _default


def install(rec: SpanRecorder) -> SpanRecorder:
    """Swap the process-default recorder; returns the previous one so
    the caller can restore it (the train loop does, in its finally)."""
    global _default
    with _install_lock:
        prev = _default
        _default = rec
        return prev
