"""Process-wide run identity: ``run_id`` + ``process_index`` tags (port
of ``milnce_tpu/obs/runctx.py``).

An ambiguity this module settles: RUN_EVENTS.jsonl is
append-only BY DESIGN, so two runs sharing one ``obs_dir`` interleave
into a stream no tool can split, and a pod run's per-process snapshots
carry nothing that says which host produced them.  This module is the
fix's single source of truth: the entry points that own a run (the
train loop, ``milnce-serve``, ``bench.py``, ``serve_bench``) call
:func:`set_run_context` once at startup, and from then on

- every record the span recorder writes (obs/spans.py) and
- every ``milnce.obs/v1`` snapshot (obs/export.py)

is stamped with ``run_id`` + ``process_index``.  ``obs_report`` splits
event streams on ``run_id`` (mixed-run streams are a loud error) and
``obs/aggregate.py`` refuses to merge snapshots from different runs.

Pure stdlib, no torch/numpy — the same import-anywhere contract as the
rest of ``obs/``; the caller passes its rank in.
Thread-safe: the context is read from recorder/export call sites on
arbitrary threads while the owning entry point installs it.
"""

from __future__ import annotations

import threading
import os
import time
from typing import Optional


_lock = threading.Lock()
_run_id: Optional[str] = None           # guarded-by: _lock
_process_index: Optional[int] = None    # guarded-by: _lock


def auto_run_id(prefix: str = "r") -> str:
    """A fresh process-local run id: start-second + 2 random bytes —
    unique across restarts on one host.  NOT cluster-uniform: a
    multi-process run must share ONE id, so the train loop broadcasts
    rank 0's value (parallel/dist.broadcast_str) or the operator
    passes ``--train.run_id`` explicitly."""
    return f"{prefix}{int(time.time())}-{os.urandom(2).hex()}"


def set_run_context(run_id: Optional[str],
                    process_index: Optional[int]) -> tuple:
    """Install the process-wide run identity; returns the previous
    ``(run_id, process_index)`` so scoped owners (the train loop's
    ``finally``) can restore it."""
    global _run_id, _process_index
    with _lock:
        prev = (_run_id, _process_index)
        _run_id = str(run_id) if run_id is not None else None
        _process_index = (int(process_index)
                          if process_index is not None else None)
        return prev


def get_run_context() -> tuple:
    """``(run_id, process_index)`` — both None until an owner installs
    them (library-only processes, unit tests)."""
    with _lock:
        return _run_id, _process_index
